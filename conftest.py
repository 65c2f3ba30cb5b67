"""Tier-1's order of work and its per-test time limits (tests/_tier1.py).

At the root of the repo, so that pytest loads it for every run, on the
xdist controller and on its workers, before ``tests/conftest.py``.
"""

import os
import sys

sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests"))

from _tier1 import TimeLimits, pytest_xdist_make_scheduler  # noqa: E402,F401


def pytest_configure(config):
    config.pluginmanager.register(TimeLimits(), "tier1-time-limits")
