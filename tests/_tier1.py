"""Tier-1's order of work and its per-test time limits.

Both hold for every run of ``tests/``, with no switch: the repo's root
``conftest.py`` installs them, on the xdist controller and its workers.

* Order.  xdist's ``--dist loadfile`` hands out whole files, those with
  the most tests first, so a long file with one test (the north star)
  started last and set the end of the run.  :func:`queue_order` puts the
  files of :data:`LONG_FILES` first, longest first, and leaves every
  other file in xdist's own order.
* Time limits.  :class:`TimeLimits` arms ``SIGALRM`` around each phase
  (setup, call, teardown) of each test under ``tests/`` that tier-1
  runs.  A phase that overruns fails with its limit in the message, the
  processes it started are killed, and the session goes on.

This module imports neither jax nor torch.
"""

from __future__ import annotations

import contextlib
import math
import os
import signal
import time
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent

# Every file over 100 s of junit time in the tier-1 command (ROADMAP.md)
# on an 8-core host, 6 workers: its seconds in xdist's own order (the
# queue's key), and its longest test in six runs of that command (the
# base of its time limit).  Queued first, longest first.  Every other
# file took under 100 s, short enough to wait behind a long one (see
# pytest_xdist_make_scheduler).
LONG_FILES = {
    "tests/test_stag_hmc.py": (1104.0, 479.2),
    "tests/test_northstar.py": (827.6, 1073.9),
    "tests/test_hasenbusch.py": (744.4, 552.4),
    "tests/test_golden.py": (462.3, 368.4),
    "tests/test_stag_shard.py": (352.8, 121.2),
    "tests/test_fat7.py": (299.0, 188.1),
    "tests/test_gauge_action.py": (285.0, 170.4),
    "tests/test_multichip_dryrun.py": (270.1, 170.0),
    "tests/test_sharded_hotpath.py": (235.9, 86.8),
    "tests/test_wilson_pallas.py": (234.6, 111.1),
    "tests/test_refine.py": (227.8, 184.0),
    "tests/test_stag_pallas.py": (201.9, 79.7),
    "tests/test_torch_parallel.py": (198.3, 198.3),
    "tests/test_torch_hisq.py": (147.3, 77.9),
    "tests/test_observables.py": (146.3, 75.3),
}

# The limit of each phase of a test: twice the longest test of its file
# in LONG_FILES, and at least DEFAULT_LIMIT_S, about twice the longest
# phase of any other file under the tier-1 load (55.7 s, the setup of
# test_torch_puregauge.py::test_integrate[2MN]; its longest test took
# 74.5 s).  No limit exceeds MAX_LIMIT_S, so that a test that hangs from
# the start of the run is cut before tier-1's own clock, CLOCK_S, cuts
# the whole run (the north star, 1,073.9 s at most, gets 1,300 s).
DEFAULT_LIMIT_S = 120.0
MAX_LIMIT_S = 1300.0
CLOCK_S = 1470.0


def file_of(nodeid: str) -> str:
    return nodeid.split("::", 1)[0]


def queue_order(units: dict[str, dict]) -> list[tuple[str, dict]]:
    """``units`` (file -> its tests) in the order they are handed out:
    the files of LONG_FILES first, longest first, then every other file
    in xdist's own order (most tests first)."""
    def key(item):
        path, tests = item
        if path in LONG_FILES:
            return (0, -LONG_FILES[path][0])
        return (1, -len(tests))
    return sorted(units.items(), key=key)


def time_limit(item) -> float | None:
    """Seconds for each phase of ``item``; None (no limit) outside
    ``tests/``."""
    path = Path(item.path).resolve()
    if TESTS not in path.parents:
        return None
    longest = LONG_FILES.get(path.relative_to(TESTS.parent).as_posix(),
                             (0.0, 0.0))[1]
    return min(MAX_LIMIT_S, max(DEFAULT_LIMIT_S, 2 * longest))


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """Under ``--dist loadfile``, xdist's scheduler with the files handed
    out in :func:`queue_order`.

    A worker starts its last test only once it has been sent the next
    one (or told to stop), so xdist sends a worker its next file when
    two of its tests are left.  A worker still on a file of LONG_FILES
    would then hold the next long file long before it could start it:
    it is sent the queue's last, shortest file instead, and the long
    files go to the workers that run dry first."""
    if config.getvalue("dist") != "loadfile":
        return None
    from collections import OrderedDict

    from xdist.scheduler import LoadFileScheduling

    class LongestFirst(LoadFileScheduling):
        def _assign_work_unit(self, node):
            self.workqueue = OrderedDict(queue_order(self.workqueue))
            left = [nodeid for tests in self.assigned_work[node].values()
                    for nodeid, done in tests.items() if not done]
            if any(file_of(nodeid) in LONG_FILES for nodeid in left):
                self.workqueue.move_to_end(next(reversed(self.workqueue)),
                                           last=False)
            super()._assign_work_unit(node)

    return LongestFirst(config, log)


class TimeLimitExceeded(BaseException):
    """A test phase outran its time limit.  A BaseException, so that the
    test's own ``except Exception`` does not swallow it."""


def _ticks() -> int:
    """Now, in the clock ticks since boot of /proc/<pid>/stat."""
    return math.floor(time.clock_gettime(time.CLOCK_BOOTTIME)
                      * os.sysconf("SC_CLK_TCK"))


def _started_since(ticks: int) -> set[int]:
    """The processes below this one that started at ``ticks`` or later,
    read from /proc."""
    children: dict[int, list[int]] = {}
    started: dict[int, int] = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:  # it ended meanwhile
            continue
        pid = int(name)
        children.setdefault(int(fields[1]), []).append(pid)  # ppid
        started[pid] = int(fields[19])  # starttime, field 22
    found, todo = set(), [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), ()):
            if pid not in found:
                found.add(pid)
                todo.append(pid)
    return {pid for pid in found if started[pid] >= ticks}


def _kill(pids: set[int]) -> None:
    for pid in pids:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    for pid in pids:  # reap this process's own children
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)


class TimeLimits:
    """A plugin that gives every phase of a test not marked ``slow``
    ``limit(item)`` seconds, or no limit where that is None."""

    def __init__(self, limit=time_limit):
        self.limit = limit

    @contextlib.contextmanager
    def _armed(self, item, phase):
        seconds = self.limit(item)
        if seconds is None or item.get_closest_marker("slow"):
            # tier-1 does not run a slow test; it keeps its own timeouts
            yield
            return
        start = _ticks()

        def overrun(signum, frame):
            raise TimeLimitExceeded(
                f"{item.nodeid} exceeded its time limit of {seconds:g} s "
                f"({phase})")

        previous = signal.signal(signal.SIGALRM, overrun)
        signal.setitimer(signal.ITIMER_REAL, seconds)
        try:
            yield
        except TimeLimitExceeded:
            _kill(_started_since(start))
            raise
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_setup(self, item):
        with self._armed(item, "setup"):
            return (yield)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_call(self, item):
        with self._armed(item, "call"):
            return (yield)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_teardown(self, item):
        with self._armed(item, "teardown"):
            return (yield)
