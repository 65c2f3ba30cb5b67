"""Tier-1's order of work and its per-test time limits (tests/_tier1.py).

The scheduler is driven with fake workers, without starting xdist; the
time limit is checked in an inner pytest session of its own."""

import os
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest

import _tier1

pytest_plugins = ["pytester"]

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


@pytest.fixture(scope="module")
def collected():
    """The node ids of the table's files that tier-1 selects."""
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-m", "not slow", "-p", "no:cacheprovider", "-p", "no:xdist",
         *sorted(_tier1.LONG_FILES)],
        cwd=REPO, capture_output=True, text=True, timeout=100)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return [line for line in res.stdout.splitlines() if "::" in line]


def test_table_files_exist_and_are_collected(collected):
    files = Counter(_tier1.file_of(n) for n in collected)
    for path in _tier1.LONG_FILES:
        assert os.path.isfile(os.path.join(REPO, path)), path
        assert files[path] > 0, f"{path}: no test selected by -m 'not slow'"


class _Worker:
    """What the scheduler sees of an xdist worker: it records the test
    indices it is sent."""

    def __init__(self, name):
        self.gateway = SimpleNamespace(id=name)
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def _run_schedule(collection, nworkers=6):
    """Drive the hook's scheduler over ``collection`` to its end, each
    worker completing its tests in turn; returns every test handed out
    and the workers."""
    values = {"dist": "loadfile", "tx": [f"{nworkers}*popen"]}
    config = SimpleNamespace(getvalue=values.__getitem__,
                             option=SimpleNamespace(loadscopereorder=True))
    sched = _tier1.pytest_xdist_make_scheduler(config=config, log=None)
    workers = [_Worker(f"gw{i}") for i in range(nworkers)]
    for w in workers:
        sched.add_node(w)
    for w in workers:
        sched.add_node_collection(w, collection)
    sched.schedule()
    done = {w: 0 for w in workers}
    while any(done[w] < len(w.sent) for w in workers):
        for w in workers:
            if done[w] < len(w.sent):
                sched.mark_test_complete(w, w.sent[done[w]])
                done[w] += 1
    assert sched.tests_finished
    return [collection[i] for w in workers for i in w.sent], workers


def _fake_collection(collected):
    """The table's real tests among made-up files of 1 to 5 tests."""
    others = [f"tests/test_other{k}.py::test_{i}"
              for k in range(1, 6) for i in range(k)]
    return others[:7] + collected + others[7:]


def _units(collection):
    units = {}
    for nodeid in collection:
        units.setdefault(_tier1.file_of(nodeid), {})[nodeid] = False
    return units


def test_queue_order_puts_the_table_first_longest_first(collected):
    units = _units(_fake_collection(collected))
    order = [path for path, _ in _tier1.queue_order(units)]
    n = len(_tier1.LONG_FILES)
    assert order[:n] == sorted(_tier1.LONG_FILES, reverse=True,
                               key=lambda path: _tier1.LONG_FILES[path][0])
    rest = [len(units[path]) for path in order[n:]]
    assert rest == sorted(rest, reverse=True)


def test_scheduler_hands_out_every_test_once(collected):
    collection = _fake_collection(collected)
    handed, workers = _run_schedule(collection)
    assert Counter(handed) == Counter(collection)
    assert all(w.shutting_down for w in workers)
    units = _units(collection)
    order = [path for path, _ in _tier1.queue_order(units)]
    firsts = [_tier1.file_of(collection[w.sent[0]]) for w in workers]
    assert firsts == order[:len(workers)]
    # a worker sent a long file of two tests or fewer is sent the
    # shortest file next, not the next long one
    short = [w for w, path in zip(workers, firsts) if len(units[path]) <= 2]
    assert short, "no long file of two tests or fewer among the first"
    nexts = [_tier1.file_of(collection[w.sent[len(units[path])]])
             for w, path in zip(workers, firsts) if w in short]
    assert nexts == order[::-1][:len(short)]


def test_every_limit_fires_inside_the_clock():
    def limit(path):
        return _tier1.time_limit(SimpleNamespace(path=Path(REPO, path)))

    for path, (_, longest) in _tier1.LONG_FILES.items():
        assert 1.2 * longest <= limit(path) < _tier1.CLOCK_S, path
    assert limit("tests/test_config.py") == _tier1.DEFAULT_LIMIT_S
    # the benchmark's own tests keep no limit
    assert limit("benchmark/tests/test_bench_faults.py") is None


_INNER_CONFTEST = """
    import sys
    sys.path.insert(0, {tests!r})
    from _tier1 import TimeLimits

    def pytest_configure(config):
        config.pluginmanager.register(TimeLimits(lambda item: 1.0))
"""

_INNER_TESTS = """
    import subprocess
    import sys
    import time

    import pytest

    def test_sleeps():
        child = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(120)"])
        with open("child.pid", "w") as f:
            f.write(str(child.pid))
        time.sleep(60)

    def test_after():
        assert True

    @pytest.mark.slow
    def test_slow_keeps_its_own_timeouts():
        time.sleep(1.5)
"""


def test_overrun_fails_alone_and_kills_its_children(pytester):
    pytester.makeconftest(textwrap.dedent(_INNER_CONFTEST).format(
        tests=TESTS))
    pytester.makepyfile(test_inner=textwrap.dedent(_INNER_TESTS))
    res = pytester.runpytest_subprocess("-p", "no:cacheprovider",
                                        "-p", "no:xdist", timeout=60)
    res.assert_outcomes(passed=2, failed=1)
    res.stdout.fnmatch_lines([
        "*test_inner.py::test_sleeps exceeded its time limit of 1 s (call)*"])
    pid = int((pytester.path / "child.pid").read_text())
    assert not os.path.exists(f"/proc/{pid}")
