"""The metric arithmetic on synthetic inputs, and the byte models
against PERF.md's bounds."""

import math
import time

import pytest

from benchmark import harness, tracing


def test_idle_share_from_intervals():
    # busy [1, 3] and [2, 5] overlap; [7, 8] apart; window [0, 10]
    busy, gaps = tracing.busy_and_gaps([(2, 5), (1, 3), (7, 8)], (0, 10))
    assert busy == 5
    assert gaps == [(0, 1), (5, 7), (8, 10)]
    # clipped to the window
    busy, gaps = tracing.busy_and_gaps([(-2, 1), (9, 12)], (0, 10))
    assert busy == 2 and gaps == [(1, 9)]


def test_idle_gap_named_by_innermost_span():
    spans = [("unit", 0, 10), ("solve", 2, 6), ("smear", 3, 4)]
    assert tracing.name_of(3.5, spans) == "smear"
    assert tracing.name_of(5, spans) == "solve"
    assert tracing.name_of(8, spans) == "unit"
    assert tracing.name_of(11, spans) == "(no benchmark span)"


class Sleeper:
    objects = {}

    def __init__(self, stall_at=None):
        self.stall_at = stall_at

    def unit(self, i):
        time.sleep(0.04 if i == self.stall_at else 0.01)
        return {"iterations": 10}


def test_window_rate_moves_with_a_stall():
    n0, w0, _r = harness.window(Sleeper(), 0.2, "cpu")
    n1, w1, _r = harness.window(Sleeper(stall_at=3), 0.2, "cpu")
    assert w0 >= 0.2 and w1 >= 0.2
    assert w1 / n1 > w0 / n0


def trace_with(profile, dims=(24, 24, 24, 24)):
    kernels = {"b1": harness.load_json(harness.BENCH / "kernels" / "b1.json")}
    spans = {"seconds": {"solve": 2.0}, "calls": {"solve": 4},
             "counters": {"solve.iterations": 400}}
    records = [{"iterations": 100, "seconds": 1.0}] * 4
    peaks = harness.peaks_for("NVIDIA H100 80GB HBM3")
    return harness.Trace(4, 4.0, spans, records, profile, kernels, peaks,
                         dims)


def test_roofline_and_idle_share_arithmetic():
    bound = 12 * (24 ** 4 // 2) * 636 / 3.35e12   # 12 launches, half fused
    prof = {"window_s": 1.0, "busy_s": 0.75,
            "kernels": {"b1": {"launches": 12, "device_s": 2 * bound}},
            "fused_calls": {"b1": [12, 6]}}
    tr = trace_with(prof)
    assert math.isclose(tr.roofline("b1"), 50.0)
    assert math.isclose(tr.idle_share(), 25.0)
    assert harness.load_reader("cg_iters.traj").read(tr) == 100
    assert math.isclose(harness.load_reader("cg_iter_ms.solve").read(tr),
                        10.0)
    assert math.isclose(harness.load_reader("cg_s.traj").read(tr), 0.5)


def test_readers_return_nothing_without_data():
    tr = trace_with(None)
    for name in ("b1_roofline.traj", "idle_share.traj", "smear_s.traj",
                 "b2_roofline.solve"):
        assert harness.load_reader(name).read(tr) is None


@pytest.mark.parametrize("kernel,dims,bound_us", [
    ("b1", (24, 24, 24, 24), 30.9),     # PERF.md table: 624 B/site
    ("b2", (32, 32, 32, 64), 375.6),    # 1,200 B/site
    ("b2", (24, 24, 24, 24), 59.4),
])
def test_byte_models_against_the_kernel_table(kernel, dims, bound_us):
    km = harness.load_json(harness.BENCH / "kernels" / f"{kernel}.json")
    peak = harness.peaks_for("NVIDIA H100 80GB HBM3")["bytes_per_s"]
    sites = math.prod(dims) // km["sites_divisor"]
    got = sites * km["bytes_per_site"] / peak * 1e6
    assert abs(got - bound_us) < 0.05
