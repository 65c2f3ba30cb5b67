"""The benchmark's harness: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic file
(``traffic/<traffic>.json``, whose "kind" names the unit runner
``kinds/<kind>.py``), the limits of its comparison
(``checks/<cell>.json``), a reader per per-layer metric
(``metrics/<metric>.py``) and a byte model per kernel
(``kernels/<kernel>.json``).

A run: set-up (inputs from the seed, the program's set-up, warm-up of
every shape), then a window of back-to-back units that closes at the
end of the first unit that ends after ``--seconds``, then (``--trace
1``) a few more units under ``torch.profiler``, then the comparison with
the plain reference, and last one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from . import tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qex_tpu")


@dataclasses.dataclass
class Context:
    """What a unit runner is built from."""

    cell: dict
    config: dict
    traffic: dict
    dims: tuple
    seed: int
    device: str
    parts: dict = dataclasses.field(default_factory=dict)
    last: float = 0.0

    def mark(self, name: str) -> None:
        """Record the seconds since the last mark as set-up part
        ``name``."""
        sync(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(man: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` that this cell reports."""
    return [m for m in man[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}",
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose whole top-level name is forbidden (so
    ``qex_tpu_torch`` is not ``qex_tpu``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def quantile(values, q: float) -> float:
    """Linear-interpolated quantile of a non-empty list."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window(cell_obj, seconds: float, device: str, err=None):
    """Units back to back until one ends after ``seconds``: (units,
    window seconds, per-unit records).  A unit that raises counts as
    failed; its traceback goes to ``err``."""
    records = []
    sync(device)
    t0 = time.perf_counter()
    i = 0
    while True:
        t_unit = time.perf_counter()
        try:
            rec = cell_obj.unit(i)
        except Exception as exc:          # a unit that raises has failed
            traceback.print_exc(file=err or sys.stderr)
            rec = {"failed": True, "error": repr(exc)[:300]}
        sync(device)
        now = time.perf_counter()
        rec["seconds"] = now - t_unit
        records.append(rec)
        i += 1
        if now - t0 >= seconds:
            return len(records), now - t0, records


def profiled_units(cell_obj, n: int, first: int, traffic: dict, kernels,
                   device: str) -> dict:
    """``n`` more units under torch.profiler with device activity alone,
    which costs the host little: the device's busy seconds within the
    window between two syncs on the host clock, and the kernels' time.
    Then ``n`` more with host activity too and the traffic's spans as
    record_function ranges, which name the idle gaps (host tracing slows
    the host, so these gaps read longer than the first pass's)."""
    from torch.profiler import ProfilerActivity, profile
    is_cuda = torch.device(device).type == "cuda"
    with tracing.fused_launch_counts(kernels) as fused:
        sync(device)
        with profile(activities=[ProfilerActivity.CUDA if is_cuda
                                 else ProfilerActivity.CPU]) as prof:
            sync(device)
            t0 = time.perf_counter()
            for i in range(first, first + n):
                cell_obj.unit(i)
            sync(device)
            window_s = time.perf_counter() - t0
    t_red = time.perf_counter()
    red = tracing.reduce_device(prof, kernels)
    red.update(window_s=window_s, units=n, fused_calls=fused)
    reduce_s = time.perf_counter() - t_red

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if is_cuda
                                     else [])
    with tracing.annotated_spans(traffic.get("spans", []),
                                 cell_obj.objects):
        sync(device)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(tracing.SPAN_PREFIX
                                                + "window"):
                for i in range(first + n, first + 2 * n):
                    with torch.profiler.record_function(
                            tracing.SPAN_PREFIX + "unit"):
                        cell_obj.unit(i)
                sync(device)
    t_red = time.perf_counter()
    named = tracing.idle_by_span(prof)
    red["idle_gaps"] = named.pop("idle_gaps")
    red["host_traced"] = named
    red["reduce_s"] = reduce_s + time.perf_counter() - t_red
    return red


class Trace:
    """What a per-layer metric's reader reads: the traced window's
    spans and counters, the profiled units' device trace, the kernel
    byte models and the card's peaks."""

    def __init__(self, units, window_s, spans, records, profile, kernels,
                 peaks, dims):
        self.units, self.window_s = units, window_s
        self.seconds = spans["seconds"]
        self.calls = spans["calls"]
        self.counters = dict(spans["counters"])
        its = [r["iterations"] for r in records if "iterations" in r]
        if its:
            self.counters["unit.iterations"] = sum(its)
        self.profile, self.kernels, self.peaks = profile, kernels, peaks
        self.dims = dims

    def per_unit(self, value):
        return None if value is None or self.units == 0 else \
            value / self.units

    def idle_share(self):
        """Percent of the device-profiled window with nothing on the
        device."""
        p = self.profile
        if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - p["busy_s"] / p["window_s"])

    def roofline(self, kernel: str):
        """Percent of the kernel's bound (bytes over the card's peak
        bandwidth) that its device time per launch reaches."""
        p, km = self.profile, self.kernels.get(kernel)
        if not p or km is None or not self.peaks:
            return None
        k = p["kernels"].get(kernel)
        if not k or k["launches"] == 0 or k["device_s"] <= 0:
            return None
        sites = math.prod(self.dims) // km["sites_divisor"]
        calls, fused = p["fused_calls"].get(kernel, [0, 0])
        share = fused / calls if calls else 0.0
        per_site = km["bytes_per_site"] + share * km.get(
            "fused_extra_bytes_per_site", 0)
        bound = sites * per_site / self.peaks["bytes_per_s"]
        return 100.0 * bound * k["launches"] / k["device_s"]


def peaks_for(kind: str | None) -> dict | None:
    if kind is None:
        return None
    for entry in load_json(BENCH / "peaks.json")["devices"]:
        if entry["name"] in kind:
            return entry
    return None


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float | None = None, device: str | None = None,
         dims=None, out=None, err=None, traffic_overrides=None) -> int:
    """One run.  ``device``, ``dims`` and ``traffic_overrides`` are for
    the CPU tests only: without them the run needs the cell's CUDA cards
    and runs its traffic file as it stands."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    args = parse(argv)
    man = manifest()
    cell = find(man["workloads"], args.workload, "workload")
    cfg_entry = find(man["configs"], cell["config"], "config")
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    traffic.update(traffic_overrides or {})
    checks = load_json(BENCH / "checks" / f"{cell['name']}.json")
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: this benchmark runs on the card only",
                  file=err)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} cards, found "
                  f"{torch.cuda.device_count()}", file=err)
            return 2
        device = "cuda"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctx = Context(cell, config, traffic,
                  tuple(dims if dims is not None else traffic["dims"]),
                  args.seed, device)
    kernels = {k: load_json(BENCH / "kernels" / f"{k}.json")
               for k in traffic.get("kernels", [])}
    if torch.device(device).type == "cuda":
        from qex_tpu_torch import _native
        srcs = sorted({km["source"] for km in kernels.values()})
        _native.build(srcs)
        for src in srcs:
            _native.load(src)
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    ctx.last = t_start
    ctx.mark("load_and_build_s")
    cell_obj = kind.setup(ctx)
    sync(device)
    setup_s = time.perf_counter() - t_start

    spans = {"seconds": {}, "calls": {}, "counters": {}}
    if args.trace:
        with tracing.synced_spans(traffic.get("spans", []),
                                  cell_obj.objects, device) as spans:
            units, window_s, records = window(cell_obj, args.seconds,
                                              device, err)
    else:
        units, window_s, records = window(cell_obj, args.seconds, device,
                                          err)
    profile = None
    if args.trace:
        profile = profiled_units(cell_obj, traffic["profile_units"],
                                 units, traffic, kernels, device)
    is_cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    kind_name = torch.cuda.get_device_name(0) if is_cuda else None
    dev_info = {"platform": "gpu" if is_cuda else "cpu", "kind": kind_name,
                "count": cell["chips"], "memory_peak_bytes": peak,
                "power_limit": power_limit() if is_cuda else None}
    failed = sum(1 for r in records if r.get("failed"))
    times = [r["seconds"] for r in records]
    print(json.dumps({"cell": cell["name"], "seed": args.seed,
                      "units": units, "window_s": window_s,
                      "setup_s": setup_s, "setup_parts": ctx.parts,
                      "unit_s_median":
                      statistics.median(times), "unit_s_p90":
                      quantile(times, 0.9), "unit_s": times,
                      "units_detail": [{k: v for k, v in r.items()
                                        if k != "seconds"}
                                       for r in records]}), file=err)

    # the reference, once the program's state is freed
    cell_obj.release()
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    try:
        numbers = cell_obj.check()
        check_error = None
    except Exception:                  # a check that cannot run: not correct
        numbers, check_error = {}, traceback.format_exc()[-2000:]
    ref_s = time.perf_counter() - t_ref
    limits = checks["limits"]
    compared = {name: {"value": numbers.get(name), "limit": lim}
                for name, lim in limits.items()}
    correct = (check_error is None and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in compared.values()))

    if args.trace:
        tr = Trace(units, window_s, spans, records, profile, kernels,
                   peaks_for(kind_name), ctx.dims)
        metrics = {}
        for m in cell_metrics(man, cell["name"], "per_layer"):
            value = load_reader(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = profile["busy_s"]
        dev_info["window_s"] = profile["window_s"]
    else:
        values = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30,
                  traffic["rate_metric"]: window_s / units}
        metrics = {}
        for m in cell_metrics(man, cell["name"], "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": correct, "attempted": units, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if args.trace:
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
        print(json.dumps({"spans_s": spans["seconds"],
                          "span_calls": spans["calls"],
                          "counters": tr.counters,
                          "profile": {k: v for k, v in profile.items()
                                      if k not in ("device_ops",
                                                   "idle_gaps")}}),
              file=err)
    if check_error:
        print(f"comparison failed to run: {check_error}", file=err)
    print(json.dumps({"reference_s": ref_s}), file=err)
    checks_line = {name: [c["value"], c["limit"]]
                   for name, c in compared.items()}
    for name, (value, lim) in checks_line.items():
        print(f"check {name} {value!r} limit {lim!r}", file=err)
    result["checks"] = checks_line
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=err)
        return 3
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
