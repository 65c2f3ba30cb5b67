"""The benchmark's own spans, counters and device trace.

Spans wrap the program's functions from outside, by the targets a
traffic file names (an attribute of a module, or of an object the cell
builds); the program itself is not edited.  Two kinds:

* :func:`synced_spans`: each call bracketed by ``torch.cuda.synchronize``
  on the host clock, with exclusive times (a wrapped call inside another
  is subtracted from the outer one) and call counts.  The syncs cost
  time, so only a traced run opens them.
* :func:`annotated_spans`: each call inside a
  ``torch.profiler.record_function`` range and no sync, so that the
  profiler's timeline says what the host was doing during each device
  idle gap.

:func:`reduce_device` turns a ``torch.profiler`` trace into the device's
busy time (union of kernel, copy and set intervals) and kernel device
time and launches by name; :func:`idle_by_span` names a trace's idle
time by the innermost open span.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import re
import time

import torch

SPAN_PREFIX = "bench:"


def _targets(spans, objects):
    """(span, owner, attribute) for each span entry of a traffic file:
    {"name", "attr", and "module" or "object"}; a dotted "attr" walks
    into the module (a class's method: "Class.method")."""
    out = []
    for sp in spans:
        if "module" in sp:
            owner = importlib.import_module(sp["module"])
        else:
            owner = objects[sp["object"]]
        *path, attr = sp["attr"].split(".")
        for part in path:
            owner = getattr(owner, part)
        out.append((sp, owner, attr))
    return out


@contextlib.contextmanager
def _patched(targets, make):
    saved = []
    for sp, owner, attr in targets:
        had = attr in vars(owner)
        old = vars(owner).get(attr)
        saved.append((owner, attr, had, old))
        setattr(owner, attr, make(sp, getattr(owner, attr)))
    try:
        yield
    finally:
        for owner, attr, had, old in reversed(saved):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def synced_spans(spans, objects, device):
    """Yield {"seconds": {name: exclusive s}, "calls": {name: n},
    "counters": {name.iterations: n}} filled while the context is open.
    A span with "stats" counts the ``iterations`` of the (x, stats) its
    function returns."""
    acc = {"seconds": {}, "calls": {}, "counters": {}}
    inner = []

    def make(sp, fn):
        name = sp["name"]
        acc["seconds"].setdefault(name, 0.0)
        acc["calls"].setdefault(name, 0)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            inner.append(0.0)
            try:
                out = fn(*args, **kwargs)
            finally:
                _sync(device)
                dt = time.perf_counter() - t0
                acc["seconds"][name] += dt - inner.pop()
                acc["calls"][name] += 1
                if inner:
                    inner[-1] += dt
            if sp.get("stats"):
                key = f"{name}.iterations"
                acc["counters"][key] = (acc["counters"].get(key, 0)
                                        + int(out[1].iterations))
            return out
        return wrapper

    with _patched(_targets(spans, objects), make):
        yield acc


@contextlib.contextmanager
def annotated_spans(spans, objects):
    """Each wrapped call inside a record_function range named
    ``bench:<span>``."""
    def make(sp, fn):
        label = SPAN_PREFIX + sp["name"]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    with _patched(_targets(spans, objects), make):
        yield


@contextlib.contextmanager
def fused_launch_counts(kernels):
    """Count the calls of each kernel model's program wrapper, and those
    that pass its fused-epilogue argument: {kernel: [calls, fused]}."""
    counts = {}
    targets = []
    for name, km in kernels.items():
        if "wrapper" not in km:
            continue
        module, attr = km["wrapper"].rsplit(".", 1)
        targets.append(({"name": name, "fuse": km.get("fused_argument")},
                        importlib.import_module(module), attr))
        counts[name] = [0, 0]

    def make(sp, fn):
        c = counts[sp["name"]]
        fuse = sp["fuse"]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            c[0] += 1
            if fuse and kwargs.get(fuse) is not None:
                c[1] += 1
            return fn(*args, **kwargs)
        return wrapper

    with _patched(targets, make):
        yield counts


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_and_gaps(device_intervals, window):
    """(busy seconds, idle gaps [(start, end)]) of the device within
    ``window`` = (start, end), all in one clock; busy is the union of
    the intervals clipped to the window."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1)) for s, e in device_intervals
               if e > w0 and s < w1]
    merged = _union(clipped)
    busy = sum(e - s for s, e in merged)
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return busy, gaps


def name_of(t: float, spans) -> str:
    """The innermost span (shortest open interval) containing time t."""
    best, best_len = "(no benchmark span)", None
    for name, s, e in spans:
        if s <= t < e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event of a finished
    profile, read from the profiler's raw results (building
    ``prof.events()`` takes minutes for a trajectory's ~1e5 events).
    User annotations on the device timeline are left out."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            user = getattr(ev, "is_user_annotation", None)
            if name.startswith(SPAN_PREFIX) or (user and user()):
                continue
            out.append((name, True, start, end))
        else:
            out.append((name, False, start, end))
    return out


def reduce_device(prof, kernels) -> dict:
    """Busy seconds of the device over the whole profile (the union of
    its intervals), device time and launches of each kernel model (by
    its "match" regex on the kernel's name) and the device operations
    with most time."""
    device_ev = [(n, s, e) for n, on_device, s, e in _events(prof)
                 if on_device]
    busy = sum(e - s for s, e in _union([(s, e) for _n, s, e in device_ev]))
    by_op = {}
    for n, s, e in device_ev:
        by_op[n] = by_op.get(n, 0) + (e - s)
    kern = {}
    for name, km in kernels.items():
        rx = re.compile(km["match"])
        hits = [(e - s) for n, s, e in device_ev if rx.search(n)]
        kern[name] = {"launches": len(hits), "device_s": sum(hits) / 1e9}
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "kernels": kern,
            "device_events": len(device_ev),
            "device_ops": [[n[:160], t / 1e9] for n, t in top_ops]}


def idle_by_span(prof) -> dict:
    """Window, busy seconds and idle seconds by the innermost open
    benchmark span, of the ``bench:window`` range of a profile with host
    activity."""
    device_ev, spans, window = [], [], None
    for name, on_device, s, e in _events(prof):
        if on_device:
            device_ev.append((s, e))
        elif name.startswith(SPAN_PREFIX):
            label = name[len(SPAN_PREFIX):]
            if label == "window":
                window = (s, e)
            else:
                spans.append((label, s, e))
    if window is None:
        raise RuntimeError("profile: no bench:window range")
    busy, gaps = busy_and_gaps(device_ev, window)
    idle_by = {}
    for s, e in gaps:
        label = name_of(s, spans)
        idle_by[label] = idle_by.get(label, 0) + (e - s)
    top_idle = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (window[1] - window[0]) / 1e9, "busy_s": busy / 1e9,
            "idle_gaps": [[n, t / 1e9] for n, t in top_idle]}
