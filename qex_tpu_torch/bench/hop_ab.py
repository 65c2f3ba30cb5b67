"""Time the 16-term HISQ hop (B2/B2b) and the v1 hop (B4/B4b) against
the same kernels built from another copy of their sources, on one CUDA
card.

    python -m qex_tpu_torch.bench.hop_ab PARENT_CSRC [--out FILE]

``PARENT_CSRC`` holds an earlier ``hisq16_dslash.cu`` and
``stag_v1_dslash.cu`` whose entry points take no launch grid (one site a
thread, the grid chosen in C): for example ``qex_tpu_torch/csrc`` of a
commit unpacked with ``git archive``.  Each hop runs on random operands,
f32 and bf16 links, at 24^4 and 32^3x64 (HISQ) or 24^4 and 32^4 (v1),
at 8^4, 12^4, 16^4 and 20^4 (where v1's operands fit in L2),
and at two shapes off the vector path, one whose operands fit in the
card's L2 and one whose do not (6x24x24x24 and 30x30x30x32 for HISQ,
X no multiple of 4; 5x24x24x24 and 31x32x32x32 for v1, X odd).  The parent and the kernel behind
the package's wrapper are timed in turns, parent, new, new, parent, each
time by replaying a CUDA graph of 200 launches five times (the median);
both must give the same output.  One JSON line per record on stdout
(and in ``FILE``): first the card's name and power limit, the stream
bandwidth and the ptxas lines of the parent's build and of the
package's (when this process builds it).  Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from .. import _native
from ..lattice import Lattice
from ..physics import stag_hisq as sh
from ..physics import stag_pallas as sp1

PEAK_BYTES_S = 3.35e12
BYTES_PER_SITE = {("hisq16", torch.float32): 1200,
                  ("hisq16", torch.bfloat16): 624,
                  ("v1", torch.float32): 624, ("v1", torch.bfloat16): 336}
SHAPES = {"hisq16": ((24, 24, 24, 24), (32, 32, 32, 64), (8, 8, 8, 8),
                     (12, 12, 12, 12), (16, 16, 16, 16), (20, 20, 20, 20),
                     (6, 24, 24, 24), (30, 30, 30, 32)),
          "v1": ((24, 24, 24, 24), (32, 32, 32, 32), (8, 8, 8, 8),
                 (12, 12, 12, 12), (16, 16, 16, 16), (20, 20, 20, 20),
                 (5, 24, 24, 24), (31, 32, 32, 32))}
SOURCES = {"hisq16": "hisq16_dslash.cu", "v1": "stag_v1_dslash.cu"}
ENTRIES = {"hisq16": "qex_hisq16_dslash", "v1": "qex_stag_v1_dslash"}
GEOMETRY = {"hisq16": lambda dims, ldt: sh.hisq16_geometry(dims),
            "v1": sp1.v1_geometry}
TOL = 1e-12


def graph_time_ms(fn, reps: int = 200, rounds: int = 5) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``rounds`` times between CUDA events (median)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def stream_gbs() -> float:
    """Read+write bandwidth of an out-of-place scale over 512 MB."""
    x = torch.ones(128 * 1024 * 1024, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    ms = graph_time_ms(lambda: torch.mul(x, 1.000001, out=y), reps=20)
    return 2 * x.numel() * 4 / (ms * 1e-3) / 1e9


def ptxas_lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]


def build_parent(csrc: Path) -> dict:
    """hop -> (ctypes library, ptxas lines) of ``csrc``'s sources, one
    ``nvcc`` each, started together with the package's own build."""
    out_dir = _native.BUILD_DIR / "hop_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for hop, src in SOURCES.items():
        so = out_dir / f"libparent_{hop}.so"
        cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-o", str(so),
               str(csrc / src)]
        procs[hop] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True))
    _native.build(list(SOURCES.values()))
    libs = {}
    for hop, (so, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {hop}:\n"
                               f"{stdout}{stderr}")
        libs[hop] = (ctypes.CDLL(str(so)), ptxas_lines(stderr))
    return libs


def rel2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((got - ref).abs() ** 2).sum() / (ref.abs() ** 2).sum())


def operands(hop: str, dims, ldt, gen):
    """Random operands of one hop: the parent's pointer arguments before
    its output, their ctypes types, its scalar arguments, the call
    through the package's wrapper, and (operator, spinor), which must
    stay alive."""
    X, Y, Z, T = dims
    tail = (T // 2, Z, Y * X)
    if hop == "hisq16":
        links = torch.randn((16, 2, 3, 3) + tail, generator=gen,
                            device="cuda").to(ldt)
        x = torch.randn((3,) + tail, dtype=torch.complex64, generator=gen,
                        device="cuda")
        ptrs = (links.data_ptr(), x.data_ptr(), None)
        head = [ctypes.c_void_p] * 4 + [ctypes.c_float]
        extra = (0.0,)
        op = sh.Hisq16EO(Lattice(dims), links, links)
        new = lambda: sh.dslash_hisq16(op, x, 0)
    else:
        a, b = (torch.randn((2, 4, 3, 3) + tail, generator=gen,
                            device="cuda").to(ldt) for _ in range(2))
        x = torch.randn((2, 3) + tail, generator=gen, device="cuda")
        ptrs = (a.data_ptr(), b.data_ptr(), x.data_ptr())
        head = [ctypes.c_void_p] * 4
        extra = ()
        op = sp1.PallasStagEO(Lattice(dims), a, b)
        new = lambda: sp1.dslash_pallas(op, x, 0)
    return ptrs, head, extra, new, (op, x)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qex_tpu_torch.bench.hop_ab",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path,
                    help="directory of the earlier hisq16_dslash.cu and "
                         "stag_v1_dslash.cu")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hop_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    parent = build_parent(args.parent)
    bw = stream_gbs()
    emit({"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "stream_gbs": bw,
          "ptxas_parent": {h: p for h, (_, p) in parent.items()},
          "ptxas_new": {h: ptxas_lines(_native.BUILD_LOG.get(
              src, {}).get("ptxas", "")) for h, src in SOURCES.items()}})
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    for hop in SOURCES:
        for ldt in (torch.float32, torch.bfloat16):
            fn = getattr(parent[hop][0], ENTRIES[hop]
                         + ("_bf16" if ldt == torch.bfloat16 else ""))
            for dims in SHAPES[hop]:
                ptrs, head, extra, new, keep = operands(hop, dims, ldt, gen)
                X, Y, Z, T = dims
                fn.argtypes = head + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int

                def old():
                    # a new output a call, as the wrappers allocate; the
                    # current stream, a side stream under graph capture
                    out = torch.empty_like(keep[1])
                    err = fn(*ptrs, out.data_ptr(), *extra, X, Y, Z, T // 2,
                             0, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"parent {hop}: CUDA error {err}")
                    return out

                dev = rel2(new(), old().clone())
                if not dev <= TOL:
                    raise AssertionError(f"{hop} {ldt} {dims}: new against "
                                         f"parent {dev}")
                us = {"parent": [], "new": []}
                for who in ("parent", "new", "new", "parent"):
                    us[who].append(1e3 * graph_time_ms(
                        old if who == "parent" else new))
                nbytes = BYTES_PER_SITE[(hop, ldt)] * X * Y * Z * T // 2
                emit({"hop": hop, "links": str(ldt).split(".")[-1],
                      "dims": list(dims), "rel2_new_vs_parent": dev,
                      "new_vector_path": GEOMETRY[hop](dims, ldt).vector,
                      "parent_us": us["parent"], "new_us": us["new"],
                      "bound_us": nbytes / PEAK_BYTES_S * 1e6,
                      "bound_at_stream_us": nbytes / (bw * 1e9) * 1e6,
                      "new_share_of_stream":
                          nbytes / (min(us["new"]) * 1e-6) / (bw * 1e9)})
                del keep, new
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
