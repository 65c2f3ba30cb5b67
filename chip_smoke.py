#!/usr/bin/env python3
"""Drive the qex_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Phases, each printed as one JSON line:
  1. device: the card's name and power limit (nvidia-smi), the kernel build;
  2. kernel: the 8-term staggered CUDA kernel with float32 links (B1) and
     with bfloat16 links (B1b) against their plain torch version at 24^4
     and 8x4x4x8, and the 16-term HISQ kernel with float32 (B2) and
     bfloat16 links (B2b) at 24^4, 8x4x4x8, 4^4 and 6x3x5x4, with times
     (CUDA-graph replay, and eager launches beside), GB/s (624, 336,
     1,200 and 624 B/site: each input read once, the output written
     once), bounds and the share of this card's measured stream
     bandwidth;
  3. solve: stag_solve.solve at 24^4, m=0.05, r2req 1e-10 (complex64),
     with float32 links and sloppy (bf16 inner iterations, float32
     true-residual restarts);
  4. hmc: two trajectories of LatticeFieldTheory.hmc_step at 24^4, the
     BASELINE config-4 action without smearing (Wilson beta=7.0 + one
     staggered fermion m=0.05 + one Pauli-Villars boson m=0.5);
  5. ab: one 8^4 trajectory of that action with identical injected draws,
     once through the kernel on the card and once through the plain
     operator (CPU tensors take the plain fast-layout operator);
  6. hmc_smeared: config 4 as it is run, nHYP (0.4, 0.5, 0.5) on the
     matter links, at 24^4: two trajectories, then one more with the time
     split into smear forward, smear pullback, solves and the rest;
  7. app: the production app (qex_tpu_torch.apps.staghmc_spv.main) on the
     committed config-4 deck with sloppy solves, two trajectories with a
     checkpoint after each, then a resume from the first checkpoint that
     must repeat the second trajectory;
  8. ab_smeared: phase 5 for the smeared action with sloppy solves, from
     smoother links (see AB_SMEARED_START);
  9. hisq_solve: BASELINE config 5's solve at 32^3x64: HISQ fattening,
     HisqFermion.solve_multi at masses 0.05-0.4 on B2 with each mass's
     true residual, the sloppy solve at m=0.05 (B2b inner iterations, B2
     true residuals), and B2/B2b timed at that volume (graph replay and
     eager launches);
 10. hmc_hisq: two trajectories of a HISQ theory (Wilson beta=7.0 + one
     HISQ fermion m=0.05) at 24^4 from smoother links (see HISQ_START),
     the second split into fattening forward, fattening pullback, solves
     and the rest;
 11. ab_hisq: phase 5 for the HISQ theory at 8^4 from those links;
 12. wilson_kernel: the Wilson hop kernel with float32 (B3) and bfloat16
     links (B3b) against its plain twin, both parities, m_ee_w and
     m_ee_dag_w, at 6x4x4x8, 4x4x8x8, 24^3x32 and 32^3x64, timed at the
     last two (768 and 480 B/site, 1344 flop/site);
 13. wilson_solve: exp_wilson.py's eo CGNE solve at 24^3x32, m=0.1, bc
     pppa, r2req 1e-12, float32 links and sloppy;
 14. wilson_mesons: the 12 point-source propagators of the measure app
     through solve_eo at 24^3x32 and all nine Wilson meson channels;
 15. wilson_mg: exp_mg_ab.py's composition (m=0.005, bc pppp, r2req
     1e-8) at 8^3x16 and 16^3x32: CGNE through B3 against the K-cycle
     multigrid (setup, warm solve on the reused hierarchy, break-even);
 16. stag_generations_kernel: the older staggered kernels (v1 B4/B4b, v2
     B5, v3 B6/B6b, v4 B7/B7b with and without compute_only, the split
     modes B8) against their plain twins, both parities, with the
     d2ee/d2dd of each, at 8x4x4x8 and 32^4 (v1 also at 6x3x5x4); at
     32^4 each generation against the 8-term kernel B1/B1b on the same
     links, and B8's full mode against 1/2 (F - B) of the v3 links;
 17. stag_generations_time: the generation benchmark's A/B at 32^4
     (qex_tpu_torch.bench.stag_generations.ab, every instance, B1/B1b
     beside them), then each instance timed over 200 launches against
     its plain twin at 24^4 and 32^4;
 18. stag_generations_cg: solvers.cg.cg_solve at 32^4, m=0.1, r2req
     1e-10, through d2ee of v1, v2, v3, v4 and B1.
The launch counters are set to 0 just before each main-path phase (4, 6,
7, 9, 10, 13, 14, 15, the A/B of 17, 18) and read just after it.  Then
the card line, the kernels summary and, last, the ok line.  Any failed
check raises, so the script exits non-zero and prints no ok line;
without a CUDA device it exits non-zero at once.

``--profile`` instead runs a 24^4 f32 solve, a sloppy solve, one smeared
config-4 trajectory, one HISQ trajectory and a 24^3x32 Wilson eo solve
under torch.profiler and prints each one's wall time, device kernel
count, device-idle share and top operators.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED = 20261016
ROOT = Path(__file__).resolve().parent
TOL_KERNEL = 1e-12      # squared relative deviation, as the JAX kernel tests
TOL_RES = 1e-9          # true relative residual^2 of a solve at r2req 1e-10
# Kernel against plain trajectory at 8^4 (phases 5 and 8).  Both runs are
# float32 with the same draws; they differ by float32 rounding (the
# kernel sums in another order, and the plain run is on the host) and by
# where each CG stops within its tolerance.  Force solves stop at
# relative residual 1e-4 (r2req 1e-8), so forces may differ at 1e-4
# relative; integrated over tau=0.5 that moves links by far less than
# 1e-3.  dH is a float64 difference of sums of float32 per-site values:
# each run carries rounding of order eps_f32 * |H| (~6e-8 |H|), so two
# runs may differ by a small multiple of that; allow 1e-5 |H|.
TOL_AB_LINK = 1e-3
TOL_AB_DH_REL_H = 1e-5
# Phase 8 starts from smoother links, expm(0.3 tah), than phase 5's
# expm(0.7 tah).  From the rough start the smeared config-4 trajectory is
# unstable (|dH| ~ 6.5 |H| at 8^4), and float32 rounding grows along it:
# on the host alone, complex64 against complex128 with the plain
# operator (python -m qex_tpu_torch.apps.md_precision --cpu -ns=8 -nt=8)
# differ by 2.1e-3 in the links and 83 in dH (5.9e-4 and 28 with sloppy
# solves), against 7.7e-6 and 0.018 from the smooth start (|dH| ~ 1).
# So the rough start cannot tell a kernel fault from rounding.  The
# tolerances stay those of phase 5.
AB_SMEARED_START = 0.3
# The HISQ phases 10 and 11 start from expm(0.3 tah) links too.  From
# the expm(0.7 tah) start of the other phases the first HISQ force at
# 24^4 reaches 1.9e12 (max |F|; python -m qex_tpu_torch.apps.hisq_forces
# prints it): a few first-level fat7 links are nearly singular, where the
# exact derivative of the polar projection diverges (ROADMAP C4, C5), and
# the first gauge update overflows to NaN.  From expm(0.3 tah) the force
# stays below 1.5.
HISQ_START = 0.3
TOL_RESUME = 1e-10      # relative: a resume repeats the chain exactly
# The multishift solve has no restarts, so its true residual is held to
# 100x its r2req (phase 9).
TOL_MULTI = 1e-8
# H100 SXM data sheet (dense, 700 W): the bounds of the kernels line
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# per output site: flops (the reference's models) and bytes (links,
# spinor and output, each once) of the 8- and 16-term staggered hops and
# the Wilson hop
FLOPS_PER_SITE = {"stag8": 594, "hisq16": 1152, "wilson8": 1344}
BYTES_PER_SITE = {("stag8", torch.float32): 624,
                  ("stag8", torch.bfloat16): 336,
                  ("hisq16", torch.float32): 1200,
                  ("hisq16", torch.bfloat16): 624,
                  ("wilson8", torch.float32): 768,
                  ("wilson8", torch.bfloat16): 480}
KERNELS = {   # name: (hop kind, links dtype, launch counter)
    "stag8_dslash": ("stag8", torch.float32, "launches"),
    "stag8_dslash_bf16": ("stag8", torch.bfloat16, "launches_bf16"),
    "hisq16_dslash": ("hisq16", torch.float32, "launches"),
    "hisq16_dslash_bf16": ("hisq16", torch.bfloat16, "launches_bf16"),
    "wilson8_hop": ("wilson8", torch.float32, "launches"),
    "wilson8_hop_bf16": ("wilson8", torch.bfloat16, "launches_bf16"),
}
# the older staggered generations (phases 16-18): name -> (kind, links
# dtype, launch counter); kind v1..v4 or split, as the generation
# benchmark's Instance.kind, and for split the counter names the mode
KERNELS.update({
    "stag_v1_dslash": ("v1", torch.float32, "launches"),
    "stag_v1_dslash_bf16": ("v1", torch.bfloat16, "launches_bf16"),
    "stag_v2_dslash": ("v2", torch.float32, "launches"),
    "stag_v3_dslash": ("v3", torch.float32, "launches"),
    "stag_v3_dslash_bf16": ("v3", torch.bfloat16, "launches_bf16"),
    "stag_v4_dslash": ("v4", torch.float32, "launches"),
    "stag_v4_dslash_bf16": ("v4", torch.bfloat16, "launches_bf16"),
    "stag_v4_compute_only": ("v4", torch.float32, "launches_compute_only"),
    "stag_v4_compute_only_bf16": ("v4", torch.bfloat16,
                                  "launches_compute_only_bf16"),
    **{f"stag_v3_split_{m}": ("split", torch.float32, f"launches_{m}")
       for m in ("dma", "matvec", "shifts", "compute", "full")}})
GEN_KINDS = ("v1", "v2", "v3", "v4", "split")
SOURCES = {"stag8": "stag8_dslash.cu", "hisq16": "hisq16_dslash.cu",
           "wilson8": "wilson8_dslash.cu", "v1": "stag_v1_dslash.cu",
           "v2": "stag_v2_dslash.cu", "v3": "stag_v3_dslash.cu",
           "v4": "stag_v3_dslash.cu", "split": "stag_v3_dslash.cu"}
REPLACES = {"stag8": "qex_tpu/physics/stag_pallas_hisq.py:166",
            "hisq16": "qex_tpu/physics/stag_pallas_hisq.py:166",
            "wilson8": "qex_tpu/physics/wilson_pallas.py:167",
            "v1": "qex_tpu/physics/stag_pallas.py:69",
            "v2": "qex_tpu/physics/stag_pallas2.py:59",
            "v3": "qex_tpu/physics/stag_pallas3.py:123",
            "v4": "qex_tpu/physics/stag_pallas4.py:39",
            "split": "exp_pallas3.py:19"}
# an odd-extent shape for the kernel checks of B2/B2b (phase 2) and
# B4/B4b (phase 16): odd Y and Z, an x extent that the 16-term kernel's
# four-site path does not divide, V = 180 (a bf16 link plane of 360 B is
# no multiple of 16); its fields come from a generator of their own, so
# that the main-path phases draw what they drew before the check existed
ODD_DIMS = (6, 3, 5, 4)
# phases 16-18: the generation benchmark's volume and CG (exp_s8.py:36)
GEN_DIMS = (32, 32, 32, 32)
GEN_MASS = 0.1
TOL_CG_ITS = 2          # CG iterations within +-2 of B1's
# Wilson solves (phases 13-14): true relative r^2 of D x = b, by the
# plain operator in complex128; exp_wilson.py's r2req 1e-12 for phase 13
TOL_WILSON = 1e-11
# where the chip run keeps the app's checkpoints (gitignored)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


def odd_generator():
    """The generator of the ODD_DIMS checks (see ODD_DIMS)."""
    return torch.Generator(device="cuda").manual_seed(SEED + 1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean per-call time of ``reps``
    back-to-back calls, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_time_ms(fn, reps: int = 200, rounds: int = 5) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    the graph replayed ``rounds`` times between CUDA events (median), so
    the host's cost of each launch lies outside the timed window."""
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


def timed_once_s(fn):
    """(result, seconds) of one call, by CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def rel2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((got - ref).abs() ** 2).sum() / (ref.abs() ** 2).sum())


def random_links(lat, gen, dtype=torch.complex64, scale: float = 0.7):
    """expm(scale * random_tah) per link (0.7: tests/test_stag_pallas.py)."""
    from qex_tpu_torch.ops import group, linalg
    return torch.stack([linalg.expm(scale * group.random_tah(
        gen, lat.dims, lat.nc, dtype)) for _ in range(lat.nd)])


def _wrapper(kind: str):
    from qex_tpu_torch.bench import exp_pallas3 as ep3
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_pallas as sp1
    from qex_tpu_torch.physics import stag_pallas2 as sp2
    from qex_tpu_torch.physics import stag_pallas3 as sp3
    from qex_tpu_torch.physics import stag_pallas4 as sp4
    from qex_tpu_torch.physics import wilson_pallas as wp
    return {"stag8": sh.dslash_stag8, "hisq16": sh.dslash_hisq16,
            "wilson8": wp.hop_w, "v1": sp1.dslash_pallas,
            "v2": sp2.dslash_pallas2, "v3": sp3.dslash_pallas3,
            "v4": sp4.dslash_pallas4, "split": ep3.run}[kind]


def reset_counts() -> None:
    for kind, _ldt, counter in KERNELS.values():
        setattr(_wrapper(kind), counter, 0)


def read_counts() -> dict:
    return {name: getattr(_wrapper(kind), counter)
            for name, (kind, _ldt, counter) in KERNELS.items()}


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from qex_tpu_torch import _native
    sources = sorted(set(SOURCES.values()))
    t0 = time.perf_counter()
    _native.build(sources)                 # one nvcc each, in parallel
    for src in sources:
        _native.load(src)
    build_s = time.perf_counter() - t0
    nvcc, ptxas = {}, {}
    for src in sources:
        log = _native.BUILD_LOG.get(src, {})
        nvcc[src] = log.get("seconds")
        ptxas[src] = [ln.strip() for ln in log.get("ptxas", "").splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling" in ln]
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "nvcc_s": nvcc, "ptxas": ptxas})
    return {"smi": smi}


def stream_bandwidth_gbs() -> float:
    """Read+write bandwidth of an out-of-place scale over 512 MB."""
    n = 128 * 1024 * 1024
    x = torch.ones(n, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    ms = cuda_time_ms(lambda: torch.mul(x, 1.000001, out=y), reps=20)
    del x, y
    return 2 * 4 * n / (ms * 1e-3) / 1e9


def hisq_links(lat, u):
    """Fat and long links of u, phased and smeared as
    HisqFermion._links does (forward only)."""
    from qex_tpu_torch.gauge import fat7
    from qex_tpu_torch.physics import staggered as st
    return fat7.hisq_links_lowmem(lat, st.phase_links(lat, u))


def hop_fns(kind: str):
    """(hop, plain hop, d2ee) of the 8- or 16-term kernel."""
    from qex_tpu_torch.physics import stag_hisq as sh
    if kind == "stag8":
        return sh.dslash_stag8, sh.dslash_stag8_plain, sh.d2ee_stag8
    return sh.dslash_hisq16, sh.dslash_hisq16_plain, sh.d2ee_hisq16


def make_ops(kind: str, lat, u):
    """links dtype -> kernel-ready operator of links u (the 16-term one
    on their HISQ fat and long links, computed once)."""
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import staggered as st
    if kind == "stag8":
        s = st.new_stag_eo(lat, u)
        return lambda ldt: sh.new_stag8(s, links_dtype=ldt)
    s3 = st.new_stag3_eo(lat, *hisq_links(lat, u))
    return lambda ldt: sh.new_hisq16(s3, links_dtype=ldt)


def compare_hop(name: str, op, x, f32_op=None) -> dict:
    """Kernel against its plain twin on the same links: both parities
    and the fused d2ee; raises past TOL_KERNEL."""
    kind = KERNELS[name][0]
    hop, plain, d2ee = hop_fns(kind)
    res, max_abs = {}, 0.0
    for parity in (0, 1):
        got = hop(op, x, parity)
        ref = plain(op, x, parity)
        torch.cuda.synchronize()
        res[f"rel2_parity{parity}"] = rel2(got, ref)
        max_abs = max(max_abs, float((got - ref).abs().max()))
    m = 0.05
    got = d2ee(op, x, m)
    ref = (m * m) * x - plain(op, plain(op, x, 1), 0)
    torch.cuda.synchronize()
    res["rel2_d2ee"] = rel2(got, ref)
    res["max_abs_err"] = max(max_abs, float((got - ref).abs().max()))
    if f32_op is not None:
        # information only: the bf16 operator against the f32 one
        res["rel2_bf16_vs_f32_d2ee"] = rel2(got, d2ee(f32_op, x, m))
    for key in ("rel2_parity0", "rel2_parity1", "rel2_d2ee"):
        if not res[key] <= TOL_KERNEL:
            raise AssertionError(f"{name} at {tuple(x.shape)}: {key} "
                                 f"{res[key]}")
    return res


def time_hop(name: str, op, x, sites: int) -> dict:
    """Kernel time by CUDA-graph replay ("ms", the device time) and by
    eager launches, plain twin and fused d2ee times (CUDA events), GB/s
    by the bytes model and the kernel's bound at the data-sheet peaks."""
    kind, ldt, _ = KERNELS[name]
    hop, plain, d2ee = hop_fns(kind)
    nbytes = BYTES_PER_SITE[(kind, ldt)] * sites
    flops = FLOPS_PER_SITE[kind] * sites
    k_ms = graph_time_ms(lambda: hop(op, x, 0))
    eager_ms = cuda_time_ms(lambda: hop(op, x, 0), reps=200)
    p_ms = cuda_time_ms(lambda: plain(op, x, 0), reps=10)
    ee_ms = cuda_time_ms(lambda: d2ee(op, x, 0.05), reps=100)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    return {"ms": k_ms, "ms_eager_launches": eager_ms, "plain_ms": p_ms,
            "d2ee_ms": ee_ms,
            "gflops": flops / (k_ms * 1e-3) / 1e9,
            "bytes": nbytes, "gbs": nbytes / (k_ms * 1e-3) / 1e9,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def add_stream_share(rec: dict, bw: float) -> None:
    rec["stream_gbs"] = bw
    rec["share_of_stream_bw"] = rec["gbs"] / bw
    rec["bound_at_stream_us"] = rec["bytes"] / (bw * 1e9) * 1e6


def fast_vector(lat, gen):
    X, Y, Z, T = lat.dims
    return torch.randn((3, T // 2, Z, Y * X), dtype=torch.complex64,
                       generator=gen, device=gen.device)


def dims_label(dims) -> str:
    return (f"{dims[0]}^4" if len(set(dims)) == 1
            else "x".join(str(d) for d in dims))


def phase_kernel(gen) -> dict:
    """Each kernel against its plain twin at 24^4 (timed), 8x4x4x8 and,
    for the 16-term kernels, 4^4 (Th = 2, distance-3 wraps at extent
    4) and ODD_DIMS, on expm(0.7 tah) links (HISQ-smeared for the
    16-term ones)."""
    from qex_tpu_torch.lattice import Lattice
    out = {}
    for kind in ("stag8", "hisq16"):
        sizes = [(24, 24, 24, 24), (8, 4, 4, 8)]
        if kind == "hisq16":
            sizes += [(4, 4, 4, 4), ODD_DIMS]
        for i, dims in enumerate(sizes):
            lat = Lattice(dims)
            g = odd_generator() if dims == ODD_DIMS else gen
            build = make_ops(kind, lat, random_links(lat, g))
            f32_op = build(torch.float32)
            x = fast_vector(lat, g)
            for name, (k, ldt, _c) in KERNELS.items():
                if k != kind:
                    continue
                op = f32_op if ldt == torch.float32 else build(ldt)
                rec = {"dims": list(dims), "links": str(ldt)}
                rec.update(compare_hop(
                    name, op, x, f32_op if ldt == torch.bfloat16 else None))
                if i == 0:
                    rec.update(time_hop(name, op, x, lat.volume // 2))
                out.setdefault(name, {})[dims_label(dims)] = rec
    bw = stream_bandwidth_gbs()
    for recs in out.values():
        add_stream_share(recs["24^4"], bw)
        recs["24^4"]["max_abs_err"] = max(r["max_abs_err"]
                                          for r in recs.values())
    emit({"phase": "kernel", **out})
    res = {k: v["24^4"] for k, v in out.items()}
    res["stream_gbs"] = bw
    return res


def phase_solve(gen) -> dict:
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import eo
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((24, 24, 24, 24))
    m = 0.05
    u = random_links(lat, gen)
    s = st.new_stag_eo(lat, u)
    b = torch.randn(lat.vector_shape(), dtype=torch.complex64,
                    generator=gen, device=gen.device)
    s64 = st.new_stag_eo(lat, u.to(torch.complex128))
    be, bo = (v.to(torch.complex128) for v in eo.pack(b, 4))
    rhs = m * be - st.dslash_eo(s64, bo, 0)
    res = {"phase": "solve", "dims": list(lat.dims), "m": m}
    for route, sloppy in (("f32", False), ("sloppy", True)):
        params = SolverParams(r2req=1e-10, maxits=5000, restarts=5,
                              sloppy=sloppy)
        stag_solve.solve(s, b, m, params)                 # warm-up
        runs = []
        for _ in range(3):
            reset_counts()
            (x, stats), secs = timed_once_s(
                lambda: stag_solve.solve(s, b, m, params))
            runs.append((secs, stats, read_counts()))
        secs = statistics.median(r[0] for r in runs)
        stats, counts = runs[-1][1], runs[-1][2]
        # true residuals with the plain canonical operator in complex128
        xe, xo = (v.to(torch.complex128) for v in eo.pack(x, 4))
        true_ee = rel2(st.d2ee(s64, xe, m), rhs)
        re = m * xe + st.dslash_eo(s64, xo, 0) - be
        ro = m * xo + st.dslash_eo(s64, xe, 1) - bo
        true_full = float(((re.abs() ** 2).sum() + (ro.abs() ** 2).sum())
                          / ((be.abs() ** 2).sum() + (bo.abs() ** 2).sum()))
        rec = {"r2req": params.r2req, "iterations": stats.iterations,
               "solver_r2": stats.r2, "true_rel_r2_even_system": true_ee,
               "true_rel_r2_full_system": true_full, "seconds": secs,
               "seconds_runs": [r[0] for r in runs],
               "seconds_per_iteration": secs / stats.iterations,
               "gflops": stag_solve.cg_flops(lat, 4, 3, stats.iterations)
               / secs / 1e9, "kernel_launches": counts}
        if sloppy:
            # each inner iteration is one bf16 d2ee; each true residual
            # (one per restart, one at the end) one f32 d2ee
            rec["inner_iterations"] = counts["stag8_dslash_bf16"] // 2
            rec["true_residuals"] = counts["stag8_dslash"] // 2
        res[route] = rec
        if not true_ee <= TOL_RES:
            raise AssertionError(f"solve {route}: true residual {true_ee} "
                                 f"> {TOL_RES}")
        needed = ["stag8_dslash"] + (["stag8_dslash_bf16"] if sloppy else [])
        for k in needed:
            if counts[k] <= 0:
                raise AssertionError(f"solve {route}: {k} never launched")
    emit(res)
    return res


def config4_theory(lat, smear=None, sloppy: bool = False):
    """exp_northstar32.py:45-56 composition (``smear=None``: unsmeared)."""
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.solvers.base import SolverParams
    return LatticeFieldTheory(
        lat,
        gauge=GaugeActionSpec(ga.wilson(7.0), steps=12, scheme="2MN"),
        fermions=[FermionSpec("fermion", mass=0.05, steps=6, scheme="2MN"),
                  FermionSpec("boson", mass=0.5, steps=6, scheme="2MN")],
        smear=smear, bc="pppa",
        solver_params=SolverParams(r2req=1e-10, maxits=1500, restarts=3,
                                   sloppy=sloppy),
        force_solver_params=SolverParams(r2req=1e-8, maxits=1500,
                                         restarts=2, sloppy=sloppy),
        tau=0.5)


def hisq_theory(lat):
    """Config 5's fermion in an HMC (qex_tpu_torch.apps.hisq_forces)."""
    from qex_tpu_torch.apps.hisq_forces import hisq_theory as build
    return build(lat)


def run_trajectories(th, lat, gen, u, n: int, tag: str,
                     need: str = "stag8_dslash", first: int = 0) -> tuple:
    """``n`` hmc_step calls, each with its time, dH, plaquette, kernel
    launches and peak memory; raises on a non-finite dH, a plaquette
    outside (0, 1) or no launch of kernel ``need``."""
    from qex_tpu_torch.gauge import loops
    trajs = []
    for i in range(first, first + n):
        before = read_counts()
        torch.cuda.reset_peak_memory_stats()
        (u, state), secs = timed_once_s(lambda: th.hmc_step(gen, u))
        plaq = float(loops.plaquette(lat, u))
        after = read_counts()
        rec = {"traj": i, "seconds": secs, "dH": state.dH,
               "accepted": state.accepted, "h_old": state.h_old,
               "plaquette": plaq,
               "kernel_launches": {k: after[k] - before[k] for k in after},
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        trajs.append(rec)
        if not math.isfinite(state.dH):
            raise AssertionError(f"{tag} traj {i}: dH is {state.dH}")
        if not 0.0 < plaq < 1.0:
            raise AssertionError(f"{tag} traj {i}: plaquette {plaq}")
        if rec["kernel_launches"][need] <= 0:
            raise AssertionError(f"{tag} traj {i}: no {need} launch")
    return u, trajs


def phase_hmc(gen) -> dict:
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice((24, 24, 24, 24))
    th = config4_theory(lat)
    u = random_links(lat, gen)
    plaq0 = float(loops.plaquette(lat, u))
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    u, trajs = run_trajectories(th, lat, gen, u, 2, "hmc")
    launches = read_counts()
    res = {"phase": "hmc", "dims": list(lat.dims), "plaquette_start": plaq0,
           "trajectories": trajs,
           "seconds_per_traj_median": statistics.median(
               r["seconds"] for r in trajs), "kernel_launches": launches}
    emit(res)
    return res


@contextlib.contextmanager
def split_timer(patches):
    """Host-clock split of what runs inside: each (key, owner, attribute)
    of ``patches`` is wrapped to add its time to ``key``, bracketed by
    device syncs (which cost a little time of their own).  Times are
    exclusive: a wrapped call inside another is subtracted from the
    outer one."""
    acc = {key: 0.0 for key, _o, _a in patches}
    inner = []                  # time of wrapped calls nested in each open
    saved = []

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                acc[key] += dt - inner.pop()
                if inner:
                    inner[-1] += dt
        return wrapper

    for key, owner, attr in patches:
        saved.append((owner, attr, attr in vars(owner),
                      vars(owner).get(attr)))
        setattr(owner, attr, timed(key, getattr(owner, attr)))
    try:
        yield acc
    finally:
        for owner, attr, had, old in reversed(saved):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)


def split_run(th, lat, gen, u, patches, tag, need, first):
    """One trajectory under :func:`split_timer`; returns (u, its record,
    the split with the remainder as "rest" and the wall time)."""
    with split_timer(patches) as split:
        t0 = time.perf_counter()
        u, trajs = run_trajectories(th, lat, gen, u, 1, tag, need, first)
        wall = time.perf_counter() - t0
    split["rest"] = wall - sum(split.values())
    split["wall"] = wall
    return u, trajs[0], split


def phase_hmc_smeared(gen) -> dict:
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice((24, 24, 24, 24))
    th = config4_theory(lat, smear=HypCoefs(0.4, 0.5, 0.5))
    u = random_links(lat, gen)
    plaq0 = float(loops.plaquette(lat, u))
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    u, trajs = run_trajectories(th, lat, gen, u, 2, "hmc_smeared")
    launches = read_counts()
    from qex_tpu_torch.mcmc import md
    from qex_tpu_torch.physics import stag_solve
    u, split_traj, split = split_run(
        th, lat, gen, u, [("smear_forward", th, "_smear"),
                          ("smear_pullback", md, "_pullback"),
                          ("solves", stag_solve, "solve_ee")],
        "hmc_smeared split", "stag8_dslash", 2)
    res = {"phase": "hmc_smeared", "dims": list(lat.dims),
           "smear": "nHYP(0.4, 0.5, 0.5)", "plaquette_start": plaq0,
           "trajectories": trajs,
           "seconds_per_traj_median": statistics.median(
               r["seconds"] for r in trajs),
           "peak_mem_gib": max(r["peak_mem_gib"] for r in trajs),
           "kernel_launches": launches, "split_trajectory": split_traj,
           "split_seconds": split}
    emit(res)
    return res


def _app(argv: list[str]) -> list[str]:
    """Run the app's main in this process; echo and return its lines."""
    from qex_tpu_torch.apps import staghmc_spv
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = staghmc_spv.main(argv)
    lines = out.getvalue().splitlines()
    for ln in lines:
        print("  | " + ln, flush=True)
    if rc != 0:
        raise AssertionError(f"app exited {rc}")
    return lines


def _tag_values(lines: list[str], tag: str) -> list[float]:
    return [float(ln.split()[-1]) for ln in lines if ln.startswith(tag)]


def phase_app() -> dict:
    deck = str(ROOT / "qex_tpu_torch" / "apps" / "decks" / "config4_24.xml")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    base = ["--xml", deck, "-sloppy_solve=1", f"-save_path={CKPT_DIR}"]
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    t0 = time.perf_counter()
    lines = _app(base + ["--ntraj", "2", "-save_freq=1", "-check_solvers=1",
                         "-rev_check_freq=2"])
    secs = time.perf_counter() - t0
    launches = read_counts()
    for tag in ("Begin H", "End H", "MEASplaq ", "MEASplaq6", "MEASploop",
                "SOLVER", "REVCHECK"):
        if not any(ln.startswith(tag) for ln in lines):
            raise AssertionError(f"app: no {tag!r} line")
    verdicts = [ln for ln in lines if ln.startswith(("ACCEPT", "REJECT"))]
    dh = [float(ln.split()[2]) for ln in verdicts]
    if len(dh) != 2 or not all(math.isfinite(x) for x in dh):
        raise AssertionError(f"app: dH {dh}")
    for k in ("stag8_dslash", "stag8_dslash_bf16"):
        if launches[k] <= 0:
            raise AssertionError(f"app: {k} never launched")
    resumed = _app(base + ["--ntraj", "1", "-start_config=1"])
    h_first, h_resumed = _tag_values(lines, "Begin H"), \
        _tag_values(resumed, "Begin H")
    p_first, p_resumed = _tag_values(lines, "MEASplaq "), \
        _tag_values(resumed, "MEASplaq ")
    dev = {"begin_h": abs(h_resumed[0] - h_first[1]) / abs(h_first[1]),
           "plaquette": abs(p_resumed[0] - p_first[1]) / abs(p_first[1])}
    res = {"phase": "app", "dims": [24, 24, 24, 24], "sloppy": True,
           "dH": dh, "seconds_two_trajectories_and_checks": secs,
           "kernel_launches": launches, "resume_rel_dev": dev,
           "solver": [ln for ln in lines if ln.startswith("SOLVER")],
           "revcheck": [ln for ln in lines if ln.startswith("REVCHECK")]}
    emit(res)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    for k, v in dev.items():
        if not v <= TOL_RESUME:
            raise AssertionError(f"app: resume {k} deviates by {v}")
    return res


def _ab(gen, tag: str, theory, start: float = 0.7,
        needed: tuple = ("stag8_dslash",)) -> dict:
    """One 8^4 trajectory of ``theory(lat)`` with identical injected
    draws, through the kernels on the card and through the plain
    operators on the host; raises past the link and dH gates or if a
    kernel of ``needed`` never launched."""
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice((8, 8, 8, 8))
    th = theory(lat)
    u = random_links(lat, gen, scale=start)
    p = th.draw_momenta(gen, u)
    xis = th.draw_noise(gen, u)

    def run(dev):
        uu, pp = u.to(dev), p.to(dev)
        phis = th.heatbath_from_noise(
            [None if x is None else x.to(dev) for x in xis], uu)
        h_old = float(th.hamiltonian(uu, pp, phis))
        u1, p1 = th.trajectory(uu, pp, phis)
        h_new = float(th.hamiltonian(u1, p1, phis))
        return u1.cpu(), h_old, h_new - h_old

    before = read_counts()
    (u_k, h_k, dh_k), secs_k = timed_once_s(lambda: run("cuda"))
    after = read_counts()
    launches = {k: after[k] - before[k] for k in after}
    t0 = time.perf_counter()
    u_p, h_p, dh_p = run("cpu")
    secs_p = time.perf_counter() - t0
    link_dev = float((u_k - u_p).abs().max())
    ddh = abs(dh_k - dh_p)
    res = {"phase": tag, "dims": list(lat.dims), "start": start,
           "dH_kernel": dh_k,
           "dH_plain": dh_p, "abs_ddH": ddh, "h_old": h_k,
           "max_link_dev": link_dev, "tol_link": TOL_AB_LINK,
           "tol_ddH": TOL_AB_DH_REL_H * abs(h_k),
           "kernel_launches": launches, "seconds_kernel": secs_k,
           "seconds_plain_host": secs_p}
    emit(res)
    for k in needed:
        if launches[k] <= 0:
            raise AssertionError(f"{tag}: the kernel run never launched {k}")
    if not link_dev <= TOL_AB_LINK:
        raise AssertionError(f"{tag}: link deviation {link_dev}")
    if not ddh <= TOL_AB_DH_REL_H * abs(h_k):
        raise AssertionError(f"{tag}: |dH_kernel - dH_plain| = {ddh}")
    return res


def phase_hisq_solve(gen) -> dict:
    """BASELINE config 5's solve at 32^3x64 (bench_configs.py CONFIG7):
    fattening, the 4-mass multishift on B2 with each mass's true
    residual by the kernel's d2ee, the f32 and sloppy single-mass solves
    at m=0.05, and B2/B2b against their twins and timed at this volume."""
    import dataclasses
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import linalg
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_hmc
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((32, 32, 32, 64))
    torch.cuda.reset_peak_memory_stats()
    u = random_links(lat, gen)
    links, fat_s = timed_once_s(lambda: hisq_links(lat, u))
    X, Y, Z, T = lat.dims
    b = torch.randn((3, X, Y, Z, T // 2), dtype=torch.complex64,
                    generator=gen, device=gen.device)
    masses = (0.05, 0.1, 0.2, 0.4)
    ferm = stag_hmc.HisqFermion(lat, masses[0], params=SolverParams(
        r2req=1e-10, maxits=2000))
    p16 = sh.new_hisq16(st.new_stag3_eo(lat, *links))
    bf = sf.to_fast(b, lat)
    b2 = float(linalg.norm2(bf, torch.float64))

    def true_r2(x, m):          # with the kernel's operator
        r = sh.d2ee_hisq16(p16, sf.to_fast(x, lat), m) - bf
        return float(linalg.norm2(r, torch.float64)) / b2

    res = {"phase": "hisq_solve", "dims": list(lat.dims),
           "fattening_s": fat_s}
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    (xs, stats), secs = timed_once_s(
        lambda: ferm.solve_multi(u, b, masses, links=links))
    counts = read_counts()
    res["multishift"] = {
        "masses": list(masses), "r2req": ferm.params.r2req,
        "iterations": stats.iterations, "solver_r2": stats.r2,
        "seconds": secs, "seconds_per_iteration": secs / stats.iterations,
        "true_rel_r2": [true_r2(x, m) for x, m in zip(xs, masses)],
        "kernel_launches": counts}
    del xs
    main_counts = dict(counts)
    for route, sloppy in (("f32", False), ("sloppy", True)):
        f = dataclasses.replace(ferm, params=SolverParams(
            r2req=1e-10, maxits=2000, restarts=5, sloppy=sloppy))
        reset_counts()
        (x, st_), secs = timed_once_s(lambda: f.solve_ee(u, b,
                                                         links=links))
        counts = read_counts()
        rec = {"m": masses[0], "r2req": 1e-10, "iterations": st_.iterations,
               "solver_r2": st_.r2, "true_rel_r2": true_r2(x, masses[0]),
               "seconds": secs, "kernel_launches": counts}
        if sloppy:
            rec["inner_iterations"] = counts["hisq16_dslash_bf16"] // 2
            rec["true_residuals"] = counts["hisq16_dslash"] // 2
        res[f"solve_{route}"] = rec
        for k, v in counts.items():
            main_counts[k] += v
    res["kernel_launches"] = main_counts
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    x = fast_vector(lat, gen)
    bw = stream_bandwidth_gbs()
    for name, ldt in (("hisq16_dslash", torch.float32),
                      ("hisq16_dslash_bf16", torch.bfloat16)):
        op = p16 if ldt == torch.float32 else sh.new_hisq16(
            st.new_stag3_eo(lat, *links), links_dtype=ldt)
        rec = compare_hop(name, op, x)
        rec.update(time_hop(name, op, x, lat.volume // 2))
        add_stream_share(rec, bw)
        res[name] = rec
    emit(res)
    for i, m in enumerate(masses):
        if not res["multishift"]["true_rel_r2"][i] <= TOL_MULTI:
            raise AssertionError(f"hisq_solve: mass {m} true residual "
                                 f"{res['multishift']['true_rel_r2'][i]}")
    for route in ("f32", "sloppy"):
        if not res[f"solve_{route}"]["true_rel_r2"] <= TOL_RES:
            raise AssertionError(f"hisq_solve {route}: true residual "
                                 f"{res[f'solve_{route}']['true_rel_r2']}")
    for k in ("hisq16_dslash", "hisq16_dslash_bf16"):
        if main_counts[k] <= 0:
            raise AssertionError(f"hisq_solve: {k} never launched")
    return res


def phase_hmc_hisq(gen) -> dict:
    """Two HISQ trajectories at 24^4 from a random start, expm(0.3 tah)
    (see HISQ_START), the second
    split into fattening forward (fat7.hisq_links and its forward-only
    twin), fattening pullback (the rest of each force evaluation: the
    backward pass through the two fat7 levels, the small d2ee3 backward
    and the TAH projection), solves and the rest."""
    from qex_tpu_torch.gauge import fat7, loops
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.mcmc import theory as theory_mod
    from qex_tpu_torch.physics import stag_hmc
    lat = Lattice((24, 24, 24, 24))
    th = hisq_theory(lat)
    u = random_links(lat, gen, scale=HISQ_START)
    plaq0 = float(loops.plaquette(lat, u))
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    u, trajs = run_trajectories(th, lat, gen, u, 1, "hmc_hisq",
                                "hisq16_dslash")
    u, split_traj, split = split_run(
        th, lat, gen, u,
        [("fattening_forward", fat7, "hisq_links"),
         ("fattening_forward", fat7, "hisq_links_lowmem"),
         ("fattening_pullback", theory_mod, "force_from_action"),
         ("solves", stag_hmc.HisqFermion, "_solve_links")],
        "hmc_hisq split", "hisq16_dslash", 1)
    launches = read_counts()
    trajs.append(split_traj)
    res = {"phase": "hmc_hisq", "dims": list(lat.dims),
           "plaquette_start": plaq0, "trajectories": trajs,
           "seconds_per_traj": [r["seconds"] for r in trajs],
           "peak_mem_gib": max(r["peak_mem_gib"] for r in trajs),
           "kernel_launches": launches, "split_seconds": split}
    emit(res)
    return res


def wilson_op(lat, u, m: float, bc: str = "pppa"):
    """links dtype -> kernel-ready Wilson hop of links u (eo, mass m)."""
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.physics import wilson_pallas as wp
    w = wl.new_wilson_eo(lat, u, m, bc)
    return lambda ldt: wp.new_pallas_wilson(w, links_dtype=ldt)


def compare_wilson(name: str, pw, x) -> dict:
    """Kernel B3 / B3b against its plain twin on the same links: both
    parities, m_ee_w (fused epilogue) and m_ee_dag_w; raises past
    TOL_KERNEL."""
    from qex_tpu_torch.physics import wilson_pallas as wp
    res, max_abs = {}, 0.0

    def check(key, got, ref):
        nonlocal max_abs
        torch.cuda.synchronize()
        res[key] = rel2(got, ref)
        max_abs = max(max_abs, float((got - ref).abs().max()))

    for parity in (0, 1):
        check(f"rel2_parity{parity}", wp.hop_w(pw, x, parity),
              wp.hop_w_plain(pw, x, parity))

    def m_ee_plain(v):
        return pw.a * v - wp.hop_w_plain(pw, wp.hop_w_plain(pw, v, 1),
                                         0) / pw.a

    check("rel2_m_ee", wp.m_ee_w(pw, x), m_ee_plain(x))
    check("rel2_m_ee_dag", wp.m_ee_dag_w(pw, x),
          wp._g5(m_ee_plain(wp._g5(x))))
    res["max_abs_err"] = max_abs
    for key in ("rel2_parity0", "rel2_parity1", "rel2_m_ee",
                "rel2_m_ee_dag"):
        if not res[key] <= TOL_KERNEL:
            raise AssertionError(f"{name} at {tuple(x.shape)}: {key} "
                                 f"{res[key]}")
    return res


def time_wilson(name: str, pw, x, sites: int) -> dict:
    """Kernel, plain twin and m_ee_w times (CUDA events), GB/s by the
    bytes model and the kernel's bound at the data-sheet peaks."""
    from qex_tpu_torch.physics import wilson_pallas as wp
    _kind, ldt, _ = KERNELS[name]
    nbytes = BYTES_PER_SITE[("wilson8", ldt)] * sites
    flops = FLOPS_PER_SITE["wilson8"] * sites
    k_ms = cuda_time_ms(lambda: wp.hop_w(pw, x, 0), reps=200)
    p_ms = cuda_time_ms(lambda: wp.hop_w_plain(pw, x, 0), reps=5, rounds=3)
    ee_ms = cuda_time_ms(lambda: wp.m_ee_w(pw, x), reps=100)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    return {"ms": k_ms, "plain_ms": p_ms, "m_ee_ms": ee_ms,
            "gflops": flops / (k_ms * 1e-3) / 1e9,
            "bytes": nbytes, "gbs": nbytes / (k_ms * 1e-3) / 1e9,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def phase_wilson_kernel(gen) -> dict:
    """B3 and B3b against the plain twin at 6x4x4x8 (the JAX kernel
    test's geometry), 4x4x8x8, 24^3x32 (exp_wilson.py) and 32^3x64, on
    expm(0.7 tah) links; timed at the last two."""
    from qex_tpu_torch.lattice import Lattice
    out = {}
    timed = ((24, 24, 24, 32), (32, 32, 32, 64))
    for dims in ((6, 4, 4, 8), (4, 4, 8, 8)) + timed:
        lat = Lattice(dims)
        build = wilson_op(lat, random_links(lat, gen), 0.1)
        X, Y, Z, T = lat.dims
        x = torch.randn((4, 3, T // 2, Z, Y * X), dtype=torch.complex64,
                        generator=gen, device=gen.device)
        for name in ("wilson8_hop", "wilson8_hop_bf16"):
            ldt = KERNELS[name][1]
            pw = build(ldt)
            rec = {"dims": list(dims), "links": str(ldt)}
            rec.update(compare_wilson(name, pw, x))
            if dims in timed:
                rec.update(time_wilson(name, pw, x, lat.volume // 2))
            out.setdefault(name, {})[dims_label(dims)] = rec
            del pw
        del build, x
    bw = stream_bandwidth_gbs()
    for recs in out.values():
        for dims in timed:
            add_stream_share(recs[dims_label(dims)], bw)
    emit({"phase": "wilson_kernel", "stream_gbs": bw,
          "ptxas": ptxas_lines(SOURCES["wilson8"]), **out})
    res = {}
    for name, recs in out.items():
        res[name] = dict(recs["24x24x24x32"])
        res[name]["max_abs_err"] = max(r["max_abs_err"]
                                       for r in recs.values())
    return res


def wilson_true_r2(lat, u, m: float, bc: str, x, b) -> float:
    """|D x - b|^2 / |b|^2 with the plain operator in complex128."""
    from qex_tpu_torch.physics import wilson as wl
    d = wl.new_wilson(lat, u.to(torch.complex128), m, bc)
    b64 = b.to(torch.complex128)
    r = wl.wilson_d(d, x.to(torch.complex128)) - b64
    return float((r.abs() ** 2).sum() / (b64.abs() ** 2).sum())


def phase_wilson_solve(gen) -> dict:
    """exp_wilson.py's solve through wilson.solve_eo's routing:
    24^3x32, m=0.1, bc pppa, r2req 1e-12, maxits 1000, 3 restarts, on
    seeded expm(0.7 tah) links (not Haar links: random_su is ROADMAP
    A4), float32 links (B3) and sloppy (B3b inner iterations)."""
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((24, 24, 24, 32))
    m = 0.1
    u = random_links(lat, gen)
    b = torch.randn((4, 3) + lat.dims, dtype=torch.complex64, generator=gen,
                    device=gen.device)
    w = wl.new_wilson_eo(lat, u, m)
    res = {"phase": "wilson_solve", "dims": list(lat.dims), "m": m}
    total = dict.fromkeys(KERNELS, 0)
    for route, sloppy in (("f32", False), ("sloppy", True)):
        params = SolverParams(r2req=1e-12, maxits=1000, restarts=3,
                              sloppy=sloppy)
        torch.cuda.synchronize()
        reset_counts()                     # count the main path only
        (x, stats), secs = timed_once_s(lambda: wl.solve_eo(w, b, params))
        counts = read_counts()
        true = wilson_true_r2(lat, u, m, "pppa", x, b)
        res[route] = {"r2req": params.r2req, "iterations": stats.iterations,
                      "solver_r2": stats.r2, "true_rel_r2": true,
                      "seconds": secs,
                      "seconds_per_iteration": secs / stats.iterations,
                      "kernel_launches": counts}
        for k, v in counts.items():
            total[k] += v
        if not true <= TOL_WILSON:
            raise AssertionError(f"wilson_solve {route}: true residual "
                                 f"{true} > {TOL_WILSON}")
        needed = ["wilson8_hop"] + (["wilson8_hop_bf16"] if sloppy else [])
        for k in needed:
            if counts[k] <= 0:
                raise AssertionError(f"wilson_solve {route}: {k} never "
                                     f"launched")
    res["kernel_launches"] = total
    emit(res)
    return res


def phase_wilson_mesons(gen) -> dict:
    """The measure app's Wilson mesons (qex_tpu/apps/measure.py:111-130):
    12 point-source solves through solve_eo at 24^3x32 (m=0.1, bc pppa,
    r2req 1e-10) and all nine channels; raises on a propagator's true
    residual, a non-finite correlator or a pion C(t) <= 0."""
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.observables import mesons
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((24, 24, 24, 32))
    m, r2req = 0.1, 1e-10
    u = random_links(lat, gen)
    w = wl.new_wilson_eo(lat, u, m)
    params = SolverParams(r2req=r2req, maxits=1000, restarts=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                         # count the main path only
    t0 = time.perf_counter()
    cols, its, trues = [], [], []
    for s0 in range(4):
        for c0 in range(lat.nc):
            src = torch.zeros((4, lat.nc) + lat.dims, dtype=torch.complex64,
                              device=u.device)
            src[(s0, c0) + (0,) * lat.nd] = 1.0
            x, stats = wl.solve_eo(w, src, params)
            cols.append(x)
            its.append(stats.iterations)
            trues.append(wilson_true_r2(lat, u, m, "pppa", x, src))
    props = torch.stack(cols).reshape((4, lat.nc) + cols[0].shape)
    del cols
    corr = mesons.wilson_mesons_from_prop(lat, props, mesons.WILSON_CHANNELS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    res = {"phase": "wilson_mesons", "dims": list(lat.dims), "m": m,
           "r2req": r2req, "seconds": secs, "iterations": its,
           "true_rel_r2_max": max(trues),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "propagator_gib": props.numel() * props.element_size() / 2**30,
           "kernel_launches": launches,
           "correlators": {ch: [float(v) for v in c.cpu()]
                           for ch, c in corr.items()}}
    emit(res)
    if not max(trues) <= 10 * r2req:
        raise AssertionError(f"wilson_mesons: true residual {max(trues)}")
    for ch, c in corr.items():
        if not bool(torch.isfinite(c).all()):
            raise AssertionError(f"wilson_mesons: {ch} is not finite")
    if not bool((corr["pion"] > 0).all()):
        raise AssertionError("wilson_mesons: pion C(t) <= 0")
    if launches["wilson8_hop"] <= 0:
        raise AssertionError("wilson_mesons: wilson8_hop never launched")
    return res


def phase_wilson_mg(gen) -> dict:
    """exp_mg_ab.py's A/B (MG_AB_cpu.json's scale): m=0.005, bc pppp,
    r2req 1e-8, expm(0.45 tah) links, at 8^3x16 and 16^3x32.  CGNE is
    solve_eo (B3); MG is solve_mg with MGParams(nlevels=1, nvec=8,
    relax_iters=30, m=16, k_m=4, bottom_iters=16), its fine operator the
    plain wilson_d as in the JAX package.  Setup time = (build + solve)
    - (solve on the reused hierarchy)."""
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.solvers.base import MGParams, SolverParams
    m, r2req = 0.005, 1e-8
    p_cg = SolverParams(r2req=r2req, maxits=4000, restarts=2)
    p_mg = SolverParams(r2req=r2req, maxits=400, backend="mg",
                        mg=MGParams(nlevels=1, nvec=8, relax_iters=30,
                                    m=16, k_m=4, bottom_iters=16))
    res = {"phase": "wilson_mg", "m": m, "r2req": r2req, "scale": 0.45}
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    for dims in ((8, 8, 8, 16), (16, 16, 16, 32)):
        lat = Lattice(dims)
        u = random_links(lat, gen, scale=0.45)
        b = torch.randn((4, 3) + lat.dims, dtype=torch.complex64,
                        generator=gen, device=gen.device)
        weo = wl.new_wilson_eo(lat, u, m, "pppp")
        wl.solve_eo(weo, b, p_cg)                           # warm-up
        (x, st_cg), t_cg = timed_once_s(lambda: wl.solve_eo(weo, b, p_cg))
        true_cg = wilson_true_r2(lat, u, m, "pppp", x, b)
        w = wl.new_wilson(lat, u, m, "pppp")
        (x, st_mg, hier), t_build = timed_once_s(
            lambda: wl.solve_mg(w, b, p_mg))
        (x, st_mg, _), t_mg = timed_once_s(
            lambda: wl.solve_mg(w, b, p_mg, hierarchy=hier))
        true_mg = wilson_true_r2(lat, u, m, "pppp", x, b)
        t_setup = t_build - t_mg
        rec = {"cgne_eo": {"seconds": t_cg, "iterations": st_cg.iterations,
                           "true_rel_r2": true_cg},
               "mg_kcycle": {"seconds": t_mg, "setup_seconds": t_setup,
                             "iterations": st_mg.iterations,
                             "true_rel_r2": true_mg},
               "speedup_mg_over_cgne": t_cg / t_mg,
               "breakeven_solves": (t_setup / (t_cg - t_mg)
                                    if t_cg > t_mg else None)}
        res[dims_label(dims)] = rec
        del hier, x
        for tag, true in (("cgne", true_cg), ("mg", true_mg)):
            if not true <= 10 * r2req:
                raise AssertionError(f"wilson_mg {dims} {tag}: true "
                                     f"residual {true}")
    res["kernel_launches"] = read_counts()
    emit(res)
    if res["kernel_launches"]["wilson8_hop"] <= 0:
        raise AssertionError("wilson_mg: wilson8_hop never launched")
    return res


def gen_instances() -> dict:
    """Kernel name -> the generation benchmark's Instance, for the names
    of phases 16-18."""
    from qex_tpu_torch.bench import stag_generations as gens
    out = {}
    for name, (kind, ldt, counter) in KERNELS.items():
        if kind in GEN_KINDS:
            out[name] = gens.Instance(
                kind, ldt, compute_only="compute_only" in counter,
                mode=counter[len("launches_"):] if kind == "split" else None)
    return out


def ptxas_lines(source: str) -> list:
    """The kernel names, registers and spills of a build made in this
    process."""
    from qex_tpu_torch import _native
    return [ln.strip() for ln in _native.BUILD_LOG.get(source, {}).get(
        "ptxas", "").splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln]


def compare_generation(name: str, inst, op, x) -> dict:
    """One older-generation kernel against its plain twin on the same
    links: both parities and, for v1-v4 without compute_only, the d2ee
    (and for v3/v4 the d2dd) wrappers; raises past TOL_KERNEL."""
    from qex_tpu_torch.bench import stag_generations as gens
    hop, plain = gens.hop(inst, op), gens.plain_hop(inst, op)
    v = gens.to_layout(inst.kind, x)
    res, max_abs = {}, 0.0

    def check(key, got, ref, parity=None):
        nonlocal max_abs
        torch.cuda.synchronize()
        res[key] = (rel2(got, ref) if parity is None
                    else gens.deviation(inst, op, v, parity, got, ref))
        max_abs = max(max_abs, float((got - ref).abs().max()))

    for parity in (0, 1):
        check(f"rel2_parity{parity}", hop(v, parity), plain(v, parity),
              parity)
    if inst.kind != "split" and not inst.compute_only:
        m = GEN_MASS
        check("rel2_d2ee", gens.d2ee(inst.kind, op)(v, m),
              (m * m) * v - plain(plain(v, 1), 0))
        if inst.kind in ("v3", "v4"):
            from qex_tpu_torch.physics import stag_pallas3 as sp3
            from qex_tpu_torch.physics import stag_pallas4 as sp4
            d2dd = sp3.d2dd_pallas3 if inst.kind == "v3" else sp4.d2dd_pallas4
            check("rel2_d2dd", d2dd(op, v, 1), -plain(plain(v, 0), 1))
    res["max_abs_err"] = max_abs
    for key, val in res.items():
        if key.startswith("rel2") and not val <= TOL_KERNEL:
            raise AssertionError(f"{name} at {tuple(x.shape)}: {key} {val}")
    return res


def phase_stag_generations_kernel(gen) -> dict:
    """Phase 16: every older-generation instance against its twin at
    8x4x4x8 (the JAX kernel tests' geometry) and 32^4, and v1 (B4/B4b)
    also at ODD_DIMS, on expm(0.7 tah) links; at 32^4 also each
    generation against B1 (f32 links) or B1b (bf16 links) on the same
    gauge field, and B8's full mode against 1/2 (F - B) through B6 on
    links with the backward terms negated."""
    from qex_tpu_torch.bench import stag_generations as gens
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_pallas3 as sp3
    from qex_tpu_torch.physics import staggered as st
    insts = gen_instances()
    out = {name: {} for name in insts}
    res = {"phase": "stag_generations_kernel"}
    for dims in ((8, 4, 4, 8), ODD_DIMS, GEN_DIMS):
        lat = Lattice(dims)
        g = odd_generator() if dims == ODD_DIMS else gen
        s = sf.new_fast(st.new_stag_eo(lat, random_links(lat, g)))
        x = fast_vector(lat, g)
        b1 = {}
        if dims == GEN_DIMS:
            for ldt in (torch.float32, torch.bfloat16):
                b1[ldt] = sh.dslash_stag8(sh.new_stag8(s, links_dtype=ldt),
                                          x, 0)
        for name, inst in insts.items():
            if dims == ODD_DIMS and inst.kind != "v1":
                continue
            op = gens.build(inst, s)
            rec = {"dims": list(dims), "links": str(inst.links_dtype)}
            rec.update(compare_generation(name, inst, op, x))
            if b1 and inst.kind != "split" and not inst.compute_only:
                got = gens.from_layout(inst.kind, gens.hop(inst, op)(
                    gens.to_layout(inst.kind, x), 0))
                rec["rel2_vs_B1"] = rel2(got, b1[inst.links_dtype])
                if not rec["rel2_vs_B1"] <= TOL_KERNEL:
                    raise AssertionError(f"{name}: against the 8-term "
                                         f"kernel {rec['rel2_vs_B1']}")
            if b1 and inst.mode == "full":
                neg = torch.tensor([1.0] * 4 + [-1.0] * 4, device=x.device
                                   ).reshape(8, 1, 1, 1, 1, 1, 1)
                fb = sp3.PallasStagEO3(lat, op.l_e * neg, op.l_o * neg)
                v = gens.to_layout("split", x)
                got = gens.hop(inst, op)(v, 1)
                ref = 0.5 * sp3.dslash_pallas3(fb, v, 1)
                torch.cuda.synchronize()
                rec["rel2_vs_half_f_minus_b"] = rel2(got, ref)
                rec["rel2_vs_v3"] = rel2(got, sp3.dslash_pallas3(op, v, 1))
                if not rec["rel2_vs_half_f_minus_b"] <= TOL_KERNEL:
                    raise AssertionError(
                        f"{name}: against 1/2 (F - B) "
                        f"{rec['rel2_vs_half_f_minus_b']}")
            out[name][dims_label(dims)] = rec
            del op
        del s, x, b1
    res.update(out)
    res["ptxas"] = {src: ptxas_lines(src) for src in (
        "stag_v1_dslash.cu", "stag_v2_dslash.cu", "stag_v3_dslash.cu")}
    emit(res)
    return {name: max(r["max_abs_err"] for r in recs.values())
            for name, recs in out.items()}


def phase_stag_generations_time(gen) -> dict:
    """Phase 17: the generation benchmark's A/B at 32^4 over every
    instance (its main path: the counts are read around it), then each
    instance and B1/B1b timed at 24^4 ("at_24") and 32^4 by CUDA events
    over 200 launches, replayed from a CUDA graph ("ms", the kernel's
    device time) and launched from the host ("ms_eager_launches", which
    the wrapper's host cost bounds from below at some 22-39 us), with
    its plain twin, GB/s by its bytes per site, GFLOP/s by its flops per
    site and its bound at the data-sheet peaks and at the stream."""
    from qex_tpu_torch.bench import stag_generations as gens
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice(GEN_DIMS)
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    t0 = time.perf_counter()
    lines = []
    records = gens.ab(lat, gens.all_instances(), iters=50, seed=SEED,
                      emit=lambda line: lines.append(json.loads(line)))
    ab_s = time.perf_counter() - t0
    launches = read_counts()
    bw = stream_bandwidth_gbs()
    timed = dict(gen_instances())
    timed.update({"stag8_dslash": gens.Instance("s8"),
                  "stag8_dslash_bf16": gens.Instance("s8", torch.bfloat16)})
    out = {}
    for dims in ((24, 24, 24, 24), GEN_DIMS):
        tlat = Lattice(dims)
        s, x = gens.setup(tlat, SEED)
        for name, inst in timed.items():
            op = gens.build(inst, s)
            v = gens.to_layout(inst.kind, x)
            hop, plain = gens.hop(inst, op), gens.plain_hop(inst, op)
            k_ms = graph_time_ms(lambda: hop(v, 0))
            eager_ms = cuda_time_ms(lambda: hop(v, 0), reps=200)
            p_ms = cuda_time_ms(lambda: plain(v, 0), reps=5, rounds=3)
            n = tlat.volume // 2
            nbytes = gens.bytes_per_site(inst) * n
            flops = gens.flops_per_site(inst) * n
            bytes_ms = nbytes / PEAK_BYTES_S * 1e3
            flops_ms = flops / PEAK_F32_FLOPS * 1e3
            rec = {"ms": k_ms, "ms_eager_launches": eager_ms,
                   "plain_ms": p_ms,
                   "bytes_per_site": gens.bytes_per_site(inst),
                   "gflops": flops / (k_ms * 1e-3) / 1e9, "bytes": nbytes,
                   "gbs": nbytes / (k_ms * 1e-3) / 1e9,
                   "bound_ms": max(bytes_ms, flops_ms),
                   "bound_by": ("bytes" if bytes_ms >= flops_ms
                                else "operations")}
            add_stream_share(rec, bw)
            if dims == GEN_DIMS:
                out[name] = dict(rec, at_24=out[name])
            else:
                out[name] = rec
            del op
        del s, x
    res = {"phase": "stag_generations_time", "dims": list(GEN_DIMS),
           "stream_gbs": bw, "ab_seconds": ab_s, "ab": lines,
           "kernel_launches": launches, **out}
    emit(res)
    for rec in records:
        if not math.isfinite(rec["ms_per_hop"]):
            raise AssertionError(f"A/B {rec['instance']}: no time")
    for name in gen_instances():
        if launches[name] <= 0:
            raise AssertionError(f"stag_generations_time: {name} never "
                                 f"launched in the A/B")
    return res


def phase_stag_generations_cg(gen) -> dict:
    """Phase 18: cg_solve at 32^4 (exp_s8.py's m=0.1), r2req 1e-10, on
    expm(0.7 tah) links, through d2ee of v1, v2, v3, v4 (float32 links)
    and B1's d2ee_stag8; true r^2 by the complex128 fast-layout
    operator."""
    from qex_tpu_torch.bench import stag_generations as gens
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers import cg
    lat = Lattice(GEN_DIMS)
    m, r2req = GEN_MASS, 1e-10
    s = sf.new_fast(st.new_stag_eo(lat, random_links(lat, gen)))
    b = fast_vector(lat, gen)
    s64 = sf.FastStagEO(lat, s.g_e.to(torch.complex128),
                        s.g_o.to(torch.complex128))
    b64 = b.to(torch.complex128)
    res = {"phase": "stag_generations_cg", "dims": list(GEN_DIMS), "m": m,
           "r2req": r2req}
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    for kind in ("s8", "v1", "v2", "v3", "v4"):
        op = gens.build(gens.Instance(kind), s)
        a = gens.d2ee(kind, op)
        bk = gens.to_layout(kind, b)
        (x, stats), secs = timed_once_s(lambda: cg.cg_solve(
            lambda v: a(v, m), bk, r2req=r2req, maxits=3000))
        r = sf.d2ee_fast(s64, gens.from_layout(kind, x).to(
            torch.complex128), m) - b64
        true = float((r.abs() ** 2).sum() / (b64.abs() ** 2).sum())
        res[kind] = {"iterations": stats.iterations, "solver_r2": stats.r2,
                     "true_rel_r2": true, "seconds": secs,
                     "seconds_per_iteration": secs / stats.iterations}
        del op, x
    res["kernel_launches"] = read_counts()
    emit(res)
    its = res["s8"]["iterations"]
    for kind in ("s8", "v1", "v2", "v3", "v4"):
        if not res[kind]["true_rel_r2"] <= TOL_RES:
            raise AssertionError(f"stag_generations_cg {kind}: true "
                                 f"residual {res[kind]['true_rel_r2']}")
        if abs(res[kind]["iterations"] - its) > TOL_CG_ITS:
            raise AssertionError(f"stag_generations_cg {kind}: "
                                 f"{res[kind]['iterations']} iterations "
                                 f"against B1's {its}")
    for name in ("stag8_dslash", "stag_v1_dslash", "stag_v2_dslash",
                 "stag_v3_dslash", "stag_v4_dslash"):
        if res["kernel_launches"][name] <= 0:
            raise AssertionError(f"stag_generations_cg: {name} never "
                                 f"launched")
    return res


def profiled(tag: str, fn) -> dict:
    """Run ``fn`` once under torch.profiler: wall time, device kernel
    count and busy time (sum of kernel durations; one stream, so they
    do not overlap), and the ten operators with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    top = sorted(prof.key_averages(),
                 key=lambda a: -a.self_device_time_total)[:10]
    res = {"phase": f"profile_{tag}", "wall_s": wall,
           "device_kernels": len(kernels), "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall,
           "top_self_device_ms": [[a.key[:60], a.count,
                                   a.self_device_time_total / 1e3]
                                  for a in top]}
    emit(res)
    return res


def profile_main() -> int:
    """``--profile``: one f32 and one sloppy solve, one smeared config-4
    trajectory and one HISQ trajectory at 24^4, and one Wilson eo solve
    at 24^3x32, under torch.profiler (not part of the checked run)."""
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers.base import SolverParams
    phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lat = Lattice((24, 24, 24, 24))
    u = random_links(lat, gen)
    s = st.new_stag_eo(lat, u)
    b = torch.randn(lat.vector_shape(), dtype=torch.complex64,
                    generator=gen, device=gen.device)
    for route, sloppy in (("solve_f32", False), ("solve_sloppy", True)):
        params = SolverParams(r2req=1e-10, maxits=5000, restarts=5,
                              sloppy=sloppy)
        stag_solve.solve(s, b, 0.05, params)              # warm-up
        profiled(route, lambda: stag_solve.solve(s, b, 0.05, params))
    th = config4_theory(lat, smear=HypCoefs(0.4, 0.5, 0.5))
    th.hmc_step(gen, u)                                   # warm-up
    profiled("hmc_smeared", lambda: th.hmc_step(gen, u))
    th = hisq_theory(lat)
    u = random_links(lat, gen, scale=HISQ_START)
    th.hmc_step(gen, u)                                   # warm-up
    profiled("hmc_hisq", lambda: th.hmc_step(gen, u))
    from qex_tpu_torch.physics import wilson as wl
    lat = Lattice((24, 24, 24, 32))
    w = wl.new_wilson_eo(lat, random_links(lat, gen), 0.1)
    b = torch.randn((4, 3) + lat.dims, dtype=torch.complex64, generator=gen,
                    device=gen.device)
    params = SolverParams(r2req=1e-12, maxits=1000, restarts=3)
    wl.solve_eo(w, b, params)                             # warm-up
    profiled("wilson_solve_f32", lambda: wl.solve_eo(w, b, params))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.gauge.smear import HypCoefs
    smeared_theory = functools.partial(
        config4_theory, smear=HypCoefs(0.4, 0.5, 0.5), sloppy=True)
    if sys.argv[1:] == ["--profile"]:
        return profile_main()

    t_start = time.perf_counter()
    dev = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kern = phase_kernel(gen)
    phase_solve(gen)
    phase_hmc(gen)
    _ab(gen, "ab", config4_theory)
    smeared = phase_hmc_smeared(gen)
    app = phase_app()
    _ab(gen, "ab_smeared", smeared_theory, start=AB_SMEARED_START,
        needed=("stag8_dslash", "stag8_dslash_bf16"))
    hsolve = phase_hisq_solve(gen)
    hhmc = phase_hmc_hisq(gen)
    _ab(gen, "ab_hisq", hisq_theory, start=HISQ_START,
        needed=("hisq16_dslash",))
    kern.update(phase_wilson_kernel(gen))
    wsolve = phase_wilson_solve(gen)
    wmesons = phase_wilson_mesons(gen)
    wmg = phase_wilson_mg(gen)
    gen_err = phase_stag_generations_kernel(gen)
    gtime = phase_stag_generations_time(gen)
    gcg = phase_stag_generations_cg(gen)
    for name, err in gen_err.items():
        kern[name] = dict(gtime[name], max_abs_err=err)
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(dev["smi"], flush=True)
    # each kernel's main path: the smeared config-4 trajectories and the
    # app for the 8-term kernels, config 5's solves and the HISQ
    # trajectories for the 16-term ones, the Wilson solves, mesons and
    # MG A/B for the Wilson hop, the generation benchmark's A/B and CG
    # for the older staggered kernels
    paths = {"stag8": (smeared, app), "hisq16": (hsolve, hhmc),
             "wilson8": (wsolve, wmesons, wmg),
             **{kind: (gtime, gcg) for kind in GEN_KINDS}}
    kernels = []
    for name, (kind, _ldt, _c) in KERNELS.items():
        k = kern[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"qex_tpu_torch/csrc/{SOURCES[kind]}",
            "replaces": REPLACES[kind],
            "launches": sum(ph["kernel_launches"][name]
                            for ph in paths[kind]),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_us": k["bound_ms"] * 1e3, "bound_by": k["bound_by"],
            "library_ms": None})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
