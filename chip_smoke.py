#!/usr/bin/env python3
"""Drive the qex_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Phases, each printed as one JSON line:
  1. device: the card's name and power limit (nvidia-smi), the kernel build;
  2. kernel: the 8-term staggered CUDA kernel with float32 links (B1) and
     with bfloat16 links (B1b) against their plain torch version at 24^4
     and 8x4x4x8, with times, GB/s (624 and 336 B/site: each input read
     once, the output written once), bounds and the share of this card's
     measured stream bandwidth;
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
     smoother links (see AB_SMEARED_START).
The launch counters are set to 0 just before each main-path phase (4, 6,
7) and read just after it.  Then the card line, the kernels summary and,
last, the ok line.  Any failed check raises, so the script exits non-zero
and prints no ok line; without a CUDA device it exits non-zero at once.

``--profile`` instead runs a 24^4 f32 solve, a sloppy solve and one
smeared config-4 trajectory under torch.profiler and prints each one's
wall time, device kernel count, device-idle share and top operators.
"""

from __future__ import annotations

import contextlib
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
TOL_RESUME = 1e-10      # relative: a resume repeats the chain exactly
# H100 SXM data sheet (dense, 700 W): the bounds of the kernels line
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FLOPS_PER_SITE = 594
BYTES_PER_SITE = {torch.float32: 624, torch.bfloat16: 336}
# where the chip run keeps the app's checkpoints (gitignored)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


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


def reset_counts() -> None:
    from qex_tpu_torch.physics import stag_hisq as sh
    sh.dslash_stag8.launches = 0
    sh.dslash_stag8.launches_bf16 = 0


def read_counts() -> dict:
    from qex_tpu_torch.physics import stag_hisq as sh
    return {"stag8_dslash": sh.dslash_stag8.launches,
            "stag8_dslash_bf16": sh.dslash_stag8.launches_bf16}


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from qex_tpu_torch import _native
    t0 = time.perf_counter()
    _native.load("stag8_dslash.cu")
    build_s = time.perf_counter() - t0
    log = _native.BUILD_LOG.get("stag8_dslash.cu", {})
    ptxas = [ln.strip() for ln in log.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "nvcc_s": log.get("seconds"), "ptxas": ptxas})
    return {"smi": smi}


def stream_bandwidth_gbs() -> float:
    """Read+write bandwidth of an out-of-place scale over 512 MB."""
    n = 128 * 1024 * 1024
    x = torch.ones(n, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    ms = cuda_time_ms(lambda: torch.mul(x, 1.000001, out=y), reps=20)
    del x, y
    return 2 * 4 * n / (ms * 1e-3) / 1e9


def check_kernel(dims, gen, links_dtype, timing: bool) -> dict:
    """One kernel (links in ``links_dtype``) against its plain twin on
    the same links: both parities and the fused d2ee."""
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import staggered as st
    lat = Lattice(dims)
    u = random_links(lat, gen)
    s = st.new_stag_eo(lat, u)
    p8 = sh.new_stag8(s, links_dtype=links_dtype)
    x = torch.randn((3, dims[3] // 2, dims[2], dims[1] * dims[0]),
                    dtype=torch.complex64, generator=gen, device="cuda")
    res = {"dims": list(dims), "links": str(links_dtype)}
    max_abs = 0.0
    for parity in (0, 1):
        got = sh.dslash_stag8(p8, x, parity)
        ref = sh.dslash_stag8_plain(p8, x, parity)
        torch.cuda.synchronize()
        dev = rel2(got, ref)
        max_abs = max(max_abs, float((got - ref).abs().max()))
        res[f"rel2_parity{parity}"] = dev
        if not dev <= TOL_KERNEL:
            raise AssertionError(f"dslash_stag8 {links_dtype} parity "
                                 f"{parity} at {dims}: rel2 {dev}")
    m = 0.05
    got = sh.d2ee_stag8(p8, x, m)
    ref = (m * m) * x - sh.dslash_stag8_plain(
        p8, sh.dslash_stag8_plain(p8, x, 1), 0)
    torch.cuda.synchronize()
    dev = rel2(got, ref)
    res["rel2_d2ee"] = dev
    max_abs = max(max_abs, float((got - ref).abs().max()))
    if not dev <= TOL_KERNEL:
        raise AssertionError(f"d2ee_stag8 {links_dtype} at {dims}: "
                             f"rel2 {dev}")
    res["max_abs_err"] = max_abs
    if links_dtype == torch.bfloat16:
        # information only: the bf16 operator against the f32 one
        res["rel2_bf16_vs_f32_d2ee"] = rel2(
            got, sh.d2ee_stag8(sh.new_stag8(s), x, m))
    if timing:
        sites = lat.volume // 2
        nbytes = BYTES_PER_SITE[links_dtype] * sites
        k_ms = cuda_time_ms(lambda: sh.dslash_stag8(p8, x, 0), reps=200)
        p_ms = cuda_time_ms(lambda: sh.dslash_stag8_plain(p8, x, 0),
                            reps=10)
        ee_ms = cuda_time_ms(lambda: sh.d2ee_stag8(p8, x, m), reps=100)
        bytes_ms = nbytes / PEAK_BYTES_S * 1e3
        flops_ms = FLOPS_PER_SITE * sites / PEAK_F32_FLOPS * 1e3
        res.update({
            "ms": k_ms, "plain_ms": p_ms, "d2ee_ms": ee_ms,
            "gflops": FLOPS_PER_SITE * sites / (k_ms * 1e-3) / 1e9,
            "bytes": nbytes, "gbs": nbytes / (k_ms * 1e-3) / 1e9,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"})
    return res


def phase_kernel(gen) -> dict:
    out = {}
    for name, ldt in (("stag8_dslash", torch.float32),
                      ("stag8_dslash_bf16", torch.bfloat16)):
        big = check_kernel((24, 24, 24, 24), gen, ldt, timing=True)
        small = check_kernel((8, 4, 4, 8), gen, ldt, timing=False)
        big["max_abs_err"] = max(big["max_abs_err"], small["max_abs_err"])
        out[name] = {"24^4": big, "8x4x4x8": small}
    bw = stream_bandwidth_gbs()
    for rec in out.values():
        big = rec["24^4"]
        big["stream_gbs"] = bw
        big["share_of_stream_bw"] = big["gbs"] / bw
        big["bound_at_stream_us"] = big["bytes"] / (bw * 1e9) * 1e6
    emit({"phase": "kernel", **out})
    return {k: v["24^4"] for k, v in out.items()}


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
                    generator=gen, device="cuda")
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


def run_trajectories(th, lat, gen, u, n: int, tag: str) -> tuple:
    from qex_tpu_torch.gauge import loops
    trajs = []
    for i in range(n):
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
        if rec["kernel_launches"]["stag8_dslash"] <= 0:
            raise AssertionError(f"{tag} traj {i}: no stag8 kernel launch")
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
def split_timer(th):
    """Host-clock split of trajectories of ``th`` into smear forward,
    smear pullback and solves, each bracketed by device syncs (which
    cost a little time of their own); the rest is the remainder."""
    from qex_tpu_torch.mcmc import md
    from qex_tpu_torch.physics import stag_solve
    acc = {"smear_forward": 0.0, "smear_pullback": 0.0, "solves": 0.0}
    saved = (th._smear, md._pullback, stag_solve.solve_ee)

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            return out
        return wrapper

    th._smear = timed("smear_forward", saved[0])
    md._pullback = timed("smear_pullback", saved[1])
    stag_solve.solve_ee = timed("solves", saved[2])
    try:
        yield acc
    finally:
        del th._smear
        md._pullback, stag_solve.solve_ee = saved[1], saved[2]


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
    with split_timer(th) as split:
        t0 = time.perf_counter()
        u, split_traj = run_trajectories(th, lat, gen, u, 1,
                                         "hmc_smeared split")
        wall = time.perf_counter() - t0
    split["rest"] = wall - sum(split.values())
    split["wall"] = wall
    res = {"phase": "hmc_smeared", "dims": list(lat.dims),
           "smear": "nHYP(0.4, 0.5, 0.5)", "plaquette_start": plaq0,
           "trajectories": trajs,
           "seconds_per_traj_median": statistics.median(
               r["seconds"] for r in trajs),
           "peak_mem_gib": max(r["peak_mem_gib"] for r in trajs),
           "kernel_launches": launches, "split_trajectory": split_traj[0],
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


def _ab(gen, tag: str, smear=None, sloppy: bool = False,
        start: float = 0.7) -> dict:
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice((8, 8, 8, 8))
    th = config4_theory(lat, smear=smear, sloppy=sloppy)
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
    needed = ["stag8_dslash"] + (["stag8_dslash_bf16"] if sloppy else [])
    for k in needed:
        if launches[k] <= 0:
            raise AssertionError(f"{tag}: the kernel run never launched {k}")
    if not link_dev <= TOL_AB_LINK:
        raise AssertionError(f"{tag}: link deviation {link_dev}")
    if not ddh <= TOL_AB_DH_REL_H * abs(h_k):
        raise AssertionError(f"{tag}: |dH_kernel - dH_plain| = {ddh}")
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
    """``--profile``: one f32 and one sloppy solve and one smeared
    config-4 trajectory at 24^4 under torch.profiler (not part of the
    checked run)."""
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
                    generator=gen, device="cuda")
    for route, sloppy in (("solve_f32", False), ("solve_sloppy", True)):
        params = SolverParams(r2req=1e-10, maxits=5000, restarts=5,
                              sloppy=sloppy)
        stag_solve.solve(s, b, 0.05, params)              # warm-up
        profiled(route, lambda: stag_solve.solve(s, b, 0.05, params))
    th = config4_theory(lat, smear=HypCoefs(0.4, 0.5, 0.5))
    th.hmc_step(gen, u)                                   # warm-up
    profiled("hmc_smeared", lambda: th.hmc_step(gen, u))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.gauge.smear import HypCoefs
    if sys.argv[1:] == ["--profile"]:
        return profile_main()

    t_start = time.perf_counter()
    dev = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kern = phase_kernel(gen)
    phase_solve(gen)
    phase_hmc(gen)
    _ab(gen, "ab")
    smeared = phase_hmc_smeared(gen)
    app = phase_app()
    _ab(gen, "ab_smeared", smear=HypCoefs(0.4, 0.5, 0.5), sloppy=True,
        start=AB_SMEARED_START)
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(dev["smi"], flush=True)
    kernels = []
    for name in ("stag8_dslash", "stag8_dslash_bf16"):
        k = kern[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "qex_tpu_torch/csrc/stag8_dslash.cu",
            "replaces": "qex_tpu/physics/stag_pallas_hisq.py:166",
            # this slice's main path: the smeared config-4 trajectories
            # (float32 solves) and the app (sloppy solves)
            "launches": (smeared["kernel_launches"][name]
                         + app["kernel_launches"][name]),
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
