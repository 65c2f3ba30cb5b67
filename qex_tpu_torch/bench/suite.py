"""Microbenchmarks: site linalg, shifts, gauge action and force, CG,
Wilson, lattice I/O, halo exchange and the block stencils (port of
``qex_tpu.bench.suite``; QEX's src/bench/ programs benchLinalg,
benchGather, benchGauge, benchStagProp and benchQio).

    python -m qex_tpu_torch.bench.suite [--cpu] [--lat X Y Z T]
        [--budget SECONDS]

Each measurement runs a warm-up call, times one call, then times as many
calls as fit in ``--budget`` seconds (benchStagProp's calibration,
benchStagProp.nim:61-71): by CUDA events on the card, by the host clock
on the host.  The CG runs ``stag_solve``'s operator (kernel B1 on the
card) and the Wilson m_ee the plain fast layout and kernel B3.  The I/O
lines write and read a SciDAC file with the checksum codec and with its
zlib loop (``io.native``), and through ``io.pario`` on this process's
mesh.  Under a process group of several ranks (torchrun) the halo
exchange and the block stencil run on the ranks' mesh, else the block
stencil runs on a one-rank mesh.  Rank 0 prints one line per
measurement.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time


def _timeit(fn, dev, budget_s: float = 1.0) -> tuple[float, int]:
    """(seconds per call, calls) with the run length calibrated to the
    budget; CUDA events on a card, the host clock else."""
    import torch
    cuda = dev.type == "cuda"

    def timed(n):
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return time.perf_counter() - t0

    fn()
    dt1 = timed(1)
    n = max(1, int(budget_s / max(dt1, 1e-6)))
    return timed(n) / n, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_suite")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the CUDA card)")
    ap.add_argument("--lat", type=int, nargs=4, default=[16, 16, 16, 16])
    ap.add_argument("--budget", type=float, default=1.0,
                    help="seconds per measurement")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch import device as qdevice
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.io import lime, native, pario
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import eo, group, linalg
    from qex_tpu_torch.ops.shifts import shift
    from qex_tpu_torch.parallel import halo
    from qex_tpu_torch.parallel.mesh import local_block, make_lattice_mesh
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_shard as shd
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.physics import wilson_fast as wf
    from qex_tpu_torch.physics import wilson_pallas as wp
    from qex_tpu_torch.rng import seeded_generator
    from qex_tpu_torch.solvers import cg

    dev = qdevice.resolve("cpu" if args.cpu else None)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    def say(line):
        if rank0:
            print(line, flush=True)

    lat = Lattice(tuple(args.lat))
    dtype = torch.complex64
    V = lat.volume
    budget = args.budget
    say(f"# bench suite: {lat.dims} "
        f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'host'}")
    gen = seeded_generator(dev, 0)
    u = torch.stack([linalg.expm(0.7 * group.random_tah(
        gen, lat.dims, lat.nc, dtype)) for _ in range(lat.nd)])
    m = linalg.expm(0.3 * group.random_tah(gen, lat.dims, lat.nc, dtype))
    v = torch.randn(lat.vector_shape(), dtype=dtype, generator=gen,
                    device=dev)

    # --- linalg (benchLinalg) ------------------------------------------
    cases = {
        "mat*mat": (lambda: linalg.mul(m, m), V * (8 * 27 + 9 * 2)),
        "mat*vec": (lambda: linalg.mv(m, v), V * (8 * 9 + 3 * 2)),
        "expm": (lambda: linalg.expm(0.1 * m), V * (8 * 27 * 16)),
        "project_u": (lambda: linalg.project_u(m), V * (8 * 27 * 3 * 15)),
        "tah": (lambda: group.tah(m), V * 9 * 4),
    }
    for name, (fn, flops) in cases.items():
        dt, n = _timeit(fn, dev, budget)
        say(f"linalg {name:10s}: {dt*1e6:9.1f} us {flops/dt/1e9:8.1f} GF/s"
            f"  (x{n})")

    # --- shifts (benchGather) ------------------------------------------
    for mu in range(lat.nd):
        dt, n = _timeit(lambda mu=mu: shift(v, mu, +1, lat.nd), dev,
                        budget / 2)
        byt = 2 * V * lat.nc * 8
        say(f"shift mu={mu}: {dt*1e6:9.1f} us {byt/dt/1e9:8.1f} GB/s"
            f"  (x{n})")

    # --- gauge action + force (benchGauge) -----------------------------
    c = ga.symanzik(6.0)
    dt, n = _timeit(lambda: ga.full_action(c, lat, u), dev, budget)
    say(f"gauge action (symanzik): {dt*1e3:9.2f} ms  (x{n})")
    dt, n = _timeit(lambda: ga.gauge_force(c, lat, u), dev, budget)
    say(f"gauge force  (AD):       {dt*1e3:9.2f} ms  (x{n})")

    # --- CG throughput (benchStagProp) ---------------------------------
    s = st.new_stag_eo(lat, u)
    fs = sf.new_fast(s)
    be, _ = eo.pack(v, lat.nd)
    bf = sf.to_fast(be, lat)
    op, _ = stag_solve.fast_ops(fs, bf, m=0.01)
    cg.cg_solve(op, bf, r2req=1e-8, maxits=20)                # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, stats = cg.cg_solve(op, bf, r2req=1e-8, maxits=300)
    dt = time.perf_counter() - t0
    say(f"CG m=0.01: {dt:6.3f} s, {stats.iterations} iters, "
        f"{stag_solve.cg_flops(lat, 4, 3, stats.iterations)/dt/1e9:8.1f}"
        " GF/s (QEX flop model)")

    # --- Wilson eo operator (wilsonD.nim flop model, 1344/site) --------
    w = wf.new_fast_wilson(wl.new_wilson_eo(lat, u, 0.1))
    x4 = torch.stack([v, torch.roll(v, 1, -1), torch.roll(v, 2, -1),
                      torch.roll(v, 3, -1)])
    xe, _ = eo.pack(x4, lat.nd)
    xw = sf.to_fast(xe, lat)
    wfl = 1344 * (V // 2)
    dt, n = _timeit(lambda: wf.m_ee_fast(w, xw), dev, budget)
    say(f"wilson m_ee fast  : {dt/2*1e3:9.2f} ms/hop "
        f"{wfl/(dt/2)/1e9:8.1f} GF/s  (x{n})")
    pw = wp.new_pallas_wilson(w)
    dt, n = _timeit(lambda: wp.m_ee_w(pw, xw), dev, budget)
    say(f"wilson m_ee {'kernel' if dev.type == 'cuda' else 'twin  '}: "
        f"{dt/2*1e3:9.2f} ms/hop {wfl/(dt/2)/1e9:8.1f} GF/s  (x{n})")

    # --- lattice I/O (benchQio) ----------------------------------------
    lm = make_lattice_mesh(lat)
    un = u.cpu().numpy()
    native.library()                  # the codec's build is not timed
    with tempfile.TemporaryDirectory() as td:
        fn = os.path.join(td, f"bench_gauge_{lm.rank}.lime")
        for label in ("codec", "zlib"):
            with (native.zlib_only() if label == "zlib"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                lime.save_gauge(fn, lat, un)
                t_w = time.perf_counter() - t0
                route = native.last_route
                sz = os.path.getsize(fn)
                t0 = time.perf_counter()
                lime.load_gauge(fn, lat)
                t_r = time.perf_counter() - t0
            say(f"IO {label:5s} ({route}): write {t_w:6.3f} s "
                f"{sz/t_w/1e6:7.0f} MB/s | read(+cksum) {t_r:6.3f} s "
                f"{sz/t_r/1e6:7.0f} MB/s")
        lm.barrier()
        fn2 = os.path.join(td, "bench_gauge_par.lime")
        if lm.size > 1:
            fn2 = _shared_name(lm, fn2)
        blk = local_block(lm, u).cpu()
        t0 = time.perf_counter()
        pario.save_gauge_parallel(fn2, lat, lm, blk)
        t_pw = time.perf_counter() - t0
        t0 = time.perf_counter()
        pario.load_gauge_parallel(fn2, lat, lm)
        t_pr = time.perf_counter() - t0
        say(f"IO pario ({lm.size} rank{'s' if lm.size > 1 else ''}): write "
            f"{t_pw:6.3f} s {sz/t_pw/1e6:7.0f} MB/s | read(+cksum) "
            f"{t_pr:6.3f} s {sz/t_pr/1e6:7.0f} MB/s")
        lm.barrier()

    # --- halo exchange and the block stencil ---------------------------
    if lm.size > 1:
        vb = local_block(lm, v)
        for mu in range(lat.nd):
            if lm.rank_geom[mu] == 1:
                continue
            dt, n = _timeit(lambda mu=mu: halo.shift_halo(lm, vb, mu, +1),
                            dev, budget / 2)
            face = V // lat.dims[mu] * lat.nc * 8
            say(f"halo mu={mu} ({lm.rank_geom[mu]} ranks): {dt*1e6:9.1f} us "
                f"{face/dt/1e9:6.2f} GB/s face  (x{n})")
    Z, Th = lat.dims[2], lat.dims[3] // 2
    gzs = [d for d in range(1, lm.size + 1)
           if lm.size % d == 0 and Z % d == 0 and (Z // d) % 2 == 0
           and Th % (lm.size // d) == 0]
    if gzs:
        lm2 = make_lattice_mesh(lat, rank_geom=(1, 1, max(gzs),
                                                lm.size // max(gzs)))
        ee, _ = shd.ops8(lm2, shd.block_of(lm2, fs))
        xb = shd.fast_block(lm2, bf)
        dt, n = _timeit(lambda: ee(xb, 0.1), dev, budget)
        say(f"stencil d2ee ({lm2.rank_geom} mesh): {dt*1e3:9.2f} ms "
            f"{2*594*(V//2)/dt/1e9:7.1f} GF/s  (x{n})")
        if lm2.staged:
            say(f"  host-staged exchanges: {lm2.stats['staged_s']:.4f} s "
                f"of which copies {lm2.stats['copy_s']:.4f} s")
    return 0


def _shared_name(lm, name: str) -> str:
    """Rank 0's temporary file name, on every rank (each made its own
    temporary directory): the ranks must write one file together."""
    import torch.distributed as dist
    obj = [name]
    dist.broadcast_object_list(obj, 0, group=lm.group)
    return obj[0]


if __name__ == "__main__":
    sys.exit(main())
