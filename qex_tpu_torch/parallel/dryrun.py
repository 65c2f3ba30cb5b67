"""Multi-rank dry run: one dynamical HMC step over n ranks (port of
``__graft_entry__.dryrun_multichip`` and its ``_dryrun_body``).

    python -m qex_tpu_torch.parallel.dryrun [--nranks N] [--cpu]

It starts N ranks (``torch.multiprocessing``; under ``torchrun`` each
process is one rank already) and on each runs :func:`body`:

1. one HMC step of gauge (Wilson beta 5.5) + staggered fermion (m 0.5)
   + Pauli-Villars boson (m 0.75) at 8^4, block-resident on the rank
   mesh (``SolverParams.mesh``: each rank holds its block of every
   field);
2. the block kernel path (``physics.stag_shard``) on a z/t mesh: the
   sharded d2ee against the unsplit operator on the same links;
3. BASELINE config 5 shrunk to 8^3x16: HISQ fattening, then the 4-mass
   multishift on the sharded 16-term operator, each mass's true
   residual checked.

Ranks run on the CUDA card (complex64; NCCL where every rank has a card
of its own, else gloo through host memory) unless ``--cpu`` puts them on
the host (complex128, gloo).  There is no fallback: without a card it
raises unless ``--cpu`` is given (the JAX dry run re-executes itself on
a virtual CPU mesh instead).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

DIMS = (8, 8, 8, 8)
DIMS5 = (8, 8, 8, 16)
MASSES5 = (0.05, 0.1, 0.2, 0.4)


def _zt_geom(n: int, Z: int, Th: int, naik: bool = False):
    """(1, 1, gz, gt) with gz * gt = n, the largest gz whose blocks the
    block kernel path takes (even local Z; with ``naik`` local Z >= 3 and
    local Th >= 2), or None."""
    for gz in range(n, 0, -1):
        gt = n // gz
        if n % gz or Z % gz or (Z // gz) % 2 or Th % gt:
            continue
        if naik and (Z // gz < 3 or Th // gt < 2):
            continue
        return (1, 1, gz, gt)
    return None


def body(device, nranks: int, dims=DIMS, dims5=DIMS5, pg=None) -> dict:
    """The dry run on this rank of process group ``pg`` (default: the default
    process group, started already) at lattices ``dims`` (the HMC step
    and the block d2ee) and ``dims5`` (config 5); returns this rank's
    numbers."""
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge import fat7, loops
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.ops import group, linalg
    from qex_tpu_torch.parallel.mesh import (gather_field, local_block,
                                             make_lattice_mesh, use_mesh)
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_shard as shd
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.rng import seeded_generator
    from qex_tpu_torch.solvers.base import SolverParams

    dev = torch.device(device)
    dtype = torch.complex128 if dev.type == "cpu" else torch.complex64
    out = {"nranks": nranks}

    def links(lat, seed):
        gen = seeded_generator(dev, seed)
        return torch.stack([linalg.expm(0.5 * group.random_tah(
            gen, lat.dims, lat.nc, dtype)) for _ in range(lat.nd)])

    lat = Lattice(dims)
    geom = _zt_geom(nranks, lat.dims[2], lat.dims[3] // 2)
    if geom is None:
        raise ValueError(f"no z/t rank geometry of {nranks} ranks at "
                         f"{lat.dims}")
    lm = make_lattice_mesh(lat, rank_geom=geom, group=pg)
    theory = LatticeFieldTheory(
        lat, gauge=GaugeActionSpec(ga.wilson(5.5), steps=4, scheme="2MN"),
        fermions=[FermionSpec("fermion", mass=0.5, steps=2, scheme="2MN",
                              smeared=False),
                  FermionSpec("boson", mass=0.75, steps=2, scheme="2MN",
                              smeared=False)],
        smear=None, bc="pppa",
        solver_params=SolverParams(r2req=1e-8, maxits=30, restarts=1,
                                   mesh=lm),
        tau=0.2)
    u = links(lat, 0)
    u1, state = theory.hmc_step(seeded_generator(dev, 1), local_block(lm, u))
    with use_mesh(lm):
        plaq = float(loops.plaquette(lat, u1))
    out.update(rank_geom=list(geom), dH=state.dH, plaquette=plaq)
    if not torch.isfinite(torch.tensor(state.dH)):
        raise AssertionError(f"dry run: dH {state.dH}")

    # the block kernel path against the unsplit operator on the same links
    fs = sf.new_fast(st.new_stag_eo(lat, u))
    ee, _ = shd.ops8(lm, shd.block_of(lm, fs))
    gen = seeded_generator(dev, 2)
    X, Y, Z, T = lat.dims
    x = torch.randn((3, T // 2, Z, Y * X), dtype=dtype, generator=gen,
                    device=dev)
    got = shd.gather_fast(lm, ee(shd.fast_block(lm, x), 0.1))
    ref = sf.d2ee_fast(fs, x, 0.1)
    out["d2ee_rel_dev"] = float(linalg.norm2(got - ref) / linalg.norm2(ref))
    if not out["d2ee_rel_dev"] < 1e-10:
        raise AssertionError(f"dry run: sharded d2ee deviates by "
                             f"{out['d2ee_rel_dev']}")

    # config 5 shrunk: HISQ fattening, 4-mass multishift on 16 terms
    lat5 = Lattice(dims5)
    geom5 = _zt_geom(nranks, lat5.dims[2], lat5.dims[3] // 2, naik=True)
    if geom5 is None:
        raise ValueError(f"no z/t rank geometry of {nranks} ranks with "
                         f"local Z >= 3 and Th >= 2 at {lat5.dims}")
    lm5 = make_lattice_mesh(lat5, rank_geom=geom5, group=pg)
    u5 = links(lat5, 5)
    with torch.no_grad():
        s35 = st.new_stag3_eo(lat5, *fat7.hisq_links_lowmem(
            lat5, st.phase_links(lat5, u5, "pppa")))
    b5 = torch.randn((3,) + lat5.dims[:3] + (lat5.dims[3] // 2,),
                     dtype=dtype, generator=seeded_generator(dev, 6),
                     device=dev)
    xs5, stats5 = shd.solve_multi_sharded(
        lm5, shd.block_of(lm5, sf.new_fast3(s35)),
        local_block(lm5, b5, "eo"), MASSES5,
        SolverParams(r2req=1e-10, maxits=400))
    worst = max(float(linalg.norm2(
        st.d2ee3(s35, gather_field(lm5, x5, "eo"), m) - b5)
        / linalg.norm2(b5)) for m, x5 in zip(MASSES5, xs5))
    out.update(config5_rank_geom=list(geom5),
               config5_iterations=stats5.iterations,
               config5_worst_true_r2=worst)
    if not worst < 1e-6:
        raise AssertionError(f"dry run: config-5 multishift true r2 {worst}")
    return out


def _rank(rank: int, nranks: int, init_method: str, backend: str,
          device: str, queue) -> None:
    from qex_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.initialize(backend, init_method=init_method,
                           world_size=nranks, rank=rank)
    try:
        if device == "cuda":
            device = f"cuda:{rank % torch.cuda.device_count()}"
        res = body(device, nranks)
        if rank == 0:
            queue.put(res)
    finally:
        torch.distributed.destroy_process_group()


def run(nranks: int, device: str = "cuda") -> dict:
    """Start ``nranks`` ranks, each running :func:`body`; rank 0's
    numbers.  ``device`` "cuda" or "cpu"; NCCL where every rank has a
    card of its own, else gloo."""
    import torch.multiprocessing as mp

    from qex_tpu_torch.parallel.distributed import free_port
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("dry run: no CUDA device (pass --cpu to run the "
                           "ranks on the host)")
    backend = ("nccl" if device != "cpu"
               and nranks <= torch.cuda.device_count() else "gloo")
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    mp.start_processes(_rank, args=(nranks, f"tcp://localhost:{free_port()}",
                                    backend, device, queue),
                       nprocs=nranks, start_method="spawn")
    return queue.get()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun")
    ap.add_argument("--nranks", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the host (gloo, complex128)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if "WORLD_SIZE" in os.environ:           # one rank of a torchrun job
        from qex_tpu_torch.parallel import distributed
        distributed.initialize("gloo" if args.cpu else "nccl")
        try:
            dev = device if args.cpu else \
                f"cuda:{distributed.local_rank() % torch.cuda.device_count()}"
            res = body(dev, torch.distributed.get_world_size())
            if torch.distributed.get_rank() != 0:
                return 0
        finally:
            torch.distributed.destroy_process_group()
    else:
        res = run(args.nranks, device)
    print(f"dryrun({res['nranks']}): rank_geom={res['rank_geom']}, "
          f"dH={res['dH']:.4f}, plaq={res['plaquette']:.6f}, sharded d2ee "
          f"rel dev={res['d2ee_rel_dev']:.3e}, config5 "
          f"rank_geom={res['config5_rank_geom']} its="
          f"{res['config5_iterations']} worst true rel_r2="
          f"{res['config5_worst_true_r2']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
