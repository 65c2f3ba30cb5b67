"""XML-driven staggered + Pauli-Villars HMC, the production app (port of
``qex_tpu.apps.staghmc_spv``).

nHYP-smeared staggered fermions (Nf, mass; one rooted field where Nf is
not a multiple of 4) + num_pv Pauli-Villars bosons
(mass_pv), an unsmeared and an optional smeared gauge action (Wilson,
rect or adjoint), per-field integrators (force-gradient schemes
included) and step counts, a Metropolis warm-up
(no_metropolis_until), measurement lines, solver and reversibility
checks, and checkpoints.

Usage:
    python -m qex_tpu_torch.apps.staghmc_spv --xml deck.xml \
        [--ntraj N] [--cpu] [--profile] [-key=value ...]
    torchrun --nproc_per_node=2 -m qex_tpu_torch.apps.staghmc_spv \
        --xml deck.xml -rank_geom=1x1x1x2 ...

It runs on the CUDA card in complex64; ``--cpu`` runs on the host in
complex128.  Output lines carry the reference's tags: ``Begin H``,
``End H``, ``ACCEPT``/``REJECT``, ``MEASplaq``, ``MEASplaq6``,
``MEASploop``, ``MEASpbp`` (every ``pbp_freq`` trajectories, the
chiral condensate of ``observables.condensate`` on the unsmeared links),
``SOLVER``, ``REVCHECK``.

``-rank_geom`` splits the lattice over the ranks of a process group
(``parallel.mesh``, z and t only: ``1x1xgzxgt``) and runs
block-resident: each rank holds only its block of the gauge field, the
momenta, the smeared links and the pseudofermions, exchanges faces
where a shift crosses its block and all-reduces every sum in float64
(``mcmc.theory``); the solves run on the block kernels
(``physics.stag_shard``).  Every rank draws the same momenta and noise
whole from the same seeded generators and keeps its block, so the chain
is the one run without a mesh.  Rank 0 prints the lines, from global
sums; each rank saves its block of a checkpoint
(``parallel.distributed.save_shards``, a directory ``<name>.shards``)
and a resume reads it back re-cut for the run's own geometry, or cuts
a one-process checkpoint.  ``--profile`` prints a timer tree of each
trajectory (``utils.profile``).

Each trajectory draws from a ``torch.Generator`` seeded from
``(serial_seed, traj)`` (the hot start from ``parallel_seed``), so a
resume from a checkpoint repeats the chain.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import time

import torch

from qex_tpu_torch.parallel import distributed
from qex_tpu_torch.rng import seeded_generator

# words appended to (serial_seed, traj) for the per-trajectory checks,
# the JAX app's fold_in constants
_SOLVER_WORD = 101
_REVCHECK_WORD = 202
# the chiral condensate's noise comes from (parallel_seed, 10_000 + traj),
# as the JAX app folds it, so it draws nothing from the trajectory's stream
_PBP_WORD = 10_000


def build_theory(cfg, lat, mesh=None):
    """The port's LatticeFieldTheory for an HMCConfig (the JAX app's
    ``build_theory``); ``mesh`` splits its solves over a rank mesh."""
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.solvers.base import SolverParams

    def coeffs(act, beta, c1, adj_fac):
        if act.lower() == "wilson":
            return ga.wilson(beta)
        if act.lower() == "rect":
            return ga.gauge_act_rect(beta, c1)
        if act.lower() == "adjoint":
            return ga.adjoint_action(beta, adj_fac)
        raise ValueError(f"unknown gauge action {act!r}")

    gauges = [GaugeActionSpec(coeffs(cfg.gauge_act, cfg.beta, cfg.c1,
                                     cfg.adj_fac),
                              steps=cfg.g_steps, scheme=cfg.gauge_int_alg,
                              smeared=False)]
    if cfg.sg_opt:
        gauges.append(GaugeActionSpec(
            coeffs(cfg.smeared_gauge_act, cfg.sm_beta, cfg.sm_c1,
                   cfg.sm_adj_fac),
            steps=cfg.sg_steps, scheme=cfg.smeared_gauge_int_alg,
            smeared=True))

    fermions = []
    matter_smeared = cfg.matter_smearing.lower() == "nhyp"
    # each staggered field is 4 tastes: Nf % 4 == 0 takes Nf/4 plain
    # pseudofermion fields, as the reference, any other Nf one rooted
    # field
    if cfg.nf > 0:
        if cfg.nf % 4 == 0:
            for _ in range(cfg.nf // 4):
                fermions.append(FermionSpec("fermion", cfg.mass,
                                            steps=cfg.f_steps,
                                            scheme=cfg.ferm_int_alg,
                                            smeared=matter_smeared))
        else:
            fermions.append(FermionSpec("rooted", cfg.mass,
                                        steps=cfg.f_steps,
                                        scheme=cfg.ferm_int_alg,
                                        smeared=matter_smeared, nf=cfg.nf))
    for _ in range(cfg.num_pv):
        fermions.append(FermionSpec("boson", cfg.mass_pv,
                                    steps=cfg.pv_steps,
                                    scheme=cfg.pv_int_alg,
                                    smeared=matter_smeared))

    smear = (HypCoefs(cfg.alpha_1, cfg.alpha_2, cfg.alpha_3)
             if (matter_smeared or cfg.gauge_smearing.lower() == "nhyp")
             else None)
    sloppy = bool(cfg.sloppy_solve)
    return LatticeFieldTheory(
        lat, gauges, fermions, smear=smear, bc=cfg.bc,
        solver_params=SolverParams(r2req=cfg.a_tol, maxits=cfg.a_maxits,
                                   restarts=3, sloppy=sloppy, mesh=mesh),
        # MD-force solves at the (usually looser) f_tol/f_maxits
        force_solver_params=SolverParams(r2req=cfg.f_tol,
                                         maxits=cfg.f_maxits, restarts=3,
                                         sloppy=sloppy, mesh=mesh),
        tau=cfg.tau)


def profile_patches(theory) -> list:
    """The calls ``--profile`` times inside a trajectory: (name, owner,
    attribute) for :meth:`utils.profile.Profiler.timing`."""
    from qex_tpu_torch.mcmc import md
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.physics.stag_hmc import (HisqFermion,
                                                StagRootedFermion)
    return [("smear_forward", theory, "_smear"),
            ("smear_pullback", md, "_pullback"),
            ("solve_ee", stag_solve, "solve_ee"),
            ("solve_multi", stag_solve, "solve_multi"),
            ("hisq_solve", HisqFermion, "_solve_links"),
            ("rooted_multishift", StagRootedFermion, "_multishift")]


def hot_start(lat, dtype, device, seed: int, scale: float = 0.7
              ) -> torch.Tensor:
    """expm(scale * random_tah) per link from a generator seeded by
    ``seed``."""
    from qex_tpu_torch.ops import group, linalg
    gen = seeded_generator(device, seed)
    return torch.stack([linalg.expm(scale * group.random_tah(
        gen, lat.dims, lat.nc, dtype)) for _ in range(lat.nd)])


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    ap = argparse.ArgumentParser(prog="staghmc_spv")
    ap.add_argument("--xml", help="XML input deck (input_hmc.xml format)")
    ap.add_argument("--json", help="JSON input deck")
    ap.add_argument("--ntraj", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host in complex128 (default: the "
                    "CUDA card in complex64)")
    ap.add_argument("--profile", action="store_true",
                    help="print a per-trajectory timer tree (smear forward "
                    "and pullback, solves; QEX profile.nim echoTimers "
                    "role), with a device sync around each timed call")
    ap.add_argument("overrides", nargs="*",
                    help="-key=value config overrides")
    args, unknown = ap.parse_known_args(argv)
    args.overrides = list(args.overrides) + [
        a for a in unknown if a.startswith("-") and "=" in a]
    bad = [a for a in unknown if not (a.startswith("-") and "=" in a)]
    if bad:
        ap.error(f"unrecognized arguments: {bad}")
    if not args.cpu and not torch.cuda.is_available():
        print("staghmc_spv: no CUDA device; pass --cpu to run on the host",
              file=sys.stderr)
        return 2

    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.utils.config import HMCConfig

    if args.xml:
        cfg = HMCConfig.from_xml(args.xml)
    elif args.json:
        cfg = HMCConfig.from_json(args.json)
    else:
        cfg = HMCConfig()
    kvs = {}
    for ov in args.overrides:
        k, _, v = ov.lstrip("-").partition("=")
        kvs[k] = v
    cfg.override(kvs)
    ntraj = args.ntraj if args.ntraj is not None else cfg.num_trajectories

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.complex128 if args.cpu else torch.complex64
    lat = Lattice(cfg.dims)
    lm, own_group = None, False
    if cfg.rank_geom:
        lm, own_group = _rank_mesh(cfg.rank_geom, lat, args)
        if not args.cpu:
            device = torch.device("cuda", distributed.local_rank()
                                  % torch.cuda.device_count())
    try:
        with (contextlib.redirect_stdout(io.StringIO())
              if lm is not None and lm.rank != 0
              else contextlib.nullcontext()):
            return _run(args, cfg, lat, lm, device, dtype, ntraj)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _rank_mesh(rank_geom: str, lat, args):
    """(mesh, whether this call started the process group) of the deck's
    ``rank_geom`` ("gx,gy,gz,gt" or "gxxgyxgzxgt").  Under torchrun the
    group is started here: NCCL where every rank has a card of its own,
    else gloo (ranks on the host, or sharing one card through host
    memory)."""
    import torch.distributed as dist

    from qex_tpu_torch.parallel.mesh import make_lattice_mesh
    rg = [int(x) for x in rank_geom.replace("x", ",").split(",") if x]
    own = False
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        ws = int(os.environ["WORLD_SIZE"])
        distributed.initialize("nccl" if not args.cpu
                               and ws <= torch.cuda.device_count()
                               else "gloo")
        own = True
    return make_lattice_mesh(lat, rank_geom=rg), own


def _save_shards(fn: str, lm, u, state: dict, traj: int) -> None:
    """Each rank's block of the links under ``fn.shards/`` and, from
    rank 0, the chain's state beside them."""
    import json
    distributed.save_shards(fn + ".shards", lm, u, n_site_axes=3)
    if lm.rank == 0:
        with open(os.path.join(fn + ".shards", "chain.json"), "w") as f:
            json.dump({"rng_state": state, "traj": traj}, f)
    lm.barrier()


def _load_shards(fn: str, lm, dtype, device):
    """(this rank's block, rng_state, traj) of :func:`_save_shards`'s
    checkpoint, re-cut for ``lm``."""
    import json
    u = distributed.load_shards(fn + ".shards", lm, 3, device=device)
    with open(os.path.join(fn + ".shards", "chain.json")) as f:
        chain = json.load(f)
    return u.to(dtype), chain["rng_state"], int(chain["traj"])


def _run(args, cfg, lat, lm, device, dtype, ntraj) -> int:
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.io import checkpoint as ckpt
    from qex_tpu_torch.observables import condensate
    from qex_tpu_torch.ops import group
    from qex_tpu_torch.parallel.mesh import local_block, use_mesh
    from qex_tpu_torch.solvers.base import SolverParams
    from qex_tpu_torch.utils import profile

    theory = build_theory(cfg, lat, mesh=lm)
    if lm is not None:
        print(f"# rank mesh rank_geom={lm.rank_geom} ({lm.size} ranks"
              f"{', host-staged' if lm.staged else ''})")
    print(f"# staghmc_spv: lattice {lat.dims} nf={cfg.nf} "
          f"mass={cfg.mass} num_pv={cfg.num_pv} mass_pv={cfg.mass_pv} "
          f"beta={cfg.beta} tau={cfg.tau} sloppy={bool(cfg.sloppy_solve)} "
          f"device={device} dtype={dtype}")

    start_traj = 0
    n_acc = 0
    if cfg.start_config > 0:
        fn = os.path.join(cfg.save_path,
                          f"{cfg.save_filename}_{cfg.start_config}")
        if lm is not None and os.path.isdir(fn + ".shards"):
            u, rng_state, start_traj = _load_shards(fn, lm, dtype, device)
        else:
            u, rng_state, start_traj = ckpt.load_checkpoint(fn, lat, dtype,
                                                            device)
        n_acc = int(rng_state.get("n_acc", 0))
        if int(rng_state.get("serial_seed", cfg.serial_seed)) \
                != cfg.serial_seed:
            print("# WARNING: checkpoint serial_seed "
                  f"{rng_state['serial_seed']} != deck {cfg.serial_seed};"
                  " using checkpoint value for chain continuity")
            cfg.serial_seed = int(rng_state["serial_seed"])
        print(f"# resumed from {fn} at trajectory {start_traj}")
    elif cfg.start == "cold":
        u = group.unit_gauge(lat, dtype, device)
    else:
        u = hot_start(lat, dtype, device, cfg.parallel_seed)
    if lm is not None and u.shape[3:] == tuple(lat.dims):
        u = local_block(lm, u)

    prof = profile.Profiler() if args.profile else None
    for traj in range(start_traj, start_traj + ntraj):
        t0 = time.time()
        warmup = traj < cfg.no_metropolis_until
        gen = seeded_generator(device, cfg.serial_seed, traj)
        if prof is None:
            u, st = theory.hmc_step(gen, u, always_accept=warmup)
        else:
            with prof.timing(profile_patches(theory), sync=device), \
                    prof.timer("trajectory", sync=device):
                u, st = theory.hmc_step(gen, u, always_accept=warmup)
        n_acc += int(st.accepted and not warmup)
        print(f"Begin H: {st.h_old:.15g}")
        print(f"End H: {st.h_new:.15g}")
        print(f"{'ACCEPT' if st.accepted else 'REJECT'}: dH {st.dH:.6g} "
              f"({time.time() - t0:.2f} s){' [warmup]' if warmup else ''}")
        if prof is not None:
            print("PROFILE trajectory phase tree:")
            print(prof.report())
            prof.reset()
        if cfg.check_solvers:
            report = theory.solver_report(seeded_generator(
                device, cfg.serial_seed, traj, _SOLVER_WORD), u)
            for name, (its, rel) in report.items():
                print(f"SOLVER {name}: its {int(its)} relr2 {rel:.4g}")
        if cfg.rev_check_freq and (traj + 1) % cfg.rev_check_freq == 0:
            rev = theory.reverse_check(seeded_generator(
                device, cfg.serial_seed, traj, _REVCHECK_WORD), u)
            print(f"Reversed H: {rev['h2']:.15g}")
            print(f"REVCHECK dHrev {rev['dH_rev']:.6g} "
                  f"udev2 {rev['u_dev2']:.6g} pdev2 {rev['p_dev2']:.6g}")
        with torch.no_grad(), use_mesh(lm):
            if cfg.plaq_freq and (traj + 1) % cfg.plaq_freq == 0:
                print(f"MEASplaq {float(loops.plaquette(lat, u)):.15g}")
                if cfg.plaq_verbose:
                    print("MEASplaq6 " + " ".join(
                        f"{float(x):.10g}"
                        for x in loops.plaquette_by_plane(lat, u)))
            if cfg.ploop_freq and (traj + 1) % cfg.ploop_freq == 0:
                pl = complex(loops.polyakov_loop(lat, u))
                print(f"MEASploop {pl.real:.10g} {pl.imag:.10g}")
            if cfg.pbp_freq and (traj + 1) % cfg.pbp_freq == 0:
                pbp = condensate.pbp_staggered(
                    seeded_generator(device, cfg.parallel_seed,
                                     _PBP_WORD + traj),
                    lat, u, cfg.mass, bc=cfg.bc,
                    params=SolverParams(r2req=cfg.a_tol,
                                        maxits=cfg.a_maxits, restarts=3))
                print(f"MEASpbp {pbp:.10g}")
        if cfg.save_freq and (traj + 1) % cfg.save_freq == 0:
            fn = os.path.join(cfg.save_path,
                              f"{cfg.save_filename}_{traj + 1}")
            state = {"serial_seed": cfg.serial_seed,
                     "parallel_seed": cfg.parallel_seed, "n_acc": n_acc}
            if lm is not None:
                _save_shards(fn, lm, u, state, traj + 1)
                fn += ".shards"
            else:
                ckpt.save_checkpoint(fn, u, state, traj + 1)
            print(f"# saved {fn}")
    done = ntraj - max(0, min(cfg.no_metropolis_until - start_traj, ntraj))
    if done > 0:
        print(f"# acceptance: {n_acc}/{done} = {n_acc / done:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
