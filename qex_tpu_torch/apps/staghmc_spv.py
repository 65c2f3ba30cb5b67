"""XML-driven staggered + Pauli-Villars HMC, the production app (port of
``qex_tpu.apps.staghmc_spv``).

nHYP-smeared staggered fermions (Nf, mass) + num_pv Pauli-Villars bosons
(mass_pv), an unsmeared and an optional smeared Wilson gauge action,
per-field integrators and step counts, a Metropolis warm-up
(no_metropolis_until), measurement lines, solver and reversibility
checks, and checkpoints.

Usage:
    python -m qex_tpu_torch.apps.staghmc_spv --xml deck.xml \
        [--ntraj N] [--cpu] [-key=value ...]

It runs on the CUDA card in complex64; ``--cpu`` runs on the host in
complex128.  Output lines carry the reference's tags: ``Begin H``,
``End H``, ``ACCEPT``/``REJECT``, ``MEASplaq``, ``MEASplaq6``,
``MEASploop``, ``SOLVER``, ``REVCHECK``.

Each trajectory draws from a ``torch.Generator`` seeded from
``(serial_seed, traj)`` (the hot start from ``parallel_seed``), so a
resume from a checkpoint repeats the chain.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

# words appended to (serial_seed, traj) for the per-trajectory checks,
# the JAX app's fold_in constants
_SOLVER_WORD = 101
_REVCHECK_WORD = 202


def seed_of(*words: int) -> int:
    """A 63-bit generator seed from a tuple of non-negative integers."""
    state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _generator(device: torch.device, *words: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(*words))


def _check_scheme(name: str) -> None:
    from qex_tpu_torch.hmc.integrators import get_integrator
    if any(st[0] == "FG" for st in get_integrator(name).steps):
        raise NotImplementedError(
            f"integrator {name!r} has force-gradient steps, which are not "
            "ported yet (ROADMAP A4)")


def build_theory(cfg, lat):
    """The port's LatticeFieldTheory for an HMCConfig (the JAX app's
    ``build_theory``)."""
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.solvers.base import SolverParams

    def coeffs(act, beta):
        if act.lower() == "wilson":
            return ga.wilson(beta)
        if act.lower() in ("rect", "adjoint"):
            raise NotImplementedError(
                f"gauge action {act!r} is not ported yet (ROADMAP A4)")
        raise ValueError(f"unknown gauge action {act!r}")

    _check_scheme(cfg.gauge_int_alg)
    gauges = [GaugeActionSpec(coeffs(cfg.gauge_act, cfg.beta),
                              steps=cfg.g_steps, scheme=cfg.gauge_int_alg,
                              smeared=False)]
    if cfg.sg_opt:
        _check_scheme(cfg.smeared_gauge_int_alg)
        gauges.append(GaugeActionSpec(
            coeffs(cfg.smeared_gauge_act, cfg.sm_beta),
            steps=cfg.sg_steps, scheme=cfg.smeared_gauge_int_alg,
            smeared=True))

    fermions = []
    matter_smeared = cfg.matter_smearing.lower() == "nhyp"
    # each staggered field is 4 tastes: Nf % 4 == 0 takes Nf/4 plain
    # pseudofermion fields, as the reference
    if cfg.nf > 0:
        if cfg.nf % 4 != 0:
            raise NotImplementedError(
                f"Nf={cfg.nf} needs a rooted fermion, which is not ported "
                "yet (ROADMAP A6)")
        _check_scheme(cfg.ferm_int_alg)
        for _ in range(cfg.nf // 4):
            fermions.append(FermionSpec("fermion", cfg.mass,
                                        steps=cfg.f_steps,
                                        scheme=cfg.ferm_int_alg,
                                        smeared=matter_smeared))
    if cfg.num_pv > 0:
        _check_scheme(cfg.pv_int_alg)
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
                                   restarts=3, sloppy=sloppy),
        # MD-force solves at the (usually looser) f_tol/f_maxits
        force_solver_params=SolverParams(r2req=cfg.f_tol,
                                         maxits=cfg.f_maxits, restarts=3,
                                         sloppy=sloppy),
        tau=cfg.tau)


def hot_start(lat, dtype, device, seed: int, scale: float = 0.7
              ) -> torch.Tensor:
    """expm(scale * random_tah) per link from a generator seeded by
    ``seed``."""
    from qex_tpu_torch.ops import group, linalg
    gen = _generator(device, seed)
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
                    help="not ported: the JAX app's per-phase timer tree "
                    "needs its split-step dispatcher")
    ap.add_argument("overrides", nargs="*",
                    help="-key=value config overrides")
    args, unknown = ap.parse_known_args(argv)
    args.overrides = list(args.overrides) + [
        a for a in unknown if a.startswith("-") and "=" in a]
    bad = [a for a in unknown if not (a.startswith("-") and "=" in a)]
    if bad:
        ap.error(f"unrecognized arguments: {bad}")
    if args.profile:
        raise NotImplementedError(
            "--profile: the split-step dispatcher it times is not ported "
            "(ROADMAP: do not port it)")
    if not args.cpu and not torch.cuda.is_available():
        print("staghmc_spv: no CUDA device; pass --cpu to run on the host",
              file=sys.stderr)
        return 2

    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.io import checkpoint as ckpt
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import group
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
    if cfg.rank_geom:
        raise NotImplementedError(
            "rank_geom: multi-GPU runs are not ported yet (ROADMAP A11)")
    if cfg.pbp_freq > 0:
        raise NotImplementedError(
            "pbp_freq: the chiral condensate is not ported yet (ROADMAP A9)")
    ntraj = args.ntraj if args.ntraj is not None else cfg.num_trajectories

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.complex128 if args.cpu else torch.complex64
    lat = Lattice(cfg.dims)
    theory = build_theory(cfg, lat)
    print(f"# staghmc_spv: lattice {lat.dims} nf={cfg.nf} "
          f"mass={cfg.mass} num_pv={cfg.num_pv} mass_pv={cfg.mass_pv} "
          f"beta={cfg.beta} tau={cfg.tau} sloppy={bool(cfg.sloppy_solve)} "
          f"device={device} dtype={dtype}")

    start_traj = 0
    n_acc = 0
    if cfg.start_config > 0:
        fn = os.path.join(cfg.save_path,
                          f"{cfg.save_filename}_{cfg.start_config}")
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

    for traj in range(start_traj, start_traj + ntraj):
        t0 = time.time()
        warmup = traj < cfg.no_metropolis_until
        u, st = theory.hmc_step(_generator(device, cfg.serial_seed, traj),
                                u, always_accept=warmup)
        n_acc += int(st.accepted and not warmup)
        print(f"Begin H: {st.h_old:.15g}")
        print(f"End H: {st.h_new:.15g}")
        print(f"{'ACCEPT' if st.accepted else 'REJECT'}: dH {st.dH:.6g} "
              f"({time.time() - t0:.2f} s){' [warmup]' if warmup else ''}")
        if cfg.check_solvers:
            report = theory.solver_report(
                _generator(device, cfg.serial_seed, traj, _SOLVER_WORD), u)
            for name, (its, rel) in report.items():
                print(f"SOLVER {name}: its {int(its)} relr2 {rel:.4g}")
        if cfg.rev_check_freq and (traj + 1) % cfg.rev_check_freq == 0:
            rev = theory.reverse_check(
                _generator(device, cfg.serial_seed, traj, _REVCHECK_WORD), u)
            print(f"Reversed H: {rev['h2']:.15g}")
            print(f"REVCHECK dHrev {rev['dH_rev']:.6g} "
                  f"udev2 {rev['u_dev2']:.6g} pdev2 {rev['p_dev2']:.6g}")
        with torch.no_grad():
            if cfg.plaq_freq and (traj + 1) % cfg.plaq_freq == 0:
                print(f"MEASplaq {float(loops.plaquette(lat, u)):.15g}")
                if cfg.plaq_verbose:
                    print("MEASplaq6 " + " ".join(
                        f"{float(x):.10g}"
                        for x in loops.plaquette_by_plane(lat, u)))
            if cfg.ploop_freq and (traj + 1) % cfg.ploop_freq == 0:
                pl = complex(loops.polyakov_loop(lat, u))
                print(f"MEASploop {pl.real:.10g} {pl.imag:.10g}")
        if cfg.save_freq and (traj + 1) % cfg.save_freq == 0:
            fn = os.path.join(cfg.save_path,
                              f"{cfg.save_filename}_{traj + 1}")
            ckpt.save_checkpoint(fn, u,
                                 {"serial_seed": cfg.serial_seed,
                                  "parallel_seed": cfg.parallel_seed,
                                  "n_acc": n_acc},
                                 traj + 1)
            print(f"# saved {fn}")
    done = ntraj - max(0, min(cfg.no_metropolis_until - start_traj, ntraj))
    if done > 0:
        print(f"# acceptance: {n_acc}/{done} = {n_acc / done:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
