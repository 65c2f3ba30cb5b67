"""The largest HISQ force along one MD trajectory, by how rough the start is.

    python -m qex_tpu_torch.apps.hisq_forces [--dims X Y Z T]
        [--start 0.7 0.3] [--seed 20261016] [--cpu]

For each start s it draws links expm(s * random_tah), then the momenta
and the pseudofermion heatbath of :func:`hisq_theory`.  It runs the
trajectory kick by kick and prints one JSON line per start: H, the
largest |F| of each HISQ kick, the kick at which a force or the links
stopped being finite (if any) and dH.  It shows where the exact
derivative of the polar projection, taken at nearly singular first-level
fat7 links, blows a trajectory up (ROADMAP C4, C5).  Runs on the CUDA
card in complex64, or with ``--cpu`` on the host in complex64.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def hisq_theory(lat):
    """BASELINE config 5's fermion in an HMC: Wilson beta=7.0 (12 x 2MN)
    and one HISQ fermion m=0.05 (6 x 2MN), bc pppa, tau 0.5, solves at
    r2req 1e-10 (maxits 1500, 3 restarts) and forces at 1e-8 (2
    restarts).  Wilson stands in for config 5's Symanzik action, whose
    rect term is not ported."""
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.solvers.base import SolverParams
    return LatticeFieldTheory(
        lat,
        gauge=GaugeActionSpec(ga.wilson(7.0), steps=12, scheme="2MN"),
        fermions=[FermionSpec("hisq", mass=0.05, steps=6, scheme="2MN")],
        bc="pppa",
        solver_params=SolverParams(r2req=1e-10, maxits=1500, restarts=3),
        force_solver_params=SolverParams(r2req=1e-8, maxits=1500,
                                         restarts=2),
        tau=0.5)


def force_trace(lat, start: float, seed: int, device) -> dict:
    """One trajectory from expm(start * random_tah) links, kick by kick."""
    from qex_tpu_torch.hmc import hmc as hmc_mod
    from qex_tpu_torch.mcmc import md
    from qex_tpu_torch.ops import group, linalg
    th = hisq_theory(lat)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.stack([linalg.expm(start * group.random_tah(
        gen, lat.dims, lat.nc, torch.complex64)) for _ in range(lat.nd)])
    p = th.draw_momenta(gen, u)
    phis = th.heatbath(gen, u)
    h_old = float(th.hamiltonian(u, p, phis))
    rec = {"dims": list(lat.dims), "start": start, "h_old": h_old,
           "hisq_max_abs_force": [], "nonfinite_at_kick": None}
    t0 = time.perf_counter()
    kick = 0
    for dt, kicks in md.build_schedule(th.terms, th.tau):
        if dt > 1e-9:
            u = hmc_mod.gauge_update_u(u, p, dt)
        for (i, cdt, _fg) in kicks:
            f = th.terms[i].force(u, phis[i])
            p = p - cdt * f
            if th.terms[i].name.startswith("hisq"):
                rec["hisq_max_abs_force"].append(float(f.abs().max()))
            if not (torch.isfinite(f).all() and torch.isfinite(u).all()):
                rec["nonfinite_at_kick"] = kick
                rec["seconds"] = time.perf_counter() - t0
                return rec
            kick += 1
    rec["dH"] = float(th.hamiltonian(u, p, phis)) - h_old
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hisq_forces")
    ap.add_argument("--dims", type=int, nargs=4, default=[24, 24, 24, 24])
    ap.add_argument("--start", type=float, nargs="+", default=[0.7, 0.3],
                    help="links expm(start * random_tah), one run each")
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("hisq_forces: no CUDA device; pass --cpu to run on the host",
              file=sys.stderr)
        return 2
    from qex_tpu_torch.lattice import Lattice
    device = torch.device("cpu" if args.cpu else "cuda")
    lat = Lattice(args.dims)
    for start in args.start:
        print(json.dumps(force_trace(lat, start, args.seed, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
