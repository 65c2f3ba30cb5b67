"""Pure-gauge HMC program (port of ``qex_tpu.apps.puregauge_hmc``; QEX
puregaugehmc): lattice, SU(nc) gauge group (nc=1 is compact U(1)),
Wilson, rect (``--c1``) or adjoint (``--adj``) action, tau, steps,
integrator, seed, trajectory count and warm-up; BASELINE config 3 is
16^3x32 SU(3) at beta 6.0.

Usage:
    python -m qex_tpu_torch.apps.puregauge_hmc --lattice 16 16 16 32 \\
        --beta 6.0 --tau 1.0 --steps 20 --int 2MN --ntraj 10 [--cpu]

It runs on the CUDA card in complex64; ``--cpu`` runs on the host in
complex128.  Each trajectory draws from a ``torch.Generator`` seeded
from ``(seed, traj)``, the hot start from ``seed``.  ``--save`` writes
the port's ``.npz`` checkpoint, which the JAX package also reads.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .staghmc_spv import hot_start, seeded_generator


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    ap = argparse.ArgumentParser(prog="puregauge_hmc")
    ap.add_argument("--lattice", type=int, nargs="+", default=[8, 8, 8, 8])
    ap.add_argument("--nc", type=int, default=3,
                    help="gauge group SU(nc); nc=1 gives compact U(1)")
    ap.add_argument("--beta", type=float, default=6.0)
    ap.add_argument("--c1", type=float, default=None,
                    help="rectangle coefficient (rect action)")
    ap.add_argument("--adj", type=float, default=None,
                    help="adjoint/fundamental ratio (adjoint action)")
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--int", dest="integ", default="2MN")
    ap.add_argument("--ntraj", type=int, default=10)
    ap.add_argument("--seed", type=int, default=987654321)
    ap.add_argument("--start", default="cold", choices=["cold", "hot"])
    ap.add_argument("--warmup", type=int, default=1,
                    help="trajectories with Metropolis disabled")
    ap.add_argument("--save", help="checkpoint path to write at the end")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host in complex128 (default: the "
                    "CUDA card in complex64)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("puregauge_hmc: no CUDA device; pass --cpu to run on the "
              "host", file=sys.stderr)
        return 2

    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.hmc import hmc, integrators
    from qex_tpu_torch.io import checkpoint as ckpt
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import group

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.complex128 if args.cpu else torch.complex64
    lat = Lattice(tuple(args.lattice), nc=args.nc)
    if args.adj is not None:
        coeffs = ga.adjoint_action(args.beta, args.adj)
    elif args.c1 is not None:
        coeffs = ga.gauge_act_rect(args.beta, args.c1)
    else:
        coeffs = ga.wilson(args.beta)

    def act(u):
        return ga.full_action(coeffs, lat, u)

    def frc(u):
        return ga.gauge_force(coeffs, lat, u)

    scheme = integrators.get_integrator(args.integ)
    print(f"# puregauge_hmc {lat.dims} beta={args.beta} tau={args.tau} "
          f"steps={args.steps} int={scheme.name} device={device}")

    if args.start == "cold":
        u = group.unit_gauge(lat, dtype, device)
    else:
        u = hot_start(lat, dtype, device, args.seed)

    n_acc = 0
    for traj in range(args.ntraj):
        t0 = time.time()
        warm = traj < args.warmup
        u, st = hmc.hmc_step(seeded_generator(device, args.seed, traj), u, act,
                             frc, scheme, args.tau, args.steps,
                             always_accept=warm)
        pl = float(loops.plaquette(lat, u))
        n_acc += int(st.accepted and not warm)
        print(f"traj {traj}: dH {st.dH:+.6g} "
              f"{'ACCEPT' if st.accepted else 'REJECT'}"
              f"{' [warmup]' if warm else ''}"
              f" MEASplaq {pl:.10g} ({time.time() - t0:.2f} s)")
    meas = args.ntraj - args.warmup
    if meas > 0:
        print(f"# acceptance {n_acc}/{meas} = {n_acc / meas:.3f}")
    if args.save:
        ckpt.save_checkpoint(args.save, u, {"seed": args.seed}, args.ntraj)
        print(f"# saved {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
