"""Repelling-attracting HMC for pure gauge theory (port of
``qex_tpu.apps.rahmc``; QEX src/rahmc/puregaugerahmc.nim,
arXiv:2403.04607).

Conformal leapfrog: the momentum update carries the damping factor
b = exp(gamma eps / 2), p <- b p - eps F(U), run with -gamma (repelling)
for the first half of the trajectory and +gamma (attracting) for the
second; the phase-space volume factors cancel, so plain Metropolis is
exact.  gamma = 0 is leapfrog with ``steps`` steps.  The link update
takes its exponential in complex128 (``hmc.gauge_update_u``).

Usage:
    python -m qex_tpu_torch.apps.rahmc -lat:16,16,16,16 -beta:6.0 \
        -gamma:0.3 -tau:1.0 -steps:24 -trajs:10 -hmcUntil:2 [-cpu:true]

It runs on the CUDA card in complex64 (and raises without one);
``-cpu:true`` runs on the host in complex128.  Prints ``traj n [HMC|
raHMC]: dH .. ACCEPT|REJECT MEASplaq ..`` lines.
"""

from __future__ import annotations

import math
import sys
import time
from functools import partial

import numpy as np
import torch

from qex_tpu_torch.hmc import hmc


def conformal_half(u, p, g: float, frc, eps: float, nhalf: int):
    """One half-trajectory of conformal leapfrog at rate ``g``
    (puregaugerahmc.nim evolveRAHMC)."""
    b = math.exp(g * eps / 2)
    b2 = math.exp(g * eps)
    p = b * p - (eps / 2) * frc(u)
    for _ in range(nhalf - 1):
        u = hmc.gauge_update_u(u, p, eps)
        p = b2 * p - (1.0 + b2) * (eps / 2) * frc(u)
    u = hmc.gauge_update_u(u, p, eps)
    p = b * p - b * (eps / 2) * frc(u)
    return u, p


def ra_step_from(u, p, r: float, act, frc, gamma: float, tau: float,
                 steps: int):
    """One RAHMC trajectory from momenta ``p`` and the Metropolis uniform
    ``r``: a repelling then an attracting half, each of steps // 2
    steps.  Returns (u, dH, accepted) with a float64 dH."""
    eps = tau / steps
    nhalf = steps // 2

    def h(uu, pp):
        return float(hmc.kinetic_energy(pp) + act(uu).to(torch.float64))

    with torch.no_grad():
        h0 = h(u, p)
        u1, p1 = conformal_half(u, p, -gamma, frc, eps, nhalf)
        u1, p1 = conformal_half(u1, p1, +gamma, frc, eps, nhalf)
        dH = h(u1, p1) - h0
    acc = hmc.metropolis(dH, r)
    return (u1 if acc else u), dH, acc


def draw(gen: torch.Generator, u: torch.Tensor):
    """(p, r): Gaussian TAH momenta and the Metropolis uniform."""
    return hmc.draw_momenta(gen, u), hmc.draw_uniform(gen)


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    from qex_tpu_torch.device import resolve
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.hmc import integrators
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import group
    from qex_tpu_torch.utils.params import Params
    prm = Params(argv)
    lat_dims = prm.int_seq_param("lat", [8, 8, 8, 8], "lattice size")
    beta = prm.float_param("beta", 6.0, "gauge coupling")
    adj_fac = prm.float_param("adjFac", 0.0, "adjoint ratio")
    gamma = prm.float_param("gamma", 0.3, "conformal damping rate")
    tau = prm.float_param("tau", 1.0, "trajectory length")
    steps = prm.int_param("steps", 24, "MD steps (even)")
    trajs = prm.int_param("trajs", 10, "trajectories")
    hmc_until = prm.int_param("hmcUntil", 1, "plain-HMC warmup trajectories")
    seed = prm.int_param("seed", 987654321, "RNG seed")
    use_cpu = prm.bool_param("cpu", False, "run on the host")

    device = resolve("cpu" if use_cpu else None)
    dtype = torch.complex128 if use_cpu else torch.complex64
    lat = Lattice(tuple(lat_dims))
    coeffs = (ga.adjoint_action(beta, adj_fac) if adj_fac
              else ga.wilson(beta))
    act = partial(ga.full_action, coeffs, lat)
    frc = partial(ga.gauge_force, coeffs, lat)
    scheme = integrators.get_integrator("LF")

    print(f"# rahmc {lat.dims} beta={beta} gamma={gamma} tau={tau} "
          f"steps={steps} device={device}")
    gen = torch.Generator(device=device).manual_seed(seed)
    u = group.unit_gauge(lat, dtype, device)
    n_acc = 0
    for traj in range(trajs):
        t0 = time.time()
        p, r = draw(gen, u)
        if traj < hmc_until:
            with torch.no_grad():
                u, st = hmc.hmc_step_from(u, p, r, act, frc, scheme, tau,
                                          steps)
            dH, acc, alg = st.dH, st.accepted, "HMC"
        else:
            u, dH, acc = ra_step_from(u, p, r, act, frc, gamma, tau, steps)
            alg = "raHMC"
        n_acc += int(acc)
        plaq = np.float32(float(loops.plaquette(lat, u)))
        print(f"traj {traj} [{alg}]: dH {dH:+.6g} "
              f"{'ACCEPT' if acc else 'REJECT'} MEASplaq "
              f"{float(plaq):.10g} ({time.time()-t0:.2f} s)")
    print(f"# acceptance {n_acc}/{trajs} = {n_acc/max(1, trajs):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
