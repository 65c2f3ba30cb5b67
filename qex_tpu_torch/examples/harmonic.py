"""Coupled harmonic oscillators (free scalar field) HMC (port of
``examples/harmonic.py``; QEX's src/examples/harmonic.nim).

H = (1/2) sum_<i,j> (x_i - x_j)^2 over nearest neighbours, leapfrog MD,
Metropolis accept/reject, recentering, <x> and <x^2>.

Run: python -m qex_tpu_torch.examples.harmonic -lat:16 -ntraj:4
     -nsteps:8 -tau:1.0 [-cpu:true]   (on the CUDA card unless
     ``-cpu:true``; float64 on the host, float32 on the card)
"""

import sys

import torch

from qex_tpu_torch import device as qdevice
from qex_tpu_torch.rng import seeded_generator
from qex_tpu_torch.utils.params import Params


def action_x(x: torch.Tensor) -> torch.Tensor:
    s = 0.0
    for mu in range(x.dim()):
        d = x - torch.roll(x, -1, mu)
        s = s + 0.5 * torch.sum(d * d)
    return s


def grad_x(x: torch.Tensor) -> torch.Tensor:
    """dS/dx: sum_mu (2 x - x(+mu) - x(-mu))."""
    g = torch.zeros_like(x)
    for mu in range(x.dim()):
        g = g + 2 * x - torch.roll(x, -1, mu) - torch.roll(x, 1, mu)
    return g


def trajectory(gen, x, tau: float, nsteps: int):
    p = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    h0 = float(action_x(x) + 0.5 * torch.sum(p * p))
    eps = tau / nsteps
    x1 = x
    for _ in range(nsteps):
        x1 = x1 + 0.5 * eps * p
        p = p - eps * grad_x(x1)
        x1 = x1 + 0.5 * eps * p
    ds = float(action_x(x1) + 0.5 * torch.sum(p * p)) - h0
    r = float(torch.rand((), generator=gen, dtype=x.dtype, device=x.device))
    acc = r < min(1.0, float(torch.exp(torch.tensor(-ds))))
    x_new = x1 if acc else x
    return x_new - x_new.mean(), ds, acc       # recenter (zero mode)


def main(argv=None) -> int:
    prm = Params(sys.argv[1:] if argv is None else argv)
    dev = qdevice.resolve("cpu" if prm.bool_param("cpu", False, "host")
                          else None)
    shape = tuple(int(s) for s in prm.str_param(
        "lat", "16", "lattice size (comma-separated)").split(","))
    ntraj = prm.int_param("ntraj", 4, "trajectories")
    nsteps = prm.int_param("nsteps", 8, "MD steps")
    tau = prm.float_param("tau", 1.0, "trajectory length")
    seed = prm.int_param("seed", 1, "RNG seed")
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    x = torch.zeros(shape, dtype=dtype, device=dev)
    n_acc, ds2 = 0, 0.0
    for traj in range(1, ntraj + 1):
        x, ds, acc = trajectory(seeded_generator(dev, seed, traj), x, tau,
                                nsteps)
        ds2 += ds ** 2
        n_acc += int(acc)
        print(f"{'Accept' if acc else 'Reject'}: {ds:.6g}")
        print(f"  ave x: {float(x.mean()):.6g}")
        print(f"  ave x2: {float((x * x).mean()):.6g}")
    print(f"Acceptance ratio: {n_acc / ntraj}")
    print(f"ds2: {ds2 / ntraj:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
