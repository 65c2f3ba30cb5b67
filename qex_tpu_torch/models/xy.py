"""XY model Monte Carlo in any dimension: heatbath, Metropolis, Wolff
cluster and the spin gradient flow (port of ``qex_tpu.models.xy``).

H = -beta * sum_{x,mu} cos(theta(x) - theta(x+mu)).

Every stochastic update is a deterministic core that takes its draws as
tensors (``*_from``) and a thin wrapper that draws them from a
``torch.Generator`` (``draw_*``); the wrappers look the draw functions
up by name, so a caller can swap in draws of its own.  Global sums (the
energy, the magnetization) are taken in float64.

* Heatbath: theta(x) given its neighbours is von Mises with
  kappa = beta |h(x)| around the local field's angle, sampled by the
  Best-Fisher rejection scheme with at most ``VM_ITERS`` proposals per
  site (a site that accepts none keeps its uniform start ``theta0``).
  All proposals are drawn up front, so the first accepted one is found
  by one ``argmax`` over the proposal axis: no host read per sweep.
* Wolff: the seed's cluster grows by label propagation over the frozen
  bonds.  Each sweep first fills every straight run of frozen bonds
  along each axis (a segmented OR by ``index_add``), then takes one
  step across every bond, the periodic ones included.  Propagation only
  adds sites joined to the cluster and stops at a fixed point closed
  under single bonds, so it ends at the connected component whatever
  the sweep order; testing for the fixed point every ``check_every``
  sweeps (one host read each; ``WOLFF_CHECK``) gives the same cluster
  bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

VM_ITERS = 32          # Best-Fisher proposals per site (the reference's cap)
# Wolff propagation sweeps per fixed-point test: on an H100 at L=256 a
# 40-44-sweep cluster took 33.0-40.4 ms testing every sweep, 23.8-29.2
# ms every 4th and 24.8-34.1 ms every 16th, a one-site cluster 0.9-1.3,
# 2.0-3.2 and 7.1-12.1 ms (chip_smoke.py phase xy, two runs)
WOLFF_CHECK = 4


def energy(theta: torch.Tensor, beta: float) -> torch.Tensor:
    """H = -beta sum_{x,mu} cos(dtheta_mu), a float64 scalar."""
    th = theta.to(torch.float64)
    e = 0.0
    for mu in range(th.dim()):
        e = e + torch.cos(torch.roll(th, -1, mu) - th).sum()
    return -beta * e


def magnetization(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(|M|, arg M) with M = mean exp(i theta), float64 scalars."""
    th = theta.to(torch.float64)
    mr, mi = torch.cos(th).mean(), torch.sin(th).mean()
    return torch.hypot(mr, mi), torch.atan2(mi, mr)


def _local_field(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(magnitude, angle) of h(x) = sum_neighbours exp(i theta_nbr)."""
    hr = hi = 0.0
    for mu in range(theta.dim()):
        for sgn in (-1, 1):
            tn = torch.roll(theta, sgn, mu)
            hr = hr + torch.cos(tn)
            hi = hi + torch.sin(tn)
    return torch.hypot(hr, hi), torch.atan2(hi, hr)


def _parity_mask(shape, device=None) -> torch.Tensor:
    """(sum_mu x_mu) % 2 per site, an int64 field of ``shape``."""
    s = torch.zeros((), dtype=torch.int64, device=device)
    for mu, n in enumerate(shape):
        sh = [1] * len(shape)
        sh[mu] = n
        s = s + torch.arange(n, device=device).reshape(sh)
    return torch.broadcast_to(s % 2, tuple(shape))


# --- von Mises sampling -------------------------------------------------------

class VonMisesDraws(NamedTuple):
    """Draws of the Best-Fisher sampler for a stack of ``n`` fields:
    ``theta0`` (n, *shape) uniform on [-pi, pi), the start a site keeps
    when kappa < 1e-6 or no proposal is accepted, and ``u``
    (n, VM_ITERS, 3, *shape) uniforms on [0, 1): per proposal, the
    angle, the acceptance and the sign draw."""

    theta0: torch.Tensor
    u: torch.Tensor


def sample_von_mises_from(kappa: torch.Tensor, theta0: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
    """Best-Fisher (1979) von Mises(0, kappa) sample per site from given
    draws (``u`` of shape (n_iter, 3, *kappa.shape)): each site takes its
    first accepted proposal, or keeps ``theta0`` when kappa < 1e-6 or
    none of the n_iter proposals is accepted."""
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa + 1e-30)
    r = (1.0 + rho * rho) / (2.0 * rho + 1e-30)
    u1, u2, u3 = u[:, 0], u[:, 1], u[:, 2]
    z = torch.cos(math.pi * u1)
    f = (1.0 + r * z) / (r + z)
    c = kappa * (r - f)
    accept = ((c * (2.0 - c) - u2 > 0)
              | (torch.log(c / (u2 + 1e-30)) + 1.0 - c >= 0))
    accept = accept & ~(kappa < 1e-6)
    new = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
    first = accept.to(torch.uint8).argmax(0, keepdim=True)
    picked = new.gather(0, first)[0]
    return torch.where(accept.any(0), picked, theta0)


def draw_von_mises(gen: torch.Generator, n: int, shape, dtype
                   ) -> VonMisesDraws:
    """``n`` fields' worth of von Mises draws of ``shape`` on ``gen``'s
    device."""
    dev = gen.device
    theta0 = (2.0 * torch.rand((n,) + tuple(shape), generator=gen,
                               dtype=dtype, device=dev) - 1.0) * math.pi
    u = torch.rand((n, VM_ITERS, 3) + tuple(shape), generator=gen,
                   dtype=dtype, device=dev)
    return VonMisesDraws(theta0, u)


# --- heatbath and Metropolis --------------------------------------------------

def heatbath_sweep_from(theta: torch.Tensor, beta: float,
                        draws: VonMisesDraws) -> torch.Tensor:
    """One even then odd checkerboard heatbath sweep (xy_heatbath_mc
    parity) from the draws of :func:`draw_heatbath` (n = 2: one per
    parity)."""
    par = _parity_mask(theta.shape, theta.device)
    for p in (0, 1):
        hmag, hang = _local_field(theta)
        sample = sample_von_mises_from(beta * hmag, draws.theta0[p],
                                       draws.u[p])
        theta = torch.where(par == p, hang + sample, theta)
    return theta


def draw_heatbath(gen: torch.Generator, theta: torch.Tensor
                  ) -> VonMisesDraws:
    return draw_von_mises(gen, 2, theta.shape, theta.dtype)


def heatbath_sweep(gen: torch.Generator, theta: torch.Tensor, beta: float
                   ) -> torch.Tensor:
    return heatbath_sweep_from(theta, beta, draw_heatbath(gen, theta))


def metropolis_sweep_from(theta: torch.Tensor, beta: float, delta: float,
                          prop: torch.Tensor, acc_u: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Checkerboard Metropolis sweep from given draws: ``prop`` (2,
    *shape) uniforms on [-1, 1) (proposal theta + delta prop) and
    ``acc_u`` (2, *shape) uniforms on [0, 1), one of each per parity.
    Returns (theta, acceptance rate as a float64 scalar)."""
    par = _parity_mask(theta.shape, theta.device)
    acc_tot = 0.0
    for p in (0, 1):
        new = theta + delta * prop[p]
        hmag, hang = _local_field(theta)
        de = -beta * hmag * (torch.cos(new - hang) - torch.cos(theta - hang))
        acc = acc_u[p] < torch.exp(-de)
        theta = torch.where(acc & (par == p), new, theta)
        acc_tot = acc_tot + 2.0 * (acc & (par == p)).to(torch.float64).mean()
    return theta, acc_tot / 2


def draw_metropolis(gen: torch.Generator, theta: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (2,) + tuple(theta.shape)
    kw = dict(generator=gen, dtype=theta.dtype, device=gen.device)
    return 2.0 * torch.rand(shape, **kw) - 1.0, torch.rand(shape, **kw)


def metropolis_sweep(gen: torch.Generator, theta: torch.Tensor, beta: float,
                     delta: float = 1.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    return metropolis_sweep_from(theta, beta, delta,
                                 *draw_metropolis(gen, theta))


# --- Wolff cluster ------------------------------------------------------------

def frozen_bonds(s: torch.Tensor, beta: float, bond_u: torch.Tensor
                 ) -> torch.Tensor:
    """(nd, *shape) bool: bond (x, x+mu) frozen with probability
    1 - exp(min(0, -2 beta s(x) s(x+mu))), decided by ``bond_u``."""
    return torch.stack([
        bond_u[mu] < 1.0 - torch.exp(torch.clamp(
            -2.0 * beta * s * torch.roll(s, -1, mu), max=0.0))
        for mu in range(s.dim())])


def _line_fill(mask: torch.Tensor, bond: torch.Tensor, mu: int
               ) -> torch.Tensor:
    """Fill every straight run of frozen bonds along axis ``mu`` that
    holds a cluster site (the periodic bond left to the single step)."""
    n = mask.shape[mu]
    m = mask.movedim(mu, -1).reshape(-1, n)
    b = bond.movedim(mu, -1).reshape(-1, n)
    start = torch.ones_like(m)
    start[:, 1:] = ~b[:, :-1]
    seg = torch.cumsum(start, 1) - 1
    seg = seg + n * torch.arange(m.shape[0], device=m.device)[:, None]
    hits = torch.zeros(m.numel(), dtype=torch.int32, device=m.device)
    hits.index_add_(0, seg.reshape(-1), m.reshape(-1).to(torch.int32))
    filled = (hits[seg] > 0).reshape(mask.movedim(mu, -1).shape)
    return filled.movedim(-1, mu)


def _propagate(mask: torch.Tensor, bonds: torch.Tensor) -> torch.Tensor:
    for mu in range(mask.dim()):
        b = bonds[mu]
        mask = _line_fill(mask, b, mu)
        mask = (mask | (torch.roll(mask, -1, mu) & b)
                | torch.roll(mask & b, 1, mu))
    return mask


def wolff_cluster(bonds: torch.Tensor, seed: int,
                  check_every: int = WOLFF_CHECK) -> tuple[torch.Tensor, int]:
    """(cluster mask, sweeps run): the connected component of the flat
    site index ``seed`` in the frozen-bond graph ``bonds``, testing for
    the fixed point every ``check_every`` sweeps."""
    shape = bonds.shape[1:]
    mask = torch.zeros(shape, dtype=torch.bool, device=bonds.device)
    mask.view(-1)[seed] = True
    sweeps = 0
    while True:
        for _ in range(check_every):
            prev = mask
            mask = _propagate(mask, bonds)
            sweeps += 1
        if not bool((mask != prev).any()):
            return mask, sweeps


def wolff_update_from(theta: torch.Tensor, beta: float, alpha: float,
                      seed: int, bond_u: torch.Tensor,
                      check_every: int = WOLFF_CHECK
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Wolff reflection (xy_cluster.nim:198-273) from given draws:
    the mirror angle ``alpha`` (theta -> 2 alpha + pi - theta), the seed
    site's flat index and ``bond_u`` (nd, *shape) uniforms.  Returns
    (theta, cluster fraction as a float64 scalar)."""
    s = torch.cos(theta - alpha)
    mask, _ = wolff_cluster(frozen_bonds(s, beta, bond_u), seed, check_every)
    theta = torch.where(mask, 2.0 * alpha + math.pi - theta, theta)
    return theta, mask.to(torch.float64).mean()


def draw_wolff(gen: torch.Generator, theta: torch.Tensor
               ) -> tuple[float, int, torch.Tensor]:
    """(alpha on [0, 2 pi), seed site index, bond uniforms)."""
    dev = gen.device
    alpha = 2.0 * math.pi * float(torch.rand(
        (), generator=gen, dtype=torch.float64, device=dev))
    seed = int(torch.randint(theta.numel(), (), generator=gen, device=dev))
    bond_u = torch.rand((theta.dim(),) + tuple(theta.shape), generator=gen,
                        dtype=theta.dtype, device=dev)
    return alpha, seed, bond_u


def wolff_update(gen: torch.Generator, theta: torch.Tensor, beta: float,
                 check_every: int = WOLFF_CHECK
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    alpha, seed, bond_u = draw_wolff(gen, theta)
    return wolff_update_from(theta, beta, alpha, seed, bond_u, check_every)


# --- spin gradient flow -------------------------------------------------------

def _grad_h(th: torch.Tensor) -> torch.Tensor:
    g = 0.0
    for mu in range(th.dim()):
        g = g + torch.sin(th - torch.roll(th, -1, mu)) \
            + torch.sin(th - torch.roll(th, 1, mu))
    return g


def spin_flow(theta: torch.Tensor, eps: float, steps: int) -> torch.Tensor:
    """U(1) gradient flow of the spins, dtheta/dt = -dH/dtheta at unit
    coupling, ``steps`` RK4 steps of ``eps``."""
    for _ in range(steps):
        k1 = -_grad_h(theta)
        k2 = -_grad_h(theta + 0.5 * eps * k1)
        k3 = -_grad_h(theta + 0.5 * eps * k2)
        k4 = -_grad_h(theta + eps * k3)
        theta = theta + (eps / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return theta
