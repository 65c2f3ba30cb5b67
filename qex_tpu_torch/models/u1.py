"""Compact U(1) pure gauge theory in the angle representation: HMC,
von Mises heatbath with over-relaxation, maximal-tree gauge fixing and
the gradient flow, in any dimension (port of ``qex_tpu.models.u1``).

The field is the real array ``theta[mu, x...]``; the group is additive,
so the HMC update is theta += dt p and the force is the analytic
gradient of the real action.  Conventions:

  S(theta) = beta * sum_{x, mu<nu} (1 - cos F_munu(x)),
  F_munu(x) = theta_mu(x) + theta_nu(x+mu) - theta_mu(x+nu) - theta_nu(x),
  Q = sum_x wrap(F_01(x)) / 2pi   (2D; exactly integer on the torus).

The action, the plaquette and the charge are float64 sums: the charge
forms F in float64 from the (possibly float32) angles, so the telescoping
sum stays integer to rounding however far HMC moves the angles.  Each
stochastic update is a core that takes its draws as tensors (``*_from``)
and a wrapper that draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..hmc import hmc as _hmc
from ..hmc.integrators import get_integrator
from .xy import (VonMisesDraws, _parity_mask, draw_von_mises,
                 sample_von_mises_from)


def _roll(f: torch.Tensor, mu: int, dist: int) -> torch.Tensor:
    """f(x + dist*mu_hat) of a single component (no leading axis)."""
    return torch.roll(f, -dist, mu)


def plaq_angle(theta: torch.Tensor, mu: int, nu: int) -> torch.Tensor:
    """F_munu(x) = theta_mu(x) + theta_nu(x+mu) - theta_mu(x+nu)
    - theta_nu(x)."""
    return (theta[mu] + _roll(theta[nu], mu, 1)
            - _roll(theta[mu], nu, 1) - theta[nu])


def _planes(nd: int):
    return [(mu, nu) for nu in range(nd) for mu in range(nu)]


def action(theta: torch.Tensor, beta: float) -> torch.Tensor:
    """Wilson action beta * sum (1 - cos F) over all planes (float64)."""
    th = theta.to(torch.float64)
    s = 0.0
    for mu, nu in _planes(th.shape[0]):
        s = s + (1.0 - torch.cos(plaq_angle(th, mu, nu))).sum()
    return beta * s


def plaquette(theta: torch.Tensor) -> torch.Tensor:
    """Mean of exp(i F) over planes and sites (complex128)."""
    th = theta.to(torch.float64)
    re = im = 0.0
    n = 0
    for mu, nu in _planes(th.shape[0]):
        f = plaq_angle(th, mu, nu)
        re = re + torch.cos(f).sum()
        im = im + torch.sin(f).sum()
        n += f.numel()
    return torch.complex(re, im) / n


def topo_charge(theta: torch.Tensor) -> torch.Tensor:
    """Q = sum_planes sum_x wrap(F) / 2pi, wrap(F) = atan2(sin F, cos F)
    (topo2DU1, puregauge2du1.nim:33-57), float64."""
    th = theta.to(torch.float64)
    q = 0.0
    for mu, nu in _planes(th.shape[0]):
        f = plaq_angle(th, mu, nu)
        q = q + torch.atan2(torch.sin(f), torch.cos(f)).sum()
    return q / (2.0 * math.pi)


def _plane_gradient(theta: torch.Tensor, per_plane) -> torch.Tensor:
    """sum_{nu != mu} [G_munu(x) - G_munu(x - nu)] for each mu, from
    G_munu = per_plane(mu, nu) on the planes mu < nu (G_numu = -G_munu)."""
    nd = theta.shape[0]
    g = {}
    for mu, nu in _planes(nd):
        x = per_plane(mu, nu)
        g[mu, nu], g[nu, mu] = x, -x
    out = []
    for mu in range(nd):
        acc = torch.zeros_like(theta[mu])
        for nu in range(nd):
            if nu != mu:
                acc = acc + g[mu, nu] - _roll(g[mu, nu], nu, -1)
        out.append(acc)
    return torch.stack(out)


def force(theta: torch.Tensor, beta: float) -> torch.Tensor:
    """dS/dtheta, analytically: for each mu,
    beta sum_{nu != mu} [sin F_munu(x) - sin F_munu(x - nu)]
    (F_numu = -F_munu), in theta's dtype."""
    return beta * _plane_gradient(
        theta, lambda mu, nu: torch.sin(plaq_angle(theta, mu, nu)))


def hessian_vp(theta: torch.Tensor, v: torch.Tensor, beta: float
               ) -> torch.Tensor:
    """The derivative of :func:`force` along v (a Hessian-vector product
    of the action): sin F -> cos F * F(v), F being linear in theta."""
    return beta * _plane_gradient(
        theta, lambda mu, nu: (torch.cos(plaq_angle(theta, mu, nu))
                               * plaq_angle(v, mu, nu)))


# --- maximal-tree gauge fixing -------------------------------------------------

def max_tree_mask(shape: Sequence[int], device=None) -> torch.Tensor:
    """Bool mask (nd, *shape) of the maximal-tree links (maxTreeFix,
    puregauge2du1.nim:58-69): link (x, mu) is on the tree iff
    x_mu < L_mu - 1 and x_nu == 0 for all nu > mu."""
    nd = len(shape)
    masks = []
    for mu in range(nd):
        m = torch.ones((1,) * nd, dtype=torch.bool, device=device)
        for nu in range(mu, nd):
            sh = [1] * nd
            sh[nu] = shape[nu]
            co = torch.arange(shape[nu], device=device).reshape(sh)
            m = m & ((co < shape[nu] - 1) if nu == mu else (co == 0))
        masks.append(torch.broadcast_to(m, tuple(shape)))
    return torch.stack(masks)


def max_tree_fix(theta: torch.Tensor) -> torch.Tensor:
    """The gauge transform of theta that zeroes every maximal-tree link
    (QEX maxTreeFix, puregauge2du1.nim:58-69): theta_mu(x) -> theta_mu(x)
    + alpha(x) - alpha(x + mu), alpha built along the tree axis by axis
    by cumulative sums, alpha = 0 at the origin.  Plaquette angles are
    unchanged."""
    nd = theta.shape[0]
    dims = theta.shape[1:]
    alpha = torch.zeros(dims, dtype=theta.dtype, device=theta.device)
    for mu in range(nd):
        # alpha(x + mu) = alpha(x) + theta_mu(x) along the tree's mu links:
        # the axes after mu at 0, the axes before mu filled already
        idx = tuple(slice(None) if nu <= mu else slice(0, 1)
                    for nu in range(nd))
        line = theta[mu][idx].narrow(mu, 0, dims[mu] - 1)
        base = alpha[idx].narrow(mu, 0, 1)
        rest = base + torch.cumsum(line, mu)
        alpha[idx] = torch.cat([base, rest], mu)
    return torch.stack([theta[mu] + alpha - _roll(alpha, mu, 1)
                        for mu in range(nd)])


# --- HMC ---------------------------------------------------------------------

def _masked(g: torch.Tensor, tree: torch.Tensor | None) -> torch.Tensor:
    return g if tree is None else torch.where(tree, 0.0, g)


def hmc_step_from(theta: torch.Tensor, p: torch.Tensor, r: float,
                  beta: float, tau: float, steps: int, scheme: str = "2MN",
                  gfix: bool = False) -> tuple[torch.Tensor, dict]:
    """One HMC trajectory (puregauge2du1.nim main loop :215-276) from
    momenta ``p`` and the Metropolis uniform ``r``.

    T steps theta += dt p, V steps p -= dt dS/dtheta; a force-gradient
    step takes the exact Hessian-vector product of the action
    (:func:`hessian_vp`).  With ``gfix`` the maximal-tree
    links are frozen (momenta and forces masked).  Returns (theta',
    stats) with float stats dH, plaq, topo and bool accept."""
    sch = get_integrator(scheme)
    tree = max_tree_mask(theta.shape[1:], theta.device) if gfix else None
    dt = tau / steps
    p = _masked(p, tree)

    def grad_s(th):
        return _masked(force(th, beta), tree)

    def h(th, mom):
        return float(action(th, beta)
                     + 0.5 * (mom.to(torch.float64) ** 2).sum())

    h0 = h(theta, p)
    th, mom = theta, p
    for _rep in range(steps):
        for st in sch.steps:
            if st[0] == "T":
                th = th + (st[1] * dt) * mom
            elif st[0] == "V":
                if st[1] != 0.0:
                    mom = mom - (st[1] * dt) * grad_s(th)
            elif st[0] == "FG":
                c, xi = st[1], st[2]
                if c == 0.0:
                    continue
                # F_eff = grad S(theta - a grad S) to first order
                # (integrators.fg_force convention, a = 2 xi dt^2 / c)
                a = 2.0 * xi * dt * dt / c
                f0 = grad_s(th)
                hf = _masked(hessian_vp(th, f0, beta), tree)
                mom = mom - (c * dt) * (f0 - a * hf)
            else:  # pragma: no cover
                raise ValueError(f"bad step kind {st[0]}")
    dh = h(th, mom) - h0
    acc = _hmc.metropolis(dh, r)
    theta_new = th if acc else theta
    return theta_new, {"dH": dh, "accept": acc,
                       "plaq": float(plaquette(theta_new).real),
                       "topo": float(topo_charge(theta_new))}


def draw_hmc(gen: torch.Generator, theta: torch.Tensor
             ) -> tuple[torch.Tensor, float]:
    """Gaussian momenta shaped like theta and the Metropolis uniform."""
    p = torch.randn(theta.shape, generator=gen, dtype=theta.dtype,
                    device=gen.device)
    return p, _hmc.draw_uniform(gen)


def hmc_step(gen: torch.Generator, theta: torch.Tensor, beta: float,
             tau: float, steps: int, scheme: str = "2MN",
             gfix: bool = False) -> tuple[torch.Tensor, dict]:
    p, r = draw_hmc(gen, theta)
    return hmc_step_from(theta, p, r, beta, tau, steps, scheme, gfix)


# --- heatbath + over-relaxation ------------------------------------------------

def staple_sum(theta: torch.Tensor, mu: int) -> torch.Tensor:
    """Complex staple sum W_mu(x) such that the theta_mu(x)-dependent
    part of -S/beta is |W| cos(theta - arg W) (sumStaples,
    puregaugehb2du1.nim:5-17)."""
    nd = theta.shape[0]
    wr = torch.zeros_like(theta[mu])
    wi = torch.zeros_like(theta[mu])
    for nu in range(nd):
        if nu == mu:
            continue
        # upper staple: theta_nu(x+mu) - theta_mu(x+nu) - theta_nu(x)
        up = (_roll(theta[nu], mu, 1) - _roll(theta[mu], nu, 1) - theta[nu])
        # lower staple: -theta_nu(x+mu-nu) - theta_mu(x-nu) + theta_nu(x-nu)
        lo = (-_roll(_roll(theta[nu], mu, 1), nu, -1)
              - _roll(theta[mu], nu, -1) + _roll(theta[nu], nu, -1))
        wr = wr + torch.cos(up) + torch.cos(lo)
        wi = wi + torch.sin(up) + torch.sin(lo)
    # the staples accumulate exp(i(F - theta_mu(x))); W is their conjugate
    return torch.complex(wr, -wi)


def heatbath_sweep_from(theta: torch.Tensor, beta: float,
                        draws: VonMisesDraws, over_relax: int = 1
                        ) -> torch.Tensor:
    """One even/odd heatbath sweep and ``over_relax`` over-relaxation
    sweeps (puregaugehb2du1.nim evolve :43-103) from von Mises draws,
    one per (parity, direction), parity-major (``draw_heatbath``).

    theta_mu(x) | staples ~ vonMises(arg W, beta |W|) for a whole parity
    class of one direction at a time (their staples are disjoint)."""
    nd = theta.shape[0]
    par = _parity_mask(theta.shape[1:], theta.device)
    for p in (0, 1):
        for mu in range(nd):
            i = p * nd + mu
            w = staple_sum(theta, mu)
            smp = sample_von_mises_from(beta * w.abs(), draws.theta0[i],
                                        draws.u[i])
            new = torch.angle(w) + smp
            theta = theta.clone()
            theta[mu] = torch.where(par == p, new, theta[mu])
    for _ in range(over_relax):
        theta = over_relax_sweep(theta)
    return theta


def draw_heatbath(gen: torch.Generator, theta: torch.Tensor
                  ) -> VonMisesDraws:
    return draw_von_mises(gen, 2 * theta.shape[0], theta.shape[1:],
                          theta.dtype)


def heatbath_sweep(gen: torch.Generator, theta: torch.Tensor, beta: float,
                   over_relax: int = 1) -> torch.Tensor:
    return heatbath_sweep_from(theta, beta, draw_heatbath(gen, theta),
                               over_relax)


def over_relax_sweep(theta: torch.Tensor) -> torch.Tensor:
    """One microcanonical over-relaxation sweep, theta -> 2 arg W - theta
    per parity and direction (puregaugehb2du1.nim:77-103); preserves the
    action exactly."""
    nd = theta.shape[0]
    par = _parity_mask(theta.shape[1:], theta.device)
    for p in (0, 1):
        for mu in range(nd):
            new = 2.0 * torch.angle(staple_sum(theta, mu)) - theta[mu]
            theta = theta.clone()
            theta[mu] = torch.where(par == p, new, theta[mu])
    return theta


# --- gradient flow -------------------------------------------------------------

def gauge_flow(theta: torch.Tensor, eps: float, steps: int) -> torch.Tensor:
    """U(1) gradient flow dtheta/dt = -dS/dtheta at unit coupling,
    ``steps`` RK4 steps of ``eps``."""
    for _ in range(steps):
        k1 = -force(theta, 1.0)
        k2 = -force(theta + 0.5 * eps * k1, 1.0)
        k3 = -force(theta + 0.5 * eps * k2, 1.0)
        k4 = -force(theta + eps * k3, 1.0)
        theta = theta + (eps / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return theta


def random_field(gen: torch.Generator, shape: Sequence[int],
                 dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Random start: theta ~ U(-pi, pi) per link on ``gen``'s device."""
    return (2.0 * torch.rand(tuple(shape), generator=gen, dtype=dtype,
                             device=gen.device) - 1.0) * math.pi
