"""Nambu-bracket HMC for pure gauge theory with two adjoint momenta
(port of ``qex_tpu.hmc.nambu``; QEX src/nhmc/puregaugenhmc.nim).

    H  = 1/4 |pi|^2 + 1/4 |qi|^2 + S_target(U)      (accept/reject)
    H' = 1/4 |qi|^2 + S_guide(U)                     (auxiliary)

    Udot = expand(pi * qi) U,  pidot = -(F_target - F_guide)_a qi_a,
    qidot = -(F_guide)_a pi_a,

integrated as U(1/2) [P(1/2) Q(1) P(1/2) U(1)]^n with the last U step
halved.  Guide forces come from autograd through the guide action
(``gauge.action.force_from_action``).  The link update takes its
exponential in complex128 and rounds the product to the links' type
(``ops.linalg.expm_mul``), as every MD link update of the port does.
Energies are float64.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..gauge.action import force_from_action
from ..ops import group, linalg
from . import hmc as _hmc


def su_generators(nc: int = 3) -> np.ndarray:
    """Antihermitian su(nc) basis T_a with tr(T_a T_b) = -delta_ab/2
    (i/2 x Gell-Mann for nc=3)."""
    gens = []
    for i in range(nc):
        for j in range(i + 1, nc):
            m = np.zeros((nc, nc), complex)
            m[i, j] = m[j, i] = 1.0
            gens.append(m)
            m = np.zeros((nc, nc), complex)
            m[i, j] = -1j
            m[j, i] = 1j
            gens.append(m)
    for k in range(1, nc):
        m = np.zeros((nc, nc), complex)
        for i in range(k):
            m[i, i] = 1.0
        m[k, k] = -k
        m *= np.sqrt(2.0 / (k * (k + 1)))
        gens.append(m)
    return 0.5j * np.stack(gens)


def generators(nc: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """:func:`su_generators` as a tensor of ``dtype`` on ``device``."""
    return torch.from_numpy(su_generators(nc)).to(device=device, dtype=dtype)


def project_ta(f: torch.Tensor, gens: torch.Tensor) -> torch.Tensor:
    """TAH matrix field (nd, nc, nc, *dims) -> real adjoint components
    (nd, dA, *dims): v_a = -2 Re tr(T_a f)."""
    return -2.0 * torch.einsum("aij,dji...->da...", gens, f).real


def expand_ta(v: torch.Tensor, gens: torch.Tensor) -> torch.Tensor:
    """Adjoint components -> TAH matrix field sum_a v_a T_a."""
    return torch.einsum("da...,aij->dij...", v.to(gens.dtype), gens)


@dataclasses.dataclass(frozen=True)
class NambuSystem:
    target_action: Callable
    guide_action: Callable
    gens: torch.Tensor
    # optional explicit forces (hand staples); default autograd through
    # the action callables
    target_force: Callable | None = None
    guide_force: Callable | None = None

    def forces(self, u):
        ft = (self.target_force(u) if self.target_force is not None
              else force_from_action(self.target_action, u))
        fg = (self.guide_force(u) if self.guide_force is not None
              else force_from_action(self.guide_action, u))
        return (project_ta(ft - fg, self.gens),
                project_ta(fg, self.gens))


def _update_u(sys: NambuSystem, u, pi, qi, eps):
    z = eps * expand_ta(pi * qi, sys.gens)
    return torch.stack([linalg.expm_mul(z[mu], u[mu])
                        for mu in range(u.shape[0])])


def nambu_trajectory(sys: NambuSystem, u, pi, qi, tau: float, nsteps: int):
    """U(1/2) [P(1/2) Q(1) P(1/2) U(1)]^n with U half-steps at both ends
    (puregaugenhmc.nim main loop)."""
    dt = tau / nsteps
    for i in range(nsteps):
        u = _update_u(sys, u, pi, qi, 0.5 * dt if i == 0 else dt)
        fdiff, fguide = sys.forces(u)
        pi = pi - (0.5 * dt) * fdiff * qi
        qi = qi - dt * fguide * pi
        pi = pi - (0.5 * dt) * fdiff * qi
    u = _update_u(sys, u, pi, qi, 0.5 * dt)
    return u, pi, qi


def kinetic(v: torch.Tensor) -> torch.Tensor:
    """1/4 |v|^2 in float64 (reference uiNorm2 and hamiltonian
    normalisation)."""
    return 0.25 * (v.to(torch.float64) ** 2).sum()


def draw_adjoint_momentum(gen: torch.Generator, u_shape, gens: torch.Tensor,
                          nd: int, dtype: torch.dtype) -> torch.Tensor:
    """randomTAH per direction, then projectTa (reference
    drawMomentum)."""
    nc = gens.shape[-1]
    p = torch.stack([group.random_tah(gen, tuple(u_shape), nc, dtype)
                     for _ in range(nd)])
    return project_ta(p, gens)


def metadynamics_bias(q: torch.Tensor, centers: torch.Tensor,
                      counts: torch.Tensor, amplitude: float, sdev: float
                      ) -> torch.Tensor:
    """Bias over the deposited topological-charge history
    (puregaugenhmc.nim NActTopoCloverStoutMeta):

        V(q) = sum_i counts_i A [exp(-(q-c_i)^2 / 2 s^2)
                                 + exp(-(q+c_i)^2 / 2 s^2)]."""
    d1 = q - centers
    d2 = q + centers
    g = (torch.exp(-0.5 * (d1 * d1) / (sdev * sdev))
         + torch.exp(-0.5 * (d2 * d2) / (sdev * sdev)))
    return amplitude * (counts * g).sum()


class MetaHistory:
    """Host-side deposited-charge histogram in ``max_slots`` fixed slots:
    a charge rounds to |q|, adds a count to the slot already holding that
    centre, else takes the first free slot, else is dropped."""

    def __init__(self, max_slots: int = 64):
        self.centers = np.zeros(max_slots, np.float32)
        self.counts = np.zeros(max_slots, np.float32)

    def deposit(self, q: float) -> None:
        c = float(abs(round(q)))
        occupied = np.where((self.counts > 0) & (self.centers == c))[0]
        if len(occupied):
            self.counts[occupied[0]] += 1
            return
        free = np.where(self.counts == 0)[0]
        if len(free):
            self.centers[free[0]] = c
            self.counts[free[0]] = 1

    def arrays(self, device=None, dtype: torch.dtype = torch.float64):
        """(centers, counts) as tensors of ``dtype`` on ``device``."""
        return (torch.from_numpy(self.centers).to(device=device, dtype=dtype),
                torch.from_numpy(self.counts).to(device=device, dtype=dtype))


def nambu_hmc_step_from(u, pi, qi, r: float, sys: NambuSystem, tau: float,
                        nsteps: int, always_accept: bool = False):
    """One Nambu-HMC trajectory from the momenta (pi, qi) and the
    Metropolis uniform ``r``; Metropolis on the target H.  Returns
    (u, dH, dG, accepted) with float dH, dG."""
    with torch.no_grad():
        h0 = float(kinetic(pi) + kinetic(qi) + sys.target_action(u))
        g0 = float(kinetic(qi) + sys.guide_action(u))
    u1, pi1, qi1 = nambu_trajectory(sys, u, pi, qi, tau, nsteps)
    with torch.no_grad():
        h1 = float(kinetic(pi1) + kinetic(qi1) + sys.target_action(u1))
        g1 = float(kinetic(qi1) + sys.guide_action(u1))
    dH, dG = h1 - h0, g1 - g0
    acc = bool(always_accept) or _hmc.metropolis(dH, r)
    return (u1 if acc else u), dH, dG, acc


def draw_nambu(gen: torch.Generator, u: torch.Tensor, gens: torch.Tensor):
    """(pi, qi, r) for :func:`nambu_hmc_step_from`."""
    nd = u.shape[0]
    pi = draw_adjoint_momentum(gen, u.shape[3:], gens, nd, u.dtype)
    qi = draw_adjoint_momentum(gen, u.shape[3:], gens, nd, u.dtype)
    return pi, qi, _hmc.draw_uniform(gen)


def nambu_hmc_step(gen: torch.Generator, u, sys: NambuSystem, tau: float,
                   nsteps: int, always_accept: bool = False):
    pi, qi, r = draw_nambu(gen, u, sys.gens)
    return nambu_hmc_step_from(u, pi, qi, r, sys, tau, nsteps, always_accept)
