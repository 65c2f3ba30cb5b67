"""HMC trajectories: momentum refresh, MD, Metropolis (port of
``qex_tpu.hmc.hmc``: ``HMCState``, ``gauge_update_u``,
``kinetic_energy``, ``hmc_step``, ``hmc_step_guided`` and
``check_reverse``).

``hmc_step(gen, u, ...)`` draws the momenta and the Metropolis uniform
from one ``torch.Generator``.  The pieces are public so a caller can
inject its own draws: ``draw_momenta(gen, u)``, then
``hmc_step_from(u, p, r, ...)`` (integration, H and ``metropolis``).
H and dH are float64 sums.

On a rank mesh's blocks (``parallel.mesh.use_mesh``) u and p are this
rank's blocks: the momenta are drawn whole on every rank from the same
generator and cut (a transient whole field, about 0.6 GB of complex64
momenta at 32^3x64), the sums are float64 all-reduces, and the
Metropolis uniform is drawn on every rank, so every rank takes the same
decision; ``gauge_update_u`` is site-local.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..ops import group, linalg
from ..parallel import mesh
from ..parallel.halo import psum
from .integrators import Integrator, integrate


class HMCState(NamedTuple):
    """Per-trajectory diagnostics; energies are float64 host values."""

    accepted: bool
    dH: float            # H_new - H_old
    h_old: float
    h_new: float


def gauge_update_u(u: torch.Tensor, p: torch.Tensor, eps: float
                   ) -> torch.Tensor:
    """U <- exp(eps p) U per link, the exponential in complex128
    (``linalg.expm_mul``).  With a complex64 exponential, complex64 MD
    drifts from complex128 MD (the JAX package's float32 drift, ROADMAP
    C1): 1.6e-2 in dH against 3.2e-5 at 4^4, Wilson beta 6, 2MN, 48
    steps (tests/test_torch_puregauge.py)."""
    return torch.stack([linalg.expm_mul(eps * p[mu], u[mu])
                        for mu in range(u.shape[0])])


def kinetic_energy(p: torch.Tensor) -> torch.Tensor:
    """K = -1/2 sum_mu retr(p^2) = 1/2 |p|^2, accumulated in float64."""
    return 0.5 * psum(linalg.norm2(p, dtype=torch.float64))


def draw_momenta(gen: torch.Generator, u: torch.Tensor) -> torch.Tensor:
    """Gaussian TAH momenta, one field per direction, on ``gen``'s
    device (under an active mesh this rank's block of the whole draw)."""
    nd, nc = u.shape[0], u.shape[1]
    lm = mesh.active()
    dims = u.shape[3:] if lm is None else tuple(lm.lat.dims)
    return mesh.cut(torch.stack([group.random_tah(gen, dims, nc, u.dtype)
                                 for _ in range(nd)]))


def draw_uniform(gen: torch.Generator) -> float:
    """The Metropolis uniform r in [0, 1)."""
    return float(torch.rand((), generator=gen, dtype=torch.float64,
                            device=gen.device))


def metropolis(dH: float, r: float) -> bool:
    """Accept when log(r) < -dH for a uniform r in [0, 1), written as
    r < exp(-dH) so r = 0 and large |dH| need no special care; a NaN dH
    rejects."""
    return dH <= 0.0 or r < math.exp(-dH)


def _h(action_fn, u, p) -> float:
    with torch.no_grad():
        return float(kinetic_energy(p) + action_fn(u).to(torch.float64))


def hmc_step_from(u: torch.Tensor, p: torch.Tensor, r: float,
                  action_fn: Callable[[torch.Tensor], torch.Tensor],
                  force_fn: Callable[[torch.Tensor], torch.Tensor],
                  scheme: Integrator, tau: float, nsteps: int,
                  always_accept: bool = False,
                  ) -> tuple[torch.Tensor, HMCState]:
    """The trajectory from given momenta ``p`` and uniform ``r``:
    integrate, H before and after, Metropolis unless
    ``always_accept``."""
    h_old = _h(action_fn, u, p)
    u_new, p_new = integrate(scheme, u, p, tau, nsteps, force_fn,
                             gauge_update_u)
    h_new = _h(action_fn, u_new, p_new)
    dH = h_new - h_old
    acc = bool(always_accept) or metropolis(dH, r)
    return (u_new if acc else u), HMCState(accepted=acc, dH=dH,
                                           h_old=h_old, h_new=h_new)


def hmc_step(gen: torch.Generator, u: torch.Tensor,
             action_fn: Callable[[torch.Tensor], torch.Tensor],
             force_fn: Callable[[torch.Tensor], torch.Tensor],
             scheme: Integrator, tau: float, nsteps: int,
             always_accept: bool = False,
             ) -> tuple[torch.Tensor, HMCState]:
    """One HMC trajectory: refresh p, integrate, Metropolis.
    ``always_accept`` disables the accept test (the warm-up of QEX's
    ``no_metropolis_until``).  ``gen`` lives on u's device."""
    p = draw_momenta(gen, u)
    r = draw_uniform(gen)
    return hmc_step_from(u, p, r, action_fn, force_fn, scheme, tau,
                         nsteps, always_accept)


def hmc_step_guided(gen: torch.Generator, u: torch.Tensor,
                    target_action_fn: Callable[[torch.Tensor],
                                               torch.Tensor],
                    guide_force_fn: Callable[[torch.Tensor], torch.Tensor],
                    scheme: Integrator, tau: float, nsteps: int,
                    always_accept: bool = False,
                    ) -> tuple[torch.Tensor, HMCState]:
    """HMC with a guide force driving the MD and the target action in
    the Metropolis test (surrogate-force HMC): valid for any guide, since
    the integrator stays reversible and volume-preserving, but useful
    only where S_guide - S_target is nearly constant along
    trajectories.  It is ``hmc_step`` with the guide's force."""
    return hmc_step(gen, u, target_action_fn, guide_force_fn, scheme, tau,
                    nsteps, always_accept)


def check_reverse(u: torch.Tensor, p: torch.Tensor,
                  action_fn: Callable[[torch.Tensor], torch.Tensor],
                  force_fn: Callable[[torch.Tensor], torch.Tensor],
                  scheme: Integrator, tau: float, nsteps: int) -> dict:
    """Reversibility (QEX ``checkReverse``): integrate, flip p, integrate
    back; dH forward and back and the relative squared deviations of the
    returned fields, as floats."""
    h0 = _h(action_fn, u, p)
    u1, p1 = integrate(scheme, u, p, tau, nsteps, force_fn, gauge_update_u)
    h1 = _h(action_fn, u1, p1)
    u2, p2 = integrate(scheme, u1, -p1, tau, nsteps, force_fn,
                       gauge_update_u)
    h2 = _h(action_fn, u2, p2)
    def n2(x, dtype):
        return psum(linalg.norm2(x, dtype))
    return {"dH_fwd": h1 - h0, "dH_rev": h2 - h0,
            "u_dev2": float(n2(u2 - u, torch.float64)
                            / n2(u, torch.float64)),
            "p_dev2": float(n2(p2 + p, torch.float64)
                            / n2(p, torch.float64))}
