"""Plaquette gauge action and its force (port of the plaquette part of
``qex_tpu.gauge.action``).

    S(U) = -(c.plaq / nc) * sum_{x, mu > nu} retr(P_{mu nu}(x))

Global sums accumulate in float64.  Only the plaquette coefficient is
ported: nonzero rect, pgm or adjplaq raise ``NotImplementedError``.

Complex-gradient convention.  JAX's gradient G of a real S satisfies
``dS = Re tr(G^T dU)``, and the MD force is
``F = -tah(U G^T) = -tah(mul_na(U, conj G))``.  torch's autograd
returns the conjugate, ``G_torch = conj(G_jax)``, so here
``F = -tah(mul_na(U, G_torch))``; :func:`force_from_grad` is the one
place that mapping lives.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..lattice import Lattice
from ..ops import group, linalg
from ..ops.shifts import transport


@dataclasses.dataclass(frozen=True)
class GaugeActionCoeffs:
    """Action coefficients (QEX ``GaugeActionCoeffs``)."""

    plaq: float = 0.0
    rect: float = 0.0
    pgm: float = 0.0
    adjplaq: float = 0.0


def wilson(beta: float) -> GaugeActionCoeffs:
    return GaugeActionCoeffs(plaq=beta)


def _plaq_only(c: GaugeActionCoeffs) -> None:
    if c.rect != 0.0 or c.pgm != 0.0 or c.adjplaq != 0.0:
        raise NotImplementedError(
            "only the plaquette gauge action is ported; rect, pgm and "
            "adjplaq terms wait for a later slice")


def gauge_action(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                 ) -> torch.Tensor:
    """Plaquette action as QEX ``gaugeAction2`` (redot of transports),
    a float64 scalar."""
    _plaq_only(c)
    nd, nc = lat.nd, lat.nc
    pl = 0.0
    for mu in range(1, nd):
        for nu in range(mu):
            a = transport(u[mu], u[nu], mu, +1, nd)
            b = transport(u[nu], u[mu], nu, +1, nd)
            pl = pl + linalg.redot(a, b, dtype=torch.float64)
    return (-1.0 / nc) * (c.plaq * pl)


def full_action(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                ) -> torch.Tensor:
    """Total gauge action (plaquette only in this port)."""
    return gauge_action(c, lat, u)


def _staple_sums(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                 ) -> list[torch.Tensor]:
    """Per-direction staple sums Sig_mu with c.plaq/nc folded in, such
    that F_mu = tah(U_mu Sig_mu)."""
    _plaq_only(c)
    nd, nc = lat.nd, lat.nc

    def sh(f, mu):
        return torch.roll(f, -1, f.dim() - nd + mu)

    su = [[sh(u[a], b) if a != b else None for b in range(nd)]
          for a in range(nd)]
    t = [[linalg.mul(u[a], su[b][a]) if a != b else None
          for b in range(nd)] for a in range(nd)]
    cp = c.plaq / nc
    sig = []
    for mu in range(nd):
        acc = None
        for nu in range(nd):
            if nu == mu:
                continue
            s1 = linalg.mul_na(su[nu][mu], t[nu][mu])
            inner = linalg.mul(linalg.adj(t[mu][nu]), u[nu])
            term = s1 + torch.roll(inner, 1, inner.dim() - nd + nu)
            acc = term if acc is None else acc + term
        sig.append(cp * acc)
    return sig


def gauge_force_hand(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                     ) -> torch.Tensor:
    """Hand staple force of the plaquette action (QEX gaugeForce)."""
    sig = _staple_sums(c, lat, u)
    return torch.stack([group.tah(linalg.mul(u[mu], sig[mu]))
                        for mu in range(lat.nd)])


def gauge_grad(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
               ) -> torch.Tensor:
    """torch-convention gradient of the gauge action from the hand
    staple sums, -Sig_mu^dag (the conjugate of JAX's ``gauge_grad``,
    -Sig_mu^T); the chain of a smeared gauge term."""
    if c.plaq == 0.0:
        _plaq_only(c)
        return torch.zeros_like(u)
    return torch.stack([-linalg.adj(s) for s in _staple_sums(c, lat, u)])


def force_from_grad(u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """MD force F (pdot = -F) from torch's autograd gradient ``g`` of a
    real action with respect to the links u: F = -tah(U g^dag) per link,
    which equals JAX's -tah(U G^T) with G = conj(g)."""
    return -torch.stack([group.tah(linalg.mul_na(u[mu], g[mu]))
                         for mu in range(u.shape[0])])


def force_from_action(action_fn: Callable[[torch.Tensor], torch.Tensor],
                      u: torch.Tensor) -> torch.Tensor:
    """MD force field F with pdot = -F, from any real action S(u)."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(action_fn(uu), uu)
    return force_from_grad(u.detach(), g)


def gauge_force(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                ) -> torch.Tensor:
    """Force of the gauge action: hand staple sums for the plaquette."""
    if c.plaq == 0.0:
        _plaq_only(c)
        return torch.zeros_like(u)
    return gauge_force_hand(c, lat, u)
