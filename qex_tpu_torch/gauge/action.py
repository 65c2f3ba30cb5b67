"""Gauge action family and its forces (port of ``qex_tpu.gauge.action``):
plaquette + rectangle + parallelogram (QEX ``gaugeAction2``) and the
adjoint-plaquette mix (QEX ``actionA``).

    S(U) = -(1/nc) [ c.plaq sum retr(P) + c.rect sum retr(R1) + retr(R2)
                     + c.pgm sum_{sg<nu<mu} sum_{8 orientations} retr(G) ]
    S_A(U) = c.plaq (a0 - sum retr(P)/nc)
             + c.adjplaq (a0 - sum |tr P|^2/nc^2),  a0 = nd(nd-1)/2 V

Global sums accumulate in float64 (on a rank mesh's blocks, a block
sum all-reduced: ``parallel.halo.psum``).  The forces of the plaquette and
adjoint-plaquette parts come from hand staple sums; the rect and pgm
remainder is differentiated by ``torch.func.grad``, so the whole force
also has a forward-mode derivative (the exact force-gradient kick).

Complex-gradient convention.  JAX's gradient G of a real S satisfies
``dS = Re tr(G^T dU)``, and the MD force is
``F = -tah(U G^T) = -tah(mul_na(U, conj G))``.  torch's autograd
returns the conjugate, ``G_torch = conj(G_jax)``, so here
``F = -tah(mul_na(U, G_torch))``; :func:`force_from_grad` is the one
place that mapping lives.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from ..lattice import Lattice
from ..ops import group, linalg
from ..ops.shifts import shift, transport
from ..parallel.halo import psum, site_sum

C1_SYMANZIK = -1.0 / 12.0  # tree-level Luscher-Weisz
C1_IWASAKI = -0.331
C1_DBW2 = -1.4088


@dataclasses.dataclass(frozen=True)
class GaugeActionCoeffs:
    """Action coefficients (QEX ``GaugeActionCoeffs``)."""

    plaq: float = 0.0
    rect: float = 0.0
    pgm: float = 0.0
    adjplaq: float = 0.0

    def __mul__(self, x: float) -> "GaugeActionCoeffs":
        return GaugeActionCoeffs(self.plaq * x, self.rect * x,
                                 self.pgm * x, self.adjplaq * x)

    __rmul__ = __mul__


def wilson(beta: float) -> GaugeActionCoeffs:
    return GaugeActionCoeffs(plaq=beta)


def gauge_act_rect(beta: float, c1: float = C1_SYMANZIK
                   ) -> GaugeActionCoeffs:
    """QEX ``gaugeActRect``: plaq (1 - 8 c1) beta, rect c1 beta."""
    return GaugeActionCoeffs(plaq=(1.0 - 8.0 * c1) * beta, rect=c1 * beta)


def symanzik(beta: float) -> GaugeActionCoeffs:
    return gauge_act_rect(beta, C1_SYMANZIK)


def iwasaki(beta: float) -> GaugeActionCoeffs:
    return gauge_act_rect(beta, C1_IWASAKI)


def dbw2(beta: float) -> GaugeActionCoeffs:
    return gauge_act_rect(beta, C1_DBW2)


def adjoint_action(beta: float, adj_ratio: float) -> GaugeActionCoeffs:
    """Fundamental + adjoint plaquette mix (the app decks' ``adjFac``)."""
    return GaugeActionCoeffs(plaq=beta, adjplaq=beta * adj_ratio)


# --- actions ---------------------------------------------------------------

def gauge_action(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                 ) -> torch.Tensor:
    """Plaq/rect/pgm action as QEX ``gaugeAction2`` (redot of
    transports), a float64 scalar."""
    nd, nc = lat.nd, lat.nc

    def T(mu):
        return lambda f: transport(u[mu], f, mu, +1, nd)

    def Td(mu):
        return lambda f: transport(u[mu], f, mu, -1, nd)

    def rd(a, b):
        return linalg.redot(a, b, dtype=torch.float64)

    T, Td = [T(mu) for mu in range(nd)], [Td(mu) for mu in range(nd)]
    pl = rt = pg = 0.0
    for mu in range(1, nd):
        for nu in range(mu):
            pl = pl + rd(T[mu](u[nu]), T[nu](u[mu]))
            if c.rect != 0.0:
                rt = rt + rd(T[mu](T[nu](u[nu])), T[nu](T[nu](u[mu])))
                rt = rt + rd(T[mu](T[mu](u[nu])), T[nu](T[mu](u[mu])))
            if c.pgm != 0.0:
                for sg in range(nu):
                    for a, b in (
                            (T[mu](T[nu](u[sg])), T[sg](T[nu](u[mu]))),
                            (T[mu](T[sg](u[nu])), T[nu](T[sg](u[mu]))),
                            (T[nu](T[mu](u[sg])), T[sg](T[mu](u[nu]))),
                            (T[nu](T[sg](u[mu])), T[mu](T[sg](u[nu]))),
                            (T[sg](T[mu](u[nu])), T[nu](T[mu](u[sg]))),
                            (T[sg](T[nu](u[mu])), T[mu](T[nu](u[sg]))),
                            (T[mu](Td[nu](u[sg])), T[sg](Td[nu](u[mu]))),
                            (T[mu](Td[sg](u[nu])), T[nu](Td[sg](u[mu])))):
                        pg = pg + rd(a, b)
    return psum((-1.0 / nc) * (c.plaq * pl + c.rect * rt + c.pgm * pg))


def action_a(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
             ) -> torch.Tensor:
    """Plaquette + adjoint-plaquette action as QEX ``actionA``, a
    float64 scalar."""
    nd, nc = lat.nd, lat.nc
    pl = ad = 0.0
    for mu in range(1, nd):
        for nu in range(mu):
            a = transport(u[mu], u[nu], mu, +1, nd)   # U_mu(x) U_nu(x+mu)
            b = transport(u[nu], u[mu], nu, +1, nd)   # U_nu(x) U_mu(x+nu)
            trp = linalg.trace(linalg.mul_an(a, b))   # tr P^dag per site
            pl = pl + site_sum(trp.real)
            ad = ad + site_sum(trp.real ** 2 + trp.imag ** 2)
    a0 = 0.5 * nd * (nd - 1) * lat.volume
    return (c.plaq * (a0 - pl / nc)
            + c.adjplaq * (a0 - ad / (nc * nc)))


def full_action(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                ) -> torch.Tensor:
    """``action_a`` when adjplaq is used (plus any rect/pgm part through
    ``gauge_action``), ``gauge_action`` otherwise."""
    if c.adjplaq != 0.0:
        s = action_a(GaugeActionCoeffs(plaq=c.plaq, adjplaq=c.adjplaq),
                     lat, u)
        if c.rect != 0.0 or c.pgm != 0.0:
            s = s + gauge_action(_ad_part(c), lat, u)
        return s
    return gauge_action(c, lat, u)


# --- hand staple force (plaq + adjplaq) ------------------------------------
#
# With P_munu(x) = U_mu(x) U_nu(x+mu) U_mu(x+nu)^+ U_nu(x)^+, the U_mu(y)
# insertions of Re tr P are the up staple S1 = U_nu(y+mu) U_mu(y+nu)^+
# U_nu(y)^+ and the down staple S2 = shift_-nu[U_nu(x+mu)^+ U_mu(x)^+
# U_nu(x)], so for S = -(c/nc) sum Re tr P the force is
# F_mu = (c/nc) tah(U_mu Sig_mu), Sig_mu = sum_nu (S1 + S2).  The
# adjoint term |tr P|^2 weights each staple by w = conj(tr P) at the
# plaquette's base before the (R-linear) tah.

def _staple_sums(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                 ) -> list[torch.Tensor]:
    """Per-direction weighted staple sums Sig_mu with the plaq and
    adjplaq coefficients folded in, such that F_mu = tah(U_mu Sig_mu)."""
    nd, nc = lat.nd, lat.nc

    def sh(f, mu):
        return shift(f, mu, +1, nd)

    su = [[sh(u[a], b) if a != b else None for b in range(nd)]
          for a in range(nd)]
    t = [[linalg.mul(u[a], su[b][a]) if a != b else None
          for b in range(nd)] for a in range(nd)]
    cp = c.plaq / nc
    ca = 2.0 * c.adjplaq / (nc * nc)
    sig = []
    for mu in range(nd):
        acc = None
        for nu in range(nd):
            if nu == mu:
                continue
            s1 = linalg.mul_na(su[nu][mu], t[nu][mu])
            inner = linalg.mul(linalg.adj(t[mu][nu]), u[nu])
            if ca != 0.0:
                # tr P_munu = tr(t1 t2^+); w = conj(tr P)
                w = (t[mu][nu] * t[nu][mu].conj()).sum((0, 1)).conj()
                s1 = cp * s1 + ca * (w * s1)
                inner = cp * inner + ca * (w.conj() * inner)
            term = s1 + shift(inner, nu, -1, nd)
            acc = term if acc is None else acc + term
        sig.append(acc if ca != 0.0 else cp * acc)
    return sig


def _hand_part(c: GaugeActionCoeffs) -> GaugeActionCoeffs:
    return GaugeActionCoeffs(plaq=c.plaq, adjplaq=c.adjplaq)


def _ad_part(c: GaugeActionCoeffs) -> GaugeActionCoeffs:
    return GaugeActionCoeffs(rect=c.rect, pgm=c.pgm)


def _has_hand(c: GaugeActionCoeffs) -> bool:
    return c.plaq != 0.0 or c.adjplaq != 0.0


def _has_ad(c: GaugeActionCoeffs) -> bool:
    return c.rect != 0.0 or c.pgm != 0.0


def gauge_force_hand(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                     ) -> torch.Tensor:
    """Hand staple force of the plaq + adjplaq part of ``c`` (QEX
    gaugeForce/forceA)."""
    sig = _staple_sums(c, lat, u)
    return torch.stack([group.tah(linalg.mul(u[mu], sig[mu]))
                        for mu in range(lat.nd)])


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


def force_and_derivative(action_fn: Callable[[torch.Tensor], torch.Tensor],
                         u: torch.Tensor, tangent_fn: Callable
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, dF[t]) for F = force_from_action(action_fn) and the tangent
    t = tangent_fn(F): the force and its exact derivative along t by a
    Hessian-vector product (a second backward through the recorded
    gradient).  F is R-bilinear in (U, G), so
    dF[t] = force_from_grad(t, G) + force_from_grad(U, H t)."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(action_fn(uu), uu, create_graph=True)
        f = force_from_grad(u.detach(), g.detach())
        t = tangent_fn(f)
        (h,) = torch.autograd.grad(linalg.redot(g, t), uu)
    return f, force_from_grad(t, g.detach()) + force_from_grad(u.detach(), h)


def gauge_force(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                ) -> torch.Tensor:
    """Force of the full gauge action: hand staple sums for the plaq and
    adjplaq parts, ``torch.func.grad`` for the rect and pgm remainder.
    Forward-mode differentiable throughout."""
    f = None
    if _has_hand(c):
        f = gauge_force_hand(c, lat, u)
    if _has_ad(c):
        fr = force_from_grad(
            u, torch.func.grad(partial(full_action, _ad_part(c), lat))(u))
        f = fr if f is None else f + fr
    return torch.zeros_like(u) if f is None else f


def gauge_grad(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
               ) -> torch.Tensor:
    """torch-convention gradient of the full gauge action (the conjugate
    of JAX's ``gauge_grad``), the chain of a smeared gauge term: -Sig^dag
    from the hand staples for plaq/adjplaq, ``torch.func.grad`` for
    rect/pgm."""
    g = None
    if _has_hand(c):
        g = torch.stack([-linalg.adj(s) for s in _staple_sums(c, lat, u)])
    if _has_ad(c):
        gr = torch.func.grad(partial(full_action, _ad_part(c), lat))(u)
        g = gr if g is None else g + gr
    return torch.zeros_like(u) if g is None else g
