"""Differentiable link smearing: nHYP and stout (port of
``qex_tpu.gauge.smear``).

Smearing is an ordinary differentiable function of the gauge field; HMC
forces come from autograd through ``action(smear(u))``, with the polar
projection's closed-form backward (:func:`..ops.linalg.project_u`).

nHYP levels, QEX hypsmear.nim conventions (alpha1 is the innermost
level; the usual choice is (0.4, 0.5, 0.5)):

    L1[mu][nu] = P((1-a1) U[mu] + (a1/2) SS_nu(U, U[mu]))
    L2[mu][nu] = P((1-a2) U[mu] + (a2/4) sum_{a,b comp} SS_a(L1[a][b], L1[mu][b]))
    V[mu]      = P((1-a3) U[mu] + (a3/6) sum_{nu!=mu} SS_nu(L2[nu][mu], L2[mu][nu]))

SS_nu(A, B) is the symmetric staple of the direction-mu field B with
side links A, and P the polar projection onto U(3).  The level outputs
are tuples of link fields (indexed like the JAX stacks), so no level is
copied into a stacked array.  The JAX package's slab and pre-projection
pieces are not ported: they exist for the TPU's memory and compiler.

Gradient convention: torch's gradient of a real action is the conjugate
of JAX's (see :mod:`.action`); :func:`smeared_force` takes and returns
torch-convention gradients.
"""

from __future__ import annotations

import dataclasses

import torch

from ..lattice import Lattice
from ..ops import group, linalg
from ..ops.shifts import shift


def sym_staple(side: torch.Tensor, mid: torch.Tensor, nu: int, mu: int,
               nd: int) -> torch.Tensor:
    """Symmetric staple of ``mid`` (direction mu) with side links ``side``
    (direction nu):

        S(x) = side(x) mid(x+nu) side(x+mu)^dag
             + side(x-nu)^dag mid(x-nu) side(x-nu+mu)
    """
    s1 = shift(side, mu, +1, nd)
    s2 = shift(mid, nu, +1, nd)
    fwd = linalg.mul_na(linalg.mul(side, s2), s1)
    t = linalg.mul(linalg.mul_an(side, mid), s1)
    return fwd + shift(t, nu, -1, nd)


@dataclasses.dataclass(frozen=True)
class HypCoefs:
    """nHYP coefficients; alpha1 is the innermost level."""

    alpha1: float = 0.4
    alpha2: float = 0.5
    alpha3: float = 0.5


_HYP_PAIRS = [(mu, nu) for mu in range(4) for nu in range(4) if nu != mu]
_HYP_IDX = {p: i for i, p in enumerate(_HYP_PAIRS)}


def nhyp_stages(c: HypCoefs, lat: Lattice, proj_iters: int = 14):
    """The three nHYP levels, ``v = s3(u, s2(u, s1(u)))``; s1 and s2
    return 12 link fields in ``_HYP_PAIRS`` order, s3 the (4, 3, 3, ...)
    smeared field."""
    nd = lat.nd
    if nd != 4:
        raise ValueError("nHYP smearing requires nd=4")

    def proj(x):
        return linalg.project_u(x, iters=proj_iters)

    def s1(u):
        return tuple(
            proj((1.0 - c.alpha1) * u[mu]
                 + 0.5 * c.alpha1 * sym_staple(u[nu], u[mu], nu, mu, nd))
            for mu, nu in _HYP_PAIRS)

    def s2(u, l1):
        out = []
        for mu, nu in _HYP_PAIRS:
            comp = [d for d in range(nd) if d not in (mu, nu)]
            acc = (1.0 - c.alpha2) * u[mu]
            for a in comp:
                b = comp[0] if comp[1] == a else comp[1]
                acc = acc + 0.25 * c.alpha2 * sym_staple(
                    l1[_HYP_IDX[(a, b)]], l1[_HYP_IDX[(mu, b)]], a, mu, nd)
            out.append(proj(acc))
        return tuple(out)

    def s3(u, l2):
        out = []
        for mu in range(nd):
            acc = (1.0 - c.alpha3) * u[mu]
            for nu in range(nd):
                if nu != mu:
                    acc = acc + (c.alpha3 / 6.0) * sym_staple(
                        l2[_HYP_IDX[(nu, mu)]], l2[_HYP_IDX[(mu, nu)]],
                        nu, mu, nd)
            out.append(proj(acc))
        return torch.stack(out)

    return s1, s2, s3


def nhyp_smear(c: HypCoefs, lat: Lattice, u: torch.Tensor,
               proj_iters: int = 14) -> torch.Tensor:
    """Three-level nHYP smearing; differentiable, same shape as ``u``."""
    s1, s2, s3 = nhyp_stages(c, lat, proj_iters)
    return s3(u, s2(u, s1(u)))


def smeared_force(c: HypCoefs, lat: Lattice, u: torch.Tensor,
                  chain: torch.Tensor) -> torch.Tensor:
    """Pull a chain dS/dV back through the smearing to dS/dU (both in
    torch's gradient convention): one forward with grad, one backward."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(nhyp_smear(c, lat, uu), uu,
                                   grad_outputs=chain)
    return g


# --- stout ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StoutCoefs:
    """Isotropic stout parameter rho."""

    rho: float = 0.1


def _stout_z(c: StoutCoefs, lat: Lattice, u: torch.Tensor):
    """Z_mu = projTAH(rho C_mu U_mu^dag), C_mu the sum of staples."""
    nd = lat.nd
    zs = []
    for mu in range(nd):
        cmu = 0.0
        for nu in range(nd):
            if nu != mu:
                cmu = cmu + sym_staple(u[nu], u[mu], nu, mu, nd)
        zs.append(group.tah(linalg.mul_na(c.rho * cmu, u[mu])))
    return zs


def stout_smear(c: StoutCoefs, lat: Lattice, u: torch.Tensor
                ) -> torch.Tensor:
    """One stout step U' = exp(Z(U)) U (Morningstar & Peardon)."""
    return torch.stack([linalg.mul(linalg.expm(z), u[mu])
                        for mu, z in enumerate(_stout_z(c, lat, u))])


def stout_smear_inv(c: StoutCoefs, lat: Lattice, v: torch.Tensor,
                    iters: int = 40) -> torch.Tensor:
    """Inverse of one stout step by the fixed point
    U_{k+1} = exp(-Z(U_k)) V, U_0 = V."""
    u = v
    for _ in range(iters):
        u = torch.stack([linalg.mul(linalg.expm(-z), v[mu])
                         for mu, z in enumerate(_stout_z(c, lat, u))])
    return u
