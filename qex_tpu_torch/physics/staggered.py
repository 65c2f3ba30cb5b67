"""Staggered (Kogut-Susskind) Dirac operator, canonical eo layout (port
of ``qex_tpu.physics.staggered``: the plain 1-hop operator and the fat +
naik (HISQ) operator with its full-lattice oracle).

Staggered phases and boundary signs are folded into the links once
(:func:`phase_links`), so the stencil is phase-free:

    D(m) chi = m chi + Dslash chi,
    Dslash chi(x) = 1/2 sum_mu [ U_mu(x) chi(x+mu) - U_mu(x-mu)^dag chi(x-mu) ].

Dslash is anti-hermitian, so the even-odd normal operator
``A = m^2 - D_eo D_oe`` on even sites is hermitian positive definite.
This module is differentiable in the links; the fermion forces take
their gradients through it.

On a rank mesh's blocks (``parallel.mesh.use_mesh``) a ``Lattice``
argument is the global lattice: the phases and boundary signs come from
the block's global coordinates (the antiperiodic sign only on the ranks
that hold the global last plane), the operators' shifts exchange faces,
and an operator built on a block carries the block's lattice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve
from ..lattice import Lattice
from ..ops import eo, linalg
from ..ops.shifts import shift
from ..parallel import mesh


def _block(lat: Lattice) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(dims, global origin) of the sites this process holds of
    ``lat``: the active mesh's block, else the whole lattice."""
    lm = mesh.active()
    if lm is None or tuple(lat.dims) != tuple(lm.lat.dims):
        return tuple(lat.dims), (0,) * lat.nd
    return lm.local_dims, lm.origin


def _coord(lat: Lattice, mu: int, device) -> torch.Tensor:
    """Global coordinate along mu of the sites held (:func:`_block`),
    broadcastable over them."""
    dims, origin = _block(lat)
    shape = [1] * lat.nd
    shape[mu] = dims[mu]
    return torch.arange(origin[mu], origin[mu] + dims[mu],
                        device=device).reshape(shape)


def staggered_phases(lat: Lattice, dtype: torch.dtype = torch.float32,
                     device: torch.device | str | None = None
                     ) -> torch.Tensor:
    """eta_mu(x) field, shape (nd, *dims), values +-1:
    eta_0 = 1, eta_mu = (-1)^{x_0 + ... + x_{mu-1}}; on ``device``
    (default: the CUDA card; raises without one)."""
    device = resolve(device)
    phases = []
    csum = torch.zeros(_block(lat)[0], dtype=torch.int64, device=device)
    for mu in range(lat.nd):
        phases.append(1.0 - 2.0 * (csum % 2).to(dtype))
        csum = csum + _coord(lat, mu, device)
    return torch.stack(phases)


def bc_signs(lat: Lattice, bc: str = "pppa",
             dtype: torch.dtype = torch.float32,
             device: torch.device | str | None = None) -> torch.Tensor:
    """Boundary-condition sign field, shape (nd, *dims): 'p' periodic,
    'a' anti-periodic (links on the last slice of that direction pick
    up -1); on ``device`` (default: the CUDA card; raises without
    one)."""
    nd = lat.nd
    if len(bc) != nd:
        raise ValueError(f"bc string length {len(bc)} != nd {nd}")
    device = resolve(device)
    out = []
    for mu, c in enumerate(bc):
        f = torch.ones(_block(lat)[0], dtype=dtype, device=device)
        if c == "a":
            last = _coord(lat, mu, device) == lat.dims[mu] - 1
            f = torch.where(last, -f, f)
        elif c != "p":
            raise ValueError(f"bad bc char {c!r}")
        out.append(f)
    return torch.stack(out)


def phase_links(lat: Lattice, u: torch.Tensor, bc: str = "pppa"
                ) -> torch.Tensor:
    """Fold staggered phases and BC signs into the links."""
    rdtype = u.dtype.to_real()
    eta = (staggered_phases(lat, rdtype, u.device)
           * bc_signs(lat, bc, rdtype, u.device))
    return u * eta[:, None, None]


@dataclasses.dataclass(frozen=True)
class StaggeredEO:
    """Even-odd packed phased links: ``g_e[mu]`` holds U_mu(x) for even
    x, ``g_o[mu]`` for odd x, each (nd, nc, nc, *dims_h)."""

    lat: Lattice
    g_e: torch.Tensor
    g_o: torch.Tensor


def new_stag_eo(lat: Lattice, u: torch.Tensor, bc: str = "pppa"
                ) -> StaggeredEO:
    """Build the eo-packed operator from an (unphased) gauge field."""
    ge, go = eo.pack(phase_links(lat, u, bc), lat.nd)
    return StaggeredEO(mesh.block_lattice(lat), ge, go)


def dslash_eo(s: StaggeredEO, x_src: torch.Tensor, parity_out: int
              ) -> torch.Tensor:
    """Hopping term from parity ``1-parity_out`` onto ``parity_out``."""
    nd = s.lat.nd
    g_out = s.g_e if parity_out == 0 else s.g_o
    g_src = s.g_o if parity_out == 0 else s.g_e
    out = None
    for mu in range(nd):
        fwd = linalg.mv(g_out[mu], eo.shift_eo(x_src, mu, +1, parity_out,
                                               nd))
        bwd = eo.shift_eo(linalg.mv_an(g_src[mu], x_src), mu, -1,
                          parity_out, nd)
        term = fwd - bwd
        out = term if out is None else out + term
    return 0.5 * out


def d2ee(s: StaggeredEO, x_e: torch.Tensor, m: float) -> torch.Tensor:
    """Even-odd normal operator A x = (m^2 - D_eo D_oe) x on even sites."""
    t = dslash_eo(s, x_e, parity_out=1)
    y = dslash_eo(s, t, parity_out=0)
    return (m * m) * x_e - y


def d2dd(s: StaggeredEO, x: torch.Tensor, parity: int = 0) -> torch.Tensor:
    """Mass-free normal operator -D_po,ps D_ps,po x on ``parity``."""
    t = dslash_eo(s, x, parity_out=1 - parity)
    return -dslash_eo(s, t, parity_out=parity)


def reconstruct_odd(s: StaggeredEO, x_e: torch.Tensor, b_o: torch.Tensor,
                    m: float) -> torch.Tensor:
    """Odd part of the solution of D x = b: x_o = (b_o - D_oe x_e) / m."""
    return (b_o - dslash_eo(s, x_e, parity_out=1)) / m


@dataclasses.dataclass(frozen=True)
class Staggered3EO:
    """Even-odd packed fat + naik operator: fat (1-hop) links ``gf_*``
    and long (3-hop) links ``gl_*``, built from
    ``gauge.fat7.hisq_links`` of phased links (phases and boundary signs
    are folded in before fattening)."""

    lat: Lattice
    gf_e: torch.Tensor
    gf_o: torch.Tensor
    gl_e: torch.Tensor
    gl_o: torch.Tensor


def new_stag3_eo(lat: Lattice, fat: torch.Tensor, long: torch.Tensor
                 ) -> Staggered3EO:
    """Pack pre-phased fat and long links into the eo operator."""
    fe, fo = eo.pack(fat, lat.nd)
    le, lo = eo.pack(long, lat.nd)
    return Staggered3EO(mesh.block_lattice(lat), fe, fo, le, lo)


def dslash3_eo(s: Staggered3EO, x_src: torch.Tensor, parity_out: int
               ) -> torch.Tensor:
    """Fat (1-hop) + naik (3-hop) hopping term onto ``parity_out``; both
    distances are odd, so both connect the opposite parity.  The naik
    coefficient is inside the long links."""
    nd = s.lat.nd
    gf_out = s.gf_e if parity_out == 0 else s.gf_o
    gf_src = s.gf_o if parity_out == 0 else s.gf_e
    gl_out = s.gl_e if parity_out == 0 else s.gl_o
    gl_src = s.gl_o if parity_out == 0 else s.gl_e
    out = None
    for mu in range(nd):
        fwd = linalg.mv(gf_out[mu], eo.shift_eo(x_src, mu, +1, parity_out,
                                                nd))
        bwd = eo.shift_eo(linalg.mv_an(gf_src[mu], x_src), mu, -1,
                          parity_out, nd)
        term = fwd - bwd
        fwd3 = linalg.mv(gl_out[mu], eo.shift_eo(x_src, mu, +1, parity_out,
                                                 nd, dist=3))
        bwd3 = eo.shift_eo(linalg.mv_an(gl_src[mu], x_src), mu, -1,
                           parity_out, nd, dist=3)
        term = term + fwd3 - bwd3
        out = term if out is None else out + term
    return 0.5 * out


def dslash3_full(lat: Lattice, fat: torch.Tensor, long: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Full-lattice fat + naik hopping term (correctness oracle)."""
    nd = lat.nd
    out = None
    for mu in range(nd):
        term = (linalg.mv(fat[mu], shift(x, mu, +1, nd))
                - shift(linalg.mv_an(fat[mu], x), mu, -1, nd))
        term = term + (linalg.mv(long[mu], shift(x, mu, +1, nd, dist=3))
                       - shift(linalg.mv_an(long[mu], x), mu, -1, nd,
                               dist=3))
        out = term if out is None else out + term
    return 0.5 * out


def d2ee3(s: Staggered3EO, x_e: torch.Tensor, m: float) -> torch.Tensor:
    """Even-odd normal operator of the fat + naik Dslash."""
    t = dslash3_eo(s, x_e, parity_out=1)
    y = dslash3_eo(s, t, parity_out=0)
    return (m * m) * x_e - y


def d2dd3(s: Staggered3EO, x: torch.Tensor, parity: int = 0
          ) -> torch.Tensor:
    """Mass-free fat + naik normal operator (multishift base)."""
    t = dslash3_eo(s, x, parity_out=1 - parity)
    return -dslash3_eo(s, t, parity_out=parity)


def dslash_flops_per_site(nd: int = 4, nc: int = 3) -> int:
    """QEX's Dslash flop model: 18 + nd*(72+66+6) = 594 for nd=4, nc=3."""
    if nc == 3:
        return 18 + nd * (72 + 66 + 6)
    return 6 * nc + nd * (8 * nc * nc + 8 * nc + 2 * nc)
