"""Even-odd staggered operator in the fast layout (port of
``qex_tpu.physics.stag_fast``: the 1-hop operator and the fat + naik
(HISQ) operator).

Vectors are stored ``(nc, Th, Z, Y*X)``: the lattice sites lie on the
last axes with x fastest, which is also the coalescing axis of the
CUDA kernel in :mod:`.stag_hisq`.  x shifts are rolls of the ``Y*X``
axis with a boundary-column select, y shifts roll that axis by X, z
shifts roll the Z axis, and t shifts select between two rolls of the
``Th`` axis by the output site's sublattice.  Shifts take an odd
distance: 1 for the hopping term, 3 for the naik term.
"""

from __future__ import annotations

import dataclasses

import torch

from ..lattice import Lattice
from ..ops import linalg
from . import staggered as st


def to_fast(v: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """(..., X, Y, Z, Th) -> (..., Th, Z, Y*X), contiguous."""
    X, Y, Z = lat.dims[0], lat.dims[1], lat.dims[2]
    nlead = v.dim() - 4
    perm = tuple(range(nlead)) + (nlead + 3, nlead + 2, nlead + 1, nlead)
    vt = v.permute(perm)
    return vt.reshape(vt.shape[:nlead] + (vt.shape[nlead], Z, Y * X)
                      ).contiguous()


def from_fast(v: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """(..., Th, Z, Y*X) -> (..., X, Y, Z, Th), contiguous."""
    X, Y = lat.dims[0], lat.dims[1]
    nlead = v.dim() - 3
    vt = v.reshape(v.shape[:nlead] + (v.shape[nlead], v.shape[nlead + 1],
                                      Y, X))
    perm = tuple(range(nlead)) + (nlead + 3, nlead + 2, nlead + 1, nlead)
    return vt.permute(perm).contiguous()


@dataclasses.dataclass(frozen=True)
class FastStagEO:
    """Fast-layout eo staggered links, each (nd, nc, nc, Th, Z, Y*X)."""

    lat: Lattice
    g_e: torch.Tensor
    g_o: torch.Tensor


def new_fast(s: st.StaggeredEO) -> FastStagEO:
    lat = s.lat
    if lat.nd != 4:
        raise ValueError("fast path requires nd=4")
    return FastStagEO(lat, to_fast(s.g_e, lat), to_fast(s.g_o, lat))


def _coords(lat: Lattice, device):
    """(x, y, z) coordinate fields of shape (Z, Y*X)."""
    X, Y, Z = lat.dims[0], lat.dims[1], lat.dims[2]
    yx = torch.arange(Y * X, device=device).reshape(1, Y * X)
    zg = torch.arange(Z, device=device).reshape(Z, 1)
    return yx % X, yx // X, zg


def shift_fast(f: torch.Tensor, mu: int, sign: int, parity_out: int,
               lat: Lattice, dist: int = 1) -> torch.Tensor:
    """Odd-distance eo shift in the fast layout onto ``parity_out``
    (dist=1 hopping, dist=3 naik)."""
    X = lat.dims[0]
    d = dist
    if mu == 0:       # x: roll of Y*X plus the boundary-column wrap
        xg, _, _ = _coords(lat, f.device)
        if sign > 0:
            a = torch.roll(f, -d, -1)
            b = torch.roll(f, X - d, -1)
            return torch.where(xg >= X - d, b, a)
        a = torch.roll(f, d, -1)
        b = torch.roll(f, -(X - d), -1)
        return torch.where(xg < d, b, a)
    if mu == 1:       # y: roll of the (y, x) axis by d*X
        return torch.roll(f, -sign * d * X, -1)
    if mu == 2:       # z
        return torch.roll(f, -sign * d, -2)
    # t: global t = 2*th + b with b = (parity + x + y + z) % 2; t + sign*d
    # lands at th + sign*(d+1)/2 where b == 1 (forward) or b == 0
    # (backward), else at th + sign*(d-1)/2
    if d % 2 != 1:
        raise ValueError("fast t-shift supports odd distances only")
    xg, yg, zg = _coords(lat, f.device)
    s = ((parity_out + xg + yg + zg) % 2).bool()
    lo, hi = (d - 1) // 2, (d + 1) // 2
    if sign > 0:
        base = f if lo == 0 else torch.roll(f, -lo, -3)
        extra = torch.roll(f, -hi, -3)
    else:
        base = torch.roll(f, hi, -3)
        extra = f if lo == 0 else torch.roll(f, lo, -3)
    return torch.where(s, extra, base)


def dslash_fast(s: FastStagEO, x_src: torch.Tensor, parity_out: int
                ) -> torch.Tensor:
    """Hopping term in the fast layout (same math as
    staggered.dslash_eo)."""
    g_out = s.g_e if parity_out == 0 else s.g_o
    g_src = s.g_o if parity_out == 0 else s.g_e
    out = None
    for mu in range(4):
        fwd = linalg.mv(g_out[mu],
                        shift_fast(x_src, mu, +1, parity_out, s.lat))
        bwd = shift_fast(linalg.mv_an(g_src[mu], x_src), mu, -1,
                         parity_out, s.lat)
        term = fwd - bwd
        out = term if out is None else out + term
    return 0.5 * out


def d2ee_fast(s: FastStagEO, x_e: torch.Tensor, m: float) -> torch.Tensor:
    t = dslash_fast(s, x_e, parity_out=1)
    y = dslash_fast(s, t, parity_out=0)
    return (m * m) * x_e - y


def d2dd_fast(s: FastStagEO, x: torch.Tensor, parity: int = 0
              ) -> torch.Tensor:
    """Mass-free normal operator -D_eo D_oe (multishift base)."""
    t = dslash_fast(s, x, parity_out=1 - parity)
    return -dslash_fast(s, t, parity_out=parity)


# --- fat + naik (HISQ) operator ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class FastStag3EO:
    """Fast-layout eo fat + naik links, each (nd, nc, nc, Th, Z, Y*X):
    fat (1-hop) links ``gf_*`` and long (3-hop) links ``gl_*`` with the
    naik coefficient folded in."""

    lat: Lattice
    gf_e: torch.Tensor
    gf_o: torch.Tensor
    gl_e: torch.Tensor
    gl_o: torch.Tensor


def new_fast3(s: st.Staggered3EO) -> FastStag3EO:
    lat = s.lat
    if lat.nd != 4:
        raise ValueError("fast path requires nd=4")
    return FastStag3EO(lat, to_fast(s.gf_e, lat), to_fast(s.gf_o, lat),
                       to_fast(s.gl_e, lat), to_fast(s.gl_o, lat))


def dslash3_fast(s: FastStag3EO, x_src: torch.Tensor, parity_out: int
                 ) -> torch.Tensor:
    """Fat (1-hop) + naik (3-hop) hopping term in the fast layout (same
    math as staggered.dslash3_eo)."""
    gf_out = s.gf_e if parity_out == 0 else s.gf_o
    gf_src = s.gf_o if parity_out == 0 else s.gf_e
    gl_out = s.gl_e if parity_out == 0 else s.gl_o
    gl_src = s.gl_o if parity_out == 0 else s.gl_e
    out = None
    for mu in range(4):
        fwd = linalg.mv(gf_out[mu],
                        shift_fast(x_src, mu, +1, parity_out, s.lat))
        bwd = shift_fast(linalg.mv_an(gf_src[mu], x_src), mu, -1,
                         parity_out, s.lat)
        term = fwd - bwd
        fwd3 = linalg.mv(gl_out[mu], shift_fast(x_src, mu, +1, parity_out,
                                                s.lat, dist=3))
        bwd3 = shift_fast(linalg.mv_an(gl_src[mu], x_src), mu, -1,
                          parity_out, s.lat, dist=3)
        term = term + fwd3 - bwd3
        out = term if out is None else out + term
    return 0.5 * out


def d2ee3_fast(s: FastStag3EO, x_e: torch.Tensor, m: float
               ) -> torch.Tensor:
    t = dslash3_fast(s, x_e, parity_out=1)
    y = dslash3_fast(s, t, parity_out=0)
    return (m * m) * x_e - y


def d2dd3_fast(s: FastStag3EO, x: torch.Tensor, parity: int = 0
               ) -> torch.Tensor:
    """Mass-free fat + naik normal operator (multishift base)."""
    t = dslash3_fast(s, x, parity_out=1 - parity)
    return -dslash3_fast(s, t, parity_out=parity)
