"""Gauge loop observables (port of ``qex_tpu.gauge.loops``): plaquette,
Polyakov loop, Wilson lines, the clover field strength, the energy
density in two discretisations and the topological charge.  Site sums
accumulate in float64, all-reduced over the ranks on a rank mesh's
blocks (``parallel.halo.site_sum``)."""

from __future__ import annotations

import math

import torch

from ..lattice import Lattice
from ..ops import linalg
from ..ops.shifts import shift
from ..parallel import mesh
from ..parallel.halo import psum, site_sum


def plaq_field(u: torch.Tensor, mu: int, nu: int, nd: int) -> torch.Tensor:
    """Untraced plaquette P_{mu nu}(x) =
    U_mu(x) U_nu(x+mu) U_mu(x+nu)^dag U_nu(x)^dag."""
    umu, unu = u[mu], u[nu]
    a = linalg.mul(umu, shift(unu, mu, +1, nd))
    b = linalg.mul(unu, shift(umu, nu, +1, nd))
    return linalg.mul_na(a, b)


def plaquette(lat: Lattice, u: torch.Tensor) -> torch.Tensor:
    """Average plaquette Re tr P / nc over all planes and sites (float64);
    1.0 for unit gauge."""
    nd, nc = lat.nd, lat.nc
    total = 0.0
    nplanes = nd * (nd - 1) // 2
    for mu in range(nd):
        for nu in range(mu + 1, nd):
            total = total + site_sum(
                linalg.re_trace(plaq_field(u, mu, nu, nd)))
    return total / (nplanes * nc * lat.volume)


def plaquette_by_plane(lat: Lattice, u: torch.Tensor) -> torch.Tensor:
    """Per-plane plaquette averages, shape (nd*(nd-1)/2,) float64, in
    the order (0,1),(0,2),(1,2),(0,3),... (spatial planes first)."""
    nd, nc = lat.nd, lat.nc
    return torch.stack([
        site_sum(linalg.re_trace(plaq_field(u, mu, nu, nd)))
        / (nc * lat.volume) for nu in range(1, nd) for mu in range(nu)])


def polyakov_loop(lat: Lattice, u: torch.Tensor, mu: int | None = None
                  ) -> torch.Tensor:
    """Volume-averaged Polyakov loop tr prod U_mu / nc along ``mu``
    (default the last direction), a complex128 scalar.  A power-of-two
    extent multiplies by doubling, P_{k+1}(x) = P_k(x) P_k(x + 2^k mu);
    any other extent one link at a time."""
    nd, nc = lat.nd, lat.nc
    if mu is None:
        mu = nd - 1
    lm = mesh.active()
    if lm is not None and lm.rank_geom[mu] > 1:
        return _polyakov_split(lm, lat, u, mu)
    length = lat.dims[mu]
    p = u[mu]
    if (length & (length - 1)) == 0:
        span = 1
        while span < length:
            p = linalg.mul(p, shift(p, mu, +1, nd, dist=span))
            span *= 2
    else:
        for k in range(1, length):
            p = linalg.mul(p, shift(u[mu], mu, +1, nd, dist=k))
    return site_sum(linalg.trace(p), torch.complex128) / (nc * lat.volume)


def _polyakov_split(lm, lat: Lattice, u: torch.Tensor, mu: int
                    ) -> torch.Tensor:
    """:func:`polyakov_loop` with direction mu split over the ranks:
    each rank's ordered product of its block's links along mu, the
    products of one line of ranks multiplied in rank order, traced at
    the line's first rank (the trace is cyclic, so every base point on
    a line gives it)."""
    nd, nc = lat.nd, lat.nc
    axis = u[mu].dim() - nd + mu
    p = u[mu].select(axis, 0)
    for k in range(1, u.shape[u.dim() - nd + mu]):
        p = linalg.mul(p, u[mu].select(axis, k))
    parts = lm.all_gather(p.contiguous())
    here = list(lm.coords)
    line = None
    for c in range(lm.rank_geom[mu]):
        here[mu] = c
        q = parts[lm.rank_of(here)]
        line = q if line is None else linalg.mul(line, q)
    first = torch.sum(linalg.trace(line), dtype=torch.complex128)
    if lm.coords[mu] != 0:
        first = torch.zeros_like(first)
    return psum(first * lat.dims[mu]) / (nc * lat.volume)


def wilson_line(lat: Lattice, u: torch.Tensor, path, engine=None
                ) -> torch.Tensor:
    """Average Re tr / nc of the Wilson line along ``path`` (entries
    +-(mu+1), QEX ``wline``); pass a shared ``engine`` to reuse
    sub-segments across lines."""
    from .wline import PathEngine
    eng = engine if engine is not None else PathEngine(lat, u)
    return eng.loop_trace(path)


def clover_fmunu(u: torch.Tensor, mu: int, nu: int, nd: int,
                 engine=None) -> torch.Tensor:
    """Clover field strength F_{mu nu}: the traceless anti-hermitian part
    of the mean of the four plaquette leaves around x."""
    from .wline import PathEngine
    if engine is None:
        engine = PathEngine(Lattice(u.shape[-nd:], nc=u.shape[1]), u)
    c = 0.25 * engine.clover_leaves(mu, nu)
    f = 0.5 * (c - linalg.adj(c))
    tr = linalg.trace(f) / f.shape[0]
    return f - tr * linalg.eye_like(f)


def energy_density_clover(lat: Lattice, u: torch.Tensor) -> torch.Tensor:
    """Clover energy density E = -1/2 sum tr F^2 / V = sum |F|^2 / V over
    the planes mu < nu (QEX densityE), float64."""
    from .wline import PathEngine
    nd = lat.nd
    eng = PathEngine(lat, u)
    total = 0.0
    for mu in range(nd):
        for nu in range(mu + 1, nd):
            f = clover_fmunu(u, mu, nu, nd, engine=eng)
            total = total + linalg.norm2(f, dtype=torch.float64)
    return psum(total) / lat.volume


def energy_density_plaq(lat: Lattice, u: torch.Tensor) -> torch.Tensor:
    """Plaquette energy density E = 2 sum_planes (nc - retr P) / V,
    float64."""
    nd, nc = lat.nd, lat.nc
    total = 0.0
    for mu in range(nd):
        for nu in range(mu + 1, nd):
            total = total + site_sum(
                nc - linalg.re_trace(plaq_field(u, mu, nu, nd)))
    return 2.0 * total / lat.volume


def topo_charge_clover(lat: Lattice, u: torch.Tensor) -> torch.Tensor:
    """Clover topological charge
    Q = 1/(32 pi^2) sum_x eps_{mu nu rho sigma} tr F_{mu nu} F_{rho sigma}
    (QEX topoQ), 4D only, float64.  The 24 terms of the epsilon sum are
    8 copies of the three plane pairings (01)(23), -(02)(13), (03)(12)."""
    from .wline import PathEngine
    nd = lat.nd
    if nd != 4:
        raise ValueError("topological charge requires nd=4")
    eng = PathEngine(lat, u)
    fs = {(mu, nu): clover_fmunu(u, mu, nu, nd, engine=eng)
          for mu in range(nd) for nu in range(mu + 1, nd)}

    def tr_ff(a, b):
        return site_sum(linalg.re_trace(linalg.mul(fs[a], fs[b])))

    q = tr_ff((0, 1), (2, 3)) - tr_ff((0, 2), (1, 3)) + tr_ff((0, 3), (1, 2))
    return q / (4.0 * math.pi ** 2)
