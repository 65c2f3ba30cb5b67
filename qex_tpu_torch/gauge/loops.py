"""Plaquette and Polyakov-loop observables (port of ``plaq_field``,
``plaquette``, ``plaquette_by_plane`` and ``polyakov_loop`` from
``qex_tpu.gauge.loops``).  Site sums accumulate in float64."""

from __future__ import annotations

import torch

from ..lattice import Lattice
from ..ops import linalg
from ..ops.shifts import shift


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
            total = total + torch.sum(
                linalg.re_trace(plaq_field(u, mu, nu, nd)),
                dtype=torch.float64)
    return total / (nplanes * nc * lat.volume)


def plaquette_by_plane(lat: Lattice, u: torch.Tensor) -> torch.Tensor:
    """Per-plane plaquette averages, shape (nd*(nd-1)/2,) float64, in
    the order (0,1),(0,2),(1,2),(0,3),... (spatial planes first)."""
    nd, nc = lat.nd, lat.nc
    return torch.stack([
        torch.sum(linalg.re_trace(plaq_field(u, mu, nu, nd)),
                  dtype=torch.float64) / (nc * lat.volume)
        for nu in range(1, nd) for mu in range(nu)])


def polyakov_loop(lat: Lattice, u: torch.Tensor, mu: int | None = None
                  ) -> torch.Tensor:
    """Volume-averaged Polyakov loop tr prod U_mu / nc along ``mu``
    (default the last direction), a complex128 scalar.  A power-of-two
    extent multiplies by doubling, P_{k+1}(x) = P_k(x) P_k(x + 2^k mu);
    any other extent one link at a time."""
    nd, nc = lat.nd, lat.nc
    if mu is None:
        mu = nd - 1
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
    return torch.sum(linalg.trace(p), dtype=torch.complex128) / (
        nc * lat.volume)
