"""Coulomb and Landau gauge fixing (port of ``qex_tpu.gauge.fix``; QEX
src/gauge/gaugefix.nim).

A checkerboard polar relaxation: every even site moves at once (its
optimum depends only on odd-site data), then every odd site.  At fixed
neighbours the maximiser of

    F[g] = sum_{x, mu in dirs} Re tr[ g(x) U_mu(x) g(x+mu)^dag ]

is the projection g(x) = P(h(x)^dag), h(x) = sum_{mu in dirs}
[U_mu(x) g(x+mu)^dag + (g(x-mu) U_mu(x-mu))^dag].  ``iters // 4`` such
sweeps approach the basin, then checkerboard Riemannian gradient sweeps
g <- exp(-tau tah(g h)) g converge to the SU(3) gauge condition.  The
transform g is built in complex128 whatever the links' type, and the
fixed links rounded to it at the end: a complex64 g leaves the group by
~1e-7 a gradient sweep, and 150 sweeps of Coulomb fixing at 16^4 moved
the plaquette of the fixed links by 1.0e-6 on an H100 (30 sweeps at 4^4
by 7.6e-6 with a complex64 exponential too).
Landau gauge: dirs = all; Coulomb: dirs = spatial.  The functional and
the violation are float64 sums.
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..lattice import Lattice
from ..ops import group, linalg
from ..ops.shifts import shift


def apply_gauge_transform(lat: Lattice, u: torch.Tensor, g: torch.Tensor
                          ) -> torch.Tensor:
    """U_mu(x) -> g(x) U_mu(x) g(x+mu)^dag."""
    return torch.stack([
        linalg.mul_na(linalg.mul(g, u[mu]), shift(g, mu, +1, lat.nd))
        for mu in range(lat.nd)])


def functional(lat: Lattice, u: torch.Tensor, dirs) -> torch.Tensor:
    """Normalised gauge functional F = mean_{x,mu} Re tr U_mu / nc."""
    dirs = tuple(dirs)
    vals = sum(linalg.re_trace(u[mu]).sum(dtype=torch.float64)
               for mu in dirs)
    return vals / (len(dirs) * lat.nc * lat.volume)


def violation(lat: Lattice, u: torch.Tensor, dirs) -> torch.Tensor:
    """Gauge-condition residual theta = (1/V) sum_x |Delta(x)|^2 with
    Delta = sum_mu [A_mu(x) - A_mu(x-mu)], A = tah(U) (QEX gaugefix
    metric :145-196 analogue)."""
    delta = None
    for mu in dirs:
        a = group.tah(u[mu])
        d = a - shift(a, mu, -1, lat.nd)
        delta = d if delta is None else delta + d
    return linalg.norm2(delta, dtype=torch.float64) / lat.volume


def _site_h(lat: Lattice, u: torch.Tensor, g: torch.Tensor, dirs
            ) -> torch.Tensor:
    """h(x) as above on every site (the parity mask picks which move)."""
    nd = lat.nd
    h = None
    for mu in dirs:
        fwd = linalg.mul_na(u[mu], shift(g, mu, +1, nd))
        bwd = linalg.adj(shift(linalg.mul(g, u[mu]), mu, -1, nd))
        t = fwd + bwd
        h = t if h is None else h + t
    return h


def _parity_mask(lat: Lattice, device) -> torch.Tensor:
    """1 on odd sites, 0 on even ones (real, of the lattice's shape)."""
    s = torch.zeros((), dtype=torch.int64, device=device)
    for mu in range(lat.nd):
        shape = [1] * lat.nd
        shape[mu] = lat.dims[mu]
        s = s + torch.arange(lat.dims[mu], device=device).reshape(shape)
    return torch.broadcast_to(s % 2, lat.dims).to(torch.float64)


def gauge_dirs(lat: Lattice, gauge: str) -> tuple[int, ...]:
    if gauge == "landau":
        return tuple(range(lat.nd))
    if gauge == "coulomb":
        return tuple(range(lat.nd - 1))
    raise ValueError(f"unknown gauge {gauge!r}")


def gauge_fix_iter(lat: Lattice, u: torch.Tensor, *, gauge: str = "landau",
                   iters: int = 200, proj_iters: int = 14
                   ) -> Iterator[torch.Tensor]:
    """The transform g (complex128) after each of the ``iters`` sweeps of
    :func:`gauge_fix` (a caller can monitor the functional and the
    violation on the way)."""
    dirs = gauge_dirs(lat, gauge)
    odd = _parity_mask(lat, u.device)
    even = 1.0 - odd
    g = linalg.eye_like(u[0].to(torch.complex128)).expand(u[0].shape).clone()

    def polar_half(g, mask):
        h = _site_h(lat, u, g, dirs)
        gopt = linalg.project_su(linalg.adj(h), iters=proj_iters)
        return g * (1.0 - mask) + gopt * mask

    # the U(3)-polar maximiser with the determinant's phase removed is
    # not exactly SU(3)-stationary, so gradient ascent finishes the job
    tau = 0.9 / (2.0 * len(dirs))

    def grad_half(g, mask):
        h = _site_h(lat, u, g, dirs)
        x = group.tah(linalg.mul(g, h))
        return g * (1.0 - mask) + linalg.mul(linalg.expm(-tau * x), g) * mask

    n1 = max(iters // 4, 1)
    for i in range(max(iters, n1)):
        half = polar_half if i < n1 else grad_half
        g = half(half(g, even), odd)
        yield g


def gauge_fix(lat: Lattice, u: torch.Tensor, *, gauge: str = "landau",
              iters: int = 200, proj_iters: int = 14
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gauge-fixing transform g (QEX ``getGaugeFixTransform``) and the
    fixed links, both of u's type: ``iters`` sweeps, the first
    ``max(iters // 4, 1)`` polar.  ``gauge``: "landau" (all directions)
    or "coulomb" (spatial only)."""
    g = None
    for g in gauge_fix_iter(lat, u, gauge=gauge, iters=iters,
                            proj_iters=proj_iters):
        pass
    return g.to(u.dtype), apply_gauge_transform(lat, u, g).to(u.dtype)
