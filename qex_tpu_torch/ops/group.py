"""SU(N) group / algebra operations on lattice fields (port of
``qex_tpu.ops.group``).

Algebra elements are traceless anti-hermitian (TAH) matrices ``p``; the
HMC kinetic energy is ``K = -1/2 sum retr(p^2) = 1/2 sum |p_ij|^2``.
Random draws take an explicit ``torch.Generator`` in place of a JAX key.
"""

from __future__ import annotations

import torch

from ..device import resolve
from . import linalg


def tah(m: torch.Tensor) -> torch.Tensor:
    """Traceless anti-hermitian projection
    P(m) = (m - m^dag)/2 - tr(m - m^dag)/(2 n) I."""
    n = m.shape[0]
    a = 0.5 * (m - linalg.adj(m))
    if n == 1:
        return a
    tr = linalg.trace(a) / n
    return a - tr * linalg.eye_like(m)


def norm2_tah(p: torch.Tensor, dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """Algebra norm: -sum retr(p^2) = sum_ij |p_ij|^2 (real, >= 0)."""
    return linalg.norm2(p, dtype=dtype)


def kinetic_energy(p: torch.Tensor, dtype: torch.dtype | None = None
                   ) -> torch.Tensor:
    """HMC kinetic term K = -1/2 sum retr(p^2)."""
    return 0.5 * norm2_tah(p, dtype=dtype)


def random_tah(gen: torch.Generator, shape: tuple[int, ...], n: int,
               dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Gaussian traceless anti-hermitian field, shape (n, n, *shape),
    drawn on ``gen``'s device from exp(-K): tah of a complex Ginibre
    matrix with unit-variance real components, so E[K] = (n^2-1)/2 per
    matrix."""
    rdtype = dtype.to_real()
    full = (n, n) + tuple(shape)
    gr = torch.randn(full, generator=gen, dtype=rdtype, device=gen.device)
    gi = torch.randn(full, generator=gen, dtype=rdtype, device=gen.device)
    return tah(torch.complex(gr, gi).to(dtype))


def unit_gauge(lat, dtype: torch.dtype = torch.complex64,
               device: torch.device | str | None = None) -> torch.Tensor:
    """Cold start: identity links, shape (nd, nc, nc, *dims), on
    ``device`` (default: the CUDA card; raises without one)."""
    n = lat.nc
    ident = torch.eye(n, dtype=dtype, device=resolve(device))
    ident = ident.reshape((1, n, n) + (1,) * lat.nd)
    return ident.expand(lat.gauge_shape()).contiguous()
