"""SU(N) group / algebra operations on lattice fields (port of
``qex_tpu.ops.group``).

Algebra elements are traceless anti-hermitian (TAH) matrices ``p``; the
HMC kinetic energy is ``K = -1/2 sum retr(p^2) = 1/2 sum |p_ij|^2``.
Random draws take an explicit ``torch.Generator`` in place of a JAX key.
"""

from __future__ import annotations

import math

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
    return tah(ginibre(gen, shape, n, dtype))


def ginibre(gen: torch.Generator, shape: tuple[int, ...], n: int,
            dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Complex Ginibre field of shape (n, n, *shape) with unit-variance
    real components, drawn on ``gen``'s device (real parts first)."""
    rdtype = dtype.to_real()
    full = (n, n) + tuple(shape)
    gr = torch.randn(full, generator=gen, dtype=rdtype, device=gen.device)
    gi = torch.randn(full, generator=gen, dtype=rdtype, device=gen.device)
    return torch.complex(gr, gi).to(dtype)


def unitary_from_ginibre(g: torch.Tensor) -> torch.Tensor:
    """Haar-distributed U(n) field from a Ginibre field: the Q of the QR
    factorisation with positive diag(R) (Mezzadri's phase fix).  For
    n <= 5 a modified Gram-Schmidt elementwise over the sites, which is
    that QR; above, ``torch.linalg.qr`` on site-major matrices with the
    diagonal phases of R moved into Q."""
    n = g.shape[0]
    if n > 5:
        q, r = torch.linalg.qr(torch.movedim(g, (0, 1), (-2, -1)))
        d = torch.diagonal(r, dim1=-2, dim2=-1)
        q = q * (d / d.abs())[..., None, :]
        return torch.movedim(q, (-2, -1), (0, 1))
    qcols: list[torch.Tensor] = []
    for j in range(n):
        v = g[:, j]
        for qi in qcols:
            v = v - qi * (qi.conj() * v).sum(0)
        nrm = torch.sqrt((v.abs() ** 2).sum(0)).to(g.dtype)
        qcols.append(v / nrm)
    return torch.stack(qcols, dim=1)


def su_from_unitary(u: torch.Tensor) -> torch.Tensor:
    """A U(n) field with each determinant's phase divided out."""
    n = u.shape[0]
    phase = torch.angle(linalg.det(u))
    return u * torch.exp(-1j * phase / n).to(u.dtype)


def random_unitary(gen: torch.Generator, shape: tuple[int, ...], n: int,
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Haar-random U(n) field of shape (n, n, *shape) (hot starts)."""
    return unitary_from_ginibre(ginibre(gen, shape, n, dtype))


def random_su(gen: torch.Generator, shape: tuple[int, ...], n: int,
              dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Haar-random SU(n) field: a U(n) sample with the determinant's
    phase removed."""
    return su_from_unitary(random_unitary(gen, shape, n, dtype))


def check_su(u: torch.Tensor) -> dict:
    """Unitarity and determinant deviations per site, float64 scalars
    (QEX ``checkSU``)."""
    nsites = math.prod(u.shape[2:]) if u.dim() > 2 else 1
    dev_u = linalg.norm2(linalg.mul_an(u, u) - linalg.eye_like(u),
                         dtype=torch.float64)
    dev_d = linalg.norm2(linalg.det(u) - 1.0, dtype=torch.float64)
    return {"unitarity_dev2_per_site": dev_u / nsites,
            "det_dev2_per_site": dev_d / nsites}


def unit_gauge(lat, dtype: torch.dtype = torch.complex64,
               device: torch.device | str | None = None) -> torch.Tensor:
    """Cold start: identity links, shape (nd, nc, nc, *dims), on
    ``device`` (default: the CUDA card; raises without one)."""
    n = lat.nc
    ident = torch.eye(n, dtype=dtype, device=resolve(device))
    ident = ident.reshape((1, n, n) + (1,) * lat.nd)
    return ident.expand(lat.gauge_shape()).contiguous()
