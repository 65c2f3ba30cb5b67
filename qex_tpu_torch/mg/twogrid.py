"""Two-grid (adaptive aggregation) multigrid for the Wilson operator
(port of ``qex_tpu.mg.twogrid``).

* Setup: near-null vectors from relaxing random fields with the
  homogeneous operator (Richardson on D v ~ 0), then block-orthonormalized
  over hypercubic aggregates -> prolongator P.
* Coarse operator: Galerkin D_c = R D P applied matrix-free (one fine
  operator application per coarse matvec).
* Solve: outer GCR right-preconditioned by one two-grid cycle:
  pre-smooth, coarse GCR solve, post-smooth.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..device import resolve
from ..lattice import Lattice
from ..ops import linalg


def _block_reshape(v: torch.Tensor, lat: Lattice, bs: int) -> torch.Tensor:
    """(lead..., X, Y, Z, T) -> (lead..., Xc, bx, Yc, by, Zc, bz, Tc, bt)."""
    lead = tuple(v.shape[:-lat.nd])
    shape = lead + sum((((d // bs), bs) for d in lat.dims), ())
    return v.reshape(shape)


@dataclasses.dataclass(frozen=True)
class MGSetup:
    """Two-grid data: orthonormal block prolongator.

    w: (nvec, ns, nc, Xc, bs, Yc, bs, Zc, bs, Tc, bs) block-supported
    orthonormal near-null vectors."""

    lat: Lattice
    bs: int
    w: torch.Tensor

    @property
    def nvec(self) -> int:
        return self.w.shape[0]


def restrict(setup: MGSetup, v: torch.Tensor) -> torch.Tensor:
    """Fine field (ns, nc, *dims) -> coarse (nvec, Xc, Yc, Zc, Tc)."""
    vb = _block_reshape(v, setup.lat, setup.bs)
    return torch.einsum("kscXxYyZzTt,scXxYyZzTt->kXYZT", setup.w.conj(), vb)


def prolong(setup: MGSetup, c: torch.Tensor) -> torch.Tensor:
    """Coarse (nvec, Xc, Yc, Zc, Tc) -> fine (ns, nc, *dims)."""
    vb = torch.einsum("kscXxYyZzTt,kXYZT->scXxYyZzTt", setup.w, c)
    return vb.reshape(tuple(vb.shape[:2]) + setup.lat.dims)


def _block_orthonormalize(w: torch.Tensor, eps: float = 1e-30
                          ) -> torch.Tensor:
    """Gram-Schmidt the nvec vectors within every block."""
    ws = []
    for k in range(w.shape[0]):
        v = w[k]
        for wj in ws:
            c = torch.einsum("scXxYyZzTt,scXxYyZzTt->XYZT", wj.conj(), v)
            v = v - torch.einsum("scXxYyZzTt,XYZT->scXxYyZzTt", wj, c)
        n2 = torch.einsum("scXxYyZzTt,scXxYyZzTt->XYZT", v.conj(), v)
        inv = torch.rsqrt(n2.real + eps).to(v.dtype)
        ws.append(torch.einsum("scXxYyZzTt,XYZT->scXxYyZzTt", v, inv))
    return torch.stack(ws)


def _start_vectors(gen: torch.Generator, shape: tuple[int, ...],
                   dtype: torch.dtype) -> torch.Tensor:
    """The setup's random start fields: complex Gaussian with
    unit-variance real and imaginary parts, drawn on ``gen``'s device
    (the one place the setup draws random numbers)."""
    rdtype = dtype.to_real()
    re = torch.randn(shape, generator=gen, dtype=rdtype, device=gen.device)
    im = torch.randn(shape, generator=gen, dtype=rdtype, device=gen.device)
    return torch.complex(re, im).to(dtype)


def mg_setup(lat: Lattice, op: Callable, nvec: int = 8, bs: int = 2,
             relax_iters: int = 30, relax_step: float = 0.2,
             seed: int = 0, dtype: torch.dtype = torch.complex64,
             ns: int = 4, chiral: bool = False,
             device: torch.device | str | None = None) -> MGSetup:
    """Adaptive setup: relax random vectors toward the near-null space
    of ``op``, then block-orthonormalize.  The start vectors come from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default: the
    CUDA card; raises without one).

    ``chiral=True`` (requires ns=4, chiral gamma basis): split each
    near-null vector into its two gamma5 chiralities before the block
    orthonormalization, so span(P) is gamma5-invariant and the coarse
    operator inherits gamma5-hermiticity (doubles the coarse dof per
    near-null vector)."""
    if chiral and ns != 4:
        raise ValueError("chiral splitting requires ns=4")
    gen = torch.Generator(device=resolve(device)).manual_seed(seed)
    v = _start_vectors(gen, (nvec, ns, lat.nc) + lat.dims, dtype)
    relaxed = []
    for x in v:
        for _ in range(relax_iters):
            x = x - relax_step * op(x)
            x = x / torch.sqrt(linalg.norm2(x))
        relaxed.append(x)
    v = torch.stack(relaxed)
    if chiral:
        # g5 = diag(1,1,-1,-1): the upper and lower spin doublets are the
        # two chiralities
        up, dn = v.clone(), v.clone()
        up[:, 2:] = 0
        dn[:, :2] = 0
        v = torch.cat([up, dn])
    return MGSetup(lat, bs, _block_orthonormalize(_block_reshape(v, lat,
                                                                 bs)))


def coarse_op(setup: MGSetup, op: Callable) -> Callable:
    """Galerkin coarse operator D_c = R D P (matrix-free)."""
    def dc(c):
        return restrict(setup, op(prolong(setup, c)))
    return dc


def mg_preconditioner(setup: MGSetup, op: Callable, *,
                      smooth_iters: int = 2, smooth_step: float = 0.2,
                      coarse_iters: int = 8) -> Callable:
    """One two-grid cycle as a right preconditioner for GCR:
    pre-smooth (Richardson), coarse GCR solve of D_c e = R r, prolong
    the correction, post-smooth."""
    from ..solvers.gcr import gcr_solve
    dc = coarse_op(setup, op)

    def cycle(r):
        x = smooth_step * r
        for _ in range(smooth_iters - 1):
            x = x + smooth_step * (r - op(x))
        rc = restrict(setup, r - op(x))
        ec, _ = gcr_solve(dc, rc, r2req=1e-4, m=coarse_iters,
                          max_restarts=1)
        x = x + prolong(setup, ec)
        for _ in range(smooth_iters):
            x = x + smooth_step * (r - op(x))
        return x

    return cycle


def mg_solve(lat: Lattice, op: Callable, b: torch.Tensor, *,
             nvec: int = 8, bs: int = 2, r2req: float = 1e-10,
             m: int = 16, max_restarts: int = 50, seed: int = 0,
             setup: MGSetup | None = None):
    """Two-grid preconditioned GCR solve of op x = b; returns
    (x, stats, setup)."""
    from ..solvers.gcr import gcr_solve
    if setup is None:
        setup = mg_setup(lat, op, nvec=nvec, bs=bs, seed=seed,
                         dtype=b.dtype, ns=b.shape[0], device=b.device)
    x, stats = gcr_solve(op, b, precon=mg_preconditioner(setup, op),
                         r2req=r2req, m=m, max_restarts=max_restarts)
    return x, stats, setup
