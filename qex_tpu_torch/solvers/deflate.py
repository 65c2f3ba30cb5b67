"""Subspace-deflated CG (port of ``qex_tpu.solvers.deflate``).

Given n approximate low eigenvectors V of the hermitian positive
definite A, the solve is split Galerkin-style (init-CG):

    x0 = V (V^H A V)^{-1} V^H b,      r0 = b - A x0  (V^H r0 = 0
                                       by construction),

then CG runs on A z = r0, and the low-mode correction is applied once
more on the final iterate to absorb rounding drift.  The full Galerkin
matrix V^H A V, not the Ritz values, keeps the scheme robust to inexact
(complex64) eigenvectors.  The Galerkin matrix and right-hand sides are
formed in complex128 and the n x n solve runs there; the JAX package's
``jax.vmap(op)`` over the vectors is a loop here.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops import linalg
from . import cg
from .base import SolverStats

Op = Callable[[torch.Tensor], torch.Tensor]


def deflated_cg(op: Op, b: torch.Tensor, evals, vecs: torch.Tensor, *,
                r2req: float = 1e-12, maxits: int = 1000, restarts: int = 2
                ) -> tuple[torch.Tensor, SolverStats]:
    """Solve A x = b with the span of ``vecs`` handled directly.

    ``vecs``: (n, *b.shape) approximate low eigenvectors (orthonormal or
    not: the Galerkin matrix absorbs the scaling).  ``evals`` is
    accepted for symmetry with ``eigens.deflation_basis``; the Galerkin
    matrix V^H A V is used instead.  Costs n operator applications at
    setup."""
    del evals
    g = linalg.gram(vecs, torch.stack([op(x) for x in vecs]))

    def galerkin(r):
        c = linalg.gram(vecs, r[None])[:, 0]
        y = torch.linalg.solve(g, c).to(vecs.dtype)
        return torch.tensordot(y, vecs, dims=1)

    x0 = galerkin(b)
    z, stats = cg.cg_solve_restarted(op, b - op(x0), r2req=r2req,
                                     maxits=maxits, restarts=restarts)
    x = x0 + z
    return x + galerkin(b - op(x)), stats


def deflation_pays(evals, m: float, margin: float = 1.0) -> bool:
    """Whether deflating the shifted solve A + m^2 pays: only where the
    deflated modes dominate the low end of the shifted spectrum, i.e.
    max(deflated evals) >= margin * m^2 (the JAX package measured a 2x
    slower solve where m^2 already dominates the band).  Host-side."""
    ev = np.asarray(evals, dtype=np.float64)
    if ev.size == 0:
        return False
    return bool(np.max(ev) >= margin * float(m) * float(m))


def auto_deflated_cg(op: Op, b: torch.Tensor, evals, vecs: torch.Tensor,
                     m: float, *, r2req: float = 1e-12, maxits: int = 1000,
                     restarts: int = 2):
    """:func:`deflated_cg` where :func:`deflation_pays`, else plain
    restarted CG.  Returns (x, stats, used_deflation)."""
    if deflation_pays(evals, m):
        x, stats = deflated_cg(op, b, evals, vecs, r2req=r2req,
                               maxits=maxits, restarts=restarts)
        return x, stats, True
    x, stats = cg.cg_solve_restarted(op, b, r2req=r2req, maxits=maxits,
                                     restarts=restarts)
    return x, stats, False
