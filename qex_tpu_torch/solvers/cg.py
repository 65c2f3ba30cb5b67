"""Conjugate gradient with defect-correction restarts (port of
``qex_tpu.solvers.cg``: ``cg_solve``, ``cg_solve_restarted`` and
``cg_solve_precon``).

The JAX ``lax.while_loop`` becomes a Python loop.  Scalars stay on the
device; the stop test reads ``|r|^2`` to the host once per iteration,
which is the loop's one synchronisation (a known idle gap between
iterations on the GPU, left for a later change).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import linalg
from .base import LOCAL, Reductions, SolverStats

Op = Callable[[torch.Tensor], torch.Tensor]


def cg_solve(op: Op, b: torch.Tensor, x0: torch.Tensor | None = None, *,
             r2req: float = 1e-12, maxits: int = 1000,
             dots: Reductions = LOCAL) -> tuple[torch.Tensor, SolverStats]:
    """Plain CG on a hermitian positive definite operator, from ``x0``
    (default 0); stops when |r|^2 / |b|^2 <= r2req or after maxits
    iterations.  ``dots`` takes the global sums (a mesh's for vectors
    split over ranks)."""
    b2 = dots.norm2(b)
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - op(x0)
    p = r
    r2 = dots.norm2(r)
    stop = float(r2req * b2)
    r2_host = float(r2)
    k = 0
    while r2_host > stop and k < maxits:
        ap = op(p)
        alpha = r2 / dots.redot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        r2new = dots.norm2(r)
        p = r + (r2new / r2) * p
        r2 = r2new
        r2_host = float(r2)
        k += 1
    return x, SolverStats(iterations=k, r2=r2_host / float(b2))


def cg_solve_restarted(op: Op, b: torch.Tensor, *, r2req: float = 1e-12,
                       maxits: int = 1000, restarts: int = 5,
                       inner_r2req_floor: float = 1e-12,
                       op_true: Op | None = None,
                       stop2: float | None = None,
                       dots: Reductions = LOCAL,
                       ) -> tuple[torch.Tensor, SolverStats]:
    """Defect-correction restarted CG: run inner CG, recompute the TRUE
    residual r = b - op_true(x), and restart on the defect until the
    true relative residual meets r2req (at most ``restarts`` rounds).

    ``op_true`` (default ``op``) evaluates the true residuals; ``stop2``
    is an absolute |r|^2 stop that overrides ``r2req * |b|^2``; ``dots``
    as in :func:`cg_solve`.
    """
    if op_true is None:
        op_true = op
    b2 = float(dots.norm2(b))
    stop = r2req * b2 if stop2 is None else float(stop2)
    x = torch.zeros_like(b)
    its = 0
    for _ in range(restarts):
        r = b - op_true(x)
        if float(dots.norm2(r)) <= stop:
            break
        dx, st = cg_solve(op, r, r2req=max(r2req * 0.1, inner_r2req_floor),
                          maxits=maxits, dots=dots)
        x = x + dx
        its += st.iterations
    r2_final = float(dots.norm2(b - op_true(x))) / b2
    return x, SolverStats(iterations=its, r2=r2_final)


def cg_solve_precon(op: Op, b: torch.Tensor, precon: Op, *,
                    r2req: float = 1e-12, maxits: int = 1000
                    ) -> tuple[torch.Tensor, SolverStats]:
    """Preconditioned CG from x = 0 with a hermitian preconditioner
    ``precon`` ~ A^{-1}; stops on the unpreconditioned |r|^2 / |b|^2 <=
    r2req or after maxits iterations."""
    x = torch.zeros_like(b)
    b2 = linalg.norm2(b)
    r = b
    z = precon(r)
    p = z
    rz = linalg.redot(r, z)
    stop = float(r2req * b2)
    r2_host = float(linalg.norm2(r))
    k = 0
    while r2_host > stop and k < maxits:
        ap = op(p)
        alpha = rz / linalg.redot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precon(r)
        rznew = linalg.redot(r, z)
        p = z + (rznew / rz) * p
        rz = rznew
        r2_host = float(linalg.norm2(r))
        k += 1
    return x, SolverStats(iterations=k, r2=r2_host / float(b2))
