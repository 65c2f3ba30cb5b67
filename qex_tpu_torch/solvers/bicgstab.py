"""BiCGStab for non-hermitian systems (port of
``qex_tpu.solvers.bicgstab``): solve D x = b directly without forming
the normal equations.  A Python loop that reads |r|^2 to the host once
per iteration, as ``solvers.cg`` does.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops import linalg
from .base import SolverStats


def bicgstab_solve(op: Callable[[torch.Tensor], torch.Tensor],
                   b: torch.Tensor, x0: torch.Tensor | None = None, *,
                   r2req: float = 1e-12, maxits: int = 2000
                   ) -> tuple[torch.Tensor, SolverStats]:
    """BiCGStab (van der Vorst).  Stops at |r|^2/|b|^2 <= r2req, after
    ``maxits`` iterations, or on breakdown (a non-finite |r|^2)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - op(x)
    r0 = r
    b2 = float(linalg.norm2(b))
    stop = r2req * b2
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    p = v = torch.zeros_like(b)
    r2 = float(linalg.norm2(r))
    k = 0
    while r2 > stop and math.isfinite(r2) and k < maxits:
        rho_new = linalg.dot(r0, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = op(p)
        alpha = rho_new / linalg.dot(r0, v)
        s = r - alpha * v
        t = op(s)
        omega = linalg.dot(t, s) / torch.clamp(linalg.norm2(t), min=1e-30)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        r2 = float(linalg.norm2(r))
        k += 1
    return x, SolverStats(iterations=k, r2=r2 / b2)
