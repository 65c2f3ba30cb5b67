"""GCR (generalized conjugate residual) with optional right
preconditioning (port of ``qex_tpu.solvers.gcr``; the outer solver of
the Wilson multigrid).

Restarted GCR(m) as nested Python loops with true early exit: the stop
test reads |r|^2 to the host once per iteration, as ``solvers.cg``
does.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import linalg
from .base import SolverStats

Op = Callable[[torch.Tensor], torch.Tensor]


def gcr_solve(op: Op, b: torch.Tensor, *, precon: Op | None = None,
              r2req: float = 1e-12, m: int = 16, max_restarts: int = 50
              ) -> tuple[torch.Tensor, SolverStats]:
    """Right-preconditioned restarted GCR(m): solve D x = b from x = 0.

    ``precon``: approximate inverse applied to residuals (identity when
    None), the hook the multigrid cycle plugs into.
    """
    b2 = float(linalg.norm2(b))
    stop = r2req * b2
    x = torch.zeros_like(b)
    r, r2 = b, b2
    its = 0
    for _ in range(max_restarts):
        if not r2 > stop:
            break
        ps, aps = [], []
        while len(ps) < m and r2 > stop:
            z = r if precon is None else precon(r)
            az = op(z)
            for p, ap in zip(ps, aps):      # orthogonalize against A ps
                c = linalg.dot(ap, az)
                z = z - c * p
                az = az - c * ap
            inv = 1.0 / torch.clamp(torch.sqrt(linalg.norm2(az)), min=1e-30)
            z = z * inv
            az = az * inv
            ps.append(z)
            aps.append(az)
            c = linalg.dot(az, r)
            x = x + c * z
            r = r - c * az
            r2 = float(linalg.norm2(r))
            its += 1
    return x, SolverStats(iterations=its, r2=r2 / b2)
