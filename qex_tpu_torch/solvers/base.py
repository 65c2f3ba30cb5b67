"""Solver parameter/result types (port of ``SolverParams`` and
``SolverStats`` from ``qex_tpu.solvers.base``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Static solve configuration.

    r2req: relative residual^2 target (|r|^2 / |b|^2).
    maxits: iteration cap per inner CG.
    restarts: defect-correction restart cap.
    sloppy: bf16-link inner CG iterations with true-residual restarts
    on the full-precision operator (``stag_solve.solve_ee``).
    mesh: the JAX package's sharded multi-chip kernel route; not ported
    yet (ROADMAP A11), so setting it raises in the solve entry points.
    """

    r2req: float = 1e-12
    maxits: int = 2000
    restarts: int = 5
    sloppy: bool = False
    mesh: object | None = None

    def check_supported(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                "SolverParams.mesh: multi-GPU solves are not ported yet "
                "(ROADMAP A11)")


@dataclasses.dataclass
class SolverStats:
    """Per-solve statistics: iterations and final relative residual^2."""

    iterations: int = 0
    r2: float = 0.0


LinearOp = Callable[[torch.Tensor], torch.Tensor]
