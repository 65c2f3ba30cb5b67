"""Solver parameter/result types (port of ``MGParams``, ``SolverParams``
and ``SolverStats`` from ``qex_tpu.solvers.base``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class MGParams:
    """Multigrid-preconditioner configuration for the ``backend="mg"``
    Wilson solve route (consumed by ``mg.kcycle`` through
    ``physics.wilson.solve_mg``)."""

    nlevels: int = 2
    nvec: int = 8          # near-null vectors per coarsening
    bs: int = 2            # geometric block size
    chiral: bool = True    # gamma5-chirality-split prolongator
    relax_iters: int = 30  # adaptive-setup relaxation sweeps
    m: int = 16            # outer GCR restart length
    smooth_iters: int = 2
    k_m: int = 4           # K-cycle coarse GCR iterations
    bottom_iters: int = 16
    seed: int = 0
    assemble: bool = True  # probe coarse ops into explicit stencils


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
    backend: "cg" (CGNE / eo CG) or "mg" (K-cycle-multigrid-preconditioned
    GCR on the Wilson operator itself; ``physics.wilson.solve``/``solve_eo``
    dispatch on it), with ``mg`` its configuration (default MGParams()).
    """

    r2req: float = 1e-12
    maxits: int = 2000
    restarts: int = 5
    sloppy: bool = False
    mesh: object | None = None
    backend: str = "cg"
    mg: MGParams | None = None

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
