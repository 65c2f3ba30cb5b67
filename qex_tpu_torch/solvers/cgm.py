"""Multishift (multi-mass) conjugate gradient (port of
``qex_tpu.solvers.cgm.cg_multishift``).

Solves ``(A + sigma_i) x_i = b`` for every shift sigma_i from one Krylov
space of the base operator A (B. Jegerlehner, hep-lat/9612014).  The
smallest shift is the base system, which converges slowest, so every
other system has converged when it has.  The shifted residuals are
``zeta_i * r``, so every shift's convergence follows from the base
residual norm.

The JAX ``lax.while_loop`` becomes a Python loop.  The per-shift
iterates are stacked on a leading axis and the scalar recurrences run on
the device, so the stop test's one read of ``max_i zeta_i^2 |r|^2`` is
the loop's only synchronisation per iteration.  The scalars are
accumulated and carried in float64 (the JAX package carries them in the
vector's real precision; on complex128 vectors the two agree).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops import linalg
from .base import SolverStats


def cg_multishift(base_op: Callable[[torch.Tensor], torch.Tensor],
                  b: torch.Tensor, shifts: Sequence[float], *,
                  r2req: float = 1e-12, maxits: int = 2000
                  ) -> tuple[list[torch.Tensor], SolverStats]:
    """Shifted CG: returns [x_i] with (A + sigma_i) x_i = b.

    Iterates until max_i |zeta_i r|^2 <= r2req |b|^2 or maxits; every
    shift must be >= 0 and A positive semi-definite (the staggered
    normal operator)."""
    ns = len(shifts)
    f64 = torch.float64
    dev = b.device
    i0 = int(min(range(ns), key=lambda i: shifts[i]))
    sig0 = float(shifts[i0])
    dsig = torch.tensor([float(s) - sig0 for s in shifts], dtype=f64,
                        device=dev)
    bshape = (ns,) + (1,) * b.dim()

    def op(v):
        return base_op(v) + sig0 * v

    def scal(v):          # per-shift float64 scalars -> b's dtype
        return v.reshape(bshape).to(b.dtype)

    b2 = float(linalg.norm2(b, dtype=f64))
    stop = r2req * b2
    one = torch.ones(ns, dtype=f64, device=dev)
    x = torch.zeros((ns,) + b.shape, dtype=b.dtype, device=dev)
    ps = b.expand((ns,) + b.shape).clone()
    p, r = b, b
    rho = linalg.norm2(r, dtype=f64)
    zeta, zeta_old = one, one
    a_old = torch.ones((), dtype=f64, device=dev)
    b_old = torch.zeros((), dtype=f64, device=dev)
    k = 0
    worst = float((zeta * zeta).max() * rho)
    while worst > stop and k < maxits:
        ap = op(p)
        alpha = rho / linalg.redot(p, ap, dtype=f64)
        # shifted coefficient recurrences (Jegerlehner eqs. 2.42-2.44)
        denom = (alpha * b_old * (zeta_old - zeta)
                 + zeta_old * a_old * (one + dsig * alpha))
        zeta_new = torch.where(denom != 0.0,
                               zeta * zeta_old * a_old / denom, 0.0)
        ratio = torch.where(zeta != 0.0, zeta_new / zeta, 0.0)
        x = x + scal(alpha * ratio) * ps
        r = r - alpha.to(b.dtype) * ap
        rho_new = linalg.norm2(r, dtype=f64)
        beta = rho_new / rho
        p = r + beta.to(b.dtype) * p
        ps = scal(zeta_new) * r + scal(beta * ratio * ratio) * ps
        rho, zeta_old, zeta, a_old, b_old = rho_new, zeta, zeta_new, \
            alpha, beta
        k += 1
        worst = float((zeta * zeta).max() * rho)
    return [x[i] for i in range(ns)], SolverStats(iterations=k,
                                                  r2=worst / b2)
