"""Multishift (multi-mass) conjugate gradient (port of
``qex_tpu.solvers.cgm``: ``cg_multishift`` and ``cg_multishift_refined``).

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

from .base import LOCAL, Reductions, SolverStats


def cg_multishift(base_op: Callable[[torch.Tensor], torch.Tensor],
                  b: torch.Tensor, shifts: Sequence[float], *,
                  r2req: float = 1e-12, maxits: int = 2000,
                  dots: Reductions = LOCAL
                  ) -> tuple[list[torch.Tensor], SolverStats]:
    """Shifted CG: returns [x_i] with (A + sigma_i) x_i = b.

    Iterates until max_i |zeta_i r|^2 <= r2req |b|^2 or maxits; every
    shift must be >= 0 and A positive semi-definite (the staggered
    normal operator); ``dots`` takes the global sums (``cg.cg_solve``)."""
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

    b2 = float(dots.norm2(b, dtype=f64))
    stop = r2req * b2
    one = torch.ones(ns, dtype=f64, device=dev)
    x = torch.zeros((ns,) + b.shape, dtype=b.dtype, device=dev)
    ps = b.expand((ns,) + b.shape).clone()
    p, r = b, b
    rho = dots.norm2(r, dtype=f64)
    zeta, zeta_old = one, one
    a_old = torch.ones((), dtype=f64, device=dev)
    b_old = torch.zeros((), dtype=f64, device=dev)
    k = 0
    worst = float((zeta * zeta).max() * rho)
    while worst > stop and k < maxits:
        ap = op(p)
        alpha = rho / dots.redot(p, ap, dtype=f64)
        # shifted coefficient recurrences (Jegerlehner eqs. 2.42-2.44)
        denom = (alpha * b_old * (zeta_old - zeta)
                 + zeta_old * a_old * (one + dsig * alpha))
        zeta_new = torch.where(denom != 0.0,
                               zeta * zeta_old * a_old / denom, 0.0)
        ratio = torch.where(zeta != 0.0, zeta_new / zeta, 0.0)
        x = x + scal(alpha * ratio) * ps
        r = r - alpha.to(b.dtype) * ap
        rho_new = dots.norm2(r, dtype=f64)
        beta = rho_new / rho
        p = r + beta.to(b.dtype) * p
        ps = scal(zeta_new) * r + scal(beta * ratio * ratio) * ps
        rho, zeta_old, zeta, a_old, b_old = rho_new, zeta, zeta_new, \
            alpha, beta
        k += 1
        worst = float((zeta * zeta).max() * rho)
    return [x[i] for i in range(ns)], SolverStats(iterations=k,
                                                  r2=worst / b2)


def cg_multishift_refined(base_sloppy: Callable[[torch.Tensor], torch.Tensor],
                          base_true: Callable[[torch.Tensor], torch.Tensor],
                          b: torch.Tensor, shifts: Sequence[float], *,
                          r2req: float = 1e-12, maxits: int = 2000,
                          sloppy_r2req: float = 1e-8,
                          refine_restarts: int = 2,
                          dots: Reductions = LOCAL
                          ) -> tuple[list[torch.Tensor], SolverStats]:
    """Mixed-precision multishift: one joint pass on ``base_sloppy`` to
    max(r2req, sloppy_r2req), then per-shift defect correction against
    ``base_true``.

    The shifted iterates share one Krylov space, so the joint pass
    cannot restart; each shift is refined after it by
    ``cg_solve_restarted`` with the sloppy operator inside true-residual
    restarts, its inner floor at ``sloppy_r2req`` (the sloppy operator's
    achievable residual).  Where the two operators differ, a closure on
    the true operator aimed at the original system's absolute target
    (``stop2 = r2req |b|^2``) follows; it does no iteration where the
    sloppy refinement already met it.  Two monotone guards keep a stage
    that made a shift's defect worse from poisoning the next: the joint
    pass's x_i is dropped if its defect exceeds |b|, and the sloppy
    correction if it grew the defect.  ``r2`` is the worst shift's true
    relative residual on ``base_true``; ``dots`` as in
    :func:`cg_multishift`."""
    from . import cg as cgmod

    xs, st0 = cg_multishift(base_sloppy, b, shifts,
                            r2req=max(r2req, sloppy_r2req), maxits=maxits,
                            dots=dots)
    # the defect after the joint pass is ~sloppy_r2req |b|^2, so this
    # relative target lands the final residual at ~r2req |b|^2 with a
    # decade to spare
    r2_ref = min(1.0, 0.1 * r2req / max(r2req, sloppy_r2req))
    total = st0.iterations
    out, worst = [], 0.0
    b2 = float(dots.norm2(b))
    for i, s in enumerate(shifts):
        def op_t(v, s=s):
            return base_true(v) + s * v

        def op_s(v, s=s):
            return base_sloppy(v) + s * v

        d = b - op_t(xs[i])
        if float(dots.norm2(d)) > b2:
            xs[i], d = torch.zeros_like(b), b
        e, sti = cgmod.cg_solve_restarted(
            op_s, d, r2req=r2_ref, maxits=maxits, restarts=refine_restarts,
            op_true=op_t, inner_r2req_floor=max(r2_ref * 0.1, sloppy_r2req),
            dots=dots)
        xi = xs[i] + e
        total += sti.iterations
        if base_sloppy is not base_true:
            # refinement with a sloppy inner operator converges only
            # while eps_sloppy * kappa(A + s) < 1; the true-operator
            # closure finishes the shifts where it stalled
            d2 = b - op_t(xi)
            if float(dots.norm2(d2)) > float(dots.norm2(d)):
                xi, d2 = xs[i], d
            e2, st2 = cgmod.cg_solve_restarted(
                op_t, d2, r2req=r2_ref, maxits=maxits,
                restarts=refine_restarts, stop2=r2req * b2, dots=dots)
            xi = xi + e2
            total += st2.iterations
        out.append(xi)
        worst = max(worst, float(dots.norm2(b - op_t(xi))) / b2)
    return out, SolverStats(iterations=total, r2=worst)
