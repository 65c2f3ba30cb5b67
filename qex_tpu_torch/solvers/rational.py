"""Near-minimax rational approximations of x^(p/q) in pole-residue form
(port of ``qex_tpu.solvers.rational``: ``RationalApprox`` and the cached
``rational_approx``).

    x^(p/q)  ~=  c0 + sum_i  r_i / (x + s_i)     on [lo, hi]

is what the multishift CG consumes: r(A) b costs one Krylov space.  The
approximation is computed on demand by AAA (Nakatsukasa, Sete &
Trefethen, SIAM J. Sci. Comput. 2018; ``scipy.interpolate.AAA``) on a
dense log-spaced grid, with the same inputs as the JAX package, so both
get the same coefficients.  Its poles come out real and negative, so the
shifts s_i = -pole_i are positive and every shifted system A + s_i stays
positive definite.

Rooted staggered HMC uses it: S = phi^dag A^{-nf/4} phi with
A = m^2 - D_eo D_oe; the heatbath needs A^{+nf/8}, the MD A^{-nf/4}.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable

import numpy as np
import torch

from .base import SolverStats


@dataclasses.dataclass(frozen=True)
class RationalApprox:
    """Partial-fraction rational approximation on [lo, hi]:
    r(x) = c0 + sum_i residues_i / (x + poles_i), poles_i > 0."""

    power_num: int
    power_den: int
    lo: float
    hi: float
    degree: int
    c0: float
    residues: tuple[float, ...]
    poles: tuple[float, ...]
    max_rel_err: float

    def __call__(self, x):
        x = np.asarray(x, dtype=float)
        acc = np.full_like(x, self.c0)
        for r, p in zip(self.residues, self.poles):
            acc = acc + r / (x + p)
        return acc

    def apply(self, base_op: Callable[[torch.Tensor], torch.Tensor],
              b: torch.Tensor, *, r2req: float = 1e-12, maxits: int = 2000,
              dots=None) -> tuple[torch.Tensor, SolverStats]:
        """r(A) b by one multishift CG on the positive semi-definite
        operator ``base_op``; the poles become the shifts.  ``dots``
        takes the global sums (``cgm.cg_multishift``)."""
        from . import cgm
        from .base import LOCAL
        xs, stats = cgm.cg_multishift(base_op, b, list(self.poles),
                                      r2req=r2req, maxits=maxits,
                                      dots=dots or LOCAL)
        acc = self.c0 * b
        for r, x in zip(self.residues, xs):
            acc = acc + r * x
        return acc, stats


@functools.lru_cache(maxsize=64)
def rational_approx(power_num: int, power_den: int, lo: float, hi: float,
                    degree: int = 16, tol: float = 1e-13) -> RationalApprox:
    """Near-minimax r(x) ~= x^(power_num/power_den) on [lo, hi] (cached).

    ``degree`` caps the number of poles; AAA stops earlier when ``tol``
    (relative) is reached.  ``max_rel_err`` is the achieved relative
    error on the fitting grid."""
    from scipy.interpolate import AAA

    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got [{lo}, {hi}]")
    power = power_num / power_den
    x = np.logspace(np.log10(lo), np.log10(hi), 4000)
    f = x ** power
    with warnings.catch_warnings():
        # reaching max_terms before rtol is fine: max_rel_err says what
        # was achieved
        warnings.simplefilter("ignore", RuntimeWarning)
        r = AAA(x, f, rtol=float(tol), max_terms=degree + 1)

    poles = r.poles()
    residues = r.residues()
    if np.abs(poles.imag).max(initial=0.0) > 1e-10 * np.abs(
            poles.real).min(initial=1.0):
        raise RuntimeError(f"AAA produced complex poles for x^{power}")
    if poles.real.max(initial=-1.0) >= 0:
        raise RuntimeError(f"AAA produced a non-negative pole for "
                           f"x^{power}: {poles.real.max()}")
    # the constant term: the barycentric form's limit at infinity
    w = r.weights
    c0 = float(np.real(np.sum(w * r.support_values) / np.sum(w)))
    shifts = tuple(float(-p) for p in poles.real)
    res = tuple(float(np.real(ri)) for ri in residues)
    order = np.argsort(shifts)
    shifts = tuple(shifts[i] for i in order)
    res = tuple(res[i] for i in order)

    ra = RationalApprox(power_num, power_den, lo, hi, len(shifts), c0,
                        res, shifts, 0.0)
    rel = np.abs(ra(x) / f - 1.0).max()
    return dataclasses.replace(ra, max_rel_err=float(rel))
