"""Cubic-spline interpolation with natural or clamped ends (port of
``qex_tpu.utils.spline``; QEX src/algorithms/cspline.nim).

The second derivatives come from a host Thomas solve on the knots; the
spline, its derivative and its root (by bisection) are evaluated with
torch ops on the knots' device.  Used to interpolate flow observables
(t^2 E(t) -> t0, w0) and tuning curves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve


def estimate_derivative(dx, dy) -> float:
    """Derivative at a point from 1-3 forward differences (dx[i], dy[i]
    relative to that point) by Taylor-series elimination
    (cspline.nim:6-24)."""
    dx = [float(v) for v in dx]
    dy = [float(v) for v in dy]
    n = len(dx)
    if n == 1:
        return dy[0] / dx[0]
    if n == 2:
        h10 = dx[1] - dx[0]
        return dy[0] * dx[1] / (dx[0] * h10) - dx[0] * dy[1] / (h10 * dx[1])
    if n == 3:
        h10 = dx[1] - dx[0]
        h02 = dx[0] - dx[2]
        h21 = dx[2] - dx[1]
        a = dy[0] * dx[1] * dx[2] / (dx[0] * h10 * h02)
        b = dx[0] * dy[1] * dx[2] / (dx[1] * h10 * h21)
        c = dx[0] * dx[1] * dy[2] / (dx[2] * h02 * h21)
        return -(a + b + c)
    raise ValueError(f"estimate_derivative: need 1-3 points, got {n}")


@dataclasses.dataclass(frozen=True)
class CSpline:
    """Cubic spline through knots (x, y) with second derivatives y2."""

    x: torch.Tensor
    y: torch.Tensor
    y2: torch.Tensor

    def _interval(self, t):
        t = torch.as_tensor(t, dtype=self.x.dtype, device=self.x.device)
        i = torch.clamp(torch.searchsorted(self.x, t, right=True) - 1,
                        0, self.x.shape[0] - 2)
        xl, xh = self.x[i], self.x[i + 1]
        h = xh - xl
        return i, h, (xh - t) / h, (t - xl) / h

    def __call__(self, t):
        """The spline at t (scalar or tensor); clamps to the knot
        range."""
        i, h, a, b = self._interval(t)
        return (a * self.y[i] + b * self.y[i + 1]
                + ((a ** 3 - a) * self.y2[i] + (b ** 3 - b) * self.y2[i + 1])
                * (h * h) / 6.0)

    def deriv(self, t):
        """First derivative of the spline at t."""
        i, h, a, b = self._interval(t)
        return ((self.y[i + 1] - self.y[i]) / h
                + ((3.0 * b * b - 1.0) * self.y2[i + 1]
                   - (3.0 * a * a - 1.0) * self.y2[i]) * h / 6.0)

    def solve(self, target, lo=None, hi=None, iters: int = 60):
        """x with spline(x) == target by ``iters`` bisections on [lo, hi]
        (the t0 / w0 scale-setting use)."""
        def as_t(v, default):
            return default if v is None else torch.as_tensor(
                v, dtype=self.x.dtype, device=self.x.device)
        a, b = as_t(lo, self.x[0]), as_t(hi, self.x[-1])
        rising = self(b) > self(a)
        for _ in range(iters):
            m = 0.5 * (a + b)
            fm = self(m)
            below = torch.where(rising, fm < target, fm > target)
            a, b = torch.where(below, m, a), torch.where(below, b, m)
        return 0.5 * (a + b)


def cspline(x, y, dy_lo: float | None = None, dy_hi: float | None = None,
            device=None) -> CSpline:
    """A cubic spline with natural ends (y'' = 0) by default, clamped
    (given first derivative) where dy_lo / dy_hi is set (cspline.nim
    CSplineBounds: CSBZeroD2y / CSBSetDy); float64 knots on ``device``
    (default: the card)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.size
    if n < 3:
        raise ValueError("cspline needs >= 3 knots")
    if np.any(np.diff(x) <= 0):
        raise ValueError("cspline knots must be strictly increasing")
    y2 = np.zeros(n)
    u = np.zeros(n)
    if dy_lo is not None:
        y2[0] = -0.5
        u[0] = (3.0 / (x[1] - x[0])) * ((y[1] - y[0]) / (x[1] - x[0])
                                        - float(dy_lo))
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        u[i] = ((y[i + 1] - y[i]) / (x[i + 1] - x[i])
                - (y[i] - y[i - 1]) / (x[i] - x[i - 1]))
        u[i] = (6.0 * u[i] / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    if dy_hi is None:
        qn, un = 0.0, 0.0
    else:
        qn = 0.5
        un = (3.0 / (x[-1] - x[-2])) * (float(dy_hi)
                                        - (y[-1] - y[-2]) / (x[-1] - x[-2]))
    y2[-1] = (un - qn * u[-2]) / (qn * y2[-2] + 1.0)
    for i in range(n - 2, -1, -1):
        y2[i] = y2[i] * y2[i + 1] + u[i]
    dev = resolve(device)
    return CSpline(*(torch.from_numpy(a).to(dev) for a in (x, y, y2)))
