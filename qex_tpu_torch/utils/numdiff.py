"""Richardson-extrapolated numerical differentiation (Ridders 1982)
(port of ``qex_tpu.utils.numdiff``; QEX src/algorithms/numdiff.nim,
ndiff :55, ndiff2 :63).

f'(x) and f''(x) by Neville extrapolation of central differences with a
geometrically shrinking step: an independent numerical oracle for
analytic or autograd forces, and a way to differentiate observables
known only as black-box scalars.  ``f`` may return a number, a tensor or
a tuple of them; ``x`` is the scalar abscissa.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _scale_add(a, sa, b, sb):
    if isinstance(a, (tuple, list)):
        return type(a)(_scale_add(x, sa, y, sb) for x, y in zip(a, b))
    return sa * a + sb * b


def _max_absdiff(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max((_max_absdiff(x, y) for x, y in zip(a, b)), default=0.0)
    d = a - b
    return float(d.abs().max()) if isinstance(d, torch.Tensor) else abs(d)


def _ridders(samples, scale):
    """Neville extrapolation over samples A[i] taken at step dx/scale**i;
    (limit, err) with err = max |limit - last two column entries|
    (numdiff.nim ndiffTemplate parity)."""
    a = list(samples)
    n = len(a)
    s2 = scale * scale
    b = s2
    for j in range(n - 1, 1, -1):
        c = 1.0 / (b - 1.0)
        for i in range(j):
            a[i] = _scale_add(a[i + 1], b * c, a[i], -c)
        b *= s2
    c = 1.0 / (b - 1.0)
    r = _scale_add(a[1], b * c, a[0], -c)
    err = max(_max_absdiff(r, a[0]), _max_absdiff(r, a[1]))
    return r, err


def ndiff(f: Callable, x: float, dx: float, scale: float = 2.0,
          ord_max: int = 8) -> Tuple[object, float]:
    """(f'(x), error estimate) by extrapolated central differences
    (numdiff.nim:55-61)."""
    samples = []
    h = float(dx)
    for _ in range(ord_max):
        fp, fm = f(x + h), f(x - h)
        samples.append(_scale_add(fp, 0.5 / h, fm, -0.5 / h))
        h /= scale
    return _ridders(samples, scale)


def ndiff2(f: Callable, x: float, dx: float, scale: float = 2.0,
           ord_max: int = 8) -> Tuple[object, float]:
    """(f''(x), error estimate) by extrapolated second differences
    (numdiff.nim ndiff2 :63)."""
    f0 = f(x)
    samples = []
    h = float(dx)
    for _ in range(ord_max):
        fp, fm = f(x + h), f(x - h)
        s = _scale_add(fp, 1.0 / (h * h), fm, 1.0 / (h * h))
        s = _scale_add(s, 1.0, f0, -2.0 / (h * h))
        samples.append(s)
        h /= scale
    return _ridders(samples, scale)
