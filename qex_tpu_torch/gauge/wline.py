"""Wilson lines and loops with shared sub-segments (port of
``qex_tpu.gauge.wline``).

A :class:`PathEngine` memoises every sub-segment's matrix field, and its
shifted copies, for the life of the engine, so loop families (the four
clover leaves, rectangles, Polyakov-line powers) reuse each other's
halves.  A line is built by binary splitting,

    W(p)(x) = W(p_left)(x) W(p_right)(x + disp(p_left)),

so its depth is logarithmic in the path length.

Path convention (QEX ``wline``): entries +-(mu+1); +1 is one hop in +x,
-3 one hop in -z.
"""

from __future__ import annotations

import torch

from ..lattice import Lattice
from ..ops import linalg
from ..ops.shifts import shift
from ..parallel.halo import site_sum


def path_displacement(path: tuple[int, ...], nd: int) -> tuple[int, ...]:
    """Net lattice displacement of a path."""
    d = [0] * nd
    for step in path:
        mu = abs(step) - 1
        d[mu] += 1 if step > 0 else -1
    return tuple(d)


class PathEngine:
    """Memoising Wilson-line maker over one gauge field."""

    def __init__(self, lat: Lattice, u: torch.Tensor):
        self.lat = lat
        self.u = u
        self._lines: dict = {}
        self._shifted: dict = {}

    def _shift_by(self, key, arr: torch.Tensor, disp: tuple[int, ...]
                  ) -> torch.Tensor:
        """arr(x + disp), memoised on (segment, disp)."""
        if all(d == 0 for d in disp):
            return arr
        ck = (key, disp)
        if ck not in self._shifted:
            out = arr
            for mu, d in enumerate(disp):
                if d:
                    out = shift(out, mu, +1 if d > 0 else -1,
                                self.lat.nd, dist=abs(d))
            self._shifted[ck] = out
        return self._shifted[ck]

    def line(self, path) -> torch.Tensor:
        """Untraced Wilson-line matrix field along ``path``:
        W(x) = L_{p1}(x) L_{p2}(x + d1) ... with L_{+mu}(x) = U_mu(x),
        L_{-mu}(x) = U_mu(x - mu)^dag."""
        path = tuple(int(s) for s in path)
        for step in path:
            if step == 0 or abs(step) > self.lat.nd:
                raise ValueError(
                    f"bad path step {step}: expected +-(mu+1) with "
                    f"mu < nd={self.lat.nd}")
        if not path:
            n = self.lat.nc
            ident = torch.eye(n, dtype=self.u.dtype, device=self.u.device)
            return ident.reshape((n, n) + (1,) * self.lat.nd).expand(
                (n, n) + tuple(self.u.shape[-self.lat.nd:]))
        if path in self._lines:
            return self._lines[path]
        if len(path) == 1:
            step = path[0]
            mu = abs(step) - 1
            if step > 0:
                w = self.u[mu]
            else:
                w = shift(linalg.adj(self.u[mu]), mu, -1, self.lat.nd)
        else:
            k = len(path) // 2
            a, b = path[:k], path[k:]
            wb = self._shift_by(b, self.line(b),
                                path_displacement(a, self.lat.nd))
            w = linalg.mul(self.line(a), wb)
        self._lines[path] = w
        return w

    def loop_trace(self, path) -> torch.Tensor:
        """Volume-averaged Re tr / nc of the (closed or open) line, a
        float64 scalar."""
        w = self.line(path)
        return (site_sum(linalg.re_trace(w))
                / (self.lat.nc * self.lat.volume))

    def rect_path(self, mu: int, nu: int, r: int, t: int
                  ) -> tuple[int, ...]:
        """R x T rectangle in the (mu, nu) plane starting at x."""
        return ((mu + 1,) * r + (nu + 1,) * t
                + (-(mu + 1),) * r + (-(nu + 1),) * t)

    def wilson_loop(self, mu: int, nu: int, r: int, t: int
                    ) -> torch.Tensor:
        """Averaged R x T Wilson loop."""
        return self.loop_trace(self.rect_path(mu, nu, r, t))

    def clover_leaves(self, mu: int, nu: int) -> torch.Tensor:
        """Sum of the four plaquette leaves around x in the (mu, nu)
        plane, all built from the same cached single-link segments."""
        pmu, pnu = mu + 1, nu + 1
        paths = [(pmu, pnu, -pmu, -pnu), (pnu, -pmu, -pnu, pmu),
                 (-pmu, -pnu, pmu, pnu), (-pnu, pmu, pnu, -pmu)]
        total = None
        for p in paths:
            w = self.line(p)
            total = w if total is None else total + w
        return total

    def stats(self) -> dict:
        return {"segments": len(self._lines),
                "shifted": len(self._shifted)}
