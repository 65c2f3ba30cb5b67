"""Ensemble quasi-Newton (L-BFGS-style) preconditioned HMC (port of
``qex_tpu.hmc.qnhmc``; QEX src/examples/puregauge2du1qn.nim).

The HMC mass matrix M is the DFP direct-Hessian approximation built
from difference pairs (s_k = x_{k+1} - x_k, y_k = f_{k+1} - f_k) taken
across an ensemble of streams sampling one distribution:

    M_k = W_k^T M_{k-1} W_k + rho_k y_k y_k^T,
    W_k = I - rho_k s_k y_k^T,    rho_k = 1/(y_k . s_k),

applied without matrices: ``apply_m`` runs the recursion, ``apply_minv``
the DFP inverse expansion H_k = H_{k-1} + rho_k s_k s_k^T
- c_k w_k w_k^T (w_k = H_{k-1} y_k, c_k = 1/(y_k . w_k), prepared once
per trajectory by :func:`qn_prep`), and ``push_noise`` draws p ~ N(0, M)
with no square root: q_k = W_k^T q_{k-1} + sqrt(rho_k) z_k y_k.

The ring buffer keeps the JAX package's semantics: ``qn_add`` writes
slot ``pos % m`` and advances ``pos``, ``qn_set`` writes a given slot
and leaves ``pos``; a pair with y.s <= cutoff is stored invalid, and
``qn_prep`` consumes slots oldest first from ``pos`` and drops the
slots ``exclude`` names.  Dots are global sums in the field's dtype
(the app runs float64 fields); the loops over pairs are host loops of
0-d tensors, with no host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from . import hmc as _hmc


@dataclasses.dataclass(frozen=True)
class QNState:
    """Ring buffer of difference pairs (stacked leading axis m)."""

    s: torch.Tensor          # (m, *field)
    y: torch.Tensor          # (m, *field), already yscale-scaled
    valid: torch.Tensor      # (m,) bool
    pos: int                 # next write slot of qn_add
    h0: float = 1.0

    @property
    def m(self) -> int:
        return self.s.shape[0]


def qn_init(m: int, field_shape, h0: float = 1.0,
            dtype: torch.dtype = torch.float64, device=None) -> QNState:
    z = torch.zeros((m,) + tuple(field_shape), dtype=dtype, device=device)
    return QNState(z, z.clone(), torch.zeros((m,), dtype=torch.bool,
                                             device=device), 0, h0)


def _pair(st: QNState, i: int, x_prev, f_prev, x_new, f_new, yscale,
          cutoff):
    s = x_new - x_prev
    y = yscale * (f_new - f_prev)
    ss, yy, valid = st.s.clone(), st.y.clone(), st.valid.clone()
    ss[i], yy[i] = s, y
    valid[i] = (s * y).sum() > cutoff
    return ss, yy, valid


def qn_add(st: QNState, x_prev, f_prev, x_new, f_new,
           yscale: float = 1.0, cutoff: float = 0.0) -> QNState:
    """Push (s, y) = (x_new - x_prev, yscale (f_new - f_prev)) into slot
    pos % m; a pair with y.s <= cutoff is stored invalid
    (puregauge2du1qn.nim ``add`` :231-282)."""
    ss, yy, valid = _pair(st, st.pos % st.m, x_prev, f_prev, x_new, f_new,
                          yscale, cutoff)
    return QNState(ss, yy, valid, st.pos + 1, st.h0)


def qn_set(st: QNState, slot: int, x_prev, f_prev, x_new, f_new,
           yscale: float = 1.0, cutoff: float = 0.0) -> QNState:
    """Store the pair in ring slot ``slot % m`` ("item k has the
    difference between k and k+1", puregauge2du1qn.nim:434-436)."""
    ss, yy, valid = _pair(st, slot % st.m, x_prev, f_prev, x_new, f_new,
                          yscale, cutoff)
    return QNState(ss, yy, valid, st.pos, st.h0)


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).reshape(a.shape[0], -1).sum(1)


@dataclasses.dataclass(frozen=True)
class QNOps:
    """Prepared per-trajectory operator set."""

    s: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor          # w_k = H_{k-1} y_k
    rho: torch.Tensor        # masked 1/(y.s)
    c: torch.Tensor          # masked 1/(y.w)
    h0: float

    def apply_minv(self, v: torch.Tensor) -> torch.Tensor:
        """M^{-1} v (DFP inverse-Hessian expansion)."""
        sv = _dots(self.s, v.expand_as(self.s))
        wv = _dots(self.w, v.expand_as(self.w))
        corr = (torch.tensordot(self.rho * sv, self.s, dims=1)
                - torch.tensordot(self.c * wv, self.w, dims=1))
        return v / self.h0 + corr

    def apply_m(self, v: torch.Tensor) -> torch.Tensor:
        """M v by the product-form recursion (down W, scale, up W^T +
        rank-1)."""
        m = self.s.shape[0]
        a = []
        for k in range(m - 1, -1, -1):
            yv = (self.y[k] * v).sum()
            a.append(yv)
            v = v - self.rho[k] * self.s[k] * yv
        v = self.h0 * v
        for k in range(m):
            yv = a[m - 1 - k]
            v = (v - self.rho[k] * self.y[k] * (self.s[k] * v).sum()
                 + self.rho[k] * self.y[k] * yv)
        return v

    def push_noise(self, q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """q_m = L [q; z] with cov(q_m) = M from cov(q) = h0 I and
        z ~ N(0, I_m): one W^T and rank-1 injection per pair, oldest
        first."""
        for k in range(self.s.shape[0]):
            q = (q - self.rho[k] * self.y[k] * (self.s[k] * q).sum()
                 + torch.sqrt(self.rho[k]) * z[k] * self.y[k])
        return q

    def kinetic(self, p: torch.Tensor) -> torch.Tensor:
        return 0.5 * (p * self.apply_minv(p)).sum()


def qn_prep(st: QNState, exclude: torch.Tensor | None = None,
            damp: float = 0.2) -> QNOps:
    """The per-trajectory operator scalars (the reference ``prep``
    :433-520), pairs in ring order oldest first.  Invalid pairs get
    rho = c = 0.  ``exclude`` (m,) bool in ring-slot order drops the
    pairs of the stream being updated (detailed balance).  ``damp`` is
    Powell's damping threshold sigma: where s.y < sigma s.(M_{k-1} s), y
    is blended toward M_{k-1} s so that M never shrinks below sigma of
    its previous value along s; damp = 0 is the raw update."""
    m = st.m
    dev = st.s.device
    order = (st.pos + torch.arange(m, device=dev)) % m
    s = st.s[order]
    y0 = st.y[order]
    valid = st.valid[order]
    if exclude is not None:
        valid = valid & ~exclude.to(dev)[order]
    zero = torch.zeros((), dtype=s.dtype, device=dev)
    one = torch.ones((), dtype=s.dtype, device=dev)

    def apply_partial_m(k, ys_list, rho_list, v):
        """M_{k-1} v by the recursion over pairs < k (damped y rows)."""
        a = []
        for j in range(k - 1, -1, -1):
            yv = (ys_list[j] * v).sum()
            a.append(yv)
            v = v - rho_list[j] * s[j] * yv
        v = st.h0 * v
        for j in range(k):
            yv = a[k - 1 - j]
            v = (v - rho_list[j] * ys_list[j] * (s[j] * v).sum()
                 + rho_list[j] * ys_list[j] * yv)
        return v

    y_rows, rho_rows, w_rows, c_rows = [], [], [], []
    for k in range(m):
        yk = y0[k]
        if damp > 0.0:
            bs = apply_partial_m(k, y_rows, rho_rows, s[k])
            s_bs = (s[k] * bs).sum()
            s_y = (s[k] * yk).sum()
            need = s_y < damp * s_bs
            theta = torch.where(
                need, (1.0 - damp) * s_bs / torch.where(need, s_bs - s_y,
                                                        one), one)
            yk = theta * yk + (1.0 - theta) * bs
        ysk = (s[k] * yk).sum()
        ok = valid[k] & (ysk > 0.0)
        rhok = torch.where(ok, 1.0 / torch.where(ok, ysk, one), zero)
        yk = torch.where(ok, yk, zero)
        y_rows.append(yk)
        rho_rows.append(rhok)
        # w_k = H_{k-1} y_k with H_{k-1} built from pairs < k
        v = yk / st.h0
        for j in range(k):
            v = (v + rho_rows[j] * (s[j] * yk).sum() * s[j]
                 - c_rows[j] * (w_rows[j] * yk).sum() * w_rows[j])
        yw = (yk * v).sum()
        c_rows.append(torch.where(ok, 1.0 / torch.where(ok, yw, one), zero))
        w_rows.append(torch.where(ok, v, zero))
    vb = valid.reshape((m,) + (1,) * (s.dim() - 1))
    return QNOps(torch.where(vb, s, zero), torch.stack(y_rows),
                 torch.stack(w_rows), torch.stack(rho_rows),
                 torch.stack(c_rows), st.h0)


def qn_hmc_step_from(x: torch.Tensor, q: torch.Tensor, z: torch.Tensor,
                     r: float, ops: QNOps,
                     action_fn: Callable[[torch.Tensor], torch.Tensor],
                     grad_fn: Callable[[torch.Tensor], torch.Tensor],
                     tau: float, steps: int,
                     mask: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, dict[str, Any]]:
    """One leapfrog HMC trajectory with mass matrix M = ops, from the
    standard normal field ``q``, the (m,) standard normals ``z`` (p =
    push_noise(sqrt(h0) q, z)) and the Metropolis uniform ``r``.
    ``mask``: frozen components (maximal-tree links), where momenta and
    forces vanish.  H is taken in float64."""
    p = ops.push_noise(math.sqrt(ops.h0) * q, z)
    if mask is not None:
        p = torch.where(mask, 0.0, p)

    def grad(xx):
        g = grad_fn(xx)
        return torch.where(mask, 0.0, g) if mask is not None else g

    def h(xx, pp):
        return float(action_fn(xx).to(torch.float64)
                     + ops.kinetic(pp).to(torch.float64))

    h0 = h(x, p)
    dt = tau / steps
    xx, pp = x, p
    for _ in range(steps):
        xx = xx + (0.5 * dt) * ops.apply_minv(pp)
        pp = pp - dt * grad(xx)
        xx = xx + (0.5 * dt) * ops.apply_minv(pp)
    dh = h(xx, pp) - h0
    acc = _hmc.metropolis(dh, r)
    return (xx if acc else x), {"dH": dh, "accept": acc}


def draw_qn(gen: torch.Generator, shape, m: int, dtype: torch.dtype
            ) -> tuple[torch.Tensor, torch.Tensor, float]:
    """(q, z, r): the normal field and pair normals of ``push_noise`` and
    the Metropolis uniform, on ``gen``'s device."""
    kw = dict(generator=gen, dtype=dtype, device=gen.device)
    q = torch.randn(tuple(shape), **kw)
    z = torch.randn((m,), **kw)
    return q, z, _hmc.draw_uniform(gen)


def qn_hmc_step(gen: torch.Generator, x: torch.Tensor, ops: QNOps,
                action_fn, grad_fn, tau: float, steps: int,
                mask: torch.Tensor | None = None):
    q, z, r = draw_qn(gen, x.shape, ops.s.shape[0], x.dtype)
    return qn_hmc_step_from(x, q, z, r, ops, action_fn, grad_fn, tau, steps,
                            mask)
