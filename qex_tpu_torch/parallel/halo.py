"""Halo exchange and global sums on a rank mesh (port of
``qex_tpu.parallel.halo``; QEX's ShiftB halo pipeline,
src/layout/shifts.nim:67-286, and ``qmpSum``).

Every function takes this rank's block of a field (``parallel.mesh``):
site-tensor axes leading, the block's lattice axes trailing.  A shift is
a local roll plus, along a split direction, one face exchange with the
neighbouring ranks; a global sum is a float64 sum over the block
all-reduced over the group, so that the sum's value does not depend on
how the lattice is split beyond float64 rounding.

Both are ``torch.autograd.Function``s in the ``setup_context`` form, so
that autograd, ``torch.func.grad`` and ``torch.func.jvp`` pass them (a
collective inside a plain function would meet the transforms' wrapped
tensors).  The backward of a shift is the opposite shift of the
gradient, made of the same Function, so it exchanges its own face and is
itself differentiable (the exact force-gradient kick differentiates a
force, and the solves' implicit backwards differentiate inside a
backward); its jvp is the same shift of the tangent.  The backward of a
global sum is the identity: each rank seeds its own partial sum with 1,
and the backward exchanges of the shifts carry the neighbours' share of
the gradient to the links they read (``torch.distributed.nn``'s
all-reduce would all-reduce the gradient again, multiplying every force
by the number of ranks).  Every rank enters each exchange and each sum
in the same order, forward and backward: nothing here branches on data
that one rank holds.
"""

from __future__ import annotations

import torch

from ..ops import linalg
from ..solvers.base import Reductions
from .mesh import LatticeMesh, active


def _roll_block(f: torch.Tensor, lm: LatticeMesh, mu: int, k: int,
                axis: int) -> torch.Tensor:
    """result[i] = f[i + k] along ``axis`` of the global field, on
    blocks: a local roll whose wrapped |k| planes come from the
    neighbour along mu (its first planes for k > 0, its last for k < 0)."""
    rolled = torch.roll(f, -k, axis)
    if k == 0 or lm.rank_geom[mu] == 1:
        return rolled
    n, d = f.shape[axis], abs(k)
    if d > n:
        raise ValueError(f"halo depth {d} > local extent {n} along "
                         f"direction {mu}: a shift reaches only the "
                         "neighbouring block")
    if k > 0:
        rolled.narrow(axis, n - d, d).copy_(
            lm.exchange_one(mu, f.narrow(axis, 0, d), +1))
    else:
        rolled.narrow(axis, 0, d).copy_(
            lm.exchange_one(mu, f.narrow(axis, n - d, d), -1))
    return rolled


class _Roll(torch.autograd.Function):
    """:func:`_roll_block` with the opposite roll as its backward and
    the same roll as its jvp (see the module docstring)."""

    @staticmethod
    def forward(f, lm, mu, k, axis):
        return _roll_block(f, lm, mu, k, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _f, ctx.lm, ctx.mu, ctx.k, ctx.axis = inputs

    @staticmethod
    def backward(ctx, g):
        return _Roll.apply(g, ctx.lm, ctx.mu, -ctx.k, ctx.axis), \
            None, None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _Roll.apply(t, ctx.lm, ctx.mu, ctx.k, ctx.axis)


def roll_halo(lm: LatticeMesh, f: torch.Tensor, mu: int, k: int,
              axis: int) -> torch.Tensor:
    """result[i] = f[i + k] along tensor axis ``axis``, which runs along
    lattice direction mu (in the full layout the mu-th lattice axis; in
    the eo and fast layouts t is the packed axis), on this rank's blocks
    of ``lm``; |k| may not exceed the local extent of a split axis.
    Differentiable (module docstring)."""
    if lm.rank_geom[mu] == 1:
        return torch.roll(f, -k, axis)
    return _Roll.apply(f, lm, mu, k, axis % f.dim())


def shift_halo(lm: LatticeMesh, f: torch.Tensor, mu: int, sign: int,
               dist: int = 1) -> torch.Tensor:
    """result[x] = f[x + sign*dist*mu_hat] globally, on blocks (the full
    layout); differentiable."""
    return roll_halo(lm, f, mu, sign * dist, f.dim() - lm.lat.nd + mu)


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks of a per-rank partial sum; the backward is
    the identity (module docstring)."""

    @staticmethod
    def forward(x, lm):
        if x.is_complex():
            return torch.view_as_complex(lm.all_reduce(torch.view_as_real(
                x.resolve_conj().contiguous())))
        return lm.all_reduce(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.lm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        return _AllReduce.apply(t, ctx.lm)


def global_sum(lm: LatticeMesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over this rank's block and all the others, in
    float64 (complex128 for a complex ``x``); differentiable with
    respect to the block (the gradient of the global sum)."""
    dt = torch.complex128 if x.is_complex() else torch.float64
    return _AllReduce.apply(torch.sum(x, dtype=dt), lm)


def psum(x: torch.Tensor) -> torch.Tensor:
    """A per-rank partial sum (float64 or complex128) summed over the
    ranks of the active mesh (``x`` itself with none)."""
    lm = active()
    if lm is None:
        return x
    return _AllReduce.apply(x, lm)


def site_sum(x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """``torch.sum(x, dtype=dtype)`` over the whole lattice: the block
    sum all-reduced under an active mesh."""
    return psum(torch.sum(x, dtype=dtype))


def dslash_full_sharded(lm: LatticeMesh, g: torch.Tensor, x: torch.Tensor
                        ) -> torch.Tensor:
    """Full-lattice staggered hopping term on blocks, halos exchanged:
    ``g`` the block of phased links (nd, nc, nc, *local), ``x`` of a
    color vector (nc, *local)."""
    out = None
    for mu in range(lm.lat.nd):
        fwd = linalg.mv(g[mu], shift_halo(lm, x, mu, +1))
        bwd = shift_halo(lm, linalg.mv_an(g[mu], x), mu, -1)
        term = fwd - bwd
        out = term if out is None else out + term
    return 0.5 * out


def norm2_sharded(lm: LatticeMesh, x: torch.Tensor, dtype=None
                  ) -> torch.Tensor:
    """Global |x|^2 of a field split over the mesh (float64)."""
    return lm.all_reduce(linalg.norm2(x, dtype=torch.float64))


def redot_sharded(lm: LatticeMesh, x: torch.Tensor, y: torch.Tensor,
                  dtype=None) -> torch.Tensor:
    """Global Re<x, y> (float64)."""
    return lm.all_reduce(linalg.redot(x, y, dtype=torch.float64))


def dot_sharded(lm: LatticeMesh, x: torch.Tensor, y: torch.Tensor
                ) -> torch.Tensor:
    """Global <x, y> = sum conj(x) y (complex128)."""
    d = linalg.dot(x, y, dtype=torch.complex128)
    return torch.view_as_complex(lm.all_reduce(torch.view_as_real(d)))


def reductions(lm: LatticeMesh) -> Reductions:
    """The global sums of a Krylov solve on blocks of ``lm`` (float64
    whatever the requested dtype, as :func:`norm2_sharded`)."""
    return Reductions(norm2=lambda x, dtype=None: norm2_sharded(lm, x),
                      redot=lambda x, y, dtype=None: redot_sharded(lm, x, y))
