"""Halo exchange and global sums on a rank mesh (port of
``qex_tpu.parallel.halo``; QEX's ShiftB halo pipeline,
src/layout/shifts.nim:67-286, and ``qmpSum``).

Every function takes this rank's block of a field (``parallel.mesh``):
site-tensor axes leading, the block's lattice axes trailing.  A shift is
a local roll plus, along a split direction, one face exchange with the
neighbouring ranks; a global sum is a float64 sum over the block
all-reduced over the group, so that the sum's value does not depend on
how the lattice is split beyond float64 rounding.
"""

from __future__ import annotations

import torch

from ..ops import linalg
from ..solvers.base import Reductions
from .mesh import LatticeMesh


def shift_halo(lm: LatticeMesh, f: torch.Tensor, mu: int, sign: int,
               dist: int = 1) -> torch.Tensor:
    """result[x] = f[x + sign*dist*mu_hat] globally, on blocks."""
    nd = lm.lat.nd
    axis = f.dim() - nd + mu
    rolled = torch.roll(f, -sign * dist, axis)
    if lm.rank_geom[mu] == 1 or dist == 0:
        return rolled
    n = f.shape[axis]
    if dist >= n:
        raise ValueError("halo depth >= local extent")
    lo, hi = f.narrow(axis, 0, dist), f.narrow(axis, n - dist, dist)
    # the wrapped planes come from the neighbour: its first planes for a
    # forward shift, its last for a backward one
    from_next, from_prev = lm.exchange_faces({mu: (lo, hi)})[mu]
    if sign > 0:
        rolled.narrow(axis, n - dist, dist).copy_(from_next)
    else:
        rolled.narrow(axis, 0, dist).copy_(from_prev)
    return rolled


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
