"""Lattice shifts and parallel transport, full-lattice layout (port of
``qex_tpu.ops.shifts``).

Sign convention: ``shift(f, mu, +1)[x] = f[x + mu]``, i.e. pull from the
forward neighbour, which is ``torch.roll(f, -1, axis)``.

Under an active rank mesh (``parallel.mesh.use_mesh``) ``f`` is this
rank's block and a shift along a split direction exchanges its face
(``parallel.halo.roll_halo``, differentiable).
"""

from __future__ import annotations

import torch

from ..parallel import halo, mesh
from . import linalg


def roll(f: torch.Tensor, k: int, axis: int, mu: int) -> torch.Tensor:
    """result[i] = f[i + k] along tensor ``axis``, which runs along
    lattice direction mu: ``torch.roll(f, -k, axis)``, or its halo
    exchanging twin on the active mesh's blocks."""
    lm = mesh.active()
    if lm is None:
        return torch.roll(f, -k, axis)
    return halo.roll_halo(lm, f, mu, k, axis)


def shift(f: torch.Tensor, mu: int, sign: int, nd: int | None = None,
          dist: int = 1) -> torch.Tensor:
    """Shifted field: result[x] = f[x + sign*dist*mu_hat] (periodic)."""
    if nd is None:
        nd = 4
    return roll(f, sign * dist, f.dim() - nd + mu, mu)


def transport(u_mu: torch.Tensor, f: torch.Tensor, mu: int, sign: int,
              nd: int | None = None) -> torch.Tensor:
    """Parallel transport of ``f`` through link field ``u_mu``.

    sign=+1: U_mu(x) f(x+mu); sign=-1: U_mu(x-mu)^dag f(x-mu).
    Works for both matrix-valued and vector-valued ``f``.
    """
    matf = f.dim() == u_mu.dim()
    if sign > 0:
        fs = shift(f, mu, +1, nd)
        return linalg.mul(u_mu, fs) if matf else linalg.mv(u_mu, fs)
    y = linalg.mul_an(u_mu, f) if matf else linalg.mv_an(u_mu, f)
    return shift(y, mu, -1, nd)
