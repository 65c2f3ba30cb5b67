"""Multi-level K-cycle multigrid for the Wilson operator (port of
``qex_tpu.mg.kcycle``).

* Chirality-split prolongator (``chiral=True``): each near-null vector
  is split into its two gamma5 chiralities before block
  orthonormalization, so the coarse space commutes with gamma5.
* Recursive levels: the Galerkin coarse operator is itself coarsened
  with the same adaptive setup.
* K-cycle: at each level the coarse equation is solved by a few
  iterations of GCR preconditioned by the next-coarser cycle.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from ..lattice import Lattice
from ..solvers.gcr import gcr_solve
from . import twogrid as tg
from .coarse import apply_stencil, assemble_stencil


@dataclasses.dataclass(frozen=True)
class MGHierarchy:
    """Per-level transfer data.

    setups[l] transfers level-l fields to level l+1; stencils[l] is the
    assembled level-(l+1) Galerkin operator (:class:`.coarse.CoarseStencil`)
    or None for matrix-free.  Level operators are derived from this data
    plus the fine operator by :func:`level_ops`."""

    setups: tuple
    stencils: tuple
    lats: tuple


def _wrap_coarse_op(dc: Callable) -> Callable:
    """Coarse fields are (nvec, *dims); present them to the setup
    machinery as (ns=1, nc=nvec, *dims)."""
    return lambda v: dc(v[0])[None]


def level_ops(h: MGHierarchy, fine_op: Callable) -> tuple:
    """ops[l] applies the level-l operator: the assembled stencil where
    there is one, the recursive matrix-free Galerkin operator
    otherwise."""
    ops = [fine_op]
    for l, s in enumerate(h.setups):
        if h.stencils[l] is not None:
            ops.append(partial(apply_stencil, h.stencils[l]))
        else:
            prev = ops[l] if l == 0 else _wrap_coarse_op(ops[l])
            ops.append(tg.coarse_op(s, prev))
    return tuple(ops)


def _coarse_lat(lat: Lattice, bs: int, nvec_eff: int) -> Lattice:
    """Coarse geometry; the coarse 'color' dimension is the number of
    (chirality-split) near-null vectors."""
    return Lattice(tuple(d // bs for d in lat.dims), nc=nvec_eff)


def mg_hierarchy(lat: Lattice, op: Callable, *, nlevels: int = 2,
                 nvec: int = 8, bs: int = 2, chiral: bool = True,
                 ns: int = 4, seed: int = 0,
                 dtype: torch.dtype = torch.complex64,
                 relax_iters: int = 30, assemble: bool = True,
                 device: torch.device | str | None = None) -> MGHierarchy:
    """Adaptive setup of ``nlevels`` coarsening steps on ``device``
    (default: the CUDA card).

    ``assemble=True`` probes each Galerkin coarse operator into an
    explicit 9-point stencil (:mod:`.coarse`) so coarse matvecs never
    touch the fine grid; the probing costs ``nvec_eff * (2 + sum_mu
    k_mu)`` applications of the level's operator, once per hierarchy
    (reuse the hierarchy across solves on one gauge field)."""
    setups, stencils, lats = [], [], [lat]
    cur_lat, cur_op, cur_ns = lat, op, ns
    for lvl in range(nlevels):
        s = tg.mg_setup(cur_lat, cur_op, nvec=nvec, bs=bs, seed=seed + lvl,
                        dtype=dtype, ns=cur_ns,
                        chiral=(chiral and lvl == 0 and cur_ns == 4),
                        relax_iters=relax_iters, device=device)
        setups.append(s)
        dc = tg.coarse_op(s, cur_op)
        cur_lat = _coarse_lat(cur_lat, bs, s.nvec)
        if assemble:
            cst = assemble_stencil(dc, s.nvec, cur_lat.dims, dtype,
                                   device=s.w.device)
            stencils.append(cst)
            dc = partial(apply_stencil, cst)
        else:
            stencils.append(None)
        lats.append(cur_lat)
        if min(cur_lat.dims) < bs and lvl + 1 < nlevels:
            break     # cannot coarsen further
        cur_op = _wrap_coarse_op(dc)
        cur_ns = 1
    return MGHierarchy(tuple(setups), tuple(stencils), tuple(lats))


def _restrict_l(h: MGHierarchy, lvl: int, v: torch.Tensor) -> torch.Tensor:
    return tg.restrict(h.setups[lvl], v if lvl == 0 else v[None])


def _prolong_l(h: MGHierarchy, lvl: int, c: torch.Tensor) -> torch.Tensor:
    p = tg.prolong(h.setups[lvl], c)
    return p if lvl == 0 else p[0]


def k_cycle(h: MGHierarchy, fine_op: Callable, lvl: int = 0, *,
            smooth_iters: int = 2, smooth_step: float = 0.2,
            k_m: int = 4, bottom_iters: int = 16,
            bottom_r2: float = 1e-4, _ops=None) -> Callable:
    """The level-``lvl`` K-cycle preconditioner r -> approximate
    D_lvl^{-1} r."""
    ops = level_ops(h, fine_op) if _ops is None else _ops
    op = ops[lvl]

    def smooth(x, r):
        for _ in range(smooth_iters):
            x = x + smooth_step * (r - op(x))
        return x

    if lvl >= len(h.setups):       # deepest level: plain GCR bottom solve
        def bottom(r):
            x, _ = gcr_solve(op, r, r2req=bottom_r2, m=bottom_iters,
                             max_restarts=1)
            return x
        return bottom

    inner = k_cycle(h, fine_op, lvl + 1, smooth_iters=smooth_iters,
                    smooth_step=smooth_step, k_m=k_m,
                    bottom_iters=bottom_iters, bottom_r2=bottom_r2,
                    _ops=ops)
    op_next = ops[lvl + 1]

    def cycle(r):
        x = smooth(torch.zeros_like(r), r)
        rc = _restrict_l(h, lvl, r - op(x))
        # K-cycle: a few GCR iterations at the coarse level,
        # preconditioned by the next-coarser cycle
        ec, _ = gcr_solve(op_next, rc, precon=inner, r2req=bottom_r2,
                          m=k_m, max_restarts=1)
        return smooth(x + _prolong_l(h, lvl, ec), r)

    return cycle


def mg_solve_kcycle(lat: Lattice, op: Callable, b: torch.Tensor, *,
                    nlevels: int = 2, nvec: int = 8, bs: int = 2,
                    chiral: bool = True, r2req: float = 1e-10,
                    m: int = 16, max_restarts: int = 50, seed: int = 0,
                    hierarchy: MGHierarchy | None = None,
                    relax_iters: int = 30, smooth_iters: int = 2,
                    k_m: int = 4, bottom_iters: int = 16,
                    assemble: bool = True):
    """K-cycle preconditioned GCR solve of op x = b; the hierarchy is
    built on b's device unless one is passed.  Returns
    (x, stats, hierarchy)."""
    if hierarchy is None:
        hierarchy = mg_hierarchy(lat, op, nlevels=nlevels, nvec=nvec,
                                 bs=bs, chiral=chiral, ns=b.shape[0],
                                 seed=seed, dtype=b.dtype,
                                 relax_iters=relax_iters,
                                 assemble=assemble, device=b.device)
    precon = k_cycle(hierarchy, op, smooth_iters=smooth_iters, k_m=k_m,
                     bottom_iters=bottom_iters)
    x, stats = gcr_solve(op, b, precon=precon, r2req=r2req, m=m,
                         max_restarts=max_restarts)
    return x, stats, hierarchy
