"""Staggered solve entry points (port of ``qex_tpu.physics.stag_solve``:
``solve_ee``, ``solve_eo``, ``solve``, ``solve_multi``, ``solve_batched``
and ``cg_flops``).

Eliminating the odd sites of D(m) x = b gives the hermitian positive
definite even-site system ``(m^2 - D_eo D_oe) x_e = m b_e - D_eo b_o``,
solved by restarted CG, then ``x_o = (b_o - D_oe x_e) / m``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from ..ops import eo
from ..solvers import cg, cgm
from ..solvers.base import SolverParams, SolverStats
from . import stag_fast as sf
from . import stag_hisq as sh
from . import stag_shard
from . import staggered as st


def solve_ee(s: st.StaggeredEO, b_e: torch.Tensor, m: float,
             params: SolverParams = SolverParams()
             ) -> tuple[torch.Tensor, SolverStats]:
    """Solve (m^2 - D_eo D_oe) x_e = b_e on even sites.

    4-d lattices solve in the fast layout: a CUDA tensor through the
    8-term CUDA kernel (``stag_hisq.d2ee_stag8``), a CPU tensor through
    the plain ``stag_fast.d2ee_fast``.  The layout conversions bracket
    the whole solve, not each iteration.

    ``params.sloppy`` runs the inner CG on bf16-rounded links (kernel
    B1b on the card) with the inner tolerance held at the bf16 noise
    floor 1e-5, and the true-residual restarts on the 8-term operator
    with links in the vector's precision (float32 on the card, kernel
    B1).  A CPU tensor takes the same route through the plain twins.

    ``params.mesh`` (or the active mesh, ``parallel.mesh.use_mesh``)
    runs the CG on this rank's blocks (``stag_shard.solve_route``: the
    same kernels on each block, halos exchanged, sums all-reduced):
    ``s`` and ``b_e`` are then this rank's blocks, and so is the
    solution.
    """
    if s.lat.nd == 4:
        bf = sf.to_fast(b_e, s.lat)
        fs = sf.new_fast(s)
        op, op_sloppy, dots = stag_shard.solve_route(
            params.mesh, fs, params.sloppy, m,
            lambda: fast_ops(fs, bf, params.sloppy, m=m))
        op_true, floor = None, 1e-12
        if op_sloppy is not None:
            op, op_true, floor = op_sloppy, op, 1e-5
        xf, stats = cg.cg_solve_restarted(op, bf, r2req=params.r2req,
                                          maxits=params.maxits,
                                          restarts=params.restarts,
                                          op_true=op_true,
                                          inner_r2req_floor=floor,
                                          dots=dots)
        return sf.from_fast(xf, s.lat), stats
    op = partial(st.d2ee, s, m=m)
    return cg.cg_solve_restarted(op, b_e, r2req=params.r2req,
                                 maxits=params.maxits,
                                 restarts=params.restarts)


def solve_eo(s: st.StaggeredEO, b_e: torch.Tensor, b_o: torch.Tensor,
             m: float, params: SolverParams = SolverParams()
             ) -> tuple[torch.Tensor, torch.Tensor, SolverStats]:
    """Solve D(m) x = b given packed rhs; returns (x_e, x_o, stats)."""
    rhs = m * b_e - st.dslash_eo(s, b_o, parity_out=0)
    x_e, stats = solve_ee(s, rhs, m, params)
    x_o = st.reconstruct_odd(s, x_e, b_o, m)
    return x_e, x_o, stats


def solve(s: st.StaggeredEO, b: torch.Tensor, m: float,
          params: SolverParams = SolverParams()
          ) -> tuple[torch.Tensor, SolverStats]:
    """Solve D(m) x = b for a full-lattice rhs ``b`` (shape (nc, *dims))."""
    nd = s.lat.nd
    b_e, b_o = eo.pack(b, nd)
    x_e, x_o, stats = solve_eo(s, b_e, b_o, m, params)
    return eo.unpack(x_e, x_o, nd), stats


def fast_ops(fs: sf.FastStagEO, x: torch.Tensor, sloppy: bool = False,
             m: float | None = None) -> tuple:
    """``(op, op_sloppy)`` on fast-layout vectors like ``x``: the
    even-site normal operator m^2 - D_eo D_oe (the mass-free
    -D_eo D_oe when ``m`` is None) and, with ``sloppy``, the same
    operator on bf16-rounded links (else None).

    The one place the fast-layout solves pick their operator: a CUDA
    vector goes through the 8-term kernel (B1, and B1b for the sloppy
    one); a CPU vector through the plain fast-layout operator, or with
    ``sloppy`` through the kernel's plain twin on links in x's
    precision and on bf16 links."""
    if sloppy:
        links = (sh.new_stag8(fs, links_dtype=x.real.dtype),
                 sh.new_stag8(fs, links_dtype=torch.bfloat16))
    elif x.is_cuda:
        links = (sh.new_stag8(fs), None)
    else:
        links = (fs, None)

    def bind(p):
        if p is None:
            return None
        if m is None:
            return partial(sf.d2dd_fast if p is fs else sh.d2dd_stag8, p,
                           parity=0)
        return partial(sf.d2ee_fast if p is fs else sh.d2ee_stag8, p, m=m)
    return tuple(bind(p) for p in links)


# bf16's rounding ~3.9e-3 and lambda_max(-D_eo D_oe) <= 16: a refinement
# with a bf16 inner operator converges while eps * kappa(A + sigma) < 1,
# so the sloppy multishift route needs every shift above twice this
SLOPPY_MULTI_MIN_SHIFT = 2 * 3.9e-3 * 16


def solve_multi(s: st.StaggeredEO, b_e: torch.Tensor, masses,
                params: SolverParams = SolverParams()
                ) -> tuple[list[torch.Tensor], SolverStats]:
    """Multi-mass even-site solve: (m_i^2 - D_eo D_oe) x_i = b_e for all
    masses from one multishift Krylov space.

    4-d lattices solve in the fast layout on :func:`fast_ops` (kernel
    B1 on the card).  ``params.sloppy`` takes the bf16 route (a joint
    pass on B1b, per-shift refinement on B1,
    ``cgm.cg_multishift_refined``) only where every shift m_i^2 is at
    least ``SLOPPY_MULTI_MIN_SHIFT``; lighter masses take the plain
    route.  The joint pass cannot restart, and in complex64 the smallest
    shift's true residual stalls near 1e-8, so below that r2req (1e-22
    in complex128), with restarts allowed, the plain route refines each
    shift on the true operator.  ``stats.r2`` is the worst shift's
    relative residual (true on the refined routes, iterated else).
    ``params.mesh`` runs it on blocks, as :func:`solve_ee`."""
    shifts = [m * m for m in masses]
    if s.lat.nd != 4:
        return cgm.cg_multishift(partial(st.d2dd, s, parity=0), b_e, shifts,
                                 r2req=params.r2req, maxits=params.maxits)
    bf = sf.to_fast(b_e, s.lat)
    fs = sf.new_fast(s)
    sloppy = params.sloppy and min(shifts) >= SLOPPY_MULTI_MIN_SHIFT
    base, base_sloppy, dots = stag_shard.solve_route(
        params.mesh, fs, sloppy, None, lambda: fast_ops(fs, bf, sloppy))
    b = bf
    floor = 1e-8 if bf.dtype == torch.complex64 else 1e-22
    if base_sloppy is not None:
        xs, stats = cgm.cg_multishift_refined(
            base_sloppy, base, b, shifts, r2req=params.r2req,
            maxits=params.maxits, sloppy_r2req=1e-5, dots=dots)
    elif params.r2req < floor and params.restarts > 0:
        xs, stats = cgm.cg_multishift_refined(
            base, base, b, shifts, r2req=params.r2req,
            maxits=params.maxits, sloppy_r2req=floor,
            refine_restarts=params.restarts, dots=dots)
    else:
        xs, stats = cgm.cg_multishift(base, b, shifts, r2req=params.r2req,
                                      maxits=params.maxits, dots=dots)
    return [sf.from_fast(x, s.lat) for x in xs], stats


def solve_batched(s: st.StaggeredEO, bs: torch.Tensor, m: float,
                  params: SolverParams = SolverParams()
                  ) -> tuple[torch.Tensor, list[SolverStats]]:
    """Multi-RHS solve of D(m) x = b for each full-lattice ``b`` of
    ``bs`` (nrhs, nc, *dims): the solutions stacked as ``bs`` and one
    SolverStats per right-hand side.  Each is solved alone by
    :func:`solve` with ``params`` less ``sloppy`` (kernel B1 on the
    card), so each result equals its own solve."""
    params = dataclasses.replace(params, sloppy=False)
    xs, stats = [], []
    for b in bs:
        x, st_ = solve(s, b, m, params)
        xs.append(x)
        stats.append(st_)
    return torch.stack(xs), stats


def cg_flops(lat, nd: int, nc: int, iters: int) -> int:
    """QEX's eo-CG flop model: (nd*4*72 + 60) * nEven * iters for nc=3."""
    n_even = lat.volume // 2
    per_site = nd * 4 * 72 + 60 if nc == 3 else nd * 4 * 8 * nc * nc + 20 * nc
    return per_site * n_even * iters
