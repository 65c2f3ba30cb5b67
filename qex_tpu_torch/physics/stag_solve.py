"""Staggered solve entry points (port of ``qex_tpu.physics.stag_solve``:
``solve_ee``, ``solve_eo``, ``solve`` and ``cg_flops``).

Eliminating the odd sites of D(m) x = b gives the hermitian positive
definite even-site system ``(m^2 - D_eo D_oe) x_e = m b_e - D_eo b_o``,
solved by restarted CG, then ``x_o = (b_o - D_oe x_e) / m``.
"""

from __future__ import annotations

from functools import partial

import torch

from ..ops import eo
from ..solvers import cg
from ..solvers.base import SolverParams, SolverStats
from . import stag_fast as sf
from . import stag_hisq as sh
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
    """
    params.check_supported()
    if s.lat.nd == 4:
        fs = sf.new_fast(s)
        bf = sf.to_fast(b_e, s.lat)
        op_true, floor = None, 1e-12
        if params.sloppy:
            op = partial(sh.d2ee_stag8,
                         sh.new_stag8(fs, links_dtype=torch.bfloat16), m=m)
            op_true = partial(sh.d2ee_stag8,
                              sh.new_stag8(fs, links_dtype=bf.real.dtype),
                              m=m)
            floor = 1e-5
        elif bf.is_cuda:
            op = partial(sh.d2ee_stag8, sh.new_stag8(fs), m=m)
        else:
            op = partial(sf.d2ee_fast, fs, m=m)
        xf, stats = cg.cg_solve_restarted(op, bf, r2req=params.r2req,
                                          maxits=params.maxits,
                                          restarts=params.restarts,
                                          op_true=op_true,
                                          inner_r2req_floor=floor)
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


def cg_flops(lat, nd: int, nc: int, iters: int) -> int:
    """QEX's eo-CG flop model: (nd*4*72 + 60) * nEven * iters for nc=3."""
    n_even = lat.volume // 2
    per_site = nd * 4 * 72 + 60 if nc == 3 else nd * 4 * 8 * nc * nc + 20 * nc
    return per_site * n_even * iters
