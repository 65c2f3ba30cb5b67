"""Wilson Dirac operator and solver (port of ``qex_tpu.physics.wilson``).

Euclidean hermitian gamma matrices in the chiral basis,
gamma5 = diag(1,1,-1,-1) = g0 g1 g2 g3; fields have shape
``(4, nc, *dims)`` (spin axis leading, then color).

    D psi(x) = (nd + m) psi(x)
             - 1/2 sum_mu [ (1 - g_mu) U_mu(x) psi(x+mu)
                          + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu) ]

gamma5-hermiticity g5 D g5 = D^dag makes D^dag D hermitian positive
definite: the CGNE target.  The even-odd Schur complement
``M = a - H_eo H_oe / a`` (a = nd + m) is solved in the fast layout,
through the CUDA hop of :mod:`.wilson_pallas` on the card.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from ..lattice import Lattice
from ..ops import eo
from ..ops.shifts import shift
from ..solvers import cg
from ..solvers.base import MGParams, SolverParams, SolverStats
from .staggered import bc_signs


def gamma_matrices() -> np.ndarray:
    """(5, 4, 4) complex: g0..g3 (x,y,z,t) and g5, chiral basis."""
    i = 1j
    g0 = np.array([[0, 0, 0, i], [0, 0, i, 0],
                   [0, -i, 0, 0], [-i, 0, 0, 0]])
    g1 = np.array([[0, 0, 0, -1], [0, 0, 1, 0],
                   [0, 1, 0, 0], [-1, 0, 0, 0]])
    g2 = np.array([[0, 0, i, 0], [0, 0, 0, -i],
                   [-i, 0, 0, 0], [0, i, 0, 0]])
    g3 = np.array([[0, 0, 1, 0], [0, 0, 0, 1],
                   [1, 0, 0, 0], [0, 1, 0, 0]])
    g5 = np.diag([1, 1, -1, -1]).astype(complex)
    assert np.allclose(g0 @ g1 @ g2 @ g3, g5)
    return np.stack([g0, g1, g2, g3, g5])


def _spin_mul(mat: np.ndarray, psi: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 spin matrix to the leading spin axis."""
    m = torch.as_tensor(mat, dtype=psi.dtype, device=psi.device)
    return torch.einsum("st,tc...->sc...", m, psi)


@dataclasses.dataclass(frozen=True)
class WilsonD:
    """Wilson operator data: BC-phased links + mass."""

    lat: Lattice
    g: torch.Tensor        # (nd, nc, nc, *dims) phased links
    m: float


def new_wilson(lat: Lattice, u: torch.Tensor, m: float,
               bc: str = "pppa") -> WilsonD:
    """Links u with the boundary signs of ``bc`` folded in (built on
    u's device)."""
    sgn = bc_signs(lat, bc, u.dtype.to_real(), u.device)
    return WilsonD(lat, u * sgn[:, None, None], m)


def wilson_hop(w: WilsonD, psi: torch.Tensor) -> torch.Tensor:
    """The hopping term H psi = 1/2 sum_mu [(1-g)U psi(x+mu) +
    (1+g)U^dag psi(x-mu)] (no diagonal)."""
    nd = w.lat.nd
    gams = gamma_matrices()
    out = None
    for mu in range(nd):
        fwd = torch.einsum("ab...,sb...->sa...", w.g[mu],
                           shift(psi, mu, +1, nd))
        fwd = fwd - _spin_mul(gams[mu], fwd)
        tmp = torch.einsum("ba...,sb...->sa...", w.g[mu].conj(), psi)
        bwd = shift(tmp, mu, -1, nd)
        bwd = bwd + _spin_mul(gams[mu], bwd)
        term = fwd + bwd
        out = term if out is None else out + term
    return 0.5 * out


def wilson_d(w: WilsonD, psi: torch.Tensor) -> torch.Tensor:
    """Full Wilson operator D(m) psi (diagonal nd + m)."""
    return (w.lat.nd + w.m) * psi - wilson_hop(w, psi)


def wilson_d_dag(w: WilsonD, psi: torch.Tensor) -> torch.Tensor:
    """D^dag via gamma5-hermiticity: D^dag = g5 D g5."""
    gams = gamma_matrices()
    return _spin_mul(gams[4], wilson_d(w, _spin_mul(gams[4], psi)))


def wilson_ddagd(w: WilsonD, psi: torch.Tensor) -> torch.Tensor:
    """Normal operator D^dag D (hermitian positive definite)."""
    return wilson_d_dag(w, wilson_d(w, psi))


def solve(w: WilsonD, b: torch.Tensor,
          params: SolverParams = SolverParams()
          ) -> tuple[torch.Tensor, SolverStats]:
    """Solve D x = b by CGNE: (D^dag D) x = D^dag b on the full lattice.
    ``params.backend == "mg"`` routes to the K-cycle-multigrid
    preconditioned GCR instead (:func:`solve_mg`)."""
    params.check_supported()
    if params.backend == "mg":
        x, stats, _ = solve_mg(w, b, params)
        return x, stats
    return cg.cg_solve_restarted(partial(wilson_ddagd, w),
                                 wilson_d_dag(w, b), r2req=params.r2req,
                                 maxits=params.maxits,
                                 restarts=params.restarts)


def solve_mg(w: WilsonD, b: torch.Tensor,
             params: SolverParams = SolverParams(), hierarchy=None):
    """Solve D x = b by K-cycle-multigrid-preconditioned GCR on D itself
    (no normal operator): the ``backend="mg"`` solve route.

    Returns (x, stats, hierarchy); pass ``hierarchy`` back in to reuse
    the adaptive setup across solves on the same gauge field.
    ``params.mg`` (solvers.base.MGParams) sets the cycle shape.
    """
    from ..mg.kcycle import mg_solve_kcycle
    mp = params.mg if params.mg is not None else MGParams()
    return mg_solve_kcycle(
        w.lat, partial(wilson_d, w), b, nlevels=mp.nlevels, nvec=mp.nvec,
        bs=mp.bs, chiral=mp.chiral, r2req=params.r2req, m=mp.m,
        max_restarts=max(1, params.maxits // mp.m), seed=mp.seed,
        hierarchy=hierarchy, relax_iters=mp.relax_iters,
        smooth_iters=mp.smooth_iters, k_m=mp.k_m,
        bottom_iters=mp.bottom_iters, assemble=mp.assemble)


# --- even-odd preconditioning ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WilsonEO:
    """eo-packed Wilson operator: links per parity + diagonal a=nd+m."""

    lat: Lattice
    g_e: torch.Tensor
    g_o: torch.Tensor
    m: float

    @property
    def a(self) -> float:
        return self.lat.nd + self.m


def new_wilson_eo(lat: Lattice, u: torch.Tensor, m: float,
                  bc: str = "pppa") -> WilsonEO:
    w = new_wilson(lat, u, m, bc)
    ge, go = eo.pack(w.g, lat.nd)
    return WilsonEO(lat, ge, go, m)


def wilson_hop_eo(w: WilsonEO, psi_src: torch.Tensor, parity_out: int
                  ) -> torch.Tensor:
    """Hopping term from parity 1-parity_out onto parity_out (packed
    spinors, shape (ns, nc, *dims_h))."""
    nd = w.lat.nd
    gams = gamma_matrices()
    g_out = w.g_e if parity_out == 0 else w.g_o
    g_src = w.g_o if parity_out == 0 else w.g_e
    out = None
    for mu in range(nd):
        fwd = torch.einsum("ab...,sb...->sa...", g_out[mu],
                           eo.shift_eo(psi_src, mu, +1, parity_out, nd))
        fwd = fwd - _spin_mul(gams[mu], fwd)
        tmp = torch.einsum("ba...,sb...->sa...", g_src[mu].conj(), psi_src)
        bwd = eo.shift_eo(tmp, mu, -1, parity_out, nd)
        bwd = bwd + _spin_mul(gams[mu], bwd)
        term = fwd + bwd
        out = term if out is None else out + term
    return 0.5 * out


def wilson_m_ee(w: WilsonEO, x_e: torch.Tensor) -> torch.Tensor:
    """Schur complement M = a - H_eo H_oe / a on even sites."""
    t = wilson_hop_eo(w, x_e, parity_out=1)
    return w.a * x_e - wilson_hop_eo(w, t, parity_out=0) / w.a


def wilson_m_ee_dag(w: WilsonEO, x_e: torch.Tensor) -> torch.Tensor:
    """M^dag = g5 M g5 (gamma5-hermiticity survives eo reduction)."""
    g5 = gamma_matrices()[4]
    return _spin_mul(g5, wilson_m_ee(w, _spin_mul(g5, x_e)))


def solve_eo(w: WilsonEO, b: torch.Tensor,
             params: SolverParams = SolverParams()
             ) -> tuple[torch.Tensor, SolverStats]:
    """eo-preconditioned CGNE solve of D x = b (full-lattice b/x):
    M^dag M x_e = M^dag (b_e + H_eo b_o / a) on even sites, then
    x_o = (b_o + H_oe x_e) / a.

    4-d lattices solve in the fast layout.  Where
    ``wilson_pallas.fits`` the operator is ``m_ee_dag_w(m_ee_w(v))`` on
    links in the vector's precision (float32 on the card: kernel B3;
    a CPU tensor takes its plain twin), and the rhs and the odd-site
    reconstruction use the same hop; ``params.sloppy`` runs the inner
    CG on bf16 links (kernel B3b) with the inner tolerance held at the
    bf16 noise floor 1e-5 and true-residual restarts on the full
    operator.  Other 4-d lattices take the plain fast-layout operator,
    other nd the canonical eo operator.

    ``params.backend == "mg"``: dispatch to the K-cycle multigrid on
    the full (unreduced) operator.
    """
    from . import stag_fast as sf
    from . import wilson_fast as wf
    from . import wilson_pallas as wp
    params.check_supported()
    lat = w.lat
    if params.backend == "mg":
        g = eo.unpack(w.g_e, w.g_o, lat.nd)
        x, stats, _ = solve_mg(WilsonD(lat, g, w.m), b, params)
        return x, stats
    b_e, b_o = eo.pack(b, lat.nd)
    if lat.nd != 4:
        rhs = b_e + wilson_hop_eo(w, b_o, parity_out=0) / w.a
        x_e, stats = cg.cg_solve_restarted(
            lambda v: wilson_m_ee_dag(w, wilson_m_ee(w, v)),
            wilson_m_ee_dag(w, rhs), r2req=params.r2req,
            maxits=params.maxits, restarts=params.restarts)
        x_o = (b_o + wilson_hop_eo(w, x_e, parity_out=1)) / w.a
        return eo.unpack(x_e, x_o, lat.nd), stats
    fw = wf.new_fast_wilson(w)
    bf_e, bf_o = sf.to_fast(b_e, lat), sf.to_fast(b_o, lat)
    op_true, floor = None, 1e-12
    if wp.fits(lat):
        pw = wp.new_pallas_wilson(fw, links_dtype=bf_e.real.dtype)
        hop, m_ee_dag = partial(wp.hop_w, pw), partial(wp.m_ee_dag_w, pw)
        op = lambda v: wp.m_ee_dag_w(pw, wp.m_ee_w(pw, v))
        if params.sloppy:
            pwb = wp.new_pallas_wilson(fw, links_dtype=torch.bfloat16)
            op_true, floor = op, 1e-5
            op = lambda v: wp.m_ee_dag_w(pwb, wp.m_ee_w(pwb, v))
    else:
        hop, m_ee_dag = partial(wf.hop_fast, fw), partial(wf.m_ee_dag_fast,
                                                           fw)
        op = lambda v: wf.m_ee_dag_fast(fw, wf.m_ee_fast(fw, v))
    rhs = bf_e + hop(bf_o, 0) / w.a
    xf_e, stats = cg.cg_solve_restarted(op, m_ee_dag(rhs),
                                        r2req=params.r2req,
                                        maxits=params.maxits,
                                        restarts=params.restarts,
                                        op_true=op_true,
                                        inner_r2req_floor=floor)
    xf_o = (bf_o + hop(xf_e, 1)) / w.a
    return eo.unpack(sf.from_fast(xf_e, lat), sf.from_fast(xf_o, lat),
                     lat.nd), stats


def wilson_flops_per_site(nd: int = 4, nc: int = 3, ns: int = 4) -> int:
    """Reference-style flop model: per direction 2 color matvecs on
    half-spinors (2 spin components after projection) + spin
    reconstruction (1392 for nd=4, nc=3; the hop kernel's own cost model
    is 1344)."""
    cmv = 8 * nc * nc * (ns // 2) * 2      # two half-spinor matvecs
    proj = 4 * nc * ns                     # project + reconstruct adds
    return nd * (cmv + proj) + 2 * 2 * nc * ns
