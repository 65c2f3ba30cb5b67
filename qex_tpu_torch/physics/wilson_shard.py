"""Domain-decomposed eo Wilson solve: the kernels B3/B3b on each rank's
block plus the exact surface correction (the Wilson counterpart of
``physics.stag_shard``; the JAX package runs ``wilson.solve_eo`` under
GSPMD, tests/test_sharded_hotpath.py:173).

Each rank of a ``parallel.mesh.LatticeMesh`` split over z and t only
(``rank_geom=(1, 1, gz, gt)``, even local Z, the packed T divisible:
``stag_shard.mesh_usable``) holds its block of the gauge field, builds
the kernel's pre-shifted links from it (``wilson_pallas.new_pallas_wilson``
under ``parallel.mesh.use_mesh``: the backward links' shifts exchange
faces), and runs the eight-term hop on its block of the fast-layout
spinor (4, 3, Th, Z, Y*X) with local-periodic wraps: the CUDA kernel for
a CUDA tensor (``wilson_pallas.hop_w``), its plain twin for a CPU
tensor.  The only error is the wrapped spinor plane at each local z and
t face, and the correction adds, term by term,

    L_t(x) P_t (psi_halo - psi_wrap)|_face,

with P_t the term's spin projection and reconstruction
(``wilson_pallas._sigma_struct``): one batch of face exchanges per hop.
The CGNE runs on the blocks with every sum a float64 all-reduce
(``parallel.halo.reductions``).
"""

from __future__ import annotations

from functools import partial

import torch

from ..parallel import halo
from ..parallel.mesh import LatticeMesh, use_mesh
from ..solvers import cg
from ..solvers.base import SolverParams, SolverStats
from . import stag_fast as sf
from . import stag_shard
from . import wilson_fast as wf
from . import wilson_pallas as wp


def _term(links: torch.Tensor, delta: torch.Tensor, mu: int, e: int
          ) -> torch.Tensor:
    """The hop's term (mu, e) applied to a slab ``delta`` (4, 3, ...):
    project, multiply by the split links (2, 3, 3, ...), reconstruct."""
    perm, coef = wp._sigma_struct(mu)
    lk = links.to(delta.real.dtype)
    lk = torch.complex(lk[0], lk[1])
    out = [torch.zeros_like(delta[0]) for _ in range(4)]
    for s in range(2):
        h = delta[s] + (e * coef[s]) * delta[2 + perm[s]]
        r = torch.einsum("ab...,b...->a...", lk, h)
        out[s] = out[s] + r
        out[2 + perm[s]] = out[2 + perm[s]] + (e * coef[s].conjugate()) * r
    return torch.stack(out)


def hop_fix_w(lm: LatticeMesh, p: wp.PallasWilsonEO, x: torch.Tensor,
              parity_out: int, out: torch.Tensor, scale: float = 1.0
              ) -> torch.Tensor:
    """Add ``scale`` times the exact face correction of the
    local-periodic hop of block ``x`` (4, 3, Th, Z, Y*X) to ``out`` (in
    place; returned).  Term mu (forward, e = -1) reads psi(x + mu),
    term 4 + mu (backward, e = +1) psi(x - mu); on the packed t axis the
    wrapped plane is selected by the output site's sublattice, as in
    ``stag_shard.hop3_fix``."""
    sizes = lm.rank_geom
    links = p.l_e if parity_out == 0 else p.l_o
    Zl, Thl = x.shape[-2], x.shape[-3]
    faces = {}
    if sizes[2] > 1:
        faces[2] = (x[..., 0:1, :], x[..., Zl - 1:Zl, :])
    if sizes[3] > 1:
        faces[3] = (x[:, :, 0:1], x[:, :, Thl - 1:Thl])
    halos = lm.exchange_faces(faces)
    if sizes[2] > 1:
        (lo, hi), (nxt, prv) = faces[2], halos[2]
        d_lo, d_hi = scale * (nxt - lo), scale * (prv - hi)
        out[..., Zl - 1, :] += _term(links[2][..., Zl - 1, :],
                                     d_lo[..., 0, :], 2, -1)
        out[..., 0, :] += _term(links[6][..., 0, :], d_hi[..., 0, :], 2, +1)
    if sizes[3] > 1:
        s_par = sf.odd_t(p.lat, parity_out, x.device)     # (Z, Y*X)
        (lo, hi), (nxt, prv) = faces[3], halos[3]
        d_lo, d_hi = scale * (nxt - lo), scale * (prv - hi)
        zero = torch.zeros_like(d_lo[:, :, 0])
        # forward t: psi(x+t) = sel(s, psi[th+1], psi[th]); wrapped at
        # th = Thl-1 where s holds.  backward: sel(s, psi[th],
        # psi[th-1]); wrapped at th = 0 where s does not
        out[:, :, Thl - 1] += _term(links[3][:, :, :, Thl - 1],
                                    torch.where(s_par, d_lo[:, :, 0], zero),
                                    3, -1)
        out[:, :, 0] += _term(links[7][:, :, :, 0],
                              torch.where(s_par, zero, d_hi[:, :, 0]), 3, +1)
    return out


def hop_sharded(lm: LatticeMesh, p: wp.PallasWilsonEO, x: torch.Tensor,
                parity_out: int, x_fuse: torch.Tensor | None = None
                ) -> torch.Tensor:
    """``wilson_pallas.hop_w`` on blocks: the kernel (or its twin) with
    local wraps, then :func:`hop_fix_w` (scaled by -1/a after the fused
    epilogue a x_fuse - hop / a)."""
    y = wp.hop_w(p, x, parity_out, x_fuse)
    return hop_fix_w(lm, p, x, parity_out, y,
                     1.0 if x_fuse is None else -1.0 / p.a)


def m_ee_sharded(lm: LatticeMesh, p: wp.PallasWilsonEO, x: torch.Tensor
                 ) -> torch.Tensor:
    """Schur complement a - H_eo H_oe / a on blocks."""
    return hop_sharded(lm, p, hop_sharded(lm, p, x, 1), 0, x_fuse=x)


def m_ee_dag_sharded(lm: LatticeMesh, p: wp.PallasWilsonEO,
                     x: torch.Tensor) -> torch.Tensor:
    return wp._g5(m_ee_sharded(lm, p, wp._g5(x)))


def links_w(lm: LatticeMesh, w, links_dtype: torch.dtype
            ) -> wp.PallasWilsonEO:
    """The kernel's links built from this rank's block of a
    ``wilson.WilsonEO`` or ``wilson_fast.FastWilsonEO``."""
    stag_shard.require_usable(lm)
    fw = w if isinstance(w, wf.FastWilsonEO) else wf.new_fast_wilson(w)
    if tuple(fw.lat.dims) != tuple(lm.local_dims) or not wp.fits(fw.lat):
        raise ValueError(f"Wilson links on {fw.lat.dims}: the block solve "
                         f"takes this rank's block {lm.local_dims} with a "
                         "local T of at least 4")
    with use_mesh(lm):
        return wp.new_pallas_wilson(fw, links_dtype=links_dtype)


def solve_eo_sharded(lm: LatticeMesh, w, b_e: torch.Tensor,
                     b_o: torch.Tensor, params: SolverParams = SolverParams()
                     ) -> tuple[torch.Tensor, torch.Tensor, SolverStats]:
    """``wilson.solve_eo``'s CGNE on this rank's blocks: ``w`` its block
    of the eo operator, ``b_e``/``b_o`` its fast-layout blocks of the
    packed right-hand side; returns its blocks (x_e, x_o) and the
    stats.  ``params.sloppy`` takes bf16 inner iterations (B3b) with
    true-residual restarts on B3 and the inner floor 1e-5."""
    p = links_w(lm, w, b_e.real.dtype if not b_e.is_cuda
                else torch.float32)
    hop = partial(hop_sharded, lm, p)
    op = lambda v: m_ee_dag_sharded(lm, p, m_ee_sharded(lm, p, v))
    op_true, floor = None, 1e-12
    if params.sloppy:
        pb = links_w(lm, w, torch.bfloat16)
        op_true, floor = op, 1e-5
        op = lambda v: m_ee_dag_sharded(lm, pb, m_ee_sharded(lm, pb, v))
    rhs = b_e + hop(b_o, 0) / p.a
    x_e, stats = cg.cg_solve_restarted(
        op, m_ee_dag_sharded(lm, p, rhs), r2req=params.r2req,
        maxits=params.maxits, restarts=params.restarts, op_true=op_true,
        inner_r2req_floor=floor, dots=halo.reductions(lm))
    x_o = (b_o + hop(x_e, 1)) / p.a
    return x_e, x_o, stats
