"""Domain-decomposed staggered hot path: the kernels B1/B2 on each rank's
block plus the exact halo correction (port of
``qex_tpu.physics.stag_shard``).

Each rank of a ``parallel.mesh.LatticeMesh`` holds the block of the
fast layout (nc, Th, Z, Y*X) its z and t coordinates select, and the
same block of the pre-shifted term-major links of ``stag_hisq``, which
it builds itself from its block of the gauge field: the phases come from
the block's global coordinates, the antiperiodic sign from the global
boundary, and the backward links' shifts exchange faces
(``staggered.phase_links`` and ``stag_hisq.new_stag8`` under
``parallel.mesh.use_mesh``).  The 8-term (plain staggered) or 16-term (fat + naik) hop runs
on the block with local-periodic wraps, through the CUDA kernel for a
CUDA tensor (``stag_hisq.dslash_stag8`` / ``dslash_hisq16``: B1/B1b,
B2/B2b) and through its plain twin for a CPU tensor.  Its only error is
the wrapped psi plane at each local z and t face, and the exact surface
correction is

    hop_true(x) = hop_local(x)
                + sum_{split mu} link_mu (psi_halo - psi_wrap) |_faces

(:func:`hop3_fix`): one face exchange per split direction and sign with
a slab of 1 plane (3 z planes and 2 packed-t planes for the 16 terms),
the z and t faces in one batch.

The fast layout merges y and x into its minor axis, so the rank
geometry must leave x and y whole (docs/MULTICHIP.md:62): split z and t
only, ``rank_geom=(1, 1, gz, gt)``.  Every local Z must be even, so that
a block's parities are the global ones (the kernels and the t-shift
derive the parity from local coordinates), and the packed Th must
divide; the 16 terms need local Z >= 3 and local Th >= 2
(:func:`mesh_usable`).

The solves (:func:`solve_ee_sharded`, :func:`solve_multi_sharded`,
and ``stag_solve``'s and ``stag_hmc``'s through :func:`solve_route`)
take this rank's block of the right-hand side and of the links and
return its block of the solution, with every dot and norm a float64
block sum all-reduced over the group (``parallel.halo``).  There is no
whole field to fall back on, so a mesh the block kernels cannot take
raises a ``ValueError`` naming its local extents.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..lattice import Lattice
from ..parallel import halo
from ..parallel.mesh import LatticeMesh, active, local_block, use_mesh
from ..solvers import cg, cgm
from ..solvers.base import LOCAL, SolverParams, SolverStats
from . import stag_fast as sf
from . import stag_hisq as sh


def _sizes(lm: LatticeMesh) -> tuple[int, ...]:
    sizes = tuple(lm.rank_geom)
    if len(sizes) != 4:
        raise ValueError("sharded fast path requires a 4D lattice mesh")
    if sizes[0] != 1 or sizes[1] != 1:
        raise ValueError(
            f"rank geometry {sizes} shards x/y; the fast layout's minor "
            "axis is merged Y*X -- use rank_geom=(1,1,gz,gt)")
    return sizes


def local_lattice(lat: Lattice, sizes) -> Lattice:
    X, Y, Z, T = lat.dims
    if (Z // sizes[2]) % 2 != 0:
        raise ValueError("local Z extent must be even")
    return Lattice((X, Y, Z // sizes[2], T // sizes[3]), nc=lat.nc)


def mesh_usable(lm: LatticeMesh | None, lat: Lattice,
                naik: bool = False) -> bool:
    """True when the block kernel path supports this mesh and lattice:
    x/y unsplit, even local Z, packed t divisible; the distance-3 (naik)
    hop also needs local Z >= 3 and local Th >= 2."""
    if lm is None or lat.nd != 4:
        return False
    sizes = lm.rank_geom
    if sizes[0] != 1 or sizes[1] != 1:
        return False
    if lat.dims[2] % sizes[2] or (lat.dims[2] // sizes[2]) % 2:
        return False
    if (lat.dims[3] // 2) % sizes[3]:
        return False
    if naik:
        if lat.dims[2] // sizes[2] < 3:
            return False
        if (lat.dims[3] // 2) // sizes[3] < 2:
            return False
    return True


def _check_local3(lat_l: Lattice) -> None:
    if lat_l.dims[2] < 3:
        raise ValueError("sharded HISQ path needs local Z extent >= 3")
    if lat_l.dims[3] < 4:
        raise ValueError("sharded HISQ path needs local Th extent >= 2")


# --- blocks of fast-layout fields --------------------------------------------

def _fast_slices(lm: LatticeMesh, coords=None) -> tuple[slice, slice]:
    """(Th, Z) slices of the block at ``coords`` (default: this rank)."""
    _, _, sz, st_ = lm.block_slices(coords)
    return (slice(st_.start // 2, st_.stop // 2), sz)


def fast_block(lm: LatticeMesh, v: torch.Tensor) -> torch.Tensor:
    """This rank's block of a fast-layout field (..., Th, Z, Y*X),
    contiguous."""
    return local_block(lm, v, "fast")


def gather_fast(lm: LatticeMesh, block: torch.Tensor) -> torch.Tensor:
    """The global fast-layout field from every rank's block."""
    X, Y, Z, T = lm.lat.dims
    out = block.new_empty(block.shape[:-3] + (T // 2, Z, Y * X))
    for r, part in enumerate(lm.all_gather(block)):
        th, z = _fast_slices(lm, np.unravel_index(r, lm.rank_geom))
        out[..., th, z, :] = part
    return out


def block_of(lm: LatticeMesh, f):
    """This rank's block of a whole ``stag_fast.FastStagEO`` or
    ``FastStag3EO``, on the local lattice (what ``staggered.new_stag_eo``
    and ``stag_fast.new_fast`` build from the block under the mesh)."""
    lat_l = local_lattice(lm.lat, _sizes(lm))
    if isinstance(f, sf.FastStag3EO):
        return sf.FastStag3EO(lat_l, *(fast_block(lm, g) for g in (
            f.gf_e, f.gf_o, f.gl_e, f.gl_o)))
    return sf.FastStagEO(lat_l, fast_block(lm, f.g_e), fast_block(lm, f.g_o))


def _check_block(lm: LatticeMesh, f) -> None:
    if tuple(f.lat.dims) != tuple(lm.local_dims):
        raise ValueError(f"links on lattice {f.lat.dims}: the mesh's "
                         f"operators take this rank's block "
                         f"{lm.local_dims}")


# --- the local hop and its surface correction --------------------------------

def hop3_ref(lat_l: Lattice, l: torch.Tensor, x: torch.Tensor,
             parity_out: int) -> torch.Tensor:
    """The local-periodic hop of a block in plain torch: the kernels'
    twin (``stag_hisq._hop_plain``) on term-major links ``l`` (8 or 16
    terms) and a complex block ``x``."""
    return sh._hop_plain(lat_l, l, x, parity_out, None, 0.0)


def hop3_fix(lm: LatticeMesh, lat_l: Lattice, l: torch.Tensor,
             x: torch.Tensor, parity_out: int, out: torch.Tensor,
             sign: float = 1.0) -> torch.Tensor:
    """Add ``sign`` times the exact boundary correction of the
    local-periodic hop to ``out`` (in place; returned).

    Fixes terms 2/6 (fat z), 10/14 (long z, 3-plane halos), 3/7 (fat t)
    and 11/15 (long t: packed th moves by 1 or 2 under the eo parity
    select, as ``stag_fast.shift_fast`` with dist 3).  With 8-term links
    only the fat terms exist and the halo slabs are single planes."""
    sizes = _sizes(lm)
    naik = l.shape[0] == 16
    zs, ts = (3, 2) if naik else (1, 1)     # z and packed-t slab depths
    Zl, Thl = x.shape[-2], x.shape[-3]

    def lk(term, *idx):
        v = l[(term, slice(None), slice(None), slice(None)) + idx]
        v = v.to(x.real.dtype)
        return torch.complex(v[0], v[1])

    # the z and t faces travel in one batch
    faces = {}
    if sizes[2] > 1:
        faces[2] = (x[:, :, 0:zs], x[:, :, Zl - zs:Zl])
    if sizes[3] > 1:
        faces[3] = (x[:, 0:ts], x[:, Thl - ts:Thl])
    halos = lm.exchange_faces(faces)

    if sizes[2] > 1:
        (lo, hi), (nxt, prv) = faces[2], halos[2]
        d_lo, d_hi = sign * (nxt - lo), sign * (prv - hi)
        # fat z fwd (term 2) at plane Zl-1 <- delta of plane 0
        out[:, :, Zl - 1] += torch.einsum(
            "abtk,btk->atk", lk(2, slice(None), Zl - 1), d_lo[:, :, 0])
        # fat z bwd (term 6) at plane 0 <- delta of plane Zl-1
        out[:, :, 0] += torch.einsum(
            "abtk,btk->atk", lk(6, slice(None), 0), d_hi[:, :, zs - 1])
        if naik:
            # long z fwd (term 10): planes Zl-3..Zl-1 <- deltas 0..2
            out[:, :, Zl - 3:Zl] += torch.einsum(
                "abtzk,btzk->atzk", lk(10, slice(None), slice(Zl - 3, Zl)),
                d_lo)
            # long z bwd (term 14): planes 0..2 <- deltas Zl-3..Zl-1
            out[:, :, 0:3] += torch.einsum(
                "abtzk,btzk->atzk", lk(14, slice(None), slice(0, 3)), d_hi)

    if sizes[3] > 1:
        s_par = sf.odd_t(lat_l, parity_out, x.device)     # (Z, Y*X)
        (lo, hi), (nxt, prv) = faces[3], halos[3]
        d_lo, d_hi = sign * (nxt - lo), sign * (prv - hi)
        zero = torch.zeros_like(d_lo[:, 0])

        def fix_t(term, th_out, delta):
            out[:, th_out] += torch.einsum("abzk,bzk->azk",
                                           lk(term, th_out), delta)

        # fat t fwd (term 3): psi(x+t) = sel(s, psi[th+1], psi[th]);
        # wrapped only at th = Thl-1 where s holds
        fix_t(3, Thl - 1, torch.where(s_par, d_lo[:, 0], zero))
        # fat t bwd (term 7): sel(s, psi[th], psi[th-1]); th = 0, !s
        fix_t(7, 0, torch.where(s_par, zero, d_hi[:, ts - 1]))
        if naik:
            # long t fwd (term 11): sel(s, psi[th+2], psi[th+1])
            fix_t(11, Thl - 1, torch.where(s_par, d_lo[:, 1], d_lo[:, 0]))
            fix_t(11, Thl - 2, torch.where(s_par, d_lo[:, 0], zero))
            # long t bwd (term 15): sel(s, psi[th-1], psi[th-2])
            fix_t(15, 0, torch.where(s_par, d_hi[:, 1], d_hi[:, 0]))
            fix_t(15, 1, torch.where(s_par, zero, d_hi[:, 1]))
    return out


def _hop(lm: LatticeMesh, p, x: torch.Tensor, parity_out: int,
         x_fuse: torch.Tensor | None = None, m2: float = 0.0
         ) -> torch.Tensor:
    """The corrected hop of a block: the kernel (CUDA) or its twin (CPU)
    with local wraps, fused epilogue ``m2 * x_fuse - hop`` with
    ``x_fuse``, then the surface correction."""
    kernel = sh.dslash_stag8 if isinstance(p, sh.Stag8EO) else \
        sh.dslash_hisq16
    y = kernel(p, x, parity_out, x_fuse, m2)
    links = p.l_e if parity_out == 0 else p.l_o
    return hop3_fix(lm, p.lat, links, x, parity_out, y,
                    -1.0 if x_fuse is not None else 1.0)


def d2ee_sharded(lm: LatticeMesh, p, x: torch.Tensor, m: float
                 ) -> torch.Tensor:
    """(m^2 - D_eo D_oe) x on blocks: ``p`` the links built from this
    rank's block (:func:`ops8`), ``x`` its even block."""
    _sizes(lm)
    t = _hop(lm, p, x, 1)
    return _hop(lm, p, t, 0, x_fuse=x, m2=m * m)


def d2dd_sharded(lm: LatticeMesh, p, x: torch.Tensor, parity: int = 0
                 ) -> torch.Tensor:
    """Mass-free normal operator -D D on blocks (multishift base)."""
    _sizes(lm)
    t = _hop(lm, p, x, 1 - parity)
    return _hop(lm, p, t, parity, x_fuse=x, m2=0.0)


def d2ee3_sharded(lm: LatticeMesh, p, x: torch.Tensor, m: float
                  ) -> torch.Tensor:
    """(m^2 - D3_eo D3_oe) for the fat + naik operator on blocks."""
    _check_local3(local_lattice(lm.lat, _sizes(lm)))
    return d2ee_sharded(lm, p, x, m)


def d2dd3_sharded(lm: LatticeMesh, p, x: torch.Tensor, parity: int = 0
                  ) -> torch.Tensor:
    """Mass-free fat + naik normal operator on blocks."""
    _check_local3(local_lattice(lm.lat, _sizes(lm)))
    return d2dd_sharded(lm, p, x, parity)


# --- operator factories and solves ------------------------------------------

def _links_dtype(links: torch.Tensor, links_dtype) -> torch.dtype:
    """float32 on the card (the kernels' links), the links' own real
    precision on the host (the twin computes in x's precision)."""
    if links_dtype is not None:
        return links_dtype
    return torch.float32 if links.is_cuda else links.real.dtype


def ops8(lm: LatticeMesh, fs: sf.FastStagEO, links_dtype=None) -> tuple:
    """``(d2ee(v, m), d2dd(v))`` on this rank's blocks of fast-layout
    vectors, through the 8-term kernel (B1; B1b with bfloat16 links):
    ``fs`` this rank's block of the links (:func:`block_of`)."""
    _sizes(lm)
    _check_block(lm, fs)
    with use_mesh(lm):
        p = sh.new_stag8(fs, _links_dtype(fs.g_e, links_dtype))
    return partial(d2ee_sharded, lm, p), partial(d2dd_sharded, lm, p,
                                                 parity=0)


def ops16(lm: LatticeMesh, f3: sf.FastStag3EO, links_dtype=None) -> tuple:
    """``(d2ee3(v, m), d2dd3(v))`` on blocks through the 16-term kernel
    (B2; B2b with bfloat16 links), ``f3`` this rank's block."""
    _check_local3(local_lattice(lm.lat, _sizes(lm)))
    _check_block(lm, f3)
    with use_mesh(lm):
        p = sh.new_hisq16(f3, _links_dtype(f3.gf_e, links_dtype))
    return partial(d2ee_sharded, lm, p), partial(d2dd_sharded, lm, p,
                                                 parity=0)


def sharded_ops(lm: LatticeMesh, f, sloppy: bool = False,
                m: float | None = None) -> tuple:
    """``(op, op_sloppy)`` on blocks, as ``stag_solve.fast_ops``: the
    even-site normal operator (mass-free with ``m`` None) of a
    ``FastStagEO`` (8 terms) or ``FastStag3EO`` (16 terms) and, with
    ``sloppy``, the same on bf16-rounded links (else None)."""
    make = ops16 if isinstance(f, sf.FastStag3EO) else ops8

    def bind(ldt):
        ee, dd = make(lm, f, ldt)
        return dd if m is None else partial(ee, m=m)
    return bind(None), (bind(torch.bfloat16) if sloppy else None)


def solve_ee_sharded(lm: LatticeMesh, s, b_e: torch.Tensor, m: float,
                     params: SolverParams | None = None
                     ) -> tuple[torch.Tensor, SolverStats]:
    """Even-site solve of (m^2 - D_eo D_oe) x_e = b_e, domain-decomposed.

    ``s`` this rank's block of a ``staggered.StaggeredEO`` or
    ``stag_fast.FastStagEO`` and ``b_e`` its block of the canonical
    even-site right-hand side; returns its block of x_e.
    ``params.sloppy`` takes bf16 inner iterations (B1b) with
    true-residual restarts on B1 and the inner floor 1e-5, as
    ``stag_solve.solve_ee``."""
    params = params or SolverParams()
    lat = lm.lat
    fs = s if isinstance(s, sf.FastStagEO) else sf.new_fast(s)
    op, op_sloppy = sharded_ops(lm, fs, params.sloppy, m=m)
    op_true, floor = None, 1e-12
    if op_sloppy is not None:
        op, op_true, floor = op_sloppy, op, 1e-5
    x, stats = cg.cg_solve_restarted(
        op, sf.to_fast(b_e, lat), r2req=params.r2req,
        maxits=params.maxits, restarts=params.restarts, op_true=op_true,
        inner_r2req_floor=floor, dots=halo.reductions(lm))
    return sf.from_fast(x, lat), stats


def solve_multi_sharded(lm: LatticeMesh, s3, b_e: torch.Tensor, masses,
                        params: SolverParams | None = None
                        ) -> tuple[list[torch.Tensor], SolverStats]:
    """Multi-mass HISQ even-site solve (multishift CG on the 16-term
    operator on blocks), BASELINE config 5's solve domain-decomposed:
    ``s3`` this rank's block of a ``staggered.Staggered3EO`` or
    ``stag_fast.FastStag3EO``, ``b_e`` its block of the right-hand
    side; returns its blocks of the canonical-layout solutions."""
    params = params or SolverParams()
    lat = lm.lat
    f3 = s3 if isinstance(s3, sf.FastStag3EO) else sf.new_fast3(s3)
    dd, _ = sharded_ops(lm, f3)
    xs, stats = cgm.cg_multishift(
        dd, sf.to_fast(b_e, lat), [m * m for m in masses],
        r2req=params.r2req, maxits=params.maxits, dots=halo.reductions(lm))
    return [sf.from_fast(x, lat) for x in xs], stats


def require_usable(lm: LatticeMesh, naik: bool = False) -> None:
    """Raise a ``ValueError`` naming the local extents where the block
    kernels cannot take ``lm`` (:func:`mesh_usable`)."""
    if not mesh_usable(lm, lm.lat, naik=naik):
        raise ValueError(
            f"rank geometry {lm.rank_geom} of lattice {lm.lat.dims} gives "
            f"blocks {lm.local_dims}: the block kernels need x and y "
            "unsplit, an even local Z and the packed T divisible"
            + (", and for the 16 terms local Z >= 3 and local T/2 >= 2"
               if naik else "") + "; there is no whole field to fall "
            "back on")


def solve_route(mesh: LatticeMesh | None, f, sloppy: bool, m: float | None,
                whole_ops) -> tuple:
    """``(op, op_sloppy, dots)`` of a fast-layout solve on ``f``'s
    links: on this rank's blocks of ``mesh`` (default: the active mesh,
    ``parallel.mesh.use_mesh``) through :func:`sharded_ops`, with
    all-reduced sums, the right-hand side and the solution then being
    blocks too; with no mesh on the whole field through ``whole_ops()``
    -> ``(op, op_sloppy)`` with one process's sums.  A mesh the block
    kernels cannot take raises (:func:`require_usable`)."""
    lm = mesh if mesh is not None else active()
    if lm is None:
        op, op_sloppy = whole_ops()
        return op, op_sloppy, LOCAL
    require_usable(lm, naik=isinstance(f, sf.FastStag3EO))
    op, op_sloppy = sharded_ops(lm, f, sloppy, m=m)
    return op, op_sloppy, halo.reductions(lm)
