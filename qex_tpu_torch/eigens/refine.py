"""Rayleigh-Ritz and inverse-iteration refinement of approximate
eigenpairs (port of ``qex_tpu.eigens.refine``).

The complex64 Lanczos stalls at true residuals ~1e-5..1e-3 at production
volumes: each projection coefficient is a float32 reduction over ~5e6
elements.  Both polishes here work on a small subspace built from the
approximate vectors and compute every inner product of it -- Gram
matrices, norms, the Galerkin right-hand sides -- in complex128,
upcasting the complex64 vectors for each reduction.  The JAX package
forms the same entries with its two-float compensated sums
(``ops/dsum``), which exist because the TPU has no float64; the card has
it, so ``dsum`` is not ported.  The small dense problems (generalized
eigenproblems, the Galerkin solve) run on the host in complex128.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops import linalg
from ..solvers import cg as cgmod
from .lanczos import bind, combine


def norms(x: torch.Tensor) -> torch.Tensor:
    """2-norms of stacked vectors, accumulated in float64 (on x's
    device)."""
    return torch.linalg.vector_norm(
        x.reshape(x.shape[0], -1).to(torch.complex128), dim=1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    """Stacked vectors scaled to unit norm."""
    nrm = torch.clamp(norms(x), min=1e-30).to(x.real.dtype)
    return x / nrm.reshape((-1,) + (1,) * (x.dim() - 1))


def _apply(op: Callable, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([op(x) for x in v])


def _herm(h: torch.Tensor) -> np.ndarray:
    """The hermitian part of a Gram matrix, on the host."""
    h = h.cpu().numpy()
    return 0.5 * (h + h.conj().T)


def _pencil(h: np.ndarray, g: np.ndarray):
    """Eigenpairs (theta, c) of the pencil H c = theta G c through
    G^{-1/2}, G's directions below 1e-5 of its largest eigenvalue
    masked (G ~ I by construction)."""
    gl, gq = np.linalg.eigh(g)
    isq = np.where(gl > 1e-5 * np.max(gl),
                   1.0 / np.sqrt(np.maximum(gl, 1e-30)), 0.0)
    rm = (gq * isq[None, :]) @ gq.conj().T
    h = rm @ h @ rm.conj().T
    th, y = np.linalg.eigh(0.5 * (h + h.conj().T))
    return th, rm @ y        # rm is hermitian: pencil vectors c = rm y


def _finals(op: Callable, v: torch.Tensor):
    """Rayleigh quotients (complex128 Gram diagonal) and true residual
    norms |A v - theta v| of stacked unit vectors, as float64 numpy."""
    w = _apply(op, v)
    th = linalg.gram(v, w).diagonal().real.cpu().numpy()
    tht = torch.as_tensor(th, dtype=v.real.dtype, device=v.device)
    rs = norms(w - tht.reshape((-1,) + (1,) * (v.dim() - 1)) * v)
    return th, rs.cpu().numpy()


def rr_refine_dev(op: Callable, vecs: torch.Tensor, op_args=(),
                  iters: int = 2, which: str = "smallest",
                  depth: int = 2, filt: Callable | None = None):
    """Refine ``vecs`` (stacked (n, ...) approximate eigenvectors of the
    hermitian PSD operator ``op(v, *op_args)``) by block Rayleigh-Ritz
    over span[V, R, A R, ..., A^{depth-1} R], R the residual directions.

    ``filt``: optional low-pass polynomial ``filt(v, *op_args)`` (e.g.
    ``chebyshev_filter`` with the eigensolve's window) applied to the
    vectors at the start of every iteration; needed where the targets
    sit far below eps * |A| (the JAX docstring's measurement).

    Returns (evals, vecs, resids, info): float64 Rayleigh quotients, the
    refined vectors, float64 true residual norms |A v - theta v|."""
    aop = bind(op, op_args)
    n = vecs.shape[0]
    desc = which == "largest"
    v = vecs
    for _ in range(iters):
        if filt is not None:
            v = _unit(_apply(bind(filt, op_args), v))
        w = _apply(aop, v)
        # block-Krylov expansion: each level's block is the previous
        # level's image, Gram-Schmidt'd against every block built so far
        blocks, images, cur = [v], [w], w
        for _lvl in range(depth):
            r = cur
            for bq in blocks:
                r = r - combine(linalg.gram(bq, r).cpu().numpy(), bq)
            r = _unit(r)
            ar = _apply(aop, r)
            blocks.append(r)
            images.append(ar)
            cur = ar
        s = torch.cat(blocks)
        th, cc = _pencil(_herm(linalg.gram(s, torch.cat(images))),
                         _herm(linalg.gram(s, s)))
        # masked directions of G give spurious theta ~ 0 with pencil
        # vectors ~ 0; push them to the far end before ordering
        th = np.where(np.linalg.norm(cc, axis=0) < 1e-3,
                      -np.inf if desc else np.inf, th)
        order = np.argsort(-th if desc else th)
        v = _unit(combine(cc[:, order[:n]], s))
    evals, resids = _finals(aop, v)
    return evals, v, resids, {"iters": iters, "depth": depth,
                              "matvecs": (1 + depth) * n * iters + n}


def refine_inverse_dev(op: Callable, vecs: torch.Tensor, op_args=(),
                       iters: int = 2, r2req: float = 1e-10,
                       maxits: int = 500, restarts: int = 2):
    """Deflated inverse iteration for tiny clustered eigenvalues (the
    Dirac low band): each vector is replaced by A^{-1} v, its in-band
    part from the Galerkin projector over the current vectors and the
    rest by restarted CG, then a block Rayleigh-Ritz over the new
    vectors re-diagonalizes in band.

    Returns (evals, vecs, resids, info) like :func:`rr_refine_dev`."""
    aop = bind(op, op_args)
    n = vecs.shape[0]
    v = vecs
    for _ in range(iters):
        gm = _herm(linalg.gram(v, _apply(aop, v)))

        def galerkin(r):
            y = np.linalg.solve(gm, linalg.gram(v, r[None])[:, 0].cpu()
                                .numpy())
            return combine(y[:, None], v)[0]

        new = []
        for x in v:
            x0 = galerkin(x)
            z, _ = cgmod.cg_solve_restarted(aop, x - aop(x0), r2req=r2req,
                                            maxits=maxits,
                                            restarts=restarts)
            new.append(x0 + z)
        vn = _unit(torch.stack(new))
        # in-band block Rayleigh-Ritz re-diagonalization
        _th, cc = _pencil(_herm(linalg.gram(vn, _apply(aop, vn))),
                          _herm(linalg.gram(vn, vn)))
        v = _unit(combine(cc[:, :n], vn))
    evals, resids = _finals(aop, v)
    return evals, v, resids, {"iters": iters}
