"""Production staggered eigensolver driver (port of
``qex_tpu.eigens.hisqev``): the lowest eigenpairs of the even-odd normal
operator, plain staggered or fat + naik (HISQ), with the spectral window
calibrated, the Dslash singular values, true residuals and grep-able
``EIGEN`` report lines.

The eigensolve runs in the fast layout ``(nc, Th, Z, Y*X)``: a vector on
the card goes through the 8-term kernel (B1, ``stag_hisq.d2dd_stag8``)
for plain staggered and the 16-term kernel (B2,
``stag_hisq.d2dd_hisq16``) for fat + naik links; a CPU vector through
the plain fast-layout operators (the same rule as
``stag_solve.fast_ops``).  The JAX package converts the layout inside
every operator apply; here it converts once around the whole solve
(inner products do not depend on the layout).  ``EigResult.vecs`` keeps
the canonical even-site layout ``(n, nc, *dims_h)``, which deflation and
the apps consume.

On a rank mesh (inside ``parallel.mesh.use_mesh``) ``u`` is this rank's
block: the operator runs on the block kernels
(``stag_shard.solve_route``), the Lanczos basis is a tensor of blocks
with all-reduced dots (``eigens.lanczos``), and ``EigResult.vecs`` holds
this rank's blocks of the eigenvectors.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import numpy as np
import torch

from ..lattice import Lattice
from ..parallel import mesh as pmesh
from ..physics import stag_fast as sf
from ..physics import staggered as st
from .chebyshev import (eigs_filtered, estimate_spectral_range,
                        estimate_spectral_range_dev)


@dataclasses.dataclass(frozen=True)
class EigResult:
    """Lowest-n spectrum of A = -D_eo D_oe (the caller adds m^2 where it
    needs the shifted operator): eigenvalues, Dslash singular values,
    true residuals, and solver statistics."""

    evals: np.ndarray        # eigenvalues of the mass-free normal op
    svals: np.ndarray        # sqrt(evals): |Dslash| singular values
    vecs: torch.Tensor       # (n, nc, *dims_h) even-site eigenvectors
    resids: np.ndarray       # true residuals |A v - theta v|
    info: dict


def _normal_op(lat: Lattice, u: torch.Tensor | None, bc: str, naik: bool,
               links=None, m: float | None = None
               ) -> tuple[Callable, torch.Tensor]:
    """(op, example): the even-site normal operator -D_eo D_oe, or
    m^2 - D_eo D_oe with ``m``, on fast-layout vectors, and a zero
    fast-layout vector of the links' dtype and device.

    ``links``: a precomputed (fat, long) pair (e.g. from
    ``gauge.fat7.hisq_links_lowmem``), which implies naik; ``naik``
    alone fattens the phased ``u`` here."""
    from ..physics import stag_hmc, stag_shard, stag_solve
    if lat.nd != 4:
        raise ValueError("the eigensolvers run in the 4-d fast layout")
    if links is None and naik:
        from ..gauge import fat7
        links = fat7.hisq_links_lowmem(lat, st.phase_links(lat, u, bc))
    ref = u if links is None else links[0]
    X, Y, Z, T = pmesh.block_lattice(lat).dims
    example = torch.zeros((lat.nc, T // 2, Z, Y * X), dtype=ref.dtype,
                          device=ref.device)
    if links is None:
        f = sf.new_fast(st.new_stag_eo(lat, u, bc))

        def whole():
            return stag_solve.fast_ops(f, example, m=m)
    else:
        f = sf.new_fast3(st.new_stag3_eo(lat, *links))

        def whole():
            ee, dd = stag_hmc._fast3_ops(f)
            return (dd if m is None else partial(ee, m=m)), None
    return stag_shard.solve_route(None, f, False, m, whole)[0], example


def stag_eigs(lat: Lattice, u: torch.Tensor | None, n: int, *,
              bc: str = "pppa", naik: bool = False, degree: int = 24,
              tol: float = 1e-8, m: int | None = None,
              max_restarts: int = 60, seed: int = 0, links=None,
              verbose: bool = False, refine_iters: int = 0) -> EigResult:
    """Lowest-n eigenpairs of the staggered (or fat + naik HISQ)
    mass-free even-odd normal operator on gauge field ``u``: spectral
    bracket, Chebyshev-filtered Lanczos, per-pair true residuals.

    ``links``: precomputed (fat, long) HISQ links; ``u`` may then be
    None.  ``refine_iters > 0`` follows the Lanczos with that many
    deflated inverse-iteration passes (``refine.refine_inverse_dev``).
    ``m`` is the Lanczos basis size.  Inside ``parallel.mesh.use_mesh``
    it runs on blocks (module docstring); every rank gets the same
    eigenvalues."""
    from .refine import refine_inverse_dev
    if refine_iters > 0 and pmesh.active() is not None:
        raise ValueError("refine_iters runs on whole fields only")
    op, example = _normal_op(lat, u, bc, naik, links)
    evals, vecs, info = eigs_filtered(op, example, n, degree=degree,
                                      tol=tol, m=m,
                                      max_restarts=max_restarts, seed=seed)
    resids = info["true_residuals"]
    if refine_iters > 0:
        evals, vecs, resids, rinfo = refine_inverse_dev(op, vecs,
                                                        iters=refine_iters)
        info = dict(info, refine=rinfo, true_residuals=resids)
    svals = np.sqrt(np.maximum(evals, 0.0))
    if verbose:
        for i, (ev, sv, r) in enumerate(zip(evals, svals, resids)):
            print(f"EIGEN {i} ev {ev:.12g} sv {sv:.12g} resid {r:.3e}")
        print(f"EIGENinfo matvecs {info['matvecs_A']} "
              f"cycles {info['cycles']} window {info['window']}")
    return EigResult(evals, svals, sf.from_fast(vecs, lat), resids, info)


def spectral_range_stag(lat: Lattice, u: torch.Tensor | None, mass: float,
                        *, bc: str = "pppa", naik: bool = False,
                        m: int = 30, links=None) -> tuple[float, float]:
    """(lo, hi) bracket of the shifted normal operator m^2 - D_eo D_oe,
    for the rooted fermion's rational approximation interval; the
    m-step Lanczos runs on the device driver off the CPU."""
    op, example = _normal_op(lat, u, bc, naik, links)
    est = estimate_spectral_range if example.device.type == "cpu" \
        else estimate_spectral_range_dev
    lo, hi = est(op, example, m=m)
    mm = mass * mass
    return max(mm, mm + lo), mm + hi


def deflation_basis(res: EigResult, mass: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(evals + m^2, vecs) for ``solvers.deflate.deflated_cg`` on the
    shifted operator A(m) = m^2 - D_eo D_oe."""
    return torch.as_tensor(res.evals + mass * mass), res.vecs
