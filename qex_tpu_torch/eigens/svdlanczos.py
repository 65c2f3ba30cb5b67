"""Golub-Kahan-Lanczos SVD of the Dirac operator (port of
``qex_tpu.eigens.svdlanczos``).

Unlike the hermitian thick restart on the normal operator D^dag D, this
works on D itself: the bidiagonalization squares nothing, so tiny
singular values keep their relative precision.

Golub-Kahan bidiagonalization with Baglama-Reichel thick restart
(IRLBA, SIAM J. Sci. Comput. 27(1), 2005) and full two-sided
reorthogonalization:

    D v_j     = alpha_j u_j + beta_{j-1} u_{j-1}
    D^dag u_j = alpha_j v_j + beta_j v_{j+1}

After m steps the projected operator is the (m x m) upper-bidiagonal B;
its SVD B = P S Q^T gives Ritz triplets (sigma_i, U P_i, V Q_i) with
residual bound |D^dag u_i - sigma_i v_i| = beta_m |P[m-1, i]|.  The
restart keeps k triplets plus the last right-residual direction.

The JAX package's host loop (``svd_lanczos``) and device driver
(``svd_lanczos_dev``) are one driver here: it keeps the bases as tensors
on the vectors' device, orthogonalizes by batched two-pass classical
Gram-Schmidt and reads B to the host once per restart cycle, where its
SVD runs in float64.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops import linalg
from . import lanczos
from .lanczos import bind, combine, gs_pass


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(linalg.norm2(v))


def _ordered_svd(b: np.ndarray, desc: bool):
    p, s, qt = np.linalg.svd(b)          # numpy: descending sigma
    if not desc:
        p, s, qt = p[:, ::-1], s[::-1], qt[::-1, :]
    return p, s, qt


def _restart_size(n: int, m: int) -> int:
    if m < n + 3:
        raise ValueError(f"m={m} too small for n={n}")
    return min(n + max(3, n // 2), m - 3)


def _gs2(basis: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return gs_pass(basis, gs_pass(basis, w)[0])[0]


def svd_lanczos_dev(av: Callable, ahv: Callable, example_v: torch.Tensor,
                    n: int, *, m: int = 30, max_restarts: int = 100,
                    tol: float = 1e-8, which: str = "smallest",
                    seed: int = 0, op_args=()):
    """Thick-restart GKL with the bases as tensors ``Ub`` (m, *range)
    and ``Vb`` (m+1, *domain) on the vectors' device, batched two-pass
    Gram-Schmidt, and B read to the host once per cycle.  As the JAX
    drivers, the relative residual bound is tested against ``tol``.

    av(v, *op_args) = D v (domain -> range), ahv(u, *op_args) = D^dag u.
    Returns (sigma[n], U[n, ...range], V[n, ...domain], info)."""
    if max_restarts < 1:
        raise ValueError(f"max_restarts must be >= 1, got {max_restarts}")
    k = _restart_size(n, m)
    av, ahv = bind(av, op_args), bind(ahv, op_args)
    desc = which == "largest"
    dev, rdt = example_v.device, example_v.real.dtype
    v = lanczos.start_vector(example_v, seed)
    v = v / _norm(v)
    u0 = av(v)
    a0 = _norm(u0)
    ub = torch.zeros((m,) + tuple(u0.shape), dtype=u0.dtype, device=dev)
    vb = torch.zeros((m + 1,) + tuple(v.shape), dtype=v.dtype, device=dev)
    bd = torch.zeros((m, m), dtype=rdt, device=dev)
    ub[0] = u0 / torch.clamp(a0, min=1e-30)
    vb[0] = v
    bd[0, 0] = a0
    info = {"cycles": 0, "matvecs": 1}
    k0 = 1
    for cycle in range(max_restarts):
        for j in range(k0, m):
            w = _gs2(vb[:j], ahv(ub[j - 1]))
            b = _norm(w)
            vb[j] = w / torch.clamp(b, min=1e-30)
            uw = _gs2(ub[:j], av(vb[j]))
            a = _norm(uw)
            ub[j] = uw / torch.clamp(a, min=1e-30)
            bd[j - 1, j] = b
            bd[j, j] = a
        w = _gs2(vb[:m], ahv(ub[m - 1]))      # next coupling beta_m
        beta = _norm(w)
        info["matvecs"] += 2 * (m - k0) + 1
        bmat = bd.to("cpu", torch.float64).numpy()      # one read a cycle
        beta_m = float(beta)
        p, s, qt = _ordered_svd(bmat, desc)
        res = np.abs(beta_m * p[m - 1, :n])
        scale = max(s[0], s[-1], 1e-30)
        relres = float(res.max() / scale)
        info["cycles"] = cycle + 1
        if relres <= tol or cycle == max_restarts - 1:
            break
        # restart state
        uk, vk = combine(p[:, :k], ub), combine(qt.T[:, :k], vb[:m])
        vb[k] = w / max(beta_m, 1e-30)
        vb[:k] = vk
        ub[:k] = uk
        uw = _gs2(ub[:k], av(vb[k]))
        a = _norm(uw)
        ub[k] = uw / torch.clamp(a, min=1e-30)
        info["matvecs"] += 1
        bd.zero_()
        bd.diagonal()[:k] = torch.as_tensor(s[:k].copy(), dtype=rdt,
                                            device=dev)
        bd[:k, k] = torch.as_tensor(beta_m * p[m - 1, :k], dtype=rdt,
                                    device=dev)
        bd[k, k] = a
        k0 = k + 1
    info["residual"] = float(res.max())
    info["relative_residual"] = relres
    info["converged"] = bool(relres <= tol)
    return (s[:n].copy(), combine(p[:, :n], ub),
            combine(qt.T[:, :n], vb[:m]), info)


# The JAX package's host loop (see lanczos.eigs_hermitian).
svd_lanczos = svd_lanczos_dev


def svd_stag(lat, u, n: int, *, bc: str = "pppa", mass0: bool = True, **kw):
    """Lowest singular triplets of the staggered eo hopping block D_oe
    (even -> odd): sigma(D_oe) = |lambda(Dslash)| at m=0.

    On the card D_oe and D_eo run in the fast layout through the 8-term
    kernel's single-parity hop (``stag_hisq.dslash_stag8``: its
    parity-1 output is D_oe, its parity-0 output D_eo, with the same
    +-1/2 convention as ``staggered.dslash_eo``); on the CPU through the
    plain ``staggered.dslash_eo``.  ``(D_oe)^dag = -D_eo`` for the antihermitian staggered
    Dslash.  Returns (sigma, U_odd, V_even, info), vectors in the
    canonical even-odd layout (n, nc, *dims_h)."""
    from ..physics import stag_fast as sf
    from ..physics import stag_hisq as sh
    from ..physics import staggered as st
    s = st.new_stag_eo(lat, u, bc)
    if u.is_cuda:
        p8 = sh.new_stag8(sf.new_fast(s))
        example = torch.zeros((lat.nc, lat.dims[3] // 2, lat.dims[2],
                               lat.dims[1] * lat.dims[0]), dtype=u.dtype,
                              device=u.device)
        sig, uo, ve, info = svd_lanczos_dev(
            lambda v: sh.dslash_stag8(p8, v, 1),
            lambda w: -sh.dslash_stag8(p8, w, 0), example, n, **kw)
        return sig, sf.from_fast(uo, lat), sf.from_fast(ve, lat), info
    example = torch.zeros((lat.nc,) + tuple(s.g_e.shape[3:]), dtype=u.dtype,
                          device=u.device)
    return svd_lanczos_dev(lambda v: st.dslash_eo(s, v, parity_out=1),
                       lambda w: -st.dslash_eo(s, w, parity_out=0),
                       example, n, **kw)
