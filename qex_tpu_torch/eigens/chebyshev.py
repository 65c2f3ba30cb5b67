"""Chebyshev spectral filtering for the Lanczos eigensolvers (port of
``qex_tpu.eigens.chebyshev``).

A degree-k Chebyshev polynomial of the operator keeps the unwanted part
of the spectrum [a, b] within |T_k| <= 1 and amplifies the modes below
``a`` exponentially in k, so Lanczos on p(A) converges the low modes in
far fewer matvec-equivalents than Lanczos on A.  Eigenvalues of A come
from Rayleigh quotients of the converged filtered Ritz vectors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..parallel import mesh
from . import lanczos
from .lanczos import bind, eigs_hermitian_dev, gs_pass, lanczos_hermitian


def chebyshev_filter(op: Callable, a: float, b: float, degree: int
                     ) -> Callable:
    """v -> T_degree(l(A)) v with l mapping [a, b] -> [-1, 1].

    Modes with eigenvalue x < a are amplified ~ cosh(degree *
    acosh(|l(x)|)); modes inside [a, b] stay bounded by 1.  The filter
    forwards trailing operator arguments: ``filt(v, *op_args)``."""
    if not (b > a):
        raise ValueError(f"need b > a, got [{a}, {b}]")
    center = 0.5 * (b + a)
    half = 0.5 * (b - a)

    def filt(v, *args):
        t0, t1 = v, torch.add(op(v, *args), v, alpha=-center) / half
        if degree == 0:
            return t0
        for _ in range(degree - 1):     # T_{j+1} = 2 l(A) T_j - T_{j-1}
            t0, t1 = t1, (torch.add(op(t1, *args), t1, alpha=-center)
                          .mul_(2.0 / half).sub_(t0))
        return t1

    return filt


def _bracket(al, be, b_last: float, safety: float) -> tuple[float, float]:
    """Extreme Ritz values of the tridiagonal (al, be) padded by the
    residual bound b_last * |last component| times ``safety``."""
    t = np.diag(al) + np.diag(be, 1) + np.diag(be, -1)
    ev, evec = np.linalg.eigh(t)
    lo = ev[0] - safety * abs(b_last * evec[-1, 0])
    hi = ev[-1] + safety * abs(b_last * evec[-1, -1])
    return float(lo), float(hi)


def estimate_spectral_range(op: Callable, example: torch.Tensor,
                            m: int = 30, seed: int = 7,
                            safety: float = 1.05, op_args=()
                            ) -> tuple[float, float]:
    """(lo, hi) bracket of a hermitian operator's spectrum from an m-step
    Lanczos: extreme Ritz values padded by the residual bound times
    ``safety``.  As the JAX host path, the bound uses the last of the
    m-1 couplings."""
    v0 = lanczos.start_vector(example, seed)
    al, be, _ = lanczos_hermitian(bind(op, op_args), v0, m)
    return _bracket(al, be, be[-1] if len(be) else 0.0, safety)


def estimate_spectral_range_dev(op: Callable, example: torch.Tensor,
                                m: int = 30, seed: int = 7,
                                safety: float = 1.05, op_args=()
                                ) -> tuple[float, float]:
    """:func:`estimate_spectral_range` with the basis as one tensor on
    the device and the Lanczos coefficients read to the host once, at
    the end; as the JAX device path, the bound uses the m-th coupling
    (the one out of the Krylov space)."""
    op = bind(op, op_args)
    bb = torch.zeros((m + 1,) + tuple(example.shape), dtype=example.dtype,
                     device=example.device)
    v = lanczos.start_vector(example, seed)
    bb[0] = v / torch.sqrt(lanczos.norm2(v))
    rdt = example.real.dtype
    al = torch.zeros(m, dtype=rdt, device=example.device)
    be = torch.zeros(m, dtype=rdt, device=example.device)
    for j in range(m):
        w, c1 = gs_pass(bb[:j + 1], op(bb[j]))
        w, _ = gs_pass(bb[:j + 1], w)           # second pass
        al[j] = c1[j].real
        be[j] = torch.sqrt(lanczos.norm2(w)) + 1e-300
        bb[j + 1] = w / be[j]
    al = al.to("cpu", torch.float64).numpy()
    be = be.to("cpu", torch.float64).numpy()
    return _bracket(al, be[:m - 1], be[m - 1], safety)


def eigs_filtered(op: Callable, example: torch.Tensor, n_eigs: int, *,
                  degree: int = 20, window: tuple[float, float]
                  | None = None, m: int | None = None,
                  max_restarts: int = 40, tol: float = 1e-8,
                  seed: int = 0, device: bool | None = None,
                  op_args=()) -> tuple[np.ndarray, torch.Tensor, dict]:
    """Lowest ``n_eigs`` eigenpairs of hermitian ``op`` by
    Chebyshev-filtered thick-restart Lanczos.

    ``window`` is the suppressed interval [a, b]; it defaults to
    [lo + 0.1 (hi - lo), hi] from the spectral range estimate.
    Eigenvalues are Rayleigh quotients of A on the converged filtered
    Ritz vectors; ``info["true_residuals"]`` are |A v - theta v|.

    ``device``: take :func:`estimate_spectral_range_dev` for the
    window; default: on any device but the CPU, as the JAX package
    selects its device drivers off its CPU backend, and on a rank mesh's
    blocks, where each of the host loop's per-vector dots would be an
    all-reduce and the batched driver takes three a step.  (Its two
    Lanczos drivers are one here, :func:`lanczos.eigs_hermitian_dev`.)"""
    op = bind(op, op_args)
    if device is None:
        device = example.device.type != "cpu" or mesh.active() is not None
    if window is None:
        est = estimate_spectral_range_dev if device \
            else estimate_spectral_range
        lo, hi = est(op, example)
        window = (lo + 0.1 * (hi - lo), hi)
    # wanted modes map to the largest T_k: l(x) < -1 below the window and
    # T_k(-|x|) = (-1)^k T_k(|x|), so the degree is made even
    degree += degree % 2
    filt = chebyshev_filter(op, window[0], window[1], degree)
    _fvals, vecs, info = eigs_hermitian_dev(
        filt, example, n_eigs, which="largest", m=m,
        max_restarts=max_restarts, tol=tol, seed=seed)
    info["degree"] = degree
    info["window"] = window
    info["matvecs_A"] = info["matvecs"] * degree

    # Rayleigh quotients and true residuals on A, read to the host once
    ths, rs = [], []
    for v in vecs:
        av = op(v)
        th = lanczos.dot(v, av).real
        ths.append(th)
        rs.append(torch.sqrt(lanczos.norm2(av - th * v)))
    thetas = torch.stack(ths).to("cpu", torch.float64).numpy()
    resids = torch.stack(rs).to("cpu", torch.float64).numpy()
    order = np.argsort(thetas)
    info["true_residuals"] = resids[order]
    return thetas[order], vecs[torch.as_tensor(order)], info
