"""Fast-layout eo Wilson operator with half-spinor projection (port of
``qex_tpu.physics.wilson_fast``).

Spinors are stored ``(ns, nc, Th, Z, Y*X)`` (the :mod:`.stag_fast`
layout).  (1 -+ gamma_mu) has rank 2, so each direction needs only two
3x3 color matvecs: the projector pair comes from the exact
eigendecomposition (1 -+ g) = B B^dag with B (4, 2).  Semantics equal
``wilson.wilson_hop_eo`` / ``wilson_m_ee``; this plain operator is the
independent check of the kernel's spin algebra in :mod:`.wilson_pallas`.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..lattice import Lattice
from ..ops import linalg
from . import stag_fast as sf
from . import wilson as wl


@lru_cache(maxsize=None)
def _half_basis(mu: int, sign: int) -> np.ndarray:
    """B with (1 - sign*gamma_mu) = B @ B^dag, B shape (4, 2)."""
    g = wl.gamma_matrices()[mu]
    a = np.eye(4, dtype=complex) - sign * np.asarray(g)
    w, v = np.linalg.eigh(a)
    cols = np.argsort(w)[-2:]          # the two eigenvalue-2 directions
    return v[:, cols] * np.sqrt(w[cols])[None, :]


@dataclasses.dataclass(frozen=True)
class FastWilsonEO:
    """Fast-layout eo Wilson operator (links per parity, diag a=nd+m)."""

    lat: Lattice
    g_e: torch.Tensor   # (nd, nc, nc, Th, Z, Y*X)
    g_o: torch.Tensor
    m: float

    @property
    def a(self) -> float:
        return self.lat.nd + self.m


def new_fast_wilson(w: wl.WilsonEO) -> FastWilsonEO:
    if w.lat.nd != 4:
        raise ValueError("fast path requires nd=4")
    return FastWilsonEO(w.lat, sf.to_fast(w.g_e, w.lat),
                        sf.to_fast(w.g_o, w.lat), w.m)


def _spin(mat: np.ndarray, psi: torch.Tensor) -> torch.Tensor:
    m = torch.as_tensor(mat, dtype=psi.dtype, device=psi.device)
    return torch.einsum("st,tc...->sc...", m, psi)


def _mv2(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Apply the 3x3 color matrix field to a (2, nc, ...) half-spinor."""
    return torch.stack([linalg.mv(g, h[0]), linalg.mv(g, h[1])])


def _mv2_an(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.stack([linalg.mv_an(g, h[0]), linalg.mv_an(g, h[1])])


def hop_fast(w: FastWilsonEO, psi_src: torch.Tensor, parity_out: int
             ) -> torch.Tensor:
    """Hopping term onto ``parity_out`` in the fast layout:
    1/2 sum_mu [(1-g_mu) U psi(x+mu) + (1+g_mu) U(x-mu)^dag psi(x-mu)]
    computed through rank-2 half-spinors."""
    lat = w.lat
    g_out = w.g_e if parity_out == 0 else w.g_o
    g_src = w.g_o if parity_out == 0 else w.g_e
    out = None
    for mu in range(4):
        bf = _half_basis(mu, +1)       # (1 - g) = bf bf^dag
        bb = _half_basis(mu, -1)       # (1 + g) = bb bb^dag
        # forward: bf (U_mu(x) (bf^dag psi)(x+mu))
        h = _spin(bf.conj().T, sf.shift_fast(psi_src, mu, +1, parity_out,
                                             lat))
        fwd = _spin(bf, _mv2(g_out[mu], h))
        # backward: bb (U_mu(x-mu)^dag (bb^dag psi)(x-mu))
        t = _mv2_an(g_src[mu], _spin(bb.conj().T, psi_src))
        bwd = _spin(bb, sf.shift_fast(t, mu, -1, parity_out, lat))
        term = fwd + bwd
        out = term if out is None else out + term
    return 0.5 * out


def m_ee_fast(w: FastWilsonEO, x_e: torch.Tensor) -> torch.Tensor:
    """Schur complement M = a - H_eo H_oe / a (wilson.wilson_m_ee)."""
    t = hop_fast(w, x_e, parity_out=1)
    return w.a * x_e - hop_fast(w, t, parity_out=0) / w.a


def m_ee_dag_fast(w: FastWilsonEO, x_e: torch.Tensor) -> torch.Tensor:
    g5 = wl.gamma_matrices()[4]
    return _spin(g5, m_ee_fast(w, _spin(g5, x_e)))
