"""Wilson meson correlators (port of the Wilson part of
``qex_tpu.observables.mesons``).

With the point-source propagator S (column (s0, c0) solves
D S = delta_{s0 c0}) and gamma5-hermiticity, the channel with gamma
matrix G is

    C_G(t) = sum_x tr[ G S(x) G^dag g5 S(x)^dag g5 ].

The staggered correlators are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice import Lattice
from ..physics.wilson import gamma_matrices

WILSON_CHANNELS = ("pion", "scalar", "rho_x", "rho_y", "rho_z", "a0",
                   "a1_x", "a1_y", "a1_z")


def _wilson_gamma(ch: str) -> np.ndarray:
    g = gamma_matrices()
    table = {
        "pion": g[4], "scalar": np.eye(4), "a0": np.eye(4),
        "rho_x": g[0], "rho_y": g[1], "rho_z": g[2],
        "a1_x": g[0] @ g[4], "a1_y": g[1] @ g[4], "a1_z": g[2] @ g[4],
    }
    return table[ch]


def wilson_mesons_from_prop(lat: Lattice, props: torch.Tensor,
                            channels=("pion",)) -> dict:
    """Wilson meson two-point functions {channel: C(t)} from the full
    propagator ``props`` of shape (ns_src, nc_src, ns, nc, *dims)."""
    g5 = gamma_matrices()[4]
    spatial = tuple(range(-lat.nd, -1))
    conj = props.conj()
    out = {}
    for ch in channels:
        gm = _wilson_gamma(ch)
        # C(x) = sum N[b,s] S[t,u,s,v] M[t,a] conj(S[a,u,b,v]) with
        # M = G^dag g5, N = g5 G and S indexed [src_spin t, src_col u,
        # snk_spin s, snk_col v] (for G = g5: sum |S|^2, the pion)
        m = torch.as_tensor(gm.conj().T @ g5, dtype=props.dtype,
                            device=props.device)
        n = torch.as_tensor(g5 @ gm, dtype=props.dtype, device=props.device)
        ns_ = torch.einsum("bs,tusv...->tubv...", n, props)
        mns = torch.einsum("ta,tubv...->aubv...", m, ns_)
        c = (mns * conj).sum(dim=(0, 1, 2, 3))
        out[ch] = c.real.sum(dim=spatial)
    return out


def wilson_pion_from_prop(lat: Lattice, props: torch.Tensor) -> torch.Tensor:
    """Wilson pion correlator from stacked (ns*nc) point-source
    propagators props[(s,a)] of shape (ns, nc, *dims):
    C(t) = sum_x tr[S^dag S]."""
    dens = (props.abs() ** 2).sum(dim=tuple(range(props.dim() - lat.nd)))
    return dens.sum(dim=tuple(range(lat.nd - 1)))
