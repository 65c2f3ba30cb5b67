"""Staggered and Wilson meson correlators (port of
``qex_tpu.observables.mesons``).

Staggered local channels: with point-source propagators G_a(x) (one per
source color a), the local correlator in the channel with sign phase
eps(x) is

    C(t) = sum_{x spatial} eps(x) sum_a |G_a(x, t)|^2

Goldstone pion: eps = 1; the local non-Goldstone channels use
(-1)^{x_i} sign flips (taste structure of the one-component field).

Wilson channels: with the point-source propagator S (column (s0, c0)
solves D S = delta_{s0 c0}) and gamma5-hermiticity, the channel with
gamma matrix G is

    C_G(t) = sum_x tr[ G S(x) G^dag g5 S(x)^dag g5 ].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve
from ..lattice import Lattice
from ..physics import stag_solve
from ..physics import staggered as st
from ..physics.wilson import gamma_matrices
from ..solvers.base import SolverParams


def point_source(lat: Lattice, color: int, site=None,
                 dtype: torch.dtype = torch.complex64,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Color-vector delta source at ``site`` (default the origin), on
    ``device`` (default: the CUDA card)."""
    if site is None:
        site = (0,) * lat.nd
    b = torch.zeros(lat.vector_shape(), dtype=dtype, device=resolve(device))
    b[(color,) + tuple(site)] = 1.0
    return b


def wall_source(lat: Lattice, color: int, t: int = 0,
                dtype: torch.dtype = torch.complex64,
                device: torch.device | str | None = None) -> torch.Tensor:
    """Color wall source on timeslice ``t``."""
    b = torch.zeros(lat.vector_shape(), dtype=dtype, device=resolve(device))
    b[color, ..., t] = 1.0
    return b


def _coord(lat: Lattice, mu: int, device) -> torch.Tensor:
    shape = [1] * lat.nd
    shape[mu] = lat.dims[mu]
    return torch.arange(lat.dims[mu], device=device).reshape(shape)


def momentum_phase(lat: Lattice, p: tuple[int, ...],
                   dtype: torch.dtype = torch.complex64,
                   device: torch.device | str | None = None
                   ) -> torch.Tensor:
    """exp(-i 2 pi p.x / L) over the spatial coordinates."""
    dev = resolve(device)
    rdt = torch.empty((), dtype=dtype).real.dtype
    ph = torch.zeros(lat.dims, dtype=rdt, device=dev)
    for mu, k in enumerate(p):
        if k:
            ph = ph + (2.0 * math.pi * k / lat.dims[mu]) * _coord(
                lat, mu, dev).to(rdt)
    return torch.polar(torch.ones_like(ph), -ph).to(dtype)


def _sign_field(lat: Lattice, dirs: tuple[int, ...], device=None
                ) -> torch.Tensor:
    """(-1)^{sum_{mu in dirs} x_mu} over the lattice (float32)."""
    dev = resolve(device)
    s = torch.zeros(lat.dims, dtype=torch.int64, device=dev)
    for mu in dirs:
        s = s + _coord(lat, mu, dev)
    return (1 - 2 * (s % 2)).to(torch.float32)


# local staggered meson channels: name -> spatial sign directions
STAG_CHANNELS = {
    "pion5": (),             # Goldstone pi (gamma5 x gamma5)
    "pion_i5": (0, 1, 2),    # gamma0gamma5-type (all-spatial sign)
    "rho_x": (0,),
    "rho_y": (1,),
    "rho_z": (2,),
    "a1_xy": (0, 1),
    "a1_yz": (1, 2),
    "a1_zx": (2, 0),
}


def stag_mesons_from_prop(lat: Lattice, props: torch.Tensor,
                          channels=("pion5",),
                          momenta=((0, 0, 0),)) -> dict:
    """Correlators from stacked color propagators (nc, nc, *dims):
    props[a] solves D G_a = delta e_a.

    Returns {channel: C}, each momentum projected over the spatial
    volume per t-slice: a real C(t) for zero momentum alone, else a
    complex (n_momenta, T) stack."""
    dens = (props.abs() ** 2).sum(dim=(0, 1))        # (*dims,)
    spatial = tuple(range(lat.nd - 1))
    zero_only = len(momenta) == 1 and not any(momenta[0])
    cdtype = torch.complex64 if dens.dtype == torch.float32 \
        else torch.complex128
    out = {}
    for ch in channels:
        w = dens * _sign_field(lat, STAG_CHANNELS[ch], dens.device)
        if zero_only:
            out[ch] = w.sum(dim=spatial)
            continue
        out[ch] = torch.stack([
            (w.sum(dim=spatial).to(cdtype) if not any(p) else
             (w * momentum_phase(lat, p, cdtype, dens.device)).sum(
                 dim=spatial)) for p in momenta])
    return out


def stag_meson_correlators(lat: Lattice, u: torch.Tensor, m: float,
                           bc: str = "pppa",
                           channels=("pion5", "pion_i5", "rho_x"),
                           params: SolverParams = SolverParams(),
                           site=None) -> dict[str, torch.Tensor]:
    """Point-source staggered meson correlators: nc solves through
    ``stag_solve.solve_batched`` (kernel B1 for links on the card), then
    the contraction."""
    s = st.new_stag_eo(lat, u, bc)
    bs = torch.stack([point_source(lat, a, site, u.dtype, u.device)
                      for a in range(lat.nc)])
    props, _ = stag_solve.solve_batched(s, bs, m, params)
    return stag_mesons_from_prop(lat, props, channels)


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
