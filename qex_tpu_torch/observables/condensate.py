"""Chiral condensate with noise sources and dilution (port of
``qex_tpu.observables.condensate``).

Estimator: pbp = (1/V) E[ Re eta^dag D^{-1} eta ] over noise eta with
E[eta eta^dag] = I.  Dilution splits eta into orthogonal supports;
solving each part separately removes the off-diagonal stochastic noise
within the diluted subspace.
"""

from __future__ import annotations

import torch

from ..device import resolve
from ..lattice import Lattice
from ..ops import linalg
from ..parallel import mesh
from ..parallel.halo import psum
from ..physics import stag_solve
from ..physics import staggered as st
from ..rng import gaussian_complex, u1_noise, z2_noise, z4_noise
from ..solvers.base import SolverParams

NOISES = {
    "z4": z4_noise,
    "z2": z2_noise,
    "u1": u1_noise,
    "gauss": lambda g, s, d: gaussian_complex(g, s, d) * 0.7071067811865476,
}


def dilution_masks(lat: Lattice, kind: str,
                   device: torch.device | str | None = None
                   ) -> list[torch.Tensor]:
    """Real 0/1 float32 masks partitioning the lattice (they sum to 1):
    "none", "eo" (site parity) or "corner3d" (the 8 spatial corners of
    each 2^3 cube)."""
    dev = resolve(device)
    if kind == "none":
        return [torch.ones(lat.dims, dtype=torch.float32, device=dev)]
    coords = []
    for mu in range(lat.nd):
        shape = [1] * lat.nd
        shape[mu] = lat.dims[mu]
        coords.append(torch.arange(lat.dims[mu], device=dev).reshape(shape))

    def mask(m):
        return m.expand(lat.dims).to(torch.float32)

    if kind == "eo":
        par = sum(coords) % 2
        return [mask(par == p) for p in range(2)]
    if kind == "corner3d":
        return [mask((coords[0] % 2 == cx) & (coords[1] % 2 == cy)
                     & (coords[2] % 2 == cz))
                for cx in range(2) for cy in range(2) for cz in range(2)]
    raise ValueError(f"unknown dilution {kind!r}")


def pbp_staggered(gen: torch.Generator | None, lat: Lattice, u: torch.Tensor,
                  m: float, bc: str = "pppa", noise: str = "z4",
                  n_noise: int = 1, dilution: str = "none",
                  params: SolverParams = SolverParams(),
                  noises: torch.Tensor | None = None) -> float:
    """Stochastic psi-bar-psi = (1/V) tr D^{-1} for staggered D(m): each
    diluted noise vector solved through ``stag_solve.solve`` (kernel B1
    for links on the card).

    The n_noise noise vectors of kind ``noise`` are drawn from ``gen``
    (on u's device), or given as ``noises`` (n_noise, nc, *dims).  On
    the active rank mesh's blocks (``parallel.mesh.use_mesh``) the
    noises and masks are drawn whole and cut, the solves run on the
    blocks and the sum is all-reduced."""
    s = st.new_stag_eo(lat, u, bc)
    if noises is None:
        noises = [NOISES[noise](gen, lat.vector_shape(), u.dtype)
                  for _ in range(n_noise)]
    noises = [mesh.cut(eta) for eta in noises]
    masks = [mesh.cut(mk) for mk in dilution_masks(lat, dilution, u.device)]
    total = torch.zeros((), dtype=torch.float64, device=u.device)
    for eta in noises:
        for msk in masks:
            eta_d = eta * msk
            x, _ = stag_solve.solve(s, eta_d, m, params)
            total = total + linalg.dot(eta_d, x, torch.complex128).real
    return float(psum(total)) / (len(noises) * lat.volume)
