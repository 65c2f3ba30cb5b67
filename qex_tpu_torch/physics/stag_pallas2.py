"""The eo staggered hop in the grid-major layout, v2 (port of
``qex_tpu.physics.stag_pallas2``).

The operator is v1's (:mod:`.stag_pallas`); the arrays are reordered so
that the (th, z) plane leads and each plane is one contiguous block:

    links:   (Th, Z, 2, 4, 3, 3, Y*X)   float32
    spinors: (Th, Z, 2, 3, Y*X)         float32

:func:`dslash_pallas2` runs the hand-written kernel
``csrc/stag_v2_dslash.cu`` (B5) on a CUDA tensor and
:func:`dslash_pallas2_plain` on a CPU tensor.  The converters are exact
permutes.  The JAX kernel's ``nzb`` is not ported (VMEM tiling; the
output does not depend on it).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve
from ..lattice import Lattice
from . import stag_fast as sf
from .stag_pallas import (PallasStagEO, _launch_split, _split,
                          dslash_pallas_plain)


def to_gridmajor_links(g_split: torch.Tensor) -> torch.Tensor:
    """(2, 4, 3, 3, Th, Z, YX) -> (Th, Z, 2, 4, 3, 3, YX), contiguous."""
    return g_split.permute(4, 5, 0, 1, 2, 3, 6).contiguous()


def to_gridmajor_spinor(x_split: torch.Tensor) -> torch.Tensor:
    """(2, 3, Th, Z, YX) -> (Th, Z, 2, 3, YX), contiguous."""
    return x_split.permute(2, 3, 0, 1, 4).contiguous()


def from_gridmajor_spinor(x: torch.Tensor) -> torch.Tensor:
    """(Th, Z, 2, 3, YX) -> (2, 3, Th, Z, YX), contiguous."""
    return x.permute(2, 3, 0, 1, 4).contiguous()


def _from_gridmajor_links(g: torch.Tensor) -> torch.Tensor:
    return g.permute(2, 3, 4, 5, 0, 1, 6)


@dataclasses.dataclass(frozen=True)
class PallasStagEO2:
    """Grid-major links, each (Th, Z, 2, 4, 3, 3, Y*X)."""

    lat: Lattice
    g_e: torch.Tensor
    g_o: torch.Tensor


def new_pallas2(s, device: torch.device | str | None = None
                ) -> PallasStagEO2:
    """From a staggered.StaggeredEO or stag_fast.FastStagEO: float32
    links (as the JAX ``new_pallas2``) on ``device`` (default: the CUDA
    card; raises without one)."""
    if not isinstance(s, sf.FastStagEO):
        s = sf.new_fast(s)
    device = resolve(device)
    return PallasStagEO2(s.lat,
                         to_gridmajor_links(_split(s.g_e)).to(device),
                         to_gridmajor_links(_split(s.g_o)).to(device))


def dslash_pallas2_plain(s: PallasStagEO2, x_gm: torch.Tensor,
                         parity_out: int) -> torch.Tensor:
    """Plain-torch twin of the kernel, in x's precision: v1's twin on the
    permuted links and spinor."""
    p1 = PallasStagEO(s.lat, _from_gridmajor_links(s.g_e),
                      _from_gridmajor_links(s.g_o))
    return to_gridmajor_spinor(dslash_pallas_plain(
        p1, from_gridmajor_spinor(x_gm), parity_out))


def dslash_pallas2(s: PallasStagEO2, x_gm: torch.Tensor, parity_out: int
                   ) -> torch.Tensor:
    """Apply the hopping term; x_gm is a (Th, Z, 2, 3, Y*X) grid-major
    spinor on the source parity; returns the same shape on
    ``parity_out``.

    CPU tensors take :func:`dslash_pallas2_plain`.  CUDA tensors launch
    the kernel (float32 spinor and links, contiguous on one device) or
    raise; ``dslash_pallas2.launches`` counts the launches (B5).
    """
    if x_gm.device.type == "cpu":
        return dslash_pallas2_plain(s, x_gm, parity_out)
    a = s.g_e if parity_out == 0 else s.g_o
    b = s.g_o if parity_out == 0 else s.g_e
    X, Y, Z, T = s.lat.dims
    out = _launch_split("stag_v2_dslash.cu", "qex_stag_v2_dslash", (a, b),
                        (T // 2, Z, 2, 4, 3, 3, Y * X), (torch.float32,),
                        x_gm, (T // 2, Z, 2, 3, Y * X), s.lat, parity_out)
    dslash_pallas2.launches += 1
    return out


dslash_pallas2.launches = 0


def d2ee_pallas2(s: PallasStagEO2, x_gm: torch.Tensor, m: float
                 ) -> torch.Tensor:
    """(m^2 - D_eo D_oe) x on grid-major vectors."""
    t = dslash_pallas2(s, x_gm, parity_out=1)
    y = dslash_pallas2(s, t, parity_out=0)
    return (m * m) * x_gm - y
