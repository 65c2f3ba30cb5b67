"""The eo staggered hop, v4 (port of ``qex_tpu.physics.stag_pallas4``).

v4 takes v3's operator (:class:`.stag_pallas3.PallasStagEO3`) and
computes v3's function; on the TPU it differs only in how the vector
work is fused into Mosaic operations, which has no counterpart in a
kernel that runs one CUDA thread per site.  Its one extra is the
``compute_only`` switch: term 0's link block multiplies every term's
shifted spinor (the TPU kernel streams term 0's block eight times, to
time its vector work without the link traffic):

    out(x) = sum_{k<8} L_0(x) psi(x + d_k).

:func:`dslash_pallas4` runs the hand-written kernel's v4 entry point
(``csrc/stag_v3_dslash.cu``: float32 links B7, bfloat16 links B7b) on a
CUDA tensor and :func:`dslash_pallas4_plain` on a CPU tensor.
``nslots`` is not ported (TPU copy pipeline depth).
"""

from __future__ import annotations

import torch

from ..lattice import Lattice
from . import stag_fast as sf
from .stag_pallas import _join, _split
from .stag_pallas3 import (PallasStagEO3, fits, hop3_plain,  # noqa: F401
                           launch_v3, new_pallas3)


def compute_only_plain(lat: Lattice, l: torch.Tensor, x_split: torch.Tensor,
                       parity_out: int) -> torch.Tensor:
    """sum_k L_0 psi(x + d_k) on term-major links ``l``, in x's
    precision."""
    # (Th, 2, 3, 3, Z, YX) -> complex (3, 3, Th, Z, YX)
    l0 = _join(l[0].to(x_split.dtype).permute(1, 2, 3, 0, 4, 5))
    psi = _join(x_split)
    out = None
    for k in range(8):
        v = sf.shift_fast(psi, k % 4, +1 if k < 4 else -1, parity_out, lat)
        term = (l0 * v[None]).sum(1)
        out = term if out is None else out + term
    return _split(out, x_split.dtype)


def dslash_pallas4_plain(s: PallasStagEO3, x_split: torch.Tensor,
                         parity_out: int, compute_only: bool = False
                         ) -> torch.Tensor:
    """Plain-torch twin of the kernel, in x's precision."""
    l = s.l_e if parity_out == 0 else s.l_o
    if compute_only:
        return compute_only_plain(s.lat, l, x_split, parity_out)
    return hop3_plain(s.lat, l, x_split, parity_out)


def dslash_pallas4(s: PallasStagEO3, x_split: torch.Tensor, parity_out: int,
                   compute_only: bool = False) -> torch.Tensor:
    """Apply the hopping term (``compute_only``: term 0's links in every
    term); x_split (2, 3, Th, Z, Y*X) on the source parity; returns the
    same shape on ``parity_out``.

    CPU tensors take :func:`dslash_pallas4_plain`.  CUDA tensors launch
    the kernel or raise.  Launch counts: ``dslash_pallas4.launches``
    (float32 links, B7), ``.launches_bf16`` (bfloat16 links, B7b),
    ``.launches_compute_only`` and ``.launches_compute_only_bf16`` (the
    same kernels with ``compute_only``).
    """
    if x_split.device.type == "cpu":
        return dslash_pallas4_plain(s, x_split, parity_out, compute_only)
    out = launch_v3("qex_stag_v4_dslash", s, x_split, parity_out,
                    int(bool(compute_only)))
    name = "launches" + ("_compute_only" if compute_only else "") \
        + ("_bf16" if s.l_e.dtype == torch.bfloat16 else "")
    setattr(dslash_pallas4, name, getattr(dslash_pallas4, name) + 1)
    return out


dslash_pallas4.launches = 0
dslash_pallas4.launches_bf16 = 0
dslash_pallas4.launches_compute_only = 0
dslash_pallas4.launches_compute_only_bf16 = 0


def d2ee_pallas4(s: PallasStagEO3, x_e_split: torch.Tensor, m: float
                 ) -> torch.Tensor:
    """(m^2 - D_eo D_oe) x on split vectors."""
    t = dslash_pallas4(s, x_e_split, parity_out=1)
    y = dslash_pallas4(s, t, parity_out=0)
    return (m * m) * x_e_split - y


def d2dd_pallas4(s: PallasStagEO3, x_split: torch.Tensor, parity: int = 0
                 ) -> torch.Tensor:
    """Mass-free normal operator -D_eo D_oe on split vectors."""
    t = dslash_pallas4(s, x_split, parity_out=1 - parity)
    return -dslash_pallas4(s, t, parity_out=parity)


def dslash_pallas4_c(s: PallasStagEO3, x: torch.Tensor, parity_out: int
                     ) -> torch.Tensor:
    """Complex fast-layout wrapper (x rounded to float32 planes)."""
    return _join(dslash_pallas4(s, _split(x), parity_out))
