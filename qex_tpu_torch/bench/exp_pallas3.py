"""The v3 hop split into its parts (port of the repository's
``exp_pallas3.py``: ``make_kernel`` and ``run``).

The experiment times the pieces of the v3 kernel on v3's links
(:func:`..physics.stag_pallas3.new_pallas3`).  Every mode computes

    out = 1/2 sum_{k<8} sign_k term_k,   sign_k = +1 (k < 4), -1 (k >= 4),

with term_k, for L_k the k-th link block and psi(x + d_k) the k-th
shifted spinor:

    dma      column 0 of L_k (L_k[., 0]); no spinor
    matvec   L_0 psi(x), unshifted: zero up to rounding (the terms
             cancel); it times eight matvecs
    shifts   psi(x + d_k); no links
    compute  L_0 psi(x + d_k)
    full     L_k psi(x + d_k)

These are the functions the JAX ``make_kernel`` computes, with two
departures stated here.  ``full`` is not v3: v3's links already hold
the +-1/2, so ``full`` is 1/2 (F - B) where v3 is F + B (F, B the
forward and backward terms).  And in JAX ``matvec`` and ``compute`` read
link scratch that no copy wrote (NaN in interpret mode, undefined on the
chip); here they read L_0, resident, as ``stag_pallas4``'s
``compute_only`` does.

:func:`run` launches the hand-written kernel's split entry point
(``csrc/stag_v3_dslash.cu``, B8; float32 links) on a CUDA tensor and
:func:`run_plain` on a CPU tensor.  ``nslots`` is not ported (TPU copy
pipeline depth).
"""

from __future__ import annotations

import torch

from ..lattice import Lattice
from ..physics import stag_fast as sf
from ..physics.stag_pallas import _join, _split
from ..physics.stag_pallas3 import PallasStagEO3, launch_v3

MODES = ("dma", "matvec", "shifts", "compute", "full")


def terms_plain(l: torch.Tensor, x_split: torch.Tensor, lat: Lattice,
                parity_out: int, mode: str) -> torch.Tensor:
    """The eight unsigned terms of ``mode``, (8, 2, 3, Th, Z, Y*X), in
    x's precision, on term-major links ``l`` (8, Th, 2, 3, 3, Z, Y*X)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    rdt = x_split.dtype
    if mode == "dma":
        # l[k, th, ri, r, 0] -> (8, 2, 3, Th, Z, YX)
        return l[:, :, :, :, 0].to(rdt).permute(0, 2, 3, 1, 4, 5)
    psi = _join(x_split)
    # (8, Th, 2, 3, 3, Z, YX) -> complex (8, 3, 3, Th, Z, YX)
    links = _join(l.to(rdt).permute(2, 0, 3, 4, 1, 5, 6))
    terms = []
    for k in range(8):
        mu, sign = k % 4, (+1 if k < 4 else -1)
        v = psi if mode == "matvec" else sf.shift_fast(psi, mu, sign,
                                                       parity_out, lat)
        if mode != "shifts":
            lk = links[0] if mode in ("matvec", "compute") else links[k]
            v = (lk * v[None]).sum(1)
        terms.append(_split(v, rdt))
    return torch.stack(terms)


def run_plain(l: torch.Tensor, x_split: torch.Tensor, lat: Lattice,
              parity_out: int, mode: str) -> torch.Tensor:
    """Plain-torch twin of the kernel: 1/2 sum_k sign_k term_k, the
    terms summed in order, in x's precision."""
    terms = terms_plain(l, x_split, lat, parity_out, mode)
    acc = terms[0]
    for k in range(1, 8):
        acc = acc + terms[k] if k < 4 else acc - terms[k]
    return 0.5 * acc


def run(l: torch.Tensor, x_split: torch.Tensor, lat: Lattice,
        parity_out: int, mode: str) -> torch.Tensor:
    """One application of ``mode`` on the term-major links ``l`` of
    output parity ``parity_out`` (``new_pallas3(s).l_e`` for 0, ``l_o``
    for 1) to a split spinor (2, 3, Th, Z, Y*X); returns the same shape.

    CPU tensors take :func:`run_plain`.  CUDA tensors launch the kernel
    (float32 spinor and links, contiguous on one device) or raise;
    ``run.launches_<mode>`` counts each mode's launches (B8).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if x_split.device.type == "cpu":
        return run_plain(l, x_split, lat, parity_out, mode)
    s = PallasStagEO3(lat, l, l)
    out = launch_v3("qex_stag_v3_split", s, x_split, parity_out,
                    MODES.index(mode), dtypes=(torch.float32,))
    name = f"launches_{mode}"
    setattr(run, name, getattr(run, name) + 1)
    return out


for _mode in MODES:
    setattr(run, f"launches_{_mode}", 0)
del _mode
