"""The eo staggered hop on pre-shifted term-major links, v3 (port of
``qex_tpu.physics.stag_pallas3``).

All links live at the output site: per output parity the eight link
matrices of the hopping term, +-1/2 folded in,

    out(x) = sum_{k<8} L_k(x) psi(x + d_k),
    L_mu(x) = +1/2 U_mu(x),  L_{4+mu}(x) = -1/2 U_mu(x-mu)^dag,

stored term-major ``(8, Th, 2, 3, 3, Z, Y*X)`` (th outside re/im: not
the ``(8, 2, 3, 3, Th, Z, Y*X)`` of ``stag_hisq.new_stag8``).  bfloat16
links are rounded after the fold and the adjoint, as in JAX.
:func:`dslash_pallas3` runs the hand-written kernel
``csrc/stag_v3_dslash.cu`` (float32 links B6, bfloat16 links B6b) on a
CUDA tensor and :func:`dslash_pallas3_plain` on a CPU tensor.

The JAX kernel's ``nslots``/``nsplit`` (depth and split of its manual
link DMA) are not ported: they shape the TPU's copy pipeline, and the
output does not depend on them.  :func:`fits` keeps the JAX criterion
(the TPU kernel's VMEM envelope and 128-lane alignment); the CUDA kernel
runs at any even-T volume, and the generation benchmark uses
:func:`fits` to pick its reference as the JAX A/B does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve
from ..lattice import Lattice
from . import stag_fast as sf
from .stag_hisq import _hop_plain
from .stag_pallas import _join, _launch_split, _split, split_shape


def _term_major(g_split: torch.Tensor) -> torch.Tensor:
    """(2, 8, 3, 3, Th, Z, YX) -> (8, Th, 2, 3, 3, Z, YX), contiguous."""
    return g_split.permute(1, 4, 0, 2, 3, 5, 6).contiguous()


def _adj(g: torch.Tensor) -> torch.Tensor:
    """Adjoint on the leading (nc, nc) axes of (nc, nc, Th, Z, YX)."""
    return g.transpose(0, 1).conj()


def links_shape(lat: Lattice) -> tuple:
    """Shape (8, Th, 2, 3, 3, Z, Y*X) of one parity's v3 links."""
    X, Y, Z, T = lat.dims
    return (8, T // 2, 2, 3, 3, Z, Y * X)


@dataclasses.dataclass(frozen=True)
class PallasStagEO3:
    """v3 operator: term-major pre-shifted split-complex links.

    l_e / l_o: (8, Th, 2, 3, 3, Z, YX) -- terms 0-3 A_mu (forward,
    output-parity links at the output site), terms 4-7 C_mu (backward,
    source-parity links shifted -mu and adjointed).
    """

    lat: Lattice
    l_e: torch.Tensor
    l_o: torch.Tensor


def _build_links(lat: Lattice, g_out: torch.Tensor, g_src: torch.Tensor,
                 parity_out: int, dtype: torch.dtype) -> torch.Tensor:
    """A_mu = +0.5 g_out[mu]; C_mu = -0.5 shift_-mu(adj(g_src[mu]))."""
    cs = [sf.shift_fast(_adj(g_src[mu]), mu, -1, parity_out, lat)
          for mu in range(4)]
    l = torch.cat([0.5 * g_out, -0.5 * torch.stack(cs)])
    return _term_major(_split(l, dtype))


def fits(lat: Lattice, links_dtype: torch.dtype = torch.float32) -> bool:
    """The JAX v3 kernel's constraints: its full-Z VMEM blocks fit the
    TPU's 16 MB envelope, T is even and Y*X is 128-aligned (it needs
    Y*X % 128 == 0: true at 32^4, false at 24^4)."""
    Z, YX = lat.dims[2], lat.dims[1] * lat.dims[0]
    lb = 2 if links_dtype == torch.bfloat16 else 4
    need = 2 * (2 * 9 * Z * YX * lb) + 8 * (2 * 3 * Z * YX * 4)
    return (need <= 15_800_000 and lat.dims[3] % 2 == 0
            and YX % 128 == 0)


def new_pallas3(s, links_dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> PallasStagEO3:
    """From a staggered.StaggeredEO or stag_fast.FastStagEO, on
    ``device`` (default: the CUDA card; raises without one); bfloat16
    links are the sloppy operator."""
    if not isinstance(s, sf.FastStagEO):
        s = sf.new_fast(s)
    device = resolve(device)
    return PallasStagEO3(
        s.lat,
        _build_links(s.lat, s.g_e, s.g_o, 0, links_dtype).to(device),
        _build_links(s.lat, s.g_o, s.g_e, 1, links_dtype).to(device))


def _terms_major_to_hisq(l: torch.Tensor) -> torch.Tensor:
    """(8, Th, 2, 3, 3, Z, YX) -> the (8, 2, 3, 3, Th, Z, YX) view that
    :func:`.stag_hisq._hop_plain` sums."""
    return l.permute(0, 2, 3, 4, 1, 5, 6)


def hop3_plain(lat: Lattice, l: torch.Tensor, x_split: torch.Tensor,
               parity_out: int) -> torch.Tensor:
    """sum_k L_k psi(x + d_k) on term-major links ``l``, in x's
    precision (the plain twin of the v3 and v4 kernels)."""
    out = _hop_plain(lat, _terms_major_to_hisq(l), _join(x_split),
                     parity_out, None, 0.0)
    return _split(out, x_split.dtype)


def dslash_pallas3_plain(s: PallasStagEO3, x_split: torch.Tensor,
                         parity_out: int) -> torch.Tensor:
    """Plain-torch twin of the kernel, in x's precision."""
    return hop3_plain(s.lat, s.l_e if parity_out == 0 else s.l_o, x_split,
                      parity_out)


def launch_v3(entry: str, s: PallasStagEO3, x_split: torch.Tensor,
              parity_out: int, *extra: int,
              dtypes: tuple = (torch.float32, torch.bfloat16)
              ) -> torch.Tensor:
    """Launch ``csrc/stag_v3_dslash.cu``'s ``entry`` on the links of
    ``parity_out`` (checks as :func:`.stag_pallas._launch_split`)."""
    l = s.l_e if parity_out == 0 else s.l_o
    return _launch_split("stag_v3_dslash.cu", entry, (l,),
                         links_shape(s.lat), dtypes, x_split,
                         split_shape(s.lat), s.lat, parity_out, *extra)


def dslash_pallas3(s: PallasStagEO3, x_split: torch.Tensor, parity_out: int
                   ) -> torch.Tensor:
    """Apply the hopping term; x_split (2, 3, Th, Z, Y*X) on the source
    parity; returns the same shape on ``parity_out``.

    CPU tensors take :func:`dslash_pallas3_plain`.  CUDA tensors launch
    the kernel (float32 spinor, float32 or bfloat16 links, contiguous on
    one device) or raise; ``dslash_pallas3.launches`` counts launches on
    float32 links (B6), ``dslash_pallas3.launches_bf16`` on bfloat16
    links (B6b).
    """
    if x_split.device.type == "cpu":
        return dslash_pallas3_plain(s, x_split, parity_out)
    out = launch_v3("qex_stag_v3_dslash", s, x_split, parity_out)
    if s.l_e.dtype == torch.bfloat16:
        dslash_pallas3.launches_bf16 += 1
    else:
        dslash_pallas3.launches += 1
    return out


dslash_pallas3.launches = 0
dslash_pallas3.launches_bf16 = 0


def d2ee_pallas3(s: PallasStagEO3, x_e_split: torch.Tensor, m: float
                 ) -> torch.Tensor:
    """(m^2 - D_eo D_oe) x on split vectors."""
    t = dslash_pallas3(s, x_e_split, parity_out=1)
    y = dslash_pallas3(s, t, parity_out=0)
    return (m * m) * x_e_split - y


def d2dd_pallas3(s: PallasStagEO3, x_split: torch.Tensor, parity: int = 0
                 ) -> torch.Tensor:
    """Mass-free normal operator -D_eo D_oe on split vectors."""
    t = dslash_pallas3(s, x_split, parity_out=1 - parity)
    return -dslash_pallas3(s, t, parity_out=parity)


def dslash_pallas3_c(s: PallasStagEO3, x: torch.Tensor, parity_out: int
                     ) -> torch.Tensor:
    """Complex fast-layout wrapper (x rounded to float32 planes)."""
    return _join(dslash_pallas3(s, _split(x), parity_out))
