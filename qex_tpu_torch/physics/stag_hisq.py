"""Staggered hops with pre-shifted links, and their CUDA kernels (port
of ``qex_tpu.physics.stag_pallas_hisq``: the 8-term plain staggered mode
and the 16-term fat + naik (HISQ) mode).

:func:`new_stag8` builds, per output parity, the eight link matrices
of the hopping term at the output site, +-1/2 folded in:

    out(x) = sum_{t<8} L_t(x) psi(x + d_t),
    L_mu(x) = +1/2 U_mu(x),  L_{4+mu}(x) = -1/2 U_mu(x-mu)^dag,

in the split layout ``(8, 2, 3, 3, Th, Z, Y*X)`` of ``new_pallas_stag8``
(``l_e``/``l_o`` identical to the JAX arrays).  :func:`dslash_stag8`
applies it to a complex fast-layout vector ``(3, Th, Z, Y*X)``: a CUDA
tensor goes through the hand-written kernel ``csrc/stag8_dslash.cu``
(and nothing else), a CPU tensor through :func:`dslash_stag8_plain`.

:func:`new_hisq16` builds the sixteen terms of the fat + naik hop the
same way, term t = kind*4 + mu with kind 0 = fat forward
(+1/2 fat_mu(x)), 1 = fat backward (-1/2 fat_mu(x-mu)^dag), 2 = long
forward (+1/2 long_mu(x), a 3-hop) and 3 = long backward
(-1/2 long_mu(x-3mu)^dag), in ``(16, 2, 3, 3, Th, Z, Y*X)`` as
``new_pallas_hisq``; :func:`dslash_hisq16` applies it through
``csrc/hisq16_dslash.cu`` (CUDA) or :func:`dslash_hisq16_plain` (CPU).

Links may be float32 (the true operator) or bfloat16 (the inner operator
of the sloppy CG, ``links_dtype=torch.bfloat16``: the split planes are
rounded to nearest even, as the JAX ``_split(l, bfloat16)``).  The
kernels widen each bf16 link element to float32 and compute in float32,
and the plain twins cast the links up to x's precision, so both compute
the same operator on the same rounded links.

Built on a block of a rank mesh (``parallel.mesh.use_mesh``), the
backward links' shifts exchange faces, so the links are the block of the
global build; the hop itself wraps the block locally, and
``stag_shard.hop3_fix`` corrects its faces.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _native
from ..lattice import Lattice
from ..parallel import mesh
from . import stag_fast as sf
from .stag_pallas import Geometry, _aligned, _join, _split, site_geometry


@dataclasses.dataclass(frozen=True)
class Stag8EO:
    """Kernel-ready 8-term operator: term-major pre-shifted links
    ``l_e``/``l_o``, each (8, 2, 3, 3, Th, Z, Y*X)."""

    lat: Lattice
    l_e: torch.Tensor
    l_o: torch.Tensor


def new_stag8(s, links_dtype: torch.dtype = torch.float32) -> Stag8EO:
    """From a staggered.StaggeredEO or stag_fast.FastStagEO."""
    if not isinstance(s, sf.FastStagEO):
        s = sf.new_fast(s)
    lm = mesh.active()

    def build(g_out, g_src, parity_out):
        c1 = [sf.shift_fast(g_src[mu].transpose(0, 1).conj(), mu, -1,
                            parity_out, s.lat, lm=lm) for mu in range(4)]
        l = torch.cat([0.5 * g_out, -0.5 * torch.stack(c1)])
        return _split(l, links_dtype).transpose(0, 1).contiguous()

    return Stag8EO(s.lat, build(s.g_e, s.g_o, 0), build(s.g_o, s.g_e, 1))


def _hop_plain(lat: Lattice, l_split: torch.Tensor, x: torch.Tensor,
               parity_out: int, x_fuse: torch.Tensor | None, m2: float
               ) -> torch.Tensor:
    """sum_t L_t psi(x + d_t) over the 8 or 16 terms of ``l_split``
    (term t = kind*4 + mu: kinds 0/2 forward, 1/3 backward, 0/1 one hop,
    2/3 three hops), in x's precision; with ``x_fuse`` it returns
    ``m2 * x_fuse - sum``."""
    links = _join(l_split.transpose(0, 1).to(x.real.dtype))
    out = None
    for t in range(links.shape[0]):
        kind, mu = divmod(t, 4)
        sign, dist = (+1 if kind % 2 == 0 else -1), (1 if kind < 2 else 3)
        term = (links[t] * sf.shift_fast(x, mu, sign, parity_out, lat,
                                         dist)[None]).sum(1)
        out = term if out is None else out + term
    return out if x_fuse is None else m2 * x_fuse - out


def dslash_stag8_plain(p8: Stag8EO, x: torch.Tensor, parity_out: int,
                       x_fuse: torch.Tensor | None = None, m2: float = 0.0
                       ) -> torch.Tensor:
    """Plain-torch twin of the kernel: the fast-layout formula on the
    pre-shifted links, in x's precision.  With ``x_fuse`` it returns
    ``m2 * x_fuse - sum_t L_t psi`` (the fused d2ee epilogue)."""
    return _hop_plain(p8.lat, p8.l_e if parity_out == 0 else p8.l_o, x,
                      parity_out, x_fuse, m2)


def _check_operand(name: str, v: torch.Tensor, shape, device) -> None:
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, expected {device}")
    if v.dtype != torch.complex64:
        raise TypeError(f"{name} must be complex64, got {v.dtype}")
    if tuple(v.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(v.shape)}, "
                         f"expected {shape}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# csrc/hisq16_dslash.cu's kSites, kVectorThreads and kSiteThreads
HISQ16_SITES = 4
HISQ16_VECTOR_THREADS = 64
HISQ16_SITE_THREADS = 256


def hisq16_geometry(dims, aligned: bool = True) -> Geometry:
    """Launch grid of the 16-term kernel on the half lattice of ``dims``:
    the four-site vector path where X is a multiple of 4 and the
    operands are ``aligned`` to 16 B, else one site a thread."""
    return site_geometry(dims, HISQ16_SITES, HISQ16_VECTOR_THREADS,
                         HISQ16_SITE_THREADS, aligned)


def _launch(kind: str, links: torch.Tensor, lat: Lattice,
            x: torch.Tensor, parity_out: int, x_fuse: torch.Tensor | None,
            m2: float) -> torch.Tensor:
    """Check the operands and launch ``csrc/<kind>_dslash.cu`` (its
    float32- or bfloat16-link entry point) on x's CUDA device, the
    16-term kernel with :func:`hisq16_geometry`; raises on operands the
    kernel does not take and on a failed launch."""
    if x.device.type != "cuda":
        raise ValueError(f"no {kind} kernel for device {x.device}")
    nterms = 8 if kind == "stag8" else 16
    X, Y, Z, T = lat.dims
    shape = (3, T // 2, Z, Y * X)
    if (links.device != x.device
            or links.dtype not in (torch.float32, torch.bfloat16)
            or tuple(links.shape) != (nterms, 2, 3, 3) + shape[1:]
            or not links.is_contiguous()):
        raise ValueError(f"{kind} links must be contiguous float32 or "
                         f"bfloat16 ({nterms}, 2, 3, 3, {shape[1:]}) on "
                         f"{x.device}")
    _check_operand("x", x, shape, x.device)
    if x_fuse is not None:
        _check_operand("x_fuse", x_fuse, shape, x.device)
    out = torch.empty_like(x)
    geom = ()
    if kind == "hisq16":
        geom = hisq16_geometry(lat.dims,
                               _aligned(links, x, x_fuse, out)).args()
    lib = _native.load(f"{kind}_dslash.cu")
    fn = getattr(lib, f"qex_{kind}_dslash"
                 + ("_bf16" if links.dtype == torch.bfloat16 else ""))
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] \
            + [ctypes.c_int] * (5 + len(geom)) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(links.data_ptr(), x.data_ptr(),
                 None if x_fuse is None else x_fuse.data_ptr(),
                 out.data_ptr(), float(m2), X, Y, Z, T // 2,
                 int(parity_out), *geom, stream)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: CUDA error {err}")
    return out


def dslash_stag8(p8: Stag8EO, x: torch.Tensor, parity_out: int,
                 x_fuse: torch.Tensor | None = None, m2: float = 0.0
                 ) -> torch.Tensor:
    """Apply the 8-term hop onto ``parity_out``; x is a complex
    fast-layout vector (3, Th, Z, Y*X) on the source parity.

    CPU tensors take :func:`dslash_stag8_plain`.  CUDA tensors launch
    the kernel (complex64 vectors, float32 or bfloat16 links, all
    contiguous on one device) or raise; ``dslash_stag8.launches`` counts
    launches of the float32-link kernel and ``dslash_stag8.launches_bf16``
    those of the bfloat16-link kernel.
    """
    if x.device.type == "cpu":
        return dslash_stag8_plain(p8, x, parity_out, x_fuse, m2)
    links = p8.l_e if parity_out == 0 else p8.l_o
    out = _launch("stag8", links, p8.lat, x, parity_out, x_fuse, m2)
    if links.dtype == torch.bfloat16:
        dslash_stag8.launches_bf16 += 1
    else:
        dslash_stag8.launches += 1
    return out


dslash_stag8.launches = 0
dslash_stag8.launches_bf16 = 0


def d2ee_stag8(p8: Stag8EO, x_e: torch.Tensor, m: float) -> torch.Tensor:
    """A x = (m^2 - D_eo D_oe) x with the epilogue fused into the
    second hop."""
    t = dslash_stag8(p8, x_e, 1)
    return dslash_stag8(p8, t, 0, x_fuse=x_e, m2=m * m)


def d2dd_stag8(p8: Stag8EO, x: torch.Tensor, parity: int = 0
               ) -> torch.Tensor:
    """Mass-free normal operator -D_po,ps D_ps,po x."""
    t = dslash_stag8(p8, x, 1 - parity)
    return dslash_stag8(p8, t, parity, x_fuse=x, m2=0.0)


# --- 16-term fat + naik (HISQ) hop -------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hisq16EO:
    """Kernel-ready fat + naik operator: term-major pre-shifted links
    ``l_e``/``l_o``, each (16, 2, 3, 3, Th, Z, Y*X)."""

    lat: Lattice
    l_e: torch.Tensor
    l_o: torch.Tensor


def new_hisq16(s, links_dtype: torch.dtype = torch.float32) -> Hisq16EO:
    """From a staggered.Staggered3EO or stag_fast.FastStag3EO."""
    if not isinstance(s, sf.FastStag3EO):
        s = sf.new_fast3(s)
    if s.lat.dims[0] < 3:
        raise ValueError("the naik x hop needs an x extent of at least 3")
    lm = mesh.active()

    def build(gf_out, gf_src, gl_out, gl_src, parity_out):
        def back(g, dist):
            return [sf.shift_fast(g[mu].transpose(0, 1).conj(), mu, -1,
                                  parity_out, s.lat, dist, lm=lm)
                    for mu in range(4)]
        l = torch.cat([0.5 * gf_out, -0.5 * torch.stack(back(gf_src, 1)),
                       0.5 * gl_out, -0.5 * torch.stack(back(gl_src, 3))])
        return _split(l, links_dtype).transpose(0, 1).contiguous()

    return Hisq16EO(s.lat, build(s.gf_e, s.gf_o, s.gl_e, s.gl_o, 0),
                    build(s.gf_o, s.gf_e, s.gl_o, s.gl_e, 1))


def dslash_hisq16_plain(p16: Hisq16EO, x: torch.Tensor, parity_out: int,
                        x_fuse: torch.Tensor | None = None, m2: float = 0.0
                        ) -> torch.Tensor:
    """Plain-torch twin of the 16-term kernel (fused d2ee epilogue with
    ``x_fuse``, as :func:`dslash_stag8_plain`)."""
    return _hop_plain(p16.lat, p16.l_e if parity_out == 0 else p16.l_o, x,
                      parity_out, x_fuse, m2)


def dslash_hisq16(p16: Hisq16EO, x: torch.Tensor, parity_out: int,
                  x_fuse: torch.Tensor | None = None, m2: float = 0.0
                  ) -> torch.Tensor:
    """Apply the 16-term fat + naik hop onto ``parity_out``; x is a
    complex fast-layout vector (3, Th, Z, Y*X) on the source parity.

    CPU tensors take :func:`dslash_hisq16_plain`.  CUDA tensors launch
    the kernel ``csrc/hisq16_dslash.cu`` (complex64 vectors, float32 or
    bfloat16 links, all contiguous on one device) or raise;
    ``dslash_hisq16.launches`` counts launches of the float32-link
    kernel (B2) and ``dslash_hisq16.launches_bf16`` those of the
    bfloat16-link kernel (B2b).
    """
    if x.device.type == "cpu":
        return dslash_hisq16_plain(p16, x, parity_out, x_fuse, m2)
    links = p16.l_e if parity_out == 0 else p16.l_o
    out = _launch("hisq16", links, p16.lat, x, parity_out, x_fuse, m2)
    if links.dtype == torch.bfloat16:
        dslash_hisq16.launches_bf16 += 1
    else:
        dslash_hisq16.launches += 1
    return out


dslash_hisq16.launches = 0
dslash_hisq16.launches_bf16 = 0


def d2ee_hisq16(p16: Hisq16EO, x_e: torch.Tensor, m: float
                ) -> torch.Tensor:
    """A3 x = (m^2 - D3_eo D3_oe) x with the epilogue fused into the
    second hop."""
    t = dslash_hisq16(p16, x_e, 1)
    return dslash_hisq16(p16, t, 0, x_fuse=x_e, m2=m * m)


def d2dd_hisq16(p16: Hisq16EO, x: torch.Tensor, parity: int = 0
                ) -> torch.Tensor:
    """Mass-free fat + naik normal operator -D3_po,ps D3_ps,po x."""
    t = dslash_hisq16(p16, x, 1 - parity)
    return dslash_hisq16(p16, t, parity, x_fuse=x, m2=0.0)
