"""The eo Wilson hopping term with all eight spin-projected hops fused,
and its CUDA kernel (port of ``qex_tpu.physics.wilson_pallas``).

:func:`new_pallas_wilson` builds, per output parity, the eight link
matrices of the hop at the output site, 1/2 folded in, in the split
layout ``(8, 2, 3, 3, Th, Z, Y*X)`` of the JAX ``_build_links_w``: term
t = mu holds 1/2 U_mu(x), term t = 4 + mu holds 1/2 U_mu(x-mu)^dag.

Spin structure: the chiral-basis gammas are off-diagonal 2x2 blocks
gamma_mu = [[0, s], [s^dag, 0]] with one entry c_r = s[r, p(r)] in
{+-1, +-i} per row (:func:`_sigma_struct`), so term t with e = -1
(forward) or +1 (backward) is

    h_s = psi_s(x+d_t) + e c_s psi_{2+p(s)}(x+d_t)        (s = 0, 1)
    r_s = L_t(x) h_s
    out_s += r_s,   out_{2+p(s)} += e conj(c_s) r_s.

:func:`hop_w` applies it to a complex fast-layout spinor
``(4, 3, Th, Z, Y*X)``: a CUDA tensor goes through the hand-written
kernel ``csrc/wilson8_dslash.cu`` (and nothing else), a CPU tensor
through :func:`hop_w_plain`, which computes this same formulation in
torch.  Links may be float32 (the true operator, kernel B3) or bfloat16
(the inner operator of the sloppy solve, kernel B3b: planes rounded to
nearest even, as the JAX ``_split(l, bfloat16)``); the kernel widens
each bf16 element to float32, the twin casts the links to x's
precision.
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import torch

from .. import _native
from ..lattice import Lattice
from . import stag_fast as sf
from . import wilson as wl
from . import wilson_fast as wf
from .stag_hisq import _check_operand
from .stag_pallas import _join, _split


@lru_cache(maxsize=None)
def _sigma_struct(mu: int) -> tuple[tuple[int, ...], tuple[complex, ...]]:
    """gamma_mu = [[0, s], [s^dag, 0]] with one entry per row of s:
    returns (p, c) with s[r, p(r)] = c_r, entries in {+-1, +-i}."""
    g = wl.gamma_matrices()[mu]
    s = g[:2, 2:]
    if not (abs(g[:2, :2]).max() == 0 and abs(g[2:, 2:]).max() == 0
            and (g[2:, :2] == s.conj().T).all()):
        raise ValueError(f"gamma_{mu} is not block off-diagonal")
    perm, coef = [], []
    for r in range(2):
        nz = [j for j in range(2) if abs(s[r, j]) > 1e-12]
        if len(nz) != 1:
            raise ValueError(f"gamma_{mu}: row {r} of s is not a monomial")
        perm.append(nz[0])
        coef.append(complex(s[r, nz[0]]))
    return tuple(perm), tuple(coef)


@dataclasses.dataclass(frozen=True)
class PallasWilsonEO:
    """Kernel-ready eo Wilson operator: term-major pre-shifted links
    ``l_e``/``l_o``, each (8, 2, 3, 3, Th, Z, Y*X)."""

    lat: Lattice
    l_e: torch.Tensor
    l_o: torch.Tensor
    m: float

    @property
    def a(self) -> float:
        return self.lat.nd + self.m


def _build_links_w(lat: Lattice, g_out: torch.Tensor, g_src: torch.Tensor,
                   parity_out: int, dtype: torch.dtype) -> torch.Tensor:
    c1 = [sf.shift_fast(g_src[mu].transpose(0, 1).conj(), mu, -1,
                        parity_out, lat) for mu in range(4)]
    l = torch.cat([0.5 * g_out, 0.5 * torch.stack(c1)])
    # (2, 8, 3, 3, Th, Z, YX) -> (8, 2, 3, 3, Th, Z, YX)
    return _split(l, dtype).transpose(0, 1).contiguous()


def new_pallas_wilson(w, links_dtype: torch.dtype = torch.float32
                      ) -> PallasWilsonEO:
    """From a wilson.WilsonEO or wilson_fast.FastWilsonEO."""
    if not isinstance(w, wf.FastWilsonEO):
        w = wf.new_fast_wilson(w)
    return PallasWilsonEO(
        w.lat, _build_links_w(w.lat, w.g_e, w.g_o, 0, links_dtype),
        _build_links_w(w.lat, w.g_o, w.g_e, 1, links_dtype), w.m)


def fits(lat: Lattice) -> bool:
    """Even (packable) T with at least 2 t-halves."""
    return lat.nd == 4 and lat.dims[3] % 2 == 0 and lat.dims[3] >= 4


def hop_w_plain(p: PallasWilsonEO, x: torch.Tensor, parity_out: int,
                x_fuse: torch.Tensor | None = None) -> torch.Tensor:
    """Plain-torch twin of the kernel: project, matvec and reconstruct
    with the (p, c) table on the pre-shifted links, in x's precision.
    With ``x_fuse`` it returns ``a * x_fuse - sum / a`` (the fused
    Schur-complement epilogue of :func:`m_ee_w`)."""
    links = _join((p.l_e if parity_out == 0 else p.l_o).transpose(0, 1)
                  .to(x.real.dtype))
    acc = [0.0] * 4
    for t in range(8):
        mu, e = t % 4, (-1 if t < 4 else +1)
        perm, coef = _sigma_struct(mu)
        nb = sf.shift_fast(x, mu, -e, parity_out, p.lat)
        h = torch.stack([nb[s] + (e * coef[s]) * nb[2 + perm[s]]
                         for s in range(2)])
        r = (links[t][None] * h[:, None]).sum(2)
        for s in range(2):
            acc[s] = acc[s] + r[s]
            acc[2 + perm[s]] = (acc[2 + perm[s]]
                                + (e * coef[s].conjugate()) * r[s])
    out = torch.stack(acc)
    return out if x_fuse is None else p.a * x_fuse - out / p.a


def _launch(p: PallasWilsonEO, links: torch.Tensor, x: torch.Tensor,
            parity_out: int, x_fuse: torch.Tensor | None) -> torch.Tensor:
    """Check the operands and launch ``csrc/wilson8_dslash.cu`` (its
    float32- or bfloat16-link entry point) on x's CUDA device; raises on
    operands the kernel does not take and on a failed launch."""
    if x.device.type != "cuda":
        raise ValueError(f"no wilson8 kernel for device {x.device}")
    X, Y, Z, T = p.lat.dims
    shape = (4, 3, T // 2, Z, Y * X)
    if (links.device != x.device
            or links.dtype not in (torch.float32, torch.bfloat16)
            or tuple(links.shape) != (8, 2, 3, 3) + shape[2:]
            or not links.is_contiguous()):
        raise ValueError(f"wilson8 links must be contiguous float32 or "
                         f"bfloat16 (8, 2, 3, 3, {shape[2:]}) on {x.device}")
    _check_operand("x", x, shape, x.device)
    if x_fuse is not None:
        _check_operand("x_fuse", x_fuse, shape, x.device)
    lib = _native.load("wilson8_dslash.cu")
    fn = lib.qex_wilson8_hop_bf16 if links.dtype == torch.bfloat16 \
        else lib.qex_wilson8_hop
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] * 2 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(links.data_ptr(), x.data_ptr(),
                 None if x_fuse is None else x_fuse.data_ptr(),
                 out.data_ptr(), float(p.a), -1.0 / float(p.a), X, Y, Z,
                 T // 2, int(parity_out), stream)
    if err != 0:
        raise RuntimeError(f"wilson8 kernel launch failed: CUDA error {err}")
    return out


def hop_w(p: PallasWilsonEO, x: torch.Tensor, parity_out: int,
          x_fuse: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the Wilson hopping term onto ``parity_out``; x is a complex
    fast-layout spinor (4, 3, Th, Z, Y*X) on the source parity.  With
    ``x_fuse`` it returns ``a * x_fuse - hop / a``.

    CPU tensors take :func:`hop_w_plain`.  CUDA tensors launch the
    kernel (complex64 spinors, float32 or bfloat16 links, all contiguous
    on one device) or raise; ``hop_w.launches`` counts launches of the
    float32-link kernel (B3) and ``hop_w.launches_bf16`` those of the
    bfloat16-link kernel (B3b).
    """
    if x.device.type == "cpu":
        return hop_w_plain(p, x, parity_out, x_fuse)
    links = p.l_e if parity_out == 0 else p.l_o
    out = _launch(p, links, x, parity_out, x_fuse)
    if links.dtype == torch.bfloat16:
        hop_w.launches_bf16 += 1
    else:
        hop_w.launches += 1
    return out


hop_w.launches = 0
hop_w.launches_bf16 = 0


def _g5(x: torch.Tensor) -> torch.Tensor:
    """gamma5 = diag(1, 1, -1, -1) on the spin axis."""
    return torch.cat([x[:2], -x[2:]])


def m_ee_w(p: PallasWilsonEO, x: torch.Tensor) -> torch.Tensor:
    """Schur complement M = a - H_eo H_oe / a (wilson.wilson_m_ee), the
    epilogue fused into the second hop."""
    return hop_w(p, hop_w(p, x, 1), 0, x_fuse=x)


def m_ee_dag_w(p: PallasWilsonEO, x: torch.Tensor) -> torch.Tensor:
    """M^dag = g5 M g5."""
    return _g5(m_ee_w(p, _g5(x)))
