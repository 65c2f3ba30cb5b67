"""The first-generation eo staggered hop on unshifted links, and the
complex <-> split re/im converters (port of
``qex_tpu.physics.stag_pallas``).

Kernel-ready arrays keep the JAX kernels' split layout: a leading axis
of 2 holding the real and imaginary planes.  :func:`new_pallas` splits
the fast-layout links ``g_e``/``g_o`` to ``(2, 4, 3, 3, Th, Z, Y*X)``;
:func:`dslash_pallas` applies

    out(x) = 1/2 sum_mu [ A_mu(x) psi(x+mu) - B_mu(x-mu)^dag psi(x-mu) ]

(A the output-parity links, B the source-parity links, read at the
source site x-mu) to a split float32 spinor ``(2, 3, Th, Z, Y*X)``: a
CUDA tensor goes through the hand-written kernel
``csrc/stag_v1_dslash.cu`` (float32 links, B4; bfloat16 links, B4b) and
nothing else, a CPU tensor through :func:`dslash_pallas_plain`.

The JAX kernel's ``nzb`` (z planes per VMEM block) is not ported: it
tiles the TPU's VMEM, and the output does not depend on it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _native
from ..device import resolve
from ..lattice import Lattice
from . import stag_fast as sf


def _split(v: torch.Tensor, dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """complex (...) -> real (2, ...) planes in ``dtype``."""
    return torch.stack([v.real, v.imag]).to(dtype).contiguous()


def _join(v: torch.Tensor) -> torch.Tensor:
    """real (2, ...) planes -> complex (...) of the matching precision
    (the JAX helper always returns complex64; here a float64 split
    joins to complex128)."""
    return torch.complex(v[0], v[1])


def _aligned(*tensors) -> bool:
    """Whether every tensor given (None passes) starts on 16 B."""
    return all(v is None or v.data_ptr() % 16 == 0 for v in tensors)


def _check_split(name: str, v: torch.Tensor, shape, device) -> None:
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, expected {device}")
    if v.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {v.dtype}")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(v.shape)}, "
                         f"expected {tuple(shape)}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_split(source: str, entry: str, links: tuple, shape,
                  dtypes: tuple, x: torch.Tensor, x_shape, lat: Lattice,
                  parity_out: int, *extra: int) -> torch.Tensor:
    """Check the operands and launch ``csrc/<source>``'s ``entry`` (or
    ``entry + "_bf16"`` on bfloat16 links) on x's CUDA device: links
    (each contiguous, of ``shape`` and one of ``dtypes``), the split
    float32 spinor x of ``x_shape``, the output, X, Y, Z, Th,
    ``parity_out``, the ``extra`` ints and the stream.  Raises on
    operands the kernel does not take and on a failed launch."""
    if x.device.type != "cuda":
        raise ValueError(f"no {entry} kernel for device {x.device}")
    for l in links:
        if (l.device != x.device or l.dtype not in dtypes
                or tuple(l.shape) != tuple(shape) or not l.is_contiguous()
                or l.dtype != links[0].dtype):
            raise ValueError(
                f"{entry} links must be contiguous {dtypes} "
                f"{tuple(shape)} on {x.device}, got {l.dtype} "
                f"{tuple(l.shape)} on {l.device}")
    _check_split("x", x, x_shape, x.device)
    lib = _native.load(source)
    fn = getattr(lib, entry + ("_bf16" if links[0].dtype == torch.bfloat16
                               else ""))
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * (len(links) + 2) \
            + [ctypes.c_int] * (5 + len(extra)) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    X, Y, Z, T = lat.dims
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(l.data_ptr() for l in links), x.data_ptr(),
                 out.data_ptr(), X, Y, Z, T // 2, int(parity_out),
                 *(int(e) for e in extra), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return out


def split_shape(lat: Lattice) -> tuple:
    """Shape (2, 3, Th, Z, Y*X) of a split fast-layout spinor."""
    X, Y, Z, T = lat.dims
    return (2, 3, T // 2, Z, Y * X)


@dataclasses.dataclass(frozen=True)
class PallasStagEO:
    """Kernel-ready eo operator: split-complex fast-layout links, each
    (2, 4, 3, 3, Th, Z, Y*X)."""

    lat: Lattice
    g_e: torch.Tensor
    g_o: torch.Tensor


def new_pallas(s, links_dtype: torch.dtype = torch.float32,
               device: torch.device | str | None = None) -> PallasStagEO:
    """From a staggered.StaggeredEO or stag_fast.FastStagEO, on
    ``device`` (default: the CUDA card; raises without one).

    ``links_dtype=torch.bfloat16`` rounds the split planes to nearest
    even, as the JAX ``_split(g, bfloat16)`` (kernel B4b)."""
    if not isinstance(s, sf.FastStagEO):
        s = sf.new_fast(s)
    device = resolve(device)
    return PallasStagEO(s.lat, _split(s.g_e, links_dtype).to(device),
                        _split(s.g_o, links_dtype).to(device))


def dslash_pallas_plain(s: PallasStagEO, x_split: torch.Tensor,
                        parity_out: int) -> torch.Tensor:
    """Plain-torch twin of the kernel: the fast-layout hop on the split
    links, in x's precision (links widened to it)."""
    rdt = x_split.dtype
    fs = sf.FastStagEO(s.lat, _join(s.g_e.to(rdt)), _join(s.g_o.to(rdt)))
    return _split(sf.dslash_fast(fs, _join(x_split), parity_out), rdt)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Launch grid of a site-parallel hop kernel: ``blocks`` blocks of
    ``threads`` threads, thread i taking the sites [k*i, k*i + k) below
    ``sites``, through the kernel's k-site vector path when ``vector`` is
    set and its per-site path (k = 1) otherwise.  No shared memory."""

    sites: int
    blocks: int
    threads: int
    k: int
    vector: bool

    def args(self) -> tuple:
        """(blocks, threads, vector) as the C entry points take them."""
        return (self.blocks, self.threads, int(self.vector))


def site_geometry(dims, k: int, vector_threads: int, site_threads: int,
                  vector: bool) -> Geometry:
    """Grid of a kernel over the half lattice of ``dims`` (X, Y, Z, T):
    its vector path, k consecutive sites a thread in blocks of
    ``vector_threads``, where the caller allows it (``vector``: operands
    aligned to 16 B, and whatever else the kernel asks) and X % k == 0 (a
    thread's sites share an x row, and every plane and row stride is a
    multiple of k); else its per-site path, one site a thread in blocks
    of ``site_threads``."""
    X, Y, Z, T = dims
    sites = X * Y * Z * (T // 2)
    if vector and X % k == 0:
        threads = vector_threads
    else:
        k, threads = 1, site_threads
    return Geometry(sites, -(-sites // (k * threads)), threads, k, k > 1)


# csrc/stag_v1_dslash.cu's kSites, kVectorThreads and kSiteThreads
V1_SITES = 2
V1_VECTOR_THREADS = 64
V1_SITE_THREADS = 256
# The vector path reads its links past L1 with an L2 evict-first policy:
# where a hop's operands fit in L2 (the H100's 50 MiB), the per-site
# path, which leaves them there from one call to the next, was faster
# (PERF.md §6).
V1_VECTOR_MIN_BYTES = 50 * 2 ** 20


def v1_geometry(dims, links_dtype: torch.dtype = torch.float32,
                aligned: bool = True) -> Geometry:
    """Launch grid of the v1 kernel on the half lattice of ``dims``: the
    two-site vector path where X is even, the operands are ``aligned``
    to 16 B and a hop moves at least ``V1_VECTOR_MIN_BYTES`` (A and B
    links of ``links_dtype``, the spinor and the output), else one site
    a thread."""
    X, Y, Z, T = dims
    item = torch.empty((), dtype=links_dtype).element_size()
    nbytes = X * Y * Z * (T // 2) * (2 * 72 * item + 48)
    return site_geometry(dims, V1_SITES, V1_VECTOR_THREADS, V1_SITE_THREADS,
                         aligned and nbytes >= V1_VECTOR_MIN_BYTES)


def dslash_pallas(s: PallasStagEO, x_split: torch.Tensor, parity_out: int
                  ) -> torch.Tensor:
    """Apply the hopping term; x_split is (2, 3, Th, Z, Y*X) on the
    source parity; returns the same shape on ``parity_out``.

    CPU tensors take :func:`dslash_pallas_plain`.  CUDA tensors launch
    the kernel (float32 spinor, float32 or bfloat16 links, all contiguous
    on one device) or raise; ``dslash_pallas.launches`` counts launches
    of the float32-link kernel (B4), ``dslash_pallas.launches_bf16``
    those of the bfloat16-link kernel (B4b).
    """
    if x_split.device.type == "cpu":
        return dslash_pallas_plain(s, x_split, parity_out)
    a = s.g_e if parity_out == 0 else s.g_o
    b = s.g_o if parity_out == 0 else s.g_e
    X, Y, Z, T = s.lat.dims
    geom = v1_geometry(s.lat.dims, a.dtype, _aligned(a, b, x_split))
    out = _launch_split("stag_v1_dslash.cu", "qex_stag_v1_dslash", (a, b),
                        (2, 4, 3, 3, T // 2, Z, Y * X),
                        (torch.float32, torch.bfloat16), x_split,
                        split_shape(s.lat), s.lat, parity_out,
                        *geom.args())
    if a.dtype == torch.bfloat16:
        dslash_pallas.launches_bf16 += 1
    else:
        dslash_pallas.launches += 1
    return out


dslash_pallas.launches = 0
dslash_pallas.launches_bf16 = 0


def d2ee_pallas(s: PallasStagEO, x_e_split: torch.Tensor, m: float
                ) -> torch.Tensor:
    """(m^2 - D_eo D_oe) x on split vectors."""
    t = dslash_pallas(s, x_e_split, parity_out=1)
    y = dslash_pallas(s, t, parity_out=0)
    return (m * m) * x_e_split - y


def dslash_pallas_c(s: PallasStagEO, x: torch.Tensor, parity_out: int
                    ) -> torch.Tensor:
    """Complex fast-layout wrapper (x rounded to float32 planes, as the
    JAX wrapper does)."""
    return _join(dslash_pallas(s, _split(x), parity_out))
