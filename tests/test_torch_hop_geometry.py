"""Launch geometry and neighbour arithmetic of the 16-term HISQ kernel
(csrc/hisq16_dslash.cu, B2/B2b) and the v1 kernel (csrc/stag_v1_dslash.cu,
B4/B4b), on the host: no card, no JAX.

- The grid that each wrapper passes to its kernel
  (``stag_hisq.hisq16_geometry``, ``stag_pallas.v1_geometry``) at every
  shape of tests/test_torch_kernels_gpu.py and chip_smoke.py, operands
  aligned or not, gives every site to exactly one thread and takes the
  vector path only where a thread's sites share an x row and every
  stride of a vector load is a multiple of its width; the kernels ask
  for no shared memory (a Hopper block may have 232,448 B).
- The sites a thread takes and the block sizes are the kernels' own
  (parsed out of the .cu files).
- The kernels' neighbour arithmetic, restated here with the term table
  parsed out of hisq16_dslash.cu, reads exactly the site that
  ``stag_fast.shift_fast`` moves onto each output site, on the per-site
  path and on the vector path (its paired loads included).
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.physics import stag_fast as sf
from qex_tpu_torch.physics import stag_hisq as sh
from qex_tpu_torch.physics import stag_pallas as sp1

CSRC = Path(__file__).resolve().parent.parent / "qex_tpu_torch" / "csrc"
# every shape the card sees: the GPU tests', chip_smoke.py's and
# bench/hop_ab.py's
SHAPES = [(4, 4, 4, 4), (8, 4, 4, 8), (24, 24, 24, 24), (6, 3, 5, 4),
          (8, 3, 5, 4), (5, 4, 4, 6), (6, 4, 2, 6), (4, 6, 8, 4),
          (8, 8, 8, 8), (6, 4, 4, 8), (32, 32, 32, 32), (32, 32, 32, 64),
          (24, 23, 25, 24), (12, 12, 12, 12), (16, 16, 16, 16),
          (20, 20, 20, 20),
          (6, 24, 24, 24), (30, 30, 30, 32), (5, 24, 24, 24),
          (31, 32, 32, 32)]
SMALL = [(4, 4, 4, 4), (8, 4, 4, 8), (6, 3, 5, 4), (8, 3, 5, 4),
         (5, 4, 4, 6), (3, 3, 3, 4)]


def _source(name: str) -> str:
    return (CSRC / name).read_text()


def _constant(src: str, name: str) -> int:
    return int(re.search(r"constexpr int " + name + r" = (\d+);",
                         src).group(1))


def _term_table() -> list:
    src = _source("hisq16_dslash.cu")
    m = re.search(r"term_geom\(int t, int f\) \{\s*constexpr int "
                  r"g\[16\]\[3\] = (\{[^;]*\});", src)
    return ast.literal_eval(m.group(1).replace("{", "[").replace("}", "]"))


def _geometries(dims):
    for aligned in (True, False):
        yield "hisq16", sh.hisq16_geometry(dims, aligned)
        for ldt in (torch.float32, torch.bfloat16):
            yield "v1", sp1.v1_geometry(dims, ldt, aligned)


def test_kernel_constants_match_the_wrappers():
    hisq = _source("hisq16_dslash.cu")
    assert sh.HISQ16_SITES == _constant(hisq, "kSites")
    assert sh.HISQ16_VECTOR_THREADS == _constant(hisq, "kVectorThreads")
    assert sh.HISQ16_SITE_THREADS == _constant(hisq, "kSiteThreads")
    v1 = _source("stag_v1_dslash.cu")
    assert sp1.V1_SITES == _constant(v1, "kSites")
    assert sp1.V1_VECTOR_THREADS == _constant(v1, "kVectorThreads")
    assert sp1.V1_SITE_THREADS == _constant(v1, "kSiteThreads")


@pytest.mark.parametrize("dims", SHAPES)
def test_geometry_covers_every_site_once(dims):
    """Thread i of the grid takes sites [k*i, k*i + k) below V (the
    kernels' `first = (blockIdx.x * blockDim.x + threadIdx.x) * K`), with
    k and the block size of the path it takes."""
    X, Y, Z, T = dims
    V = X * Y * Z * T // 2
    for kind, g in _geometries(dims):
        k_vec, vec_threads, site_threads = (
            (sh.HISQ16_SITES, sh.HISQ16_VECTOR_THREADS,
             sh.HISQ16_SITE_THREADS) if kind == "hisq16" else
            (sp1.V1_SITES, sp1.V1_VECTOR_THREADS, sp1.V1_SITE_THREADS))
        assert g.sites == V
        assert (g.k, g.threads) == ((k_vec, vec_threads) if g.vector
                                    else (1, site_threads))
        owners = np.arange(g.blocks * g.threads, dtype=np.int64)
        sites = (owners[:, None] * g.k + np.arange(g.k)).ravel()
        sites = sites[sites < V]
        assert sites.size == V and np.array_equal(np.sort(sites),
                                                  np.arange(V))
        # no block without a site
        assert (g.blocks - 1) * g.threads * g.k < V


@pytest.mark.parametrize("source", ["hisq16_dslash.cu", "stag_v1_dslash.cu"])
def test_kernels_ask_for_no_shared_memory(source):
    """Within Hopper's 232,448 B of dynamic shared memory a block: the
    kernels declare none and both paths launch with 0 B."""
    src = _source(source)
    assert "__shared__" not in src
    shared = re.findall(r"<<<\s*\w+\s*,\s*\w+\s*,\s*([^,]+),", src)
    assert shared == ["0", "0"]


@pytest.mark.parametrize("dims", SHAPES)
def test_vector_path_loads_are_aligned(dims):
    """Where the grid takes the vector path (operands aligned to 16 B),
    a thread's k sites share an x row, and each offset that a vector load
    adds to an aligned base is a multiple of the load's width in
    elements: the first site (a multiple of k), the row, z-plane,
    th-plane and operand-plane strides (X, X*Y, X*Y*Z, V), since y and z
    gathers shift by whole rows and planes.  Links load k elements at a
    time; spinor and store pairs two sites (hisq16: one float4 of two
    complex64; v1: one float2 of two floats)."""
    X, Y, Z, T = dims
    strides = (X, X * Y, X * Y * Z, X * Y * Z * T // 2)
    for kind, g in _geometries(dims):
        if not g.vector:
            continue
        assert X % g.k == 0                      # k sites in one x row
        for width in (g.k, 2):                   # links, spinor pairs
            assert g.k % width == 0
            assert all(stride % width == 0 for stride in strides)
    assert not sh.hisq16_geometry(dims, aligned=False).vector
    assert not sp1.v1_geometry(dims, aligned=False).vector


@pytest.mark.parametrize("dims", SHAPES)
def test_which_path_each_kernel_takes(dims):
    """The 16-term kernel takes the vector path wherever its loads fit
    (X % 4 == 0); v1 where X is even and a hop moves at least
    V1_VECTOR_MIN_BYTES (624 B a site with f32 links, 336 with bf16),
    so that 16^4 and 20^4 with bf16 links take the per-site path and
    24^4 the vector path."""
    X, Y, Z, T = dims
    V = X * Y * Z * T // 2
    assert sh.hisq16_geometry(dims).vector == (X % 4 == 0)
    for ldt, per_site in ((torch.float32, 624), (torch.bfloat16, 336)):
        big = V * per_site >= sp1.V1_VECTOR_MIN_BYTES
        assert sp1.v1_geometry(dims, ldt).vector == (X % 2 == 0 and big)
    if dims in ((16, 16, 16, 16), (20, 20, 20, 20)):
        assert not sp1.v1_geometry(dims, torch.bfloat16).vector
    if dims == (24, 24, 24, 24):
        assert sp1.v1_geometry(dims, torch.bfloat16).vector


def _wrap(c, k, n):
    return (c + k + 4 * n) % n


def _coords(dims, site):
    X, Y, Z, T = dims
    YX, ZYX = X * Y, X * Y * Z
    yx = site % YX
    return yx % X, yx // X, (site // YX) % Z, site // ZYX


def _hisq_nb(dims, parity, mu, step, k_sites=1):
    """hop_sites<L, K>'s neighbour of every site, restated: the thread of
    site0 = K*i handles x0 + k with sublattice s0 ^ (k & 1); on the
    vector path its y and z hops load site0 + shift + k."""
    X, Y, Z, T = dims
    Th, YX, ZYX = T // 2, X * Y, X * Y * Z
    site = np.arange(Th * ZYX)
    k = site % k_sites
    site0 = site - k
    x, y, z, th = _coords(dims, site)
    x0 = x - k
    s0 = (parity + x0 + y + z) & 1
    if k_sites > 1 and mu in (1, 2):
        shift = ((_wrap(y, step, Y) - y) * X if mu == 1
                 else (_wrap(z, step, Z) - z) * YX)
        return site0 + shift + k
    if mu == 0:
        return site - x0 - k + _wrap(x0 + k, step, X)
    if mu == 1:
        return site + (_wrap(y, step, Y) - y) * X
    if mu == 2:
        return site + (_wrap(z, step, Z) - z) * YX
    s = s0 ^ (k & 1)
    return site + (_wrap(th, s + (step - 1) // 2, Th) - th) * ZYX


def _v1_nb(dims, parity, j, k_sites=1):
    """stag_v1_dslash.cu's nbr(j, k) of every site, restated: the thread
    of site0 = K*i takes x = x0 + k with sublattice s0 ^ (k & 1); on the
    vector path its y and z hops (j = 1, 2, 5, 6) load nbr(j, 0) + k."""
    X, Y, Z, T = dims
    Th, YX, ZYX = T // 2, X * Y, X * Y * Z
    site = np.arange(Th * ZYX)
    k = site % k_sites
    site0 = site - k
    _, y, z, th = _coords(dims, site0)
    yx = site0 % YX
    x0 = yx % X
    row, tz = site0 - x0, th * ZYX + z * YX

    def nbr(k):
        x = x0 + k
        s = ((parity + x0 + y + z) & 1) ^ (k & 1)
        return [row + np.where(x + 1 == X, 0, x + 1),
                tz + np.where(y + 1 == Y, 0, y + 1) * X + x,
                th * ZYX + np.where(z + 1 == Z, 0, z + 1) * YX + yx + k,
                np.where(s == 1, np.where(th + 1 == Th, 0, th + 1), th)
                * ZYX + z * YX + yx + k,
                row + np.where(x == 0, X - 1, x - 1),
                tz + np.where(y == 0, Y - 1, y - 1) * X + x,
                th * ZYX + np.where(z == 0, Z - 1, z - 1) * YX + yx + k,
                np.where(s == 1, th, np.where(th == 0, Th - 1, th - 1))
                * ZYX + z * YX + yx + k][j]

    if k_sites > 1 and j % 4 in (1, 2):
        return nbr(0) + k
    return nbr(k)


def _shifted_index(dims, mu, sign, parity, dist):
    lat = Lattice(dims)
    X, Y, Z, T = dims
    f = torch.arange(X * Y * Z * T // 2, dtype=torch.float64).reshape(
        T // 2, Z, Y * X)
    return sf.shift_fast(f, mu, sign, parity, lat, dist).reshape(-1).long(
        ).numpy()


def test_term_table_is_the_plain_hops_order():
    """Term t = kind*4 + mu (stag_hisq._hop_plain, new_hisq16): kinds 0/2
    forward, 1/3 backward, 0/1 one hop, 2/3 three hops."""
    assert _term_table() == [[t % 4, 1 if (t // 4) % 2 == 0 else -1,
                              1 if t < 8 else 3] for t in range(16)]


@pytest.mark.parametrize("dims", SMALL)
def test_hisq16_neighbours_match_shift_fast(dims):
    ks = [1] + ([sh.HISQ16_SITES] if dims[0] % sh.HISQ16_SITES == 0 else [])
    for parity in (0, 1):
        for mu, sign, dist in _term_table():
            ref = _shifted_index(dims, mu, sign, parity, dist)
            for k in ks:
                got = _hisq_nb(dims, parity, mu, sign * dist, k)
                assert np.array_equal(got, ref), (parity, mu, sign, dist, k)


@pytest.mark.parametrize("dims", SMALL)
def test_v1_neighbours_match_shift_fast(dims):
    ks = [1] + ([sp1.V1_SITES] if dims[0] % sp1.V1_SITES == 0 else [])
    for parity in (0, 1):
        for j in range(8):
            ref = _shifted_index(dims, j % 4, 1 if j < 4 else -1, parity, 1)
            for k in ks:
                assert np.array_equal(_v1_nb(dims, parity, j, k), ref), (
                    parity, j, k)
