"""Staggered operator parity of qex_tpu_torch against qex_tpu: the
canonical eo operator and the fast layout to 1e-12 relative
(complex128), the pre-shifted 8-term links exactly, and the 8-term hop
against the JAX Pallas kernel run in interpret mode (which computes in
float32, hence the kernel tests' squared-deviation bound of 1e-12).
The CUDA kernel itself is checked against its plain version on a card
by tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, ginibre, n, random_links, rel, rel2,
                            single_threaded, t)
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.physics import stag_fast as jsf
from qex_tpu.physics import stag_pallas_hisq as jsph
from qex_tpu.physics import staggered as jst
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.physics import stag_fast as sf
from qex_tpu_torch.physics import stag_hisq as sh
from qex_tpu_torch.physics import staggered as st

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (8, 4, 4, 8)
TOL = 1e-12


@pytest.fixture(scope="module")
def ops():
    rng = np.random.default_rng(31)
    jlat, lat = JLattice(DIMS), Lattice(DIMS)
    u = random_links(rng, jlat)
    xe = ginibre(rng, (3,) + DIMS[:3] + (DIMS[3] // 2,))
    js = jst.new_stag_eo(jlat, jnp.asarray(u))
    s = st.new_stag_eo(lat, t(u))
    return jlat, lat, u, xe, js, s


def test_phases_and_bc_exact():
    jlat, lat = JLattice(DIMS), Lattice(DIMS)
    bcs = ("pppa", "pppp", "apap")
    ref_eta, ref_bc = compile_ref(lambda: (
        jst.staggered_phases(jlat, jnp.float64),
        [jst.bc_signs(jlat, bc, jnp.float64) for bc in bcs]))()
    assert np.array_equal(n(st.staggered_phases(lat, torch.float64,
                                                "cpu")),
                          np.asarray(ref_eta))
    for bc, ref in zip(bcs, ref_bc):
        assert np.array_equal(n(st.bc_signs(lat, bc, torch.float64, "cpu")),
                              np.asarray(ref))
    with pytest.raises(ValueError):
        st.bc_signs(lat, "ppp")


@pytest.mark.parametrize("bc", ["pppa", "apap"])
def test_d_full(bc):
    """The full-lattice oracle D(m) = m + Dslash at 4^4 on phased links."""
    rng = np.random.default_rng(5)
    dims = (4, 4, 4, 4)
    jlat, lat = JLattice(dims), Lattice(dims)
    u = random_links(rng, jlat)
    x = ginibre(rng, (3,) + dims)
    ref_d, ref_dslash = compile_ref(lambda v, y: (
        jst.d_full(jlat, jst.phase_links(jlat, v, bc), y, 0.3),
        jst.dslash_full(jlat, jst.phase_links(jlat, v, bc), y)), u, x)(u, x)
    g = st.phase_links(lat, t(u), bc)
    assert rel(n(st.d_full(lat, g, t(x), 0.3)), ref_d) < TOL
    assert rel(n(st.dslash_full(lat, g, t(x))), ref_dslash) < TOL


def test_new_stag_eo_links(ops):
    _, _, _, _, js, s = ops
    assert rel(n(s.g_e), js.g_e) < TOL
    assert rel(n(s.g_o), js.g_o) < TOL


@pytest.mark.parametrize("parity", [0, 1])
def test_dslash_eo(ops, parity):
    _, _, _, xe, js, s = ops
    ref = jst.dslash_eo(js, jnp.asarray(xe), parity)
    assert rel(n(st.dslash_eo(s, t(xe), parity)), ref) < TOL


def test_d2ee_d2dd_reconstruct(ops):
    _, _, _, xe, js, s = ops
    jx = jnp.asarray(xe)
    assert rel(n(st.d2ee(s, t(xe), 0.3)), jst.d2ee(js, jx, 0.3)) < TOL
    assert rel(n(st.d2dd(s, t(xe), 1)), jst.d2dd(js, jx, 1)) < TOL
    bo = 0.5 * xe[::-1].copy()
    ref = jst.reconstruct_odd(js, jx, jnp.asarray(bo), 0.3)
    assert rel(n(st.reconstruct_odd(s, t(xe), t(bo), 0.3)), ref) < TOL


def test_dslash_flops_model():
    for nd, nc in ((4, 3), (4, 2), (3, 3)):
        assert (st.dslash_flops_per_site(nd, nc)
                == jst.dslash_flops_per_site(nd, nc))


@pytest.fixture(scope="module")
def fast_refs(ops):
    """JAX fast-layout references, all in one jit."""
    jlat, _, _, xe, js, _ = ops
    jfs = jsf.new_fast(js)

    def refs(x):
        xf = jsf.to_fast(x, jlat)
        return (xf, [jsf.dslash_fast(jfs, xf, par) for par in (0, 1)],
                jsf.d2ee_fast(jfs, xf, 0.2), jsf.d2dd_fast(jfs, xf, 0))

    xf, ds, ee, dd = compile_ref(refs, jnp.asarray(xe))(jnp.asarray(xe))
    return np.asarray(xf), ds, ee, dd


@pytest.mark.parametrize("parity", [0, 1])
def test_dslash_fast(ops, fast_refs, parity):
    s = ops[-1]
    xf, ds, ee, dd = fast_refs
    fs = sf.new_fast(s)
    assert rel(n(sf.dslash_fast(fs, t(xf), parity)), ds[parity]) < TOL
    assert rel(n(sf.d2ee_fast(fs, t(xf), 0.2)), ee) < TOL
    assert rel(n(sf.d2dd_fast(fs, t(xf), 0)), dd) < TOL


@pytest.mark.parametrize("links", ["f32", "f64"])
def test_new_stag8_links_exact(ops, links):
    _, _, _, _, js, s = ops
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "f64": (jnp.float64, torch.float64)}[links]
    def build(ge, go):
        jp8 = jsph.new_pallas_stag8(
            jsf.new_fast(jst.StaggeredEO(js.lat, ge, go)), links_dtype=jdt)
        return jp8.l_e, jp8.l_o

    ref_e, ref_o = compile_ref(build, js.g_e, js.g_o)(js.g_e, js.g_o)
    p8 = sh.new_stag8(s, links_dtype=tdt)
    assert p8.l_e.dtype == tdt and p8.l_e.is_contiguous()
    assert np.array_equal(n(p8.l_e), np.asarray(ref_e))
    assert np.array_equal(n(p8.l_o), np.asarray(ref_o))


@pytest.fixture(scope="module")
def stag8(ops):
    """The JAX 8-term kernel in interpret mode: both parities in one jit
    (each interpret-mode instance costs seconds to compile), and d2ee as
    d2ee_pallas_hisq computes it, m^2 x - D_0 D_1 x, on those two
    compiled hops."""
    jlat, _, _, xe, js, s = ops
    jfs = jsf.new_fast(js)
    jp8 = jsph.new_pallas_stag8(jfs)
    xf = np.asarray(jsf.to_fast(jnp.asarray(xe), jlat))

    def refs(x):
        return [jsph.dslash_pallas_hisq_c(jp8, x, parity, interpret=True)
                for parity in (0, 1)]

    hops = compile_ref(refs, jnp.asarray(xf))
    ds = hops(jnp.asarray(xf))
    # the hops take x in its dtype and round it to float32, as _split
    d1 = np.asarray(ds[1]).astype(xf.dtype)
    ee = (M8 * M8) * xf.astype(np.complex64) - np.asarray(hops(d1)[0])
    return jfs, ds, ee, sh.new_stag8(s), xf


M8 = 0.25


@pytest.mark.parametrize("parity", [0, 1])
def test_dslash_stag8_vs_pallas_interpret(stag8, parity):
    _, ds, _, p8, xf = stag8
    got = sh.dslash_stag8(p8, t(xf), parity)
    assert torch.equal(got, sh.dslash_stag8_plain(p8, t(xf), parity))
    assert rel2(n(got), ds[parity]) < TOL


def test_d2ee_d2dd_stag8_vs_pallas_interpret(stag8):
    jfs, _, ee, p8, xf = stag8
    assert rel2(n(sh.d2ee_stag8(p8, t(xf), M8)), ee) < TOL
    # the complex128 plain route is the fast-layout operator up to the
    # float32 rounding of the links
    assert rel(n(sh.d2ee_stag8(p8, t(xf), M8)),
               jsf.d2ee_fast(jfs, jnp.asarray(xf), M8)) < 1e-6
    assert rel(n(sh.d2dd_stag8(p8, t(xf), 0)),
               jsf.d2dd_fast(jfs, jnp.asarray(xf), 0)) < 1e-6


def test_dslash_stag8_rejects_other_devices(stag8):
    _, _, _, p8, xf = stag8
    with pytest.raises(ValueError):
        sh.dslash_stag8(p8, t(xf).to("meta"), 0)
