"""The Wilson slice of qex_tpu_torch against qex_tpu.

In complex128 at 4^4 (m=0.1, bc pppa): the chiral gammas exactly; the
full and eo operators, the fast-layout half-spinor operator, and
solve/solve_eo (the kernel twin's route at 4^4, the plain fast route
forced there, the canonical eo route at nd=3) to 1e-12 relative. In
complex64 at 6x4x8x4 (X != Y, two z-blocks at nzb=4): the pre-shifted
links exactly, and the twin of kernels B3 (float32 links) and B3b
(bfloat16 links), hop at both parities, m_ee_w and m_ee_dag_w, against
the JAX Pallas kernel in interpret mode (z-blocked and full-Z) to
squared deviation 1e-12 (float32 arithmetic); the sloppy solve against
the JAX cg_solve_restarted on that Pallas operator (the TPU route of
qex_tpu.physics.wilson.solve_eo). The Wilson meson channels to 1e-12.
The CUDA kernels are checked against the twin on a card by
tests/test_torch_kernels_gpu.py.

An interpret-mode Pallas hop costs about 8 s to lower and compile here,
so the reference operator is compiled once, with the links as arguments,
and the reference CG reaches it through jax.pure_callback.
"""

import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, ginibre, n, random_links, rel, rel2,
                            single_threaded, t)
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.observables import mesons as jmesons
from qex_tpu.ops import eo as jeo
from qex_tpu.physics import stag_fast as jsf
from qex_tpu.physics import wilson as jwl
from qex_tpu.physics import wilson_fast as jwf
from qex_tpu.physics import wilson_pallas as jwp
from qex_tpu.solvers import cg as jcg
from qex_tpu.solvers.base import SolverParams as JSolverParams
from qex_tpu_torch import convert
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.observables import mesons
from qex_tpu_torch.physics import stag_fast as sf
from qex_tpu_torch.physics import wilson as wl
from qex_tpu_torch.physics import wilson_fast as wf
from qex_tpu_torch.physics import wilson_pallas as wp
from qex_tpu_torch.solvers.base import SolverParams

pytestmark = pytest.mark.usefixtures("single_threaded")

TOL = 1e-12
M = 0.1
DIMS = (4, 4, 4, 4)            # fits: the kernel twin's solve route
DIMS_3D = (4, 4, 4)            # nd = 3: the canonical eo route
DIMS_K = (6, 4, 8, 4)
REPO = Path(__file__).resolve().parent.parent


def test_gamma_matrices_exact():
    g = wl.gamma_matrices()
    assert g.dtype == complex
    assert np.array_equal(g, np.asarray(jwl.gamma_matrices()))
    assert wl.wilson_flops_per_site() == jwl.wilson_flops_per_site()


def test_sigma_tables_match_gammas_and_kernel_source():
    """_sigma_struct equals the JAX one, and the compile-time tables of
    csrc/wilson8_dslash.cu hold the same (p, c = i^k)."""
    src = (REPO / "qex_tpu_torch" / "csrc" / "wilson8_dslash.cu").read_text()

    def table(name):
        m = re.search(name + r"\(int mu, int r\) \{\s*constexpr int "
                      r"t\[4\]\[2\] = (\{[^;]*\});", src)
        return ast.literal_eval(m.group(1).replace("{", "[").replace("}", "]"))

    perm, ipow = table("sigma_perm"), table("sigma_ipow")
    for mu in range(4):
        p, c = wp._sigma_struct(mu)
        assert (p, c) == jwp._sigma_struct(mu)
        assert list(p) == perm[mu]
        assert list(c) == [1j ** k for k in ipow[mu]]


@pytest.fixture(scope="module")
def ops():
    """The JAX operators and solves in complex128, one compile."""
    rng = np.random.default_rng(31)
    cases = {}
    for dims in (DIMS, DIMS_3D):
        jlat = JLattice(dims)
        bc = "pppa" if len(dims) == 4 else "ppa"
        u = random_links(rng, jlat)
        b = ginibre(rng, (4, 3) + dims)
        cases[dims] = (jlat, bc, u, b)
    jp = JSolverParams(r2req=1e-26, maxits=1000, restarts=3)

    def ref(args):
        out = {}
        for dims, (u, b) in args.items():
            jlat, bc = cases[dims][:2]
            weo = jwl.new_wilson_eo(jlat, u, M, bc)
            x, stats = jwl.solve_eo(weo, b, jp)
            out[dims] = {"solve_eo": (x, stats.iterations)}
        jlat, bc, _, _ = cases[DIMS]
        u, b = args[DIMS]
        w = jwl.new_wilson(jlat, u, M, bc)
        weo = jwl.new_wilson_eo(jlat, u, M, bc)
        fw = jwf.new_fast_wilson(weo)
        be = jnp.asarray(b)[..., ::2]         # any half-lattice field
        bf = jsf.to_fast(be, jlat)
        x, stats = jwl.solve(w, b, jp)
        out[DIMS].update(
            g=w.g, hop=jwl.wilson_hop(w, b), d=jwl.wilson_d(w, b),
            d_dag=jwl.wilson_d_dag(w, b), ddagd=jwl.wilson_ddagd(w, b),
            g_e=weo.g_e, g_o=weo.g_o,
            hop_eo=[jwl.wilson_hop_eo(weo, be, p) for p in (0, 1)],
            m_ee=jwl.wilson_m_ee(weo, be),
            m_ee_dag=jwl.wilson_m_ee_dag(weo, be),
            fg_e=fw.g_e, fg_o=fw.g_o,
            hop_fast=[jwf.hop_fast(fw, bf, p) for p in (0, 1)],
            m_ee_fast=jwf.m_ee_fast(fw, bf),
            m_ee_dag_fast=jwf.m_ee_dag_fast(fw, bf),
            solve=(x, stats.iterations))
        return out

    args = {dims: (c[2], c[3]) for dims, c in cases.items()}
    return cases, compile_ref(ref, args)(args)


def test_operators_match_reference(ops):
    cases, refs = ops
    jlat, bc, u, b = cases[DIMS]
    r = refs[DIMS]
    lat = Lattice(DIMS)
    w = wl.new_wilson(lat, t(u), M, bc)
    tb = t(b)
    assert rel(n(w.g), r["g"]) < TOL
    for name, fn in (("hop", wl.wilson_hop), ("d", wl.wilson_d),
                     ("d_dag", wl.wilson_d_dag), ("ddagd", wl.wilson_ddagd)):
        assert rel(n(fn(w, tb)), r[name]) < TOL, name
    weo = wl.new_wilson_eo(lat, t(u), M, bc)
    assert rel(n(weo.g_e), r["g_e"]) < TOL
    assert rel(n(weo.g_o), r["g_o"]) < TOL
    be = tb[..., ::2].contiguous()
    for p in (0, 1):
        assert rel(n(wl.wilson_hop_eo(weo, be, p)), r["hop_eo"][p]) < TOL
    assert rel(n(wl.wilson_m_ee(weo, be)), r["m_ee"]) < TOL
    assert rel(n(wl.wilson_m_ee_dag(weo, be)), r["m_ee_dag"]) < TOL


def test_fast_operator_matches_reference(ops):
    cases, refs = ops
    jlat, bc, u, b = cases[DIMS]
    r = refs[DIMS]
    lat = Lattice(DIMS)
    fw = wf.new_fast_wilson(wl.new_wilson_eo(lat, t(u), M, bc))
    assert np.array_equal(n(fw.g_e), np.asarray(r["fg_e"]))
    assert np.array_equal(n(fw.g_o), np.asarray(r["fg_o"]))
    for mu in range(4):
        for sign in (1, -1):
            assert np.allclose(wf._half_basis(mu, sign),
                               jwf._half_basis(mu, sign), atol=0, rtol=0)
    bf = sf.to_fast(t(b)[..., ::2].contiguous(), lat)
    for p in (0, 1):
        assert rel(n(wf.hop_fast(fw, bf, p)), r["hop_fast"][p]) < TOL
    assert rel(n(wf.m_ee_fast(fw, bf)), r["m_ee_fast"]) < TOL
    assert rel(n(wf.m_ee_dag_fast(fw, bf)), r["m_ee_dag_fast"]) < TOL
    # the kernel twin computes the same hop on pre-shifted links
    pw = wp.new_pallas_wilson(fw, links_dtype=torch.float64)
    for p in (0, 1):
        assert rel(n(wp.hop_w(pw, bf, p)), r["hop_fast"][p]) < TOL
    assert rel(n(wp.m_ee_w(pw, bf)), r["m_ee_fast"]) < TOL
    assert rel(n(wp.m_ee_dag_w(pw, bf)), r["m_ee_dag_fast"]) < TOL


@pytest.mark.parametrize("route", ["twin", "fast", "canonical"])
def test_solve_eo_matches_reference(ops, route, monkeypatch):
    """Each route of solve_eo against the JAX solve: the kernel twin
    (4^4 fits), the plain fast layout (a lattice that does not fit,
    forced at 4^4) and the canonical eo operator (nd = 3)."""
    cases, refs = ops
    dims = DIMS_3D if route == "canonical" else DIMS
    jlat, bc, u, b = cases[dims]
    x_ref, its_ref = refs[dims]["solve_eo"]
    lat = Lattice(dims)
    assert wp.fits(lat) == (route != "canonical")
    calls = []
    if route == "fast":
        monkeypatch.setattr(wp, "fits", lambda lat: False)
    monkeypatch.setattr(wp, "hop_w_plain", lambda *a, _f=wp.hop_w_plain,
                        **k: calls.append(1) or _f(*a, **k))
    w = wl.new_wilson_eo(lat, t(u), M, bc)
    x, stats = wl.solve_eo(w, t(b), SolverParams(r2req=1e-26, maxits=1000,
                                                 restarts=3))
    assert bool(calls) == (route == "twin")
    assert rel(n(x), x_ref) < TOL
    assert abs(stats.iterations - int(its_ref)) <= 2
    d = wl.new_wilson(lat, t(u), M, bc)
    assert rel(n(wl.wilson_d(d, x)), b) ** 2 < 1e-24


def test_solve_matches_reference(ops):
    cases, refs = ops
    jlat, bc, u, b = cases[DIMS]
    x_ref, its_ref = refs[DIMS]["solve"]
    lat = Lattice(DIMS)
    x, stats = wl.solve(wl.new_wilson(lat, t(u), M, bc), t(b),
                        SolverParams(r2req=1e-26, maxits=1000, restarts=3))
    assert rel(n(x), x_ref) < TOL
    assert abs(stats.iterations - int(its_ref)) <= 2


# --- kernels B3 / B3b: the twin against the Pallas kernel --------------------

M8 = 0.25


@pytest.fixture(scope="module")
def kern():
    """The JAX pre-shifted links (float32 and bfloat16) and one
    interpret-mode executable (links, x) -> (hop(x, 1), hop(hop(x, 1), 0),
    a x - hop(hop(x, 1), 0) / a): the body of m_ee_pallas with its
    intermediate hop exposed, the first hop z-blocked (nzb=4, two
    blocks) and the second on one full-Z block (nzb=None).  bf16 links
    enter it widened to float32, which is exact and is what the kernel
    does with them first."""
    rng = np.random.default_rng(37)
    jlat = JLattice(DIMS_K)
    u = random_links(rng, jlat).astype(np.complex64)
    X, Y, Z, T = DIMS_K
    xf = ginibre(rng, (4, 3, T // 2, Z, Y * X)).astype(np.complex64)
    b = ginibre(rng, (4, 3) + DIMS_K).astype(np.complex64)
    links = compile_ref(lambda u: {ldt: (pw.l_e, pw.l_o) for ldt, pw in (
        (ldt, jwp.new_pallas_wilson(jwl.new_wilson_eo(jlat, u, M8),
                                    links_dtype=ldt))
        for ldt in ("float32", "bfloat16"))}, u)(u)

    def body(l_e, l_o, xs):
        pw = jwp.PallasWilsonEO(jlat, l_e, l_o, M8)
        t1 = jwp.hop_pallas_w(pw, xs, 1, nzb=4, interpret=True)
        y = jwp.hop_pallas_w(pw, t1, 0, nzb=None, interpret=True)
        return t1, y, pw.a * xs - y / pw.a

    l32 = [np.asarray(v) for v in links["float32"]]
    exe = compile_ref(body, *l32, np.asarray(jwp._split(jnp.asarray(xf))))
    return jlat, u, xf, b, links, exe


def _run(kern, ldt, v):
    """complex fast-layout v -> the executable's outputs (numpy) on the
    JAX links of dtype ``ldt``."""
    links, exe = kern[4], kern[5]
    l_e, l_o = (np.asarray(x).astype(np.float32) for x in links[ldt])
    xs = np.stack([v.real, v.imag]).astype(np.float32)
    return [np.asarray(o) for o in exe(l_e, l_o, xs)]


def _cplx(split):
    return split[0] + 1j * split[1]


def _g5(v):
    return np.concatenate([v[:2], -v[2:]])


@pytest.mark.parametrize("links", ["float32", "bfloat16"])
def test_hop_twin_vs_pallas_interpret(kern, links):
    jlat, u, xf = kern[:3]
    l_e, l_o = (np.asarray(x).astype(np.float32) for x in kern[4][links])
    t1, y, mee = _run(kern, links, xf)
    pw = wp.new_pallas_wilson(wl.new_wilson_eo(Lattice(DIMS_K), t(u), M8),
                              links_dtype=getattr(torch, links))
    # pre-shifted links bit for bit (bf16 rounded to nearest even as JAX)
    assert pw.l_e.dtype == getattr(torch, links) and pw.l_e.is_contiguous()
    assert np.array_equal(n(pw.l_e.float()), l_e)
    assert np.array_equal(n(pw.l_o.float()), l_o)
    got1 = wp.hop_w(pw, t(xf), 1)
    assert got1.dtype == torch.complex64
    assert rel2(n(got1), _cplx(t1)) < TOL
    assert rel2(n(wp.hop_w(pw, t(_cplx(t1).astype(np.complex64)), 0)),
                _cplx(y)) < TOL
    assert rel2(n(wp.m_ee_w(pw, t(xf))), _cplx(mee)) < TOL
    mdag = _g5(_cplx(_run(kern, links, _g5(xf))[2]))   # m_ee_dag_pallas
    assert rel2(n(wp.m_ee_dag_w(pw, t(xf))), mdag) < TOL


def test_sloppy_solve_matches_reference(kern):
    """The TPU route of wilson.solve_eo: restarted CG whose inner
    operator is the Pallas one on bf16 links, true residuals on f32
    links, inner floor 1e-5, the eo bracket by the fast operator; all in
    float32.  The port runs its twins on the same algorithm, so the
    iteration counts agree up to float32 summation order."""
    jlat, u, _, b = kern[:4]
    r2req = 1e-9
    a = 4 + M8

    def normal(ldt):
        def f(v):
            m1 = _cplx(_run(kern, ldt, v)[2])
            m2 = _cplx(_run(kern, ldt, _g5(m1).astype(np.complex64))[2])
            return _g5(m2).astype(np.complex64)
        return lambda v: jax.pure_callback(
            f, jax.ShapeDtypeStruct(v.shape, v.dtype), v)

    def ref(u, b):
        w = jwl.new_wilson_eo(jlat, u, M8)
        fw = jwf.new_fast_wilson(w)
        be, bo = jeo.pack(b, 4)
        bf_e, bf_o = jsf.to_fast(be, jlat), jsf.to_fast(bo, jlat)
        rhs = bf_e + jwf.hop_fast(fw, bf_o, 0) / a
        xf_e, stats = jcg.cg_solve_restarted(
            normal("bfloat16"), jwf.m_ee_dag_fast(fw, rhs), r2req=r2req,
            maxits=1000, restarts=5, op_true=normal("float32"),
            inner_r2req_floor=1e-5)
        xf_o = (bf_o + jwf.hop_fast(fw, xf_e, 1)) / a
        return (jeo.unpack(jsf.from_fast(xf_e, jlat),
                           jsf.from_fast(xf_o, jlat), 4), stats.iterations)

    x_ref, its_ref = jax.jit(ref)(u, b)
    lat = Lattice(DIMS_K)
    w = wl.new_wilson_eo(lat, t(u), M8)
    x, stats = wl.solve_eo(w, t(b), SolverParams(r2req=r2req, maxits=1000,
                                                 restarts=5, sloppy=True))
    assert x.dtype == torch.complex64
    assert abs(stats.iterations - int(its_ref)) <= 3, (stats.iterations,
                                                       int(its_ref))
    assert rel(n(x), np.asarray(x_ref)) < 1e-4
    d = wl.new_wilson(lat, t(u).to(torch.complex128), M8)
    for sol in (n(x), np.asarray(x_ref)):
        true = rel(n(wl.wilson_d(d, t(sol).to(torch.complex128))), b) ** 2
        assert true <= 10 * r2req


# --- mesons ------------------------------------------------------------------

def test_wilson_mesons_match_reference():
    rng = np.random.default_rng(41)
    jlat, lat = JLattice(DIMS), Lattice(DIMS)
    props = ginibre(rng, (4, 3, 4, 3) + DIMS)
    refs = compile_ref(lambda p: (
        jmesons.wilson_mesons_from_prop(jlat, p, jmesons.WILSON_CHANNELS),
        jmesons.wilson_pion_from_prop(jlat, p)), props)(props)
    assert mesons.WILSON_CHANNELS == jmesons.WILSON_CHANNELS
    got = mesons.wilson_mesons_from_prop(lat, t(props),
                                         mesons.WILSON_CHANNELS)
    for ch in mesons.WILSON_CHANNELS:
        assert got[ch].shape == (DIMS[3],)
        assert rel(n(got[ch]), refs[0][ch]) < TOL, ch
    assert rel(n(got["pion"]), n(mesons.wilson_pion_from_prop(
        lat, t(props)))) < TOL
    assert rel(n(mesons.wilson_pion_from_prop(lat, t(props))),
               refs[1]) < TOL


def test_wilson_from_reference(ops):
    """The JAX operator objects (built on the reference's arrays) carry
    across to the port's."""
    cases, refs = ops
    jlat, bc, u, _ = cases[DIMS]
    r = refs[DIMS]
    lat = Lattice(DIMS)
    weo = wl.new_wilson_eo(lat, t(u), M, bc)
    for ref, cls, mine in (
            (jwl.WilsonD(jlat, r["g"], M), wl.WilsonD,
             wl.new_wilson(lat, t(u), M, bc)),
            (jwl.WilsonEO(jlat, r["g_e"], r["g_o"], M), wl.WilsonEO, weo),
            (jwf.FastWilsonEO(jlat, r["fg_e"], r["fg_o"], M),
             wf.FastWilsonEO, wf.new_fast_wilson(weo))):
        got = convert.wilson_from_reference(ref, device="cpu",
                                            dtype=torch.complex128)
        assert type(got) is cls and got.lat == lat and got.m == M
        for f in ("g", "g_e", "g_o"):
            if hasattr(mine, f):
                assert rel(n(getattr(got, f)), n(getattr(mine, f))) < TOL
