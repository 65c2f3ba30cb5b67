"""Staggered solve parity of qex_tpu_torch against qex_tpu on a 4^4
field (complex128, m=0.1, r2req 1e-20): solutions to 1e-10 relative and
iteration counts within 2.  The sloppy route: the bf16-link plain twin
against the JAX 8-term kernel with bf16 links in interpret mode
(8x4x4x8, complex64, squared deviation 1e-12), and the sloppy solve
against a JAX reference built from cg_solve_restarted on bf16-rounded
fast-layout links."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_helpers import (compile_ref, ginibre, n, random_links, rel, rel2,
                            single_threaded, t)
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.ops import eo as jeo
from qex_tpu.physics import stag_solve as jsolve
from qex_tpu.physics import staggered as jst
from qex_tpu.solvers import base as jbase
from qex_tpu.solvers import cg as jcg
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.physics import stag_solve, staggered as st
from qex_tpu_torch.solvers import cg
from qex_tpu_torch.solvers.base import SolverParams

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (4, 4, 4, 4)
M = 0.1


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(5)
    jlat = JLattice(DIMS)
    u = random_links(rng, jlat)
    b = ginibre(rng, (3,) + DIMS)
    jp = jbase.SolverParams(r2req=1e-20, maxits=1000, restarts=3)

    def ref(u, b):
        x, stats = jsolve.solve(jst.new_stag_eo(jlat, u), b, M, jp)
        return x, stats.iterations, stats.r2

    x, its, r2 = compile_ref(ref, u, b)(u, b)
    return u, b, np.asarray(x), int(its), float(r2)


def test_solve_matches_reference(problem):
    u, b, x_ref, its_ref, _ = problem
    lat = Lattice(DIMS)
    s = st.new_stag_eo(lat, t(u))
    x, stats = stag_solve.solve(
        s, t(b), M, SolverParams(r2req=1e-20, maxits=1000, restarts=3))
    assert rel(n(x), x_ref) < 1e-10
    assert abs(stats.iterations - its_ref) <= 2, (stats.iterations,
                                                  its_ref)
    assert stats.r2 <= 1e-20


def test_solve_eo_residual(problem):
    u, b, _, _, _ = problem
    lat = Lattice(DIMS)
    s = st.new_stag_eo(lat, t(u))
    from qex_tpu_torch.ops import eo
    be, bo = eo.pack(t(b), 4)
    xe, xo, _ = stag_solve.solve_eo(s, be, bo, M, SolverParams(r2req=1e-20))
    # D x = b on both parities
    re = M * xe + st.dslash_eo(s, xo, 0) - be
    ro = M * xo + st.dslash_eo(s, xe, 1) - bo
    res2 = float((re.abs() ** 2).sum() + (ro.abs() ** 2).sum())
    assert res2 / float((t(b).abs() ** 2).sum()) < 1e-18


def test_cg_solve_restarted_matches_reference():
    """Plain restarted CG on a diagonal SPD operator: same iterates as
    the JAX loop (exact arithmetic sequence, complex128)."""
    rng = np.random.default_rng(9)
    d = 0.05 + rng.random(64)
    b = ginibre(rng, (64,))
    xr, sr = jcg.cg_solve_restarted(lambda v: jnp.asarray(d) * v,
                                    jnp.asarray(b), r2req=1e-24,
                                    maxits=500, restarts=4)
    x, s = cg.cg_solve_restarted(lambda v: t(d) * v, t(b), r2req=1e-24,
                                 maxits=500, restarts=4)
    assert rel(n(x), xr) < 1e-12
    assert s.iterations == int(sr.iterations)


def test_cg_flops_model():
    lat, jlat = Lattice((8, 8, 8, 16)), JLattice((8, 8, 8, 16))
    for nc in (2, 3):
        assert (stag_solve.cg_flops(lat, 4, nc, 17)
                == int(jsolve.cg_flops(jlat, 4, nc, 17)))


@pytest.mark.parametrize("field", ["sloppy", "mesh"])
def test_unported_solver_routes_raise(problem, field):
    """The mesh route, plain or sloppy, once refused: on a one-rank mesh
    (no process group) it runs the solve on the mesh's one block and
    gives the unmeshed solve's iterations and solution (the multi-rank
    solves are in tests/test_torch_parallel.py)."""
    from qex_tpu_torch.parallel.mesh import make_lattice_mesh
    u, b, _, _, _ = problem
    lat = Lattice(DIMS)
    s = st.new_stag_eo(lat, t(u))
    sloppy = field == "sloppy"
    # the sloppy route's bf16 inner iterations end near 1e-12
    r2req, tol = (1e-10, 1e-4) if sloppy else (1e-20, 1e-9)
    sp = dict(r2req=r2req, maxits=1000, restarts=5, sloppy=sloppy)
    x0, s0 = stag_solve.solve(s, t(b), M, SolverParams(**sp))
    x1, s1 = stag_solve.solve(s, t(b), M, SolverParams(
        mesh=make_lattice_mesh(lat, (1, 1, 1, 1)), **sp))
    # the block route sums in another order; both reach r2req
    assert abs(s1.iterations - s0.iterations) <= 2
    assert s1.r2 <= r2req and s0.r2 <= r2req
    assert rel(n(x1), n(x0)) < tol


DIMS8 = (8, 4, 4, 8)
M8 = 0.25


@pytest.fixture(scope="module")
def stag8_bf16():
    """The JAX 8-term kernel on bf16 links in interpret mode, complex64
    links and spinor: both parities in one jit, and d2ee as
    d2ee_pallas_hisq computes it, m^2 x - D_0 D_1 x, on those two
    compiled hops (each interpret-mode instance costs seconds to
    compile)."""
    from qex_tpu.physics import stag_fast as jsf
    from qex_tpu.physics import stag_pallas_hisq as jsph
    rng = np.random.default_rng(17)
    jlat = JLattice(DIMS8)
    u = random_links(rng, jlat).astype(np.complex64)
    xf = ginibre(rng, (3, DIMS8[3] // 2, DIMS8[2], DIMS8[1] * DIMS8[0])
                 ).astype(np.complex64)

    def refs(u, x):
        jp8 = jsph.new_pallas_stag8(jsf.new_fast(jst.new_stag_eo(jlat, u)),
                                    links_dtype=jnp.bfloat16)
        return (jp8.l_e, jp8.l_o,
                [jsph.dslash_pallas_hisq_c(jp8, x, parity, interpret=True)
                 for parity in (0, 1)])

    hops = compile_ref(refs, u, xf)
    l_e, l_o, ds = hops(u, xf)
    ee = (M8 * M8) * xf - np.asarray(hops(u, np.asarray(ds[1]))[2][0])
    return u, xf, np.asarray(l_e), np.asarray(l_o), ds, ee


def test_stag8_bf16_twin_vs_pallas_interpret(stag8_bf16):
    import torch
    from qex_tpu_torch.physics import stag_hisq as sh
    u, xf, l_e, l_o, ds, ee = stag8_bf16
    p8 = sh.new_stag8(st.new_stag_eo(Lattice(DIMS8), t(u)),
                      links_dtype=torch.bfloat16)
    # the links are rounded to nearest even, bit for bit as JAX
    assert p8.l_e.dtype == torch.bfloat16 and p8.l_e.is_contiguous()
    assert np.array_equal(n(p8.l_e.float()), l_e.astype(np.float32))
    assert np.array_equal(n(p8.l_o.float()), l_o.astype(np.float32))
    for parity in (0, 1):
        got = sh.dslash_stag8(p8, t(xf), parity)
        assert got.dtype == torch.complex64
        assert rel2(n(got), ds[parity]) < 1e-12
    assert rel2(n(sh.d2ee_stag8(p8, t(xf), M8)), ee) < 1e-12


def test_sloppy_solve_matches_reference(problem):
    """JAX ignores ``sloppy`` off the TPU, so the reference is the
    TPU route's algorithm: restarted CG whose inner operator has its
    fast-layout links rounded to bf16 (rounding commutes with the exact
    +-1/2 scaling, the adjoint and the shift, so these are the kernel's
    links), true residuals on the full-precision operator, inner
    tolerance floor 1e-5."""
    from functools import partial

    from qex_tpu.physics import stag_fast as jsf
    u, b, _, _, _ = problem
    jlat = JLattice(DIMS)
    r2req = 1e-14
    be = np.asarray(jeo.pack(jnp.asarray(b), 4)[0])

    def bf16(g):
        return (g.real.astype(jnp.bfloat16).astype(g.real.dtype)
                + 1j * g.imag.astype(jnp.bfloat16).astype(g.real.dtype))

    def ref(u, be):
        fs = jsf.new_fast(jst.new_stag_eo(jlat, u))
        fsb = jsf.FastStagEO(jlat, bf16(fs.g_e), bf16(fs.g_o))
        xf, stats = jcg.cg_solve_restarted(
            partial(jsf.d2ee_fast, fsb, m=M), jsf.to_fast(be, jlat),
            r2req=r2req, maxits=1000, restarts=5,
            op_true=partial(jsf.d2ee_fast, fs, m=M),
            inner_r2req_floor=1e-5)
        return jsf.from_fast(xf, jlat), stats.iterations

    x_ref, its_ref = compile_ref(ref, u, be)(u, be)
    s = st.new_stag_eo(Lattice(DIMS), t(u))
    x, stats = stag_solve.solve_ee(
        s, t(be), M, SolverParams(r2req=r2req, maxits=1000, restarts=5,
                                  sloppy=True))
    assert stats.iterations == int(its_ref)
    assert rel(n(x), np.asarray(x_ref)) < 1e-9
    true = rel(n(st.d2ee(s, x, M)), be) ** 2
    assert true <= 10 * r2req
    assert stats.r2 <= r2req
