"""The Wilson multigrid of qex_tpu_torch against qex_tpu, complex128.

GCR (with and without a preconditioner) and BiCGStab on a dense
non-hermitian operator: the same iteration counts, solutions to 1e-10.
At 4^4 (Wilson m=0.1, bc pppp, expm(0.4 tah) links): the chiral
adaptive setup with the JAX start vectors injected, restrict, prolong,
the block orthonormalization and the Galerkin coarse operator to 1e-10;
the two-level hierarchy with its assembled stencils; the K-cycle solve
on the hierarchy carried across by convert.mg_hierarchy_from_reference
and on the port's own; the two-grid solve; and the backend="mg"
dispatch of wilson.solve and solve_eo.  Probe assembly and the stencil
apply on a random stencil over extents 4, 6, 2 and 1 (every spacing
case).  The JAX references compile once, in one program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, ginibre, n, random_links, rel,
                            single_threaded, t)
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.mg import coarse as jcoarse
from qex_tpu.mg import kcycle as jkc
from qex_tpu.mg import twogrid as jtg
from qex_tpu.physics import wilson as jwl
from qex_tpu.solvers import base as jbase
from qex_tpu.solvers import bicgstab as jbicg
from qex_tpu.solvers import gcr as jgcr
from qex_tpu_torch import convert
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.mg import coarse, kcycle
from qex_tpu_torch.mg import twogrid as tg
from qex_tpu_torch.physics import wilson as wl
from qex_tpu_torch.solvers import bicgstab, gcr
from qex_tpu_torch.solvers.base import MGParams, SolverParams

pytestmark = pytest.mark.usefixtures("single_threaded")

TOL = 1e-10
DIMS = (4, 4, 4, 4)
M = 0.1
DT = jnp.complex128
SETUP = dict(nvec=3, bs=2, relax_iters=5)
# the backend="mg" route with these parameters and maxits 300 (30 GCR
# restarts) is the K-cycle solve on the hierarchy of mg_refs
MGP = dict(nlevels=2, nvec=3, relax_iters=5, m=10)


def _jax_draws(seed, shape, dtype):
    """mg_setup's start vectors, as qex_tpu.mg.twogrid draws them."""
    key = jax.random.PRNGKey(seed)
    rdtype = jnp.finfo(dtype).dtype
    return (jax.random.normal(key, shape, rdtype)
            + 1j * jax.random.normal(jax.random.fold_in(key, 1), shape,
                                     rdtype)).astype(dtype)


# (seed, shape) of every start-vector draw the tests below make: the
# fine level (nvec=3, ns=4) and the second level of the hierarchy
# (3 vectors on the 2^4 coarse grid with 6 chirality-split colors)
DRAWS = ((0, (3, 4, 3) + DIMS), (1, (3, 1, 6, 2, 2, 2, 2)))


@pytest.fixture
def jax_draws(mg_refs, monkeypatch):
    """The port's setup draws replaced by the JAX ones for its seed."""
    draws = mg_refs[4]["draws"]
    monkeypatch.setattr(tg, "_start_vectors", lambda gen, shape, dtype: t(
        draws[DRAWS.index((gen.initial_seed(), tuple(shape)))]).to(dtype))


def test_gcr_and_bicgstab_match_reference():
    rng = np.random.default_rng(51)
    nn = 48
    a = 3.0 * np.eye(nn) + 1.5 / np.sqrt(nn) * ginibre(rng, (nn, nn))
    d = 1.0 / np.diag(a)
    b = ginibre(rng, (nn,))
    kw = dict(r2req=1e-20, m=6, max_restarts=40)

    def ref(a, d, b):
        op = lambda v: a @ v
        return (jgcr.gcr_solve(op, b, **kw),
                jgcr.gcr_solve(op, b, precon=lambda v: d * v, **kw),
                jbicg.bicgstab_solve(op, b, r2req=1e-20, maxits=300))

    refs = compile_ref(ref, a, d, b)(a, d, b)
    ta, td, tb = t(a), t(d), t(b)
    op = lambda v: ta @ v
    gots = (gcr.gcr_solve(op, tb, **kw),
            gcr.gcr_solve(op, tb, precon=lambda v: td * v, **kw),
            bicgstab.bicgstab_solve(op, tb, r2req=1e-20, maxits=300))
    for (x, st), (xr, sr) in zip(gots, refs):
        assert st.iterations == int(sr.iterations)
        assert rel(n(x), xr) < TOL
        assert st.r2 <= 1e-20
    assert gots[1][1].iterations < gots[0][1].iterations


def test_stencil_assembly_and_apply_match_reference():
    """A random 9-point stencil over extents (4, 6, 2, 1) probed back
    exactly: spacing 4, spacing 3, the merged extent-2 hop and the
    extent-1 hops folded into the diagonal."""
    rng = np.random.default_rng(53)
    dims, nc = (4, 6, 2, 1), 2
    mats = [ginibre(rng, (nc, nc) + dims) for _ in range(9)]
    c = ginibre(rng, (nc,) + dims)
    axes = (0, 1, 2, 3)

    def ref(mats, c):
        st = jcoarse.CoarseStencil(mats[0], tuple(
            (mats[1 + 2 * i], mats[2 + 2 * i]) for i in range(4)), axes)
        op = lambda v: jcoarse.apply_stencil(st, v)
        ast = jcoarse.assemble_stencil(op, nc, dims, DT, batch=4)
        return op(c), ast, jcoarse.apply_stencil(ast, c)

    y, ast, y2 = compile_ref(ref, mats, c)(mats, c)
    st = coarse.CoarseStencil(t(mats[0]), tuple(
        (t(mats[1 + 2 * i]), t(mats[2 + 2 * i])) for i in range(4)), axes)
    op = lambda v: coarse.apply_stencil(st, v)
    assert rel(n(op(t(c))), y) < 1e-13
    got = coarse.assemble_stencil(op, nc, dims, torch.complex128, "cpu")
    assert got.axes == tuple(ast.axes) == (0, 1, 2)
    assert rel(n(got.diag), ast.diag) < 1e-13
    for (p, m), (pr, mr) in zip(got.hops, ast.hops):
        assert rel(n(p), pr) < 1e-13
        assert (m is None) == (mr is None)
        if m is not None:
            assert rel(n(m), mr) < 1e-13
    assert got.hops[2][1] is None           # extent 2: merged
    assert rel(n(coarse.apply_stencil(got, t(c))), y2) < 1e-13
    assert rel(n(coarse.apply_stencil(got, t(c))), y) < 1e-13


@pytest.fixture(scope="module")
def mg_refs():
    rng = np.random.default_rng(57)
    jlat = JLattice(DIMS)
    u = random_links(rng, jlat, 0.4)
    b = ginibre(rng, (4, 3) + DIMS)
    c = ginibre(rng, (6, 2, 2, 2, 2))
    blk = ginibre(rng, (3, 4, 3, 2, 2, 2, 2, 2, 2, 2, 2))

    def ref(u, b, c, blk):
        w = jwl.new_wilson(jlat, u, M, bc="pppp")
        op = lambda v: jwl.wilson_d(w, v)
        s = jtg.mg_setup(jlat, op, dtype=DT, chiral=True, **SETUP)
        h = jkc.mg_hierarchy(jlat, op, nlevels=2, chiral=True, dtype=DT,
                             **SETUP)
        xk, sk, _ = jkc.mg_solve_kcycle(jlat, op, b, hierarchy=h,
                                        r2req=1e-14, m=10, max_restarts=30)
        s2 = jtg.mg_setup(jlat, op, dtype=DT, **SETUP)
        x2, st2 = jgcr.gcr_solve(op, b, precon=jtg.mg_preconditioner(s2, op),
                                 r2req=1e-14, m=10, max_restarts=30)
        return dict(
            draws=[_jax_draws(seed, shape, DT) for seed, shape in DRAWS],
            w=s.w, restrict=jtg.restrict(s, b), prolong=jtg.prolong(s, c),
            coarse_op=jtg.coarse_op(s, op)(c),
            ortho=jtg._block_orthonormalize(blk), hierarchy=h,
            kcycle=(xk, sk.iterations), twogrid=(x2, st2.iterations))

    return u, b, c, blk, compile_ref(ref, u, b, c, blk)(u, b, c, blk)


def _wilson_op(u):
    w = wl.new_wilson(Lattice(DIMS), t(u), M, bc="pppp")
    return w, (lambda v: wl.wilson_d(w, v))


def test_setup_and_transfers_match_reference(mg_refs, jax_draws):
    u, b, c, blk, r = mg_refs
    _, op = _wilson_op(u)
    s = tg.mg_setup(Lattice(DIMS), op, dtype=torch.complex128, chiral=True,
                    device="cpu", **SETUP)
    assert s.nvec == 6
    assert rel(n(s.w), r["w"]) < TOL
    # the rest on the reference prolongator, so each step is held alone
    s = tg.MGSetup(Lattice(DIMS), 2, t(r["w"]))
    assert rel(n(tg.restrict(s, t(b))), r["restrict"]) < TOL
    assert rel(n(tg.prolong(s, t(c))), r["prolong"]) < TOL
    assert rel(n(tg.coarse_op(s, op)(t(c))), r["coarse_op"]) < TOL
    assert rel(n(tg._block_orthonormalize(t(blk))), r["ortho"]) < TOL


def test_hierarchy_matches_reference(mg_refs, jax_draws):
    u, _, _, _, r = mg_refs
    _, op = _wilson_op(u)
    h = kcycle.mg_hierarchy(Lattice(DIMS), op, nlevels=2, chiral=True,
                            dtype=torch.complex128, device="cpu", **SETUP)
    ref = convert.mg_hierarchy_from_reference(r["hierarchy"], "cpu",
                                              torch.complex128)
    assert h.lats == ref.lats and len(h.setups) == 2
    for s, sr in zip(h.setups, ref.setups):
        assert s.bs == sr.bs and s.lat == sr.lat
        assert rel(n(s.w), n(sr.w)) < TOL
    for st, sr in zip(h.stencils, ref.stencils):
        assert st.axes == sr.axes
        assert rel(n(st.diag), n(sr.diag)) < TOL
        for (p, m), (pr, mr) in zip(st.hops, sr.hops):
            assert rel(n(p), n(pr)) < TOL
            assert (m is None) == (mr is None)


def test_kcycle_solve_on_reference_hierarchy(mg_refs):
    u, b, _, _, r = mg_refs
    _, op = _wilson_op(u)
    h = convert.mg_hierarchy_from_reference(r["hierarchy"], "cpu",
                                            torch.complex128)
    x, stats, h_out = kcycle.mg_solve_kcycle(Lattice(DIMS), op, t(b),
                                             hierarchy=h, r2req=1e-14, m=10,
                                             max_restarts=30)
    xr, its = r["kcycle"]
    assert h_out is h
    assert stats.iterations == int(its)
    assert rel(n(x), xr) < TOL
    assert rel(n(op(x)), b) ** 2 < 1e-13


def test_twogrid_solve_matches_reference(mg_refs, jax_draws):
    u, b, _, _, r = mg_refs
    _, op = _wilson_op(u)
    setup = tg.mg_setup(Lattice(DIMS), op, dtype=torch.complex128,
                        device="cpu", **SETUP)
    x, stats, s_out = tg.mg_solve(Lattice(DIMS), op, t(b), r2req=1e-14,
                                  m=10, max_restarts=30, setup=setup)
    assert s_out is setup
    xr, its = r["twogrid"]
    assert stats.iterations == int(its)
    assert rel(n(x), xr) < TOL


@pytest.mark.parametrize("entry", ["solve", "solve_eo"])
def test_backend_mg_dispatch(mg_refs, jax_draws, entry):
    """SolverParams(backend="mg") reaches the K-cycle from both Wilson
    solve entry points, with the reference's iterations and solution:
    the JAX solve and solve_eo dispatch to solve_mg, which with these
    parameters is mg_solve_kcycle on the hierarchy of mg_refs."""
    u, b, _, _, r = mg_refs
    lat = Lattice(DIMS)
    params = SolverParams(r2req=1e-14, maxits=300, backend="mg",
                          mg=MGParams(**MGP))
    w = (wl.new_wilson(lat, t(u), M, bc="pppp") if entry == "solve"
         else wl.new_wilson_eo(lat, t(u), M, bc="pppp"))
    x, stats = getattr(wl, entry)(w, t(b), params)
    xr, its = r["kcycle"]
    assert stats.iterations == int(its)
    assert rel(n(x), xr) < TOL
    assert stats.r2 <= 1e-14


def test_solver_params_from_reference():
    jp = jbase.SolverParams(r2req=1e-9, maxits=77, backend="mg",
                            mg=jbase.MGParams(nlevels=1, nvec=5, k_m=3,
                                              assemble=False))
    sp = convert._solver_params(jp)
    assert sp.backend == "mg" and sp.r2req == 1e-9 and sp.maxits == 77
    assert sp.mg == MGParams(nlevels=1, nvec=5, k_m=3, assemble=False)
    assert convert._solver_params(jbase.SolverParams()).mg is None
