"""The rooted-staggered slice of qex_tpu_torch against qex_tpu
(complex128): the AAA rational coefficients to 1e-14 relative (the same
scipy call on the same inputs); cg_solve from x0, cg_solve_precon,
cg_multishift_refined and RationalApprox.apply on a dense hermitian
operator; at 4^4 stag_solve.solve_multi on its three routes (the plain
multishift, the refinement below the precision's floor, and the sloppy
route, held against the JAX refinement on bf16-rounded fast-layout
links, which the JAX package runs only on the TPU) and solve_batched,
all to 1e-10 relative with the same iteration counts (the refinement
below the floor within 5%); and the rooted
fermion's heatbath (injected noise), action, force and exact
force-gradient kick to 1e-9, the kick also against a central difference
of the port's force to 1e-7.  Every JAX result comes from one compiled
program."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_refs, ginibre, n, random_links, rel,
                            single_threaded, t)
from qex_tpu.hmc import hmc as jhmc
from qex_tpu.hmc import integrators as jint
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.ops import eo as jeo
from qex_tpu.physics import stag_fast as jsf
from qex_tpu.physics import stag_hmc as jsh
from qex_tpu.physics import stag_solve as jsolve
from qex_tpu.physics import staggered as jst
from qex_tpu.solvers import cg as jcg
from qex_tpu.solvers import cgm as jcgm
from qex_tpu.solvers import rational as jrational
from qex_tpu.solvers.base import SolverParams as JSolverParams
from qex_tpu_torch.gauge.action import force_from_action
from qex_tpu_torch.hmc import hmc, integrators
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import eo
from qex_tpu_torch.physics import stag_hmc, stag_solve
from qex_tpu_torch.physics import staggered as st
from qex_tpu_torch.solvers import cg, cgm, rational
from qex_tpu_torch.solvers.base import SolverParams

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (4, 4, 4, 4)
NDENSE = 32
SHIFTS = [0.01, 0.2, 0.04]
LIGHT = (0.1, 0.3)          # m^2 below the sloppy multishift criterion
HEAVY = (0.4, 1.0)     # every m^2 above it (from exp_msloppy.py:32)
R2 = {"plain": 1e-20, "refined": 1e-24, "sloppy": 1e-14}
# the rooted fermion; a degree-2 approximation keeps the JAX reference's
# compile short (the code paths do not depend on the degree)
M, NF, DEGREE = 0.2, 2, 2
R2_ROOTED = 1e-28
FG_A = 0.01
RATIONAL = [(2, 8, 0.04, 16.04, 10), (-2, 4, 0.04, 16.04, 10),
            (-1, 2, 1e-3, 1.0, 14)]


def _bf16(g):
    return (g.real.astype(jnp.bfloat16).astype(g.real.dtype)
            + 1j * g.imag.astype(jnp.bfloat16).astype(g.real.dtype))


def _jrooted(jlat):
    return jsh.StagRootedFermion(
        jlat, M, nf=NF, degree=DEGREE,
        params=JSolverParams(r2req=R2_ROOTED, maxits=1000, restarts=1))


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(81)
    q, _ = np.linalg.qr(ginibre(rng, (NDENSE, NDENSE)))
    a = (q * np.linspace(0.05, 3.0, NDENSE)) @ q.conj().T
    dense = dict(a=a, a_sloppy=a.astype(np.complex64).astype(np.complex128),
                 b=ginibre(rng, (NDENSE,)), x0=ginibre(rng, (NDENSE,)))
    jlat = JLattice(DIMS)
    u = random_links(rng, jlat, 0.5)
    b = ginibre(rng, (3,) + DIMS)
    bs = ginibre(rng, (3, 3) + DIMS)
    be = np.asarray(jeo.pack(jnp.asarray(b), 4)[0])
    key = jax.random.PRNGKey(5)
    phi = ginibre(rng, be.shape)

    ra = jrational.rational_approx(-1, 2, 0.04, 3.1, 12)

    def dense_program(d):
        out = {}
        a, b = d["a"], d["b"]
        op = partial(jnp.matmul, a)
        out["cg_x0"] = jcg.cg_solve(op, b, d["x0"], r2req=1e-24, maxits=500)
        out["cg_precon"] = jcg.cg_solve_precon(
            op, b, lambda v: v / jnp.diag(a), r2req=1e-24, maxits=500)
        out["refined"] = jcgm.cg_multishift_refined(
            partial(jnp.matmul, d["a_sloppy"]), op, b, SHIFTS, r2req=1e-24,
            maxits=500, sloppy_r2req=1e-12)
        out["apply"] = ra.apply(op, b, r2req=1e-26, maxits=500)
        return out

    def solve_program(u, be, bs):
        out = {}
        s = jst.new_stag_eo(jlat, u)
        for route in ("plain", "refined"):
            out[f"multi_{route}"] = jsolve.solve_multi(
                s, be, list(LIGHT), JSolverParams(r2req=R2[route],
                                                  maxits=1000, restarts=3))
        fs = jsf.new_fast(s)
        fsb = jsf.FastStagEO(jlat, _bf16(fs.g_e), _bf16(fs.g_o))
        xs, stats = jcgm.cg_multishift_refined(
            partial(jsf.d2dd_fast, fsb, parity=0),
            partial(jsf.d2dd_fast, fs, parity=0), jsf.to_fast(be, jlat),
            [m * m for m in HEAVY], r2req=R2["sloppy"], maxits=1000,
            sloppy_r2req=1e-5)
        out["multi_sloppy"] = ([jsf.from_fast(x, jlat) for x in xs], stats)
        out["batched"] = jsolve.solve_batched(
            s, bs, 0.1, JSolverParams(r2req=1e-20, maxits=1000, restarts=3))
        return out

    def rooted_program(u, key, phi, a_fg):
        out = {}
        ferm = _jrooted(jlat)
        s_act = ferm.make_action_fn()

        def force(w):
            return jsh.fermion_force(s_act, w, phi)

        out["xi"] = jsh.gaussian_eta(key, jlat, u.dtype)
        out["heatbath"] = ferm.heatbath(key, u)
        out["action"] = s_act(u, phi)
        out["fg"] = jint.fg_force(u, a_fg, force, jhmc.gauge_update_u)
        return out

    # the three programs compiled at once
    dense_c, solve_c, rooted_c = compile_refs(
        (dense_program, dense), (solve_program, u, be, bs),
        (rooted_program, u, key, phi, FG_A))
    out = jax.tree_util.tree_map(np.asarray, {
        **dense_c(dense), **solve_c(u, be, bs),
        **rooted_c(u, key, phi, FG_A)})
    # fg_force at a = 0 is the force itself
    out["force"] = np.asarray(rooted_c(u, key, phi, 0.0)["fg"])
    return dict(dense=dense, u=u, b=b, bs=bs, be=be, phi=phi, out=out)


def _its(stats):
    return int(stats.iterations)


# --- rational approximations --------------------------------------------------

@pytest.mark.parametrize("case", RATIONAL)
def test_rational_coefficients_match_reference(case):
    got, ref = rational.rational_approx(*case), \
        jrational.rational_approx(*case)
    assert got.degree == ref.degree and got.power_num == ref.power_num
    for k in ("c0", "max_rel_err"):
        assert getattr(got, k) == pytest.approx(getattr(ref, k), rel=1e-14)
    np.testing.assert_allclose(got.residues, ref.residues, rtol=1e-14)
    np.testing.assert_allclose(got.poles, ref.poles, rtol=1e-14)
    assert all(p > 0 for p in got.poles)
    x = np.logspace(np.log10(case[2]), np.log10(case[3]), 101)
    assert np.abs(got(x) / x ** (case[0] / case[1]) - 1).max() \
        <= 1.5 * got.max_rel_err


def test_rational_apply(refs):
    d = refs["dense"]
    ra = rational.rational_approx(-1, 2, 0.04, 3.1, 12)
    x, stats = ra.apply(partial(torch.matmul, t(d["a"])), t(d["b"]),
                        r2req=1e-26, maxits=500)
    xr, sr = refs["out"]["apply"]
    assert rel(n(x), xr) < 1e-10
    assert stats.iterations == _its(sr)


# --- CG from x0, preconditioned CG, refined multishift -------------------------

def test_cg_solve_from_x0(refs):
    d = refs["dense"]
    x, stats = cg.cg_solve(partial(torch.matmul, t(d["a"])), t(d["b"]),
                           t(d["x0"]), r2req=1e-24, maxits=500)
    xr, sr = refs["out"]["cg_x0"]
    assert rel(n(x), xr) < 1e-10
    assert stats.iterations == _its(sr) > 0
    assert stats.r2 == pytest.approx(float(sr.r2), rel=1e-6)


def test_cg_solve_precon(refs):
    d = refs["dense"]
    a = t(d["a"])
    x, stats = cg.cg_solve_precon(partial(torch.matmul, a), t(d["b"]),
                                  lambda v: v / torch.diagonal(a),
                                  r2req=1e-24, maxits=500)
    xr, sr = refs["out"]["cg_precon"]
    assert rel(n(x), xr) < 1e-10
    assert stats.iterations == _its(sr) > 0


def test_cg_multishift_refined(refs):
    """A sloppy operator (the matrix rounded to complex64) for the joint
    pass, the true one for the refinement and the closure."""
    d = refs["dense"]
    xs, stats = cgm.cg_multishift_refined(
        partial(torch.matmul, t(d["a_sloppy"])),
        partial(torch.matmul, t(d["a"])), t(d["b"]), SHIFTS, r2req=1e-24,
        maxits=500, sloppy_r2req=1e-12)
    xr, sr = refs["out"]["refined"]
    assert stats.iterations == _its(sr)
    for x, ref in zip(xs, xr):
        assert rel(n(x), ref) < 1e-10
    assert stats.r2 <= 1e-24 and float(sr.r2) <= 1e-24


# --- solve_multi, solve_batched -----------------------------------------------

@pytest.mark.parametrize("route", ["plain", "refined", "sloppy"])
def test_solve_multi(refs, route):
    s = st.new_stag_eo(Lattice(DIMS), t(refs["u"]))
    masses = HEAVY if route == "sloppy" else LIGHT
    xs, stats = stag_solve.solve_multi(
        s, t(refs["be"]), masses,
        SolverParams(r2req=R2[route], maxits=1000, restarts=3,
                     sloppy=route == "sloppy"))
    xr, sr = refs["out"][f"multi_{route}"]
    if route == "refined":
        # each shift's refinement starts from a defect at the rounding
        # floor (1e-11 relative), where the two packages round
        # differently, so its inner iterations may differ
        assert abs(stats.iterations - _its(sr)) <= 0.05 * _its(sr)
    else:
        assert stats.iterations == _its(sr)
    for x, ref, m in zip(xs, xr, masses):
        assert rel(n(x), ref) < 1e-10
        true = rel(n(st.d2ee(s, x, m)), refs["be"]) ** 2
        assert true <= 100 * R2[route], (m, true)


def test_solve_multi_takes_the_jax_routes(monkeypatch):
    """Light masses with sloppy take the plain route; r2req below the
    complex128 floor with restarts the refinement; heavy masses with
    sloppy the bf16 route, whose sloppy operator is not the true one."""
    calls = []
    real = cgm.cg_multishift_refined

    def spy(base_sloppy, base_true, *a, **kw):
        calls.append((base_sloppy is base_true, kw["sloppy_r2req"]))
        return real(base_sloppy, base_true, *a, **kw)

    monkeypatch.setattr(cgm, "cg_multishift_refined", spy)
    lat = Lattice(DIMS)
    gen = torch.Generator().manual_seed(3)
    from qex_tpu_torch.ops import group
    u = torch.stack([group.random_su(gen, DIMS, 3, torch.complex128)
                     for _ in range(4)])
    s = st.new_stag_eo(lat, u)
    be = eo.pack(torch.randn((3,) + DIMS, dtype=torch.complex128,
                             generator=gen), 4)[0]
    for masses, r2req, sloppy, want in (
            (LIGHT, 1e-12, True, []), (LIGHT, 1e-24, False, [(True, 1e-22)]),
            (HEAVY, 1e-12, True, [(False, 1e-5)])):
        calls.clear()
        stag_solve.solve_multi(s, be, masses, SolverParams(
            r2req=r2req, maxits=2000, sloppy=sloppy))
        assert calls == want, (masses, r2req, sloppy)


def test_solve_batched(refs):
    s = st.new_stag_eo(Lattice(DIMS), t(refs["u"]))
    params = SolverParams(r2req=1e-20, maxits=1000, restarts=3, sloppy=True)
    xs, stats = stag_solve.solve_batched(s, t(refs["bs"]), 0.1, params)
    xr, sr = refs["out"]["batched"]
    assert xs.shape == refs["bs"].shape and len(stats) == 3
    assert rel(n(xs), xr) < 1e-10
    for st_, its in zip(stats, sr.iterations):     # as test_torch_solve
        assert abs(st_.iterations - int(its)) <= 2
    for b, x in zip(refs["bs"], xs):      # each equals its own solve
        x1, _ = stag_solve.solve(s, t(b), 0.1,
                                 SolverParams(r2req=1e-20, maxits=1000))
        assert torch.equal(x, x1)


# --- the rooted fermion ---------------------------------------------------------

def _rooted():
    return stag_hmc.StagRootedFermion(
        Lattice(DIMS), M, nf=NF, degree=DEGREE,
        params=SolverParams(r2req=R2_ROOTED, maxits=1000, restarts=1))


def test_rooted_heatbath_action_force(refs):
    out, ferm = refs["out"], _rooted()
    u, phi = t(refs["u"]), t(refs["phi"])
    assert rel(n(ferm.heatbath_from_noise(t(out["xi"]), u)),
               out["heatbath"]) < 1e-9
    s_act = ferm.make_action_fn()
    s = s_act(u, phi)
    assert s.dtype == torch.float64
    assert abs(float(s) - float(out["action"])) < 1e-9 * abs(float(s))
    frc = force_from_action(lambda w: s_act(w, phi), u)
    assert rel(n(frc), out["force"]) < 1e-9
    its, res = ferm.check_solve(u, phi)
    assert its > 0 and res < 1e-26


def test_rooted_force_gradient_kick(refs):
    """The exact kick F - a dF[F U] by a Hessian-vector product through
    the rooted backward (each x_i recorded with its own shifted solve)
    against JAX's fg_force, and dF[F U] against a central difference of
    the port's force along the force flow."""
    ferm = _rooted()
    s_act = ferm.make_action_fn()
    u, phi = t(refs["u"]), t(refs["phi"])

    def frc(w):
        return force_from_action(lambda ww: s_act(ww, phi), w)

    fg = integrators.fg_force(u, FG_A, frc, hmc.gauge_update_u,
                              action_fn=lambda w: s_act(w, phi))
    assert rel(n(fg), refs["out"]["fg"]) < 1e-9
    f = frc(u)

    def central(eps):
        return (frc(hmc.gauge_update_u(u, f, eps))
                - frc(hmc.gauge_update_u(u, f, -eps))) / (2 * eps)

    # the rooted force bends sharply along the flow (|dF| ~ 40 |F|), so
    # the O(eps^2) term of one central difference (1e-5 relative at
    # eps = 1e-4) is removed by Richardson's step
    cd1, cd2 = central(1e-4), central(2e-4)
    assert rel(n((f - fg) / FG_A), n(cd1 + (cd1 - cd2) / 3)) < 1e-7


def test_calibrate_spectral_range_names_its_item(refs):
    """The calibration (ROADMAP A9, ported in the eigensolver tier and
    held against JAX's in tests/test_torch_eigens.py) returns a copy
    whose rational approximations cover the measured bracket of A(m)."""
    ferm = _rooted()
    cal = ferm.calibrate_spectral_range(t(refs["u"]))
    lo, hi = cal.spectral_bounds
    assert ferm.spectral_bounds is None and cal.m == ferm.m
    assert M * M / 2 <= lo < hi < 1.2 * (M * M + 16.0)
    ra = cal._approx(-NF, 4)
    assert (ra.lo, ra.hi) == (lo, hi)
