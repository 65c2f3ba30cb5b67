"""The HISQ slice of qex_tpu_torch against qex_tpu: fast-layout shifts at
distance 3 exactly (4^4, where Th = 2, and 8x4x4x8); the fat + naik eo
and fast-layout operators to 1e-12 relative (complex128); the 16-term
pre-shifted links exactly (float32 and bfloat16) and their plain hop
against the JAX Pallas kernel in interpret mode at 8x4x4x4 (float32
arithmetic, hence squared deviation 1e-12); cg_multishift and
HisqFermion.solve_multi (same iterations, solutions to 1e-10); the HISQ
fermion's and the HISQ Hasenbusch ratio's heatbath, action and force
(1e-9) with injected noise; the sloppy solve on bf16-rounded links; and one LatticeFieldTheory
trajectory with a "hisq" term and injected draws (fields 1e-9, dH
1e-8).  The CUDA kernels are checked against the plain hop on a card by
tests/test_torch_kernels_gpu.py."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, compile_refs, ginibre, n,
                            random_links, rel, rel2, single_threaded, t)
from qex_tpu.gauge import action as jga
from qex_tpu.hmc import hmc as jhmc
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.mcmc import md as jmd
from qex_tpu.mcmc.theory import FermionSpec as JFermionSpec
from qex_tpu.mcmc.theory import GaugeActionSpec as JGaugeActionSpec
from qex_tpu.mcmc.theory import LatticeFieldTheory as JTheory
from qex_tpu.ops import eo as jeo
from qex_tpu.ops import group as jgroup
from qex_tpu.physics import stag_fast as jsf
from qex_tpu.physics import stag_hmc as jsh
from qex_tpu.physics import stag_pallas_hisq as jsph
from qex_tpu.physics import staggered as jst
from qex_tpu.solvers import cg as jcg
from qex_tpu.solvers import cgm as jcgm
from qex_tpu.solvers.base import SolverParams as JSolverParams
from qex_tpu_torch import convert
from qex_tpu_torch.gauge.action import force_from_action
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import eo
from qex_tpu_torch.physics import stag_fast as sf
from qex_tpu_torch.physics import stag_hisq as sh
from qex_tpu_torch.physics import stag_hmc
from qex_tpu_torch.physics import staggered as st
from qex_tpu_torch.solvers import cgm
from qex_tpu_torch.solvers.base import SolverParams

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS4 = (4, 4, 4, 4)
DIMS8 = (8, 4, 4, 8)
TOL = 1e-12
HMASS = 0.8                 # the HISQ Hasenbusch ratio's heavy mass


def _fast_shape(dims):
    return (3, dims[3] // 2, dims[2], dims[1] * dims[0])


# --- shifts ------------------------------------------------------------------

@pytest.mark.parametrize("dims", [DIMS4, DIMS8])
def test_shift_fast_exact(dims):
    """Every direction, sign, output parity and distance 1 and 3."""
    jlat, lat = JLattice(dims), Lattice(dims)
    f = ginibre(np.random.default_rng(3), _fast_shape(dims))
    cases = [(mu, sign, par, dist) for mu in range(4) for sign in (1, -1)
             for par in (0, 1) for dist in (1, 3)]
    refs = compile_ref(lambda f: [jsf.shift_fast(f, *c[:3], jlat, c[3])
                                  for c in cases], f)(f)
    for c, ref in zip(cases, refs):
        got = sf.shift_fast(t(f), *c[:3], lat, c[3])
        assert np.array_equal(n(got), np.asarray(ref)), c


# --- the fat + naik operator -------------------------------------------------

@pytest.fixture(scope="module")
def ops3():
    """Random fat and long links and vectors at 8x4x4x8, and every JAX
    operator result in one compiled program."""
    rng = np.random.default_rng(43)
    jlat = JLattice(DIMS8)
    fl = random_links(rng, jlat)
    ll = 0.3 * random_links(rng, jlat)
    x = ginibre(rng, (3,) + DIMS8)

    def ref(fl, ll, x):
        s3 = jst.new_stag3_eo(jlat, fl, ll)
        xe, xo = jeo.pack(x, 4)
        f3 = jsf.new_fast3(s3)
        xf = jsf.to_fast(xe, jlat)
        return ([jst.dslash3_eo(s3, xo, 0), jst.dslash3_eo(s3, xe, 1)],
                jst.d2ee3(s3, xe, 0.3), jst.d2dd3(s3, xe, 0),
                jst.dslash3_full(jlat, fl, ll, x), xf,
                [jsf.dslash3_fast(f3, xf, par) for par in (0, 1)],
                jsf.d2ee3_fast(f3, xf, 0.3), jsf.d2dd3_fast(f3, xf, 0))

    outs = compile_ref(ref, fl, ll, x)(fl, ll, x)
    s3 = st.new_stag3_eo(Lattice(DIMS8), t(fl), t(ll))
    return dict(fl=fl, ll=ll, x=x, s3=s3, outs=outs)


@pytest.mark.parametrize("parity", [0, 1])
def test_dslash3_eo(ops3, parity):
    xe, xo = eo.pack(t(ops3["x"]), 4)
    got = st.dslash3_eo(ops3["s3"], xo if parity == 0 else xe, parity)
    assert rel(n(got), ops3["outs"][0][parity]) < TOL


def test_d2ee3_d2dd3(ops3):
    xe, _ = eo.pack(t(ops3["x"]), 4)
    assert rel(n(st.d2ee3(ops3["s3"], xe, 0.3)), ops3["outs"][1]) < TOL
    assert rel(n(st.d2dd3(ops3["s3"], xe, 0)), ops3["outs"][2]) < TOL


def test_dslash3_full_oracle(ops3):
    """The full-lattice oracle against JAX, and the eo operator against
    the packed oracle."""
    lat = Lattice(DIMS8)
    full = st.dslash3_full(lat, t(ops3["fl"]), t(ops3["ll"]), t(ops3["x"]))
    assert rel(n(full), ops3["outs"][3]) < TOL
    de, do = eo.pack(full, 4)
    xe, xo = eo.pack(t(ops3["x"]), 4)
    assert rel(n(st.dslash3_eo(ops3["s3"], xo, 0)), n(de)) < TOL
    assert rel(n(st.dslash3_eo(ops3["s3"], xe, 1)), n(do)) < TOL


@pytest.mark.parametrize("parity", [0, 1])
def test_fast3_operator(ops3, parity):
    f3 = sf.new_fast3(ops3["s3"])
    xf = ops3["outs"][4]
    assert rel(n(sf.dslash3_fast(f3, t(xf), parity)),
               ops3["outs"][5][parity]) < TOL
    assert rel(n(sf.d2ee3_fast(f3, t(xf), 0.3)), ops3["outs"][6]) < TOL
    assert rel(n(sf.d2dd3_fast(f3, t(xf), 0)), ops3["outs"][7]) < TOL


# --- the 16-term hop against the JAX Pallas kernel ---------------------------

DIMS_K = (8, 4, 4, 4)


@pytest.fixture(scope="module")
def hop16():
    """complex64 links and spinor; the JAX 16-term links (float32 and
    bfloat16) and kernel in interpret mode, both parities, one jit.  One
    geometry holds both wrap cases of the naik hops: Th = 2 (a 3-hop in
    t returns to th or th+-1) and extents of 4 in y and z (a 3-hop wraps
    past the start), with X != Y."""
    dims = DIMS_K
    rng = np.random.default_rng(47)
    jlat = JLattice(dims)
    fl = random_links(rng, jlat).astype(np.complex64)
    ll = (0.3 * random_links(rng, jlat)).astype(np.complex64)
    x = ginibre(rng, _fast_shape(dims)).astype(np.complex64)

    def ref(fl, ll, x):
        f3 = jsf.new_fast3(jst.new_stag3_eo(jlat, fl, ll))
        p3 = jsph.new_pallas_hisq(f3)
        p3b = jsph.new_pallas_hisq(f3, links_dtype=jnp.bfloat16)
        return (p3.l_e, p3.l_o, p3b.l_e, p3b.l_o,
                [jsph.dslash_pallas_hisq_c(p3, x, par, interpret=True)
                 for par in (0, 1)])

    outs = compile_ref(ref, fl, ll, x)(fl, ll, x)
    s3 = st.new_stag3_eo(Lattice(dims), t(fl), t(ll))
    return dict(dims=dims, s3=s3, x=x, outs=outs)


@pytest.mark.parametrize("links", ["f32", "bf16"])
def test_new_hisq16_links_exact(hop16, links):
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[links]
    p16 = sh.new_hisq16(hop16["s3"], links_dtype=dt)
    ref_e, ref_o = hop16["outs"][0:2] if links == "f32" \
        else hop16["outs"][2:4]
    assert p16.l_e.dtype == dt and p16.l_e.is_contiguous()
    assert p16.l_e.shape == (16, 2, 3, 3) + _fast_shape(hop16["dims"])[1:]
    assert np.array_equal(n(p16.l_e.float()),
                          np.asarray(ref_e).astype(np.float32))
    assert np.array_equal(n(p16.l_o.float()),
                          np.asarray(ref_o).astype(np.float32))


@pytest.mark.parametrize("parity", [0, 1])
def test_dslash_hisq16_vs_pallas_interpret(hop16, parity):
    p16 = sh.new_hisq16(hop16["s3"])
    x = t(hop16["x"])
    got = sh.dslash_hisq16(p16, x, parity)
    assert torch.equal(got, sh.dslash_hisq16_plain(p16, x, parity))
    assert got.dtype == torch.complex64
    assert rel2(n(got), hop16["outs"][4][parity]) < TOL


def test_d2ee_d2dd_hisq16(hop16):
    """The fused epilogues against two plain hops, and the operator
    against the fast-layout one up to the float32 links."""
    p16 = sh.new_hisq16(hop16["s3"])
    x = t(hop16["x"])
    hop = partial(sh.dslash_hisq16_plain, p16)
    assert rel2(n(sh.d2ee_hisq16(p16, x, 0.3)),
                n(0.09 * x - hop(hop(x, 1), 0))) < TOL
    assert rel2(n(sh.d2dd_hisq16(p16, x, 1)), n(-hop(hop(x, 0), 1))) < TOL
    f3 = sf.new_fast3(hop16["s3"])
    assert rel(n(sh.d2ee_hisq16(p16, x, 0.3)),
               n(sf.d2ee3_fast(f3, x, 0.3))) < 1e-6


def test_dslash_hisq16_rejects_other_devices(hop16):
    p16 = sh.new_hisq16(hop16["s3"])
    with pytest.raises(ValueError):
        sh.dslash_hisq16(p16, t(hop16["x"]).to("meta"), 0)


# --- multishift CG -----------------------------------------------------------

def test_cg_multishift_matches_reference():
    """Diagonal positive operator, four shifts: the same iterations and
    iterates as the JAX loop (complex128)."""
    rng = np.random.default_rng(11)
    d = 0.01 + rng.random(96)
    b = ginibre(rng, (96,))
    shifts = [0.04, 0.0025, 0.16, 0.01]
    xr, sr = jcgm.cg_multishift(lambda v: jnp.asarray(d) * v, jnp.asarray(b),
                                shifts, r2req=1e-22, maxits=500)
    xs, stats = cgm.cg_multishift(lambda v: t(d) * v, t(b), shifts,
                                  r2req=1e-22, maxits=500)
    assert stats.iterations == int(sr.iterations)
    assert stats.r2 == pytest.approx(float(sr.r2), rel=1e-6)
    for x, ref, s in zip(xs, xr, shifts):
        assert rel(n(x), ref) < 1e-10
        assert rel(n(x), b / (d + s)) < 1e-10


# --- HisqFermion and the "hisq" theory ---------------------------------------

def _hisq_args():
    return dict(
        lat=JLattice(DIMS4),
        gauge=JGaugeActionSpec(jga.wilson(5.0), steps=2, scheme="2MN"),
        fermions=[JFermionSpec("hisq", 0.4, steps=1, scheme="2MN")],
        smear=None, bc="pppa",
        solver_params=JSolverParams(r2req=1e-20, maxits=1000, restarts=3),
        tau=0.2)


@pytest.fixture(scope="module")
def hisq_refs():
    """JAX draws, heatbath, action, forces and one trajectory of the
    "hisq" theory (each JAX call compiled once), and a HisqFermion
    multi-mass solve and sloppy-solve reference."""
    args = _hisq_args()
    jth = JTheory(**args)
    jlat = args["lat"]
    u = jnp.asarray(random_links(np.random.default_rng(53), jlat, 0.5))
    kp, kf = jax.random.split(jax.random.PRNGKey(17))
    dt = jnp.complex128

    def draws(kp, kf):
        p = jax.vmap(lambda k: jgroup.random_tah(k, DIMS4, 3, dt))(
            jax.random.split(kp, 4))
        keys = jax.random.split(kf, len(jth.terms))
        return p, [jsh.gaussian_eta(k, jlat, dt) if term.heatbath else None
                   for term, k in zip(jth.terms, keys)]

    ferm = jsh.HisqFermion(jlat, 0.4, "pppa", params=args["solver_params"])
    masses = (0.1, 0.4)
    b = ginibre(np.random.default_rng(59), (3, 4, 4, 4, 2))

    def multi(u, b):
        xs, stats = ferm.solve_multi(u, b, masses)
        return xs, stats.iterations

    # the HISQ Hasenbusch ratio over the fermion's mass: heatbath from a
    # key (its noise returned for the port), action and force there
    hasen = jsh.HisqHasenbusch(jlat, 0.4, HMASS, "pppa",
                               params=args["solver_params"])

    def ratio_heatbath(kh, u):
        return jsh.gaussian_eta(kh, jlat, dt), hasen.heatbath(kh, u)

    def ratio_action(u, phi):
        return hasen.make_action_fn()(u, phi)

    def ratio_force(u, phi):
        return jsh.fermion_force(hasen.make_action_fn(), u, phi)

    def rest_fn(u, p):
        return jhmc.kinetic_energy(p) + jga.full_action(args["gauge"].coeffs,
                                                        jlat, u)

    kh = jax.random.PRNGKey(23)
    # every program compiled at once, on the shapes of its arguments
    p_s, _ = jax.eval_shape(draws, kp, kf)
    phis_s = jax.eval_shape(jth.heatbath, kf, u)
    (draws_c, heat_c, update, hamiltonian, rest, multi_c, ratio_hb,
     ratio_act, ratio_frc, *forces) = compile_refs(
        (draws, kp, kf), (jth.heatbath, kf, u),
        (jhmc.gauge_update_u, u, p_s, 0.1), (jth.hamiltonian, u, p_s, phis_s),
        (rest_fn, u, p_s), (multi, u, b), (ratio_heatbath, kh, u),
        (ratio_action, u, phis_s[1]), (ratio_force, u, phis_s[1]),
        *[(term.force, u, phi) for term, phi in zip(jth.terms, phis_s)])
    p, xis = draws_c(kp, kf)
    phis = heat_c(kf, u)
    terms = [dataclasses.replace(term, force=f)
             for term, f in zip(jth.terms, forces)]
    h_old = float(hamiltonian(u, p, phis))
    # the HISQ action at (u, phi): H less the kinetic and gauge terms
    act = h_old - float(rest(u, p))
    u1, p1 = jmd.run_trajectory(terms, u, p, phis, jth.tau, update)
    h_new = float(hamiltonian(u1, p1, phis))
    xs, its = multi_c(u, b)
    eta_h, phi_h = ratio_hb(kh, u)
    hasenbusch = (eta_h, phi_h, ratio_act(u, phi_h), ratio_frc(u, phi_h))
    return dict(args=args, u=np.asarray(u), p=np.asarray(p),
                xis=[None if x is None else np.asarray(x) for x in xis],
                phis=[None if f is None else np.asarray(f) for f in phis],
                action=act, force=np.asarray(terms[1].force(u, phis[1])),
                h_old=h_old, u1=np.asarray(u1), p1=np.asarray(p1),
                h_new=h_new, jterms=jth.terms, masses=masses, b=b,
                xs=[np.asarray(x) for x in xs], its=int(its),
                hasenbusch=[np.asarray(x) for x in hasenbusch])


def _fermion(r, **kw):
    return stag_hmc.HisqFermion(
        Lattice(DIMS4), 0.4, "pppa",
        params=convert._solver_params(r["args"]["solver_params"]), **kw)


def test_hisq_heatbath_and_action(hisq_refs):
    r = hisq_refs
    ferm = _fermion(r)
    u = t(r["u"])
    phi = ferm.heatbath_from_noise(t(r["xis"][1]), u)
    assert rel(n(phi), r["phis"][1]) < 1e-9
    s = ferm.action(u, t(r["phis"][1]))
    assert s.dtype == torch.float64
    assert abs(float(s) - r["action"]) < 1e-9 * abs(r["action"])


def test_hisq_force_matches_reference(hisq_refs):
    """Implicit-function force through the two fat7 levels against
    jax.grad through the JAX custom_vjp (stag_hmc.fermion_force)."""
    r = hisq_refs
    ferm = _fermion(r)
    phi = t(r["phis"][1])
    frc = force_from_action(lambda uu: ferm.action(uu, phi), t(r["u"]))
    assert rel(n(frc), r["force"]) < 1e-9


def test_hisq_hasenbusch_matches_reference(hisq_refs):
    """HisqHasenbusch (kernel B2 on the card): heatbath from the JAX
    noise, action and force at the JAX phi against JAX's (1e-9), and
    the solver report of its light-mass solve."""
    r = hisq_refs
    xi, heat, act, frc = r["hasenbusch"]
    term = stag_hmc.HisqHasenbusch(
        Lattice(DIMS4), 0.4, HMASS, "pppa",
        params=convert._solver_params(r["args"]["solver_params"]))
    u = t(r["u"])
    phi = term.heatbath_from_noise(t(xi), u)
    assert rel(n(phi), heat) < 1e-9
    s_act = term.make_action_fn()
    s = s_act(u, t(heat))
    assert s.dtype == torch.float64
    assert abs(float(s) - float(act)) < 1e-9 * abs(float(act))
    assert rel(n(force_from_action(lambda w: s_act(w, t(heat)), u)), frc) \
        < 1e-9
    its, res = term.check_solve(u, t(heat))
    assert its > 0 and res < 1e-18


def test_hisq_solve_multi(hisq_refs):
    r = hisq_refs
    ferm = _fermion(r)
    u = t(r["u"])
    xs, stats = ferm.solve_multi(u, t(r["b"]), r["masses"])
    assert stats.iterations == r["its"]
    s3 = st.new_stag3_eo(Lattice(DIMS4), *ferm._links(u))
    for m, x, ref in zip(r["masses"], xs, r["xs"]):
        assert rel(n(x), ref) < 1e-10
        res = st.d2ee3(s3, x, m) - t(r["b"])
        assert float((res.abs() ** 2).sum() / (t(r["b"]).abs() ** 2).sum()
                     ) < 1e-18


def test_hisq_sloppy_solve_matches_reference(hisq_refs):
    """The JAX package takes no bf16 route off the TPU, so the reference
    is the sloppy recipe on the JAX operator: restarted CG whose inner
    fast-layout fat and long links are rounded to bf16 (rounding
    commutes with the +-1/2, the adjoint and the shifts, so these are
    the kernel's links), true residuals on the full operator, inner
    floor 1e-5."""
    r = hisq_refs
    jlat = JLattice(DIMS4)
    r2req, m = 1e-14, 0.4
    be = r["b"]

    def bf16(g):
        return (g.real.astype(jnp.bfloat16).astype(g.real.dtype)
                + 1j * g.imag.astype(jnp.bfloat16).astype(g.real.dtype))

    def ref(links, be):
        f3 = jsf.FastStag3EO(jlat, *links)
        f3b = jsf.FastStag3EO(jlat, *(bf16(g) for g in links))
        xf, stats = jcg.cg_solve_restarted(
            partial(jsf.d2ee3_fast, f3b, m=m), jsf.to_fast(be, jlat),
            r2req=r2req, maxits=1000, restarts=5,
            op_true=partial(jsf.d2ee3_fast, f3, m=m),
            inner_r2req_floor=1e-5)
        return jsf.from_fast(xf, jlat), stats.iterations

    # the fast-layout HISQ links of u, from the port (held to the JAX
    # package's by tests/test_torch_fat7.py)
    ferm = _fermion(r)
    f3 = sf.new_fast3(st.new_stag3_eo(Lattice(DIMS4),
                                      *ferm._links(t(r["u"]))))
    links = [n(g) for g in (f3.gf_e, f3.gf_o, f3.gl_e, f3.gl_o)]
    x_ref, its_ref = compile_ref(ref, links, be)(links, be)
    sp = SolverParams(r2req=r2req, maxits=1000, restarts=5, sloppy=True)
    x, stats = ferm.solve_ee(t(r["u"]), t(be), sp)
    assert stats.iterations == int(its_ref)
    assert rel(n(x), np.asarray(x_ref)) < 1e-9
    assert stats.r2 <= r2req


@pytest.fixture(scope="module")
def hisq_port(hisq_refs):
    r = hisq_refs
    th = convert.theory_from_reference(**r["args"])
    u = t(r["u"])
    phis = th.heatbath_from_noise(
        [None if x is None else t(x) for x in r["xis"]], u)
    h_old = float(th.hamiltonian(u, t(r["p"]), phis))
    u1, p1 = th.trajectory(u, t(r["p"]), phis)
    h_new = float(th.hamiltonian(u1, p1, phis))
    return dict(th=th, phis=phis, h_old=h_old, u1=u1, p1=p1, h_new=h_new)


def test_hisq_theory_terms(hisq_refs, hisq_port):
    th = hisq_port["th"]
    assert ([(x.name, x.smeared) for x in th.terms]
            == [(x.name, x.smeared) for x in hisq_refs["jterms"]])
    assert isinstance(th.matter_bases[0][1], stag_hmc.HisqFermion)
    assert rel(n(hisq_port["phis"][1]), hisq_refs["phis"][1]) < 1e-9


def test_hisq_trajectory_matches_reference(hisq_refs, hisq_port):
    r, g = hisq_refs, hisq_port
    assert abs(g["h_old"] - r["h_old"]) < 1e-9 * abs(r["h_old"])
    assert rel(n(g["u1"]), r["u1"]) < 1e-9
    assert rel(n(g["p1"]), r["p1"]) < 1e-9
    dh_ref = r["h_new"] - r["h_old"]
    assert abs((g["h_new"] - g["h_old"]) - dh_ref) < 1e-8, dh_ref


def test_hisq_solver_report_and_hasenbusch_raises(hisq_refs, hisq_port):
    """The solver report of the "hisq" theory; Hasenbusch masses on a
    HISQ field, once refused, build the JAX theory's chain (a ratio
    term and the plain field at the heavy mass), each with a solver
    report."""
    th = hisq_port["th"]
    rep = th.solver_report(torch.Generator().manual_seed(1), t(hisq_refs["u"]))
    (its, res), = rep.values()
    assert its > 0 and res < 1e-18
    args = dict(hisq_refs["args"],
                fermions=[JFermionSpec("hisq", 0.4, hmasses=(HMASS,))])
    th = convert.theory_from_reference(**args)
    assert [(x.name, x.steps) for x in th.terms] == \
        [(x.name, x.steps) for x in JTheory(**args).terms]
    rep = th.solver_report(torch.Generator().manual_seed(1), t(hisq_refs["u"]))
    assert list(rep) == ["hisq0_h0", "hisq0_h1"]
    for its, res in rep.values():
        assert its > 0 and res < 1e-18


def test_hisq_forces_tool_smooth_start_stays_finite():
    """apps.hisq_forces on the host: from expm(0.3 tah) links every kick
    is finite and the HISQ forces stay of order one (4^4, complex64)."""
    from qex_tpu_torch.apps import hisq_forces
    rec = hisq_forces.force_trace(Lattice(DIMS4), 0.3, 5,
                                  torch.device("cpu"))
    assert rec["nonfinite_at_kick"] is None
    assert len(rec["hisq_max_abs_force"]) == 13     # 6 steps of 2MN
    assert max(rec["hisq_max_abs_force"]) < 10.0
    assert np.isfinite(rec["dH"]) and abs(rec["dH"]) < 1.0
