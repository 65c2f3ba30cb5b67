"""The ported pure-gauge HMC path against qex_tpu on 4^4 (complex128):
hmc.integrators (integrate for LF, 2MN, FGI and 4MN5FV from the same
(u, p); fg_force in its exact and shifted forms, and on fermion and
boson terms), hmc.hmc (hmc_step fed the JAX step's own momenta and
uniform, check_reverse; complex64 MD against complex128 MD), the
force-gradient kicks of mcmc.md in a stout-smeared LatticeFieldTheory,
and each term's force-gradient form against the form JAX's fg_force
takes; utils.config.FlowConfig on the committed flow decks;
utils.resample against qex_tpu.utils.resample (exact) and the
acceptance gate's error on ACCEPT_CPU.json; the apps puregauge_hmc,
gauge_flow (every FLOW number against the JAX app's to the printed
digit) and staghmc_spv's rect, adjoint and force-gradient theories.
Fields agree to 1e-12 relative."""

import contextlib
import io
import json
import re
from decimal import Decimal
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_refs, ginibre, n, rel, single_threaded, t)
from qex_tpu.apps import gauge_flow as jflow_app
from qex_tpu.apps import staghmc_spv as japp
from qex_tpu.gauge import action as jga
from qex_tpu.gauge.smear import HypCoefs as JHyp
from qex_tpu.gauge.smear import StoutCoefs as JStout
from qex_tpu.hmc import hmc as jhmc
from qex_tpu.hmc import integrators as jint
from qex_tpu.io import checkpoint as jckpt
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.mcmc import md as jmd
from qex_tpu.mcmc.theory import FermionSpec as JFermionSpec
from qex_tpu.mcmc.theory import GaugeActionSpec as JGaugeActionSpec
from qex_tpu.mcmc.theory import LatticeFieldTheory as JTheory
from qex_tpu.ops import group as jgroup
from qex_tpu.solvers.base import SolverParams as JSolverParams
from qex_tpu.utils import config as jconfig
from qex_tpu.utils import resample as jresample
from qex_tpu_torch import convert
from qex_tpu_torch.apps import gauge_flow as flow_app
from qex_tpu_torch.apps import puregauge_hmc as pg_app
from qex_tpu_torch.apps import staghmc_spv as app
from qex_tpu_torch.gauge import action as ga
from qex_tpu_torch.hmc import hmc, integrators
from qex_tpu_torch.io import checkpoint as ckpt
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group, linalg
from qex_tpu_torch.utils import config, resample

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (4, 4, 4, 4)
LAT, JLAT = Lattice(DIMS), JLattice(DIMS)
TOL = 1e-12
BETA = 5.5
SCHEMES = {"LF": 1, "2MN": 2, "FGI": 1, "4MN5FV": 1}   # name: nsteps
TAU, NSTEPS = 0.2, 2
# one compiled LF step of 0.1 from a rough field (dH < 0) and a smooth
# one (dH ~ +8)
HMC_TAU = 0.1
HMC_CASES = {"accept": (7, 0.5), "reject": (8, 0.2)}   # key, link scale
FG_A = 0.01
REPO = Path(__file__).resolve().parent.parent
DECKS = REPO / "qex_tpu_torch" / "apps" / "decks"


def links(g, scale):
    return n(torch.stack([linalg.expm(scale * group.tah(x))
                          for x in t(g)]))


def jfns(c):
    return partial(jga.full_action, c, JLAT), partial(jga.gauge_force, c,
                                                      JLAT)


def fns(c):
    return partial(ga.full_action, c, LAT), partial(ga.gauge_force, c, LAT)


def matter_theory_args():
    """Unsmeared fermion and boson terms; the solves converge to the
    last digit, so JAX's derivative through the CG iterations and the
    port's through the solve's backward agree."""
    return dict(lat=JLAT, gauge=JGaugeActionSpec(jga.wilson(BETA), steps=1),
                fermions=[JFermionSpec("fermion", 0.3, steps=1, scheme="FGI",
                                       smeared=False),
                          JFermionSpec("boson", 0.6, steps=1, scheme="FGI",
                                       smeared=False)],
                solver_params=JSolverParams(r2req=1e-28, maxits=500,
                                            restarts=5), tau=TAU)


def smeared_theory_args():
    return dict(lat=JLAT, gauge=[
        JGaugeActionSpec(jga.wilson(BETA), steps=1, scheme="FGI"),
        JGaugeActionSpec(jga.wilson(1.0), steps=1, scheme="LF",
                         smeared=True)],
        smear=JStout(0.1), tau=TAU)


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(77)
    g = ginibre(rng, (4, 3, 3) + DIMS)
    u = links(g, 0.5)
    p = n(torch.stack([group.tah(x)
                       for x in t(ginibre(rng, (4, 3, 3) + DIMS))]))
    phi = ginibre(rng, (3,) + DIMS[:3] + (DIMS[3] // 2,))
    jth = JTheory(**smeared_theory_args())
    jmatter = JTheory(**matter_theory_args())
    upd = jhmc.gauge_update_u

    # the reference programs, compiled side by side
    def integrators(u, p):
        _, frc = jfns(jga.wilson(BETA))
        return {f"int_{s}": jint.integrate(jint.get_integrator(s), u, p, TAU,
                                           ns, frc, upd)
                for s, ns in SCHEMES.items()}

    def fg_gauge(u):
        _, frc = jfns(jga.wilson(BETA))
        _, frc_sym = jfns(jga.symanzik(BETA))
        return {"fg_exact": jint.fg_force(u, FG_A, frc_sym, upd),
                "fg_shifted": frc(upd(u, frc(u), -FG_A))}

    def fg_matter(u, phi):
        return {f"fg_{term.name}": jint.fg_force(
            u, FG_A, lambda w, term=term: term.force(w, phi), upd)
            for term in jmatter.terms[1:]}

    def reverse_and_smeared(u, p):
        act, frc = jfns(jga.wilson(BETA))
        return {"reverse": jhmc.check_reverse(
                    u, p, act, frc, jint.get_integrator("LF"), TAU, 1),
                "smeared_traj": jmd.run_trajectory(
                    jth.terms, u, p, [None, None], TAU, upd,
                    transform=jth._smear),
                "smeared_h": jth.hamiltonian(u, p, [None, None])}

    def step(key, u):
        act, frc = jfns(jga.wilson(BETA))
        # hmc_step's own draws of its key
        kp, ka = jax.random.split(key)
        pp = jax.vmap(lambda kk: jgroup.random_tah(kk, DIMS, 3, u.dtype))(
            jax.random.split(kp, 4))
        r = jax.random.uniform(ka, (), jnp.float32)
        return pp, r, jhmc.hmc_step(key, u, act, frc,
                                    jint.get_integrator("LF"), HMC_TAU, 1)

    key0 = jax.random.PRNGKey(0)
    ints, fgg, fgm, rs, stepc = compile_refs(
        (integrators, u, p), (fg_gauge, u), (fg_matter, u, phi),
        (reverse_and_smeared, u, p), (step, key0, u))
    ref = jax.tree_util.tree_map(np.asarray, {
        **ints(u, p), **fgg(u), **fgm(u, phi), **rs(u, p)})
    hmc_u = {k: links(g, sc) for k, (_, sc) in HMC_CASES.items()}
    for k, (kk, _) in HMC_CASES.items():
        ref[f"hmc_{k}"] = jax.tree_util.tree_map(
            np.asarray, stepc(jax.random.PRNGKey(kk), hmc_u[k]))
    return dict(u=u, p=p, phi=phi, hmc_u=hmc_u, ref=ref)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_integrate(refs, scheme):
    _, frc = fns(ga.wilson(BETA))
    u1, p1 = integrators.integrate(
        integrators.get_integrator(scheme), t(refs["u"]), t(refs["p"]),
        TAU, SCHEMES[scheme], frc, hmc.gauge_update_u)
    ru, rp = refs["ref"][f"int_{scheme}"]
    assert rel(n(u1), ru) < TOL
    assert rel(n(p1), rp) < TOL


def test_merge_equal():
    for s in tuple(SCHEMES) + ("4MN5F2GP", "FGI6"):
        steps = jint.get_integrator(s).steps
        assert integrators._merge(steps) == jint._merge(steps)


@pytest.mark.parametrize("exact", [True, False])
def test_fg_force_both_forms(refs, exact):
    """The exact form through the rect force's forward-mode derivative
    (Symanzik), the shifted form on the plaquette force."""
    _, frc = fns(ga.symanzik(BETA) if exact else ga.wilson(BETA))
    u = t(refs["u"])
    got = integrators.fg_force(u, FG_A, frc, hmc.gauge_update_u,
                               exact=exact)
    assert rel(n(got), refs["ref"]["fg_exact" if exact else "fg_shifted"]) \
        < TOL
    # the other form differs at second order in a
    other = integrators.fg_force(u, FG_A, frc, hmc.gauge_update_u,
                                 exact=not exact)
    assert 0 < rel(n(got), n(other)) < 0.05


@pytest.mark.parametrize("kind", ["fermion", "boson"])
def test_fg_force_on_matter_terms(refs, kind):
    """JAX's fg_force on an unsmeared fermion (jvp through its solve's
    custom_vjp) and boson term against the port's Hessian-vector
    product of the same term's action (the path of mcmc.md's kicks):
    the exact form, which the shifted form is far from."""
    th = convert.theory_from_reference(**matter_theory_args())
    (term,) = [x for x in th.terms if x.name.startswith(kind)]
    assert term.fg_form == "hvp"
    u, phi = t(refs["u"]), t(refs["phi"])

    def frc(w):
        return term.force(w, phi)

    got = integrators.fg_force(u, FG_A, frc, hmc.gauge_update_u,
                               action_fn=lambda w: term.action(w, phi))
    ref = refs["ref"][f"fg_{term.name}"]
    assert rel(n(got), ref) < TOL
    shifted = integrators.fg_force(u, FG_A, frc, hmc.gauge_update_u,
                                   exact=False)
    assert rel(n(shifted), ref) > 1e-3


def test_check_reverse(refs):
    act, frc = fns(ga.wilson(BETA))
    got = hmc.check_reverse(t(refs["u"]), t(refs["p"]), act, frc,
                            integrators.get_integrator("LF"), TAU, 1)
    ref = refs["ref"]["reverse"]
    for k in ("dH_fwd", "dH_rev"):
        assert abs(got[k] - float(ref[k])) < TOL * 1e3, k
    for k in ("u_dev2", "p_dev2"):
        assert got[k] == pytest.approx(float(ref[k]), rel=1e-6, abs=1e-28)
        assert got[k] < 1e-24


@pytest.mark.parametrize("case", sorted(HMC_CASES))
def test_hmc_step_given_the_jax_draws(refs, case):
    p, r, (ju, jst) = refs["ref"][f"hmc_{case}"]
    act, frc = fns(ga.wilson(BETA))
    u = t(refs["hmc_u"][case])
    u_out, st = hmc.hmc_step_from(u, t(p), float(r), act, frc,
                                  integrators.get_integrator("LF"),
                                  HMC_TAU, 1)
    assert st.accepted == bool(jst.accepted) == (case == "accept")
    for k in ("h_old", "h_new"):
        assert abs(getattr(st, k) - float(getattr(jst, k))) \
            < TOL * abs(float(getattr(jst, k)))
    assert abs(st.dH - float(jst.dH)) < TOL * abs(float(jst.h_old))
    assert rel(n(u_out), ju) < TOL
    assert torch.equal(u_out, u) == (case == "reject")


def test_hmc_step_draws_and_guided(refs):
    act, frc = fns(ga.wilson(BETA))
    u = t(refs["u"])
    scheme = integrators.get_integrator("2MN")
    u1, st = hmc.hmc_step(torch.Generator().manual_seed(5), u, act, frc,
                          scheme, TAU, NSTEPS)
    gen = torch.Generator().manual_seed(5)
    p, r = hmc.draw_momenta(gen, u), hmc.draw_uniform(gen)
    u2, st2 = hmc.hmc_step_from(u, p, r, act, frc, scheme, TAU, NSTEPS)
    assert st == st2 and torch.equal(u1, u2)
    _, forced = hmc.hmc_step(torch.Generator().manual_seed(5), u, act, frc,
                             scheme, TAU, NSTEPS, always_accept=True)
    assert forced.accepted and forced.dH == st.dH
    # a guide equal to the target is plain HMC
    _, guided = hmc.hmc_step_guided(torch.Generator().manual_seed(5), u,
                                    act, frc, scheme, TAU, NSTEPS)
    assert guided == st


def test_complex64_md_follows_complex128_md():
    """The link update takes its exponential in complex128 also for
    complex64 fields: 48 2MN steps at 4^4 from one (u, p) give the dH of
    complex128 MD to 3.2e-5; with a complex64 exponential they are
    1.6e-2 off (the drift of ROADMAP C1)."""
    lat = Lattice(DIMS)
    act, frc = fns(ga.wilson(6.0))
    gen = torch.Generator().manual_seed(2)
    u = torch.stack([linalg.expm(0.5 * group.random_tah(
        gen, lat.dims, 3, torch.complex128)) for _ in range(4)])
    p = hmc.draw_momenta(gen, u)
    scheme = integrators.get_integrator("2MN")
    def update_c64_exp(w, q, eps):
        return torch.stack([linalg.mul(linalg.expm(eps * q[mu]), w[mu])
                            for mu in range(4)])

    dh = {}
    for key, dt, upd in (("c128", torch.complex128, hmc.gauge_update_u),
                         ("c64", torch.complex64, hmc.gauge_update_u),
                         ("c64_exp", torch.complex64, update_c64_exp)):
        uu, pp = u.to(dt), p.to(dt)
        u1, p1 = integrators.integrate(scheme, uu, pp, 1.0, 48, frc, upd)
        assert u1.dtype == dt
        dh[key] = hmc._h(act, u1, p1) - hmc._h(act, uu, pp)
    assert abs(dh["c64"] - dh["c128"]) < 1e-3
    assert abs(dh["c64_exp"] - dh["c128"]) > 1e-2


def test_smeared_theory_trajectory_with_fg_terms(refs):
    th = convert.theory_from_reference(**smeared_theory_args())
    assert [x.fg_form for x in th.terms] == ["jvp", "hvp"]
    u, p = t(refs["u"]), t(refs["p"])
    ref = refs["ref"]
    h = float(th.hamiltonian(u, p, [None, None]))
    assert abs(h - float(ref["smeared_h"])) < TOL * abs(h)
    u1, p1 = th.trajectory(u, p, [None, None])
    ru, rp = ref["smeared_traj"]
    assert rel(n(u1), ru) < TOL
    assert rel(n(p1), rp) < TOL


def _nhyp_theory_args(**kw):
    return dict(lat=JLAT, gauge=[
        JGaugeActionSpec(jga.symanzik(BETA), steps=1, scheme="FGI"),
        JGaugeActionSpec(jga.wilson(1.0), steps=1, scheme="FGI",
                         smeared=True)],
        fermions=[
            JFermionSpec("fermion", 0.3, steps=1, scheme="FGI",
                         smeared=False),
            JFermionSpec("boson", 0.6, steps=1, scheme="FGI",
                         smeared=False),
            JFermionSpec("fermion", 0.3, steps=1, scheme="FGI")],
        smear=JHyp(0.4, 0.5, 0.5), tau=0.02, **kw)


def test_fg_form_of_each_term_matches_jax():
    """JAX's fg_force takes its exact form where jax.jvp of the term's
    force traces: on the matter terms (test_fg_force_on_matter_terms)
    and on the nHYP-smeared gauge term, through the SU(3) projection's
    custom_vjp (jvp passes a custom_vjp's fwd and bwd inside a
    gradient).  The port takes the exact form on each."""
    args = _nhyp_theory_args(solver_params=JSolverParams(
        r2req=1e-12, maxits=10, restarts=1))
    th = convert.theory_from_reference(**args)
    (term,) = [x for x in JTheory(**args).terms if x.name == "smeared_gauge1"]
    u = jnp.zeros((4, 3, 3) + DIMS, jnp.complex128)
    # raises where JAX's fg_force falls back to the shifted form
    jax.eval_shape(lambda v: jax.jvp(lambda w: term.force(w, None),
                                     (v,), (v,)), u)
    assert [x.fg_form for x in th.terms] == ["jvp"] + ["hvp"] * 4


def test_exact_fg_kick_on_each_kind_of_term(refs):
    """The exact derivative dF[F U] of every kind of term (the rect
    force by jvp; the nHYP-smeared gauge force, the fermion through its
    solve, the boson and the smeared fermion by a Hessian-vector product)
    against a central difference of the term's own force."""
    sp = JSolverParams(r2req=1e-24, maxits=500, restarts=3)
    th = convert.theory_from_reference(**_nhyp_theory_args(
        solver_params=sp))
    u, p = t(refs["u"]), t(refs["p"])
    phis = th.heatbath(torch.Generator().manual_seed(1), u)
    eps, a = 1e-5, 1e-3
    for term, phi in zip(th.terms, phis):
        def frc(w, term=term, phi=phi):
            return term.force(w, phi)
        f1 = frc(u)
        fd = (frc(hmc.gauge_update_u(u, f1, eps))
              - frc(hmc.gauge_update_u(u, f1, -eps))) / (2 * eps)
        got = integrators.fg_force(
            u, a, frc, hmc.gauge_update_u,
            action_fn=(lambda w, term=term, phi=phi: term.action(w, phi))
            if term.fg_form == "hvp" else None)
        assert rel(n((f1 - got) / a), n(fd)) < 1e-7, term.name


# --- decks, statistics ------------------------------------------------------

@pytest.mark.parametrize("deck", ["flow_wilson_8.xml", "flow_rect_8.xml"])
def test_committed_flow_decks_parse(deck):
    got = config.FlowConfig.from_xml(str(DECKS / deck))
    ref = jconfig.FlowConfig.from_xml(str(DECKS / deck))
    assert got.__dict__ == ref.__dict__
    assert got.dims == (8, 8, 8, 8) and len(got.segments) == 2
    assert got.flow_act == deck.split("_")[1].capitalize()
    assert got.segments[-1][0] == 0.2


@pytest.mark.parametrize("block", [1, 3, 7])
def test_resample_equals_jax_package(block):
    data = np.random.default_rng(block).normal(size=57).cumsum() * 0.1
    assert np.array_equal(resample.blocked(data, block),
                          jresample.blocked(data, block))
    assert resample.jackknife(data, block=block) \
        == jresample.jackknife(data, block=block)
    assert resample.jackknife(data, fn=np.var, block=block) \
        == jresample.jackknife(data, fn=np.var, block=block)
    assert resample.bootstrap(data, block=block, n_samples=200, seed=3) \
        == jresample.bootstrap(data, block=block, n_samples=200, seed=3)
    assert resample.autocorrelation_time(data[::block]) \
        == jresample.autocorrelation_time(data[::block])
    assert resample.autocorrelation_time([1.0, 1.0, 1.0, 1.0]) == 0.5


def test_acceptance_gate_error_of_the_float64_chain():
    """The yardstick of chip_smoke's puregauge_accept gate: the float64
    chain's plaquette error by a blocked jackknife with blocks of 5."""
    series = json.loads((REPO / "ACCEPT_CPU.json").read_text())[
        "plaq_series"]
    assert len(series) == 40
    mean, err = resample.jackknife(series, block=5)
    assert mean == pytest.approx(0.5944060124839646, abs=1e-15)
    assert err == pytest.approx(2.7977e-4, rel=1e-4)
    naive = np.std(series, ddof=1) / np.sqrt(len(series))
    assert naive == pytest.approx(1.739e-4, rel=1e-3)
    # the naive error ignores autocorrelation: it nearly doubles by 8
    assert resample.jackknife(series, block=8)[1] > 1.9 * naive


# --- apps -----------------------------------------------------------------

def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def _same_to_printed_digit(a: str, b: str) -> bool:
    unit = 10.0 ** max(Decimal(a).as_tuple().exponent,
                       Decimal(b).as_tuple().exponent)
    return abs(float(a) - float(b)) <= 1.0001 * unit


def test_gauge_flow_app_matches_jax_app(refs, tmp_path):
    path = str(tmp_path / "cfg.npz")
    ckpt.save_checkpoint(path, t(refs["u"]), {"seed": 1}, 3)
    argv = ["--cpu", "--lattice", "4", "4", "4", "4", "--tmax", "0.06",
            "--dt", "0.02", "--load", path]
    got = [ln for ln in _lines(flow_app.main, argv)
           if ln.startswith("FLOW")]
    ref = [ln for ln in _lines(jflow_app.main, argv)
           if ln.startswith("FLOW")]
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        gw, rw = g.split(), r.split()
        assert gw[::2] == rw[::2]          # the labels
        for a, b in zip(gw[1::2], rw[1::2]):
            assert _same_to_printed_digit(a, b), (g, r)


def test_gauge_flow_app_deck_and_hot_start(capsys):
    lines = _lines(flow_app.main, ["--cpu", "--lattice", "4", "4", "4", "4",
                                   "--adj", "-0.2", "--tmax", "0.02",
                                   "--dt", "0.02"])
    assert sum(ln.startswith("FLOW 0.02 plaq") for ln in lines) == 1
    if not torch.cuda.is_available():
        assert flow_app.main(["--xml", str(DECKS / "flow_wilson_8.xml")]) \
            == 2
        assert "no CUDA device" in capsys.readouterr().err


TRAJ_LINE = re.compile(r"^traj \d+: dH [+-]\S+ (ACCEPT|REJECT)"
                       r"( \[warmup\])? MEASplaq \S+ \(\d+\.\d\d s\)$")


@pytest.mark.parametrize("argv", [
    ["--lattice", "4", "4", "4", "4", "--steps", "2", "--tau", "0.2",
     "--start", "hot", "--int", "FGI", "--c1", "-0.0833333"],
    ["--lattice", "4", "4", "--nc", "1", "--beta", "2.0", "--steps", "3"],
])
def test_puregauge_hmc_app(argv, tmp_path):
    path = str(tmp_path / "pg.npz")
    lines = _lines(pg_app.main, ["--cpu", "--ntraj", "2", "--save", path,
                                 *argv])
    traj = [ln for ln in lines if ln.startswith("traj")]
    assert len(traj) == 2 and all(TRAJ_LINE.match(ln) for ln in traj)
    assert "[warmup]" in traj[0] and "[warmup]" not in traj[1]
    assert re.match(r"^# acceptance [01]/1 = [01]\.000$", lines[-2])
    assert lines[-1] == f"# saved {path}"
    i = argv.index("--lattice") + 1
    dims = []
    while i < len(argv) and argv[i].isdigit():
        dims.append(int(argv[i]))
        i += 1
    nc = 1 if "--nc" in argv else 3
    u, rng_state, traj_n = jckpt.load_checkpoint(
        path, JLattice(tuple(dims), nc=nc), jnp.complex128)
    assert traj_n == 2 and rng_state == {"seed": 987654321}
    assert float(np.abs(np.asarray(u)).max()) <= 1.0 + 1e-12


def _deck_cfg(module, **kv):
    cfg = module.HMCConfig.from_xml(str(DECKS / "config4_24.xml"))
    cfg.override({k: str(v) for k, v in kv.items()})
    return cfg


@pytest.mark.parametrize("kv", [
    dict(gauge_act="rect", c1=-0.1, gauge_int_alg="FGI"),
    dict(gauge_act="adjoint", adj_fac=-0.25, ferm_int_alg="4MN5F2GP",
         pv_int_alg="FGI", sg_opt=1, smeared_gauge_act="rect", sm_c1=-0.2,
         sm_beta=2.0, smeared_gauge_int_alg="FGI"),
])
def test_app_builds_rect_adjoint_and_fg_theories(kv):
    lat = Lattice((4, 4, 4, 4))
    th = app.build_theory(_deck_cfg(config, **kv), lat)
    jth = japp.build_theory(_deck_cfg(jconfig, **kv), JLattice(lat.dims),
                            jnp.complex128)
    assert [convert._gauge_spec(g) for g in jth.gauges] == list(th.gauges)
    def schemes(terms, get):
        return [(x.name, x.steps, get(x.scheme).name, get(x.scheme).steps)
                for x in terms]

    assert schemes(th.terms, integrators.get_integrator) \
        == schemes(jth.terms, jint.get_integrator)
    assert th.gauges[0].coeffs.rect or th.gauges[0].coeffs.adjplaq
    assert any(st[0] == "FG" for x in th.terms
               for st in x.get_scheme().steps)


def test_convert_carries_rect_pgm_and_adjplaq():
    c = jga.GaugeActionCoeffs(plaq=4.0, rect=-0.3, pgm=0.2, adjplaq=0.5)
    th = convert.theory_from_reference(
        JLAT, JGaugeActionSpec(c, steps=3, scheme="FGI"))
    assert th.gauges[0].coeffs == ga.GaugeActionCoeffs(4.0, -0.3, 0.2, 0.5)
    assert th.terms[0].get_scheme().name == "FGI"
