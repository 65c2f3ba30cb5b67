"""The ported HMC slice against qex_tpu on 4^4 (complex128): the same
links, momenta and heatbath noise (drawn by JAX and injected) through
JAX's LatticeFieldTheory and the port's theory built by
convert.theory_from_reference, unsmeared and nHYP-smeared (heatbath, H,
one shared smeared kick, a short trajectory).  Fields agree to 1e-9
relative and dH to 1e-8 absolute (solves at r2req 1e-20).  Also the
integrator tables and the MD schedule by equality."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import compile_ref, n, random_links, rel, t
from qex_tpu.gauge import action as jga
from qex_tpu.gauge import loops as jloops
from qex_tpu.hmc import hmc as jhmc
from qex_tpu.hmc import integrators as jint
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.mcmc import md as jmd
from qex_tpu.mcmc.theory import FermionSpec as JFermionSpec
from qex_tpu.mcmc.theory import GaugeActionSpec as JGaugeActionSpec
from qex_tpu.mcmc.theory import LatticeFieldTheory as JTheory
from qex_tpu.ops import group as jgroup
from qex_tpu.physics import stag_hmc as jsh
from qex_tpu.solvers.base import SolverParams as JSolverParams
from qex_tpu_torch import convert
from qex_tpu_torch.gauge import loops
from qex_tpu_torch.hmc import hmc, integrators
from qex_tpu_torch.mcmc import md
from qex_tpu_torch.mcmc.theory import FermionSpec, LatticeFieldTheory

DIMS = (4, 4, 4, 4)
DT = jnp.complex128


def _theory_args():
    return dict(
        lat=JLattice(DIMS),
        gauge=JGaugeActionSpec(jga.wilson(5.5), steps=2, scheme="2MN"),
        fermions=[JFermionSpec("fermion", 0.2, steps=1, scheme="2MN",
                               smeared=False),
                  JFermionSpec("boson", 0.5, steps=1, scheme="2MN",
                               smeared=False)],
        smear=None, bc="pppa",
        solver_params=JSolverParams(r2req=1e-20, maxits=1000, restarts=3),
        tau=0.2)


@pytest.fixture(scope="module")
def slice_refs():
    """Reference draws and JAX results, each JAX call jitted once."""
    args = _theory_args()
    jth = JTheory(**args)
    jlat = args["lat"]
    u = jnp.asarray(random_links(np.random.default_rng(23), jlat, 0.5))
    kp, kf = jax.random.split(jax.random.PRNGKey(42))

    def draws(kp, kf):
        # hmc_step's momenta and heatbath's per-term noise streams
        p = jax.vmap(lambda k: jgroup.random_tah(k, DIMS, 3, DT))(
            jax.random.split(kp, 4))
        keys = jax.random.split(kf, len(jth.terms))
        return p, [jsh.gaussian_eta(k, jlat, DT) if term.heatbath
                   else None for term, k in zip(jth.terms, keys)]

    p, xis = compile_ref(draws, kp, kf)(kp, kf)
    xis = [None if x is None else np.asarray(x) for x in xis]
    phis = compile_ref(jth.heatbath, kf, u)(kf, u)
    # md.run_trajectory runs eagerly over per-term compiled forces, so
    # each force's CG while_loop compiles once, not once per kick
    terms = [dataclasses.replace(term, force=compile_ref(term.force, u, phi))
             for term, phi in zip(jth.terms, phis)]
    update = compile_ref(jhmc.gauge_update_u, u, p, 0.1)
    hamiltonian = compile_ref(jth.hamiltonian, u, p, phis)
    h_old = float(hamiltonian(u, p, phis))
    u1, p1 = jmd.run_trajectory(terms, u, p, phis, jth.tau, update)
    h_new = hamiltonian(u1, p1, phis)
    return dict(args=args, u=np.asarray(u), p=np.asarray(p), xis=xis,
                phis=[None if f is None else np.asarray(f) for f in phis],
                h_old=h_old, u1=np.asarray(u1), p1=np.asarray(p1),
                h_new=float(h_new), jterms=jth.terms)


@pytest.fixture(scope="module")
def port_run(slice_refs):
    r = slice_refs
    th = convert.theory_from_reference(**r["args"])
    u = convert.gauge_from_reference(r["u"], "cpu", torch.complex128)
    phis = th.heatbath_from_noise(
        [None if x is None else t(x) for x in r["xis"]], u)
    h_old = float(th.hamiltonian(u, t(r["p"]), phis))
    u1, p1 = th.trajectory(u, t(r["p"]), phis)
    h_new = float(th.hamiltonian(u1, p1, phis))
    return dict(th=th, phis=phis, h_old=h_old, u1=u1, p1=p1, h_new=h_new)


def test_heatbath_pseudofermions(slice_refs, port_run):
    for got, ref in zip(port_run["phis"], slice_refs["phis"]):
        assert (got is None) == (ref is None)
        if ref is not None:
            assert rel(n(got), ref) < 1e-9


def test_hamiltonian_old(slice_refs, port_run):
    ref = slice_refs["h_old"]
    assert abs(port_run["h_old"] - ref) < 1e-9 * abs(ref)


def test_trajectory_fields(slice_refs, port_run):
    assert rel(n(port_run["u1"]), slice_refs["u1"]) < 1e-9
    assert rel(n(port_run["p1"]), slice_refs["p1"]) < 1e-9


def test_hamiltonian_new_and_dH(slice_refs, port_run):
    ref = slice_refs["h_new"]
    assert abs(port_run["h_new"] - ref) < 1e-9 * abs(ref)
    dh_ref = slice_refs["h_new"] - slice_refs["h_old"]
    dh = port_run["h_new"] - port_run["h_old"]
    assert abs(dh - dh_ref) < 1e-8, (dh, dh_ref)


def test_schedule_of_the_slice(slice_refs, port_run):
    tau = slice_refs["args"]["tau"]
    assert (md.build_schedule(port_run["th"].terms, tau)
            == jmd.build_schedule(slice_refs["jterms"], tau))


@pytest.mark.parametrize("steps,schemes", [
    ((12, 6, 6), ("2MN", "2MN", "2MN")),
    ((3, 2), ("4MN5FV", "LF")),
    ((2, 3), ("FGI", "OMELYAN,0.2")),
])
def test_build_schedule_equal(steps, schemes):
    def terms(mod):
        return [mod.ActionTerm(f"t{i}", None, None, s, sc)
                for i, (s, sc) in enumerate(zip(steps, schemes))]
    assert (md.build_schedule(terms(md), 0.5)
            == jmd.build_schedule(terms(jmd), 0.5))


@pytest.mark.parametrize("name", sorted(jint.INTEGRATORS)
                         + ["2MN,0.2", "4MN5FV,0.25,-0.03,0.08,0.68"])
def test_integrator_tables_equal(name):
    got, ref = integrators.get_integrator(name), jint.get_integrator(name)
    assert (got.name, got.steps) == (ref.name, ref.steps)


def test_plaquette(slice_refs):
    jlat = slice_refs["args"]["lat"]
    ref = float(jloops.plaquette(jlat, jnp.asarray(slice_refs["u"])))
    got = loops.plaquette(convert.Lattice(DIMS), t(slice_refs["u"]))
    assert got.dtype == torch.float64
    assert abs(float(got) - ref) < 1e-13
    unit = torch.eye(3, dtype=torch.complex128).reshape(
        1, 3, 3, 1, 1, 1, 1).expand((4, 3, 3) + DIMS)
    assert abs(float(loops.plaquette(convert.Lattice(DIMS), unit)) - 1) \
        < 1e-15


def test_hmc_step_runs_with_a_generator(slice_refs, port_run):
    th = port_run["th"]
    u = t(slice_refs["u"])
    gen = torch.Generator().manual_seed(3)
    u_out, state = th.hmc_step(gen, u)
    assert np.isfinite(state.dH)
    assert state.dH == pytest.approx(state.h_new - state.h_old)
    assert isinstance(state.accepted, bool)
    assert torch.equal(u_out, u) != state.accepted
    _, forced = th.hmc_step(torch.Generator().manual_seed(3), u,
                            always_accept=True)
    assert forced.accepted and forced.dH == state.dH


def test_metropolis():
    acc = LatticeFieldTheory.metropolis
    assert acc(-3.0, 0.999) and acc(0.0, 0.5) and acc(0.5, 0.0)
    assert acc(1.0, np.exp(-1.0) - 1e-9)
    assert not acc(1.0, np.exp(-1.0) + 1e-9)
    assert not acc(float("nan"), 0.1)


def test_kinetic_energy_and_update(slice_refs):
    p, u = slice_refs["p"], slice_refs["u"]
    ref = float(jhmc.kinetic_energy(jnp.asarray(p)))
    assert abs(float(hmc.kinetic_energy(t(p))) - ref) < 1e-12 * ref
    ref = jhmc.gauge_update_u(jnp.asarray(u), jnp.asarray(p), 0.05)
    assert rel(n(hmc.gauge_update_u(t(u), t(p), 0.05)), ref) < 1e-12


def test_unported_theory_options_raise(slice_refs):
    args = dict(slice_refs["args"])
    with pytest.raises(TypeError, match="smear"):
        convert.theory_from_reference(**dict(args, smear=object()))
    for spec in (FermionSpec("fermion", 0.2, hmasses=(0.4,)),
                 FermionSpec("rooted", 0.2),
                 FermionSpec("hisq", 0.2, hmasses=(0.4,))):
        with pytest.raises(NotImplementedError):
            LatticeFieldTheory(convert.Lattice(DIMS),
                               convert._gauge_spec(args["gauge"]),
                               fermions=[spec])


def test_gauge_from_reference_layout(slice_refs):
    u = slice_refs["u"]
    got = convert.gauge_from_reference(u, "cpu", torch.complex64)
    assert got.shape == u.shape and got.dtype == torch.complex64
    assert rel(n(got), u) < 1e-7
    with pytest.raises(ValueError):
        convert.gauge_from_reference(u[0, 0], "cpu")


# --- the smeared composition (nHYP on the matter links and on a second,
# smeared gauge term, as the app's sg_opt) ------------------------------

def _smeared_args():
    from qex_tpu.gauge.smear import HypCoefs as JHypCoefs
    return dict(
        lat=JLattice(DIMS),
        gauge=[JGaugeActionSpec(jga.wilson(5.5), steps=2, scheme="2MN"),
               JGaugeActionSpec(jga.wilson(0.5), steps=1, scheme="2MN",
                                smeared=True)],
        fermions=[JFermionSpec("fermion", 0.2, steps=1, scheme="2MN"),
                  JFermionSpec("boson", 0.5, steps=1, scheme="2MN")],
        smear=JHypCoefs(0.4, 0.5, 0.5), bc="pppa",
        solver_params=JSolverParams(r2req=1e-20, maxits=1000, restarts=3),
        tau=0.2)


@pytest.fixture(scope="module")
def smeared_refs():
    """JAX draws and results for the smeared composition.  The
    trajectory runs the reference schedule over compiled pieces: the
    gauge update, the unsmeared gauge force, and md._shared_smeared_kick
    with its kick coefficients as arguments (every shared group holds
    the same three smeared terms), so each compiles once."""
    args = _smeared_args()
    jth = JTheory(**args)
    jlat = args["lat"]
    u = jnp.asarray(random_links(np.random.default_rng(29), jlat, 0.5))
    kp, kf = jax.random.split(jax.random.PRNGKey(7))

    def draws(kp, kf):
        p = jax.vmap(lambda k: jgroup.random_tah(k, DIMS, 3, DT))(
            jax.random.split(kp, 4))
        keys = jax.random.split(kf, len(jth.terms))
        return p, [jsh.gaussian_eta(k, jlat, DT) if term.heatbath
                   else None for term, k in zip(jth.terms, keys)]

    p, xis = compile_ref(draws, kp, kf)(kp, kf)
    phis = compile_ref(jth.heatbath, kf, u)(kf, u)
    hamiltonian = compile_ref(jth.hamiltonian, u, p, phis)
    smeared = [i for i, term in enumerate(jth.terms) if term.smeared]

    def kick(u, p, phis, cdts):
        return jmd._shared_smeared_kick(
            jth._smear, jth.terms, [(i, cdts[k], 0.0)
                                    for k, i in enumerate(smeared)],
            u, p, phis)

    cdts0 = jnp.ones(len(smeared))
    kick = compile_ref(kick, u, p, phis, cdts0)
    force0 = compile_ref(jth.terms[0].force, u, None)
    update = compile_ref(jhmc.gauge_update_u, u, p, 0.1)
    uu, pp = u, p
    for dt, kicks in jmd.build_schedule(jth.terms, jth.tau):
        if dt > 1e-9:
            uu = update(uu, pp, dt)
        shared = [k for k in kicks if jth.terms[k[0]].smeared]
        if shared:
            assert [k[0] for k in shared] == smeared
            pp = kick(uu, pp, phis, jnp.asarray([k[1] for k in shared]))
        for (i, cdt, _fg) in kicks:
            if not jth.terms[i].smeared:
                pp = pp - cdt * force0(uu, None)
    return dict(args=args, u=np.asarray(u), p=np.asarray(p),
                xis=[None if x is None else np.asarray(x) for x in xis],
                phis=[None if f is None else np.asarray(f) for f in phis],
                h_old=float(hamiltonian(u, p, phis)),
                kick0=np.asarray(kick(u, jnp.zeros_like(p), phis, cdts0)),
                u1=np.asarray(uu), p1=np.asarray(pp),
                h_new=float(hamiltonian(uu, pp, phis)), jterms=jth.terms)


@pytest.fixture(scope="module")
def smeared_port(smeared_refs):
    r = smeared_refs
    th = convert.theory_from_reference(**r["args"])
    u, p = t(r["u"]), t(r["p"])
    phis = th.heatbath_from_noise(
        [None if x is None else t(x) for x in r["xis"]], u)
    kicks = [(i, 1.0, 0.0) for i, term in enumerate(th.terms)
             if term.smeared]
    kick0 = md._shared_smeared_kick(th._smear, th.terms, kicks, u,
                                    torch.zeros_like(p), phis)
    u1, p1 = th.trajectory(u, p, phis)
    return dict(th=th, phis=phis, h_old=float(th.hamiltonian(u, p, phis)),
                kick0=kick0, u1=u1, p1=p1,
                h_new=float(th.hamiltonian(u1, p1, phis)))


def test_smeared_terms_and_schedule(smeared_refs, smeared_port):
    th = smeared_port["th"]
    assert ([(x.name, x.smeared) for x in th.terms]
            == [(x.name, x.smeared) for x in smeared_refs["jterms"]])
    assert (md.build_schedule(th.terms, th.tau)
            == jmd.build_schedule(smeared_refs["jterms"], th.tau))


def test_smeared_heatbath_and_hamiltonian(smeared_refs, smeared_port):
    for got, ref in zip(smeared_port["phis"], smeared_refs["phis"]):
        assert (got is None) == (ref is None)
        if ref is not None:
            assert rel(n(got), ref) < 1e-9
    ref = smeared_refs["h_old"]
    assert abs(smeared_port["h_old"] - ref) < 1e-9 * abs(ref)


def test_shared_smeared_kick(smeared_refs, smeared_port):
    assert rel(n(smeared_port["kick0"]), smeared_refs["kick0"]) < 1e-9


def test_smeared_trajectory_fields_and_dH(smeared_refs, smeared_port):
    r, g = smeared_refs, smeared_port
    assert rel(n(g["u1"]), r["u1"]) < 1e-9
    assert rel(n(g["p1"]), r["p1"]) < 1e-9
    dh_ref = r["h_new"] - r["h_old"]
    assert abs((g["h_new"] - g["h_old"]) - dh_ref) < 1e-8, dh_ref


def test_smeared_solves_use_action_and_force_params(smeared_refs,
                                                    monkeypatch):
    """H and the heatbath solve at solver_params, MD kicks on the
    smeared links at force_solver_params."""
    from qex_tpu_torch.physics import stag_hmc, stag_solve
    from qex_tpu_torch.solvers.base import SolverParams
    r = smeared_refs
    sp = SolverParams(r2req=1e-14, maxits=1000, restarts=3)
    fp = SolverParams(r2req=1e-12, maxits=999, restarts=2)
    th = LatticeFieldTheory(
        convert.Lattice(DIMS),
        [convert._gauge_spec(g) for g in r["args"]["gauge"]],
        fermions=[convert._fermion_spec(f) for f in r["args"]["fermions"]],
        smear=convert._smear(r["args"]["smear"]), solver_params=sp,
        force_solver_params=fp, tau=0.2)
    seen = []
    solve_ee = stag_solve.solve_ee

    def spy(s, b, m, params):
        seen.append(params)
        return solve_ee(s, b, m, params)

    monkeypatch.setattr(stag_hmc.stag_solve, "solve_ee", spy)
    u, p = t(r["u"]), t(r["p"])
    phis = th.heatbath_from_noise(
        [None if x is None else t(x) for x in r["xis"]], u)
    th.hamiltonian(u, p, phis)
    assert seen and all(x is sp for x in seen)
    seen.clear()
    kicks = [(i, 1.0, 0.0) for i, term in enumerate(th.terms)
             if term.smeared]
    md._shared_smeared_kick(th._smear, th.terms, kicks, u, p, phis)
    assert seen and all(x is fp for x in seen)
