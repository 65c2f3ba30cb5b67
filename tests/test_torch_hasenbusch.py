"""The Hasenbusch slice of qex_tpu_torch against qex_tpu (complex128,
4^4): the staggered Hasenbusch ratio term's heatbath (injected noise),
action and force to 1e-9 (the HISQ ratio's are held against JAX by
tests/test_torch_hisq.py, whose reference already traces the HISQ
fattening); LatticeFieldTheory's Hasenbusch chains and
rooted term, the JSON builder (mcmc.builder.theory_from_json) on the
decks of tests/test_config.py and the committed decks, each building
the JAX package's term list; and one trajectory of the
mcmc_hmc app on a 4^4 Hasenbusch deck, its start and draws injected
from JAX's hmc_step, whose dH it matches to 1e-8.  The JAX references
are a few programs, each compiled once."""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, n, random_links, rel, single_threaded,
                            t)
from qex_tpu.gauge import action as jga
from qex_tpu.hmc import hmc as jhmc
from qex_tpu.hmc import integrators as jint
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.mcmc import builder as jbuilder
from qex_tpu.mcmc import md as jmd
from qex_tpu.mcmc.theory import FermionSpec as JFermionSpec
from qex_tpu.mcmc.theory import GaugeActionSpec as JGaugeActionSpec
from qex_tpu.mcmc.theory import LatticeFieldTheory as JTheory
from qex_tpu.ops import group as jgroup
from qex_tpu.physics import stag_hmc as jsh
from qex_tpu_torch import convert
from qex_tpu_torch.apps import mcmc_hmc, staghmc_spv
from qex_tpu_torch.gauge.action import force_from_action
from qex_tpu_torch.hmc import integrators
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.mcmc import builder
from qex_tpu_torch.mcmc.theory import LatticeFieldTheory
from qex_tpu_torch.physics import stag_hmc
from qex_tpu_torch.solvers.base import SolverParams

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (4, 4, 4, 4)
R2 = 1e-20
M1, M2 = 0.2, 0.5               # staggered ratio: light, heavy
DECKS = Path(__file__).resolve().parent.parent / "qex_tpu_torch" / "apps" \
    / "decks"
# a 4^4 Hasenbusch deck for the app's trajectory: one LF step per term,
# solves to the last digits; its ratio term (masses M1, M2) is the one
# held against JAX on its own
HMC_DECK = {
    "hmc": {"lattice-geometry": list(DIMS), "trajectory-length": 0.1,
            "start": "hot", "serial-random-number-seed": 7},
    "gauge": {"action": "Wilson", "beta": 5.5, "steps": 1,
              "integrator": "LF"},
    "staggered-fermions": {"mass": M1, "steps": 1, "integrator": "LF",
                           "hasenbusch-masses": [M2]},
    "solver": {"tolerance": R2, "max-iterations": 1000, "restarts": 2},
}
# tests/test_config.py::test_json_builder's deck
CONFIG_DECK = {
    "hmc": {"lattice-geometry": [4, 4, 4, 8], "trajectory-length": 0.5},
    "action": {"smearing": "nhyp", "smearing-coefficients": [0.4, 0.5, 0.5],
               "boundary-conditions": "pppa"},
    "gauge": {"action": "Adjoint", "adjoint-ratio": -0.25, "beta": 11.1,
              "steps": 20, "integrator": "2MN"},
    "staggered-fermions": {"mass": 0.1, "steps": 30, "integrator": "2MN",
                           "species": 1},
    "rooted-staggered-fermions": {"nf": 2, "mass": 0.1, "steps": 30,
                                  "species": 0},
    "staggered-pauli-villars": {"mass": 0.75, "steps": 20, "species": 2},
}


@pytest.fixture(scope="module")
def refs():
    """The JAX deck theory's hmc_step from its pieces, each compiled once
    (as tests/test_torch_hmc.py: the MD loop runs eagerly over compiled
    forces, so each force compiles once, not once per kick), on random
    links."""
    rng = np.random.default_rng(91)
    jlat = JLattice(DIMS)
    u = random_links(rng, jlat, 0.5)
    key = jax.random.PRNGKey(11)
    _, jth, _ = jbuilder.theory_from_json(HMC_DECK)

    def draws(key, u):
        # hmc_step's own draws of its key
        kp, kf, _ = jax.random.split(key, 3)
        p = jax.vmap(lambda k: jgroup.random_tah(k, DIMS, 3, u.dtype))(
            jax.random.split(kp, 4))
        keys = jax.random.split(kf, len(jth.terms))
        xis = [jsh.gaussian_eta(k, jlat, u.dtype) if term.heatbath
               else None for term, k in zip(jth.terms, keys)]
        return p, xis, kf

    p, xis, kf = compile_ref(draws, key, u)(key, u)
    phis = compile_ref(jth.heatbath, kf, u)(kf, u)
    terms = [dataclasses.replace(term, force=compile_ref(term.force, u, phi))
             for term, phi in zip(jth.terms, phis)]
    ratio = jth.terms[1]
    act = compile_ref(ratio.action, u, phis[1])(u, phis[1])
    update = compile_ref(jhmc.gauge_update_u, u, p, 0.1)
    hamiltonian = compile_ref(jth.hamiltonian, u, p, phis)
    h_old = float(hamiltonian(u, p, phis))
    u1, p1 = jmd.run_trajectory(terms, u, p, phis, jth.tau, update)
    out = {"ratio": (phis[1], act, terms[1].force(u, phis[1])),
           "hmc": (p, xis, u1, h_old, float(hamiltonian(u1, p1, phis)))}
    return dict(u=u, xis=xis,
                out=jax.tree_util.tree_map(np.asarray, out))


# --- the ratio term ------------------------------------------------------------

def test_stag_hasenbusch_heatbath_action_force(refs):
    """The deck's ratio term: heatbath from the JAX noise, action and
    force at the heatbath's phi."""
    heat, act, frc = refs["out"]["ratio"]
    term = stag_hmc.StagHasenbusch(Lattice(DIMS), M1, M2, params=SolverParams(
        r2req=R2, maxits=1000, restarts=2))
    u = t(refs["u"])
    phi = term.heatbath_from_noise(t(refs["xis"][1]), u)
    assert rel(n(phi), heat) < 1e-9
    s_act = term.make_action_fn()
    s = s_act(u, phi)
    assert s.dtype == torch.float64
    assert abs(float(s) - float(act)) < 1e-9 * abs(float(act))
    assert rel(n(force_from_action(lambda w: s_act(w, phi), u)), frc) < 1e-9
    its, res = term.check_solve(u, phi)
    assert its > 0 and res < 1e-18


# --- theories --------------------------------------------------------------------

def _terms(th, get):
    return [(x.name, x.steps, get(x.scheme).name, x.smeared)
            for x in th.terms]


def _masses(th):
    return [tuple(float(getattr(b, k)) for k in ("m", "m1", "m2", "nf",
                                                  "degree")
                  if hasattr(b, k)) + (type(b).__name__,)
            for _name, b, _sm in th.matter_bases]


def _same_theory(th, jth):
    assert _terms(th, integrators.get_integrator) == \
        _terms(jth, jint.get_integrator)
    assert _masses(th) == _masses(jth)
    assert list(th.gauges) == [convert._gauge_spec(g) for g in jth.gauges]
    assert (th.tau, th.bc) == (jth.tau, jth.bc)


@pytest.mark.parametrize("spec", [
    dict(kind="fermion", mass=0.1, hmasses=(0.3, 0.6), scheme="FGI"),
    dict(kind="hisq", mass=0.1, hmasses=(0.4,)),
    dict(kind="rooted", mass=0.1, nf=3, degree=8, hmasses=(0.4,)),
    dict(kind="boson", mass=0.5, hmasses=(0.7,)),
])
def test_theory_builds_the_reference_terms(spec):
    args = dict(lat=JLattice(DIMS),
                gauge=JGaugeActionSpec(jga.wilson(5.5), steps=2),
                fermions=[JFermionSpec(steps=3, **spec),
                          JFermionSpec("boson", 0.7, steps=1)],
                smear=None, tau=0.3)
    _same_theory(convert.theory_from_reference(**args), JTheory(**args))


@pytest.mark.parametrize("deck", ["config", "hmc", "hasenbusch_24"])
def test_theory_from_json_matches_reference(deck):
    cfg = {"config": CONFIG_DECK, "hmc": HMC_DECK}.get(deck)
    if cfg is None:
        cfg = json.loads((DECKS / f"{deck}.json").read_text())
    lat, th, meta = builder.theory_from_json(cfg)
    jlat, jth, jmeta = jbuilder.theory_from_json(cfg)
    assert lat.dims == jlat.dims
    _same_theory(th, jth)
    sp, jsp = th.solver_params, jth.solver_params
    assert (sp.r2req, sp.maxits, sp.restarts) == \
        (jsp.r2req, jsp.maxits, jsp.restarts)
    assert type(th.smear_coefs).__name__ == type(jth.smear_coefs).__name__
    assert meta == jmeta


def test_theory_from_json_reads_files_and_refuses_a_mesh(tmp_path):
    path = tmp_path / "deck.json"
    path.write_text(json.dumps(CONFIG_DECK))
    assert [x.name for x in builder.theory_from_json(str(path))[1].terms] \
        == [x.name for x in jbuilder.theory_from_json(str(path))[1].terms]
    # tests/test_config.py::test_json_builder_mpi_geometry's deck asks
    # for eight ranks, which one process cannot hold
    with pytest.raises(ValueError, match="8 ranks|over 1 ranks"):
        builder.theory_from_json({"hmc": {"lattice-geometry": [4, 4, 4, 8],
                                          "mpi-geometry": [1, 1, 2, 4]}})
    # a one-rank geometry builds a mesh and routes the solves through it
    _, th, meta = builder.theory_from_json(
        {"hmc": {"lattice-geometry": [4, 4, 4, 8],
                 "mpi-geometry": [1, 1, 1, 1]}})
    assert meta["mesh"].rank_geom == (1, 1, 1, 1)
    assert th.solver_params.mesh is meta["mesh"]


# --- the mcmc_hmc app --------------------------------------------------------------

def test_mcmc_hmc_trajectory_matches_reference(refs, tmp_path, monkeypatch,
                                               capsys):
    """The app on the 4^4 deck on the host, its hot start, momenta and
    noise replaced by the JAX step's: the same H, dH and links."""
    p, xis, ju1, h_old, h_new = refs["out"]["hmc"]
    monkeypatch.setattr(staghmc_spv, "hot_start",
                        lambda lat, dtype, device, seed: t(refs["u"]))
    monkeypatch.setattr(LatticeFieldTheory, "draw_momenta",
                        staticmethod(lambda gen, u: t(p)))
    monkeypatch.setattr(LatticeFieldTheory, "draw_noise",
                        lambda self, gen, u: [None if x is None else t(x)
                                              for x in xis])
    states = []
    step = LatticeFieldTheory.hmc_step

    def recorded(self, gen, u, always_accept=False):
        u1, st_ = step(self, gen, u, always_accept)
        states.append((u1, st_))
        return u1, st_

    monkeypatch.setattr(LatticeFieldTheory, "hmc_step", recorded)
    deck = tmp_path / "deck.json"
    deck.write_text(json.dumps(HMC_DECK))
    assert mcmc_hmc.main(["--json", str(deck), "--cpu", "--ntraj", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "fermion0_h0" in lines[0] and "fermion0_h1" in lines[0]
    assert lines[1].startswith("traj 0: dH ") and "[warmup]" in lines[1]
    ((u1, st_),) = states
    assert abs(st_.dH - (float(h_new) - float(h_old))) < 1e-8
    assert abs(st_.h_old - float(h_old)) < 1e-9 * abs(st_.h_old)
    assert rel(n(u1), ju1) < 1e-9


def test_mcmc_hmc_needs_a_card_or_cpu_flag(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the app would run on it")
    assert mcmc_hmc.main(["--json", str(DECKS / "hasenbusch_24.json"),
                          "--ntraj", "0"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
