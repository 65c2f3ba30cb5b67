"""Force parity of qex_tpu_torch against qex_tpu (complex128, 4^4): the
hand staple gauge force, the complex-gradient convention helper, and
the fermion and Pauli-Villars forces through force_from_action (1e-9
relative, bounded by the r2req 1e-20 solves), plus one finite-difference
check of a force along a TAH direction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, ginibre, n, random_links, rel,
                            single_threaded, t)
from qex_tpu.gauge import action as jga
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.physics import stag_hmc as jsh
from qex_tpu.solvers import base as jbase
from qex_tpu_torch.gauge import action as ga
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group, linalg
from qex_tpu_torch.physics import stag_hmc
from qex_tpu_torch.solvers.base import SolverParams

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (4, 4, 4, 4)
BETA = 5.5
MF, MB = 0.3, 0.6
TOL = 1e-9


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(17)
    jlat = JLattice(DIMS)
    u = random_links(rng, jlat, scale=0.5)
    phi = ginibre(rng, (3,) + DIMS[:3] + (DIMS[3] // 2,))
    return jlat, Lattice(DIMS), u, phi


def test_gauge_force_hand(fields):
    jlat, lat, u, _ = fields
    ref = compile_ref(lambda v: jga.gauge_force(jga.wilson(BETA), jlat, v),
                      u)(u)
    got = ga.gauge_force(ga.wilson(BETA), lat, t(u))
    assert rel(n(got), ref) < 1e-12
    # a rect term adds its autograd remainder to the hand staples
    c = ga.GaugeActionCoeffs(plaq=BETA, rect=-0.1)
    auto = ga.force_from_action(lambda v: ga.full_action(c, lat, v), t(u))
    assert rel(n(ga.gauge_force(c, lat, t(u))), n(auto)) < 1e-12


def test_gauge_action_value(fields):
    jlat, lat, u, _ = fields
    ref = float(compile_ref(
        lambda v: jga.full_action(jga.wilson(BETA), jlat, v), u)(u))
    got = ga.full_action(ga.wilson(BETA), lat, t(u))
    assert got.dtype == torch.float64
    assert abs(float(got) - ref) < 1e-12 * abs(ref)


def test_gradient_convention_helper(fields):
    """torch's autograd gradient of the gauge action, mapped by
    force_from_grad, equals JAX's force_from_action on the same links;
    and it equals conj(JAX's gradient)."""
    jlat, lat, u, _ = fields

    def refs(u):
        def act(v):
            return jga.full_action(jga.wilson(BETA), jlat, v)
        return jax.grad(act)(u), jga.force_from_action(act, u)

    jg, ref = compile_ref(refs, u)(u)
    uu = t(u).requires_grad_(True)
    (g,) = torch.autograd.grad(ga.full_action(ga.wilson(BETA), lat, uu), uu)
    assert rel(n(g), np.conj(np.asarray(jg))) < 1e-12
    assert rel(n(ga.force_from_grad(t(u), g)), ref) < 1e-12
    got = ga.force_from_action(
        lambda v: ga.full_action(ga.wilson(BETA), lat, v), t(u))
    assert rel(n(got), ref) < 1e-12
    # the hand staple force is the same force
    assert rel(n(ga.gauge_force(ga.wilson(BETA), lat, t(u))), ref) < 1e-12


@pytest.fixture(scope="module")
def fermion_refs(fields):
    """JAX forces, one jit per action (the CG while_loop compiles once)."""
    jlat, _, u, phi = fields
    jp = jbase.SolverParams(r2req=1e-20, maxits=1000, restarts=3)
    sf = jsh.make_quad_inv_action(jlat, "pppa", MF, jp, jp)
    sb = jsh.make_quad_action(jlat, "pppa", MB)

    def ref(u, phi):
        ff = jga.force_from_action(lambda v: sf(v, phi), u)
        fb = jga.force_from_action(lambda v: sb(v, phi), u)
        return ff, fb, sf(u, phi), sb(u, phi)

    return [np.asarray(a) for a in compile_ref(ref, u, phi)(u, phi)]


def test_fermion_force(fields, fermion_refs):
    _, lat, u, phi = fields
    sp = SolverParams(r2req=1e-20, maxits=1000, restarts=3)
    s_act = stag_hmc.make_quad_inv_action(lat, "pppa", MF, sp, sp)
    got = ga.force_from_action(lambda v: s_act(v, t(phi)), t(u))
    assert rel(n(got), fermion_refs[0]) < TOL
    assert abs(float(s_act(t(u), t(phi))) - float(fermion_refs[2])) \
        < TOL * abs(float(fermion_refs[2]))


def test_boson_force(fields, fermion_refs):
    _, lat, u, phi = fields
    s_act = stag_hmc.make_quad_action(lat, "pppa", MB)
    got = ga.force_from_action(lambda v: s_act(v, t(phi)), t(u))
    assert rel(n(got), fermion_refs[1]) < TOL
    assert abs(float(s_act(t(u), t(phi))) - float(fermion_refs[3])) \
        < TOL * abs(float(fermion_refs[3]))


def test_force_params_reach_the_force_solve(fields):
    """A loose force tolerance changes the force but not the value."""
    _, lat, u, phi = fields
    tight = SolverParams(r2req=1e-20, maxits=1000, restarts=3)
    loose = SolverParams(r2req=1e-4, maxits=1000, restarts=1)
    st_ = stag_hmc.make_quad_inv_action(lat, "pppa", MF, tight, tight)
    sl = stag_hmc.make_quad_inv_action(lat, "pppa", MF, tight, loose)
    assert float(st_(t(u), t(phi))) == float(sl(t(u), t(phi)))
    ft = ga.force_from_action(lambda v: st_(v, t(phi)), t(u))
    fl = ga.force_from_action(lambda v: sl(v, t(phi)), t(u))
    assert 1e-16 < rel(n(fl), n(ft)) < 1e-1


def test_fermion_force_finite_difference(fields):
    """dS/de of S(exp(e P) U) at e=0 equals -sum retr(F P)."""
    _, lat, u, phi = fields
    sp = SolverParams(r2req=1e-24, maxits=1000, restarts=4)
    s_act = stag_hmc.make_quad_inv_action(lat, "pppa", MF, sp, sp)
    rng = np.random.default_rng(3)
    p = torch.stack([group.tah(t(ginibre(rng, (3, 3) + DIMS)))
                     for _ in range(4)])
    f = ga.force_from_action(lambda v: s_act(v, t(phi)), t(u))
    pred = -float(sum(linalg.re_trace(linalg.mul(f[mu], p[mu])).sum()
                      for mu in range(4)))
    eps = 1e-5

    def s_at(e):
        ue = torch.stack([linalg.mul(linalg.expm(e * p[mu]), t(u)[mu])
                          for mu in range(4)])
        return float(s_act(ue, t(phi)))

    fd = (s_at(eps) - s_at(-eps)) / (2 * eps)
    assert abs(fd - pred) < 1e-6 * abs(pred), (fd, pred)
