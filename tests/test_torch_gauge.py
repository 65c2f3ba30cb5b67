"""The ported pure-gauge modules against qex_tpu on 4^4 (complex128):
ops.linalg (outer, sqrtm_db, logm), ops.group (the Haar samplers given
JAX's own Ginibre draws, check_su), gauge.action (every action family,
gauge_force, gauge_grad), gauge.wline / gauge.loops (Wilson lines,
clover F, both energy densities, the topological charge, also on a field
with nontrivial Q) and gauge.flow (flow_step, three measured steps of
flow).  Every JAX reference is compiled once, in one
program; everything agrees to 1e-12 relative."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_refs, ginibre, n, rel, single_threaded, t)
from qex_tpu.gauge import action as jga
from qex_tpu.gauge import flow as jgf
from qex_tpu.gauge import loops as jloops
from qex_tpu.gauge import wline as jwl
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.ops import group as jgroup
from qex_tpu.ops import linalg as jlinalg
from qex_tpu_torch.gauge import action as ga
from qex_tpu_torch.gauge import flow as gf
from qex_tpu_torch.gauge import loops, wline
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group, linalg

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (4, 4, 4, 4)
LAT, JLAT = Lattice(DIMS), JLattice(DIMS)
TOL = 1e-12
COEFFS = {"wilson": jga.wilson(5.5), "symanzik": jga.symanzik(5.5),
          "iwasaki": jga.iwasaki(5.5), "dbw2": jga.dbw2(5.5),
          "adjoint": jga.adjoint_action(5.5, -0.25),
          "pgm": jga.GaugeActionCoeffs(pgm=0.7),
          "all": jga.GaugeActionCoeffs(plaq=4.0, rect=-0.3, pgm=0.2,
                                       adjplaq=0.5)}
# forces and gradients: the hand staples, the AD remainder and both
# together in 4D; the pgm remainder (the largest AD graph) in 3D
FORCES = {"wilson": 4, "adjoint": 4, "symanzik": 4, "pgm": 3}
DIMS3 = (4, 4, 4)
LAT3, JLAT3 = Lattice(DIMS3), JLattice(DIMS3)
LOGM = dict(sqrt_iters=1, series_order=10, db_iters=6)
PATHS = [(1, 2, -1, -2), (1, 1, 3, -1, -1, -3), (4, 4, 4, 4),
         (2, -3, 1, 3, -2)]
SAMPLE = {3: (4, 3), 6: (2, 2)}   # n -> site shape: MGS and QR
FLUXES = {(0, 1): 1, (2, 3): 1, (0, 2): 1, (1, 3): 2}


def port_coeffs(c):
    return ga.GaugeActionCoeffs(c.plaq, c.rect, c.pgm, c.adjplaq)


def links(g, scale):
    """expm(scale tah(g)) per link through the port (the same field goes
    into both packages)."""
    return n(torch.stack([linalg.expm(scale * group.tah(x))
                          for x in t(g)]))


def flux_links(rng):
    """A U(1) field with constant flux 2 pi q / (L_a L_b) in the planes
    of FLUXES, embedded in SU(3) as diag(e^i th, e^-i th, 1) and
    perturbed: a field whose clover charge is far from 0 and exercises
    two of the three epsilon pairings."""
    x = np.indices(DIMS)
    th = np.zeros((4,) + DIMS)
    for (a, b), q in FLUXES.items():
        la, lb = DIMS[a], DIMS[b]
        th[a] -= 2 * np.pi * q * x[b] / (la * lb)
        th[b] += np.where(x[b] == lb - 1, 2 * np.pi * q * x[a] / la, 0.0)
    u = np.zeros((4, 3, 3) + DIMS, complex)
    u[:, 0, 0], u[:, 1, 1], u[:, 2, 2] = np.exp(1j * th), np.exp(-1j * th), 1
    kick = links(ginibre(rng, (4, 3, 3) + DIMS), 0.05)
    return np.einsum("mab...,mbc...->mac...", kick, u)


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(31)
    u = links(ginibre(rng, (4, 3, 3) + DIMS), 0.5)
    u3 = links(ginibre(rng, (3, 3, 3) + DIMS3), 0.5)
    uq = flux_links(rng)
    near = links(ginibre(rng, (1, 3, 3) + DIMS), 0.3)[0]
    v = ginibre(rng, (3,) + DIMS)
    w = ginibre(rng, (3,) + DIMS)
    keys = {k: jax.random.PRNGKey(k) for k in SAMPLE}

    # the reference programs, compiled side by side
    def algebra_and_actions(u, near, v, w):
        out = {"outer": jlinalg.outer(v, w),
               "sqrtm": jlinalg.sqrtm_db(near, iters=LOGM["db_iters"]),
               "logm": jlinalg.logm(near, **LOGM)}
        for k, c in COEFFS.items():
            out[f"S_{k}"] = jga.full_action(c, JLAT, u)
        return out

    def forces(u, u3):
        out = {}
        for k, nd in FORCES.items():
            lat, x = (JLAT, u) if nd == 4 else (JLAT3, u3)
            out[f"F_{k}"] = jga.gauge_force(COEFFS[k], lat, x)
            out[f"G_{k}"] = jga.gauge_grad(COEFFS[k], lat, x)
        return out

    def lines_and_flow(u, uq):
        out = {}
        eng = jwl.PathEngine(JLAT, u)
        for i, p in enumerate(PATHS):
            out[f"line_{i}"] = jloops.wilson_line(JLAT, u, list(p), eng)
            out[f"lineM_{i}"] = eng.line(p)
        out["fmunu"] = jnp.stack([
            jloops.clover_fmunu(uq, mu, nu, 4)
            for mu in range(4) for nu in range(mu + 1, 4)])
        out["Eclov"] = jloops.energy_density_clover(JLAT, uq)
        out["Eplaq"] = jloops.energy_density_plaq(JLAT, uq)
        out["Q"] = jloops.topo_charge_clover(JLAT, uq)
        c = jgf.wilson_flow_coeffs(3)
        out["flow_step"] = jgf.flow_step(c, JLAT, u, 0.02)
        out["flow_u"], out["flow_m"] = jgf.flow(c, JLAT, u, 0.02, 3)
        return out

    def samplers(keys):
        out = {}
        for k, key in keys.items():
            kr, ki = jax.random.split(key)
            shape = (k, k) + SAMPLE[k]
            out[f"ginibre_{k}"] = (jax.random.normal(kr, shape, jnp.float64)
                                   + 1j * jax.random.normal(ki, shape,
                                                            jnp.float64))
            out[f"unitary_{k}"] = jgroup.random_unitary(key, SAMPLE[k], k,
                                                        jnp.complex128)
            out[f"su_{k}"] = jgroup.random_su(key, SAMPLE[k], k,
                                              jnp.complex128)
            out[f"check_{k}"] = jgroup.check_su(out[f"su_{k}"])
        return out

    progs = compile_refs((algebra_and_actions, u, near, v, w),
                         (forces, u, u3), (lines_and_flow, u, uq),
                         (samplers, keys))
    ref = jax.tree_util.tree_map(np.asarray, {
        **progs[0](u, near, v, w), **progs[1](u, u3), **progs[2](u, uq),
        **progs[3](keys)})
    return dict(u=u, u3=u3, uq=uq, near=near, v=v, w=w, ref=ref)


def test_outer(refs):
    got = linalg.outer(t(refs["v"]), t(refs["w"]))
    assert rel(n(got), refs["ref"]["outer"]) < TOL


def test_sqrtm_and_logm(refs):
    near, r = t(refs["near"]), refs["ref"]
    s = linalg.sqrtm_db(near, iters=LOGM["db_iters"])
    assert rel(n(s), r["sqrtm"]) < TOL
    assert rel(n(linalg.mul(s, s)), refs["near"]) < 1e-12
    lg = linalg.logm(near, **LOGM)
    assert rel(n(lg), r["logm"]) < TOL
    # at the default depth the log of a unitary field is anti-hermitian
    # and exponentiates back
    lg = linalg.logm(near)
    assert float(linalg.norm2(lg + linalg.adj(lg))) < 1e-20
    assert rel(n(linalg.expm(lg)), refs["near"]) < 1e-12


@pytest.mark.parametrize("k", sorted(SAMPLE))
def test_haar_samplers_given_the_same_draws(refs, k):
    r = refs["ref"]
    g = t(r[f"ginibre_{k}"])
    u = group.unitary_from_ginibre(g)
    assert rel(n(u), r[f"unitary_{k}"]) < TOL
    su = group.su_from_unitary(u)
    assert rel(n(su), r[f"su_{k}"]) < TOL
    check = group.check_su(su)
    for name, val in check.items():
        assert float(val) == pytest.approx(float(r[f"check_{k}"][name]),
                                           abs=1e-24)
        assert float(val) < 1e-24
    gen = torch.Generator().manual_seed(k)
    drawn = group.random_su(gen, SAMPLE[k], k, torch.complex128)
    assert drawn.shape == (k, k) + SAMPLE[k]
    assert all(float(x) < 1e-24 for x in group.check_su(drawn).values())


@pytest.mark.parametrize("name", sorted(COEFFS))
def test_actions(refs, name):
    r = refs["ref"]
    got = ga.full_action(port_coeffs(COEFFS[name]), LAT, t(refs["u"]))
    assert got.dtype == torch.float64
    ref = float(r[f"S_{name}"])
    assert abs(float(got) - ref) < TOL * abs(ref)


def test_coefficient_presets():
    for f in ("wilson", "symanzik", "iwasaki", "dbw2"):
        assert getattr(ga, f)(6.0) == port_coeffs(getattr(jga, f)(6.0))
    assert ga.gauge_act_rect(6.0, -0.2) == port_coeffs(
        jga.gauge_act_rect(6.0, -0.2))
    assert ga.adjoint_action(6.0, -0.3) == port_coeffs(
        jga.adjoint_action(6.0, -0.3))
    assert 2.0 * ga.symanzik(1.0) == ga.symanzik(2.0)


@pytest.mark.parametrize("name", sorted(FORCES))
def test_gauge_force_and_grad(refs, name):
    r, c = refs["ref"], port_coeffs(COEFFS[name])
    lat, u = (LAT, refs["u"]) if FORCES[name] == 4 else (LAT3, refs["u3"])
    assert rel(n(ga.gauge_force(c, lat, t(u))), r[f"F_{name}"]) < TOL
    # torch's gradient is the conjugate of JAX's
    got = ga.gauge_grad(c, lat, t(u))
    assert rel(np.conj(n(got)), r[f"G_{name}"]) < TOL


def test_gauge_force_is_the_action_gradient(refs):
    """The dispatch (hand staples + torch.func.grad) equals autograd on
    the full action."""
    c = port_coeffs(COEFFS["all"])
    u = t(refs["u"])
    auto = ga.force_from_action(lambda v: ga.full_action(c, LAT, v), u)
    assert rel(n(ga.gauge_force(c, LAT, u)), n(auto)) < TOL


def test_wilson_lines(refs):
    r = refs["ref"]
    eng = wline.PathEngine(LAT, t(refs["u"]))
    for i, p in enumerate(PATHS):
        got = loops.wilson_line(LAT, t(refs["u"]), list(p), engine=eng)
        assert abs(float(got) - float(r[f"line_{i}"])) < TOL
        assert rel(n(eng.line(p)), r[f"lineM_{i}"]) < TOL
    assert eng.stats()["segments"] > len(PATHS)
    assert wline.path_displacement((1, 1, -3, 2, -1), 4) == (1, 1, -1, 0)
    with pytest.raises(ValueError):
        eng.line((5,))
    ident = eng.line(())
    assert torch.equal(ident[:, :, 0, 0, 0, 0],
                       torch.eye(3, dtype=ident.dtype))


def test_clover_energy_and_charge(refs):
    """On the flux field, whose charge is far from 0."""
    r = refs["ref"]
    u = t(refs["uq"])
    fs = torch.stack([loops.clover_fmunu(u, mu, nu, 4)
                      for mu in range(4) for nu in range(mu + 1, 4)])
    assert rel(n(fs), r["fmunu"]) < TOL
    for key, fn in (("Eclov", loops.energy_density_clover),
                    ("Eplaq", loops.energy_density_plaq)):
        got = fn(LAT, u)
        assert got.dtype == torch.float64
        assert abs(float(got) - float(r[key])) < TOL * abs(float(r[key]))
    q, ref = float(loops.topo_charge_clover(LAT, u)), float(r["Q"])
    assert abs(q - ref) < TOL * abs(ref)
    # abelian fluxes f = 2 pi q / 16: Q = -(V / 2 pi^2)
    # (f01 f23 - f02 f13 + f03 f12) = 2 in the small-field limit; a sign
    # slip in the second pairing would give -6
    assert 1.0 < q < 2.5
    # a gauge transformation leaves E and Q as they are
    g = t(links(ginibre(np.random.default_rng(5), (1, 3, 3) + DIMS),
                1.0)[0])
    ug = torch.stack([linalg.mul(linalg.mul(g, u[mu]), linalg.adj(
        torch.roll(g, -1, mu - 4))) for mu in range(4)])
    assert float(loops.topo_charge_clover(LAT, ug)) == pytest.approx(
        q, rel=1e-12)
    assert float(loops.energy_density_clover(LAT, ug)) == pytest.approx(
        float(r["Eclov"]), rel=1e-12)
    with pytest.raises(ValueError):
        loops.topo_charge_clover(Lattice((4, 4, 4)), u[:3, ..., 0])


def test_flow_step_and_flow(refs):
    r = refs["ref"]
    u = t(refs["u"])
    got = gf.flow_step(gf.wilson_flow_coeffs(3), LAT, u, 0.02)
    assert rel(n(got), r["flow_step"]) < TOL
    v, ms = gf.flow(gf.wilson_flow_coeffs(3), LAT, u, 0.02, 3)
    assert rel(n(v), r["flow_u"]) < TOL
    for name, col, ref in zip(gf.FlowMeasurement._fields, ms, r["flow_m"]):
        assert col.shape == (3,) and col.dtype == torch.float64, name
        assert rel(n(col), ref) < TOL, name
    v2, none = gf.flow(gf.wilson_flow_coeffs(3), LAT, u, 0.02, 3,
                       measure=False)
    assert none is None and torch.equal(v2, v)


def test_flow_segments(refs):
    """Segments continue one flow: the JAX-checked ``flow`` in pieces."""
    c, u = gf.wilson_flow_coeffs(3), t(refs["u"])
    segs = gf.flow_segments(c, LAT, u, [(0.04, 0.02), (0.07, 0.015)])
    assert [len(s.t) for s in segs] == [2, 2]
    v, first = gf.flow(c, LAT, u, 0.02, 2)
    _, second = gf.flow(c, LAT, v, 0.015, 2, t0=0.04)
    for got, ref in zip(segs, (first, second)):
        for col, rcol in zip(got, ref):
            assert torch.equal(col, rcol)
    assert float(segs[-1].t[-1]) == pytest.approx(0.07)
    assert math.isfinite(float(segs[-1].topo_q[-1]))
