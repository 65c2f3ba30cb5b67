"""The SU(3) samplers, gauge fixing and the numeric utilities of
qex_tpu_torch against qex_tpu (complex128 / float64 on the CPU, 4^4):
hmc.nambu (generators, the adjoint projection, NambuSystem's forces on
a one-step stout guide, nambu_hmc_step against the JAX app's own step
fed its momenta and uniform, the metadynamics bias and MetaHistory), apps.rahmc
(ra_step_from against the JAX app's own ra_step on its draws, and its
gamma = 0 limit against the port's leapfrog hmc_step), gauge.fix
(transform, fixed links, functional and violation at a few sweeps,
Landau and Coulomb), utils.numdiff and utils.spline, and the apps
nambu_hmc and rahmc against the JAX apps' lines with the JAX draws
injected.  Deterministic functions and stochastic cores fed JAX's draws
agree to TOL (relative); dH to 1e-10 absolute."""

import contextlib
import io
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, ginibre, n, random_links,  # noqa
                            single_threaded, t)
from qex_tpu.apps import nambu_hmc as jnambu_app
from qex_tpu.apps import rahmc as jrahmc_app
from qex_tpu.gauge import action as jga
from qex_tpu.gauge import fix as jfix
from qex_tpu.gauge.smear import StoutCoefs as JStout
from qex_tpu.gauge.smear import stout_smear as jstout
from qex_tpu.hmc import nambu as jnambu
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.ops import group as jgroup
from qex_tpu.utils import numdiff as jnumdiff
from qex_tpu.utils import spline as jspline
from qex_tpu_torch import convert
from qex_tpu_torch.apps import nambu_hmc as nambu_app
from qex_tpu_torch.apps import rahmc as rahmc_app
from qex_tpu_torch.gauge import action as ga
from qex_tpu_torch.gauge import fix
from qex_tpu_torch.gauge.smear import StoutCoefs, stout_smear
from qex_tpu_torch.hmc import hmc, integrators, nambu
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.utils import numdiff, spline

DIMS = (4, 4, 4, 4)
LAT, JLAT = Lattice(DIMS), JLattice(DIMS)
TOL = 1e-12
C128 = jnp.complex128
pytestmark = pytest.mark.usefixtures("single_threaded")


def close(got, ref, tol=TOL):
    got = n(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert np.linalg.norm(got - ref) <= tol * max(np.linalg.norm(ref),
                                                  1e-300), (got, ref)


def key(i):
    return jax.random.PRNGKey(i)


def j_momenta(k, dims, nd=4):
    """JAX's hmc_step / ra_step draws: TAH momenta and the uniform."""
    kp, ka = jax.random.split(k)
    p = jax.vmap(lambda kk: jgroup.random_tah(kk, dims, 3, C128))(
        jax.random.split(kp, nd))
    return p, jax.random.uniform(ka, (), jnp.float32)


def j_nambu_draws(k, dims, gens, nd=4):
    kp, kq, ka = jax.random.split(k, 3)
    return (jnambu.draw_adjoint_momentum(kp, dims, gens, nd, C128),
            jnambu.draw_adjoint_momentum(kq, dims, gens, nd, C128),
            jax.random.uniform(ka, (), jnp.float32))


def folded(draw, k, indices):
    """draw(fold_in(k, i)) for each i, from one compiled program."""
    fn = compile_ref(lambda kk, i: draw(jax.random.fold_in(kk, i)), k,
                     np.uint32(0))
    return [fn(k, np.uint32(i)) for i in indices]


@pytest.fixture(scope="module")
def links():
    return random_links(np.random.default_rng(31), JLAT, scale=0.3)


# --- nambu -------------------------------------------------------------------

def test_generators_projection_and_bias():
    g = nambu.su_generators(3)
    assert np.array_equal(g, jnambu.su_generators(3))
    gens = nambu.generators(3, torch.complex128)
    rng = np.random.default_rng(32)
    m = ginibre(rng, (4, 3, 3) + DIMS)
    q = np.array(0.7)
    centers = np.array([0.0, 1.0, 2.0, 0.0])
    counts = np.array([2.0, 1.0, 3.0, 0.0])

    def ref(m_, q_):
        jg = jnp.asarray(jnambu.su_generators(3), C128)
        p = jax.vmap(jgroup.tah)(m_)
        v = jnambu.project_ta(p, jg)
        return (p, v, jnambu.expand_ta(v, jg),
                jnambu.metadynamics_bias(q_, centers, counts, 1.3, 0.8))

    p, v, e, bias = compile_ref(ref, m, q)(m, q)
    close(nambu.project_ta(t(p), gens), v)
    close(nambu.expand_ta(t(v), gens), e)
    close(nambu.expand_ta(t(v), gens), p)
    close(nambu.metadynamics_bias(t(q), t(centers), t(counts), 1.3, 0.8),
          bias)
    # MetaHistory: the same slots and counts as JAX's after the same
    # deposits (a repeated centre, |q| rounding, a full buffer)
    jh = jnambu.MetaHistory(max_slots=3)
    h = nambu.MetaHistory(max_slots=3)
    for qq in (0.4, -1.2, 1.4, 2.6, -2.5, 3.1, 0.1):
        jh.deposit(qq)
        h.deposit(qq)
    assert np.array_equal(h.centers, jh.centers)
    assert np.array_equal(h.counts, jh.counts)
    hc = convert.meta_history_from_reference(jh)
    assert np.array_equal(hc.counts, jh.counts)
    c, w = hc.arrays("cpu")
    assert torch.equal(c, t(jh.centers).double()) and float(w.sum()) == 6


def test_nambu_forces_with_a_stout_guide(links):
    """NambuSystem.forces with a one-step stout guide, both forces by
    autograd (JAX: jax.grad); the trajectory is held to the JAX app's
    own step in test_nambu_hmc_app_against_jax."""
    beta, rho = 5.0, 0.08

    def ref(u):
        jg = jnp.asarray(jnambu.su_generators(3), C128)
        return jnambu.NambuSystem(
            partial(jga.full_action, jga.wilson(beta), JLAT),
            lambda uu: jga.full_action(jga.wilson(beta), JLAT,
                                       jstout(JStout(rho), JLAT, uu)),
            jg).forces(u)

    fd, fg = compile_ref(ref, links)(links)
    sy = nambu.NambuSystem(
        partial(ga.full_action, ga.wilson(beta), LAT),
        lambda uu: ga.full_action(ga.wilson(beta), LAT,
                                  stout_smear(StoutCoefs(rho), LAT, uu)),
        nambu.generators(3, torch.complex128))
    gfd, gfg = sy.forces(convert.gauge_from_reference(links, "cpu",
                                                      torch.complex128))
    close(gfd, fd)
    close(gfg, fg)


# --- rahmc -------------------------------------------------------------------

def run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def _fast_jit(real, seen):
    """A ``jax.jit`` that compiles with XLA's CPU backend optimisation
    off (as ``compile_ref``) and appends each jitted function's name and
    compiled caller to ``seen``."""
    def jit(fn, **kw):
        jitted = real(fn, **kw)
        cache = {}

        def call(*args):
            leaves, tree = jax.tree_util.tree_flatten(args)
            if any(isinstance(x, jax.core.Tracer) for x in leaves):
                return jitted(*args)
            sig = (tree, tuple((np.shape(x), type(x) if np.isscalar(x)
                                else np.asarray(x).dtype) for x in leaves))
            if sig not in cache:
                cache[sig] = jitted.lower(*args).compile(
                    {"xla_backend_optimization_level": 0})
            return cache[sig](*args)
        seen.append((getattr(fn, "__name__", ""), call))
        return call
    return jit


def jax_app_lines(monkeypatch, main, argv, seen=None):
    """A JAX app's output lines, its jits compiled by ``_fast_jit``."""
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", _fast_jit(jax.jit, [] if seen is None
                                        else seen))
        return run_main(main, argv)


def _fields(line):
    """(last word before it, number) for each number of a line; the
    trailing '(x.xx s)' timing dropped."""
    out, tag = [], ""
    for w in line.split("(")[0].split():
        try:
            out.append((tag, float(w)))
        except ValueError:
            tag = w
    return out


def assert_lines_close(got, want, rel_tol):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gf, wf = _fields(g), _fields(w)
        assert [k for k, _ in gf] == [k for k, _ in wf], (g, w)
        assert g.split()[3:5] == w.split()[3:5] or "ACCEPT" not in g, (g, w)
        for (_, a), (_, b) in zip(gf, wf):
            assert abs(a - b) <= rel_tol * max(1.0, abs(b)), (g, w)


def feeder(monkeypatch, module, name, items):
    it = iter(items)
    monkeypatch.setattr(module, name, lambda *a, **k: next(it))


def test_rahmc_app_and_step_against_jax(monkeypatch, links):
    """The JAX app's lines (three RAHMC trajectories; its HMC warm-up is
    the leapfrog hmc_step held to JAX's in tests/test_torch_puregauge.py)
    with its draws injected; its own ra_step on a fresh key to TOL;
    gamma = 0 against the port's leapfrog hmc_step from the same draws;
    the port's app with an HMC warm-up runs."""
    seed, steps, trajs = 34, 2, 3
    args = ["-lat:4,4,4,4", "-beta:5.5", "-gamma:0.3", "-tau:0.5",
            f"-steps:{steps}", f"-trajs:{trajs}", "-hmcUntil:0",
            f"-seed:{seed}", "-cpu:true"]
    seen = []
    want = jax_app_lines(monkeypatch, jrahmc_app.main, args, seen)
    draws = folded(lambda k: j_momenta(k, DIMS), key(seed),
                   range(trajs + 1))
    (p, r) = draws.pop()
    feeder(monkeypatch, rahmc_app, "draw",
           [(t(p), float(r)) for p, r in draws])
    got = run_main(rahmc_app.main, args)
    assert_lines_close([ln for ln in got if ln.startswith("traj")],
                       [ln for ln in want if ln.startswith("traj")], 1e-9)
    assert got[-1] == want[-1]          # the acceptance line
    # the JAX app's own ra_step from a rough start
    ra_step = dict(seen)["ra_step"]
    u1, dH, acc = ra_step(jax.random.fold_in(key(seed), trajs), links)
    c = ga.wilson(5.5)
    act, frc = partial(ga.full_action, c, LAT), partial(ga.gauge_force, c, LAT)
    u = convert.gauge_from_reference(links, "cpu", torch.complex128)
    got_u, gdH, gacc = rahmc_app.ra_step_from(u, t(p), float(r), act, frc,
                                              0.3, 0.5, steps)
    close(got_u, u1)
    assert abs(gdH - float(dH)) <= 1e-10 and gacc == bool(acc)
    # gamma = 0 is leapfrog with `steps` steps (r = 0 always accepts)
    u0, dH0, _ = rahmc_app.ra_step_from(u, t(p), 0.0, act, frc, 0.0, 0.5,
                                        steps)
    ulf, st = hmc.hmc_step_from(u, t(p), 0.0, act, frc,
                                integrators.get_integrator("LF"), 0.5, steps)
    close(u0, ulf)
    assert abs(dH0 - st.dH) <= 1e-12 * max(1.0, abs(st.dH))
    monkeypatch.undo()
    lines = run_main(rahmc_app.main, args[:-3] + ["-trajs:2", "-hmcUntil:1",
                                                  "-cpu:true"])
    assert [ln.split()[2] for ln in lines if ln.startswith("traj")] == \
        ["[HMC]:", "[raHMC]:"]


# --- gauge fixing -------------------------------------------------------------

GAUGES = {"landau": range(4), "coulomb": range(3)}


def random_su3(rng):
    """Haar SU(3) per site by numpy's QR of Ginibre noise (phases fixed,
    determinant divided out): data for a gauge transform."""
    q, r = np.linalg.qr(ginibre(rng, DIMS + (3, 3)))
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / abs(d))[..., None, :]
    q = q / np.linalg.det(q)[..., None, None] ** (1 / 3)
    return np.moveaxis(q, (-2, -1), (0, 1))


@pytest.fixture(scope="module")
def fixed_ref(links):
    """A random gauge transform of smooth links and JAX's Landau and
    Coulomb fixing of it, 5 sweeps (1 polar), in one program."""
    g0 = random_su3(np.random.default_rng(37))

    def ref(u, g):
        uu = jfix.apply_gauge_transform(JLAT, u, g)
        out = {}
        for gauge, dirs in GAUGES.items():
            g, fixed = jfix.gauge_fix(JLAT, uu, gauge=gauge, iters=5)
            out[gauge] = (g, fixed, jfix.functional(JLAT, uu, dirs),
                          jfix.violation(JLAT, uu, dirs),
                          jfix.functional(JLAT, fixed, dirs),
                          jfix.violation(JLAT, fixed, dirs))
        return uu, out

    return compile_ref(ref, links, g0)(links, g0)


@pytest.mark.parametrize("gauge", list(GAUGES))
def test_gauge_fix_against_jax(gauge, fixed_ref):
    uu, out = fixed_ref
    g, fixed, f0, v0, f1, v1 = out[gauge]
    dirs = GAUGES[gauge]
    u = t(uu)
    gg, gfixed = fix.gauge_fix(LAT, u, gauge=gauge, iters=5)
    close(gg, g)
    close(gfixed, fixed)
    close(fix.apply_gauge_transform(LAT, u, gg), fixed)
    for got, want in ((fix.functional(LAT, u, dirs), f0),
                      (fix.violation(LAT, u, dirs), v0),
                      (fix.functional(LAT, gfixed, dirs), f1),
                      (fix.violation(LAT, gfixed, dirs), v1)):
        close(got, want)
    assert float(f1) > float(f0) and float(v1) < float(v0)


# --- numdiff and spline --------------------------------------------------------

def test_numdiff_against_jax():
    a = np.linspace(0.3, 1.7, 5)

    def f_np(x):
        return (np.sin(a * x), np.exp(x) * a[:2])

    def f_t(x):
        ta = torch.from_numpy(a)
        return (torch.sin(ta * x), np.exp(x) * ta[:2])

    for fn in ("ndiff", "ndiff2"):
        want, werr = getattr(jnumdiff, fn)(f_np, 0.4, 0.1)
        got, gerr = getattr(numdiff, fn)(f_t, 0.4, 0.1)
        for g, w in zip(got, want):
            close(g, w)
        assert abs(gerr - werr) <= 1e-12 * max(1.0, werr)
    # a scalar function, and the derivative it should find
    d, err = numdiff.ndiff(lambda x: torch.tensor(np.sin(x)), 0.3, 0.2)
    assert abs(float(d) - np.cos(0.3)) < 1e-10 and err < 1e-8


def test_spline_against_jax():
    x = np.array([0.0, 0.3, 0.7, 1.2, 1.6, 2.5])
    y = np.sin(x) + 0.2 * x
    tt = np.array([-0.1, 0.0, 0.15, 0.7, 1.33, 2.5, 2.7])
    ends = ((None, None), (0.8, -0.5))
    jss = [jspline.cspline(x, y, lo, hi) for lo, hi in ends]
    # one root per spline: the natural one on the knot range, the clamped
    # one on a bracket inside it
    want = compile_ref(lambda s: [(js(s), js.deriv(s), js.solve(0.6)
                                   if i == 0 else js.solve(0.6, 0.1, 1.0))
                                  for i, js in enumerate(jss)], tt)(tt)
    for i, ((lo, hi), js, w) in enumerate(zip(ends, jss, want)):
        sp = spline.cspline(x, y, lo, hi, device="cpu")
        close(sp.y2, js.y2)
        got = (sp(t(tt)), sp.deriv(t(tt)),
               sp.solve(0.6) if i == 0 else sp.solve(0.6, 0.1, 1.0))
        for g_, w_ in zip(got, w):
            close(g_, w_)
    for dx, dy in (([0.1], [0.2]), ([0.1, 0.25], [0.2, 0.45]),
                   ([0.1, 0.2, 0.35], [0.11, 0.19, 0.4])):
        assert spline.estimate_derivative(dx, dy) == \
            jspline.estimate_derivative(dx, dy)


# --- the 4D apps -----------------------------------------------------------------

def test_nambu_hmc_app_against_jax(monkeypatch, links):
    """A hand-force guide (the stout guide's forces are held above), two
    trajectories, the first a forced warm-up, with the JAX draws
    injected; then the JAX app's own step on rough links and a fresh key
    against nambu_hmc_step_from on its draws, to TOL."""
    seed, trajs = 38, 2
    args = ["-lat:4,4,4,4", "-beta:5.5", "-nact:Wilson", "-nbeta:5.0",
            "-tau:0.2", "-steps:2", f"-trajs:{trajs}", f"-seed:{seed}",
            "-cpu:true"]
    seen = []
    want = jax_app_lines(monkeypatch, jnambu_app.main, args, seen)
    jg = jnp.asarray(jnambu.su_generators(3), C128)
    draws = folded(lambda k: j_nambu_draws(k, DIMS, jg), key(seed),
                   range(trajs + 1))
    pi, qi, r = draws.pop()
    with monkeypatch.context() as m:
        feeder(m, nambu, "draw_nambu",
               [(t(p), t(q), float(rr)) for p, q, rr in draws])
        got = run_main(nambu_app.main, args)
    assert_lines_close([ln for ln in got if ln.startswith("traj")],
                       [ln for ln in want if ln.startswith("traj")], 1e-9)
    assert got[-1] == want[-1]
    step = seen[0][1]                   # the app's first jit: its step
    u1, dH, dG, acc = step(jax.random.fold_in(key(seed), trajs), links,
                           False)
    c, cg = ga.wilson(5.5), ga.wilson(5.0)
    sy = nambu.NambuSystem(partial(ga.full_action, c, LAT),
                           partial(ga.full_action, cg, LAT),
                           nambu.generators(3, torch.complex128),
                           target_force=partial(ga.gauge_force, c, LAT),
                           guide_force=partial(ga.gauge_force, cg, LAT))
    u = convert.gauge_from_reference(links, "cpu", torch.complex128)
    gu, gdH, gdG, gacc = nambu.nambu_hmc_step_from(u, t(pi), t(qi), float(r),
                                                   sy, 0.2, 2)
    close(gu, u1)
    assert abs(gdH - float(dH)) <= 1e-10 and abs(gdG - float(dG)) <= 1e-10
    assert gacc == bool(acc)


def test_nambu_hmc_app_metadynamics_runs():
    """The TopoCloverStoutMeta guide (autograd through a stout step and
    the clover charge): lines parse, numbers finite."""
    lines = run_main(nambu_app.main, [
        "-lat:4,4,4,4", "-nact:TopoCloverStoutMeta", "-nstout:1",
        "-tau:0.2", "-steps:2", "-trajs:2", "-cpu:true"])
    rows = [_fields(ln) for ln in lines if ln.startswith("traj")]
    assert len(rows) == 2
    assert all(np.isfinite(v) for row in rows for _, v in row)


@pytest.mark.parametrize("main", [nambu_app.main, rahmc_app.main])
def test_apps_raise_without_a_card(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-lat:4,4,4,4", "-trajs:1"])
