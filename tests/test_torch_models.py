"""The spin models and compact U(1) of qex_tpu_torch against qex_tpu
(float64 on the CPU): models.xy (energy, magnetization, local field,
spin flow, the von Mises sampler, heatbath, Metropolis and Wolff fed the
JAX functions' own draws), models.clock (with JAX's float32 angles
lifted to float64 while it is traced), models.u1 (action, plaquette,
charge, analytic force, staples, max_tree_mask in 2D and 3D, flow,
over-relaxation, heatbath and hmc_step on LF, 2MN and a force-gradient
scheme), hmc.qnhmc (the ring buffer, qn_prep's operators and
qn_hmc_step), short port-only chains with the JAX tests' bounds, and
the apps xy_mc, u1_mc and u1_qn_hmc against the JAX apps' lines with
the JAX draws injected.  Every deterministic function and every
stochastic core fed JAX's draws agrees to TOL (relative); each JAX
reference is compiled once (``_torch_helpers.compile_ref``)."""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import iv

from _torch_helpers import compile_ref, n, single_threaded, t  # noqa: F401
from qex_tpu.apps import u1_mc as ju1_app
from qex_tpu.apps import u1_qn_hmc as jqn_app
from qex_tpu.apps import xy_mc as jxy_app
from qex_tpu.hmc import qnhmc as jqn
from qex_tpu.models import clock as jclock
from qex_tpu.models import u1 as ju1
from qex_tpu.models import xy as jxy
from qex_tpu_torch import convert
from qex_tpu_torch.apps import u1_mc as u1_app
from qex_tpu_torch.apps import u1_qn_hmc as qn_app
from qex_tpu_torch.apps import xy_mc as xy_app
from qex_tpu_torch.hmc import qnhmc
from qex_tpu_torch.models import clock, u1, xy

TOL = 1e-12
SHAPE2 = (8, 6)
pytestmark = pytest.mark.usefixtures("single_threaded")


def close(got, ref, tol=TOL):
    got = n(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(np.linalg.norm(ref), 1e-300)
    assert np.linalg.norm(got - ref) <= tol * scale, (got, ref)


def angles(seed, shape):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, shape)


def key(i):
    return jax.random.PRNGKey(i)


# --- JAX's draws, split as the JAX functions split their keys -----------------

def j_vm(k, shape):
    """qex_tpu.models.xy._sample_von_mises's draws: theta0 and 32
    proposals of (u1, u2, u3)."""
    k, ku = jax.random.split(k)
    theta0 = jax.random.uniform(ku, shape, minval=-jnp.pi, maxval=jnp.pi)

    def body(kk, _):
        kk, k1, k2, k3 = jax.random.split(kk, 4)
        return kk, jnp.stack([jax.random.uniform(k_, shape)
                              for k_ in (k1, k2, k3)])

    _, us = jax.lax.scan(body, k, None, length=xy.VM_ITERS)
    return theta0, us


def j_vm_stack(k, shape, count):
    """``count`` sampler calls, each on the next split of k."""
    th0, us = [], []
    for _ in range(count):
        k, kk = jax.random.split(k)
        a, b = j_vm(kk, shape)
        th0.append(a)
        us.append(b)
    return jnp.stack(th0), jnp.stack(us)


def vm_draws(pair):
    return xy.VonMisesDraws(t(pair[0]), t(pair[1]))


def j_xy_metropolis(k, shape):
    props, accs = [], []
    for _ in (0, 1):
        k, k1, k2 = jax.random.split(k, 3)
        props.append(jax.random.uniform(k1, shape, minval=-1.0, maxval=1.0))
        accs.append(jax.random.uniform(k2, shape))
    return jnp.stack(props), jnp.stack(accs)


def j_wolff(k, shape):
    _, ka, ks, kb = jax.random.split(k, 4)
    alpha = jax.random.uniform(ka, (), minval=0.0, maxval=2 * jnp.pi)
    keys = jax.random.split(kb, len(shape))
    bonds = jnp.stack([jax.random.uniform(keys[mu], shape)
                       for mu in range(len(shape))])
    seed = jax.random.randint(ks, (), 0, math.prod(shape))
    return alpha, seed, bonds


def wolff_draws(d):
    return float(d[0]), int(d[1]), t(d[2])


def j_hmc(k, shape, dtype=jnp.float64):
    _, kp, ka = jax.random.split(k, 3)
    return (jax.random.normal(kp, shape, dtype),
            jax.random.uniform(ka, (), dtype))


def j_qn(k, shape, m, dtype=jnp.float64):
    kp, ka = jax.random.split(k)
    kq, kz = jax.random.split(kp)
    return (jax.random.normal(kq, shape, dtype),
            jax.random.normal(kz, (m,), dtype),
            jax.random.uniform(ka, (), dtype))


# --- xy ------------------------------------------------------------------------

def test_xy_deterministic():
    shape = SHAPE2
    th = angles(1, shape)

    def ref(x):
        return (jxy.energy(x, 1.3), jxy.magnetization(x),
                jxy._local_field(x), jxy.spin_flow(x, 0.05, 4),
                jxy._parity_mask(shape))

    e, (m, a), (hm, ha), fl, par = compile_ref(ref, th)(th)
    close(xy.energy(t(th), 1.3), e)
    mg, ang = xy.magnetization(t(th))
    close(mg, m)
    close(ang, a)
    ghm, gha = xy._local_field(t(th))
    close(ghm, hm)
    close(gha, ha)
    close(xy.spin_flow(t(th), 0.05, 4), fl)
    assert np.array_equal(n(xy._parity_mask(shape)), np.asarray(par))


def test_xy_heatbath_from_jax_draws():
    th = angles(2, SHAPE2)
    beta = 1.1
    want, draws = compile_ref(lambda k, x: (
        jxy.heatbath_sweep(k, x, beta), j_vm_stack(k, x.shape, 2)),
        key(3), th)(key(3), th)
    close(xy.heatbath_sweep_from(t(th), beta, vm_draws(draws)), want)


def test_xy_von_mises_cap_and_small_kappa():
    """No accepted proposal in VM_ITERS keeps theta0, and so does kappa
    below 1e-6 (the uniform distribution's sample); a site whose only
    acceptable proposal is the last takes it."""
    kap = torch.tensor([2.0, 2.0, 2.0, 5e-7, 0.0], dtype=torch.float64)
    th0 = torch.tensor([0.1, -0.2, 0.3, 0.4, -0.5], dtype=torch.float64)
    u = torch.full((xy.VM_ITERS, 3, 5), 0.25, dtype=torch.float64)
    u[:, 2] = 0.75
    u[:, 1, :3] = 1.0 - 1e-12                # reject every proposal
    u[-1, 1, 2] = 0.0                        # but the last at site 2
    out = xy.sample_von_mises_from(kap, th0, u)
    assert torch.equal(out[[0, 1, 3, 4]], th0[[0, 1, 3, 4]])
    assert out[2] != th0[2] and abs(float(out[2])) <= math.pi


def test_xy_metropolis_from_jax_draws():
    th = angles(5, SHAPE2)
    run = compile_ref(lambda k, x: (jxy.metropolis_sweep(k, x, 0.9, 0.8),
                                    j_xy_metropolis(k, x.shape)), key(6), th)
    (want, acc), (prop, acc_u) = run(key(6), th)
    got, gacc = xy.metropolis_sweep_from(t(th), 0.9, 0.8, t(prop), t(acc_u))
    close(got, want)
    close(gacc, acc)


@pytest.fixture(scope="module")
def wolff_ref():
    """JAX's Wolff updates of one correlated configuration (clusters
    neither trivial nor the whole lattice) on six keys, with the draws
    each split off."""
    th = 0.6 * angles(7, SHAPE2)
    run = compile_ref(lambda k, x: (jxy.wolff_update(k, x, 0.8),
                                    j_wolff(k, x.shape)), key(8), th)
    return th, [run(key(i), th) for i in range(8, 14)]


@pytest.mark.parametrize("check_every", [1, 3])
def test_xy_wolff_from_jax_draws(check_every, wolff_ref):
    th, runs = wolff_ref
    fracs = []
    for (want, frac), d in runs:
        got, gfrac = xy.wolff_update_from(t(th), 0.8, *wolff_draws(d),
                                          check_every=check_every)
        close(got, want)
        # JAX's fraction is a float32 mean: compare the cluster sizes
        assert round(float(gfrac) * 48) == round(float(frac) * 48)
        fracs.append(float(frac))
    assert 1 < len(set(fracs)) and max(fracs) < 1.0, fracs


def test_xy_wolff_cluster_is_the_connected_component():
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    gen = torch.Generator().manual_seed(3)
    shape = (16, 12)
    th = 0.8 * (2 * torch.rand(shape, generator=gen, dtype=torch.float64)
                - 1) * math.pi
    idx = np.arange(math.prod(shape)).reshape(shape)
    for rep in range(4):
        alpha, seed, bond_u = xy.draw_wolff(gen, th)
        bonds = xy.frozen_bonds(torch.cos(th - alpha), 1.0, bond_u)
        mask, sweeps = xy.wolff_cluster(bonds, seed, check_every=2)
        b = n(bonds)
        rows = np.concatenate([idx[b[mu]] for mu in range(2)])
        cols = np.concatenate([np.roll(idx, -1, mu)[b[mu]]
                               for mu in range(2)])
        g = coo_matrix((np.ones(len(rows)), (rows, cols)),
                       shape=(idx.size, idx.size))
        _, lab = connected_components(g, directed=False)
        want = (lab == lab.reshape(-1)[seed]).reshape(shape)
        assert np.array_equal(n(mask), want), rep
        one, _ = xy.wolff_cluster(bonds, seed, check_every=1)
        assert torch.equal(one, mask) and sweeps >= 2


# --- clock ---------------------------------------------------------------------

class _JnpF64:
    """jax.numpy with float32 read as float64: JAX's clock model forms
    its angles in float32; lifted, it is held to the port at TOL."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def clock64(monkeypatch):
    monkeypatch.setattr(jclock, "jnp", _JnpF64())


def test_clock_from_jax_draws(clock64):
    nst = 6
    k0 = np.random.default_rng(9).integers(0, nst, SHAPE2).astype(np.int32)
    beta = 1.2

    def ref(kk, s):
        gum = []
        k2 = kk
        for _ in (0, 1):
            k2, k3 = jax.random.split(k2)
            gum.append(jax.random.gumbel(k3, s.shape + (nst,), jnp.float64))
        props, accs = [], []
        k2 = kk
        for _ in (0, 1):
            k2, ka, kb = jax.random.split(k2, 3)
            props.append(jax.random.randint(ka, s.shape, 0, nst,
                                            dtype=s.dtype))
            accs.append(jax.random.uniform(kb, s.shape))
        return (jclock.heatbath_sweep(kk, s, beta, nst),
                jclock.metropolis_sweep(kk, s, beta, nst),
                jclock.energy(s, beta, nst), jclock.magnetization(s, nst),
                jnp.stack(gum), jnp.stack(props), jnp.stack(accs))

    hb, (mp, macc), e, m, gum, props, accs = \
        compile_ref(ref, key(10), k0)(key(10), k0)
    s = convert.field_from_reference(k0, "cpu")
    assert s.dtype == torch.int32
    assert torch.equal(clock.heatbath_sweep_from(s, beta, nst, t(gum)),
                       t(hb))
    got, gacc = clock.metropolis_sweep_from(s, beta, nst, t(props), t(accs))
    assert torch.equal(got, t(mp))
    close(gacc, macc)
    close(clock.energy(s, beta, nst), e)
    close(clock.magnetization(s, nst), m)


# --- u1 -----------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(6, 4), (4, 3, 5)])
def test_u1_deterministic(dims):
    nd = len(dims)
    th = angles(11, (nd,) + dims)

    def ref(x):
        out = (ju1.action(x, 1.7), ju1.plaquette(x), ju1.topo_charge(x),
               ju1.force(x, 1.7),
               jnp.stack([ju1.staple_sum(x, mu) for mu in range(nd)]),
               ju1.max_tree_mask(dims))
        # the sweeps built on the staples and the force: 2D only
        return out + ((ju1.over_relax_sweep(x), ju1.gauge_flow(x, 0.05, 1))
                      if nd == 2 else ())

    want = compile_ref(ref, th)(th)
    x = t(th)
    close(u1.action(x, 1.7), want[0])
    close(u1.plaquette(x), want[1])
    close(u1.topo_charge(x), want[2])
    close(u1.force(x, 1.7), want[3])
    close(torch.stack([u1.staple_sum(x, mu) for mu in range(nd)]), want[4])
    assert np.array_equal(n(u1.max_tree_mask(dims)), np.asarray(want[5]))
    if nd == 2:
        close(u1.over_relax_sweep(x), want[6])
        close(u1.gauge_flow(x, 0.05, 1), want[7])


def test_u1_heatbath_from_jax_draws():
    dims = (6, 4)
    th = angles(12, (2,) + dims)
    # (over-relaxation is held to JAX's in test_u1_deterministic)
    run = compile_ref(lambda k, x: (ju1.heatbath_sweep(k, x, 2.0,
                                                       over_relax=0),
                                    j_vm_stack(k, dims, 4)), key(13), th)
    want, draws = run(key(13), th)
    close(u1.heatbath_sweep_from(t(th), 2.0, vm_draws(draws), over_relax=0),
          want)


@pytest.mark.parametrize("dims,scheme,gfix", [
    ((6, 4), "LF", False), ((6, 4), "2MN", True), ((6, 4), "FGI", False)])
def test_u1_hmc_step_from_jax_draws(dims, scheme, gfix):
    nd = len(dims)
    th = angles(14, (nd,) + dims)

    steps = 2 if scheme == "FGI" else 3

    def ref(k, x):
        return ju1.hmc_step(k, x, 1.0, 0.5, steps, scheme, gfix=gfix), \
            j_hmc(k, x.shape)

    (want, stats), (p, r) = compile_ref(ref, key(15), th)(key(15), th)
    x = convert.field_from_reference(th, "cpu")
    got, gst = u1.hmc_step_from(x, t(p), float(r), 1.0, 0.5, steps, scheme,
                                gfix=gfix)
    close(got, want)
    assert gst["accept"] == bool(stats["accept"])
    assert abs(gst["dH"] - float(stats["dH"])) <= 1e-10
    for k in ("plaq", "topo"):
        close(gst[k], float(stats[k]))
    if gfix:
        tree = n(u1.max_tree_mask(dims))
        assert np.array_equal(n(got)[tree], th[tree])


@pytest.mark.parametrize("dims", [(6, 5), (4, 3, 5)])
def test_u1_max_tree_fix(dims):
    """The port's maxTreeFix (the JAX package has only the mask): a gauge
    transform, so every plaquette angle is kept mod 2 pi, that zeroes
    every tree link."""
    nd = len(dims)
    th = convert.field_from_reference(angles(24, (nd,) + dims), "cpu",
                                      torch.float64)
    fixed = u1.max_tree_fix(th)
    assert float(fixed[u1.max_tree_mask(dims)].abs().max()) < 1e-13
    for mu, nu in u1._planes(nd):
        d = u1.plaq_angle(fixed, mu, nu) - u1.plaq_angle(th, mu, nu)
        assert float(torch.sin(d).abs().max()) < 1e-13
    close(u1.action(fixed, 1.3), float(u1.action(th, 1.3)))


# --- qnhmc ---------------------------------------------------------------------

QN_SHAPE = (2, 4, 4)


def j_qn_state(m_buf=3, pairs=5):
    """A JAX ring buffer that wrapped (pairs > m_buf) on an SPD
    quadratic model, one pair overwritten through qn_set with an
    indefinite pair (stored invalid)."""
    rng = np.random.default_rng(16)
    dof = math.prod(QN_SHAPE)
    r = rng.normal(size=(dof, dof))
    a = r @ r.T / dof + 0.5 * np.eye(dof)

    def f(x):
        return (a @ x.ravel()).reshape(QN_SHAPE)

    xs = rng.normal(size=(pairs + 1,) + QN_SHAPE)
    st = jqn.qn_init(m_buf, QN_SHAPE, h0=0.7)
    for i in range(pairs):
        st = jqn.qn_add(st, xs[i], f(xs[i]), xs[i + 1], f(xs[i + 1]),
                        yscale=0.5)
    st = jqn.qn_set(st, 1, xs[0], f(xs[0]), xs[1], -f(xs[1]) - 10.0)
    return st


def test_qn_ring_buffer_and_operators():
    """The ring buffer (a wrapped buffer, qn_set, an indefinite pair
    stored invalid) and qn_prep's operators with an exclude mask;
    qn_hmc_step is held to the JAX app's own step in
    test_u1_qn_hmc_app_against_jax."""
    jst = j_qn_state()
    st = convert.qn_state_from_reference(jst, "cpu")
    assert st.pos == int(jst.pos) == 5 and st.m == 3
    assert np.array_equal(n(st.valid), np.asarray(jst.valid))
    assert not bool(st.valid[1])
    # the port's qn_add / qn_set on the same pairs give the same buffer
    rng = np.random.default_rng(17)
    a, b, c, d = (rng.normal(size=QN_SHAPE) for _ in range(4))
    jst2 = jqn.qn_set(jqn.qn_add(jst, a, b, c, d), 5, c, d, a, b, cutoff=0.1)
    st2 = qnhmc.qn_set(qnhmc.qn_add(st, t(a), t(b), t(c), t(d)), 5, t(c),
                       t(d), t(a), t(b), cutoff=0.1)
    assert st2.pos == int(jst2.pos)
    assert np.array_equal(n(st2.valid), np.asarray(jst2.valid))
    close(st2.s, jst2.s)
    close(st2.y, jst2.y)
    ex = np.array([False, True, True])
    v = rng.normal(size=QN_SHAPE)
    z = rng.normal(size=(3,))

    def ref(s_, v_, z_):
        ops = jqn.qn_prep(s_, exclude=jnp.asarray(ex))
        return (ops.s, ops.y, ops.w, ops.rho, ops.c, ops.apply_m(v_),
                ops.apply_minv(v_), ops.push_noise(v_, z_), ops.kinetic(v_))

    want = compile_ref(ref, jst2, v, z)(jst2, v, z)
    ops = qnhmc.qn_prep(st2, exclude=torch.from_numpy(ex))
    got = (ops.s, ops.y, ops.w, ops.rho, ops.c, ops.apply_m(t(v)),
           ops.apply_minv(t(v)), ops.push_noise(t(v), t(z)),
           ops.kinetic(t(v)))
    for g, w in zip(got, want):
        close(g, w)
    close(ops.apply_minv(ops.apply_m(t(v))), v, 1e-9)


# --- short port-only chains (the JAX tests' bounds) ---------------------------

def _chain(update, theta, count):
    for _ in range(count):
        out = update(theta)
        theta = out[0] if isinstance(out, tuple) else out
    return theta


@pytest.mark.parametrize("algo", ["heatbath", "metropolis", "wolff"])
def test_xy_chain_ordered_phase(algo):
    gen = torch.Generator().manual_seed(1)
    beta = 2.0
    th = (2 * torch.rand((16, 16), generator=gen, dtype=torch.float64)
          - 1) * math.pi
    hb = lambda x: xy.heatbath_sweep(gen, x, beta)  # noqa: E731
    if algo == "heatbath":
        th = _chain(hb, th, 60)
    elif algo == "metropolis":
        th = _chain(lambda x: xy.metropolis_sweep(gen, x, beta, 0.8), th, 150)
    else:
        th = _chain(hb, th, 10)
        th = _chain(lambda x: xy.wolff_update(gen, x, beta), th, 60)
    assert float(xy.magnetization(th)[0]) > 0.5, algo


def test_xy_chain_disordered_and_energy_agreement():
    gen = torch.Generator().manual_seed(2)
    th = _chain(lambda x: xy.heatbath_sweep(gen, x, 0.3),
                torch.zeros((16, 16), dtype=torch.float64), 80)
    assert float(xy.magnetization(th)[0]) < 0.4
    beta = 1.0
    th0 = (2 * torch.rand((12, 12), generator=gen, dtype=torch.float64)
           - 1) * math.pi

    def measure(update, therm, count):
        x = _chain(update, th0, therm)
        es = []
        for _ in range(count):
            x = _chain(update, x, 1)
            es.append(float(xy.energy(x, beta)))
        return np.mean(es), np.std(es) / np.sqrt(len(es))

    e1, s1 = measure(lambda x: xy.heatbath_sweep(gen, x, beta), 40, 60)
    e2, s2 = measure(lambda x: xy.metropolis_sweep(gen, x, beta, 0.8),
                     120, 180)
    assert abs(e1 - e2) < 5 * np.hypot(s1, s2) + 0.02 * abs(e1), (e1, e2)


def test_clock_chain_phases():
    gen = torch.Generator().manual_seed(3)
    nst = 6
    k0 = torch.randint(nst, (16, 16), generator=gen)
    s = _chain(lambda x: clock.heatbath_sweep(gen, x, 2.0, nst), k0, 60)
    assert float(clock.magnetization(s, nst)) > 0.5
    s = _chain(lambda x: clock.heatbath_sweep(gen, x, 0.3, nst), k0, 60)
    assert float(clock.magnetization(s, nst)) < 0.4

    def measure(update, therm, count):
        x = _chain(update, k0, therm)
        es = []
        for _ in range(count):
            x = _chain(update, x, 1)
            es.append(float(clock.energy(x, 1.0, nst)))
        return np.mean(es), np.std(es) / np.sqrt(len(es))

    e1, s1 = measure(lambda x: clock.heatbath_sweep(gen, x, 1.0, nst), 40, 60)
    e2, s2 = measure(lambda x: clock.metropolis_sweep(gen, x, 1.0, nst),
                     120, 180)
    assert abs(e1 - e2) < 5 * np.hypot(s1, s2) + 0.02 * abs(e1), (e1, e2)


def test_u1_chains_plaquette_exact():
    """<plaq> = I1(beta)/I0(beta) in 2D: heatbath (L=16, beta 2) and HMC
    (L=8, beta 1), and the heatbath changes topological sector at beta
    0.5."""
    gen = torch.Generator().manual_seed(4)
    beta = 2.0
    th = u1.random_field(gen, (2, 16, 16))
    vals = []
    for it in range(40):
        th = u1.heatbath_sweep(gen, th, beta)
        if it >= 10:
            vals.append(float(u1.plaquette(th).real))
    assert abs(np.mean(vals) - iv(1, beta) / iv(0, beta)) < 0.02
    th = u1.random_field(gen, (2, 8, 8))
    vals, acc = [], 0
    for it in range(80):
        th, st = u1.hmc_step(gen, th, 1.0, 1.0, 8)
        acc += st["accept"]
        if it >= 20:
            vals.append(st["plaq"])
    assert acc / 80 > 0.7
    assert abs(np.mean(vals) - iv(1, 1.0) / iv(0, 1.0)) < 0.04
    th = u1.random_field(gen, (2, 8, 8))
    qs = set()
    for _ in range(20):
        th = u1.heatbath_sweep(gen, th, 0.5)
        q = float(u1.topo_charge(th))
        assert abs(q - round(q)) < 1e-9
        qs.add(round(q))
    assert len(qs) >= 2


def test_qn_chain_plaquette_and_frozen_tree():
    gen = torch.Generator().manual_seed(5)
    beta, L = 1.0, 6
    tree = u1.max_tree_mask((L, L))
    xs = [torch.where(tree, 0.0, u1.random_field(gen, (2, L, L)))]
    for _ in range(7):
        xs.append(u1.hmc_step(gen, xs[-1], beta, 1.0, 8, gfix=True)[0])
    st = qnhmc.qn_init(6, (2, L, L))

    def mgrad(x):
        return torch.where(tree, 0.0, u1.force(x, beta))

    for i in range(6):
        st = qnhmc.qn_add(st, xs[i], mgrad(xs[i]), xs[i + 1],
                          mgrad(xs[i + 1]), yscale=1.0 / (2 * beta))
    ops = qnhmc.qn_prep(st)
    x, vals, acc = xs[-1], [], 0
    for it in range(60):
        x, stt = qnhmc.qn_hmc_step(gen, x, ops, lambda y: u1.action(y, beta),
                                   lambda y: u1.force(y, beta), 1.0, 10,
                                   mask=tree)
        acc += stt["accept"]
        if it >= 15:
            vals.append(float(u1.plaquette(x).real))
    assert torch.equal(x[tree], xs[-1][tree])
    assert acc / 60 > 0.6
    assert abs(np.mean(vals) - iv(1, beta) / iv(0, beta)) < 0.06


# --- the apps -----------------------------------------------------------------

def _fast_jit(real, seen):
    """A ``jax.jit`` that compiles with XLA's CPU backend optimisation
    off, as ``compile_ref`` does (the JAX apps' programs run a few times
    on tiny lattices, where compiling dominates); calls made while
    another function is traced go through the plain jit.  Appends each
    jitted function's name and caller to ``seen``."""
    def jit(fn, static_argnums=(), **kw):
        jitted = real(fn, static_argnums=static_argnums, **kw)
        static = ((static_argnums,) if isinstance(static_argnums, int)
                  else tuple(static_argnums))
        cache = {}

        def call(*args):
            dyn = tuple(a for i, a in enumerate(args) if i not in static)
            leaves, tree = jax.tree_util.tree_flatten(dyn)
            if any(isinstance(x, jax.core.Tracer) for x in leaves):
                return jitted(*args)
            sig = (tuple(args[i] for i in static), tree,
                   tuple((np.shape(x), type(x) if np.isscalar(x)
                          else np.asarray(x).dtype) for x in leaves))
            if sig not in cache:
                cache[sig] = jitted.lower(*args).compile(
                    {"xla_backend_optimization_level": 0})
            return cache[sig](*dyn)
        seen.append((getattr(fn, "__name__", ""), call))
        return call
    return jit


def jax_app_lines(monkeypatch, main, argv, seen=None):
    """A JAX app's output lines, its jits compiled by ``_fast_jit``."""
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", _fast_jit(jax.jit, [] if seen is None
                                        else seen))
        return run_main(main, argv)


def run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def meas_lines(lines, prefix="MEAS"):
    return [ln for ln in lines if ln.startswith(prefix)]


def folded(draw, k, indices):
    """draw(fold_in(k, i)) for each i, from one compiled program."""
    fn = compile_ref(lambda kk, i: draw(jax.random.fold_in(kk, i)), k,
                     np.uint32(0))
    return [fn(k, np.uint32(i)) for i in indices]


def feeder(monkeypatch, module, name, items):
    """Swap ``module.name`` for a function returning ``items`` in turn."""
    it = iter(items)
    monkeypatch.setattr(module, name, lambda *a, **k: next(it))


@pytest.mark.parametrize("algo", ["wolff"])
def test_xy_mc_app_against_jax(algo, monkeypatch):
    """(The heatbath's and Metropolis's cores are held to JAX's on their
    own draws above.)"""
    L, seed, sweeps = 8, 21, 4
    args = [f"-L:{L}", "-beta:1.1", f"-algo:{algo}", f"-sweeps:{sweeps}",
            "-meas:2", "-flowTime:0.1", "-flowDt:0.05", f"-seed:{seed}",
            "-cpu:true"]
    want = meas_lines(jax_app_lines(monkeypatch, jxy_app.main, args))
    draw = {"metropolis": lambda k: j_xy_metropolis(k, (L, L)),
            "wolff": lambda k: j_wolff(k, (L, L))}[algo]

    th0 = compile_ref(lambda k: jax.random.uniform(
        k, (L, L), minval=-3.14159, maxval=3.14159), key(seed))(key(seed))
    draws = folded(draw, key(seed), range(1, sweeps + 1))
    name, conv = {"metropolis": ("draw_metropolis",
                                 lambda d: tuple(t(a) for a in d)),
                  "wolff": ("draw_wolff", wolff_draws)}[algo]
    feeder(monkeypatch, xy, name, [conv(d) for d in draws])
    monkeypatch.setattr(xy_app, "initial_spins", lambda *a: t(th0))
    got = meas_lines(run_main(xy_app.main, args))
    assert len(got) == 2 and got == want


def _fields(line):
    """(last word before it, number) for each number of a MEAS line."""
    out, tag = [], ""
    for w in line.split():
        try:
            out.append((tag, float(w)))
        except ValueError:
            tag = w
    return out


def assert_lines_close(got, want, rel_tol, dh_tol=None):
    """Each number of each line within rel_tol relative (absolute below
    1), dH within dh_tol absolute when given; the words equal."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gf, wf = _fields(g), _fields(w)
        assert [k for k, _ in gf] == [k for k, _ in wf], (g, w)
        for (k, a), (_, b) in zip(gf, wf):
            tol = dh_tol if (k == "dH" and dh_tol) else \
                rel_tol * max(1.0, abs(b))
            assert abs(a - b) <= tol, (g, w)


def test_u1_mc_app_against_jax(monkeypatch):
    """The JAX app runs float32 angles; the port's app does too, so the
    lines agree to float32 rounding (relative 1e-5; dH, a difference of
    float32 actions in the JAX app, to 1e-4 absolute).  (The heatbath's
    core is held to JAX's on its own draws above.)"""
    L, seed, n_it = 8, 22, 3
    args = [f"-L:{L}", "-beta:2.0", "-algo:hmc", f"-trajs:{n_it}",
            "-tau:0.5", "-steps:2", f"-seed:{seed}", "-cpu:true"]
    want = meas_lines(jax_app_lines(monkeypatch, ju1_app.main, args))
    shape = (2, L, L)
    th0 = compile_ref(lambda k: ju1.random_field(k, shape, jnp.float32),
                      key(seed))(key(seed))
    draws = folded(lambda k: j_hmc(k, shape, jnp.float32), key(seed),
                   range(1, n_it + 1))
    feeder(monkeypatch, u1, "random_field", [t(th0)])
    feeder(monkeypatch, u1, "draw_hmc", [(t(p), float(r)) for p, r in draws])
    got = meas_lines(run_main(u1_app.main, args))
    assert len(got) == n_it
    assert_lines_close(got, want, 1e-5, dh_tol=1e-4)


def test_u1_qn_hmc_app_against_jax(monkeypatch):
    """QN from the first sweep (the plain sweeps' hmc_step is held above),
    the JAX draws injected; then the JAX app's own prep and QN step, on
    pairs near a tree-fixed field and a fresh key, against qn_prep and
    qn_hmc_step_from on its draws, to TOL."""
    L, seed, nstream, trajs, qnbegin = 6, 23, 2, 3, 1
    beta, tau, steps = 2.0, 0.4, 2
    args = [f"-L:{L}", f"-beta:{beta}", f"-trajs:{trajs}",
            f"-qnbegin:{qnbegin}", f"-nstream:{nstream}", f"-tau:{tau}",
            f"-steps:{steps}", f"-seed:{seed}", "-cpu:true"]
    seen = []
    want = jax_app_lines(monkeypatch, jqn_app.main, args, seen)
    shape = (2, L, L)
    inits = folded(lambda k: ju1.random_field(k, shape, jnp.float64),
                   key(seed), range(nstream))
    split = qnbegin * nstream
    qn = folded(lambda k: j_qn(k, shape, nstream), key(seed + 1),
                list(range(split, (trajs + 1) * nstream)) + [999])
    q1, z1, r1 = qn.pop()
    with monkeypatch.context() as m:
        feeder(m, u1, "random_field", [t(a) for a in inits])
        feeder(m, qnhmc, "draw_qn",
               [(t(q), t(z), float(r)) for q, z, r in qn])
        got = run_main(qn_app.main, args)
    # float64 on both sides: the printed digits, but for the charge, a
    # float64 sum of angles whose value is an integer (JAX prints its
    # rounding, e.g. -2.8e-16, where the port's sum gives 0)
    assert_lines_close(meas_lines(got), meas_lines(want), 1e-12)
    assert len(meas_lines(got)) == trajs * nstream
    assert "# STARTING QN updates" in got
    lambdas = [c for name, c in seen if name == "<lambda>"]
    step, prep = lambdas[1], lambdas[2]  # plain, qn_step, prep, meas, ..
    rng = np.random.default_rng(25)
    tree = n(u1.max_tree_mask((L, L)))
    x = angles(26, shape) * ~tree
    xs = [t(x + 0.1 * rng.normal(size=shape) * ~tree) for _ in range(4)]
    fy = [n(u1.force(xx, beta)) for xx in xs]
    sy = np.stack([n(xs[2 * i + 1] - xs[2 * i]) for i in range(2)])
    yy = np.stack([(fy[2 * i + 1] - fy[2 * i]) / (2 * beta)
                   for i in range(2)])
    jst = jqn.QNState(sy, yy, np.ones(2, bool), np.asarray(1, np.int32),
                      1.0)
    ex = np.array([True, False])
    x_new, stats = step(jax.random.fold_in(key(seed + 1), 999), x,
                        prep(jst, ex))
    got, gst = qnhmc.qn_hmc_step_from(
        t(x), t(q1), t(z1), float(r1),
        qnhmc.qn_prep(convert.qn_state_from_reference(jst, "cpu"),
                      exclude=torch.from_numpy(ex)),
        lambda y: u1.action(y, beta), lambda y: u1.force(y, beta), tau,
        steps, mask=torch.from_numpy(tree))
    close(got, x_new)
    assert gst["accept"] == bool(stats["accept"])
    assert abs(gst["dH"] - float(stats["dH"])) <= 1e-10


def test_port_app_options():
    """The port's own options: xy_mc's algorithm sequence from an ordered
    start (a segment per algorithm, on one field), u1_mc's and
    u1_qn_hmc's heatbath-thermalized starts (tree-fixed in the latter)."""
    lines = run_main(xy_app.main, ["-L:6", "-algo:heatbath,wolff",
                                   "-sweeps:2", "-meas:1", "-start:ordered",
                                   "-cpu:true"])
    assert [ln for ln in lines if ln.startswith("# algo")] == \
        ["# algo heatbath", "# algo wolff"]
    assert len(meas_lines(lines)) == 4
    lines = run_main(qn_app.main, ["-L:4", "-trajs:2", "-qnbegin:2",
                                   "-nstream:2", "-steps:2", "-therm:2",
                                   "-cpu:true"])
    assert len(meas_lines(lines)) == 4
    lines = run_main(u1_app.main, ["-L:4", "-algo:hmc", "-trajs:2",
                                   "-therm:2", "-steps:2", "-cpu:true"])
    assert len(meas_lines(lines)) == 2


@pytest.mark.parametrize("main,argv", [
    (xy_app.main, ["-L:4", "-sweeps:1"]),
    (u1_app.main, ["-L:4", "-trajs:1"]),
    (qn_app.main, ["-L:4", "-trajs:1"])])
def test_apps_raise_without_a_card(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
