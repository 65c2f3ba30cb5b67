"""The eigensolver tier of qex_tpu_torch against qex_tpu (complex128).

Start vectors: both packages draw them from a seed, by generators that
differ (threefry in JAX, torch's in the port), so each test here puts
JAX's own draw for that seed into the port (``inject_jax_starts``); the
two then run the same arithmetic.

The drivers run on dense hermitian (and, for the SVD, rectangular)
operators: ``lanczos_hermitian`` alpha, beta and V to 1e-12 from one v0;
``eigs_hermitian`` and ``eigs_hermitian_dev`` (one driver in the port)
eigenvalues to 1e-10;
``chebyshev_filter`` of one vector to 1e-12; ``estimate_spectral_range``
(host and device) to 1e-10; ``eigs_filtered`` (host and device)
eigenvalues to 1e-9; ``rr_refine_dev`` and ``refine_inverse_dev`` to
1e-9; ``svd_lanczos`` and ``svd_lanczos_dev`` to 1e-10;
``deflated_cg`` to 1e-10 and ``deflation_pays`` identically.

At 4^4: ``stag_eigs`` (plain, and naik with ``links=``) to 1e-9 and
``svd_stag`` to 1e-10 against the exact spectrum of the JAX package's
own operators (``staggered.d2dd``, ``d2dd3``, ``dslash_eo``) as dense
matrices; JAX's ``stag_eigs`` and ``svd_stag`` drive those operators
through the host loops held above, and at this size take 5-8 s each,
mostly dispatching eager ops.  ``StagRootedFermion.calibrate_spectral_
range`` against JAX's to 1e-9.  The card's side is in
tests/test_torch_eigens_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, ginibre, n, random_links, rel,
                            single_threaded, t)
from qex_tpu.eigens import chebyshev as jcheb
from qex_tpu.eigens import hisqev as jhisqev
from qex_tpu.eigens import lanczos as jlz
from qex_tpu.eigens import refine as jref
from qex_tpu.eigens import svdlanczos as jsvd
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.physics import stag_hmc as jsh
from qex_tpu.physics import staggered as jst
from qex_tpu.solvers import deflate as jdefl
from qex_tpu_torch.eigens import chebyshev, hisqev, lanczos, refine
from qex_tpu_torch.eigens import svdlanczos
from qex_tpu_torch.gauge import fat7
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.physics import stag_fast as sf
from qex_tpu_torch.physics import stag_hmc
from qex_tpu_torch.physics import staggered as st
from qex_tpu_torch.solvers import deflate

DIMS = (4, 4, 4, 4)
LAT = Lattice(DIMS)
CANON = (3, 4, 4, 4, 2)                 # even-site vector, canonical
FAST = (3, 2, 4, 16)                    # the same, fast layout
NDENSE = 48
# the dense operator's spectrum: a separated low band under a bulk
LOW = (0.01, 0.02, 0.03, 0.045)


pytestmark = pytest.mark.usefixtures("single_threaded")

def jax_start(shape, seed):
    """The JAX drivers' start vector for ``seed``."""
    key = jax.random.PRNGKey(seed)
    return np.asarray(
        jax.random.normal(key, shape, jnp.float64)
        + 1j * jax.random.normal(jax.random.fold_in(key, 1), shape,
                                 jnp.float64))


@pytest.fixture
def inject_jax_starts(monkeypatch):
    """The port's start vectors become JAX's (in the fast layout where
    the port's operator runs there)."""
    def start(example, seed):
        if tuple(example.shape) == FAST:
            return sf.to_fast(t(jax_start(CANON, seed)), LAT)
        return t(jax_start(tuple(example.shape), seed))
    monkeypatch.setattr(lanczos, "start_vector", start)


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(91)
    q, _ = np.linalg.qr(ginibre(rng, (NDENSE, NDENSE)))
    ev = np.concatenate([LOW, np.linspace(1.0, 2.0, NDENSE - len(LOW))])
    a = (q * ev) @ q.conj().T
    aj = jnp.asarray(a)
    at = t(a)
    return dict(a=a, q=q, ev=ev, jop=lambda v: aj @ v,
                top=lambda v: at @ v, rng=rng,
                example=torch.zeros(NDENSE, dtype=torch.complex128))


@pytest.fixture(scope="module")
def lattice_ops():
    """4^4 links and the JAX operators' dense matrices: the mass-free
    normal operators -D_eo D_oe (plain; fat + naik on the port's HISQ
    links of the same field) and the hop D_oe."""
    rng = np.random.default_rng(92)
    jlat = JLattice(DIMS)
    u = random_links(rng, jlat, 0.3)
    fat, long = fat7.hisq_links_lowmem(LAT, st.phase_links(LAT, t(u)))
    fat, long = n(fat), n(long)
    nv = int(np.prod(CANON))
    basis = np.eye(nv, dtype=complex).reshape((nv,) + CANON)

    def mats(u, fat, long, basis):
        s = jst.new_stag_eo(jlat, u)
        s3 = jst.new_stag3_eo(jlat, fat, long)
        return tuple(jax.vmap(f)(basis).reshape(nv, nv).T for f in (
            lambda v: jst.d2dd(s, v, parity=0),
            lambda v: jst.d2dd3(s3, v, parity=0),
            lambda v: jst.dslash_eo(s, v, parity_out=1)))

    args = (u, fat, long, basis)      # the basis as an argument: as a
    d_plain, d_naik, d_oe = map(      # constant it slows the compile
        np.asarray, compile_ref(mats, *args)(*args))
    return dict(u=u, fat=fat, long=long, jlat=jlat, d_plain=d_plain,
                ev_plain=np.linalg.eigvalsh(d_plain),
                ev_naik=np.linalg.eigvalsh(d_naik),
                sv_oe=np.linalg.svd(d_oe, compute_uv=False)[::-1])


def test_lanczos_hermitian_from_v0(dense):
    v0 = ginibre(dense["rng"], (NDENSE,))
    ja, jb, jv = jlz.lanczos_hermitian(dense["jop"], jnp.asarray(v0), 12)
    a, b, v = lanczos.lanczos_hermitian(dense["top"], t(v0), 12)
    assert np.abs(a - ja).max() < 1e-12
    assert np.abs(b - jb).max() < 1e-12
    assert rel(n(v), np.asarray(jv)) < 1e-12


@pytest.mark.parametrize("driver", ["eigs_hermitian", "eigs_hermitian_dev"])
def test_eigs_hermitian(dense, inject_jax_starts, driver):
    """The port's two names are one driver.  JAX's two drivers are held
    equal by its own tests (test_eigens.py::
    test_device_path_matches_host), so each name is held against JAX's
    host loop; the ``_dev`` name gets its operator's matrix through
    ``op_args``."""
    kw = dict(m=16, tol=1e-10, seed=3)
    jev, _, jinfo = jlz.eigs_hermitian(dense["jop"],
                                       jnp.zeros(NDENSE, complex), 3, **kw)
    if driver == "eigs_hermitian_dev":
        kw.update(op_args=(t(dense["a"]),))
        top = (lambda v, a: a @ v)
    else:
        top = dense["top"]
    ev, vecs, info = getattr(lanczos, driver)(top, dense["example"], 3,
                                              **kw)
    assert info["converged"] and info["cycles"] == jinfo["cycles"]
    assert np.abs(ev - jev).max() < 1e-10
    assert np.abs(ev - np.array(LOW[:3])).max() < 1e-10
    assert vecs.shape == (3, NDENSE)


def test_chebyshev_filter(dense):
    v = ginibre(dense["rng"], (NDENSE,))
    got = chebyshev.chebyshev_filter(dense["top"], 0.3, 4.1, 7)(t(v))
    ref = jcheb.chebyshev_filter(dense["jop"], 0.3, 4.1, 7)(jnp.asarray(v))
    assert rel(n(got), np.asarray(ref)) < 1e-12


@pytest.mark.parametrize("driver", ["estimate_spectral_range",
                                    "estimate_spectral_range_dev"])
def test_estimate_spectral_range(dense, inject_jax_starts, driver):
    ref = getattr(jcheb, driver)(dense["jop"], jnp.zeros(NDENSE, complex),
                                 m=20)
    got = getattr(chebyshev, driver)(dense["top"], dense["example"], m=20)
    assert np.abs(np.subtract(got, ref)).max() < 1e-10


@pytest.mark.parametrize("device", [False, True])
def test_eigs_filtered(dense, inject_jax_starts, device):
    kw = dict(degree=9, tol=1e-10, m=12, seed=5, device=device)
    jev, _, jinfo = jcheb.eigs_filtered(dense["jop"],
                                        jnp.zeros(NDENSE, complex), 3, **kw)
    ev, _, info = chebyshev.eigs_filtered(dense["top"], dense["example"], 3,
                                          **kw)
    assert info["degree"] == jinfo["degree"] == 10
    assert np.abs(np.subtract(info["window"], jinfo["window"])).max() < 1e-10
    assert np.abs(ev - jev).max() < 1e-9
    assert np.abs(info["true_residuals"]
                  - jinfo["true_residuals"]).max() < 1e-9
    assert np.abs(ev - np.array(LOW[:3])).max() < 1e-9


@pytest.mark.parametrize("kind", ["plain", "naik_links"])
def test_stag_eigs(lattice_ops, kind):
    u = t(lattice_ops["u"])
    if kind == "plain":
        res = hisqev.stag_eigs(LAT, u, 4, degree=12, tol=1e-10)
        exact = lattice_ops["ev_plain"][:4]
    else:
        res = hisqev.stag_eigs(LAT, None, 4, degree=12, tol=1e-10, links=(
            t(lattice_ops["fat"]), t(lattice_ops["long"])))
        exact = lattice_ops["ev_naik"][:4]
    assert np.abs(res.evals - exact).max() < 1e-9 * exact.max()
    assert np.allclose(res.svals, np.sqrt(exact))
    assert res.vecs.shape == (4,) + CANON
    assert res.resids.max() < 1e-6


@pytest.mark.parametrize("kind", ["rr", "inverse"])
def test_refine(dense, kind):
    nvec = 3 if kind == "rr" else 2
    noise = 1e-3 * ginibre(np.random.default_rng(93), (nvec, NDENSE))
    v = dense["q"][:, :nvec].T + noise
    if kind == "rr":
        jr = jref.rr_refine_dev(dense["jop"], jnp.asarray(v), iters=2)
        r = refine.rr_refine_dev(dense["top"], t(v), iters=2)
    else:
        jr = jref.refine_inverse_dev(dense["jop"], jnp.asarray(v), iters=2)
        r = refine.refine_inverse_dev(dense["top"], t(v), iters=2)
    assert np.abs(r[0] - jr[0]).max() < 1e-9
    assert np.abs(r[2] - jr[2]).max() < 1e-9
    # the polish moves the pairs towards the exact low band
    assert np.abs(r[0] - np.array(LOW[:nvec])).max() < 1e-5


@pytest.mark.parametrize("driver", ["svd_lanczos", "svd_lanczos_dev"])
def test_svd_lanczos(dense, inject_jax_starts, driver):
    """As test_eigs_hermitian: one driver under two names, each held
    against JAX's host loop (its two drivers are held equal by
    test_svdlanczos.py::test_svd_lanczos_dev_matches_host), the ``_dev``
    name with the matrix passed through ``op_args`` on both sides."""
    rng = np.random.default_rng(94)
    qu, _ = np.linalg.qr(ginibre(rng, (NDENSE, NDENSE)))
    qv, _ = np.linalg.qr(ginibre(rng, (NDENSE, NDENSE)))
    sv = np.concatenate([[0.1, 0.2, 0.3], np.linspace(1.0, 1.2, NDENSE - 3)])
    d = (qu * sv) @ qv.conj().T
    dj, dt = jnp.asarray(d), t(d)
    kw = dict(m=12, tol=1e-8, seed=2)
    if driver == "svd_lanczos_dev":
        jargs, targs = dict(op_args=(dj,)), dict(op_args=(dt,))
    else:
        jargs, targs = {}, {}

    def ops(dm):
        if driver == "svd_lanczos_dev":
            return (lambda v, a: a @ v), (lambda w, a: a.conj().T @ w)
        return (lambda v: dm @ v), (lambda w: dm.conj().T @ w)

    jsig, _, _, jinfo = jsvd.svd_lanczos(
        *ops(dj), jnp.zeros(NDENSE, complex), 3, **kw, **jargs)
    sig, us, vs, info = getattr(svdlanczos, driver)(
        *ops(dt), dense["example"], 3, **kw, **targs)
    assert info["cycles"] == jinfo["cycles"] and info["converged"]
    assert np.abs(sig - jsig).max() < 1e-10
    exact = np.linalg.svd(d, compute_uv=False)[::-1][:3]
    assert np.abs(sig - exact).max() < 1e-9
    # D v_i = sigma_i u_i
    assert rel(n(vs) @ d.T, n(us) * sig[:, None]) < 1e-8


def test_svd_stag(lattice_ops):
    sig, uo, ve, info = svdlanczos.svd_stag(LAT, t(lattice_ops["u"]), 2,
                                            m=16, tol=1e-11)
    exact = lattice_ops["sv_oe"][:2]
    assert np.abs(sig - exact).max() < 1e-10
    assert uo.shape == ve.shape == (2,) + CANON
    # sigma^2 of D_oe are the eigenvalues of -D_eo D_oe
    assert np.abs(sig ** 2 - lattice_ops["ev_plain"][:2]).max() < 1e-9


def test_deflated_cg(dense):
    a, q = dense["a"], dense["q"]
    rng = np.random.default_rng(95)
    b = ginibre(rng, (NDENSE,))
    vecs = q[:, :4].T + 1e-4 * ginibre(rng, (4, NDENSE))
    ev = np.array(LOW)
    kw = dict(r2req=1e-22, maxits=200, restarts=3)
    jx, _ = compile_ref(lambda b, v: jdefl.deflated_cg(
        dense["jop"], b, jnp.asarray(ev), v, **kw), b, vecs)(b, vecs)
    x, stats = deflate.deflated_cg(dense["top"], t(b), torch.as_tensor(ev),
                                   t(vecs), **kw)
    assert rel(n(x), np.asarray(jx)) < 1e-10
    assert rel(a @ n(x), b) < 1e-10
    for m in (0.05, 0.15, 0.3):
        assert deflate.deflation_pays(ev, m) == jdefl.deflation_pays(ev, m)
    x2, _, used = deflate.auto_deflated_cg(dense["top"], t(b), ev, t(vecs),
                                           0.3, **kw)
    assert not used and rel(a @ n(x2), b) < 1e-10


def test_calibrate_spectral_range(lattice_ops, inject_jax_starts,
                                  monkeypatch):
    """JAX's calibration runs on its own operator as the dense matrix
    (its eager Lanczos on the stencil takes seconds): its
    ``hisqev._normal_op`` is replaced, for this call, by
    ``staggered.d2dd`` as the matrix ``lattice_ops`` holds."""
    m = 0.1
    dmat = jnp.asarray(lattice_ops["d_plain"])

    def normal_op(lat, u, bc, naik, links=None):
        assert bc == "pppa" and not naik and links is None
        return (lambda v, d: (d @ v.reshape(-1)).reshape(CANON),
                jax.ShapeDtypeStruct(CANON, dmat.dtype), (dmat,))

    monkeypatch.setattr(jhisqev, "_normal_op", normal_op)
    ref = jsh.StagRootedFermion(lattice_ops["jlat"], m).\
        calibrate_spectral_range(jnp.asarray(lattice_ops["u"]))
    ferm = stag_hmc.StagRootedFermion(LAT, m)
    got = ferm.calibrate_spectral_range(t(lattice_ops["u"]))
    assert np.abs(np.subtract(got.spectral_bounds,
                              ref.spectral_bounds)).max() < 1e-9
    lo, hi = got.spectral_bounds
    # the bracket holds the spectrum of A(m) and tightens the analytic one
    assert lo <= m * m + lattice_ops["ev_plain"][0]
    assert hi >= m * m + lattice_ops["ev_plain"][-1]
    assert m * m / 2 <= lo and hi < m * m + 16.0
    assert got._spectral_range() == (lo, hi)
