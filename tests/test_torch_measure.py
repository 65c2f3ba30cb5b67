"""The measurement tier of qex_tpu_torch against qex_tpu (complex128,
4^4): the resumable random streams and noise distributions; LIME files
byte-identical to the JAX package's and readable both ways; ``Params``
parsing identically; sources, momentum phases and sign fields exactly;
``stag_mesons_from_prop`` to 1e-12 (zero and nonzero momentum);
``stag_meson_correlators`` to 1e-9; ``dilution_masks`` exactly;
``pbp_staggered`` on JAX's own noise to 1e-10; the apps ``measure`` and
``eigs`` on the CPU on an .npz checkpoint, their ``MEAS*`` numbers held
against the JAX functions and their ``EIGEN`` eigenvalues against the
exact spectrum of the JAX operator; and the production app's
``pbp_freq``.  Each JAX reference is compiled once
(``_torch_helpers.compile_ref``)."""

import contextlib
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import (compile_ref, ginibre, n, random_links, rel,
                            single_threaded, t)
from qex_tpu import rng as jrng
from qex_tpu.gauge import loops as jloops
from qex_tpu.io import lime as jlime
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.observables import condensate as jcond
from qex_tpu.observables import mesons as jmes
from qex_tpu.physics import stag_solve as jsolve
from qex_tpu.physics import staggered as jst
from qex_tpu.physics import wilson as jwl
from qex_tpu.solvers.base import SolverParams as JSolverParams
from qex_tpu.utils import params as jparams
from qex_tpu_torch import rng
from qex_tpu_torch.apps import eigs as eigs_app
from qex_tpu_torch.apps import measure as measure_app
from qex_tpu_torch.apps import staghmc_spv
from qex_tpu_torch.io import checkpoint as ckpt
from qex_tpu_torch.io import lime
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.observables import condensate, mesons
from qex_tpu_torch.solvers.base import SolverParams
from qex_tpu_torch.utils import params

DIMS = (4, 4, 4, 4)
LAT = Lattice(DIMS)
MASS = 0.2
TOL = 1e-24                 # solves: r2req in complex128
SEED = 11                   # the measure app's -seed (pbp key: SEED + 1)
DECK = str(Path(__file__).resolve().parent.parent / "qex_tpu_torch" / "apps"
           / "decks" / "config4_24.xml")


pytestmark = pytest.mark.usefixtures("single_threaded")

@pytest.fixture(scope="module")
def ref():
    """4^4 links and what the JAX measure app computes on them:
    plaquette, Polyakov loop, clover charge, all staggered channels and
    the z4 condensate from key PRNGKey(SEED + 1), at r2req TOL; and the
    z4 noise that condensate draws.  Each part is its own compiled
    program (one program of all of them compiles slower than its
    parts).

    JAX's staggered observables run here on exact solves: its
    ``stag_solve.solve`` and ``solve_batched`` are replaced, while they
    are traced, by a dense solve of its own D(m) (``staggered.d_full``
    as a 768 x 768 matrix).  Its Krylov solves are held against the
    port's elsewhere (tests/test_torch_rhmc.py) and compile for seconds
    each; the port's solves at r2req TOL agree with the exact ones far
    inside these tests' tolerances.

    The condensate is JAX's undiluted one.  Even-odd dilution leaves the
    staggered estimate unchanged on the same noise: D = m + K with K
    antihermitian and parity-changing, so the parity-off-diagonal block
    of D^-1, -K (m^2 - K^2)^-1, is antihermitian and its terms in
    Re eta^dag D^-1 eta cancel."""
    jlat = JLattice(DIMS)
    u = random_links(np.random.default_rng(71), jlat, 0.3)
    key = jax.random.PRNGKey(SEED + 1)
    sp = JSolverParams(r2req=TOL, maxits=10000, restarts=3)
    nv = 3 * LAT.volume

    def run(fn, *args):
        return compile_ref(fn, *args)(*args)

    def dense_d(u):
        g = jst.phase_links(jlat, u)
        basis = jnp.eye(nv, dtype=u.dtype).reshape((nv,) + jlat.vector_shape())
        return jax.vmap(lambda x: jst.d_full(jlat, g, x, MASS))(
            basis).reshape(nv, nv).T

    def exact_solves(dmat):
        def solve(s, b, m, params):
            assert m == MASS
            return jnp.linalg.solve(dmat, b.reshape(nv)).reshape(
                b.shape), None

        def solve_batched(s, bs, m, params):
            return jax.vmap(lambda b: solve(s, b, m, params)[0])(bs), None
        return solve, solve_batched

    def staggered(u, key, dmat):
        with pytest.MonkeyPatch.context() as mp:
            solve, batched = exact_solves(dmat)
            mp.setattr(jsolve, "solve", solve)
            mp.setattr(jsolve, "solve_batched", batched)
            return (jmes.stag_meson_correlators(
                        jlat, u, MASS, channels=tuple(jmes.STAG_CHANNELS),
                        params=sp),
                    jcond.pbp_staggered(key, jlat, u, MASS, n_noise=1,
                                        params=sp),
                    jrng.z4_noise(jax.random.fold_in(key, 0),
                                  jlat.vector_shape(), jnp.complex128))

    plaq, ploop, topo = run(lambda u: (
        jloops.plaquette(jlat, u), jloops.polyakov_loop(jlat, u),
        jloops.topo_charge_clover(jlat, u)), u)
    dmat = run(dense_d, u)
    mes, pbp, noise = run(staggered, u, key, dmat)
    return dict(u=u, dmat=np.asarray(dmat), plaq=float(plaq),
                ploop=complex(ploop),
                topo=float(topo), pbp=float(pbp), noise=np.asarray(noise),
                mesons={k: np.asarray(v) for k, v in mes.items()})


@pytest.fixture(scope="module")
def links():
    return random_links(np.random.default_rng(73), JLattice(DIMS), 0.5)


def _run(main, argv) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def _tagged(lines, tag) -> dict[str, np.ndarray]:
    """{second word: the numbers after it} of the lines starting with
    ``tag``."""
    rows = {}
    for ln in lines:
        if ln.startswith(tag + " "):
            w = ln.split()
            rows[w[1]] = np.array([float(x) for x in w[2:]])
    return rows


def test_rng_state_round_trip():
    r = rng.LatticeRNG(seed=5)
    first = [rng.gaussian(r.next_generator("cpu"), (8,)) for _ in range(3)]
    state = r.state()
    assert state == {"seed": 5, "counter": 3}
    later = rng.gaussian(r.next_generator("cpu"), (8,))
    again = rng.LatticeRNG.from_state(state)
    assert torch.equal(rng.gaussian(again.next_generator("cpu"), (8,)), later)
    redo = rng.LatticeRNG(seed=5)
    assert all(torch.equal(rng.gaussian(redo.next_generator("cpu"), (8,)), f)
               for f in first)
    assert not torch.equal(first[0], first[1])


@pytest.mark.parametrize("kind", ["z4", "z2", "u1", "gauss", "complex",
                                  "uniform"])
def test_noise_distributions(kind):
    gen = rng.seeded_generator("cpu", 7)
    shape = (4, 5000)
    if kind == "complex":
        z = rng.gaussian_complex(gen, shape, torch.complex128)
        assert abs(float((z.abs() ** 2).mean()) - 2.0) < 0.05
        return
    if kind == "uniform":
        x = rng.uniform(gen, shape, torch.float64)
        assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
        assert abs(float(x.mean()) - 0.5) < 0.01
        return
    z = condensate.NOISES[kind](gen, shape, torch.complex128)
    assert z.dtype == torch.complex128
    # E[eta eta^dag] = 1 and E[eta] = 0, as JAX's samplers
    assert abs(float((z.abs() ** 2).mean()) - 1.0) < 0.03
    assert abs(complex(z.mean())) < 0.02
    if kind != "gauss":
        assert torch.allclose(z.abs(), torch.ones(shape, dtype=torch.float64))
    support = {"z4": {1, 1j, -1, -1j}, "z2": {1, -1}}.get(kind)
    if support:
        assert set(complex(v) for v in z.flatten().tolist()) == support


@pytest.mark.parametrize("precision", ["F", "D"])
def test_lime_files_match_the_reference(tmp_path, links, precision):
    jlat = JLattice(DIMS)
    mine, theirs = tmp_path / "port.lime", tmp_path / "jax.lime"
    lime.save_gauge(str(mine), LAT, t(links), precision=precision)
    jlime.save_gauge(str(theirs), jlat, links, precision=precision)
    assert mine.read_bytes() == theirs.read_bytes()
    want = links.astype(np.complex64 if precision == "F" else complex)
    assert np.array_equal(lime.load_gauge(str(theirs), LAT), want)
    assert np.array_equal(jlime.load_gauge(str(mine), jlat), want)
    assert lime.file_lattice(str(mine)) == DIMS
    recs = lime.read_lime(str(mine))
    assert [r.type for r in recs] == [r.type for r in
                                      jlime.read_lime(str(theirs))]
    # a flipped payload byte fails the checksum
    data = bytearray(mine.read_bytes())
    data[144 * 5 + sum(len(r.data) + (-len(r.data)) % 8
                       for r in recs[:4]) + 7] ^= 1
    mine.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        lime.load_gauge(str(mine), LAT)


def test_default_setup_reads_scidac(tmp_path, links):
    path = str(tmp_path / "cfg.scidac")
    lime.save_gauge(path, LAT, links, precision="D")
    lat, u = params.default_setup(params.Params([path]), device="cpu")
    jlat, ju = jparams.default_setup(jparams.Params([path]))
    assert lat.dims == jlat.dims == DIMS
    assert np.array_equal(n(u), np.asarray(ju))
    lat, u = params.default_setup(params.Params(["-lat:6,4,4,8"]))
    assert lat.dims == (6, 4, 4, 8) and u is None


def test_params_parse_like_the_reference(tmp_path):
    deck = tmp_path / "p.txt"
    deck.write_text("# comment\n-beta:6.1\nnev: 12\nmass 0.05\n")
    argv = ["-lat:8,8,8,16", "-tol:1e-9", "-naik:true", "-bc:aaaa",
            "-masses:0.1 0.2", f"-loadParams:{deck}", "pos", "-beta:5.9"]
    got, want = params.Params(argv), jparams.Params(argv)
    for p in (got, want):
        p.vals = (p.int_seq_param("lat", [4, 4, 4, 4]),
                  p.float_param("tol", 1e-8), p.bool_param("naik", False),
                  p.str_param("bc", "pppa"),
                  p.float_seq_param("masses", [0.0]),
                  p.float_param("beta", 6.0), p.int_param("nev", 8),
                  p.float_param("mass", 0.0), p.int_param("seed", 3))
    assert got.vals == want.vals
    assert got.vals[0] == [8, 8, 8, 16] and got.vals[5] == 5.9
    assert got.positional == want.positional == ["pos"]
    assert got.unknown() == want.unknown() == []
    assert got.help_text() == want.help_text()


def test_sources_and_phases_exact():
    jlat = JLattice(DIMS)
    sites = ((0, None), (2, (1, 2, 3, 0)))
    moms = ((0, 0, 0), (1, 0, 2))

    def refs():
        return ([jmes.point_source(jlat, c, st_, jnp.complex128)
                 for c, st_ in sites],
                jmes.wall_source(jlat, 1, 2, jnp.complex128),
                [jmes._sign_field(jlat, d)
                 for d in jmes.STAG_CHANNELS.values()],
                [jmes.momentum_phase(jlat, p, jnp.complex128) for p in moms])

    points, wall, signs, phases = jax.tree_util.tree_map(
        np.asarray, compile_ref(refs)())
    for (color, site), want in zip(sites, points):
        assert np.array_equal(n(mesons.point_source(
            LAT, color, site, torch.complex128, "cpu")), want)
    assert np.array_equal(
        n(mesons.wall_source(LAT, 1, 2, torch.complex128, "cpu")), wall)
    assert tuple(mesons.STAG_CHANNELS.items()) == \
        tuple(jmes.STAG_CHANNELS.items())
    for dirs, want in zip(mesons.STAG_CHANNELS.values(), signs):
        assert np.array_equal(n(mesons._sign_field(LAT, dirs, "cpu")), want)
    for p, want in zip(moms, phases):
        got = n(mesons.momentum_phase(LAT, p, torch.complex128, "cpu"))
        assert np.abs(got - want).max() < 1e-15


@pytest.mark.parametrize("momenta", [((0, 0, 0),),
                                     ((0, 0, 0), (1, 0, 0), (0, 1, 1))])
def test_stag_mesons_from_prop(momenta):
    props = ginibre(np.random.default_rng(72), (3, 3) + DIMS)
    chans = tuple(mesons.STAG_CHANNELS)
    got = mesons.stag_mesons_from_prop(LAT, t(props), chans, momenta)
    want = jmes.stag_mesons_from_prop(JLattice(DIMS), jnp.asarray(props),
                                      chans, momenta)
    for ch in chans:
        assert got[ch].shape == want[ch].shape
        assert got[ch].is_complex() == (len(momenta) > 1)
        assert rel(n(got[ch]), np.asarray(want[ch])) < 1e-12


def test_stag_meson_correlators(ref):
    got = mesons.stag_meson_correlators(
        LAT, t(ref["u"]), MASS, channels=tuple(mesons.STAG_CHANNELS),
        params=SolverParams(r2req=TOL, maxits=10000, restarts=3))
    for ch, want in ref["mesons"].items():
        assert rel(n(got[ch]), want) < 1e-9
    assert (ref["mesons"]["pion5"] > 0).all()


@pytest.mark.parametrize("kind", ["none", "eo", "corner3d"])
def test_dilution_masks_exact(kind):
    got = condensate.dilution_masks(LAT, kind, "cpu")
    want = jcond.dilution_masks(JLattice(DIMS), kind)
    assert len(got) == len(want) == {"none": 1, "eo": 2, "corner3d": 8}[kind]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.array_equal(n(g), np.asarray(w))
    assert torch.equal(sum(got), torch.ones(DIMS))


@pytest.mark.parametrize("dilution", ["none", "eo"])
def test_pbp_staggered_on_injected_noise(ref, dilution):
    got = condensate.pbp_staggered(
        None, LAT, t(ref["u"]), MASS, dilution=dilution,
        params=SolverParams(r2req=TOL, maxits=10000, restarts=3),
        noises=t(ref["noise"])[None])
    assert abs(got - ref["pbp"]) < 1e-10 * abs(ref["pbp"])
    with pytest.raises(ValueError, match="dilution"):
        condensate.dilution_masks(LAT, "time", "cpu")


@pytest.fixture
def checkpoint(tmp_path, ref):
    path = str(tmp_path / "cfg.npz")
    ckpt.save_checkpoint(path, t(ref["u"]), {}, 0)
    return path


def test_measure_app_on_the_cpu(checkpoint, ref, monkeypatch):
    """The app's z4 draws are JAX's for its key (SEED + 1), so MEASpbp
    is JAX's estimate.  Its twelve Wilson propagators are kept as the
    app solves them (solve_eo, the kernel B3 route) and held against
    JAX's operator: D x = b to a relative r^2 of 1e-20, and MEASwmeson
    against JAX's contraction of them."""
    from qex_tpu_torch.physics import wilson as wl
    monkeypatch.setitem(condensate.NOISES, "z4",
                        lambda gen, shape, dtype: t(ref["noise"]))
    props = []

    def solve_eo(w, b, params):
        x, stats = real_solve_eo(w, b, params)
        props.append(n(x))
        return x, stats

    real_solve_eo = wl.solve_eo
    monkeypatch.setattr(wl, "solve_eo", solve_eo)
    lines = _run(measure_app.main, [
        f"-gauge:{checkpoint}", "-lat:4,4,4,4", "-cpu:true",
        f"-mass:{MASS}", f"-tol:{TOL}", f"-seed:{SEED}", "-mesons:true",
        "-pbp:true", "-nNoise:1", "-dilution:eo", "-wilsonMesons:true"])
    meas = {ln.split()[0]: [float(x) for x in ln.split()[1:]]
            for ln in lines if ln.startswith(("MEASplaq", "MEASploop",
                                              "MEAStopo", "MEASpbp"))}
    assert abs(meas["MEASplaq"][0] - ref["plaq"]) < 1e-11
    assert np.abs(np.subtract(meas["MEASploop"], [ref["ploop"].real,
                                                  ref["ploop"].imag])
                  ).max() < 1e-9
    assert abs(meas["MEAStopo"][0] - ref["topo"]) < 1e-8
    assert abs(meas["MEASpbp"][0] - ref["pbp"]) < 1e-9 * abs(ref["pbp"])
    got = _tagged(lines, "MEASmeson")
    assert set(got) == set(ref["mesons"])
    for ch, c in ref["mesons"].items():
        assert rel(got[ch], c) < 1e-9, ch

    jlat = JLattice(DIMS)
    props = np.stack(props).reshape((4, 3, 4, 3) + DIMS)
    srcs = np.eye(12).reshape((4, 3, 4, 3) + (1,) * 4) * np.pad(
        np.ones((1,) * 4), [(0, d - 1) for d in DIMS])
    dx = compile_ref(lambda u, x: jax.vmap(jax.vmap(
        lambda v: jwl.wilson_d(jwl.new_wilson(jlat, u, MASS), v)))(x),
        ref["u"], props)(ref["u"], props)
    assert ((np.abs(np.asarray(dx) - srcs) ** 2).sum() / 12) < 1e-20
    want = jmes.wilson_mesons_from_prop(jlat, jnp.asarray(props),
                                        jmes.WILSON_CHANNELS)
    got = _tagged(lines, "MEASwmeson")
    assert set(got) == set(want)
    for ch, c in want.items():
        assert rel(got[ch], np.asarray(c)) < 1e-9, ch
    assert (got["pion"] > 0).all()


def test_eigs_app_on_the_cpu(checkpoint, ref, tmp_path):
    """EIGEN lines against the exact lowest eigenvalues of the JAX
    operator -D_eo D_oe: with D(m) = m + K from ``ref``'s dense
    ``staggered.d_full``, its matrix is -(K K) on the even sites (K
    changes parity)."""
    even = (np.indices(DIMS).sum(0) % 2 == 0)
    even = np.broadcast_to(even, (3,) + DIMS).reshape(-1)
    k = ref["dmat"] - MASS * np.eye(len(even))
    exact = np.linalg.eigvalsh(-(k @ k)[np.ix_(even, even)])[:3]
    save = str(tmp_path / "eigs.npz")
    lines = _run(eigs_app.main, [
        f"-gauge:{checkpoint}", "-lat:4,4,4,4", "-cpu:true", "-nev:3",
        "-mass:0.1", f"-save:{save}", "-deflate:true"])
    ev = np.array([float(ln.split()[3]) for ln in lines
                   if ln.startswith("EIGEN ")])
    assert np.abs(ev - exact).max() < 1e-9 * exact.max()
    shifted = [float(ln.split()[3]) for ln in lines
               if ln.startswith("EIGENshifted")]
    assert np.allclose(shifted, ev + 0.01, rtol=1e-10)
    with np.load(save) as z:
        assert z["vecs"].shape == (3, 3, 4, 4, 4, 2)
        assert np.abs(z["evals"] - exact).max() < 1e-9 * exact.max()
    (line,) = [ln for ln in lines if ln.startswith("DEFLATE")]
    its = [int(x) for x in re.findall(r"its=(\d+)", line)]
    r2 = [float(x) for x in re.findall(r"rel_r2=(\S+)", line)]
    assert len(its) == 2 and its[1] <= its[0]
    assert max(r2) <= 1e-9


def test_apps_need_a_card_or_cpu_flag(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the apps would run on it")
    assert eigs_app.main(["-lat:4,4,4,4"]) == 2
    assert measure_app.main(["-lat:4,4,4,4"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_app_measures_pbp(tmp_path):
    """staghmc_spv with pbp_freq=1 prints MEASpbp: the condensate of the
    trajectory's links with a generator of its own, seeded from
    (parallel_seed, 10_000 + traj), so the trajectory's stream is not
    drawn from."""
    lines = _run(staghmc_spv.main, [
        "--xml", DECK, "--cpu", "--ntraj", "1", "-ns=4", "-nt=4",
        "-g_steps=1", "-f_steps=1", "-pv_steps=1", "-tau=0.1",
        f"-save_path={tmp_path}", "-pbp_freq=1", "-save_freq=1"])
    (pbp,) = [float(ln.split()[1]) for ln in lines
              if ln.startswith("MEASpbp")]
    u, state, _ = ckpt.load_checkpoint(str(tmp_path / "config4_24_1"), LAT,
                                       torch.complex128, "cpu")
    want = condensate.pbp_staggered(
        rng.seeded_generator("cpu", state["parallel_seed"], 10_000), LAT, u,
        0.05, params=SolverParams(r2req=1e-10, maxits=1500, restarts=3))
    assert np.isfinite(pbp) and abs(pbp - want) < 1e-9 * abs(want)
