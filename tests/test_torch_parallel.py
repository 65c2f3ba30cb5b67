"""The port's multi-rank path (``parallel``, ``physics.stag_shard``,
``io.pario``, the dry run) against the JAX package's unsplit operators,
on gloo groups of host processes in complex128.

One group of four ranks starts once per module (each rank pays for
importing torch), and the test computes its references while the ranks
run ``_torch_parallel_worker.checks``: the two-rank checks in two
subgroups at once, then the four-rank ones.
The lattices are the JAX tests' own, 4x6x8x8 for 8 terms and 4x6x8x16
for 16 terms (tests/test_stag_shard.py:31-53,99-125), split z-only,
t-only and both: (1,1,2,1), (1,1,1,2), (1,1,2,2).  The bound on the
operators is the JAX tests' own: squared relative deviation < 1e-28.

The block-resident path (every field of a trajectory as each rank's
block) runs at 4x4x8x8 over the same three geometries: halo shifts and
global sums against whole-field rolls, the nHYP smear and the HISQ
links against JAX's unsplit functions to the JAX sharding tests' 1e-24
(tests/test_sharded_hotpath.py:135-171), their pullbacks and the gauge
forces against the port's unsplit ones, the Wilson solve against JAX's
(:173-197), ``stag_eigs`` at 4^4 against the exact spectrum of JAX's
operator (:199-217's bound), a config-4 trajectory and
the HISQ term against the unsplit port, and the app under torchrun
against its one-process run."""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
from _torch_helpers import (compile_ref, compile_refs, ginibre, rel, rel2,
                            single_threaded)
from qex_tpu.io import lime as jlime
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.parallel import mesh as jmesh
from qex_tpu.physics import stag_fast as jsf
from qex_tpu.physics import staggered as jst
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.parallel.distributed import free_port
from qex_tpu_torch.parallel.mesh import LatticeMesh, partition_geom
from qex_tpu_torch.physics import stag_shard as shd

DIMS8, DIMS16, HMC_DIMS, GAUGE_DIMS = (4, 6, 8, 8), (4, 6, 8, 16), \
    (4, 4, 4, 8), (4, 4, 4, 8)
M8, M16 = 0.15, 0.1
MASSES = [0.05, 0.2, 0.5]
GEOMS2 = [(1, 1, 2, 1), (1, 1, 1, 2)]
GEOMS4 = [(1, 1, 2, 2)]
HALO_GEOMS2 = [(2, 1, 1, 1), (1, 2, 1, 1), (1, 1, 2, 1), (1, 1, 1, 2)]
HALO_GEOMS4 = [(1, 2, 1, 2)]
SOLVE_MULTI_GEOM, HMC_GEOM = (1, 1, 1, 2), (1, 1, 2, 1)
BLK_DIMS, EIG_DIMS = (4, 4, 8, 8), (4, 4, 4, 4)
BLK_GEOMS = GEOMS2 + GEOMS4
APP_ARGS = ["--cpu", "--ntraj", "1", "-ns=4", "-nt=8", "-g_steps=2",
            "-f_steps=1", "-pv_steps=1", "-tau=0.2", "-plaq_freq=1",
            "-ploop_freq=1", "-pbp_freq=1"]


def _links(rng, dims, scale=0.7):
    """expm(scale * tah(G)) per link of numpy Ginibre noise G, by the
    port's own tah and expm (held to JAX's in test_torch_ops.py)."""
    from qex_tpu_torch.ops import group, linalg
    g = torch.from_numpy(ginibre(rng, (4, 3, 3) + dims))
    return torch.stack([linalg.expm(scale * group.tah(gm))
                        for gm in g]).numpy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, single_threaded):
    """The four ranks' results, and the references the test computes
    while they run: JAX's unsplit operators (one compiled program for
    each operator kind), the unmeshed hmc_step, JAX's serial LIME files.
    This process keeps one thread while its four ranks run."""
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.solvers.base import SolverParams
    rng = np.random.default_rng(17)
    d = tmp_path_factory.mktemp("ranks")
    u8 = _links(rng, DIMS8)
    fat, long = _links(rng, DIMS16), _links(rng, DIMS16)
    x8 = ginibre(rng, (3, DIMS8[3] // 2, DIMS8[2], DIMS8[1] * DIMS8[0]))
    x16 = ginibre(rng, (3, DIMS16[3] // 2, DIMS16[2],
                        DIMS16[1] * DIMS16[0]))
    field = ginibre(rng, (3,) + DIMS8)
    u_hmc, gauge = _links(rng, HMC_DIMS), _links(rng, GAUGE_DIMS)
    serial = str(d / "serial.lime")
    jlime.save_gauge(serial, JLattice(GAUGE_DIMS), gauge, precision="D")
    u_blk, u_eig = _links(rng, BLK_DIMS, 0.5), _links(rng, EIG_DIMS, 1.0)
    gshape = (4, 3, 3) + BLK_DIMS
    blk = dict(blk_dims=BLK_DIMS, eig_dims=EIG_DIMS, u_blk=u_blk,
               u_eig=u_eig, chain_v=ginibre(rng, gshape),
               chain_f=ginibre(rng, gshape), chain_l=ginibre(rng, gshape),
               fw=ginibre(rng, (3,) + BLK_DIMS),
               ww=ginibre(rng, (3,) + BLK_DIMS),
               tw=ginibre(rng, (3,) + BLK_DIMS),
               xi_h=ginibre(rng, (3,) + BLK_DIMS) * 0.5 ** 0.5,
               wil_b=ginibre(rng, (4, 3) + BLK_DIMS))
    (d / "app1").mkdir()
    (d / "app2").mkdir()
    deck = str(Path(worker.__file__).resolve().parent.parent
               / "qex_tpu_torch" / "apps" / "decks" / "config4_24.xml")
    inp = dict(
        dims8=DIMS8, dims16=DIMS16, u8=u8, fat=fat, long=long, x8=x8,
        x16=x16, m8=M8, m16=M16, masses=MASSES, field=field,
        hmc_dims=HMC_DIMS, u_hmc=u_hmc, gauge_dims=GAUGE_DIMS, gauge=gauge,
        pair_a=dict(geoms=[GEOMS2[0]], halo_geoms=HALO_GEOMS2[0::2],
                    shards_save=str(d / "shards"), pario_dir=str(d),
                    serial_file=serial, solve_multi=[SOLVE_MULTI_GEOM]),
        pair_b=dict(geoms=[GEOMS2[1]], halo_geoms=HALO_GEOMS2[1::2],
                    dryrun=((4, 4, 4, 8), (4, 4, 4, 8)),
                    solve_ee=[GEOMS2[1]], hmc=HMC_GEOM,
                    app_argv=["--xml", deck, *APP_ARGS,
                              "-rank_geom=1x1x1x2"],
                    app_port=free_port(), app_dir=str(d / "app2"),
                    app_path=str(Path(worker.__file__).resolve().parent
                                 .parent)),
        geoms4=GEOMS4, halo_geoms4=HALO_GEOMS4,
        shards_load=str(d / "shards"), **blk)
    handle = worker.start(inp, str(d / "inputs.pkl"))
    refs = _block_refs(blk, deck, d / "app1")

    jl8, jl16 = JLattice(DIMS8), JLattice(DIMS16)

    def ops8(u, x, f):
        fs = jsf.new_fast(jst.new_stag_eo(jl8, u))
        return (jsf.d2ee_fast(fs, x, M8), jsf.d2dd_fast(fs, x, 0),
                jst.dslash_full(jl8, jst.phase_links(jl8, u, "pppa"), f))

    def ops16(fl, ll, x):
        fs = jsf.new_fast3(jst.new_stag3_eo(jl16, fl, ll))
        return (jsf.d2ee3_fast(fs, x, M16), jsf.d2dd3_fast(fs, x, 0),
                jsf.d2dd3_fast(fs, x, 1))

    refs.update({
        "8": [np.asarray(a) for a in compile_ref(ops8, u8, x8, field)(
            u8, x8, field)],
        "16": [np.asarray(a) for a in compile_ref(ops16, fat, long, x16)(
            fat, long, x16)]})
    lat = Lattice(HMC_DIMS)
    theory = LatticeFieldTheory(
        lat, GaugeActionSpec(ga.wilson(5.5), steps=4, scheme="2MN"),
        fermions=[FermionSpec("fermion", 0.5, steps=2, scheme="2MN",
                              smeared=False),
                  FermionSpec("boson", 0.8, steps=2, scheme="2MN",
                              smeared=False)],
        smear=None, bc="pppa",
        solver_params=SolverParams(r2req=1e-14, maxits=300, restarts=2),
        tau=0.2)
    u1, state = theory.hmc_step(torch.Generator().manual_seed(6),
                                torch.from_numpy(u_hmc))
    refs["hmc"] = (state.dH, u1.numpy())
    for prec in ("F", "D"):
        jlime.save_gauge(str(d / f"ser_{prec}.lime"), JLattice(GAUGE_DIMS),
                         gauge, precision=prec)
    refs.update(inp=inp, dir=d)
    return worker.results(handle), refs


def _block_refs(blk, deck, app_dir):
    """What the block-resident checks are held to, computed while the
    ranks run: JAX's unsplit nHYP smear, HISQ links and Wilson solve,
    and the exact low spectrum of JAX's staggered normal operator as a
    dense matrix (the four programs compiled at once), the port's
    unsplit pullbacks, forces, config-4 trajectory and HISQ term, and
    the app's one-process lines."""
    import jax

    from qex_tpu.gauge import fat7 as jfat7
    from qex_tpu.gauge.smear import HypCoefs as JHypCoefs
    from qex_tpu.gauge.smear import nhyp_smear as jnhyp
    from qex_tpu.physics import wilson as jwl
    from qex_tpu.solvers.base import SolverParams as JSolverParams
    from qex_tpu_torch.apps import staghmc_spv
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge import fat7, smear
    from qex_tpu_torch.hmc import hmc as hmc_mod
    from qex_tpu_torch.hmc.integrators import fg_force
    from qex_tpu_torch.physics import stag_hmc
    from qex_tpu_torch.solvers.base import SolverParams

    jlat = JLattice(BLK_DIMS)
    u, b = blk["u_blk"], blk["wil_b"]

    def wilson(uu, bb):
        x, stats = jwl.solve_eo(jwl.new_wilson_eo(jlat, uu, 0.3), bb,
                                JSolverParams(**worker.WILSON_PARAMS))
        return x, stats.iterations
    jlat4, canon = JLattice(EIG_DIMS), (3,) + EIG_DIMS[:3] + (
        EIG_DIMS[3] // 2,)
    nv = int(np.prod(canon))
    basis = np.eye(nv, dtype=complex).reshape((nv,) + canon)

    def normal(ue, bas):            # -D_eo D_oe, a column a unit vector
        s = jst.new_stag_eo(jlat4, ue)
        return jax.vmap(lambda v: jst.d2dd(s, v, parity=0))(bas).reshape(
            nv, nv).T
    smear_c, hisq_c, wilson_c, normal_c = compile_refs(
        (lambda uu: jnhyp(JHypCoefs(), jlat, uu), u),
        (lambda uu: jfat7.hisq_links(jlat, uu), u), (wilson, u, b),
        (normal, blk["u_eig"], basis))
    out = {"nhyp": np.asarray(smear_c(u)),
           "hisq": [np.asarray(a) for a in hisq_c(u)]}
    x, its = wilson_c(u, b)
    out["wilson"] = (np.asarray(x), int(its))
    out["eigs"] = np.linalg.eigvalsh(np.asarray(normal_c(blk["u_eig"],
                                                         basis)))[:4]

    lat = Lattice(BLK_DIMS)
    tu = torch.from_numpy(u)
    out["nhyp_pullback"] = smear.smeared_force(
        smear.HypCoefs(), lat, tu, torch.from_numpy(blk["chain_v"])).numpy()
    with torch.enable_grad():
        uu = tu.clone().requires_grad_(True)
        (gf,) = torch.autograd.grad(fat7.hisq_links(lat, uu), uu,
                                    grad_outputs=(
                                        torch.from_numpy(blk["chain_f"]),
                                        torch.from_numpy(blk["chain_l"])))
    out["fat_pullback"] = gf.numpy()
    c = ga.GaugeActionCoeffs(**worker.FG_COEFFS)
    out["gauge_force"] = ga.gauge_force(c, lat, tu).numpy()
    out["fg_kick"] = fg_force(tu, 0.02, lambda x: ga.gauge_force(c, lat, x),
                              hmc_mod.gauge_update_u).numpy()
    u1, state = worker.config4(lat).hmc_step(
        torch.Generator().manual_seed(6), tu, always_accept=True)
    out["config4"] = (state.dH, u1.numpy())
    ferm = stag_hmc.HisqFermion(lat, 0.3, params=SolverParams(
        r2req=1e-20, maxits=1500, restarts=3))
    phi = ferm.heatbath_from_noise(torch.from_numpy(blk["xi_h"]), tu)
    act = ferm.make_action_fn()
    out["hisq_term"] = (phi.numpy(), float(act(tu, phi)),
                        ga.force_from_action(lambda v: act(v, phi),
                                             tu).numpy())
    buf = io.StringIO()
    with contextlib.chdir(app_dir), contextlib.redirect_stdout(buf):
        assert staghmc_spv.main(["--xml", deck, *APP_ARGS]) == 0
    out["app"] = buf.getvalue()
    return out


def test_partition_geom_matches_reference():
    for ndev in (1, 2, 3, 4, 6, 8, 12, 16):
        for dims in ((8, 8, 8, 8), (4, 6, 8, 16), (24, 24, 24, 48),
                     (6, 6, 6, 12), (32, 32, 32, 64)):
            try:
                ref = jmesh.partition_geom(ndev, dims)
            except ValueError:
                with pytest.raises(ValueError):
                    partition_geom(ndev, dims)
                continue
            assert partition_geom(ndev, dims) == ref, (ndev, dims)


@pytest.mark.parametrize("geom", GEOMS2 + GEOMS4)
def test_sharded_operators_8(ranks, geom):
    """d2ee and d2dd on blocks through the 8-term twin plus the halo
    correction, gathered, against JAX's unsplit fast operators."""
    res, refs = ranks
    assert rel2(res[("ee", "8", geom)], refs["8"][0]) < 1e-28
    assert rel2(res[("dd", "8", geom)], refs["8"][1]) < 1e-28


@pytest.mark.parametrize("geom", GEOMS2 + GEOMS4)
def test_sharded_operators_16(ranks, geom):
    """The 16-term (fat + naik) operators, 3-plane z and 2-plane packed-t
    halos, both parities of d2dd3."""
    res, refs = ranks
    assert rel2(res[("ee", "16", geom)], refs["16"][0]) < 1e-28
    assert rel2(res[("dd", "16", geom)], refs["16"][1]) < 1e-28
    assert rel2(res[("dd1", "16", geom)], refs["16"][2]) < 1e-28


@pytest.mark.parametrize("geom", HALO_GEOMS2 + HALO_GEOMS4)
def test_halo_shift_sums_and_dslash(ranks, geom):
    """shift_halo equals the unsplit shift exactly (distance 1 and 2,
    both signs, every direction); norm2 and dot match numpy's sums; the
    full-lattice hop with halos matches JAX's dslash_full."""
    res, refs = ranks
    f = refs["inp"]["field"]
    assert res[("shift_exact", geom)]
    assert res[("norm2", geom)] == pytest.approx(float(np.vdot(f, f).real),
                                                 rel=1e-14)
    assert res[("dot", geom)] == pytest.approx(
        complex(np.vdot(f, np.roll(f, 1, -1))), rel=1e-14)
    assert rel2(res[("dslash", geom)], refs["8"][2]) < 1e-28


@pytest.mark.parametrize("geom", [GEOMS2[1], GEOMS4[0]])
def test_sharded_solves(ranks, geom):
    """solve_ee_sharded at m = 0.25 (over 2 and 4 ranks) and
    solve_multi_sharded (16 terms, over 2) at JAX's masses and
    tolerances: true residuals by the canonical operators
    (tests/test_stag_shard.py:89-96, :147-158)."""
    res, _ = ranks
    assert res[("solve_ee", geom)] < 1e-18
    if geom == SOLVE_MULTI_GEOM:
        for m, r in zip(MASSES, res[("solve_multi", geom)]):
            assert r < 1e-20, (m, r)


def test_local_extent_guards():
    """The JAX package's guards (tests/test_stag_shard.py:168-180):
    local Z of 2 for 16 terms, a split of x or y."""
    lm = LatticeMesh(Lattice((4, 6, 8, 8)), (1, 1, 4, 2))
    with pytest.raises(ValueError, match="local Z"):
        shd.d2ee3_sharded(lm, None, None, 0.1)
    lm = LatticeMesh(Lattice((8, 8, 8, 8)), (1, 2, 2, 2))
    with pytest.raises(ValueError, match="shards x/y"):
        shd.d2ee_sharded(lm, None, None, 0.1)
    assert not shd.mesh_usable(lm, lm.lat)
    lm = LatticeMesh(Lattice((4, 6, 8, 16)), (1, 1, 2, 4))
    assert shd.mesh_usable(lm, lm.lat, naik=True)
    assert not shd.mesh_usable(LatticeMesh(lm.lat, (1, 1, 4, 2)), lm.lat,
                               naik=True)


def test_hmc_step_mesh_route(ranks):
    """SolverParams.mesh through hmc_step at 4^3x8 over (1,1,2,1): the
    unmeshed trajectory on the same draws (tests/test_stag_shard.py
    :182-214's bounds, its action at 4x4x8x8)."""
    res, refs = ranks
    (dh_mesh, u_mesh), (dh, u) = res["hmc"], refs["hmc"]
    assert dh_mesh == pytest.approx(dh, abs=1e-7)
    assert rel2(u_mesh, u) < 1e-12


def test_save_and_load_shards(ranks):
    """Per-rank shard files written by 2 ranks read back by them, and
    re-cut by 4 ranks of another geometry."""
    res, _ = ranks
    assert res["shards_same"] and res["shards_recut"]


def test_pario(ranks):
    """Two ranks write one SciDAC file byte for byte the JAX package's
    serial file (both precisions), read it back, read JAX's serial file,
    and detect a flipped payload byte."""
    res, refs = ranks
    d = refs["dir"]
    for prec in ("F", "D"):
        assert open(d / f"par_{prec}.lime", "rb").read() == \
            open(d / f"ser_{prec}.lime", "rb").read()
    back = jlime.load_gauge(str(d / "par_F.lime"), JLattice(GAUGE_DIMS))
    assert np.abs(back - refs["inp"]["gauge"]).max() < 1e-6
    assert res["pario_roundtrip"] and res["pario_reads_serial"]
    assert "checksum mismatch" in res["pario_corruption"]


def test_dryrun(ranks):
    """The dry run's HMC step, block d2ee and config-5 multishift over 2
    ranks, both at 4^3x8."""
    r = ranks[0]["dryrun"]
    assert np.isfinite(r["dH"]) and 0 < r["plaquette"] < 1
    assert r["d2ee_rel_dev"] < 1e-28
    assert r["config5_worst_true_r2"] < 1e-6


def test_profile_timer_tree(capsys):
    """The timer tree: nested timers, flop rates, ``timing`` wrapping a
    module function and restoring it."""
    from qex_tpu_torch.ops import linalg
    from qex_tpu_torch.utils import profile
    prof = profile.Profiler()
    norm2 = linalg.norm2
    x = torch.ones(1000, dtype=torch.float64)
    with prof.timing([("norm2", linalg, "norm2")], sync=x):
        with prof.timer("outer", flops=2e3, sync=x):
            for _ in range(3):
                linalg.norm2(x)
    assert linalg.norm2 is norm2
    outer = prof.root.children["outer"]
    assert outer.count == 1 and outer.children["norm2"].count == 3
    lines = prof.report(min_frac=0.0).splitlines()
    assert lines[0].startswith("outer") and "Gflop/s" in lines[0]
    assert lines[1].strip().startswith("norm2") and "x3" in lines[1]
    prof.reset()
    assert not prof.root.children
    with profile.timer("t"):
        pass
    profile.echo_timers()
    assert "t" in capsys.readouterr().out


def _lines(text: str, tags=("Begin H", "End H", "MEASplaq", "MEASploop",
                            "MEASpbp")) -> list:
    return [ln for ln in text.splitlines() if ln.startswith(tags)]


@pytest.mark.parametrize("geom", BLK_GEOMS)
def test_block_halo_shift_and_global_sum(ranks, geom):
    """shift_halo forward, backward, double backward (a Hessian-vector
    product), torch.func.grad and jvp on blocks against the whole
    field's rolls; global_sum's gradient the unsplit one (not times the
    number of ranks); the staggered phases and boundary signs exact."""
    r = ranks[0][("blocks", geom)]
    assert r["halo_value"][0] == pytest.approx(r["halo_value"][1],
                                               rel=1e-13)
    assert r["halo_jvp"][0] == pytest.approx(r["halo_jvp"][1], rel=1e-13)
    assert all(r["halo_grad_equal"])
    assert r["global_sum_grad_equal"] and r["phases_equal"]


@pytest.mark.parametrize("geom", BLK_GEOMS)
def test_block_smear_and_hisq_links(ranks, geom):
    """nhyp_smear and hisq_links on blocks, gathered, against JAX's
    unsplit functions (squared relative deviation < 1e-24)."""
    res, refs = ranks
    r = res[("blocks", geom)]
    assert rel2(r["nhyp"], refs["nhyp"]) < 1e-24
    assert rel2(r["fat"], refs["hisq"][0]) < 1e-24
    assert rel2(r["long"], refs["hisq"][1]) < 1e-24


@pytest.mark.parametrize("geom", BLK_GEOMS)
def test_block_pullbacks_and_forces(ranks, geom):
    """The smeared and fat pullbacks, the plaq + rect + pgm force (its
    rect/pgm part by torch.func.grad) and the exact force-gradient kick
    (torch.func.jvp of that force) on blocks against the unsplit port
    (squared relative deviation < 1e-20)."""
    res, refs = ranks
    r = res[("blocks", geom)]
    for k in ("nhyp_pullback", "fat_pullback", "gauge_force", "fg_kick"):
        assert rel2(r[k], refs[k]) < 1e-20, k


@pytest.mark.parametrize("geom", BLK_GEOMS)
def test_block_wilson_solve(ranks, geom):
    """The Wilson eo solve on blocks (B3's twin with face corrections,
    all-reduced CGNE sums) takes JAX's iterations and matches its
    solution (tests/test_sharded_hotpath.py:173-197's bounds)."""
    res, refs = ranks
    (x, its), (xr, itr) = res[("blocks", geom)]["wilson"], refs["wilson"]
    assert its == itr
    assert rel2(x, xr) < 1e-16


@pytest.mark.parametrize("geom", BLK_GEOMS)
def test_block_stag_eigs(ranks, geom):
    """stag_eigs on blocks at 4^4 against the exact lowest eigenvalues
    of JAX's operator (rtol 1e-8, tests/test_sharded_hotpath.py
    :199-217's bound on JAX's own eigensolver)."""
    res, refs = ranks
    assert np.allclose(res[("blocks", geom)]["eigs"], refs["eigs"],
                       rtol=1e-8)


@pytest.mark.parametrize("geom", BLK_GEOMS)
def test_block_hmc_step_config4(ranks, geom):
    """One nHYP-smeared staggered + PV trajectory on blocks against the
    unsplit port step on the same draws: links to 1e-12 relative, dH
    to 1e-8."""
    res, refs = ranks
    (dh, u1), (dh_ref, u_ref) = res[("blocks", geom)]["config4"], \
        refs["config4"]
    assert rel(u1, u_ref) < 1e-12
    assert dh == pytest.approx(dh_ref, abs=1e-8)


def test_block_fields_reach_solver_and_integrator(ranks):
    """With the mesh active no rank holds a whole field: every right-hand
    side reaching the CG and every link and momentum field reaching the
    integrator's update is the block, and gather_fast is not called."""
    r = ranks[0][("blocks", GEOMS4[0])]
    X, Y, Z, T = r["local_dims"]
    assert r["config4_gathers"] == 0
    kinds = {s[0] for s in r["config4_shapes"]}
    assert kinds == {"solve", "update"}
    for s in r["config4_shapes"]:
        if s[0] == "solve":
            assert s[1] == (3, T // 2, Z, Y * X), s
        else:
            assert s[1] == s[2] == (4, 3, 3, X, Y, Z, T), s


def test_block_hisq_term(ranks):
    """The HISQ heatbath, action and force on blocks over (1,1,2,2)
    (local Z 4, local T/2 2: the naik terms' distance-3 halos) against
    the unsplit port."""
    res, refs = ranks
    phi, s, f = res[("blocks", GEOMS4[0])]["hisq"]
    phi_r, s_r, f_r = refs["hisq_term"]
    assert rel2(phi, phi_r) < 1e-20
    assert s == pytest.approx(s_r, rel=1e-12)
    assert rel2(f, f_r) < 1e-20


def test_unusable_mesh_raises():
    """A mesh the block kernels cannot take raises, naming its local
    extents, where a whole field is no longer there to fall back on."""
    from qex_tpu_torch.physics import stag_fast as sf
    lat = Lattice((4, 4, 6, 8))
    lm = LatticeMesh(lat, (1, 1, 2, 1))
    with pytest.raises(ValueError, match=r"\(4, 4, 3, 8\)"):
        shd.solve_route(lm, sf.FastStagEO(Lattice(lm.local_dims), None,
                                          None), False, 0.1, None)
    lm = LatticeMesh(Lattice((4, 6, 8, 8)), (1, 1, 4, 2))
    with pytest.raises(ValueError, match="16 terms"):
        shd.require_usable(lm, naik=True)


def test_app_on_two_ranks(ranks):
    """staghmc_spv under torch.distributed.run, two gloo ranks with
    -rank_geom=1x1x1x2, block-resident, prints the one-process run's
    Begin H, End H, MEASplaq, MEASploop (the t-split Polyakov loop) and
    MEASpbp (the condensate's solves on blocks) lines."""
    res, refs = ranks
    rc, stdout, stderr = res["app"]
    assert rc == 0, stderr
    assert _lines(stdout) == _lines(refs["app"]) != []
