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
operators is the JAX tests' own: squared relative deviation < 1e-28."""

import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
from _torch_helpers import compile_ref, ginibre, rel2, single_threaded
from qex_tpu.io import lime as jlime
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.parallel import mesh as jmesh
from qex_tpu.physics import stag_fast as jsf
from qex_tpu.physics import staggered as jst
from qex_tpu_torch.lattice import Lattice
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
    inp = dict(
        dims8=DIMS8, dims16=DIMS16, u8=u8, fat=fat, long=long, x8=x8,
        x16=x16, m8=M8, m16=M16, masses=MASSES, field=field,
        hmc_dims=HMC_DIMS, u_hmc=u_hmc, gauge_dims=GAUGE_DIMS, gauge=gauge,
        pair_a=dict(geoms=[GEOMS2[0]], halo_geoms=HALO_GEOMS2[0::2],
                    shards_save=str(d / "shards"), pario_dir=str(d),
                    serial_file=serial, solve_multi=[SOLVE_MULTI_GEOM]),
        pair_b=dict(geoms=[GEOMS2[1]], halo_geoms=HALO_GEOMS2[1::2],
                    dryrun=((4, 4, 4, 8), (4, 4, 4, 8)),
                    solve_ee=[GEOMS2[1]], hmc=HMC_GEOM),
        geoms4=GEOMS4, halo_geoms4=HALO_GEOMS4,
        shards_load=str(d / "shards"))
    handle = worker.start(inp, str(d / "inputs.pkl"))

    jl8, jl16 = JLattice(DIMS8), JLattice(DIMS16)

    def ops8(u, x, f):
        fs = jsf.new_fast(jst.new_stag_eo(jl8, u))
        return (jsf.d2ee_fast(fs, x, M8), jsf.d2dd_fast(fs, x, 0),
                jst.dslash_full(jl8, jst.phase_links(jl8, u, "pppa"), f))

    def ops16(fl, ll, x):
        fs = jsf.new_fast3(jst.new_stag3_eo(jl16, fl, ll))
        return (jsf.d2ee3_fast(fs, x, M16), jsf.d2dd3_fast(fs, x, 0),
                jsf.d2dd3_fast(fs, x, 1))

    refs = {"8": [np.asarray(a) for a in compile_ref(ops8, u8, x8, field)(
                u8, x8, field)],
            "16": [np.asarray(a) for a in compile_ref(ops16, fat, long, x16)(
                fat, long, x16)]}
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
