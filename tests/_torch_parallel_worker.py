"""Rank side of tests/test_torch_parallel.py: a gloo group of four host
processes running the port's multi-rank code (torch and qex_tpu_torch
only, so that a rank does not pay for importing jax).

:func:`start` starts the ranks and returns at once, so that the test
can compute its references meanwhile; :func:`results` waits for them.
Each rank runs :func:`checks`: first the two-rank checks, ranks {0, 1}
and {2, 3} each in a subgroup of their own at the same time (each pair
its share), then the four-rank checks on the whole group.  Ranks 0 and
2 hand back their results as numpy arrays and numbers."""

from __future__ import annotations

import os
import pickle
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

NRANKS = 4


def start(inputs: dict, path: str):
    """Start the ranks on ``inputs``, handed over through the pickle file
    ``path`` (so that starting a rank does not wait for the one before
    to import torch and read them); returns the handle for
    :func:`results`."""
    from qex_tpu_torch.parallel.distributed import free_port
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank, args=(f"tcp://localhost:{free_port()}", path, queue),
        nprocs=NRANKS, join=False, start_method="spawn")
    return procs, queue


def results(handle, timeout: float = 300.0) -> dict:
    """The merged results of ranks 0 and 2; raises if a rank fails or
    the ranks outlast ``timeout`` seconds."""
    procs, queue = handle
    deadline = time.monotonic() + timeout
    res, parts = {}, 0
    try:
        while parts < 2:
            if not queue.empty():
                res.update(queue.get())
                parts += 1
            elif procs.join(timeout=0.05):
                if queue.empty():
                    raise RuntimeError("the ranks ended without results")
            elif time.monotonic() > deadline:
                raise TimeoutError(f"the ranks outlasted {timeout} s")
        while not procs.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks outlasted {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    return res


def _rank(rank: int, init: str, path: str, queue) -> None:
    torch.set_num_threads(1)
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    # a timeout, so that a rank left waiting fails instead of hanging
    dist.init_process_group("gloo", init_method=init, world_size=NRANKS,
                            rank=rank, timeout=timedelta(seconds=120))
    try:
        out = checks(rank, inputs)
        if rank in (0, 2):
            queue.put(out)
    finally:
        dist.destroy_process_group()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _n(x):
    return x.detach().cpu().resolve_conj().numpy()


def config4(lat, mesh=None, **kw):
    """The config-4 composition (nHYP-smeared staggered fermion + PV
    boson over a Wilson gauge action) cut to a short trajectory."""
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.solvers.base import SolverParams
    return LatticeFieldTheory(
        lat, gauge=GaugeActionSpec(ga.wilson(6.0), steps=2, scheme="2MN"),
        fermions=[FermionSpec("fermion", mass=0.3, steps=1, scheme="2MN"),
                  FermionSpec("boson", mass=0.6, steps=1, scheme="2MN")],
        smear=HypCoefs(), bc="pppa",
        solver_params=SolverParams(r2req=1e-20, maxits=1500, restarts=3,
                                   mesh=mesh),
        force_solver_params=SolverParams(r2req=1e-18, maxits=1500,
                                         restarts=3, mesh=mesh),
        tau=0.2)


FG_COEFFS = dict(plaq=5.0, rect=-0.4, pgm=-0.05)
WILSON_PARAMS = dict(r2req=1e-18, maxits=300, restarts=2)
# the JAX sharding test's tolerance and seed; a Chebyshev degree of 4 and
# a basis of 32 take 1328 operator applies where the defaults take 3168,
# each of which exchanges faces on blocks
EIG_ARGS = dict(tol=1e-10, seed=1, degree=4, m=32)


def halo_grads(ff, ww, tt):
    """(value, gradient, Hessian-vector product, jvp, func.grad) of a
    sum of shifted products, the shifts crossing the z and t faces (on
    blocks inside ``use_mesh``; whole fields outside)."""
    from qex_tpu_torch.ops.shifts import shift
    from qex_tpu_torch.parallel import halo

    def obj(f):
        y = shift(f, 2, +1) * shift(f.conj(), 3, -1, dist=2) \
            + shift(f, 3, +1) * shift(f, 2, -1, dist=2).conj()
        return halo.site_sum((y * ww).real)
    fr = ff.detach().requires_grad_(True)
    v = obj(fr)
    (g,) = torch.autograd.grad(v, fr, create_graph=True)
    (h,) = torch.autograd.grad(halo.site_sum((g * tt.conj()).real), fr)
    _, j = torch.func.jvp(obj, (ff,), (tt,))
    return v.detach(), g.detach(), h, j, torch.func.grad(obj)(ff)


def block_checks(inp: dict, geom, group, four: bool) -> dict:
    """The block-resident path over ``geom``: halo shifts and global
    sums against whole-field rolls computed here, phases, smear, HISQ
    links and their pullbacks, forces (torch.func.grad, the jvp
    force-gradient kick), Wilson solve, eigensolve and a config-4
    trajectory, gathered for the test's references; with ``four`` the
    HISQ heatbath, action and force and the shapes reaching the solver
    and the integrator too."""
    from qex_tpu_torch.eigens import hisqev
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge import fat7, smear
    from qex_tpu_torch.hmc import hmc as hmc_mod
    from qex_tpu_torch.hmc.integrators import fg_force
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.parallel import halo
    from qex_tpu_torch.parallel.mesh import (gather_field, local_block,
                                             make_lattice_mesh, use_mesh)
    from qex_tpu_torch.physics import stag_hmc, stag_shard
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.solvers import cg
    from qex_tpu_torch.solvers.base import SolverParams

    lat = Lattice(inp["blk_dims"])
    lm = make_lattice_mesh(lat, geom, group=group)
    u = _t(inp["u_blk"])
    ub = local_block(lm, u)
    out = {}

    def g(x, layout="full"):
        return _n(gather_field(lm, x, layout))

    # halo shifts and global sums, against the whole field's rolls
    ff, ww, tt = (_t(inp[k]) for k in ("fw", "ww", "tw"))
    ref = halo_grads(ff, ww, tt)
    with use_mesh(lm):
        got = halo_grads(*(local_block(lm, x) for x in (ff, ww, tt)))
    out["halo_value"] = (float(got[0]), float(ref[0]))
    out["halo_jvp"] = (float(got[3]), float(ref[3]))
    out["halo_grad_equal"] = [bool(torch.equal(gather_field(lm, a), b))
                              for a, b in ((got[1], ref[1]),
                                           (got[2], ref[2]),
                                           (got[4], ref[4]))]
    xb = local_block(lm, ff).requires_grad_(True)
    (gs,) = torch.autograd.grad(halo.global_sum(lm, (xb * xb.conj()).real),
                                xb)
    out["global_sum_grad_equal"] = bool(torch.equal(gather_field(lm, gs),
                                                    2 * ff))
    with use_mesh(lm):
        ph = (st.staggered_phases(lat, torch.float64, "cpu"),
              st.bc_signs(lat, "pppa", torch.float64, "cpu"))
    out["phases_equal"] = all(
        torch.equal(gather_field(lm, a), b) for a, b in zip(ph, (
            st.staggered_phases(lat, torch.float64, "cpu"),
            st.bc_signs(lat, "pppa", torch.float64, "cpu"))))

    # smear and HISQ links, forward and pullback; the gauge forces
    with use_mesh(lm):
        out["nhyp"] = g(smear.nhyp_smear(smear.HypCoefs(), lat, ub))
        out["nhyp_pullback"] = g(smear.smeared_force(
            smear.HypCoefs(), lat, ub, local_block(lm, _t(inp["chain_v"]))))
        with torch.enable_grad():
            uu = ub.clone().requires_grad_(True)
            fl, ll = fat7.hisq_links(lat, uu)
            (gf,) = torch.autograd.grad((fl, ll), uu, grad_outputs=(
                local_block(lm, _t(inp["chain_f"])),
                local_block(lm, _t(inp["chain_l"]))))
        out["fat"], out["long"] = g(fl.detach()), g(ll.detach())
        out["fat_pullback"] = g(gf)
        c = ga.GaugeActionCoeffs(**FG_COEFFS)
        out["gauge_force"] = g(ga.gauge_force(c, lat, ub))
        out["fg_kick"] = g(fg_force(ub, 0.02,
                                    lambda x: ga.gauge_force(c, lat, x),
                                    hmc_mod.gauge_update_u))
        # the Wilson eo solve on blocks
        w = wl.new_wilson_eo(lat, ub, 0.3)
        x, stats = wl.solve_eo(w, local_block(lm, _t(inp["wil_b"])),
                               SolverParams(**WILSON_PARAMS))
    out["wilson"] = (g(x), stats.iterations)
    lat4 = Lattice(inp["eig_dims"])
    lm4 = make_lattice_mesh(lat4, geom, group=group)
    with use_mesh(lm4):
        r = hisqev.stag_eigs(lat4, local_block(lm4, _t(inp["u_eig"])), 4,
                             **EIG_ARGS)
    out["eigs"] = np.asarray(r.evals)

    # one config-4 trajectory on blocks (the shapes reaching the
    # solver and the integrator recorded, and gather_fast counted)
    shapes, gathers = set(), [0]
    solve0, update0, gather0 = (cg.cg_solve_restarted,
                                hmc_mod.gauge_update_u, stag_shard.gather_fast)

    def solve(op, b, *a, **k):
        shapes.add(("solve", tuple(b.shape)))
        return solve0(op, b, *a, **k)

    def update(uu, p, eps):
        shapes.add(("update", tuple(uu.shape), tuple(p.shape)))
        return update0(uu, p, eps)

    def gather(*a, **k):
        gathers[0] += 1
        return gather0(*a, **k)
    cg.cg_solve_restarted, hmc_mod.gauge_update_u = solve, update
    stag_shard.gather_fast = gather
    try:
        u1, state = config4(lat, lm).hmc_step(
            torch.Generator().manual_seed(6), ub, always_accept=True)
    finally:
        cg.cg_solve_restarted, hmc_mod.gauge_update_u = solve0, update0
        stag_shard.gather_fast = gather0
    out["config4"] = (state.dH, g(u1))
    out["config4_shapes"] = sorted(shapes)
    out["config4_gathers"] = gathers[0]
    out["local_dims"] = lm.local_dims

    if four:
        ferm = stag_hmc.HisqFermion(lat, 0.3, params=SolverParams(
            r2req=1e-20, maxits=1500, restarts=3))
        with use_mesh(lm):
            phi = ferm.heatbath_from_noise(
                local_block(lm, _t(inp["xi_h"])), ub)
            act = ferm.make_action_fn()
            s_h = float(act(ub, phi))
            f_h = ga.force_from_action(lambda uu: act(uu, phi), ub)
        out["hisq"] = (g(phi, "eo"), s_h, g(f_h))
    return out


def checks(rank: int, inp: dict) -> dict:
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.io import pario
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.ops import linalg
    from qex_tpu_torch.ops.shifts import shift
    from qex_tpu_torch.parallel import distributed as pdist
    from qex_tpu_torch.parallel import dryrun, halo
    from qex_tpu_torch.parallel.mesh import (gather_field, local_block,
                                             make_lattice_mesh, use_mesh)
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_shard as shd
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers.base import SolverParams

    lat8, lat16 = Lattice(inp["dims8"]), Lattice(inp["dims16"])
    s8 = st.new_stag_eo(lat8, _t(inp["u8"]))
    fs8 = sf.new_fast(s8)
    s16 = st.new_stag3_eo(lat16, _t(inp["fat"]), _t(inp["long"]))
    fs16 = sf.new_fast3(s16)
    full = _t(inp["field"])
    g8 = st.phase_links(lat8, _t(inp["u8"]))
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pg = pairs[rank // 2]
    todo = inp["pair_a"] if rank < 2 else inp["pair_b"]
    out = {}

    def operators(geom, group):
        for kind, lat, f, ops, x in (("8", lat8, fs8, shd.ops8, inp["x8"]),
                                     ("16", lat16, fs16, shd.ops16,
                                      inp["x16"])):
            lm = make_lattice_mesh(lat, geom, group=group)
            ee, dd = ops(lm, shd.block_of(lm, f))
            xb = shd.fast_block(lm, _t(x))
            out[("ee", kind, geom)] = _n(shd.gather_fast(
                lm, ee(xb, inp["m" + kind])))
            out[("dd", kind, geom)] = _n(shd.gather_fast(lm, dd(xb)))
            if kind == "16":
                with use_mesh(lm):
                    p = sh.new_hisq16(shd.block_of(lm, f), torch.float64)
                out[("dd1", kind, geom)] = _n(shd.gather_fast(
                    lm, shd.d2dd3_sharded(lm, p, xb, parity=1)))

    def halos(geom, group):
        lm = make_lattice_mesh(lat8, geom, group=group)
        vb = local_block(lm, full)
        exact = True
        for mu in range(4):
            for sign in (1, -1):
                for d in (1, 2):
                    if d >= lm.local_dims[mu]:
                        continue           # a halo as deep as the block
                    got = gather_field(lm, halo.shift_halo(lm, vb, mu, sign,
                                                           d))
                    exact &= torch.equal(got, shift(full, mu, sign, 4, d))
        out[("shift_exact", geom)] = bool(exact)
        out[("norm2", geom)] = float(halo.norm2_sharded(lm, vb))
        out[("dot", geom)] = complex(halo.dot_sharded(
            lm, vb, local_block(lm, torch.roll(full, 1, -1))))
        out[("dslash", geom)] = _n(gather_field(
            lm, halo.dslash_full_sharded(lm, local_block(lm, g8), vb)))

    def solve_ee(geom, group):
        lm = make_lattice_mesh(lat8, geom, group=group)
        b_e = sf.from_fast(_t(inp["x8"]), lat8)
        x_e, _ = shd.solve_ee_sharded(
            lm, shd.block_of(lm, fs8), local_block(lm, b_e, "eo"), 0.25,
            SolverParams(r2req=1e-20, maxits=300, restarts=2))
        x_e = gather_field(lm, x_e, "eo")
        out[("solve_ee", geom)] = float(
            linalg.norm2(st.d2ee(s8, x_e, 0.25) - b_e) / linalg.norm2(b_e))

    def solve_multi(geom, group):
        lm = make_lattice_mesh(lat16, geom, group=group)
        b3 = sf.from_fast(_t(inp["x16"]), lat16)
        xs, _ = shd.solve_multi_sharded(
            lm, shd.block_of(lm, fs16), local_block(lm, b3, "eo"),
            inp["masses"], SolverParams(r2req=1e-24, maxits=4000))
        xs = [gather_field(lm, x, "eo") for x in xs]
        out[("solve_multi", geom)] = [
            float(linalg.norm2(st.d2ee3(s16, x, m) - b3) / linalg.norm2(b3))
            for m, x in zip(inp["masses"], xs)]

    def hmc(geom, group):
        lat = Lattice(inp["hmc_dims"])
        theory = LatticeFieldTheory(
            lat, GaugeActionSpec(ga.wilson(5.5), steps=4, scheme="2MN"),
            fermions=[FermionSpec("fermion", 0.5, steps=2, scheme="2MN",
                                  smeared=False),
                      FermionSpec("boson", 0.8, steps=2, scheme="2MN",
                                  smeared=False)],
            smear=None, bc="pppa",
            solver_params=SolverParams(
                r2req=1e-14, maxits=300, restarts=2,
                mesh=make_lattice_mesh(lat, geom, group=group)),
            tau=0.2)
        lm = theory.mesh
        u1, state = theory.hmc_step(torch.Generator().manual_seed(6),
                                    local_block(lm, _t(inp["u_hmc"])))
        out["hmc"] = (state.dH, _n(gather_field(lm, u1)))

    # --- two ranks, each pair on its own --------------------------------
    app = None
    if rank == 2 and todo.get("app_argv"):
        # the app under torchrun, two processes of its own, while the
        # pairs run their checks
        import subprocess
        import sys
        app = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "2", "--master_port",
             str(todo["app_port"]), "-m", "qex_tpu_torch.apps.staghmc_spv",
             *todo["app_argv"]], cwd=todo["app_dir"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=todo["app_path"]))
    for geom in todo["geoms"]:
        operators(geom, pg)
    for geom in todo["halo_geoms"]:
        halos(geom, pg)
    if todo.get("shards_save"):
        lm = make_lattice_mesh(lat8, (1, 1, 2, 1), group=pg)
        pdist.save_shards(todo["shards_save"], lm, local_block(lm, full))
        back = pdist.load_shards(todo["shards_save"], lm, 1)
        out["shards_same"] = bool(torch.equal(back, local_block(lm, full)))
    if todo.get("pario_dir"):
        d = todo["pario_dir"]
        latg = Lattice(inp["gauge_dims"])
        lm = make_lattice_mesh(latg, (1, 1, 1, 2), group=pg)
        blk = local_block(lm, _t(inp["gauge"]))
        for prec in ("F", "D"):
            pario.save_gauge_parallel(os.path.join(d, f"par_{prec}.lime"),
                                      latg, lm, blk, precision=prec)
        back = pario.load_gauge_parallel(os.path.join(d, "par_D.lime"), latg,
                                         lm, dtype=np.complex128)
        out["pario_roundtrip"] = bool(torch.equal(back, blk))
        ref = pario.load_gauge_parallel(todo["serial_file"], latg, lm,
                                        dtype=np.complex128)
        out["pario_reads_serial"] = bool(torch.equal(ref, blk))
        bad = os.path.join(d, "bad.lime")
        if lm.rank == 0:
            raw = bytearray(open(os.path.join(d, "par_D.lime"), "rb").read())
            off = dict((t, o) for t, o, _ in pario._scan_records(
                os.path.join(d, "par_D.lime")))["scidac-binary-data"]
            raw[off + 123] ^= 0xFF
            open(bad, "wb").write(bytes(raw))
        lm.barrier()
        try:
            pario.load_gauge_parallel(bad, latg, lm)
            out["pario_corruption"] = "not detected"
        except ValueError as e:
            out["pario_corruption"] = str(e)
    if todo.get("dryrun"):
        out["dryrun"] = dryrun.body("cpu", 2, *todo["dryrun"], pg=pg)
    for geom in todo.get("solve_ee", ()):
        solve_ee(geom, pg)
    for geom in todo.get("solve_multi", ()):
        solve_multi(geom, pg)
    if todo.get("hmc"):
        hmc(todo["hmc"], pg)
    for geom in todo["geoms"]:
        out[("blocks", geom)] = block_checks(inp, geom, pg, four=False)
    if app is not None:
        stdout, stderr = app.communicate(timeout=240)
        out["app"] = (app.returncode, stdout, stderr[-4000:])
    dist.barrier()

    # --- four ranks (rank 0 reports them) ------------------------------
    pair_out, out = out, {}
    for geom in inp["geoms4"]:
        operators(geom, None)
    for geom in inp["halo_geoms4"]:
        halos(geom, None)
    geom = inp["geoms4"][0]
    solve_ee(geom, None)
    out[("blocks", geom)] = block_checks(inp, geom, None, four=True)

    if inp.get("shards_load"):
        # the pair's checkpoint, re-cut for four ranks of another geometry
        lm = make_lattice_mesh(lat8, geom)
        back = pdist.load_shards(inp["shards_load"], lm, 1)
        out["shards_recut"] = bool(torch.equal(back, local_block(lm, full)))
    return {**pair_out, **(out if rank == 0 else {})}
