"""CPU float64 reference chain of the north-star composition.

The chain that the port's production HMC is held against: the JAX app
``qex_tpu.apps.staghmc_spv`` on the deck
``qex_tpu_torch/apps/decks/northstar_accept.xml`` (config 4's action,
exp_northstar32.py:45-56: Wilson beta 7.0, Nf=4 staggered at m=0.05,
one Pauli-Villars boson at m=0.5, nHYP (0.4, 0.5, 0.5) on the matter
links, bc pppa, 2MN) on a 4^3x8 lattice, run on the host's CPU in
complex128 (``--cpu`` with x64 enabled).  Modelled on
exp_accept_cpu.py, which does the same for the pure-gauge chain.

Stages:
  a. tune: from a cold start, forced-accept trajectories to thermalise,
     then Metropolis trajectories at step sizes tau / f (g:f:pv = 2:1:1,
     f the smallest count with tau >= 1) chosen by the 2MN scaling
     <dH> ~ eps^4 and then by bisection; the first whose acceptance,
     estimated as <min(1, exp(-dH))>, lies in [0.7, 0.9] is written
     into the deck (tau and the counts).
  b. chains: the app on the deck as it is then, REPLICAS chains side by
     side (the deck's seeds, then serial and parallel seeds offset by
     1, 2, ...), each through its warm-up (no_metropolis_until, forced
     acceptance) and N_MEAS measured trajectories, with ``-pbp_freq``
     from the deck's <pbp_freq> tag (neither app reads that tag
     itself); their ACCEPT / REJECT, MEASplaq, MEASploop and MEASpbp
     lines are parsed and pooled.
  c. quenched control: the deck's LatticeFieldTheory without the
     fermion and boson terms, same beta, volume and integrator,
     QUENCHED_STREAMS chains in processes of their own while the chains
     of stage b run, with the valence condensate (the app's estimator)
     on every QUENCHED_PBP_EVERY-th configuration.

The statistics are those of ``qex_tpu_torch.utils.chain`` (numpy on the
printed numbers), the arithmetic that chip_smoke.py's northstar_accept
gate applies to the card's chain.  The script writes ACCEPT_NS_CPU.json
only if the chain's acceptance lies in (0.5, 0.95) and one gated
observable, the plaquette or the condensate of a sector class, lies at
least Z_FERMION_MIN combined blocked-jackknife errors from the quenched
ensemble's (else the gate could not tell a chain without the
determinant from one with it): at 4^4 the plaquette moves by only
~0.1% (1,500 against 8,000 trajectories resolve 1.2 errors), the
condensate by ~10%.  The app's lines and checkpoints go to
build/accept_ns_cpu/.

Usage:
    python exp_accept_ns_cpu.py [--no-tune] [--n-meas N]
        [--n-quenched N] [--deck PATH] [--out PATH]
"""
import argparse
import copy
import hashlib
import json
import math
import multiprocessing as mp
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
ROOT = Path(__file__).resolve().parent
jax.config.update("jax_compilation_cache_dir", str(ROOT / ".jax_cache"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qex_tpu.apps import staghmc_spv as app  # noqa: E402
from qex_tpu.gauge import loops  # noqa: E402
from qex_tpu.lattice import Lattice  # noqa: E402
from qex_tpu.observables import condensate  # noqa: E402
from qex_tpu.ops import group  # noqa: E402
from qex_tpu.solvers.base import SolverParams  # noqa: E402
from qex_tpu.utils.config import HMCConfig  # noqa: E402
from qex_tpu_torch.utils import chain  # noqa: E402

DECK = ROOT / "qex_tpu_torch" / "apps" / "decks" / "northstar_accept.xml"
OUT = ROOT / "ACCEPT_NS_CPU.json"
LOG_DIR = ROOT / "build" / "accept_ns_cpu"
N_MEAS = 300            # measured trajectories of each chain
REPLICAS = 5            # chains of the deck, seeds offset by 0..4
N_QUENCHED = 6000       # measured trajectories of each quenched chain
QUENCHED_STREAMS = 3    # quenched chains, seeds offset by 0..2
QUENCHED_PBP_EVERY = 4  # their trajectories between valence condensates
TUNE_SEED = 4242
TUNE_THERM = 20         # forced-accept trajectories before the scan
TUNE_SAMPLES = 10       # Metropolis trajectories per step count
TUNE_F_START = 3        # f_steps of the first candidate, at tau 1
TUNE_MAX = 6            # step counts visited at most
ACC_WINDOW = (0.7, 0.9)
MU_TARGET = 0.128       # <dH> at acceptance 0.8 for Gaussian dH:
#                         (2 erfcinv(0.8))^2
ACCEPT_RANGE = (0.5, 0.95)
Z_FERMION_MIN = 5.0
MIN_MEAS, MIN_QUENCHED = 200, 100
CHUNK = 100             # trajectories of one app process (see run_app)
SERIES = ("plaq", "pbp", "ploop_re", "ploop_im", "dH", "accepted")


def deck_sha256(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def deck_pbp_freq(path) -> int:
    m = re.search(r"<pbp_freq>\s*(\d+)\s*</pbp_freq>",
                  Path(path).read_text())
    return int(m.group(1)) if m else 0


def write_steps(path, f: int, tau: float) -> None:
    """Set tau, g_steps = 2f and f_steps = pv_steps = f in the deck,
    leaving every other byte as it was."""
    text = Path(path).read_text()
    for tag, v in (("tau", tau), ("g_steps", 2 * f), ("f_steps", f),
                   ("pv_steps", f)):
        text, k = re.subn(rf"<{tag}>[^<]*</{tag}>", f"<{tag}>{v}</{tag}>",
                          text)
        if k != 1:
            raise ValueError(f"{path}: {k} <{tag}> tags")
    Path(path).write_text(text)


def est_acceptance(dhs) -> float:
    return float(np.mean(np.minimum(1.0, np.exp(-np.asarray(dhs)))))


def tune(deck) -> dict:
    """Stage a: the step-size scan from a thermalised field.

    A candidate is a step size eps = tau / f, run as the smallest count f
    with tau = f eps >= 1 (g:f:pv = 2:1:1).  From the first, (f, tau) =
    (TUNE_F_START, 1), the next eps follows the 2MN scaling <dH> ~ eps^4
    towards <dH> = MU_TARGET until one candidate's acceptance lies above
    the window and one below; then eps is bisected between them.  The
    first candidate inside the window is written into the deck."""
    cfg = HMCConfig.from_xml(str(deck))
    lat = Lattice(cfg.dims)

    def stepper(f, tau):
        c = copy.copy(cfg)
        c.tau, c.g_steps, c.f_steps, c.pv_steps = tau, 2 * f, f, f
        th = app.build_theory(c, lat, jnp.complex128)
        return jax.jit(lambda k, uu, w: th.hmc_step(k, uu, always_accept=w))

    t0 = time.time()
    key = jax.random.PRNGKey(TUNE_SEED)
    u = group.unit_gauge(lat, jnp.complex128)
    f, tau = TUNE_F_START, 1.0
    step = stepper(f, tau)
    n = 0
    for _ in range(TUNE_THERM):
        u, st = step(jax.random.fold_in(key, n), u, True)
        n += 1
        print(f"tune therm {n}: dH {float(st.dH):+.4f} ({time.time()-t0:.0f}"
              " s)", flush=True)
    scan = []
    eps_above, eps_below = 0.0, math.inf    # acceptance above / below
    chosen = None
    while len(scan) < TUNE_MAX:
        dhs = []
        for _ in range(TUNE_SAMPLES):
            u, st = step(jax.random.fold_in(key, n), u, False)
            n += 1
            dhs.append(float(st.dH))
        acc = est_acceptance(dhs)
        scan.append({"f_steps": f, "tau": tau, "dH": dhs,
                     "est_acceptance": acc, "seconds": time.time() - t0})
        print(f"tune f_steps={f} tau={tau}: est. acceptance {acc:.3f} dH "
              f"{['%+.4f' % d for d in dhs]} ({time.time()-t0:.0f} s)",
              flush=True)
        if ACC_WINDOW[0] <= acc <= ACC_WINDOW[1]:
            chosen = (f, tau)
            break
        eps = tau / f
        if acc > ACC_WINDOW[1]:
            eps_above = max(eps_above, eps)
        else:
            eps_below = min(eps_below, eps)
        if eps_above > 0 and eps_below < math.inf:
            eps = 0.5 * (eps_above + eps_below)
        else:
            mu = max(float(np.mean(dhs)), float(np.var(dhs)) / 2, 1e-6)
            eps *= (MU_TARGET / mu) ** 0.25
        f = math.ceil(1.0 / eps - 1e-9)
        tau = round(f * eps, 3)
        step = stepper(f, tau)
    if chosen is None:
        raise SystemExit(f"tune: no step size in {ACC_WINDOW}: {scan}")
    write_steps(deck, *chosen)
    print(f"tune: chose tau={chosen[1]}, f_steps={chosen[0]} (g "
          f"{2*chosen[0]}, pv {chosen[0]}), written into the deck",
          flush=True)
    return {"chosen": {"tau": chosen[1], "f_steps": chosen[0]},
            "therm": TUNE_THERM, "samples": TUNE_SAMPLES, "seed": TUNE_SEED,
            "scan": scan, "seconds": time.time() - t0}


def run_app(deck, ntraj: int, extra: list, name: str) -> list:
    """The JAX app on the deck for ntraj trajectories, one chain run in
    processes of CHUNK trajectories each, every one resuming from the
    checkpoint of the one before.  The app's eager condensate leaves
    ~330 memory maps of compiled code behind each call, so one process
    reaches the kernel's 65,530 maps after ~190 trajectories and dies
    (a segmentation fault).  The app draws from (seed, trajectory), so
    the pieces are the chain that one process would run.  Returns the
    app's lines, also written to LOG_DIR / <name>.log."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(ROOT / ".jax_cache"))
    lines, done = [], 0
    while done < ntraj:
        n = min(CHUNK, ntraj - done)
        argv = [sys.executable, "-m", "qex_tpu.apps.staghmc_spv", "--xml",
                str(deck), "--cpu", "--ntraj", str(n),
                f"-save_freq={CHUNK}", f"-save_path={LOG_DIR}",
                f"-save_filename={name}", *extra]
        if done:
            argv.append(f"-start_config={done}")
        p = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                           text=True)
        lines += p.stdout.splitlines()
        print(f"{name}: {done + n} of {ntraj} trajectories", flush=True)
        if p.returncode != 0:
            raise SystemExit(f"staghmc_spv exited {p.returncode}: "
                             f"{p.stderr[-2000:]}")
        done += n
    (LOG_DIR / f"{name}.log").write_text("\n".join(lines) + "\n")
    return lines


def quenched(cfg, n_warm: int, n_meas: int, stream: int) -> dict:
    """Stage c, one of QUENCHED_STREAMS chains: the deck's
    LatticeFieldTheory without its fermion and boson terms, from cold,
    n_warm forced and n_meas Metropolis trajectories in jitted scans
    (the app would spend ~1.5 s a trajectory outside the step), seeds
    offset by ``stream``; after every QUENCHED_PBP_EVERY-th the valence
    condensate (the app's estimator: one z4 noise, a_tol) and the
    Polyakov loop."""
    c = copy.copy(cfg)
    c.nf, c.num_pv, c.matter_smearing = 0, 0, "none"
    lat = Lattice(c.dims)
    th = app.build_theory(c, lat, jnp.complex128)
    params = SolverParams(r2req=c.a_tol, maxits=c.a_maxits, restarts=3)

    def scan(warm):
        def body(u, k):
            u, st = th.hmc_step(k, u, always_accept=warm)
            return u, (jnp.real(loops.plaquette(lat, u)), st.dH,
                       st.accepted)
        return jax.jit(lambda u, keys: jax.lax.scan(body, u, keys))

    @jax.jit
    def measure(u, k):
        pl = loops.polyakov_loop(lat, u)
        return (condensate.pbp_staggered(k, lat, u, c.mass, bc=c.bc,
                                         params=params),
                jnp.real(pl), jnp.imag(pl))

    key = jax.random.PRNGKey(c.serial_seed + stream)
    u = group.unit_gauge(lat, jnp.complex128)
    u, _ = scan(True)(u, jax.random.split(jax.random.fold_in(key, 0),
                                          n_warm))
    run = scan(False)
    out = {"plaq": [], "dH": [], "accepted": []}
    val = {k: [] for k in ("plaq", "dH", "accepted", "pbp", "ploop_re",
                           "ploop_im")}
    for b in range(n_meas // QUENCHED_PBP_EVERY):
        u, (pl, dh, acc) = run(u, jax.random.split(
            jax.random.fold_in(key, b + 1), QUENCHED_PBP_EVERY))
        out["plaq"] += [float(x) for x in pl]
        out["dH"] += [float(x) for x in dh]
        out["accepted"] += [bool(x) for x in acc]
        pbp, re_, im = measure(u, jax.random.fold_in(
            jax.random.PRNGKey(c.parallel_seed + stream), b))
        for k, v in (("plaq", out["plaq"][-1]), ("dH", out["dH"][-1]),
                     ("accepted", out["accepted"][-1]), ("pbp", float(pbp)),
                     ("ploop_re", float(re_)), ("ploop_im", float(im))):
            val[k].append(v)
    return dict(out, valence=val)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-tune", action="store_true",
                    help="keep the deck's step counts (skip stage a)")
    ap.add_argument("--n-meas", type=int, default=N_MEAS)
    ap.add_argument("--n-quenched", type=int, default=N_QUENCHED)
    ap.add_argument("--deck", default=str(DECK))
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    t0 = time.time()
    tuned = None if args.no_tune else tune(args.deck)
    cfg = HMCConfig.from_xml(args.deck)
    sha = deck_sha256(args.deck)
    pbp_freq = deck_pbp_freq(args.deck)
    warm = cfg.no_metropolis_until

    # stage b, REPLICAS chains of the deck side by side (replica 0 on
    # the deck's own seeds), while this process runs stage c
    t1 = time.time()
    with ThreadPoolExecutor(REPLICAS) as ex, ProcessPoolExecutor(
            QUENCHED_STREAMS, mp_context=mp.get_context("spawn")) as pex:
        futures = [ex.submit(
            run_app, args.deck, warm + args.n_meas,
            [f"-pbp_freq={pbp_freq}", f"-serial_seed={cfg.serial_seed + r}",
             f"-parallel_seed={cfg.parallel_seed + r}"], f"chain{r}")
            for r in range(REPLICAS)]
        qs = [pex.submit(quenched, cfg, warm, args.n_quenched, k)
              for k in range(QUENCHED_STREAMS)]
        qs = [q.result() for q in qs]
        t2 = time.time()
        reps = [chain.parse_app_lines(f.result()) for f in futures]
    t3 = time.time()
    dyn = {k: [x for rep in reps for x in rep[k]] for k in SERIES}
    que = {k: [x for q in qs for x in q[k]] for k in ("plaq", "dH",
                                                      "accepted")}
    que["valence"] = {k: [x for q in qs for x in q["valence"][k]]
                      for k in qs[0]["valence"]}

    st_dyn = chain.chain_stats(dyn)
    st_que = chain.blocked(que, ["plaq"])
    st_val = chain.chain_stats(que["valence"])
    acc = sum(dyn["accepted"]) / len(dyn["accepted"])
    # the determinant's mark: on the plaquette, and on the condensate of
    # each sector class both ensembles hold in half their blocks
    z_fermion = {"plaq": chain.z_score(st_dyn["plaq"], st_que["plaq"])}
    for cls in chain.CLASSES:
        if 2 * st_dyn[cls]["blocks"] >= st_dyn["pbp_n_blocks"] \
                and 2 * st_val[cls]["blocks"] >= st_val["pbp_n_blocks"]:
            z_fermion[cls] = chain.z_score(st_dyn[cls], st_val[cls])
    z = max(z_fermion.values())
    rec = {"backend": "jax_cpu_complex128",
           "app": "qex_tpu.apps.staghmc_spv",
           "deck": str(Path(args.deck).resolve().relative_to(ROOT))
           if Path(args.deck).resolve().is_relative_to(ROOT) else args.deck,
           "deck_sha256": sha, "lattice": list(cfg.dims), "beta": cfg.beta,
           "tau": cfg.tau, "g_steps": cfg.g_steps, "f_steps": cfg.f_steps,
           "pv_steps": cfg.pv_steps, "warmup": warm, "pbp_freq": pbp_freq,
           "replicas": REPLICAS,
           "replica_n_meas": [len(rep["dH"]) for rep in reps],
           "n_meas": len(dyn["dH"]), "acceptance": acc,
           "series": dyn, "warmup_series": [rep["warmup"] for rep in reps],
           "stats": st_dyn,
           "quenched": {"streams": QUENCHED_STREAMS,
                        "n_meas": len(que["dH"]),
                        "acceptance": sum(que["accepted"])
                        / len(que["accepted"]),
                        "series": {k: que[k] for k in
                                   ("plaq", "dH", "accepted")},
                        "stats": st_que,
                        "valence_every": QUENCHED_PBP_EVERY,
                        "valence": que["valence"],
                        "valence_stats": st_val},
           "z_fermion_by": z_fermion, "z_fermion": z, "tune": tuned,
           "seconds": {"tune": t1 - t0 if tuned else 0.0,
                       "quenched": t2 - t1, "chains": t3 - t1,
                       "chain_per_traj": (t3 - t1) / (warm + args.n_meas),
                       "total": t3 - t0}}
    print(f"chain: acceptance {acc:.3f}, block {st_dyn['block']}, "
          f"stats {st_dyn}; quenched {st_que}, valence {st_val}; "
          f"z_fermion {z_fermion}",
          flush=True)
    refuse = []
    if not ACCEPT_RANGE[0] < acc < ACCEPT_RANGE[1]:
        refuse.append(f"acceptance {acc:.3f} outside {ACCEPT_RANGE}")
    if not z >= Z_FERMION_MIN:
        refuse.append(f"z_fermion {z:.2f} < {Z_FERMION_MIN}")
    if rec["n_meas"] < MIN_MEAS or rec["quenched"]["n_meas"] < MIN_QUENCHED:
        refuse.append(f"{rec['n_meas']} / {rec['quenched']['n_meas']} "
                      f"measured trajectories, below {MIN_MEAS} / "
                      f"{MIN_QUENCHED}")
    if refuse:
        (LOG_DIR / "refused.json").write_text(json.dumps(rec) + "\n")
        print("refused: " + "; ".join(refuse), flush=True)
        return 1
    Path(args.out).write_text(json.dumps(rec) + "\n")
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
