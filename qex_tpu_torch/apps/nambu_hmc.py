"""Pure-gauge Nambu HMC: two adjoint momenta and a guide action (port of
``qex_tpu.apps.nambu_hmc``; QEX src/nhmc/puregaugenhmc.nim).

The guide is any gauge action on ``nstout`` stout-smeared links, or the
clover topological-charge term (``TopoClover*``, optionally with the
metadynamics bias of ``*Meta``); its force is autograd through
``gauge.smear.stout_smear`` and ``gauge.loops.topo_charge_clover``.
Metropolis on the exact target Hamiltonian.

Usage (QEX letParam-style flags):
    python -m qex_tpu_torch.apps.nambu_hmc -lat:16,16,16,16 -beta:6.0 \
        -nact:WilsonStout -nstout:3 -rho:0.1 -nbeta:6.0 \
        -tau:1.0 -steps:50 -trajs:10 [-cpu:true]

It runs on the CUDA card in complex64 (and raises without one);
``-cpu:true`` runs on the host in complex128.  Prints ``traj n: dH ..
dG .. ACCEPT|REJECT MEASplaq .. MEAStopo ..`` lines.
"""

from __future__ import annotations

import sys
import time
from functools import partial

import numpy as np
import torch


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    from qex_tpu_torch.device import resolve
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.gauge.smear import StoutCoefs, stout_smear
    from qex_tpu_torch.hmc import nambu
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import group
    from qex_tpu_torch.utils.params import Params
    prm = Params(argv)
    lat_dims = prm.int_seq_param("lat", [8, 8, 8, 8], "lattice size")
    gact = prm.str_param("gact", "Wilson",
                         "target action: Wilson|Rect|Adjoint|...")
    nact = prm.str_param("nact", "WilsonStout",
                         "guide action (optionally *Stout, TopoClover*)")
    beta = prm.float_param("beta", 6.0, "target coupling")
    nbeta = prm.float_param("nbeta", 0.0, "guide coupling (0 -> beta)")
    adj_fac = prm.float_param("adjFac", -0.25, "adjoint ratio")
    rect_fac = prm.float_param("rectFac", -1.0 / 12.0, "rect c1")
    nstout = prm.int_param("nstout", 3, "stout steps in guide")
    rho = prm.float_param("rho", 0.1, "stout rho")
    beta_q = prm.float_param("betaQ", 1.0, "topo-term coefficient")
    tau = prm.float_param("tau", 1.0, "trajectory length")
    steps = prm.int_param("steps", 50, "MD steps")
    trajs = prm.int_param("trajs", 10, "trajectories")
    warmup = prm.int_param("noMetropolisUntil", 1, "warmup trajs")
    seed = prm.int_param("seed", 987654321, "RNG seed")
    use_cpu = prm.bool_param("cpu", False, "run on the host")
    amp = prm.float_param("amplitude", 1.0, "metadynamics bump height")
    sdev = prm.float_param("sdev", 5.0, "metadynamics bump width")
    if prm.unknown():
        print(f"# warning: unused params {prm.unknown()}", file=sys.stderr)

    device = resolve("cpu" if use_cpu else None)
    dtype = torch.complex128 if use_cpu else torch.complex64
    lat = Lattice(tuple(lat_dims))
    nbeta = nbeta or beta

    def coeffs(name, b):
        n = (name.lower().replace("meta", "").replace("stout", "")
             .replace("topoclover", "wilson").replace("act", ""))
        table = {"wilson": ga.wilson(b), "": ga.wilson(b),
                 "rect": ga.gauge_act_rect(b, rect_fac),
                 "adjoint": ga.adjoint_action(b, adj_fac),
                 "symanzik": ga.symanzik(b),
                 "iwasaki": ga.iwasaki(b), "dbw2": ga.dbw2(b)}
        if n not in table:
            raise ValueError(f"unknown action {name!r}")
        return table[n]

    tcoef, gcoef = coeffs(gact, beta), coeffs(nact, nbeta)
    target = partial(ga.full_action, tcoef, lat)
    target_force = partial(ga.gauge_force, tcoef, lat)
    use_stout = "stout" in nact.lower()
    use_topo = "topoclover" in nact.lower()
    use_meta = "meta" in nact.lower()
    gens = nambu.generators(lat.nc, dtype, device)

    def smeared(uu):
        for _ in range(nstout if use_stout else 0):
            uu = stout_smear(StoutCoefs(rho), lat, uu)
        return uu

    def guide(uu):
        v = smeared(uu)
        if use_topo:
            q = loops.topo_charge_clover(lat, v)
            return beta_q * q * q
        return ga.full_action(gcoef, lat, v)

    print(f"# nambu_hmc {lat.dims} target={gact}@{beta} "
          f"guide={nact}@{nbeta} nstout={nstout} rho={rho} "
          f"meta={use_meta} device={device}")
    if use_meta:
        # NActTopoCloverStoutMeta: the bias over the deposited charge
        # history drives the dynamics
        hist = nambu.MetaHistory()

        def system():
            centers, counts = hist.arrays(device)

            def guide_m(w):
                q = loops.topo_charge_clover(lat, smeared(w))
                return nambu.metadynamics_bias(q, centers, counts, amp, sdev)
            return nambu.NambuSystem(target, guide_m, gens,
                                     target_force=target_force)
    else:
        gf = (partial(ga.gauge_force, gcoef, lat)
              if not (use_stout or use_topo) else None)
        fixed = nambu.NambuSystem(target, guide, gens,
                                  target_force=target_force, guide_force=gf)

        def system():
            return fixed

    def meas(uu):
        return (np.float32(float(loops.plaquette(lat, uu))),
                np.float32(float(loops.topo_charge_clover(lat, uu))))

    gen = torch.Generator(device=device).manual_seed(seed)
    u = group.unit_gauge(lat, dtype, device)
    n_acc = 0
    for traj in range(trajs):
        t0 = time.time()
        warm = traj < warmup
        u, dH, dG, acc = nambu.nambu_hmc_step(gen, u, system(), tau, steps,
                                              always_accept=warm)
        pl, q = meas(u)
        if use_meta:
            hist.deposit(float(q))
        n_acc += int(acc and not warm)
        print(f"traj {traj}: dH {dH:+.6g} dG {dG:+.6g} "
              f"{'ACCEPT' if acc else 'REJECT'}"
              f"{' [warmup]' if warm else ''} MEASplaq "
              f"{float(pl):.10g} MEAStopo {float(q):.6g} "
              f"({time.time()-t0:.2f} s)")
    done = trajs - warmup
    if done > 0:
        print(f"# acceptance {n_acc}/{done} = {n_acc/done:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
