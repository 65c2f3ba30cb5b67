"""Compact U(1) pure-gauge Monte Carlo program in any dimension: HMC or
heatbath with over-relaxation, with plaquette, topological-charge and
flowed-charge measurements (port of ``qex_tpu.apps.u1_mc``; QEX
src/examples/puregauge2du1.nim and puregaugehb2du1.nim).

Usage:
    python -m qex_tpu_torch.apps.u1_mc -L:128 -beta:5.0 -algo:hmc \
        -trajs:64 -tau:2.0 -steps:10 -scheme:2MN [-gfix:true] [-cpu:true]
    python -m qex_tpu_torch.apps.u1_mc -algo:heatbath -sweeps:50 -or:1

The angles are float32, as in the JAX app, with the action, plaquette
and charge summed in float64; it runs on the CUDA card (and raises
without one), ``-cpu:true`` on the host.  ``-therm:n`` runs n heatbath
sweeps (with ``-or`` over-relaxation sweeps each) from the random start
before the measured updates.  Prints ``MEAS algo n plaq re
im topo Q`` lines, with ``dH``/``acc`` for HMC and ``flowTopo`` when
``-flowTime`` is set.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    from qex_tpu_torch.device import resolve
    from qex_tpu_torch.models import u1
    from qex_tpu_torch.utils.params import Params
    prm = Params(argv)
    L = prm.int_param("L", 32, "lattice size (LxL)")
    nd = prm.int_param("nd", 2, "dimensions")
    beta = prm.float_param("beta", 5.0, "coupling")
    algo = prm.str_param("algo", "hmc", "update: hmc|heatbath")
    trajs = prm.int_param("trajs", 64, "HMC trajectories")
    tau = prm.float_param("tau", 2.0, "trajectory length")
    steps = prm.int_param("steps", 10, "MD steps per trajectory")
    scheme = prm.str_param("scheme", "2MN", "integrator scheme")
    gfix = prm.bool_param("gfix", False, "maximal-tree gauge fixing")
    sweeps = prm.int_param("sweeps", 50, "heatbath sweeps")
    n_or = prm.int_param("or", 1, "over-relaxation sweeps per heatbath")
    meas_freq = prm.int_param("meas", 1, "measurement frequency")
    flow_time = prm.float_param("flowTime", 0.0,
                                "gradient-flow time per measurement")
    flow_dt = prm.float_param("flowDt", 0.02, "flow step")
    seed = prm.int_param("seed", 11 ** 7, "RNG seed")
    therm = prm.int_param("therm", 0,
                          "heatbath sweeps before the updates (not measured)")
    use_cpu = prm.bool_param("cpu", False, "run on the host")

    device = resolve("cpu" if use_cpu else None)
    shape = (nd,) + (L,) * nd
    print(f"# u1_mc lat={'x'.join([str(L)] * nd)} beta={beta} "
          f"algo={algo} device={device}")
    gen = torch.Generator(device=device).manual_seed(seed)
    theta = u1.random_field(gen, shape, torch.float32)
    for _ in range(therm):
        theta = u1.heatbath_sweep(gen, theta, beta, over_relax=n_or)

    def meas(t):
        p = u1.plaquette(t)
        return (np.float32(float(p.real)), np.float32(float(p.imag)),
                np.float32(float(u1.topo_charge(t))))

    nflow = int(round(flow_time / flow_dt)) if flow_time > 0 else 0
    if algo == "hmc":
        def upd(g, t):
            return u1.hmc_step(g, t, beta, tau, steps, scheme, gfix=gfix)
        n_iter = trajs
    elif algo == "heatbath":
        def upd(g, t):
            return u1.heatbath_sweep(g, t, beta, over_relax=n_or), None
        n_iter = sweeps
    else:
        raise SystemExit(f"unknown algo {algo!r}")

    t0 = time.time()
    n_acc = 0
    for it in range(n_iter):
        theta, stats = upd(gen, theta)
        if (it + 1) % meas_freq == 0:
            pre, pim, q = meas(theta)
            line = (f"MEAS {algo} {it+1} plaq {float(pre):.8g} "
                    f"{float(pim):.4g} topo {float(q):.6g}")
            if stats is not None:
                acc = bool(stats["accept"])
                n_acc += acc
                line += f" dH {stats['dH']:.6g} acc {int(acc)}"
            if nflow:
                qf = meas(u1.gauge_flow(theta, flow_dt, nflow))[2]
                line += f" flowTopo {float(qf):.6g}"
            print(line)
    dtime = time.time() - t0
    extra = (f" acc_rate {n_acc/max(1, n_iter):.3f}"
             if algo == "hmc" else "")
    print(f"# {n_iter} {algo} updates in {dtime:.2f} s{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
