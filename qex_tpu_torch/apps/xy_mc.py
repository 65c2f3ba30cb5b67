"""XY model Monte Carlo program (heatbath / Metropolis / Wolff cluster)
with spin gradient flow measurements (port of ``qex_tpu.apps.xy_mc``;
QEX src/xy_cluster_mc/xy_cluster.nim and src/xy_heatbath_mc/).

Usage:
    python -m qex_tpu_torch.apps.xy_mc -L:256 -beta:1.1 -algo:wolff \
        -sweeps:200 -meas:10 -flowTime:1.0 [-start:ordered] [-cpu:true]

It runs on the CUDA card in float32 (and raises without one);
``-cpu:true`` runs on the host in float64.  ``-start:ordered`` starts
from theta = 0 instead of the random start; ``-algo:a,b,..`` runs
``-sweeps`` updates of each algorithm in turn on the same field, each
segment headed ``# algo a`` and closed by its time.  Prints
``MEAS sweep n E/bond .. |M| .. aux ..`` lines (aux: the Metropolis
acceptance or the Wolff cluster fraction), with ``flowE``/``flowM`` of
the flowed spins when ``-flowTime`` is set.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def initial_spins(gen: torch.Generator, L: int, dtype: torch.dtype,
                  start: str) -> torch.Tensor:
    """The L x L start: uniform on [-3.14159, 3.14159) (the JAX app's
    random start) or theta = 0 for ``start == "ordered"``."""
    if start == "ordered":
        return torch.zeros((L, L), dtype=dtype, device=gen.device)
    u = torch.rand((L, L), generator=gen, dtype=dtype, device=gen.device)
    return (2.0 * u - 1.0) * 3.14159


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    from qex_tpu_torch.device import resolve
    from qex_tpu_torch.models import xy
    from qex_tpu_torch.utils.params import Params
    prm = Params(argv)
    L = prm.int_param("L", 32, "lattice size (LxL)")
    beta = prm.float_param("beta", 1.1, "coupling")
    algo = prm.str_param("algo", "wolff",
                         "update: heatbath|metropolis|wolff, or several "
                         "separated by commas, run in turn")
    sweeps = prm.int_param("sweeps", 100, "updates")
    meas_freq = prm.int_param("meas", 10, "measurement frequency")
    flow_time = prm.float_param("flowTime", 0.0,
                                "spin flow time per measurement")
    flow_dt = prm.float_param("flowDt", 0.05, "spin flow step")
    seed = prm.int_param("seed", 987654321, "RNG seed")
    start = prm.str_param("start", "random", "start: random|ordered")
    use_cpu = prm.bool_param("cpu", False, "run on the host")

    device = resolve("cpu" if use_cpu else None)
    dtype = torch.float64 if use_cpu else torch.float32

    def update(name):
        if name == "heatbath":
            return lambda g, t: (xy.heatbath_sweep(g, t, beta), 0.0)
        if name == "metropolis":
            return lambda g, t: xy.metropolis_sweep(g, t, beta)
        if name == "wolff":
            return lambda g, t: xy.wolff_update(g, t, beta)
        raise SystemExit(f"unknown algo {name!r}")

    algos = algo.split(",")
    updates = [update(a) for a in algos]
    print(f"# xy_mc L={L} beta={beta} algo={algo} device={device}")
    gen = torch.Generator(device=device).manual_seed(seed)
    theta = initial_spins(gen, L, dtype, start)
    nflow = int(round(flow_time / flow_dt)) if flow_time > 0 else 0

    def meas(t):
        e = np.float32(float(xy.energy(t, beta)) / (2 * L * L))
        return e, np.float32(float(xy.magnetization(t)[0]))

    t0 = time.time()
    for name, upd in zip(algos, updates):
        if len(algos) > 1:
            print(f"# algo {name}")
        t1 = time.time()
        for sw in range(sweeps):
            theta, aux = upd(gen, theta)
            if (sw + 1) % meas_freq == 0:
                e, m = meas(theta)
                line = (f"MEAS sweep {sw+1} E/bond {float(e):.8g} |M| "
                        f"{float(m):.8g} aux {float(aux):.4g}")
                if nflow:
                    ef, mf = meas(xy.spin_flow(theta, flow_dt, nflow))
                    line += f" flowE {float(ef):.8g} flowM {float(mf):.8g}"
                print(line)
        if len(algos) > 1:
            print(f"# {sweeps} {name} updates in {time.time()-t1:.2f} s")
    print(f"# {sweeps * len(algos)} sweeps in {time.time()-t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
