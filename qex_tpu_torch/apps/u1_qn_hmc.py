"""Ensemble quasi-Newton HMC for 2D compact U(1) pure gauge (port of
``qex_tpu.apps.u1_qn_hmc``; QEX src/examples/puregauge2du1qn.nim).

``nstream`` chains held as one tensor with a leading stream axis; plain
HMC until sweep ``qnbegin``, then quasi-Newton HMC whose mass matrix is
built from the pairs of neighbouring streams (slot i holds the
difference between streams i and i+1), the pairs of the updated stream
excluded; streams are swept forward and backward in turn, with optional
maximal-tree gauge fixing.  Fields are float64, as in the JAX app.

Usage:
    python -m qex_tpu_torch.apps.u1_qn_hmc -L:64 -beta:5.0 -trajs:24 \
        -qnbegin:8 -nstream:6 [-cpu:true]

It runs on the CUDA card (and raises without one); ``-cpu:true`` runs on
the host.  ``-therm:n`` first runs n heatbath sweeps (with one
over-relaxation sweep each) on every stream and gauge-fixes the result
to the maximal tree (``models.u1.max_tree_fix``; without it the tree
links of the start are set to 0, as in the JAX app).  Prints ``MEAS sweep n stream i plaq .. topo .. dH .. acc ..``.
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
    from qex_tpu_torch.hmc import qnhmc
    from qex_tpu_torch.models import u1
    from qex_tpu_torch.utils.params import Params
    prm = Params(argv)
    L = prm.int_param("L", 16, "lattice size (LxL)")
    beta = prm.float_param("beta", 5.0, "coupling")
    trajs = prm.int_param("trajs", 24, "sweeps over all streams")
    tau = prm.float_param("tau", 2.0, "trajectory length (plain)")
    steps = prm.int_param("steps", 10, "MD steps (plain)")
    qnbegin = prm.int_param("qnbegin", 8, "sweep to start QN updates")
    qntau = prm.float_param("qntau", tau, "trajectory length (QN)")
    qnsteps = prm.int_param("qnsteps", steps, "MD steps (QN)")
    qnh0 = prm.float_param("qnh0", 1.0, "base Hessian diagonal")
    qnyscut = prm.float_param("qnyscut", 0.0, "y.s cutoff")
    nstream = prm.int_param("nstream", 6, "parallel streams")
    gfix = prm.bool_param("gfix", True, "maximal-tree gauge fixing")
    therm = prm.int_param("therm", 0,
                          "heatbath sweeps per stream before the chains")
    seed = prm.int_param("seed", 11 ** 7, "RNG seed")
    use_cpu = prm.bool_param("cpu", False, "run on the host")
    # QEX default qnyscale = 1/(2 beta): the inverse diagonal of the
    # free-field Hessian (puregauge2du1qn.nim:724)
    yscale = prm.float_param("qnyscale", 1.0 / (2.0 * beta),
                             "Hessian scale on y")

    device = resolve("cpu" if use_cpu else None)
    dtype = torch.float64
    shape = (2, L, L)
    print(f"# u1_qn_hmc lat={L}x{L} beta={beta} nstream={nstream} "
          f"qnbegin={qnbegin} device={device}")
    tree = u1.max_tree_mask((L, L), device) if gfix else None

    def act(t):
        return u1.action(t, beta)

    def grad(t):
        return u1.force(t, beta)

    def mgrad(t):
        g = grad(t)
        return torch.where(tree, 0.0, g) if tree is not None else g

    gen = torch.Generator(device=device).manual_seed(seed)
    gs = torch.stack([u1.random_field(gen, shape, dtype)
                      for _ in range(nstream)])
    if therm:
        for i in range(nstream):
            for _ in range(therm):
                gs[i] = u1.heatbath_sweep(gen, gs[i], beta)
            if tree is not None:
                gs[i] = u1.max_tree_fix(gs[i])
    elif tree is not None:
        gs = torch.where(tree[None], 0.0, gs)

    st = qnhmc.qn_init(nstream, shape, h0=qnh0, dtype=dtype, device=device)

    def set_pair(s, i, xa, xb):
        return qnhmc.qn_set(s, i, xa, mgrad(xa), xb, mgrad(xb),
                            yscale=yscale, cutoff=qnyscut)

    def meas(t):
        return (np.float32(float(u1.plaquette(t).real)),
                np.float32(float(u1.topo_charge(t))))

    forward = True
    t0 = time.time()
    n_acc = n_tot = 0
    for n in range(1, trajs + 1):
        if n == qnbegin:
            print("# STARTING QN updates")
            for i in range(nstream):
                st = set_pair(st, i, gs[i], gs[(i + 1) % nstream])
        for ns in range(nstream):
            i = ns if forward else nstream - 1 - ns
            if n >= qnbegin:
                ex = torch.zeros((nstream,), dtype=torch.bool, device=device)
                ex[i] = ex[(i - 1) % nstream] = True
                ops = qnhmc.qn_prep(st, exclude=ex)
                x_new, stats = qnhmc.qn_hmc_step(gen, gs[i], ops, act, grad,
                                                 qntau, qnsteps, mask=tree)
            else:
                x_new, stats = u1.hmc_step(gen, gs[i], beta, tau, steps,
                                           gfix=gfix)
            gs[i] = x_new
            acc = bool(stats["accept"])
            n_acc += acc
            n_tot += 1
            if n >= qnbegin:
                # refresh the pairs this stream takes part in
                st = set_pair(st, i, gs[i], gs[(i + 1) % nstream])
                st = set_pair(st, (i - 1) % nstream, gs[(i - 1) % nstream],
                              gs[i])
            pl, q = meas(gs[i])
            print(f"MEAS sweep {n} stream {i} plaq {float(pl):.8g} "
                  f"topo {float(q):.5g} dH {stats['dH']:.6g} "
                  f"acc {int(acc)}")
        forward = not forward
    print(f"# {n_tot} trajectories in {time.time()-t0:.2f} s "
          f"acc_rate {n_acc/max(1, n_tot):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
