"""XML-driven gradient-flow measurement program (port of
``qex_tpu.apps.gauge_flow``; QEX gauge_flow): Wilson, rect or adjoint
flow action, RK3 integration over (t_max, dt) segments, and after every
step t^2 E in the plaquette and clover discretisations, the topological
charge Q and the w0 slope W = t d(t^2 E)/dt from finite differences.

Usage:
    python -m qex_tpu_torch.apps.gauge_flow --xml deck.xml [--cpu]
    python -m qex_tpu_torch.apps.gauge_flow --lattice 8 8 8 8 \\
        --tmax 1.0 --dt 0.02 [--c1 C1 | --adj ADJ] [--load config.npz]

It runs on the CUDA card in complex64; ``--cpu`` runs on the host in
complex128.  Without ``--load`` the field is the hot start
expm(0.3 tah) from a generator seeded by ``--seed`` (or the deck's).
Each segment's measurements are read to the host once.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .staghmc_spv import hot_start


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    ap = argparse.ArgumentParser(prog="gauge_flow")
    ap.add_argument("--xml", help="gauge_flow XML deck (input_gf.xml)")
    ap.add_argument("--lattice", type=int, nargs="+", default=None)
    ap.add_argument("--beta", type=float, default=5.0)
    ap.add_argument("--c1", type=float, default=None,
                    help="rectangle coefficient (rect flow action)")
    ap.add_argument("--adj", type=float, default=None,
                    help="adjoint/fundamental ratio (adjoint flow action)")
    ap.add_argument("--tmax", type=float, default=1.0)
    ap.add_argument("--dt", type=float, default=0.02)
    ap.add_argument("--load", help="gauge checkpoint (.npz) to flow")
    ap.add_argument("--seed", type=int, default=987654321)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host in complex128 (default: the "
                    "CUDA card in complex64)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("gauge_flow: no CUDA device; pass --cpu to run on the host",
              file=sys.stderr)
        return 2

    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge import flow as gf
    from qex_tpu_torch.io import checkpoint as ckpt
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.utils.config import FlowConfig

    # flow normalisation 2 nc (gauge.flow.wilson_flow_coeffs)
    if args.xml:
        cfg = FlowConfig.from_xml(args.xml)
        dims, segments, seed = cfg.dims, cfg.segments, cfg.seed
        if cfg.flow_act == "Wilson":
            coeffs = ga.wilson(2.0 * 3)
        elif cfg.flow_act == "Rect":
            coeffs = ga.gauge_act_rect(2.0 * 3, cfg.c1)
        elif cfg.flow_act == "Adj":
            coeffs = ga.adjoint_action(2.0 * 3, cfg.adj_plaq)
        else:
            raise ValueError(f"unknown flow action {cfg.flow_act!r}")
    else:
        dims = tuple(args.lattice or (8, 8, 8, 8))
        segments = [(args.tmax, args.dt)]
        seed = args.seed
        if args.adj is not None:
            coeffs = ga.adjoint_action(2.0 * 3, args.adj)
        elif args.c1 is not None:
            coeffs = ga.gauge_act_rect(2.0 * 3, args.c1)
        else:
            coeffs = ga.wilson(2.0 * 3)

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.complex128 if args.cpu else torch.complex64
    lat = Lattice(dims)
    print(f"# gauge_flow: lattice {dims} segments {segments} "
          f"device={device}")
    if args.load:
        u, _, _ = ckpt.load_checkpoint(args.load, lat, dtype, device)
    else:
        u = hot_start(lat, dtype, device, seed, scale=0.3)

    t = 0.0
    prev_t2e = prev_t = None
    for t_max, dt in segments:
        n = max(1, round((t_max - t) / dt))
        u, ms = gf.flow(coeffs, lat, u, dt, n, t0=t)
        ts, plq, t2e_p, t2e_c, topo = (
            x.cpu().numpy() for x in (ms.t, ms.plaq, ms.t2e_plaq,
                                      ms.t2e_clover, ms.topo_q))
        for i in range(n):
            # w0 observable W(t) = t d(t^2 E)/dt by a finite difference
            w = (ts[i] * (t2e_c[i] - prev_t2e) / (ts[i] - prev_t)
                 if prev_t2e is not None else 0.0)
            print(f"FLOW {ts[i]:.6g} plaq {plq[i]:.10g} "
                  f"t2E_plaq {t2e_p[i]:.10g} t2E_clover {t2e_c[i]:.10g} "
                  f"Q {topo[i]:.6g} W {w:.10g}")
            prev_t2e, prev_t = t2e_c[i], ts[i]
        t = t + n * dt
    return 0


if __name__ == "__main__":
    sys.exit(main())
