"""How far float32 rounding carries along one MD trajectory.

    python -m qex_tpu_torch.apps.md_precision --cpu [--xml deck.xml]
        [--start 0.7] [--seed 5] [-key=value ...]

Builds the app's theory from a deck (default: the committed config-4
deck; ``-key=value`` overrides as in the app), draws links
expm(start * random_tah), momenta and pseudofermion noise once, runs
one trajectory from them in complex64 and in complex128 on the host,
and prints one JSON line: H, both dH, |ddH| and the largest link
deviation.  That is the yardstick for a kernel-against-plain trajectory
(chip_smoke.py's A/B phases), which cannot agree better than float32
rounding does along the same trajectory.  Host only, because the card's
kernels take complex64 alone; hence the required ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

DECK = Path(__file__).resolve().parent / "decks" / "config4_24.xml"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="md_precision")
    ap.add_argument("--xml", default=str(DECK))
    ap.add_argument("--cpu", action="store_true",
                    help="required: the comparison runs on the host")
    ap.add_argument("--start", type=float, default=0.7,
                    help="links expm(start * random_tah)")
    ap.add_argument("--seed", type=int, default=5)
    args, unknown = ap.parse_known_args(argv)
    bad = [a for a in unknown if not (a.startswith("-") and "=" in a)]
    if bad:
        ap.error(f"unrecognized arguments: {bad}")
    if not args.cpu:
        print("md_precision: runs on the host only; pass --cpu",
              file=sys.stderr)
        return 2

    from qex_tpu_torch.apps.staghmc_spv import build_theory, hot_start
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.utils.config import HMCConfig
    cfg = HMCConfig.from_xml(args.xml)
    cfg.override(dict(a.lstrip("-").split("=", 1) for a in unknown))
    lat = Lattice(cfg.dims)
    th = build_theory(cfg, lat)
    cpu = torch.device("cpu")
    u = hot_start(lat, torch.complex128, cpu, args.seed, args.start)
    gen = torch.Generator(device=cpu).manual_seed(args.seed)
    p = th.draw_momenta(gen, u)
    xis = th.draw_noise(gen, u)

    def run(dtype):
        uu, pp = u.to(dtype), p.to(dtype)
        phis = th.heatbath_from_noise(
            [None if x is None else x.to(dtype) for x in xis], uu)
        h_old = float(th.hamiltonian(uu, pp, phis))
        u1, p1 = th.trajectory(uu, pp, phis)
        return (u1.to(torch.complex128), h_old,
                float(th.hamiltonian(u1, p1, phis)) - h_old)

    t0 = time.perf_counter()
    u32, _, dh32 = run(torch.complex64)
    u64, h64, dh64 = run(torch.complex128)
    print(json.dumps({
        "dims": list(lat.dims), "start": args.start,
        "smeared": th.smear_coefs is not None,
        "sloppy": th.solver_params.sloppy, "h_old": h64, "dH_f64": dh64,
        "dH_f32": dh32, "abs_ddH": abs(dh32 - dh64),
        "max_link_dev": float((u32 - u64).abs().max()),
        "host_seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
