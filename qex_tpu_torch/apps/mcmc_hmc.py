"""JSON-driven HMC program (port of ``qex_tpu.apps.mcmc_hmc``): build a
LatticeFieldTheory from a reference-format JSON deck
(``mcmc.builder.theory_from_json``) and run HMC with plaquette and
Polyakov-loop measurements.

Usage:
    python -m qex_tpu_torch.apps.mcmc_hmc --json deck.json \
        [--ntraj N] [--warmup W] [--cpu]

It runs on the CUDA card in complex64; ``--cpu`` runs on the host in
complex128.  The first ``--warmup`` trajectories are accepted without
the Metropolis test.  Each trajectory draws from a ``torch.Generator``
seeded from the deck's ``(serial_seed, traj)``, the hot start from its
``parallel_seed`` (``apps.staghmc_spv.seeded_generator``).

A deck's ``mpi-geometry`` runs block-resident over the process group
(under torchrun the app starts it: NCCL where every rank has a card,
else gloo), as ``staghmc_spv``'s ``-rank_geom``; rank 0 prints.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import time

import torch


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    ap = argparse.ArgumentParser(prog="mcmc_hmc")
    ap.add_argument("--json", required=True)
    ap.add_argument("--ntraj", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host in complex128 (default: the "
                    "CUDA card in complex64)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("mcmc_hmc: no CUDA device; pass --cpu to run on the host",
              file=sys.stderr)
        return 2

    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.parallel import distributed

    own = False
    if "WORLD_SIZE" in os.environ and not torch.distributed.is_initialized():
        ws = int(os.environ["WORLD_SIZE"])
        distributed.initialize("nccl" if not args.cpu
                               and ws <= torch.cuda.device_count()
                               else "gloo")
        own = True
    try:
        return _run(args)
    finally:
        if own:
            torch.distributed.destroy_process_group()


def _run(args) -> int:
    from qex_tpu_torch.mcmc.builder import theory_from_json
    from qex_tpu_torch.parallel import distributed

    lat, theory, meta = theory_from_json(args.json)
    lm = meta["mesh"]
    device = torch.device("cpu" if args.cpu else "cuda")
    if lm is not None and not args.cpu:
        device = torch.device("cuda", distributed.local_rank()
                              % torch.cuda.device_count())
    dtype = torch.complex128 if args.cpu else torch.complex64
    with (contextlib.redirect_stdout(io.StringIO())
          if lm is not None and lm.rank != 0 else contextlib.nullcontext()):
        return _chain(args, lat, theory, meta, device, dtype)


def _chain(args, lat, theory, meta, device, dtype) -> int:
    from qex_tpu_torch.apps.staghmc_spv import hot_start, seeded_generator
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.ops import group
    from qex_tpu_torch.parallel.mesh import local_block, use_mesh

    lm = meta["mesh"]
    print(f"# mcmc_hmc: {lat.dims} terms="
          f"{[t.name for t in theory.terms]} tau={meta['tau']} "
          f"device={device}")
    if meta["start"] == "cold":
        u = group.unit_gauge(lat, dtype, device)
    else:
        u = hot_start(lat, dtype, device, meta["parallel_seed"])
    if lm is not None:
        u = local_block(lm, u)

    n_acc = 0
    for traj in range(args.ntraj):
        t0 = time.time()
        warm = traj < args.warmup
        u, st = theory.hmc_step(
            seeded_generator(device, meta["serial_seed"], traj), u,
            always_accept=warm)
        with torch.no_grad(), use_mesh(lm):
            pl = float(loops.plaquette(lat, u))
            plp = complex(loops.polyakov_loop(lat, u)).real
        n_acc += int(st.accepted and not warm)
        print(f"traj {traj}: dH {st.dH:+.6g} "
              f"{'ACCEPT' if st.accepted else 'REJECT'}"
              f"{' [warmup]' if warm else ''} MEASplaq {pl:.10g} "
              f"MEASploop {plp:.8g} ({time.time() - t0:.2f} s)")
    done = args.ntraj - args.warmup
    if done > 0:
        print(f"# acceptance {n_acc}/{done} = {n_acc / done:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
