#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference, computed in
the nearest precision below the configuration's (bfloat16 storage for
its complex64, ``reference.lattice.CONTROL``), put in the program's
place and judged by the same comparison as the program.  It has to come
out not correct.  A traffic kind may add readings of faults planted in
the reference put in the program's place (the HMC's H-only faults).

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed: for each reading, each compared number
beside its limit and whether one of them fails.  The benchmark's runs do
not run it; its readings set the upper end of each limit (PERF.md).
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

from benchmark import harness  # noqa: E402


def run(cell_name: str, seed: int, device: str = "cuda", dims=None) -> dict:
    man = harness.manifest()
    cell = harness.find(man["workloads"], cell_name, "workload")
    cfg = harness.find(man["configs"], cell["config"], "config")
    traffic = harness.load_json(harness.BENCH / "traffic"
                                / f"{cell['traffic']}.json")
    limits = harness.load_json(harness.BENCH / "checks"
                               / f"{cell_name}.json")["limits"]
    ctx = harness.Context(cell, harness.load_json(harness.ROOT / cfg["file"]),
                          traffic, tuple(dims or traffic["dims"]), seed,
                          device)
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    t0 = time.perf_counter()
    readings = kind.control(ctx)
    return {"cell": cell_name, "seed": seed,
            "seconds": time.perf_counter() - t0,
            "readings": {
                name: {"checks": {k: [nums.get(k), lim]
                                  for k, lim in limits.items()},
                       "fails": any(nums.get(k) is None
                                    or not nums[k] <= lim
                                    for k, lim in limits.items())}
                for name, nums in readings.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(run(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
