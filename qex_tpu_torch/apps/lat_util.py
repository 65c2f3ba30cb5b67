"""Lattice-file utilities: inspect and compare SciDAC configurations
(port of ``qex_tpu.apps.lat_util``; QEX's src/examples/checklat.nim and
fieldCmp.nim).

Usage:
    python -m qex_tpu_torch.apps.lat_util check FILE [--cpu]
    python -m qex_tpu_torch.apps.lat_util cmp FILE0 FILE1 [FILE2 ...]

``check`` prints the file's lattice size and plaquette (computed on the
CUDA card, or with ``--cpu`` on the host, in the file's precision
widened to complex128 on the host); ``cmp`` compares the fields site by
site on the host and exits 1 where two differ by more than 1e-25
relative (squared).
"""

from __future__ import annotations

import sys

import numpy as np


def _check(path: str, cpu: bool) -> int:
    import torch

    from qex_tpu_torch import device as qdevice
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.io import lime
    from qex_tpu_torch.lattice import Lattice

    dev = qdevice.resolve("cpu" if cpu else None)
    dims = lime.file_lattice(path)
    print(f"Lattice size: {list(dims)}")
    lat = Lattice(dims)
    arr = lime.load_gauge(path, lat)
    if dev.type == "cpu":
        arr = arr.astype(np.complex128)
    u = torch.from_numpy(arr).to(dev)
    with torch.no_grad():
        pl = float(loops.plaquette(lat, u))
    print(f"plaq: {pl:.10g}")
    return 0


def _cmp(paths: list[str]) -> int:
    from qex_tpu_torch.io import lime
    from qex_tpu_torch.lattice import Lattice

    dims = lime.file_lattice(paths[0])
    print(f"Lattice size: {list(dims)}")
    for p in paths[1:]:
        d = lime.file_lattice(p)
        if d != dims:
            print(f"Error: file {p} has lattice size {list(d)} != "
                  f"{list(dims)}")
            return 1
    lat = Lattice(dims)
    nt = dims[-1]
    fields, traces, norms = [], [], []
    for p in paths:
        print(f"Loading field from file: {p}")
        arr = lime.load_gauge(p, lat)
        fields.append(arr)
        # per-timeslice trace of the real part (fieldCmp.nim:47-53)
        traces.append(np.real(arr).sum(axis=tuple(range(arr.ndim - 1))))
        n2 = float(np.vdot(arr, arr).real)
        norms.append(n2)
        print(f"Field {len(fields)-1} norm2: {n2:.10g}")
    rc = 0
    for i in range(1, len(fields)):
        d = fields[i] - fields[i - 1]
        dn = float(np.vdot(d, d).real)
        rel = dn / max(min(norms[i], norms[i - 1]), 1e-300)
        print(f"Difference between field {i-1} and field {i}")
        print(f"\tNorm2 of the field difference: {dn:.6g} "
              f"relative: {rel:.6g}")
        x = 0.0
        for t in range(nt):
            lo = min(abs(traces[i][t]), abs(traces[i - 1][t]))
            x = max(x, abs(traces[i][t] - traces[i - 1][t])
                    / max(lo, 1e-300))
        print(f"\tMax relative difference in time slice traces: "
              f"{x:.6g}")
        rc |= rel > 1e-25
    return int(rc)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    argv = [a for a in argv if a != "--cpu"]
    if len(argv) >= 2 and argv[0] == "check":
        return _check(argv[1], cpu)
    if len(argv) >= 3 and argv[0] == "cmp":
        return _cmp(argv[1:])
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
