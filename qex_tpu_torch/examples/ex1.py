"""Tutorial 1 -- gauge fields, parallel transport, average plaquette
(port of ``examples/ex1.py``; QEX's src/examples/ex1.nim).

Build a unit (or random SU(3)) gauge field and measure its average
plaquette.

Run: python -m qex_tpu_torch.examples.ex1 [-lat:8,8,8,8] [-random:true]
     [-seed:7] [-cpu:true]   (on the CUDA card unless ``-cpu:true``)
"""

import sys

import torch

from qex_tpu_torch import device as qdevice
from qex_tpu_torch.gauge import loops
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group
from qex_tpu_torch.rng import seeded_generator
from qex_tpu_torch.utils.params import Params


def main(argv=None) -> int:
    prm = Params(sys.argv[1:] if argv is None else argv)
    dev = qdevice.resolve("cpu" if prm.bool_param("cpu", False, "host")
                          else None)
    shape = tuple(int(x) for x in
                  prm.str_param("lat", "4,4,4,4", "lattice size").split(","))
    use_random = prm.bool_param("random", False, "random gauge start")
    seed = prm.int_param("seed", 7, "RNG seed")
    lat = Lattice(shape)
    print(f"lattice {shape} on {dev}")
    if use_random:
        gen = seeded_generator(dev, seed)
        u = torch.stack([group.random_su(gen, lat.dims, lat.nc,
                                         torch.complex64)
                         for _ in range(lat.nd)])
    else:
        u = group.unit_gauge(lat, torch.complex64, dev)
    # average plaquette Re tr P / nc over all planes (ex1.nim:3-15)
    print(f"average plaq: {float(loops.plaquette(lat, u)):.8g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
