"""Tutorial 0 -- lattices, fields, even/odd halves, shifts (port of
``examples/ex0.py``; QEX's src/examples/ex0.nim).

Create color vector and matrix fields, assign the even and odd halves
separately, and shift.  Fields are torch tensors with the site-tensor
axes leading and the lattice axes trailing.

Run: python -m qex_tpu_torch.examples.ex0 [-cpu:true]
(on the CUDA card unless ``-cpu:true``)
"""

import sys

import torch

from qex_tpu_torch import device as qdevice
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import linalg, shifts
from qex_tpu_torch.utils.params import Params


def parity(dims, device) -> torch.Tensor:
    """(x + y + z + t) mod 2 site mask."""
    grids = torch.meshgrid(*[torch.arange(n, device=device) for n in dims],
                           indexing="ij")
    return sum(grids) % 2


def main(argv=None) -> int:
    prm = Params(sys.argv[1:] if argv is None else argv)
    dev = qdevice.resolve("cpu" if prm.bool_param("cpu", False, "host")
                          else None)
    lat = Lattice((4, 4, 4, 4))
    print(f"Hello from {dev}")
    # fields: site tensor axes leading, lattice axes trailing
    v1 = torch.full((3,) + lat.dims, 2.0 + 0j, dtype=torch.complex64,
                    device=dev)
    m1 = torch.eye(3, dtype=torch.complex64, device=dev).reshape(
        3, 3, 1, 1, 1, 1).expand((3, 3) + lat.dims)

    # v2.even := m1 * v1 ; v2.odd := 3   (ex0.nim:14-17)
    par = parity(lat.dims, dev)
    v2 = torch.where(par == 0, linalg.mv(m1, v1),
                     torch.tensor(3.0 + 0j, dtype=torch.complex64,
                                  device=dev))
    zero = torch.zeros((), dtype=torch.complex64, device=dev)
    print(f"v2 even: {float(linalg.norm2(torch.where(par == 0, v2, zero))):g}")
    print(f"v2 odd: {float(linalg.norm2(torch.where(par == 1, v2, zero))):g}")

    # shift(v2, dir=0, len=1); then dir=3, len=2  (ex0.nim:20-23)
    v1b = shifts.shift(v2, 0, +1, nd=4)
    v2b = shifts.shift(v1b, 3, +1, nd=4, dist=2)
    print("shifted even: "
          f"{float(linalg.norm2(torch.where(par == 0, v2b, zero))):g}")
    print("shifted odd: "
          f"{float(linalg.norm2(torch.where(par == 1, v2b, zero))):g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
