"""HMC checkpoint: gauge field + RNG state + chain position (port of
``qex_tpu.io.checkpoint``, numpy and torch only).

One ``.npz`` in the JAX package's format (``gauge``, ``rng_state`` as
JSON text, ``traj``, ``version``), so a checkpoint written by either
package loads in the other.  The app's per-trajectory generators are
seeded from ``(serial_seed, traj)``, so those scalars are the whole RNG
state and a resume repeats the chain.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import resolve
from ..lattice import Lattice

FORMAT_VERSION = 1


def save_checkpoint(path: str, u: torch.Tensor, rng_state: dict,
                    traj: int) -> None:
    """Write gauge + RNG + chain position; atomic rename."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        gauge=u.detach().cpu().numpy(),
        rng_state=json.dumps(rng_state),
        traj=np.int64(traj),
        version=np.int64(FORMAT_VERSION),
    )
    os.replace(tmp, path if path.endswith(".npz") else path + ".npz")


def load_checkpoint(path: str, lat: Lattice, dtype: torch.dtype,
                    device: torch.device | str | None = None
                    ) -> tuple[torch.Tensor, dict, int]:
    """Read a checkpoint onto ``device`` (default: the CUDA card);
    returns (gauge, rng_state, traj)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        g = z["gauge"]
        if tuple(g.shape) != lat.gauge_shape():
            raise ValueError(
                f"checkpoint gauge shape {g.shape} != lattice "
                f"{lat.gauge_shape()}")
        rng_state = json.loads(str(z["rng_state"]))
        traj = int(z["traj"])
    return (torch.from_numpy(g).to(device=resolve(device), dtype=dtype),
            rng_state, traj)
