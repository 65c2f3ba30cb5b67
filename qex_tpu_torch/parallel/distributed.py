"""Process-group bootstrap and per-rank shard I/O (port of
``qex_tpu.parallel.distributed``; QEX's ``QMP_init_msg_passing``,
src/comms/qmp.nim:40, and its per-rank file I/O).

:func:`initialize` is ``torch.distributed.init_process_group``.  Under
``torchrun`` it reads the rank, world size and rendezvous from the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``),
as the JAX package reads its ``JAX_*`` variables; the caller may pass
them instead (``init_method="tcp://localhost:<port>"``).  The backend is
the caller's choice: ``nccl`` for one card per rank, ``gloo`` for ranks
on the host, or several ranks sharing one card through host memory
(``parallel.mesh``).

A global field lives as one block per rank (``parallel.mesh``):
:func:`make_global_field` builds this rank's block from a callback,
:func:`save_shards` writes each rank's block to its own file and
:func:`load_shards` reads them back, re-cut where the new mesh splits
the lattice differently (QIO partfile I/O, src/io/parallelIo.nim:15-42).
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..lattice import Lattice
from .mesh import LatticeMesh, make_lattice_mesh


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def initialize(backend: str = "nccl", init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None
               ) -> None:
    """Join the default process group.

    Arguments default to torchrun's environment; a one-rank group with
    no rendezvous in the environment listens on a free localhost port.
    With ``nccl`` each rank takes the card ``LOCAL_RANK`` (torchrun) or
    ``rank`` modulo the card count."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://localhost:{free_port()}"
        else:
            raise ValueError("initialize: no rendezvous; run under torchrun "
                             "or pass init_method")
    if backend == "nccl":
        n = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % n)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(lat: Lattice, rank_geom: Sequence[int] | None = None
                ) -> LatticeMesh:
    """The mesh of ``lat`` over every rank of the default group (the
    same greedy split and ``-rankgeom:`` override as
    ``mesh.make_lattice_mesh``)."""
    return make_lattice_mesh(lat, rank_geom=rank_geom)


def _block_index(lm: LatticeMesh, n_site_axes: int,
                 global_shape) -> tuple[slice, ...]:
    return tuple(slice(0, n) for n in global_shape[:n_site_axes]) \
        + lm.block_slices()


def make_global_field(lm: LatticeMesh, fill: Callable, n_site_axes: int,
                      global_shape: tuple[int, ...], dtype=np.complex64,
                      device=None) -> torch.Tensor:
    """This rank's block of a global field: ``fill(index)`` returns the
    data of one global slice (a tuple of slices) as an array, and each
    rank asks only for its own block (QIO per-rank reads)."""
    idx = _block_index(lm, n_site_axes, tuple(global_shape))
    block = np.ascontiguousarray(np.asarray(fill(idx), dtype=dtype))
    return torch.from_numpy(block).to(device or "cpu")


def _slice_key(index, shape) -> str:
    """Stable file name key of a global index tuple."""
    return "_".join(f"{sl.start or 0}-{n if sl.stop is None else sl.stop}"
                    for sl, n in zip(index, shape))


def save_shards(path: str | os.PathLike, lm: LatticeMesh,
                block: torch.Tensor, n_site_axes: int | None = None) -> None:
    """Write this rank's block of a global field to ``path``/: one
    ``shard_<slicekey>.npy`` per rank and ``meta.json`` (global shape
    and dtype, from rank 0)."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    nd = lm.lat.nd
    if n_site_axes is None:
        n_site_axes = block.dim() - nd
    shape = tuple(block.shape[:n_site_axes]) + tuple(lm.lat.dims)
    arr = block.detach().cpu().resolve_conj().numpy()
    if lm.rank == 0:
        (path / "meta.json").write_text(json.dumps(
            {"shape": list(shape), "dtype": str(arr.dtype)}))
    key = _slice_key(_block_index(lm, n_site_axes, shape), shape)
    np.save(path / f"shard_{key}.npy", arr)
    lm.barrier()


def load_shards(path: str | os.PathLike, lm: LatticeMesh,
                n_site_axes: int, device=None) -> torch.Tensor:
    """This rank's block of a :func:`save_shards` checkpoint; its slice
    is read from one file where it was saved as one, else assembled from
    the saved tiles that cover it."""
    path = pathlib.Path(path)
    meta = json.loads((path / "meta.json").read_text())
    shape = tuple(meta["shape"])
    dtype = np.dtype(meta["dtype"])
    files = {f.stem[len("shard_"):]: f for f in path.glob("shard_*.npy")}
    want = _block_index(lm, n_site_axes, shape)
    key = _slice_key(want, shape)
    if key in files:
        out = np.load(files[key])
    else:
        out = np.empty([sl.stop - sl.start for sl in want], dtype)
        for k, f in files.items():
            tile = [tuple(map(int, p.split("-"))) for p in k.split("_")]
            inter = []
            for (a, b), w in zip(tile, want):
                lo, hi = max(a, w.start), min(b, w.stop)
                if lo >= hi:
                    break
                inter.append((lo, hi, a, w.start))
            else:
                data = np.load(f)
                src = tuple(slice(lo - a, hi - a) for lo, hi, a, _ in inter)
                dst = tuple(slice(lo - ws, hi - ws)
                            for lo, hi, _, ws in inter)
                out[dst] = data[src]
    return torch.from_numpy(out).to(device or "cpu")
