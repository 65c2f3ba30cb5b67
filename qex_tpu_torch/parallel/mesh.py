"""Lattice rank mesh over a ``torch.distributed`` process group (port of
``qex_tpu.parallel.mesh``; QEX's rank-grid domain decomposition,
src/layout/layoutX.nim:46-68, its QMP halo channels and ``qmpSum``).

The JAX package has two multi-chip paths: GSPMD, where ``jit`` with a
``NamedSharding`` lets XLA insert the collectives, and ``shard_map``
with ``ppermute`` (``parallel.halo``, ``physics.stag_shard``).  Torch
has no GSPMD, so the port has one explicit path: each rank of a process
group holds the block of the lattice its coordinates in the rank
geometry select, computes on it, and exchanges faces and global sums
through the group (:class:`LatticeMesh`).  Site-tensor axes are never
split; the lattice axes are, ``rank_geom[mu]`` ways along direction mu.

A trajectory runs block-resident inside :func:`use_mesh`: there every
lattice field is this rank's block, the shifts of ``ops.shifts``,
``ops.eo`` and the kernels' link construction go through
``parallel.halo``'s halo-exchanging shift, and site sums through its
float64 all-reduce.  The lattice code keeps its signatures: a
``Lattice`` argument stays the global lattice (volumes and global
extents), and an operator built on a block carries the block's lattice
(:func:`block_lattice`).  With no mesh active every function computes
exactly what it computes without this module.

Ranks are laid out in C order over the rank geometry (t fastest), as
``numpy.reshape`` lays out the JAX mesh's devices.  Where the group's
backend is gloo and a tensor lies on a CUDA card, every exchange,
reduction and gather stages through host memory, explicitly: that is
the only way to run several ranks on one card, since NCCL refuses two
ranks on one device.  ``LatticeMesh.stats`` accumulates the seconds of
those staged transfers (copies included) and of the copies alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..lattice import Lattice


def partition_geom(ndev: int, dims: Sequence[int]) -> tuple[int, ...]:
    """Greedy prime-factor split of ``ndev`` ranks over lattice dims
    (QEX ``partitionGeomF``, layoutX.nim:46-68): each prime factor,
    largest first, goes to the direction with the largest local extent
    that it divides leaving an even local extent (even-odd packing
    needs it), later (t, z) directions first on ties."""
    geom = [1] * len(dims)
    factors = []
    n = ndev
    p = 2
    while p * p <= n:
        while n % p == 0:
            factors.append(p)
            n //= p
        p += 1
    if n > 1:
        factors.append(n)
    for f in sorted(factors, reverse=True):
        best, best_local = -1, -1
        for i in reversed(range(len(dims))):
            local = dims[i] // geom[i]
            if local % f == 0 and (local // f) % 2 == 0:
                if local > best_local:
                    best, best_local = i, local
        if best < 0:
            raise ValueError(
                f"cannot partition lattice {tuple(dims)} over {ndev} devices")
        geom[best] *= f
    return tuple(geom)


@dataclasses.dataclass(frozen=True)
class LatticeMesh:
    """A lattice split over the ranks of a process group.

    ``rank`` is this process's rank in ``group`` (None: the default
    group, or no group at all for a one-rank mesh); ``staged`` sends
    CUDA tensors through host memory (a gloo group)."""

    lat: Lattice
    rank_geom: tuple[int, ...]
    rank: int = 0
    group: object | None = None
    staged: bool = False
    stats: dict = dataclasses.field(
        default_factory=lambda: {"staged_s": 0.0, "copy_s": 0.0},
        compare=False, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.rank_geom)

    @functools.cached_property
    def coords(self) -> tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(self.rank,
                                                      self.rank_geom))

    def rank_of(self, coords) -> int:
        return int(np.ravel_multi_index(
            tuple(c % g for c, g in zip(coords, self.rank_geom)),
            self.rank_geom))

    def neighbour(self, mu: int, sign: int) -> int:
        """Rank of the next (+1) or previous (-1) block along mu."""
        return self._neighbours[mu, sign]

    @functools.cached_property
    def _neighbours(self) -> dict:
        out = {}
        for mu in range(len(self.rank_geom)):
            for sign in (-1, 1):
                c = list(self.coords)
                c[mu] += sign
                out[mu, sign] = self.rank_of(c)
        return out

    @property
    def local_dims(self) -> tuple[int, ...]:
        return tuple(d // g for d, g in zip(self.lat.dims, self.rank_geom))

    @property
    def origin(self) -> tuple[int, ...]:
        """Global coordinates of this block's first site."""
        return tuple(c * n for c, n in zip(self.coords, self.local_dims))

    def block_slices(self, coords=None) -> tuple[slice, ...]:
        """Slices of the lattice axes (x, y, z, t) held by the rank at
        ``coords`` (default: this one)."""
        coords = self.coords if coords is None else coords
        return tuple(slice(c * n, (c + 1) * n)
                     for c, n in zip(coords, self.local_dims))

    # --- communication ---------------------------------------------------
    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def _to_host(self, *ts):
        """(tensors to send, start time or None): host copies of CUDA
        tensors on a staged mesh, timed from after the card's queued
        work, else the tensors themselves and None."""
        if not (self.staged and any(t.is_cuda for t in ts)):
            return ts, None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tuple(t.cpu() for t in ts)
        self.stats["copy_s"] += time.perf_counter() - t0
        return out, t0

    def _back(self, device, t0_staged: float, *ts):
        t0 = time.perf_counter()
        out = tuple(t.to(device) for t in ts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.stats["copy_s"] += t1 - t0
        self.stats["staged_s"] += t1 - t0_staged
        return out

    def exchange_faces(self, faces: dict) -> dict:
        """Face exchanges along several directions in one batch of sends
        and receives (and one trip through host memory on a staged
        mesh): for each ``mu: (to_prev, to_next)`` send ``to_prev`` to
        the previous rank along mu and ``to_next`` to the next, and
        return ``mu: (from_next, from_prev)``, what the next rank sent
        back and the previous one forward; an unsplit direction keeps
        its own faces."""
        out = {mu: f for mu, f in faces.items() if self.rank_geom[mu] == 1}
        split = [mu for mu in faces if self.rank_geom[mu] > 1]
        if not split:
            return out
        dev = faces[split[0]][0].device
        sends, staged = self._to_host(*[t.contiguous() for mu in split
                                        for t in faces[mu]])
        recvs = [torch.empty_like(t) for t in sends]
        ops = []
        for k, mu in enumerate(split):
            prev, nxt = (self._peer(self.neighbour(mu, -1)),
                         self._peer(self.neighbour(mu, +1)))
            a, b = sends[2 * k], sends[2 * k + 1]
            from_next, from_prev = recvs[2 * k], recvs[2 * k + 1]
            ops += [dist.P2POp(dist.isend, a, prev, self.group, tag=2 * mu),
                    dist.P2POp(dist.irecv, from_next, nxt, self.group,
                               tag=2 * mu),
                    dist.P2POp(dist.isend, b, nxt, self.group,
                               tag=2 * mu + 1),
                    dist.P2POp(dist.irecv, from_prev, prev, self.group,
                               tag=2 * mu + 1)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if staged is not None:
            recvs = self._back(dev, staged, *recvs)
        for k, mu in enumerate(split):
            out[mu] = (recvs[2 * k], recvs[2 * k + 1])
        return out

    def exchange_one(self, mu: int, face: torch.Tensor, sign: int
                     ) -> torch.Tensor:
        """One face exchange along a split direction mu: with sign +1
        send ``face`` to the previous rank and return what the next rank
        sent (its own first planes, for a forward shift); with sign -1
        send it to the next rank and return the previous rank's."""
        dev = face.device
        (send,), staged = self._to_host(face.contiguous())
        recv = torch.empty_like(send)
        to, frm = ((self.neighbour(mu, -1), self.neighbour(mu, +1))
                   if sign > 0 else
                   (self.neighbour(mu, +1), self.neighbour(mu, -1)))
        tag = 2 * mu + (sign > 0)
        ops = [dist.P2POp(dist.isend, send, self._peer(to), self.group,
                          tag=tag),
               dist.P2POp(dist.irecv, recv, self._peer(frm), self.group,
                          tag=tag)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if staged is not None:
            recv = self._back(dev, staged, recv)[0]
        return recv

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks (``t`` itself on a one-rank mesh
        without a group)."""
        if self.size == 1 and not dist.is_initialized():
            return t
        dev = t.device
        (h,), staged = self._to_host(t.clone())
        dist.all_reduce(h, group=self.group)
        if staged is not None:
            return self._back(dev, staged, h)[0]
        return h

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), indexed by rank."""
        if self.size == 1 and not dist.is_initialized():
            return [t]
        dev = t.device
        (h,), staged = self._to_host(t.contiguous())
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h, group=self.group)
        if staged is not None:
            return list(self._back(dev, staged, *parts))
        return parts

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier(group=self.group)


_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(lm: LatticeMesh | None):
    """Run the lattice code inside on ``lm``'s blocks (nothing changes
    for ``lm`` None).  Every rank must enter the same code in the same
    order: each shift across a split direction and each global sum is a
    collective of the group."""
    _ACTIVE.append(lm)
    try:
        yield lm
    finally:
        _ACTIVE.pop()


def active() -> LatticeMesh | None:
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def block_lattice(lat: Lattice) -> Lattice:
    """The lattice of this rank's block of ``lat`` under the active
    mesh (``lat`` itself with none, or where ``lat`` is not the mesh's
    global lattice, as a block's own lattice is not)."""
    lm = active()
    if lm is None or tuple(lat.dims) != tuple(lm.lat.dims):
        return lat
    return Lattice(lm.local_dims, nc=lat.nc)


def cut(f: torch.Tensor) -> torch.Tensor:
    """This rank's block of a whole field under the active mesh (``f``
    itself with none): the seeded draws, which every rank makes whole
    from the same generator and then cuts, so that a run on blocks
    reproduces a run without a mesh."""
    lm = active()
    return f if lm is None else local_block(lm, f)


def make_lattice_mesh(lat: Lattice, rank_geom: Sequence[int] | None = None,
                      group=None) -> LatticeMesh:
    """The mesh of ``lat`` over ``group`` (default: the default process
    group, or a lone rank where none is initialised).  ``rank_geom``
    overrides the automatic split (QEX ``-rankgeom:``)."""
    if dist.is_initialized():
        size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        staged = dist.get_backend(group) == "gloo"
    else:
        size, rank, staged = 1, 0, False
    if rank_geom is None:
        rank_geom = partition_geom(size, lat.dims)
    rank_geom = tuple(int(g) for g in rank_geom)
    if len(rank_geom) != lat.nd or math.prod(rank_geom) != size:
        raise ValueError(f"rank_geom {rank_geom} does not split lattice "
                         f"{lat.dims} over {size} ranks (run one process "
                         "per rank, e.g. under torchrun)")
    for d, g in zip(lat.dims, rank_geom):
        if d % g:
            raise ValueError(f"rank_geom {rank_geom} does not divide "
                             f"lattice {lat.dims}")
    return LatticeMesh(lat, rank_geom, rank, group, staged)


def local_block(lm: LatticeMesh, f: torch.Tensor, layout: str = "full"
                ) -> torch.Tensor:
    """This rank's block of a global field, contiguous: ``layout``
    "full" (site-tensor axes leading, the lattice's nd axes trailing),
    "eo" (an eo-packed half, t halved) or "fast" (``stag_fast``'s
    (..., Th, Z, Y*X), whose merged y and x stay whole: a z/t split)."""
    nd = lm.lat.nd
    sl = lm.block_slices()
    if layout == "fast":
        X, Y, Z, T = lm.lat.dims
        assert f.shape[-3:] == (T // 2, Z, Y * X), f.shape
        return f[..., slice(sl[3].start // 2, sl[3].stop // 2), sl[2],
                 :].contiguous()
    dims = tuple(lm.lat.dims)
    if layout == "eo":
        dims = dims[:-1] + (dims[-1] // 2,)
        sl = sl[:-1] + (slice(sl[-1].start // 2, sl[-1].stop // 2),)
    elif layout != "full":
        raise ValueError(f"unknown layout {layout!r}")
    assert f.shape[f.dim() - nd:] == dims, f.shape
    return f[(Ellipsis,) + sl].contiguous()


def gather_field(lm: LatticeMesh, block: torch.Tensor, layout: str = "full"
                 ) -> torch.Tensor:
    """The global field from every rank's block (an all-gather), on
    every rank; ``layout`` as :func:`local_block` ("full" or "eo")."""
    parts = lm.all_gather(block)
    nd = lm.lat.nd
    dims = tuple(lm.lat.dims)
    if layout == "eo":
        dims = dims[:-1] + (dims[-1] // 2,)
    out = block.new_empty(block.shape[:block.dim() - nd] + dims)
    for r, part in enumerate(parts):
        sl = lm.block_slices(np.unravel_index(r, lm.rank_geom))
        if layout == "eo":
            sl = sl[:-1] + (slice(sl[-1].start // 2, sl[-1].stop // 2),)
        out[(Ellipsis,) + sl] = part
    return out
