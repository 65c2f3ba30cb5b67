"""Assembled coarse operator for the multigrid hierarchy (port of
``qex_tpu.mg.coarse``).

The Galerkin coarse operator D_c = R D P applied matrix-free costs one
fine operator application per coarse matvec.  Assembling it once at
setup gives a 9-point coarse stencil (one (nc_c, nc_c) matrix per site
per offset), after which coarse matvecs are nine small batched products
on the coarse grid.

Assembly is by probing, so it is generic over any nearest-neighbour
operator (including an assembled coarse one):

  * diagonal: 2 checkerboard probes per color -- the stencil reaches
    only distance-1 neighbours, which sit on the opposite checkerboard,
    so outputs on the probe's own parity isolate the diagonal block.
  * hops: per direction mu, probe colors supported on lattice lines
    x_mu == r (mod k) with k >= 3 a divisor of L_mu: outputs at
    x_mu == r+1 receive only the +mu hop from x_mu == r, outputs at r-1
    only the -mu hop.
  * extent L_mu == 2: the +mu and -mu neighbours are the same site, so
    the probe yields (and the apply consumes) the merged hop A+ + A-.

The JAX package applies the probes as vmapped chunks; here each probe
is one operator application, accumulated as it comes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..device import resolve


@dataclasses.dataclass(frozen=True)
class CoarseStencil:
    """9-point stencil: diag (nc, nc, *dims); hops[i] = (plus, minus)
    each (nc, nc, *dims) for lattice axis axes[i]; minus is None for
    merged extent-2 axes; extent-1 axes are absent (folded into diag)."""

    diag: torch.Tensor
    hops: tuple     # ((plus, minus | None), ...) per listed axis
    axes: tuple     # lattice axis index of each hops entry


def _line_spacing(L: int) -> int:
    """Smallest divisor of L that is >= 3 (probe spacing along one
    axis); 0 signals the merged extent-2 case; -1 an extent-1 axis."""
    if L == 1:
        return -1
    if L == 2:
        return 0
    for k in range(3, L + 1):
        if L % k == 0:
            return k
    raise ValueError(f"cannot probe axis of extent {L}")


def apply_stencil(st: CoarseStencil, c: torch.Tensor) -> torch.Tensor:
    """y(x) = diag(x) c(x) + sum_mu A+_mu(x) c(x-mu) + A-_mu(x) c(x+mu)."""
    y = torch.einsum("kl...,l...->k...", st.diag, c)
    for mu, (plus, minus) in zip(st.axes, st.hops):
        ax = 1 + mu
        y = y + torch.einsum("kl...,l...->k...", plus,
                             torch.roll(c, 1, dims=ax))
        if minus is not None:
            y = y + torch.einsum("kl...,l...->k...", minus,
                                 torch.roll(c, -1, dims=ax))
    return y


def assemble_stencil(op: Callable, nc: int, dims, dtype: torch.dtype,
                     device: torch.device | str | None = None
                     ) -> CoarseStencil:
    """Probe the nearest-neighbour operator ``op`` acting on
    (nc, *dims) fields on ``device`` (default: the CUDA card) into an
    explicit :class:`CoarseStencil`: ``nc * (2 + sum_mu k_mu)``
    operator applications."""
    device = resolve(device)
    nd = len(dims)
    dims = tuple(int(d) for d in dims)
    coords = torch.meshgrid(*[torch.arange(d, device=device) for d in dims],
                            indexing="ij")
    cb = sum(coords) % 2
    probes = [(cb == s, "diag", -1, s) for s in (0, 1)]
    spacings = []
    for mu in range(nd):
        k = _line_spacing(dims[mu])
        spacings.append(k)
        if k < 0:
            continue          # extent-1 axis: folded into the diagonal
        kk = k if k else 2
        probes += [(coords[mu] % kk == r, "hop", mu, r) for r in range(kk)]

    def zeros():
        return torch.zeros((nc, nc) + dims, dtype=dtype, device=device)

    diag = zeros()
    plus, minus = [zeros() for _ in dims], [zeros() for _ in dims]
    for mask, kind, mu, r in probes:
        if kind == "diag":      # outputs on the probe's own checkerboard
            out, sel_p, sel_m = diag, mask.to(dtype), None
        else:
            kk = spacings[mu] if spacings[mu] else 2
            out = plus[mu]
            sel_p = (coords[mu] % kk == (r + 1) % kk).to(dtype)
            sel_m = ((coords[mu] % kk == (r - 1) % kk).to(dtype)
                     if spacings[mu] else None)
        for l in range(nc):
            vec = torch.zeros((nc,) + dims, dtype=dtype, device=device)
            vec[l] = mask.to(dtype)
            y = op(vec)                              # column l: (k, dims)
            out[:, l] += y * sel_p
            if sel_m is not None:
                minus[mu][:, l] += y * sel_m
    hops = tuple((plus[mu], minus[mu] if spacings[mu] > 0 else None)
                 for mu in range(nd) if spacings[mu] >= 0)
    axes = tuple(mu for mu in range(nd) if spacings[mu] >= 0)
    return CoarseStencil(diag, hops, axes)
