"""Even-odd (checkerboard) packing of lattice fields (port of
``qex_tpu.ops.eo``).

A packed field is a pair ``(even, odd)`` with the t extent halved:
``packed_P[..., x, y, z, th] = full[..., x, y, z, 2*th + s]`` with
``s = (P + x + y + z) mod 2`` and site parity ``P = (x+y+z+t) mod 2``.
x/y/z shifts are plain rolls of the opposite-parity array; t shifts
select between two rolls by ``s`` of the output site.  On a rank mesh's
blocks (even local extents, so a block's parities are the global ones)
the rolls exchange faces (``ops.shifts.roll``).
"""

from __future__ import annotations

import torch

from .shifts import roll


def _s_mask(dims: tuple[int, ...], parity: int,
            device: torch.device) -> torch.Tensor:
    """Bool mask s = (parity + x + y + z + ...) mod 2, shape
    dims[:-1] + (1,): the t-sublattice offset of each packed site."""
    nd = len(dims)
    s = torch.full((1,) * nd, parity, dtype=torch.int64, device=device)
    for i, d in enumerate(dims[:-1]):
        shape = [1] * nd
        shape[i] = d
        s = s + torch.arange(d, device=device).reshape(shape)
    return (s % 2).bool()


def pack(f: torch.Tensor, nd: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a full-lattice field into (even, odd) packed halves."""
    dims = tuple(f.shape[-nd:])
    if dims[-1] % 2 != 0:
        raise ValueError("t extent must be even for eo packing")
    th = dims[-1] // 2
    r = f.reshape(f.shape[:-1] + (th, 2))  # [..., th, c] = full t = 2*th + c
    out = []
    for parity in (0, 1):
        s = _s_mask(dims, parity, f.device)
        out.append(torch.where(s, r[..., 1], r[..., 0]))
    return out[0], out[1]


def unpack(even: torch.Tensor, odd: torch.Tensor, nd: int) -> torch.Tensor:
    """Inverse of :func:`pack`."""
    dims_h = tuple(even.shape[-nd:])
    dims = dims_h[:-1] + (2 * dims_h[-1],)
    s0 = _s_mask(dims, 0, even.device)   # where even sites sit at t%2==1
    c1 = torch.where(s0, even, odd)
    c0 = torch.where(s0, odd, even)
    r = torch.stack([c0, c1], dim=-1)
    return r.reshape(r.shape[:-2] + (dims[-1],))


def shift_eo(f_src: torch.Tensor, mu: int, sign: int, parity_out: int,
             nd: int, dist: int = 1) -> torch.Tensor:
    """Shifted packed field on ``parity_out`` sites:
    ``result[x] = f_src[x + sign*dist*mu_hat]`` where ``f_src`` lives on
    the source parity ``parity_out ^ (dist & 1)``."""
    if dist < 0:
        raise ValueError("dist must be positive; flip sign instead")
    axis = f_src.dim() - nd + mu
    if mu != nd - 1:
        return roll(f_src, sign * dist, axis, mu)
    dims_h = tuple(f_src.shape[-nd:])
    if dist % 2 == 0:
        return roll(f_src, sign * (dist // 2), axis, mu)
    # odd t shift: th' = th + (dist-1)/2 + s (forward),
    #              th' = th - (dist+1)/2 + s (backward)
    s = _s_mask(dims_h, parity_out, f_src.device)
    if sign > 0:
        base = roll(f_src, (dist - 1) // 2, axis, mu)
    else:
        base = roll(f_src, -((dist + 1) // 2), axis, mu)
    extra = roll(base, 1, axis, mu)
    return torch.where(s, extra, base)
