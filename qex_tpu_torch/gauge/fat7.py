"""Fat7 + Lepage link fattening and the HISQ two-level smear (port of
``qex_tpu.gauge.fat7``).

The generalized symmetric staple of a direction-``dir`` link-like field
L in direction nu is

    S_nu(L)(x) = U_nu(x) L(x+nu) U_nu(x+dir)^dag
               + U_nu(x-nu)^dag L(x-nu) U_nu(x-nu+dir)

(:func:`.smear.sym_staple`); fat7 stacks it into 3-, 5- and 7-link paths
and the same-direction Lepage term.  :func:`hisq_links` is fat7, the
U(3) polar projection, then asqtad fat + naik links of the projected
field, and is differentiable: HISQ forces come from autograd through it
(with the projection's closed-form backward, :func:`..ops.linalg.project_u`).
:func:`hisq_links_lowmem` is its forward-only twin, one output
direction at a time.
"""

from __future__ import annotations

import dataclasses

import torch

from ..lattice import Lattice
from ..ops import linalg
from ..ops.shifts import shift
from .smear import sym_staple


@dataclasses.dataclass(frozen=True)
class Fat7lCoefs:
    """QEX ``Fat7lCoefs`` (fat7l.nim:5-10)."""

    one_link: float = 0.0
    three_staple: float = 0.0
    five_staple: float = 0.0
    seven_staple: float = 0.0
    lepage: float = 0.0


def set_hisq_fat7(f7lf: float, naik: float) -> Fat7lCoefs:
    """QEX ``setHisqFat7`` (hisqLinks.nim:9-14)."""
    return Fat7lCoefs(
        one_link=(1.0 + 3.0 * f7lf + naik) / 8.0,
        three_staple=-1.0 / 16.0,
        five_staple=1.0 / 64.0,
        seven_staple=-1.0 / 384.0,
        lepage=-f7lf / 16.0,
    )


@dataclasses.dataclass(frozen=True)
class HisqCoefs:
    """QEX ``HisqCoefs`` defaults (hisqLinks.nim:16-22)."""

    fat7_first: Fat7lCoefs = set_hisq_fat7(0.0, 0.0)
    fat7_second: Fat7lCoefs = set_hisq_fat7(2.0, 1.0)
    naik: float = -1.0 / 24.0


def make_imp_links(lat: Lattice, u: torch.Tensor, c: Fat7lCoefs,
                   u_long: torch.Tensor | None = None, naik: float = 0.0
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Fat links and, when ``naik`` is nonzero, naik long links
    ``naik * U(x) U(x+mu) U(x+2mu)`` of ``u_long`` (default ``u``)."""
    nd = lat.nd
    fl = torch.stack([fat_link_dir(lat, u, c, d) for d in range(nd)])
    ll = None
    if naik != 0.0:
        gl = u_long if u_long is not None else u
        ll = torch.stack([naik_link_dir(lat, gl, naik, d)
                          for d in range(nd)])
    return fl, ll


def fat_link_dir(lat: Lattice, u: torch.Tensor, c: Fat7lCoefs,
                 dir_: int) -> torch.Tensor:
    """One output direction of the fat7 + Lepage links: the one-link
    term with the Lepage backtracking correction ``c1 - 6*lepage``,
    3-staples, the same-direction Lepage 5-link path, 5- and
    7-staples."""
    nd = lat.nd
    c1 = c.one_link - 6.0 * c.lepage
    have5 = c.five_staple != 0.0 or c.seven_staple != 0.0 \
        or c.lepage != 0.0
    have3 = c.three_staple != 0.0 or have5

    fl = c1 * u[dir_]
    if have3:
        for nu in range(nd):
            if nu == dir_:
                continue
            s3 = sym_staple(u[nu], u[dir_], nu, dir_, nd)
            fl = fl + c.three_staple * s3
            if c.lepage != 0.0:
                fl = fl + c.lepage * sym_staple(u[nu], s3, nu, dir_, nd)
            if have5:
                for rho in range(nd):
                    if rho in (dir_, nu):
                        continue
                    s5 = sym_staple(u[rho], s3, rho, dir_, nd)
                    fl = fl + c.five_staple * s5
                    if c.seven_staple != 0.0:
                        for sig in range(nd):
                            if sig in (dir_, nu, rho):
                                continue
                            fl = fl + c.seven_staple * sym_staple(
                                u[sig], s5, sig, dir_, nd)
    return fl


def naik_link_dir(lat: Lattice, gl: torch.Tensor, naik: float,
                  dir_: int) -> torch.Tensor:
    """naik * U(x) U(x+d) U(x+2d) for one direction."""
    nd = lat.nd
    a = shift(gl[dir_], dir_, +1, nd)                 # U(x+d)
    b = shift(linalg.mul(gl[dir_], a), dir_, +1, nd)  # U(x+d)U(x+2d)
    return naik * linalg.mul(gl[dir_], b)


def hisq_links(lat: Lattice, u: torch.Tensor, c: HisqCoefs = HisqCoefs(),
               proj_iters: int = 14) -> tuple[torch.Tensor, torch.Tensor]:
    """HISQ two-level smear: fat7 -> U(3) polar projection (per
    direction) -> asqtad fat + naik links of the projected field.

    Returns (fat_links, long_links) for
    :func:`..physics.staggered.new_stag3_eo`; differentiable."""
    t1, _ = make_imp_links(lat, u, c.fat7_first)
    t2 = torch.stack([linalg.project_u(t1[d], iters=proj_iters)
                      for d in range(lat.nd)])
    fl, ll = make_imp_links(lat, t2, c.fat7_second, u_long=t2,
                            naik=c.naik)
    return fl, ll


@torch.no_grad()
def hisq_links_lowmem(lat: Lattice, u: torch.Tensor,
                      c: HisqCoefs = HisqCoefs(), proj_iters: int = 14
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-only :func:`hisq_links`: each fat7 level computes one
    output direction at a time (the projection fused into the first
    level), so only that direction's temporaries are live; same values
    as :func:`hisq_links`, and nothing is recorded for autograd."""
    nd = lat.nd
    t2 = torch.stack([linalg.project_u(fat_link_dir(lat, u, c.fat7_first,
                                                    d), iters=proj_iters)
                      for d in range(nd)])
    fl = torch.stack([fat_link_dir(lat, t2, c.fat7_second, d)
                      for d in range(nd)])
    ll = torch.stack([naik_link_dir(lat, t2, c.naik, d) for d in range(nd)])
    return fl, ll
