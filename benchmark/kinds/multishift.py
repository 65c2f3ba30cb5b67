"""Traffic kind "multishift": back-to-back ``HisqFermion.solve_multi``
multi-mass solves (one multishift Krylov space over the HISQ fat + naik
operator) on links fattened once in set-up, each on a fresh right-hand
side made from the seed; the loop and the check are
:class:`.solve.SolveCell`'s, with the reference fattening the links
again in complex128 and judging every mass."""

from __future__ import annotations

import torch

from ..reference import lattice as L
from .solve import SolveCell, solve_control


def reference_ops(op: dict, u, pr: L.Precision) -> list:
    """[(fat, long, mass)] per mass: HISQ links of u with the phases and
    boundary signs folded in first, in precision ``pr``."""
    fat, long = L.hisq_links(L.phased(pr.cast(u), op["bc"], pr), pr,
                             op["fat7"])
    return [(fat, long, m) for m in op["masses"]]


class Cell(SolveCell):
    reference_ops = staticmethod(reference_ops)

    def prepare(self, op: dict) -> None:
        from qex_tpu_torch.gauge import fat7
        from qex_tpu_torch.lattice import Lattice
        from qex_tpu_torch.physics import stag_hmc
        from qex_tpu_torch.physics import staggered as st
        from qex_tpu_torch.solvers.base import SolverParams
        tr = self.ctx.traffic
        lat = Lattice(self.dims)
        self.masses = tuple(op["masses"])
        self.ferm = stag_hmc.HisqFermion(
            lat, self.masses[0], bc=op["bc"],
            params=SolverParams(r2req=tr["r2req"], maxits=tr["maxits"]))
        with torch.no_grad():
            self.links = fat7.hisq_links_lowmem(
                lat, st.phase_links(lat, self.u, op["bc"]))

    def solve(self, b):
        return self.ferm.solve_multi(self.u, b, self.masses,
                                     links=self.links)

    def release(self) -> None:
        del self.ferm, self.links


def control(ctx) -> dict:
    return solve_control(ctx, reference_ops)


def setup(ctx):
    return Cell(ctx)
