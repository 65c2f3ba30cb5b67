"""Traffic kind "solve": back-to-back ``stag_solve.solve_ee`` solves of
the even-site staggered system (m^2 - D_eo D_oe) x = b on nHYP links
smeared once in set-up, each on a fresh right-hand side made from the
seed.

A sample of the solves, drawn from the seed, keeps its solutions; after
the window the reference works the links out again in complex128 and
computes each sampled solution's true relative residual with its own
operator.  :class:`SolveCell` is that loop for any solve; the
multishift kind shares it.
"""

from __future__ import annotations

import math
import random

import torch

from .. import fields
from ..reference import lattice as L


def sample_indices(ctx) -> list[int]:
    """The solves kept for the check: ``sample_count`` of the first
    ``sample_among_first``, drawn from the seed."""
    tr = ctx.traffic
    pick = random.Random(fields.derive(ctx.seed, "sample"))
    return sorted(pick.sample(range(tr["sample_among_first"]),
                              tr["sample_count"]))


class SolveCell:
    """Solves on fresh seeded sources with a seeded sample kept for the
    check.  A subclass sets up the program (``prepare``), runs one
    solve returning ([x per mass], stats) (``solve``) and names the
    reference's operators (module function ``reference_ops``)."""

    reference_ops = None
    objects = {}            # no span of these traffics targets an object

    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.dims = ctx.dims
        self.u = fields.start_links(self.dims, tr["start"], ctx.device)
        ctx.mark("start_s")
        self.prepare(ctx.config["operator"])
        ctx.mark("program_s")
        self.sample_indices = sample_indices(ctx)
        self.samples = {}
        for i in range(tr["warmup_units"]):
            self.solve(fields.source(self.dims, ctx.seed, -1 - i,
                                     ctx.device))
        ctx.mark("warmup_s")

    def unit(self, i: int) -> dict:
        b = fields.source(self.dims, self.ctx.seed, i, self.ctx.device)
        xs, stats = self.solve(b)
        if i in self.sample_indices:
            self.samples[i] = [x.cpu() for x in xs]  # off the device's peak
        return {"iterations": stats.iterations, "r2": stats.r2,
                "failed": not (math.isfinite(stats.r2)
                               and stats.r2 <= self.ctx.traffic["fail_r2"])}

    def check(self) -> dict:
        """Worst true relative residual over the sampled solves and
        their masses."""
        missing = set(self.sample_indices) - set(self.samples)
        if missing:
            raise RuntimeError(f"the window closed before solves "
                               f"{sorted(missing)}")
        with torch.no_grad():
            ops = self.reference_ops(self.ctx.config["operator"], self.u,
                                     L.Precision("complex128"))
            worst = 0.0
            for i, xs in sorted(self.samples.items()):
                b = fields.source(self.dims, self.ctx.seed, i,
                                  self.ctx.device)
                for (fat, long, m), x in zip(ops, xs):
                    worst = max(worst, residual(fat, long, m,
                                                x.to(b.device), b,
                                                self.dims))
        return {"true_r2": worst}


def links(op: dict, u, pr: L.Precision):
    """Phased nHYP links of u in precision ``pr``."""
    return L.phased(L.nhyp(pr.cast(u), op["smear"]["alphas"], pr), op["bc"],
                    pr)


def reference_ops(op: dict, u, pr: L.Precision) -> list:
    """[(fat, long, mass)] of the solve: the nHYP links, no naik."""
    return [(links(op, u, pr), None, op["mass"])]


class Cell(SolveCell):
    reference_ops = staticmethod(reference_ops)

    def prepare(self, op: dict) -> None:
        from qex_tpu_torch.gauge.smear import HypCoefs, nhyp_smear
        from qex_tpu_torch.lattice import Lattice
        from qex_tpu_torch.physics import staggered as st
        from qex_tpu_torch.physics import stag_solve
        from qex_tpu_torch.solvers.base import SolverParams
        tr = self.ctx.traffic
        lat = Lattice(self.dims)
        self.m = op["mass"]
        with torch.no_grad():
            v = nhyp_smear(HypCoefs(*op["smear"]["alphas"]), lat, self.u)
            self.s = st.new_stag_eo(lat, v, op["bc"])
        self.params = SolverParams(r2req=tr["r2req"], maxits=tr["maxits"],
                                   restarts=tr["restarts"])
        self.program = stag_solve

    def solve(self, b):
        x, stats = self.program.solve_ee(self.s, b, self.m, self.params)
        return [x], stats

    def release(self) -> None:
        del self.s


def residual(fat, long, m: float, x_packed, b_packed, dims) -> float:
    """True |b - A x|^2 / |b|^2 of a packed even-site solution, with the
    reference operator in complex128."""
    pr = L.Precision("complex128")
    x = L.unpack_even(x_packed.to(torch.complex128), dims)
    b = L.unpack_even(b_packed.to(torch.complex128), dims)
    return L.true_r2(lambda y: L.normal_op(fat, y, m * m, pr, long), x, b)


def solve_control(ctx, ops_fn) -> dict:
    """The reference in :data:`~benchmark.reference.lattice.CONTROL`
    put in the program's place: the links worked out in that precision
    and a CG per mass to the cell's r2req on the first ``control_count``
    sampled sources, judged as :meth:`SolveCell.check` judges the
    program's solutions."""
    tr, op = ctx.traffic, ctx.config["operator"]
    u = fields.start_links(ctx.dims, tr["start"], ctx.device)
    pr = L.Precision(L.CONTROL)
    worst = 0.0
    with torch.no_grad():
        low = ops_fn(op, u, pr)
        ref = ops_fn(op, u, L.Precision("complex128"))
        for i in sample_indices(ctx)[:tr["control_count"]]:
            b = fields.source(ctx.dims, ctx.seed, i, ctx.device)
            full = pr.cast(L.unpack_even(b, ctx.dims))
            for (fat, long, m), (rfat, rlong, _m) in zip(low, ref):
                x, _its = L.cg(
                    lambda y: L.normal_op(fat, y, m * m, pr, long), full,
                    tr["r2req"], tr["maxits"], pr)
                worst = max(worst, residual(rfat, rlong, m,
                                            L.pack_even(x, ctx.dims), b,
                                            ctx.dims))
    return {"control": {"true_r2": worst}}


def control(ctx) -> dict:
    return solve_control(ctx, reference_ops)


def setup(ctx):
    return Cell(ctx)
