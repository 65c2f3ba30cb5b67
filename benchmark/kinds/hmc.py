"""Traffic kind "hmc": back-to-back ``LatticeFieldTheory.hmc_step``
trajectories with Metropolis, as the production app calls it, on links
made from the seed.

One trajectory of the window, drawn from the seed, is the sample: it
starts from the cell's start links, as the benchmark made them, and its
momenta and pseudofermion noise are the benchmark's own draws, handed
to the program in place of its draw for that trajectory.  The run keeps
the proposed links, H before and after, the Metropolis uniform and
decision, and the links the step hands on.  After the window the
reference runs that trajectory from the same inputs, and the run
compares H at the start, dH and the proposed links, and judges the
decision and the links handed on by the Metropolis rule applied to the
program's dH and uniform.
"""

from __future__ import annotations

import math
import random

import torch

from .. import fields
from ..reference import hmc as ref_hmc
from ..reference import lattice as L


def build_theory(action: dict, lat):
    """The program's ``LatticeFieldTheory`` for a configuration's
    "action" block (a staggered fermion and a Pauli-Villars boson on
    nHYP links, a Wilson gauge action)."""
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.solvers.base import SolverParams
    g, f, b = action["gauge"], action["fermion"], action["boson"]
    integ = action["integrator"]
    scheme = f"{integ['scheme']},{integ['lambda']}"
    sa, sf = action["solver_action"], action["solver_force"]
    return LatticeFieldTheory(
        lat,
        gauge=GaugeActionSpec(ga.wilson(g["beta"]), steps=g["steps"],
                              scheme=scheme),
        fermions=[FermionSpec("fermion", mass=f["mass"], steps=f["steps"],
                              scheme=scheme),
                  FermionSpec("boson", mass=b["mass"], steps=b["steps"],
                              scheme=scheme)],
        smear=HypCoefs(*action["smear"]["alphas"]), bc=action["bc"],
        solver_params=SolverParams(r2req=sa["r2req"], maxits=sa["maxits"],
                                   restarts=sa["restarts"]),
        force_solver_params=SolverParams(r2req=sf["r2req"],
                                         maxits=sf["maxits"],
                                         restarts=sf["restarts"]),
        tau=action["tau"])


class Cell:
    def __init__(self, ctx):
        from qex_tpu_torch.lattice import Lattice
        self.ctx = ctx
        tr, dims, dev = ctx.traffic, ctx.dims, ctx.device
        self.dims = dims
        self.lat = Lattice(dims)
        self.th = build_theory(ctx.config["action"], self.lat)
        self.objects = {"theory": self.th}
        self.u = fields.start_links(dims, tr["start"], dev)
        self.start = self.u.cpu()      # off the device's peak
        ctx.mark("start_s")
        self.gen = fields.generator(dev, ctx.seed, "markov")
        pick = random.Random(fields.derive(ctx.seed, "sample"))
        self.sample_index = pick.randrange(tr["sample_among_first"])
        self.recording = False
        self.sample = None
        self._install_recorders()
        for _ in range(tr["warmup_units"]):
            self.u, _state = self.th.hmc_step(self.gen, self.u)
        ctx.mark("warmup_s")

    def _install_recorders(self):
        """Pass-through wrappers on the theory's draws, trajectory and
        Metropolis step: while recording they hand the program the
        benchmark's draws and keep the proposal and the uniform."""
        th, rec = self.th, {}
        draw_momenta, draw_noise = th.draw_momenta, th.draw_noise
        trajectory, metropolis = th.trajectory, th.metropolis

        def momenta(gen, u):
            if not self.recording:
                return draw_momenta(gen, u)
            rec["p"] = fields.momenta(self.dims, self._draws)
            return rec["p"]

        def noise(gen, u):
            if not self.recording:
                return draw_noise(gen, u)
            xis = [fields.noise(self.dims, self._draws) if t.heatbath
                   else None for t in th.terms]
            rec["xi"] = [x for x in xis if x is not None]
            return xis

        def traj(u, p, phis):
            u1, p1 = trajectory(u, p, phis)
            if self.recording:
                rec["u1"] = u1
            return u1, p1

        def accept(dH, r):
            if self.recording:
                rec["r"] = r
            return metropolis(dH, r)

        th.draw_momenta, th.draw_noise = momenta, noise
        th.trajectory, th.metropolis = traj, accept
        self._rec = rec

    def unit(self, i: int) -> dict:
        self.recording = i == self.sample_index
        if self.recording:
            self._draws = fields.generator(self.ctx.device, self.ctx.seed,
                                           "sample draws")
            self.u = self.start.to(self.ctx.device)
        self.u, state = self.th.hmc_step(self.gen, self.u)
        if self.recording:
            # the sample waits on the host, so that the device's peak
            # does not depend on which trajectory was sampled
            self.recording = False
            rec = self._rec
            self.sample = {"p": rec.pop("p").cpu(),
                           "xi": [x.cpu() for x in rec.pop("xi")],
                           "u1": rec.pop("u1").cpu(), "r": rec.pop("r"),
                           "u_out": self.u.cpu(), "h_old": state.h_old,
                           "h_new": state.h_new, "dH": state.dH,
                           "accepted": state.accepted}
        return {"dH": state.dH, "accepted": state.accepted,
                "failed": not math.isfinite(state.dH)}

    def release(self) -> None:
        del self.th, self.objects, self.u, self.gen, self._rec

    def check(self) -> dict:
        """The sample's trajectory by the reference (:func:`compare`)."""
        if self.sample is None:
            raise RuntimeError("the window closed before the sampled "
                               "trajectory")
        dev = self.ctx.device
        s = {k: ([x.to(dev) for x in v] if k == "xi" else
                 v.to(dev) if torch.is_tensor(v) else v)
             for k, v in self.sample.items()}
        s["u"] = self.start.to(dev)
        ref = reference_trajectory(self.ctx.config, s, "complex128")
        return compare(s, ref)


def reference_trajectory(config: dict, s: dict, precision: str) -> dict:
    c4 = ref_hmc.Config4(config["action"], L.Precision(precision))
    xi_f, xi_b = s["xi"]
    return c4.trajectory(s["u"], s["p"], xi_f, xi_b)


def rel(a, b) -> float:
    """|a - b| / |b| over all components, in complex128."""
    a, b = a.to(torch.complex128), b.to(torch.complex128)
    return math.sqrt(float(L.norm2(a - b) / L.norm2(b)))


def compare(s: dict, ref: dict) -> dict:
    """|H_old - H_old_ref|, |dH - dH_ref|, |u1 - u1_ref| / |u1_ref|;
    whether the step's decision differs from the Metropolis rule on its
    own dH and uniform (0 or 1), and how far the links it hands on lie
    from those that rule picks (u1 or the start)."""
    take = ref_hmc.metropolis(s["dH"], s["r"])
    return {"h_old_gap": abs(s["h_old"] - ref["h_old"]),
            "dH_gap": abs(s["dH"] - ref["dH"]),
            "links_rel": rel(s["u1"], ref["u"]),
            "accept_mismatch": float(bool(s["accepted"]) != take),
            "handed_on_rel": rel(s["u_out"], s["u1"] if take else s["u"])}


def setup(ctx):
    return Cell(ctx)


def control(ctx) -> dict:
    """Readings of the reference put in the program's place, judged as
    :meth:`Cell.check` judges the program, from the cell's start links
    and the sample's draws.  "control": the whole trajectory in
    :data:`~benchmark.reference.lattice.CONTROL`.  The rest keep the
    complex128 trajectory and change H alone, at both ends:
    "h_float32" sums H in float32 (the configuration states float64),
    "h_without_boson" leaves the Pauli-Villars term out of H, and
    "h_action_at_force_r2" solves H's fermion system to the force
    tolerance."""
    dev = ctx.device
    u = fields.start_links(ctx.dims, ctx.traffic["start"], dev)
    draws = fields.generator(dev, ctx.seed, "sample draws")
    p = fields.momenta(ctx.dims, draws)
    xi = [fields.noise(ctx.dims, draws), fields.noise(ctx.dims, draws)]
    r = float(torch.rand((), dtype=torch.float64, generator=fields.generator(
        dev, ctx.seed, "control uniform"), device=dev))
    s = {"u": u, "p": p, "xi": xi}
    ref = reference_trajectory(ctx.config, s, "complex128")
    c4 = ref_hmc.Config4(ctx.config["action"], L.Precision("complex128"))
    ends = [(u.to(torch.complex128), p.to(torch.complex128)),
            (ref["u"], ref["p"])]
    r2_force = ctx.config["action"]["solver_force"]["r2req"]

    def h_float32(uu, pp):
        terms = c4.hamiltonian_terms(uu, pp, ref["phis"], torch.float32)
        return float(torch.stack(list(terms.values())).sum())

    def h_without_boson(uu, pp):
        terms = c4.hamiltonian_terms(uu, pp, ref["phis"])
        return float(sum(v for k, v in terms.items() if k != "boson"))

    def h_action_at_force_r2(uu, pp):
        return float(sum(c4.hamiltonian_terms(uu, pp, ref["phis"],
                                              r2=r2_force).values()))

    def judged(h_old, h_new, u1):
        dH = h_new - h_old
        take = ref_hmc.metropolis(dH, r)
        return compare({"u": u, "u1": u1, "h_old": h_old, "dH": dH, "r": r,
                        "accepted": take, "u_out": u1 if take else u}, ref)

    low = reference_trajectory(ctx.config, s, L.CONTROL)
    out = {"control": judged(low["h_old"], low["h_new"], low["u"])}
    for fn in (h_float32, h_without_boson, h_action_at_force_r2):
        out[fn.__name__] = judged(*[fn(*end) for end in ends], ref["u"])
    return out
