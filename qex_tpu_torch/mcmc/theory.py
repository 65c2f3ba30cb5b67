"""Gauge + smeared staggered matter HMC (port of ``GaugeActionSpec``,
``FermionSpec`` and ``LatticeFieldTheory`` from ``qex_tpu.mcmc.theory``).

``hmc_step(gen, u)`` draws the momenta, the pseudofermion noise and the
Metropolis uniform from one ``torch.Generator``.  The pieces that
consume draws are public so callers can inject their own:
``heatbath_from_noise(xis, u)``, ``trajectory(u, p, phis)`` and
``metropolis(dH, r)``.  H and its global sums accumulate in float64.

With ``smear`` (``HypCoefs`` or ``StoutCoefs``) the matter terms act on
the smeared links V = smear(U) (``FermionSpec.smeared``, default True)
and so may gauge terms (``GaugeActionSpec.smeared``).  Eager torch would
redo the smear for every term, so ``hamiltonian``, ``heatbath`` and
``solver_report`` smear U once for all smeared terms, and the MD kicks
of one time share one smear forward and one pullback (``mcmc.md``).

With a rank mesh (``SolverParams.mesh``; the app's ``-rank_geom``, a
deck's ``mpi-geometry``) the theory is block-resident: every method
takes and returns this rank's block of the links (and of the momenta
and pseudofermions), runs inside ``parallel.mesh.use_mesh`` so that
every shift exchanges faces and every sum is a float64 all-reduce, and
draws each noise field whole from the same generator on every rank
before cutting its block, so that a run on blocks reproduces a run
without a mesh; H and the Metropolis uniform are the same on every
rank, and so is the decision.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import torch

from ..gauge.action import (GaugeActionCoeffs, force_from_action,
                            full_action, gauge_force, gauge_grad)
from ..gauge.smear import HypCoefs, StoutCoefs, nhyp_smear, stout_smear
from ..hmc import hmc as hmc_mod
from ..lattice import Lattice
from ..ops import linalg
from ..parallel.halo import psum
from ..parallel.mesh import use_mesh
from ..physics import stag_hmc
from ..solvers.base import SolverParams
from .md import ActionTerm, run_trajectory


@dataclasses.dataclass(frozen=True)
class GaugeActionSpec:
    """Gauge action + its MD timescale; ``smeared`` puts it on the
    smeared links (the app's smeared-gauge term)."""

    coeffs: GaugeActionCoeffs
    steps: int = 10
    scheme: str = "2MN"
    smeared: bool = False


@dataclasses.dataclass(frozen=True)
class FermionSpec:
    """One staggered matter field: ``kind`` is "fermion", "boson",
    "rooted" (S = phi^dag A^{-nf/4} phi by a rational approximation of
    ``degree`` poles) or "hisq" (HISQ does its own fat7 + naik smearing,
    so its ``smeared`` is ignored).  ``hmasses`` (ascending Hasenbusch
    masses) splits a "fermion" or "hisq" field into ratio terms and one
    plain term at the heaviest mass; other kinds ignore it, as the JAX
    package does."""

    kind: str
    mass: float
    steps: int = 10
    scheme: str = "2MN"
    smeared: bool = True
    nf: int = 1
    degree: int = 10
    hmasses: tuple = ()


def _on_mesh(method):
    """Run ``method`` on the theory's rank mesh (``use_mesh``)."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        with use_mesh(self.mesh):
            return method(self, *args, **kw)
    return run


def _grad_at(action: Callable[[torch.Tensor], torch.Tensor],
             v: torch.Tensor) -> torch.Tensor:
    """torch-convention gradient of a real action at links v."""
    with torch.enable_grad():
        vv = v.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(action(vv), vv)
    return g


def _n2(x: torch.Tensor) -> torch.Tensor:
    return psum(linalg.norm2(x, torch.float64))


class LatticeFieldTheory:
    """Gauge + matter HMC system."""

    def __init__(self, lat: Lattice,
                 gauge: GaugeActionSpec | Sequence[GaugeActionSpec],
                 fermions: Sequence[FermionSpec] = (),
                 smear: HypCoefs | StoutCoefs | None = None,
                 bc: str = "pppa",
                 solver_params: SolverParams = SolverParams(
                     r2req=1e-12, maxits=2000, restarts=3),
                 force_solver_params: SolverParams | None = None,
                 tau: float = 1.0):
        if smear is not None and not isinstance(smear, (HypCoefs,
                                                        StoutCoefs)):
            raise TypeError(f"smear must be HypCoefs, StoutCoefs or None, "
                            f"not {type(smear).__name__}")
        self.lat = lat
        self.gauges = ((gauge,) if isinstance(gauge, GaugeActionSpec)
                       else tuple(gauge))
        self.fermions = tuple(fermions)
        self.smear_coefs = smear
        self.bc = bc
        self.solver_params = solver_params
        self.mesh = solver_params.mesh
        self.force_solver_params = force_solver_params
        self.tau = tau
        self.matter_bases: list[tuple[str, Any, bool]] = []
        # per term: (action at its own links, heatbath at its own links)
        self._at_links: list[tuple[Callable, Callable | None]] = []
        self.terms = self._build_terms()

    def _smear(self, u: torch.Tensor) -> torch.Tensor:
        if self.smear_coefs is None:
            return u
        if isinstance(self.smear_coefs, StoutCoefs):
            return stout_smear(self.smear_coefs, self.lat, u)
        return nhyp_smear(self.smear_coefs, self.lat, u)

    def _any_smeared(self) -> bool:
        return any(t.smeared for t in self.terms)

    def _build_terms(self) -> list[ActionTerm]:
        lat = self.lat
        terms: list[ActionTerm] = []
        for gi, gspec in enumerate(self.gauges):
            gc = gspec.coeffs
            smeared = gspec.smeared and self.smear_coefs is not None

            def g_at(w, _phi, gc=gc):
                return full_action(gc, lat, w)

            def g_action(u, phi, g_at=g_at, smeared=smeared):
                return g_at(self._smear(u) if smeared else u, phi)

            def g_force(u, _phi, gc=gc, smeared=smeared, g_action=g_action):
                if not smeared:
                    return gauge_force(gc, lat, u)
                return force_from_action(lambda uu: g_action(uu, None), u)

            def g_chain(v, _phi, gc=gc):
                return gauge_grad(gc, lat, v)

            name = "smeared_gauge" if smeared else "gauge"
            terms.append(ActionTerm(f"{name}{gi}", g_action, g_force,
                                    gspec.steps, gspec.scheme,
                                    smeared=smeared,
                                    chain_force=g_chain if smeared
                                    else None,
                                    fg_form="hvp" if smeared else "jvp"))
            self._at_links.append((g_at, None))

        for i, spec in enumerate(self.fermions):
            sp, fp = self.solver_params, self.force_solver_params
            if spec.kind == "hisq":
                spec = dataclasses.replace(spec, smeared=False)
            if spec.kind in ("fermion", "hisq") and spec.hmasses:
                # Hasenbusch chain: ratio(m, h1), ratio(h1, h2), ...,
                # and the plain field at the heaviest mass
                ms = (spec.mass,) + tuple(spec.hmasses)
                if spec.kind == "fermion":
                    bases = [stag_hmc.StagHasenbusch(
                        lat, ms[j], ms[j + 1], self.bc, sp, force_params=fp)
                        for j in range(len(ms) - 1)]
                    bases.append(stag_hmc.StagFermion(
                        lat, ms[-1], self.bc, sp, force_params=fp))
                else:
                    bases = [stag_hmc.HisqHasenbusch(
                        lat, ms[j], ms[j + 1], self.bc, params=sp,
                        force_params=fp) for j in range(len(ms) - 1)]
                    bases.append(stag_hmc.HisqFermion(
                        lat, ms[-1], bc=self.bc, params=sp, force_params=fp))
                for j, base in enumerate(bases):
                    self._add_matter_term(terms, base,
                                          f"{spec.kind}{i}_h{j}", spec)
                continue
            if spec.kind == "fermion":
                base = stag_hmc.StagFermion(lat, spec.mass, self.bc, sp,
                                            force_params=fp)
            elif spec.kind == "boson":
                base = stag_hmc.StagBoson(lat, spec.mass, self.bc, sp)
            elif spec.kind == "rooted":
                base = stag_hmc.StagRootedFermion(
                    lat, spec.mass, nf=spec.nf, bc=self.bc,
                    degree=spec.degree, params=sp, force_params=fp)
            elif spec.kind == "hisq":
                base = stag_hmc.HisqFermion(lat, spec.mass, bc=self.bc,
                                            params=sp, force_params=fp)
            else:
                raise ValueError(f"unknown matter kind {spec.kind!r}")
            self._add_matter_term(terms, base,
                                  f"{spec.kind}{i}_m{spec.mass}", spec)
        return terms

    def _add_matter_term(self, terms: list[ActionTerm], base, name: str,
                         spec: FermionSpec) -> None:
        smeared = spec.smeared and self.smear_coefs is not None
        self.matter_bases.append((name, base, smeared))
        s_act = base.make_action_fn()

        def f_action(u, phi, s_act=s_act, smeared=smeared):
            return s_act(self._smear(u) if smeared else u, phi)

        def f_force(u, phi, f_action=f_action):
            return force_from_action(lambda uu: f_action(uu, phi), u)

        def f_chain(v, phi, s_act=s_act):
            return _grad_at(lambda vv: s_act(vv, phi), v)

        def f_heat(xi, u, base=base, smeared=smeared):
            return base.heatbath_from_noise(
                xi, self._smear(u) if smeared else u)

        terms.append(ActionTerm(name, f_action, f_force, spec.steps,
                                spec.scheme, heatbath=f_heat,
                                smeared=smeared,
                                chain_force=f_chain if smeared else None,
                                fg_form="hvp"))
        self._at_links.append((s_act, base.heatbath_from_noise))

    def _links_per_term(self, u: torch.Tensor) -> list[torch.Tensor]:
        """Each term's links: smear(u) (computed once) or u."""
        v = self._smear(u) if self._any_smeared() else u
        return [v if t.smeared else u for t in self.terms]

    # -- HMC ---------------------------------------------------------------
    @_on_mesh
    def draw_momenta(self, gen: torch.Generator, u: torch.Tensor
                     ) -> torch.Tensor:
        return hmc_mod.draw_momenta(gen, u)

    @_on_mesh
    def draw_noise(self, gen: torch.Generator, u: torch.Tensor
                   ) -> list[torch.Tensor | None]:
        """One Gaussian noise field per matter term (None for gauge)."""
        return [stag_hmc.gaussian_eta(gen, self.lat, u.dtype)
                if term.heatbath else None for term in self.terms]

    @_on_mesh
    def heatbath_from_noise(self, xis: Sequence[torch.Tensor | None],
                            u: torch.Tensor) -> list[Any]:
        """Pseudofermion fields from the terms' noise fields (one smear
        of u for all smeared terms)."""
        with torch.no_grad():
            links = self._links_per_term(u)
            return [heat(xi, w) if heat is not None else None
                    for (_act, heat), w, xi in zip(self._at_links, links,
                                                   xis)]

    @_on_mesh
    def heatbath(self, gen: torch.Generator, u: torch.Tensor) -> list[Any]:
        """Refresh all pseudofermion fields."""
        return self.heatbath_from_noise(self.draw_noise(gen, u), u)

    @_on_mesh
    def hamiltonian(self, u: torch.Tensor, p: torch.Tensor,
                    phis: Sequence[Any]) -> torch.Tensor:
        """H = K(p) + sum of the terms' actions, a float64 scalar (one
        smear of u for all smeared terms)."""
        with torch.no_grad():
            h = hmc_mod.kinetic_energy(p)
            links = self._links_per_term(u)
            for (act, _heat), w, phi in zip(self._at_links, links, phis):
                h = h + act(w, phi).to(torch.float64)
        return h

    @_on_mesh
    def trajectory(self, u: torch.Tensor, p: torch.Tensor,
                   phis: Sequence[Any]) -> tuple[torch.Tensor, torch.Tensor]:
        """MD trajectory of length tau from (u, p): returns (u1, p1)."""
        return run_trajectory(self.terms, u, p, phis, self.tau,
                              hmc_mod.gauge_update_u,
                              transform=(self._smear if self._any_smeared()
                                         else None))

    metropolis = staticmethod(hmc_mod.metropolis)

    @_on_mesh
    def hmc_step(self, gen: torch.Generator, u: torch.Tensor,
                 always_accept: bool = False
                 ) -> tuple[torch.Tensor, hmc_mod.HMCState]:
        """One trajectory: momenta + pseudofermion heatbath, MD,
        Metropolis.  ``gen`` lives on u's device."""
        p = self.draw_momenta(gen, u)
        phis = self.heatbath(gen, u)
        h_old = float(self.hamiltonian(u, p, phis))
        u1, p1 = self.trajectory(u, p, phis)
        h_new = float(self.hamiltonian(u1, p1, phis))
        dH = h_new - h_old
        r = hmc_mod.draw_uniform(gen)
        acc = bool(always_accept) or self.metropolis(dH, r)
        return (u1 if acc else u), hmc_mod.HMCState(
            accepted=acc, dH=dH, h_old=h_old, h_new=h_new)

    @_on_mesh
    def reverse_check(self, gen: torch.Generator, u: torch.Tensor) -> dict:
        """Reversibility of the full multi-timescale trajectory: draw as
        ``hmc_step`` does, integrate, flip the momenta, integrate back;
        H at the three points, dH forward and back, and the relative
        squared deviations of the returned fields."""
        p = self.draw_momenta(gen, u)
        phis = self.heatbath(gen, u)
        h0 = float(self.hamiltonian(u, p, phis))
        u1, p1 = self.trajectory(u, p, phis)
        h1 = float(self.hamiltonian(u1, p1, phis))
        u2, p2 = self.trajectory(u1, -p1, phis)
        h2 = float(self.hamiltonian(u2, p2, phis))
        return {"h0": h0, "h1": h1, "h2": h2, "dH_fwd": h1 - h0,
                "dH_rev": h2 - h0,
                "u_dev2": float(_n2(u2 - u) / _n2(u)),
                "p_dev2": float(_n2(p2 + p) / _n2(p))}

    @_on_mesh
    def solver_report(self, gen: torch.Generator, u: torch.Tensor) -> dict:
        """Per matter term with a ``check_solve``: heatbath a phi from
        ``gen``, re-solve at the action tolerance, and report
        {term name: (iterations, true relative residual)}.  The PV boson
        has no check, as in the JAX package."""
        out = {}
        with torch.no_grad():
            v = (self._smear(u) if any(sm for _n, _b, sm in
                                       self.matter_bases) else u)
            for name, base, smeared in self.matter_bases:
                if hasattr(base, "check_solve"):
                    w = v if smeared else u
                    out[name] = base.check_solve(w, base.heatbath(gen, w))
        return out
