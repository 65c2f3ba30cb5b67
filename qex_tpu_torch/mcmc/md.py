"""Multi-timescale molecular dynamics (port of ``ActionTerm``,
``build_schedule``, ``_shared_smeared_kick``, ``_apply_schedule`` and
``run_trajectory`` from ``qex_tpu.mcmc.md``).

Every action term has its own step count and integrator.  Each term's
pattern expands over its own step dt_i = tau / steps_i into kick events
at absolute gauge times; all events are merged and sorted, U advances by
exp(dt p) between consecutive event times, and kicks at the same time
apply back to back.  The trajectory is a plain Python loop over that
schedule.

Terms on smeared links V = transform(U) that give a ``chain_force``
share one smear per kick time: one forward of the transform with grad,
the coefficient-weighted sum of their chains dS_i/dV, one backward, one
TAH projection.  A force-gradient kick never joins that shared kick: it
calls ``hmc.integrators.fg_force`` with its term's own force, its exact
derivative taken as the term's ``fg_form`` names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from ..hmc.integrators import Integrator, fg_force, get_integrator
from ..ops import group, linalg


@dataclasses.dataclass(frozen=True)
class ActionTerm:
    """One term of the total action with its own MD timescale.

    action(u, phi) -> real scalar; force(u, phi) -> TAH force field
    (pdot = -force); heatbath(xi, u) -> phi from the term's Gaussian
    noise ``xi`` (None for gauge terms).  A term on smeared links sets
    ``smeared`` and gives ``chain_force(v, phi)``, the torch-convention
    gradient dS/dV at the smeared links.

    ``fg_form`` is how a force-gradient kick takes the derivative of
    the term's force (:func:`..hmc.integrators.fg_force`): "jvp",
    forward mode through ``force`` (plain torch operations), or "hvp",
    a Hessian-vector product of ``action``, through the custom backward
    functions of solves and the SU(3) projection.  Both are the exact
    derivative, which the JAX package takes on every kind of term.
    """

    name: str
    action: Callable[[torch.Tensor, Any], torch.Tensor]
    force: Callable[[torch.Tensor, Any], torch.Tensor]
    steps: int
    scheme: Integrator | str = "2MN"
    heatbath: Callable[[torch.Tensor, torch.Tensor], Any] | None = None
    smeared: bool = False
    chain_force: Callable[[torch.Tensor, Any], torch.Tensor] | None = None
    fg_form: str = "jvp"

    def get_scheme(self) -> Integrator:
        s = self.scheme
        return get_integrator(s) if isinstance(s, str) else s


_EPS = 1e-9


def build_schedule(terms: Sequence[ActionTerm], tau: float):
    """Flatten all terms' integrator patterns into one sorted event list.

    Returns [(dt_advance, [(term_idx, coeff_dt, fg_a), ...]), ...]:
    advance U by dt, then apply the kicks.  ``fg_a`` (nonzero only for
    force-gradient kicks) is the force-shift magnitude a = 2 xi dt^2/c.
    Sum of advances == tau.
    """
    events: list[tuple[float, int, float, float]] = []
    for i, term in enumerate(terms):
        dt = tau / term.steps
        scheme = term.get_scheme()
        t = 0.0
        for _rep in range(term.steps):
            for st in scheme.steps:
                if st[0] == "T":
                    t += st[1] * dt
                elif st[0] == "V":
                    if st[1] != 0.0:
                        events.append((t, i, st[1] * dt, 0.0))
                elif st[0] == "FG":
                    c, xi = st[1], st[2]
                    if c != 0.0:
                        events.append((t, i, c * dt,
                                       2.0 * xi * dt * dt / c))
                else:  # pragma: no cover
                    raise ValueError(f"bad step kind {st[0]}")
        if abs(t - tau) > 1e-6 * max(1.0, abs(tau)):
            raise ValueError(
                f"term {term.name}: T coefficients sum to {t/dt} per step")
    events.sort(key=lambda e: e[0])

    schedule = []
    t_cur = 0.0
    k = 0
    while k < len(events):
        t_ev = events[k][0]
        group = []
        while k < len(events) and events[k][0] <= t_ev + _EPS:
            _, i, cdt, fg_a = events[k]
            # coalesce same-term kicks at the same time
            for j, (gi, gc, gx) in enumerate(group):
                if gi == i and gx == 0.0 and fg_a == 0.0:
                    group[j] = (gi, gc + cdt, 0.0)
                    break
            else:
                group.append((i, cdt, fg_a))
            k += 1
        schedule.append((t_ev - t_cur, group))
        t_cur = t_ev
    if tau - t_cur > _EPS:
        schedule.append((tau - t_cur, []))
    return schedule


def _pullback(v: torch.Tensor, u: torch.Tensor, chain: torch.Tensor
              ) -> torch.Tensor:
    """dS/dU from dS/dV = ``chain`` through the recorded v = transform(u)
    (torch convention): the smear's backward."""
    (g,) = torch.autograd.grad(v, u, grad_outputs=chain)
    return g


def _shared_smeared_kick(transform, terms, kicks, u, p, phis):
    """p += projTAH(U G^dag) with G the pullback through ``transform`` of
    sum_i cdt_i dS_i/dV: one smear forward and one backward for all the
    smeared kicks of one time."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        v = transform(uu)
        vd = v.detach()
        chain = None
        for (i, cdt, _x) in kicks:
            c = cdt * terms[i].chain_force(vd, phis[i])
            chain = c if chain is None else chain + c
        gu = _pullback(v, uu, chain)
    return p + torch.stack([group.tah(linalg.mul_na(u[mu], gu[mu]))
                            for mu in range(u.shape[0])])


def _apply_schedule(schedule, terms, u, p, phis, update_u, transform=None):
    for dt, kicks in schedule:
        if dt > _EPS:
            u = update_u(u, p, dt)
        shared = [k for k in kicks
                  if transform is not None and terms[k[0]].smeared
                  and terms[k[0]].chain_force is not None and k[2] == 0.0]
        if shared:
            p = _shared_smeared_kick(transform, terms, shared, u, p, phis)
        for (i, cdt, fg_a) in kicks:
            if (i, cdt, fg_a) in shared:
                continue
            term, phi = terms[i], phis[i]
            if fg_a == 0.0:
                p = p - cdt * term.force(u, phi)
                continue
            p = p - cdt * fg_force(
                u, fg_a, lambda uu, term=term, phi=phi: term.force(uu, phi),
                update_u,
                action_fn=(lambda uu, term=term, phi=phi:
                           term.action(uu, phi))
                if term.fg_form == "hvp" else None)
    return u, p


def run_trajectory(terms: Sequence[ActionTerm], u0: torch.Tensor,
                   p0: torch.Tensor, phis: Sequence[Any], tau: float,
                   update_u: Callable[[torch.Tensor, torch.Tensor, float],
                                      torch.Tensor],
                   transform: Callable[[torch.Tensor], torch.Tensor]
                   | None = None,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrate the composite multi-timescale trajectory; ``transform``
    (the smearing) enables the shared smeared kick."""
    schedule = build_schedule(terms, tau)
    return _apply_schedule(schedule, terms, u0, p0, phis, update_u,
                           transform)
