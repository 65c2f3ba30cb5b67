"""Symplectic molecular-dynamics integrators (port of
``qex_tpu.hmc.integrators``: a copy of the tables and
``get_integrator``, and ``fg_force``, ``_merge`` and ``integrate``).

An :class:`Integrator` is a palindromic sequence of (kind, *coeffs)
steps for ONE MD unit step:

    ("T", c):      U <- exp(c*dt*p) U            (gauge update)
    ("V", c):      p <- p - c*dt*F(U)            (momentum update)
    ("FG", c, xi): force-gradient momentum update

Coefficient sources are documented on each scheme below.  ``integrate``
runs one force over a trajectory as a host loop; the multi-timescale
trajectory is run by :mod:`qex_tpu_torch.mcmc.md`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

import torch

from ..gauge.action import force_and_derivative
from ..ops import linalg

@dataclasses.dataclass(frozen=True)
class Integrator:
    """A one-MD-step scheme; T coeffs sum to 1, V coeffs sum to 1."""

    name: str
    steps: tuple


def _lf() -> Integrator:
    return Integrator("LF", (("V", 0.5), ("T", 1.0), ("V", 0.5)))


def _2mn(lam: float = 0.1931833275037836) -> Integrator:
    """Omelyan 2nd-order minimum norm (QEX default '2MN,0.19318...')."""
    return Integrator("2MN", (
        ("V", lam), ("T", 0.5), ("V", 1.0 - 2.0 * lam), ("T", 0.5),
        ("V", lam)))


def _4mn5fv(rho: float = 0.2539785108410595,
            mu: float = -0.03230286765269967,
            theta: float = 0.08398315262876693,
            lam: float = 0.6822365335719091) -> Integrator:
    """OMF 4th-order 5-force velocity version.  Defaults match QEX
    '4MN5FV,0.2539...,−0.0323...,0.0839...,0.6822...'."""
    return Integrator("4MN5FV", (
        ("V", theta), ("T", rho), ("V", lam), ("T", mu),
        ("V", 0.5 - lam - theta), ("T", 1.0 - 2.0 * (mu + rho)),
        ("V", 0.5 - lam - theta), ("T", mu), ("V", lam), ("T", rho),
        ("V", theta)))


def _4mn5fp(rho: float = 0.2750081212332419,
            theta: float = -0.1347950099106792,
            vartheta: float = -0.08442961950707149,
            lam: float = 0.3549000571574260) -> Integrator:
    """OMF 4th-order 5-force position version.  Defaults and stage
    structure match QEX '4MN5FP,0.2750...,−0.1347...,−0.0844...,
    0.3549...' (mcmcTypes.nim:346-360: T(rho) V(vartheta) T(theta)
    V(lambda) T(1/2-theta-rho) V(1-2lambda-2vartheta) palindrome).
    Verified genuinely 4th order (|c5| = 5.2e-5) by the exact jet
    Taylor pipeline in tools/derive_mn6_schemes.py; the round-1
    encoding misassigned the stage roles and was only 2nd order."""
    return Integrator("4MN5FP", (
        ("T", rho), ("V", vartheta), ("T", theta), ("V", lam),
        ("T", 0.5 - theta - rho), ("V", 1.0 - 2.0 * (lam + vartheta)),
        ("T", 0.5 - theta - rho), ("V", lam), ("T", theta),
        ("V", vartheta), ("T", rho)))


def _fgi(lam: float = 1.0 / 6.0, xi: float = 1.0 / 72.0) -> Integrator:
    """Chin's 4th-order force-gradient integrator (3 forces, 1 gradient):
    V(1/6) T(1/2) FG(2/3, 1/72) T(1/2) V(1/6)."""
    return Integrator("FGI", (
        ("V", lam), ("T", 0.5), ("FG", 1.0 - 2.0 * lam, xi), ("T", 0.5),
        ("V", lam)))


def _4mn3f1gp(lam: float = 0.2470939580390842) -> Integrator:
    """Omelyan 4th-order 3-force 1-gradient position version (QEX
    '4MN3F1GP,0.2470939580390842'; Omelyan, Mryglod & Folk 2003).

    Structure: T(rho) V(lam) T(1/2-rho) FG(1-2lam, xi) T(1/2-rho)
    V(lam) T(rho) — 3 force evaluations + 1 gradient per step, T
    outermost (position version).  The BCH tau^3 error of this
    palindrome is alpha*[A,[A,B]] + beta*[B,[B,A]] with

        alpha = -1/24 + lam (1-2 rho)^2 / 4
        beta  =  1/12 - lam (1-lam) (1/2 - rho)   (before the FG term)

    (derived by matrix-exponential BCH extraction, residual < 1e-19;
    see tools/derive_fg_schemes.py).  The gradient kick can only
    cancel the [B,[B,A]] part, so 4th order requires

        rho = (1 - 1/sqrt(6 lam)) / 2      (alpha = 0)
        xi  = 1/12 - lam (1-lam) (1/2-rho) (beta = 0; our FG sign
              convention calibrated so Chin FGI's xi = 1/72)

    The single MDevolve parameter is lam; its FUEL-f3g cross-check
    'lambda = 0.2725431326761773 is a0 = 0.109' (stagag.nim:50)
    satisfies lam = 1/(6 (1-2 a0)^2) exactly, confirming the
    structure."""
    rho = 0.5 * (1.0 - 1.0 / (6.0 * lam) ** 0.5)
    xi = 1.0 / 12.0 - lam * (1.0 - lam) * (0.5 - rho)
    return Integrator("4MN3F1GP", (
        ("T", rho), ("V", lam), ("T", 0.5 - rho),
        ("FG", 1.0 - 2.0 * lam, xi), ("T", 0.5 - rho),
        ("V", lam), ("T", rho)))


def _scale_steps(steps, w):
    # FG(c, xi): the gradient term is xi*dt^3 (integrate() applies
    # a = 2 xi dt^2 / c against a c*dt kick), so a w-scaled substep
    # needs xi*w^3 -- w^2 here silently broke FGI6's 6th order
    # (caught by the jet Taylor pipeline, tools/derive_mn6_schemes.py)
    return [(s[0], s[1] * w) if s[0] in ("T", "V")
            else (s[0], s[1] * w, s[2] * w ** 3) for s in steps]


def _merge_adjacent(steps):
    out = []
    for s in steps:
        if out and out[-1][0] == s[0] and s[0] in ("T", "V"):
            out[-1] = (s[0], out[-1][1] + s[1])
        else:
            out.append(tuple(s))
    return tuple(out)


def _compose(base: Integrator, w_outer: float, name: str) -> Integrator:
    """Triple-jump composition S(w t) S((1-2w) t) S(w t) (Yoshida)."""
    seq = (_scale_steps(base.steps, w_outer)
           + _scale_steps(base.steps, 1.0 - 2.0 * w_outer)
           + _scale_steps(base.steps, w_outer))
    return Integrator(name, _merge_adjacent(seq))


def _yoshida4() -> Integrator:
    """Yoshida 4th order: triple-jump of leapfrog with
    w = 1/(2 - 2^(1/3))."""
    w = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
    return _compose(_lf(), w, "YOSHIDA4")


def _yoshida6() -> Integrator:
    """Yoshida 6th order: triple-jump of the 4th-order scheme with
    w = 1/(2 - 2^(1/5))."""
    w = 1.0 / (2.0 - 2.0 ** (1.0 / 5.0))
    return _compose(_yoshida4(), w, "YOSHIDA6")


def _s7odr6() -> Integrator:
    """Yoshida 6th-order 7-stage composition, solution A (Yoshida,
    Phys. Lett. A 150 (1990) 262): S2(w3 h) S2(w2 h) S2(w1 h) S2(w0 h)
    and back, w0 = 1 - 2(w1+w2+w3).  7 T-stages / 8 force evals per
    step -- the classic 's7odr6' velocity scheme."""
    w1 = -1.17767998417887
    w2 = 0.235573213359357
    w3 = 0.784513610477560
    w0 = 1.0 - 2.0 * (w1 + w2 + w3)
    seq = []
    for w in (w3, w2, w1, w0, w1, w2, w3):
        seq += _scale_steps(_lf().steps, w)
    return Integrator("S7ODR6", _merge_adjacent(seq))


def _6mn7fv() -> Integrator:
    """6th order, 7 forces (8 kicks, outer pair merges across steps),
    velocity: V(b1) T(a1) V(b2) T(a2) V(b3) T(a3) V(b4) T(a4)
    palindrome -- the MDevolve '6MN7FV' structure
    (integrator.nim:32-60 accepts the name; the external coefficient
    table is unavailable).  Coefficients are OUR OWN solution of the
    six 6th-order BCH conditions for this structure (quadratic-kinetic
    reduction kills two grade-5 brackets, leaving 2+4 conditions in
    the 6 free parameters): the unique real root found by
    tools/derive_mn6_schemes.py (exact jet-Taylor error extraction,
    120 Newton starts), |e7| = 0.0194, kick mass 1.157.  Genuinely
    6th order -- see tests/test_numutils.py::test_order6_family."""
    b1, b2, b3 = (0.0833333333333339, 0.3977675859548744,
                  -0.0393336931448754)
    a1, a2, a3 = (0.2465881872785576, 0.6047073875058909,
                  -0.4009869039801584)
    b4 = 0.5 - (b1 + b2 + b3)
    a4 = 1.0 - 2.0 * (a1 + a2 + a3)
    return Integrator("6MN7FV", (
        ("V", b1), ("T", a1), ("V", b2), ("T", a2), ("V", b3),
        ("T", a3), ("V", b4), ("T", a4), ("V", b4), ("T", a3),
        ("V", b3), ("T", a2), ("V", b2), ("T", a1), ("V", b1)))


def _6mn5f3gp() -> Integrator:
    """6th order, 5 forces + 3 gradients, position: T(a1) V(b1) T(a2)
    FG(b2,x2) T(a3) FG(b3,x3) palindrome -- the MDevolve '6MN5F3GP'
    structure (integrator.nim:32-60 accepts the name; the external
    coefficient table is unavailable).  Coefficients are OUR OWN
    solution of the six 6th-order BCH conditions
    (tools/derive_mn6_schemes.py + tools/derive_6mn5f3gp_alt.py, exact
    jet-Taylor error extraction): the gradient-on-outer-kicks
    placement has NO real root (300 Newton starts, span 2.0); the
    inner placement has four, of which this is the best (|e7| = 0.43,
    kick mass 1.41).  NOTE the large drift coefficients (a2 = 1.38,
    a3 = -1.13): per-step stability is weaker than 6MN7FV/FGI6 -- this
    scheme exists for structure parity; prefer 6MN7FV for production
    6th-order MD."""
    a1, a2 = 0.2462816126213404, 1.3791958713617729
    b1, b2 = 0.6011720556157608, 0.0023426279821689537
    x2, x3 = 0.0010395019784750540, 0.019882067405128642
    a3 = 0.5 - a1 - a2
    b3 = 1.0 - 2.0 * (b1 + b2)
    return Integrator("6MN5F3GP", (
        ("T", a1), ("V", b1), ("T", a2), ("FG", b2, x2), ("T", a3),
        ("FG", b3, x3), ("T", a3), ("FG", b2, x2), ("T", a2),
        ("V", b1), ("T", a1)))


def _fgi6() -> Integrator:
    """6th-order force-gradient scheme: triple-jump composition of the
    4th-order Chin FGI (symmetric, so the Yoshida w = 1/(2-2^(1/5))
    composition raises the order to 6); 9 forces + 3 gradient kicks."""
    w = 1.0 / (2.0 - 2.0 ** (1.0 / 5.0))
    return _compose(_fgi(), w, "FGI6")


# --- minimum-norm force-gradient family (MDevolve structure names) ---------
#
# The names encode the structure: <order>MN<forces>F<gradients>G +
# V(elocity, kicks outermost-adjacent) / P(osition, T outermost).
# MDevolve's exact parameter tables are not available (external Nim
# package); these coefficients are OUR OWN minimum-norm solutions of
# the BCH order conditions for the named structure: the two tau^3
# conditions are solved exactly and the leftover parameters minimize
# the Euclidean norm of the six tau^5 error coefficients (the Omelyan,
# Mryglod & Folk 2003 criterion).  Derivation + verification:
# tools/derive_fg_schemes.py (--verify re-checks every scheme's alpha,
# beta < 1e-9 against an independent matrix-BCH extraction).  tau^5
# norms: 4MN5F2GP 3.1e-6, 4MN5F2GV 2.1e-5, 4MN5F1GP 4.2e-5,
# 4MN4F2GV 5.2e-5, 4MN5F1GV 7.0e-5 (Chin FGI for scale: 8.2e-4).

def _4mn5f1gv() -> Integrator:
    """4th order, 5 forces + 1 gradient, velocity:
    V(b1) T(a1) V(b2) T(a2) FG(mid, xi) ... palindrome."""
    b1, b2 = 0.0660203679887196, 0.2427151723997158
    a1, xi = 0.1780262651989206, 0.0036409744971369
    a2, mid = 0.5 - a1, 1.0 - 2 * b1 - 2 * b2
    return Integrator("4MN5F1GV", (
        ("V", b1), ("T", a1), ("V", b2), ("T", a2), ("FG", mid, xi),
        ("T", a2), ("V", b2), ("T", a1), ("V", b1)))


def _4mn5f1gp() -> Integrator:
    """4th order, 5 forces + 1 gradient, position:
    T(a1) V(b1) T(a2) V(b2) T(a3) FG(mid, xi) ... palindrome."""
    b1, b2 = 0.1357903417483944, 0.1830682445958390
    a1, a2 = 0.0545339166207803, 0.1619003849858022
    xi = 0.0027471017840335
    a3, mid = 0.5 - a1 - a2, 1.0 - 2 * b1 - 2 * b2
    return Integrator("4MN5F1GP", (
        ("T", a1), ("V", b1), ("T", a2), ("V", b2), ("T", a3),
        ("FG", mid, xi), ("T", a3), ("V", b2), ("T", a2), ("V", b1),
        ("T", a1)))


def _4mn4f2gv() -> Integrator:
    """4th order, 4 forces + 2 gradients, velocity (gradients on the
    inner kick pair): V(b1) T(a1) FG T(mid) FG T(a1) V(b1)."""
    b1, a1, xi = 0.0868623046875, 0.2802464459318679, 0.0030832844148661
    return Integrator("4MN4F2GV", (
        ("V", b1), ("T", a1), ("FG", 0.5 - b1, xi),
        ("T", 1.0 - 2 * a1), ("FG", 0.5 - b1, xi), ("T", a1),
        ("V", b1)))


def _4mn4f2gvg() -> Integrator:
    """4th order, 4 forces + 2 gradients, gradients on the OUTER kicks
    (the 'GVG' kick pattern): FG(b1) T(a1) V T(mid) V T(a1) FG(b1)."""
    b1, a1, xi = 0.0770031731128692, 0.2697979014179325, 0.0033036389054911
    return Integrator("4MN4F2GVG", (
        ("FG", b1, xi), ("T", a1), ("V", 0.5 - b1),
        ("T", 1.0 - 2 * a1), ("V", 0.5 - b1), ("T", a1),
        ("FG", b1, xi)))


def _4mn5f2gv() -> Integrator:
    """4th order, 5 forces + 2 gradients, velocity:
    V(b1) T(a1) FG(b2, xi) T(a2) V(mid) ... palindrome."""
    b1, b2 = 0.0745196046493946, 0.3272117295116190
    a1, xi = 0.2346639132742014, 0.0016888288416746
    a2, mid = 0.5 - a1, 1.0 - 2 * b1 - 2 * b2
    return Integrator("4MN5F2GV", (
        ("V", b1), ("T", a1), ("FG", b2, xi), ("T", a2), ("V", mid),
        ("T", a2), ("FG", b2, xi), ("T", a1), ("V", b1)))


def _4mn5f2gp() -> Integrator:
    """4th order, 5 forces + 2 gradients, position (the scheme family
    of QEX's puregauge2du1.nim:203 default):
    T(a1) V(b1) T(a2) FG(b2, xi) T(a3) V(mid) ... palindrome.
    The best tau^5 norm of the whole derived family (3.1e-6)."""
    b1, b2 = 0.1639932526262120, 0.1989450975161530
    a1, a2 = 0.0702294143078926, 0.1906368848044054
    xi = 0.0009530169558621
    a3, mid = 0.5 - a1 - a2, 1.0 - 2 * b1 - 2 * b2
    return Integrator("4MN5F2GP", (
        ("T", a1), ("V", b1), ("T", a2), ("FG", b2, xi), ("T", a3),
        ("V", mid), ("T", a3), ("FG", b2, xi), ("T", a2), ("V", b1),
        ("T", a1)))


_REGISTRY: dict[str, Callable[..., Integrator]] = {
    "LF": _lf,
    "LEAPFROG": _lf,
    "MD2": _lf,
    "2MN": _2mn,
    "OMELYAN": _2mn,
    "4MN5FV": _4mn5fv,
    "4MN5FP": _4mn5fp,
    "FGI": _fgi,
    "4MN3F1GP": _4mn3f1gp,
    "4MN5F1GV": _4mn5f1gv,
    "4MN5F1GP": _4mn5f1gp,
    "4MN4F2GV": _4mn4f2gv,
    "4MN4F2GVG": _4mn4f2gvg,
    "4MN5F2GV": _4mn5f2gv,
    "4MN5F2GP": _4mn5f2gp,
    "YOSHIDA4": _yoshida4,
    "YOSHIDA6": _yoshida6,
    "S7ODR6": _s7odr6,
    "FGI6": _fgi6,
    "6MN7FV": _6mn7fv,
    "6MN5F3GP": _6mn5f3gp,
}

# No MDevolve-only aliases remain: every name the reference factory
# accepts (integrator.nim:32-60) is implemented with its OWN named
# stage structure; where MDevolve's external coefficient tables are
# unavailable the parameters are self-derived solutions of the exact
# order conditions (tools/derive_fg_schemes.py for the 4th-order
# family, tools/derive_mn6_schemes.py for the 6th).  The alias
# machinery is kept for future names.
_ALIASES: dict[str, tuple[str, Callable[..., Integrator]]] = {}

INTEGRATORS = tuple(_REGISTRY) + tuple(_ALIASES)


def get_integrator(name: str) -> Integrator:
    """String -> integrator, with QEX's comma-parameter syntax:
    e.g. '2MN,0.20' or '4MN5FV,0.25,-0.03,0.08,0.68'
    (integrator.nim factory parity).  Every reference-accepted name is
    a genuine named-structure implementation; any future alias would
    resolve to a same-order substitute WITH a loud warning."""
    parts = str(name).split(",")
    key = parts[0].upper()
    args = [float(x) for x in parts[1:]]
    if key in _ALIASES:
        subst, fn = _ALIASES[key]
        warnings.warn(
            f"integrator {key!r} is an MDevolve scheme whose exact "
            f"coefficient table is not available; substituting {subst}. "
            "Results are a valid same-order symplectic integrator but "
            "NOT coefficient-identical to MDevolve's.",
            stacklevel=2)
        return fn(*args)
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown integrator {name!r}; have "
            f"{sorted(_REGISTRY) + sorted(_ALIASES)}")
    return _REGISTRY[key](*args)


def fg_force(u: torch.Tensor, a: float,
             force_fn: Callable[[torch.Tensor], torch.Tensor],
             update_u: Callable[[torch.Tensor, torch.Tensor, float],
                                torch.Tensor],
             exact: bool = True,
             action_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
             ) -> torch.Tensor:
    """Effective force of a force-gradient kick, p <- p - cdt F_eff with
    F_eff = F(U) - a dF[F U] and a = 2 xi dt^2 / c (the caller computes
    ``a``).

    dF[F U] is the derivative of the force along the force flow,
    d/de F(exp(e F) U) at e = 0 (QEX ``gaugeDerivDeriv2``), the form the
    JAX package takes on every kind of term.  It is ``torch.func.jvp``
    of ``force_fn``, which must then be made of plain torch operations;
    or, where ``action_fn`` is given (its force is ``force_fn``), a
    Hessian-vector product of the action, which also passes the port's
    custom backward functions (solves, the SU(3) projection).
    ``exact=False`` gives the Yin-Mawhinney shifted force
    F(exp(-a F) U) (arXiv:1111.5059) instead, the JAX package's fallback
    where ``jax.jvp`` fails.
    """
    def along_flow(f):
        return torch.stack([linalg.mul(f[mu], u[mu])
                            for mu in range(u.shape[0])])

    if not exact:
        return force_fn(update_u(u, force_fn(u), -a))
    if action_fn is not None:
        f1, df = force_and_derivative(action_fn, u, along_flow)
        return f1 - a * df
    f1 = force_fn(u)
    _, df = torch.func.jvp(force_fn, (u,), (along_flow(f1),))
    return f1 - a * df


def _merge(steps: Sequence) -> tuple[list, list, list]:
    """(head, body, tail) so that ``nsteps`` repeats of ``steps`` equal
    head + body*(nsteps-1) + tail, with the last and first step of
    adjacent repeats merged when both are plain T or plain V."""
    steps = list(steps)
    first, last = steps[0], steps[-1]
    if first[0] == last[0] and first[0] in ("T", "V"):
        merged = (first[0], first[1] + last[1])
        return [first], steps[1:-1] + [merged], steps[1:]
    return [], steps, steps


def integrate(scheme: Integrator, u0: torch.Tensor, p0: torch.Tensor,
              tau: float, nsteps: int,
              force_fn: Callable[[torch.Tensor], torch.Tensor],
              update_u: Callable[[torch.Tensor, torch.Tensor, float],
                                 torch.Tensor],
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrate (u, p) over trajectory length ``tau`` in ``nsteps`` MD
    steps of ``scheme``: ``update_u(u, p, eps)`` is U <- exp(eps p) U
    and ``force_fn(u)`` the force F with pdot = -F; force-gradient kicks
    take the exact derivative of ``force_fn`` (:func:`fg_force`)."""
    dt = tau / nsteps

    def apply_step(u, p, st):
        kind = st[0]
        if kind == "T":
            if st[1] != 0.0:
                u = update_u(u, p, st[1] * dt)
        elif kind == "V":
            if st[1] != 0.0:
                p = p - (st[1] * dt) * force_fn(u)
        elif kind == "FG":
            c, xi = st[1], st[2]
            if c != 0.0:
                f = (fg_force(u, 2.0 * xi * dt * dt / c, force_fn,
                              update_u)
                     if xi != 0.0 else force_fn(u))
                p = p - (c * dt) * f
        else:  # pragma: no cover
            raise ValueError(f"bad step kind {kind}")
        return u, p

    def apply_seq(u, p, seq):
        for st in seq:
            u, p = apply_step(u, p, st)
        return u, p

    if nsteps == 1:
        return apply_seq(u0, p0, scheme.steps)
    head, body, tail = _merge(scheme.steps)
    u, p = apply_seq(u0, p0, head)
    for _ in range(nsteps - 1):
        u, p = apply_seq(u, p, body)
    return apply_seq(u, p, tail)
