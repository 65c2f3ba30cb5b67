"""Plain PyTorch reference of one HMC trajectory of the smeared
staggered + Pauli-Villars action (BASELINE config 4: Wilson gauge
action, one staggered fermion and one Pauli-Villars boson on nHYP links,
a multi-timescale integrator): the pseudofermion heatbath from given
noise, H before and after, and the molecular dynamics from given
momenta.

    H = 1/2 |p|^2 + S_g(U) + phi_f^dag A(m_f)^{-1} phi_f + phi_b^dag A(m_b) phi_b
    A(m) = m^2 - D D on even sites, D the staggered hop on V = nHYP(U)
    phi_f = (D(m_f)^dag xi_f)_e,  phi_b = A(m_b)^{-1} (D(m_b)^dag xi_b)_e

Forces come from autograd of the action through the smearing; the
fermion term's gradient is that of -Re<x, A(V) x> at the fixed
solution x = A^{-1} phi.  A kick of coefficient c moves
p <- p + c tah(U g^dag), g the gradient of the action with respect to U
in torch's convention, and a drift of length dt moves U <- exp(dt p) U.
Kicks that fall on the same time act on the same U, so they are summed.
"""

from __future__ import annotations

import math

import torch

from . import lattice as L


def schedule(terms, tau: float):
    """Event list of a multi-timescale trajectory: [(drift, {term:
    coefficient})] with the drifts summing to tau.  ``terms`` are
    (steps, pattern) with pattern a tuple of ("V", c) / ("T", c) steps
    whose T coefficients sum to one."""
    events = {}
    for ti, (steps, pattern) in enumerate(terms):
        dt = tau / steps
        t = 0.0
        for _ in range(steps):
            for kind, c in pattern:
                if kind == "T":
                    t += c * dt
                elif c != 0.0:
                    key = round(t / tau * 1e9)
                    slot = events.setdefault(key, {})
                    slot[ti] = slot.get(ti, 0.0) + c * dt
    out, t_cur = [], 0.0
    for key in sorted(events):
        t = key * tau / 1e9
        out.append((t - t_cur, events[key]))
        t_cur = t
    if tau - t_cur > 1e-9:
        out.append((tau - t_cur, {}))
    return out


def two_mn(lam: float):
    """Omelyan's second-order minimum-norm step."""
    return (("V", lam), ("T", 0.5), ("V", 1.0 - 2.0 * lam), ("T", 0.5),
            ("V", lam))


class Config4:
    """The action of a configuration file's "action" block."""

    def __init__(self, action: dict, pr: L.Precision):
        self.pr = pr
        self.beta = action["gauge"]["beta"]
        self.alphas = tuple(action["smear"]["alphas"])
        self.bc = action["bc"]
        self.tau = action["tau"]
        self.m_f = action["fermion"]["mass"]
        self.m_b = action["boson"]["mass"]
        self.lam = action["integrator"]["lambda"]
        self.steps = (action["gauge"]["steps"], action["fermion"]["steps"],
                      action["boson"]["steps"])
        ref = action["reference"]
        self.r2_action, self.r2_force = ref["r2_action"], ref["r2_force"]
        self.maxits = ref["maxits"]

    def links(self, u):
        """Phased nHYP links of u."""
        return L.phased(L.nhyp(u, self.alphas, self.pr), self.bc, self.pr)

    def solve(self, v, b, m, r2):
        return L.cg(lambda x: L.normal_op(v, x, m * m, self.pr), b, r2,
                    self.maxits, self.pr)[0]

    def heatbath(self, u, xi_f, xi_b, even):
        pr = self.pr
        with torch.no_grad():
            v = self.links(u)
            phi_f = pr.q((self.m_f * xi_f - L.dslash(v, xi_f, pr)) * even)
            rhs = pr.q((self.m_b * xi_b - L.dslash(v, xi_b, pr)) * even)
            phi_b = self.solve(v, rhs, self.m_b, self.r2_action)
        return phi_f, phi_b

    def hamiltonian_terms(self, u, p, phis, acc=torch.float64,
                          r2=None) -> dict:
        """The terms of H, each accumulated in ``acc``; the fermion's
        solve to ``r2`` (default: the action tolerance)."""
        pr = self.pr
        phi_f, phi_b = phis
        with torch.no_grad():
            v = self.links(u)
            x = self.solve(v, phi_f, self.m_f,
                           self.r2_action if r2 is None else r2)
            return {"kinetic": 0.5 * L.norm2(p, acc),
                    "gauge": L.wilson_action(u, self.beta, pr, acc),
                    "fermion": L.redot(phi_f, x, acc),
                    "boson": L.redot(phi_b, L.normal_op(
                        v, phi_b, self.m_b ** 2, pr), acc)}

    def hamiltonian(self, u, p, phis) -> float:
        return float(sum(self.hamiltonian_terms(u, p, phis).values()))

    def kick(self, u, p, coefs: dict, phis):
        """p + sum_i c_i tah(U g_i^dag) for the terms of this time
        (0 gauge, 1 fermion, 2 boson)."""
        pr = self.pr
        phi_f, phi_b = phis
        with torch.enable_grad():
            uu = u.detach().requires_grad_(True)
            loss = torch.zeros((), dtype=torch.float64, device=u.device)
            if 0 in coefs:
                loss = loss + coefs[0] * L.wilson_action(uu, self.beta, pr)
            if 1 in coefs or 2 in coefs:
                v = self.links(uu)
                if 1 in coefs:
                    x = self.solve(v.detach(), phi_f, self.m_f,
                                   self.r2_force)
                    loss = loss - coefs[1] * L.redot(
                        x, L.normal_op(v, x, self.m_f ** 2, pr))
                if 2 in coefs:
                    loss = loss + coefs[2] * L.redot(
                        phi_b, L.normal_op(v, phi_b, self.m_b ** 2, pr))
            (g,) = torch.autograd.grad(loss, uu)
        return pr.q(p + torch.stack([L.tah(L.mul_na(u[mu], g[mu], pr))
                                     for mu in range(4)]))

    def trajectory(self, u, p, xi_f, xi_b) -> dict:
        """H before and after, dH, the proposed links and momenta and
        the pseudofermions of one trajectory from links u, momenta p and
        noise xi_f, xi_b."""
        pr = self.pr
        u, p = pr.cast(u), pr.cast(p)
        xi_f, xi_b = pr.cast(xi_f), pr.cast(xi_b)
        even = L.even_mask(u.shape[3:], u.device)
        phis = self.heatbath(u, xi_f, xi_b, even)
        h_old = self.hamiltonian(u, p, phis)
        pattern = two_mn(self.lam)
        for drift, coefs in schedule([(s, pattern) for s in self.steps],
                                     self.tau):
            if drift > 1e-9:
                with torch.no_grad():
                    u = torch.stack([L.expm_mul(drift * p[mu], u[mu], pr)
                                     for mu in range(4)])
            if coefs:
                p = self.kick(u, p, coefs, phis)
        h_new = self.hamiltonian(u, p, phis)
        return {"h_old": h_old, "h_new": h_new, "dH": h_new - h_old,
                "u": u.detach(), "p": p, "phis": phis}


def metropolis(dH: float, r: float) -> bool:
    """Accept with probability min(1, exp(-dH)) for a uniform r in
    [0, 1); a NaN dH rejects."""
    return dH <= 0.0 or r < math.exp(-dH)
