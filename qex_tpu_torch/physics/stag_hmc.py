"""Staggered pseudofermion and Pauli-Villars actions for HMC (port of
``qex_tpu.physics.stag_hmc``: ``StagFermion``, ``StagBoson``, the HISQ
pseudofermion ``HisqFermion`` and its operator routing ``_fast3_ops``).

All actions live on even sites through the hermitian positive definite
normal operator ``A(m) = m^2 - D_eo D_oe``:

* fermion: S_f = phi^dag A^{-1} phi, heatbath phi = (D(m)^dag xi)_e;
* Pauli-Villars boson: S_pv = phi^dag A phi, heatbath
  phi = A^{-1} (D^dag xi)_e.

The fermion force uses the implicit-function gradient: with
x = A^{-1} phi, dS/du = -x^dag (dA/du) x.  The forward solve runs the
CUDA kernel on the GPU; the backward differentiates the plain
canonical-layout ``staggered.d2ee`` with x held fixed, so the kernel
needs no backward.  Action values are float64 scalars.

``HisqFermion`` acts through the fat + naik operator on links smeared by
``gauge.fat7.hisq_links``.  Its action records the differentiable
fattening once, solves on its output with kernel B2, and differentiates
the plain ``staggered.d2ee3`` with respect to the fat and long links;
autograd carries that gradient back through the two fat7 levels.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from ..gauge import fat7
from ..lattice import Lattice
from ..ops import eo, linalg
from ..solvers import cg, cgm
from ..solvers.base import SolverParams, SolverStats
from . import stag_fast as sf
from . import stag_hisq as sh
from . import stag_solve, staggered as st


def _a_apply(lat: Lattice, bc: str, u: torch.Tensor, x_e: torch.Tensor,
             m: float) -> torch.Tensor:
    """A(m) x on even sites from unpacked links (differentiable in u)."""
    return st.d2ee(st.new_stag_eo(lat, u, bc), x_e, m)


def _ddag_e(lat: Lattice, bc: str, u: torch.Tensor, xi: torch.Tensor,
            m: float) -> torch.Tensor:
    """(D(m)^dag xi)_e = m xi_e - D_eo xi_o for a full-lattice xi."""
    s = st.new_stag_eo(lat, u, bc)
    xi_e, xi_o = eo.pack(xi, lat.nd)
    return m * xi_e - st.dslash_eo(s, xi_o, parity_out=0)


def gaussian_eta(gen: torch.Generator, lat: Lattice, dtype: torch.dtype
                 ) -> torch.Tensor:
    """Full-lattice complex Gaussian with P ~ exp(-|xi|^2) (variance 1/2
    per real component), drawn on ``gen``'s device."""
    rdtype = dtype.to_real()
    shape = lat.vector_shape()
    xr = torch.randn(shape, generator=gen, dtype=rdtype, device=gen.device)
    xi = torch.randn(shape, generator=gen, dtype=rdtype, device=gen.device)
    return (torch.complex(xr, xi) * 0.7071067811865476).to(dtype)


class _QuadInv(torch.autograd.Function):
    """S(u, phi) = Re[phi^dag A(u)^{-1} phi] with the implicit-function
    backward (one solve forward, none backward)."""

    @staticmethod
    def forward(ctx, u, phi, lat, bc, m, params):
        s = st.new_stag_eo(lat, u, bc)
        x, _ = stag_solve.solve_ee(s, phi, m, params)
        ctx.save_for_backward(u)
        ctx.x, ctx.lat, ctx.bc, ctx.m = x, lat, bc, m
        return linalg.redot(phi, x, dtype=torch.float64)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        x = ctx.x
        gu = gphi = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                uu = u.detach().requires_grad_(True)
                quad = -linalg.redot(
                    x, _a_apply(ctx.lat, ctx.bc, uu, x, ctx.m),
                    dtype=torch.float64)
                (gu,) = torch.autograd.grad(quad, uu)
            gu = g.to(gu.real.dtype) * gu
        if ctx.needs_input_grad[1]:
            gphi = g.to(x.real.dtype) * (2.0 * x)
        return gu, gphi, None, None, None, None


def make_quad_inv_action(lat: Lattice, bc: str, m: float,
                         params: SolverParams,
                         force_params: SolverParams | None = None
                         ) -> Callable:
    """Differentiable S(u, phi) = Re[phi^dag A(u,m)^{-1} phi].

    The solve runs at ``force_params`` when a gradient with respect to
    u is being recorded (MD forces) and at ``params`` otherwise
    (Hamiltonian values), as the JAX custom_vjp's fwd/primal split.
    """
    fparams = force_params if force_params is not None else params

    def s_act(u, phi):
        grad = torch.is_grad_enabled() and u.requires_grad
        return _QuadInv.apply(u, phi, lat, bc, m,
                              fparams if grad else params)

    return s_act


def make_quad_action(lat: Lattice, bc: str, m: float) -> Callable:
    """Differentiable S(u, phi) = Re[phi^dag A(u,m) phi] (PV boson)."""

    def s_act(u, phi):
        return linalg.redot(phi, _a_apply(lat, bc, u, phi, m),
                            dtype=torch.float64)

    return s_act


@dataclasses.dataclass(frozen=True)
class StagFermion:
    """Staggered pseudofermion term S = phi^dag A(m)^{-1} phi."""

    lat: Lattice
    m: float
    bc: str = "pppa"
    params: SolverParams = SolverParams(r2req=1e-12, maxits=2000, restarts=3)
    force_params: SolverParams | None = None

    def heatbath_from_noise(self, xi: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
        return _ddag_e(self.lat, self.bc, u, xi, self.m)

    def heatbath(self, gen: torch.Generator, u: torch.Tensor
                 ) -> torch.Tensor:
        return self.heatbath_from_noise(gaussian_eta(gen, self.lat, u.dtype),
                                        u)

    def check_solve(self, u: torch.Tensor, phi: torch.Tensor
                    ) -> tuple[int, float]:
        """Re-solve at the action tolerance: (iterations, true relative
        residual |A x - phi|^2 / |phi|^2 with the plain operator)."""
        s = st.new_stag_eo(self.lat, u, self.bc)
        x, stats = stag_solve.solve_ee(s, phi, self.m, self.params)
        r = st.d2ee(s, x, self.m) - phi
        return stats.iterations, float(linalg.norm2(r) / linalg.norm2(phi))

    def make_action_fn(self) -> Callable:
        return make_quad_inv_action(self.lat, self.bc, self.m,
                                    self.params, self.force_params)

    def action(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        return self.make_action_fn()(u, phi)


@dataclasses.dataclass(frozen=True)
class StagBoson:
    """Pauli-Villars boson term S = phi^dag A(m_pv) phi."""

    lat: Lattice
    m: float
    bc: str = "pppa"
    params: SolverParams = SolverParams(r2req=1e-12, maxits=2000, restarts=3)

    def heatbath_from_noise(self, xi: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
        rhs = _ddag_e(self.lat, self.bc, u, xi, self.m)
        s = st.new_stag_eo(self.lat, u, self.bc)
        phi, _ = stag_solve.solve_ee(s, rhs, self.m, self.params)
        return phi

    def heatbath(self, gen: torch.Generator, u: torch.Tensor
                 ) -> torch.Tensor:
        return self.heatbath_from_noise(gaussian_eta(gen, self.lat, u.dtype),
                                        u)

    def make_action_fn(self) -> Callable:
        return make_quad_action(self.lat, self.bc, self.m)

    def action(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        return self.make_action_fn()(u, phi)


# --- HISQ (fat7 + naik) ------------------------------------------------------

def _fast3_ops(f3: sf.FastStag3EO) -> tuple[Callable, Callable]:
    """``(d2ee3(v, m), d2dd3(v))`` on fast-layout vectors: the 16-term
    CUDA kernel (B2) for links on the card, the plain fast-layout
    operator for links on the CPU."""
    if f3.gf_e.is_cuda:
        p16 = sh.new_hisq16(f3)
        return (partial(sh.d2ee_hisq16, p16),
                partial(sh.d2dd_hisq16, p16, parity=0))
    return partial(sf.d2ee3_fast, f3), partial(sf.d2dd3_fast, f3, parity=0)


def _fast3_ops_sloppy(f3: sf.FastStag3EO
                      ) -> tuple[Callable, Callable, Callable]:
    """As :func:`_fast3_ops` plus ``d2ee3_sloppy(v, m)``, the operator on
    bf16-rounded links for the inner iterations of a sloppy CG: kernel
    B2b on the card, its plain twin on the CPU."""
    ee, dd = _fast3_ops(f3)
    p16b = sh.new_hisq16(f3, links_dtype=torch.bfloat16)
    return ee, dd, partial(sh.d2ee_hisq16, p16b)


class _HisqQuadInv(torch.autograd.Function):
    """S(fat, long, phi) = Re[phi^dag A3(fat, long)^{-1} phi]: one solve
    forward; backward -x^dag (dA3) x by autograd of the plain
    canonical-layout d2ee3 with x held fixed."""

    @staticmethod
    def forward(ctx, fl, ll, phi, ferm, params):
        x, _ = ferm._solve_links((fl, ll), phi, params, ferm.m)
        ctx.save_for_backward(fl, ll)
        ctx.x, ctx.ferm = x, ferm
        return linalg.redot(phi, x, dtype=torch.float64)

    @staticmethod
    def backward(ctx, g):
        fl, ll = ctx.saved_tensors
        x, ferm = ctx.x, ctx.ferm
        gf = gl = gphi = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            with torch.enable_grad():
                f = fl.detach().requires_grad_(True)
                lg = ll.detach().requires_grad_(True)
                s3 = st.new_stag3_eo(ferm.lat, f, lg)
                quad = -linalg.redot(x, st.d2ee3(s3, x, ferm.m),
                                     dtype=torch.float64)
                gf, gl = torch.autograd.grad(quad, (f, lg))
            gf = g.to(gf.real.dtype) * gf
            gl = g.to(gl.real.dtype) * gl
        if ctx.needs_input_grad[2]:
            gphi = g.to(x.real.dtype) * (2.0 * x)
        return gf, gl, gphi, None, None


@dataclasses.dataclass(frozen=True)
class HisqFermion:
    """HISQ pseudofermion S = phi^dag A3(m)^{-1} phi, with the fat + naik
    normal operator A3 = m^2 - D3_eo D3_oe on ``fat7.hisq_links`` of the
    phased links (phases and boundary signs folded in before fattening).
    """

    lat: Lattice
    m: float
    bc: str = "pppa"
    proj_iters: int = 14
    params: SolverParams = SolverParams(r2req=1e-12, maxits=2000, restarts=3)
    force_params: SolverParams | None = None

    def _links(self, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(fat, long) links of u: the differentiable two-level smear
        while a gradient with respect to u is recorded, else its
        forward-only twin."""
        g = st.phase_links(self.lat, u, self.bc)
        if torch.is_grad_enabled() and u.requires_grad:
            return fat7.hisq_links(self.lat, g, proj_iters=self.proj_iters)
        return fat7.hisq_links_lowmem(self.lat, g,
                                      proj_iters=self.proj_iters)

    def heatbath_from_noise(self, xi: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
        """phi = (D3(m)^dag xi)_e = m xi_e - D3_eo xi_o, so Cov = A3."""
        s3 = st.new_stag3_eo(self.lat, *self._links(u))
        xi_e, xi_o = eo.pack(xi, self.lat.nd)
        return self.m * xi_e - st.dslash3_eo(s3, xi_o, parity_out=0)

    def heatbath(self, gen: torch.Generator, u: torch.Tensor
                 ) -> torch.Tensor:
        return self.heatbath_from_noise(gaussian_eta(gen, self.lat, u.dtype),
                                        u)

    @torch.no_grad()
    def _solve_links(self, links, b_e: torch.Tensor, sp: SolverParams,
                     m: float) -> tuple[torch.Tensor, SolverStats]:
        """A3(m)^{-1} b_e on (fat, long) links: restarted CG in the fast
        layout through :func:`_fast3_ops` (or, with ``sp.sloppy``, bf16
        inner iterations with float32 true-residual restarts and the
        inner tolerance held at the bf16 noise floor 1e-5)."""
        sp.check_supported()
        s3 = st.new_stag3_eo(self.lat, *links)
        if self.lat.nd != 4:
            return cg.cg_solve_restarted(
                partial(st.d2ee3, s3, m=m), b_e, r2req=sp.r2req,
                maxits=sp.maxits, restarts=sp.restarts)
        f3 = sf.new_fast3(s3)
        op_true, floor = None, 1e-12
        if sp.sloppy:
            ee, _, ee_b = _fast3_ops_sloppy(f3)
            op, op_true, floor = partial(ee_b, m=m), partial(ee, m=m), 1e-5
        else:
            ee, _ = _fast3_ops(f3)
            op = partial(ee, m=m)
        xf, stats = cg.cg_solve_restarted(
            op, sf.to_fast(b_e, self.lat), r2req=sp.r2req,
            maxits=sp.maxits, restarts=sp.restarts, op_true=op_true,
            inner_r2req_floor=floor)
        return sf.from_fast(xf, self.lat), stats

    def solve_ee(self, u: torch.Tensor, b_e: torch.Tensor,
                 sp: SolverParams | None = None, m: float | None = None,
                 links=None) -> tuple[torch.Tensor, SolverStats]:
        """x_e = A3(m)^{-1} b_e (default: the term's mass and params);
        ``links`` are precomputed (fat, long) links of u."""
        with torch.no_grad():
            links = self._links(u) if links is None else links
        return self._solve_links(links, b_e,
                                 self.params if sp is None else sp,
                                 self.m if m is None else m)

    def check_solve(self, u: torch.Tensor, phi: torch.Tensor
                    ) -> tuple[int, float]:
        """Re-solve at the action tolerance: (iterations, true relative
        residual with the plain canonical-layout operator)."""
        with torch.no_grad():
            links = self._links(u)
            x, stats = self.solve_ee(u, phi, links=links)
            r = st.d2ee3(st.new_stag3_eo(self.lat, *links), x, self.m) - phi
        return stats.iterations, float(linalg.norm2(r) / linalg.norm2(phi))

    def make_action_fn(self) -> Callable:
        """Differentiable S(u, phi); the solve runs at ``force_params``
        while a gradient with respect to u is recorded (MD forces) and
        at ``params`` otherwise (Hamiltonian values)."""
        fparams = (self.force_params if self.force_params is not None
                   else self.params)

        def s_act(u, phi):
            grad = torch.is_grad_enabled() and u.requires_grad
            fl, ll = self._links(u)
            return _HisqQuadInv.apply(fl, ll, phi, self,
                                      fparams if grad else self.params)

        return s_act

    def action(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        return self.make_action_fn()(u, phi)

    @torch.no_grad()
    def solve_multi(self, u: torch.Tensor, b_e: torch.Tensor, masses,
                    links=None) -> tuple[list[torch.Tensor], SolverStats]:
        """Multi-mass even-site solve (BASELINE config 5): one multishift
        Krylov space over the fat + naik operator, the shifts m^2 on the
        mass-free base ``d2dd3`` (kernel B2 on the card)."""
        self.params.check_supported()
        links = self._links(u) if links is None else links
        s3 = st.new_stag3_eo(self.lat, *links)
        shifts = [m * m for m in masses]
        kw = dict(r2req=self.params.r2req, maxits=self.params.maxits)
        if self.lat.nd != 4:
            return cgm.cg_multishift(partial(st.d2dd3, s3, parity=0), b_e,
                                     shifts, **kw)
        _, dd = _fast3_ops(sf.new_fast3(s3))
        xs, stats = cgm.cg_multishift(dd, sf.to_fast(b_e, self.lat), shifts,
                                      **kw)
        return [sf.from_fast(x, self.lat) for x in xs], stats
