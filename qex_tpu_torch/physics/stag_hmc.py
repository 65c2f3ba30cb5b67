"""Staggered pseudofermion and Pauli-Villars actions for HMC (port of
``qex_tpu.physics.stag_hmc``: ``StagFermion``, ``StagBoson``, the HISQ
pseudofermion ``HisqFermion`` and its operator routing ``_fast3_ops``,
the Hasenbusch ratios ``StagHasenbusch`` and ``HisqHasenbusch``, and the
rooted ``StagRootedFermion``).

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

``StagRootedFermion`` takes A^{-nf/4} and A^{+nf/8} as rational
functions (``solvers.rational``), each from one multishift solve on
kernel B1; its force is -sum_i r_i x_i^dag (dA) x_i.

On a rank mesh's blocks (``parallel.mesh.use_mesh``) every term runs on
this rank's block of the links and of its pseudofermion, its solves on
the block kernels (``stag_shard.solve_route``) and its action values
through float64 all-reduces (``parallel.halo.psum``).  The noise is
drawn whole on every rank from the same seeded generator and then cut
(:func:`gaussian_eta`), so that a run on blocks reproduces a run without
a mesh; the whole draw is transient, about 50 MB of complex64 colour
vector at 32^3x64, and freed before the trajectory records anything.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from ..gauge import fat7
from ..lattice import Lattice
from ..ops import eo, linalg
from ..parallel import mesh
from ..parallel.halo import psum
from ..solvers import cg, cgm
from ..solvers.base import LOCAL, SolverParams, SolverStats
from ..solvers.rational import RationalApprox, rational_approx
from . import stag_fast as sf
from . import stag_hisq as sh
from . import stag_shard, stag_solve, staggered as st


def _rel(r: torch.Tensor, b: torch.Tensor) -> float:
    """|r|^2 / |b|^2 over the whole lattice (all-reduced on blocks)."""
    return float(psum(linalg.norm2(r, torch.float64))
                 / psum(linalg.norm2(b, torch.float64)))


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
    per real component), drawn on ``gen``'s device; under an active mesh
    this rank's block of the whole draw (``parallel.mesh.cut``)."""
    rdtype = dtype.to_real()
    shape = lat.vector_shape()
    xr = torch.randn(shape, generator=gen, dtype=rdtype, device=gen.device)
    xi = torch.randn(shape, generator=gen, dtype=rdtype, device=gen.device)
    return mesh.cut((torch.complex(xr, xi) * 0.7071067811865476).to(dtype))


class _Solved(torch.autograd.Function):
    """x = A(links)^{-1} b from its computed value ``x``, with the
    implicit-function backward (A hermitian): y = A^{-1} g_x,
    g_links = d/dlinks -Re<y, A(links) x> at fixed x and y, g_b = y.
    It records a pseudofermion action's solution for a second
    derivative."""

    @staticmethod
    def forward(ctx, b, x, apply_a, solve, *links):
        ctx.save_for_backward(x, *links)
        ctx.apply_a, ctx.solve = apply_a, solve
        return x.clone()

    @staticmethod
    def backward(ctx, gx):
        x, *links = ctx.saved_tensors
        with torch.no_grad():
            y = ctx.solve(links, gx)
        with torch.enable_grad():
            ll = [v.detach().requires_grad_(True) for v in links]
            q = -linalg.redot(y, ctx.apply_a(ll, x), dtype=torch.float64)
            gl = torch.autograd.grad(q, ll)
        return (y, None, None, None, *gl)


def _recorded_grad(links, phi, x, apply_a, solve):
    """The links' gradient of S = Re<phi, A^{-1} phi>, -d/dlinks
    Re<x, A(links) x>, recorded as a function of the links with the
    solution's own dependence on them: what a Hessian-vector product
    (the exact force-gradient kick) differentiates once more.  Returns
    (gradients, recorded x)."""
    xg = _Solved.apply(phi, x, apply_a, solve, *links)

    def quad(*ll):
        return -linalg.redot(xg, apply_a(ll, xg), dtype=torch.float64)

    grads = torch.func.grad(quad, argnums=tuple(range(len(links))))(*links)
    return grads, xg


class _QuadInv(torch.autograd.Function):
    """S(u, phi) = Re[phi^dag A(u)^{-1} phi] with the implicit-function
    backward (one solve forward, none backward; one more when the
    backward is itself recorded for a second derivative)."""

    @staticmethod
    def forward(ctx, u, phi, lat, bc, m, params):
        s = st.new_stag_eo(lat, u, bc)
        x, _ = stag_solve.solve_ee(s, phi, m, params)
        ctx.save_for_backward(u, phi)
        ctx.x, ctx.lat, ctx.bc, ctx.m, ctx.params = x, lat, bc, m, params
        return psum(linalg.redot(phi, x, dtype=torch.float64))

    @staticmethod
    def backward(ctx, g):
        u, phi = ctx.saved_tensors
        x = ctx.x
        gu = gphi = None
        if torch.is_grad_enabled():
            lat, bc, m, params = ctx.lat, ctx.bc, ctx.m, ctx.params

            def apply_a(links, v):
                return _a_apply(lat, bc, links[0], v, m)

            def solve(links, b):
                return stag_solve.solve_ee(st.new_stag_eo(lat, links[0], bc),
                                           b, m, params)[0]

            (gu,), x = _recorded_grad((u,), phi, x, apply_a, solve)
            gu = g.to(gu.real.dtype) * gu
        elif ctx.needs_input_grad[0]:
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
        return psum(linalg.redot(phi, _a_apply(lat, bc, u, phi, m),
                                 dtype=torch.float64))

    return s_act


def fermion_force(action_fn: Callable, u: torch.Tensor, phi: torch.Tensor
                  ) -> torch.Tensor:
    """TAH MD force of a fermion or boson action term at fixed phi."""
    from ..gauge.action import force_from_action
    return force_from_action(lambda uu: action_fn(uu, phi), u)


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
        return stats.iterations, _rel(r, phi)

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
    canonical-layout d2ee3 with x held fixed (recorded with x's own
    dependence on the links for a second derivative)."""

    @staticmethod
    def forward(ctx, fl, ll, phi, ferm, params):
        x, _ = ferm._solve_links((fl, ll), phi, params, ferm.m)
        ctx.save_for_backward(fl, ll, phi)
        ctx.x, ctx.ferm, ctx.params = x, ferm, params
        return psum(linalg.redot(phi, x, dtype=torch.float64))

    @staticmethod
    def backward(ctx, g):
        fl, ll, phi = ctx.saved_tensors
        x, ferm = ctx.x, ctx.ferm
        gf = gl = gphi = None
        if torch.is_grad_enabled():
            params = ctx.params

            def apply_a(links, v):
                return st.d2ee3(st.new_stag3_eo(ferm.lat, *links), v, ferm.m)

            def solve(links, b):
                return ferm._solve_links(tuple(links), b, params, ferm.m)[0]

            (gf, gl), x = _recorded_grad((fl, ll), phi, x, apply_a, solve)
            gf = g.to(gf.real.dtype) * gf
            gl = g.to(gl.real.dtype) * gl
        elif ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
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
        inner tolerance held at the bf16 noise floor 1e-5); on this
        rank's blocks of ``sp.mesh`` where ``stag_shard.mesh_usable``
        accepts it (``stag_shard.solve_route``)."""
        s3 = st.new_stag3_eo(self.lat, *links)
        if self.lat.nd != 4:
            return cg.cg_solve_restarted(
                partial(st.d2ee3, s3, m=m), b_e, r2req=sp.r2req,
                maxits=sp.maxits, restarts=sp.restarts)
        f3 = sf.new_fast3(s3)

        def whole_ops():
            if sp.sloppy:
                ee, _, ee_b = _fast3_ops_sloppy(f3)
                return partial(ee, m=m), partial(ee_b, m=m)
            return partial(_fast3_ops(f3)[0], m=m), None

        op, op_sloppy, dots = stag_shard.solve_route(
            sp.mesh, f3, sp.sloppy, m, whole_ops)
        op_true, floor = None, 1e-12
        if op_sloppy is not None:
            op, op_true, floor = op_sloppy, op, 1e-5
        xf, stats = cg.cg_solve_restarted(
            op, sf.to_fast(b_e, self.lat), r2req=sp.r2req, maxits=sp.maxits,
            restarts=sp.restarts, op_true=op_true, inner_r2req_floor=floor,
            dots=dots)
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
        return stats.iterations, _rel(r, phi)

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
        links = self._links(u) if links is None else links
        s3 = st.new_stag3_eo(self.lat, *links)
        shifts = [m * m for m in masses]
        kw = dict(r2req=self.params.r2req, maxits=self.params.maxits)
        if self.lat.nd != 4:
            return cgm.cg_multishift(partial(st.d2dd3, s3, parity=0), b_e,
                                     shifts, **kw)
        f3 = sf.new_fast3(s3)
        dd, _, dots = stag_shard.solve_route(
            self.params.mesh, f3, False, None,
            lambda: (_fast3_ops(f3)[1], None))
        xs, stats = cgm.cg_multishift(dd, sf.to_fast(b_e, self.lat), shifts,
                                      dots=dots, **kw)
        return [sf.from_fast(x, self.lat) for x in xs], stats


# --- Hasenbusch ratios -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagHasenbusch:
    """Hasenbusch mass-preconditioned ratio term on even sites,

        S_h = phi^dag phi + (m2^2 - m1^2) phi^dag A(m1)^{-1} phi,

    m1 the light (target) mass, m2 the heavy (preconditioner) mass.  The
    heatbath phi = [D(m2)^{-1} D(m1) xi]_e of a full-lattice Gaussian xi
    has the even-site covariance A(m1) A(m2)^{-1}; the force is
    (m2^2 - m1^2) times the quad-inverse force at m1."""

    lat: Lattice
    m1: float
    m2: float
    bc: str = "pppa"
    params: SolverParams = SolverParams(r2req=1e-12, maxits=2000, restarts=3)
    force_params: SolverParams | None = None

    def heatbath_from_noise(self, xi: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
        s = st.new_stag_eo(self.lat, u, self.bc)
        xi_e, xi_o = eo.pack(xi, self.lat.nd)
        b_e = self.m1 * xi_e + st.dslash_eo(s, xi_o, parity_out=0)
        b_o = self.m1 * xi_o + st.dslash_eo(s, xi_e, parity_out=1)
        return stag_solve.solve_eo(s, b_e, b_o, self.m2, self.params)[0]

    def heatbath(self, gen: torch.Generator, u: torch.Tensor
                 ) -> torch.Tensor:
        return self.heatbath_from_noise(gaussian_eta(gen, self.lat, u.dtype),
                                        u)

    def check_solve(self, u: torch.Tensor, phi: torch.Tensor
                    ) -> tuple[int, float]:
        """The light-mass solve at the action tolerance: (iterations,
        true relative residual with the plain operator)."""
        return StagFermion(self.lat, self.m1, self.bc,
                           self.params).check_solve(u, phi)

    def make_action_fn(self) -> Callable:
        quad = make_quad_inv_action(self.lat, self.bc, self.m1,
                                    self.params, self.force_params)
        return _ratio_action(quad, self.m1, self.m2)

    def action(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        return self.make_action_fn()(u, phi)


def _ratio_action(quad: Callable, m1: float, m2: float) -> Callable:
    """S(u, phi) = |phi|^2 + (m2^2 - m1^2) quad(u, phi)."""
    delta = m2 * m2 - m1 * m1

    def s_act(u, phi):
        return (psum(linalg.redot(phi, phi, dtype=torch.float64))
                + delta * quad(u, phi))

    return s_act


@dataclasses.dataclass(frozen=True)
class HisqHasenbusch:
    """Hasenbusch ratio over the HISQ (fat + naik) operator A3: the
    algebra of :class:`StagHasenbusch` with A replaced by A3 on the
    HISQ links, heatbath phi = [D3(m2)^{-1} D3(m1) xi]_e, solves on
    kernel B2 through :class:`HisqFermion`."""

    lat: Lattice
    m1: float
    m2: float
    bc: str = "pppa"
    proj_iters: int = 14
    params: SolverParams = SolverParams(r2req=1e-12, maxits=2000, restarts=3)
    force_params: SolverParams | None = None

    def _ferm(self, m: float) -> HisqFermion:
        return HisqFermion(self.lat, m, self.bc, self.proj_iters,
                           self.params, self.force_params)

    def heatbath_from_noise(self, xi: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
        f1 = self._ferm(self.m1)
        with torch.no_grad():
            links = f1._links(u)
        s3 = st.new_stag3_eo(self.lat, *links)
        xi_e, xi_o = eo.pack(xi, self.lat.nd)
        b_e = self.m1 * xi_e + st.dslash3_eo(s3, xi_o, parity_out=0)
        b_o = self.m1 * xi_o + st.dslash3_eo(s3, xi_e, parity_out=1)
        # phi_e = [D3(m2)^{-1} b]_e through the even-site normal system
        rhs = self.m2 * b_e - st.dslash3_eo(s3, b_o, parity_out=0)
        return f1.solve_ee(u, rhs, m=self.m2, links=links)[0]

    def heatbath(self, gen: torch.Generator, u: torch.Tensor
                 ) -> torch.Tensor:
        return self.heatbath_from_noise(gaussian_eta(gen, self.lat, u.dtype),
                                        u)

    def check_solve(self, u: torch.Tensor, phi: torch.Tensor
                    ) -> tuple[int, float]:
        return self._ferm(self.m1).check_solve(u, phi)

    def make_action_fn(self) -> Callable:
        return _ratio_action(self._ferm(self.m1).make_action_fn(), self.m1,
                             self.m2)

    def action(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        return self.make_action_fn()(u, phi)


# --- rooted staggered fermion ------------------------------------------------

class _RootedQuad(torch.autograd.Function):
    """S(u, phi) = c0 |phi|^2 + sum_i r_i Re<phi, x_i>, x_i = (A(u) +
    s_i)^{-1} phi from one multishift solve, with the implicit-function
    backward -sum_i r_i Re<x_i, dA x_i>.  Recorded for a second
    derivative, each x_i is a :class:`_Solved` whose tangent takes one
    solve of its own shifted system."""

    @staticmethod
    def forward(ctx, u, phi, ferm, ra, params):
        xs = ferm._multishift(u, phi, ra.poles, params)[0]
        ctx.save_for_backward(u, phi)
        ctx.xs, ctx.ferm, ctx.ra, ctx.params = xs, ferm, ra, params
        s = ra.c0 * linalg.norm2(phi, torch.float64)
        for r, x in zip(ra.residues, xs):
            s = s + r * linalg.redot(phi, x, dtype=torch.float64)
        return psum(s)

    @staticmethod
    def backward(ctx, g):
        u, phi = ctx.saved_tensors
        xs, ferm, ra = ctx.xs, ctx.ferm, ctx.ra
        lat, bc, m = ferm.lat, ferm.bc, ferm.m
        gu = gphi = None

        def quad(uu, xs):
            s = st.new_stag_eo(lat, uu, bc)
            acc = 0.0
            for r, x in zip(ra.residues, xs):
                acc = acc - r * linalg.redot(x, st.d2ee(s, x, m),
                                             dtype=torch.float64)
            return acc

        if torch.is_grad_enabled():
            params = ctx.params

            def apply_a(links, v):      # the shift drops out of d/dlinks
                return _a_apply(lat, bc, links[0], v, m)

            def shifted_solve(shift):
                # one shift of the action's own multishift solve, so the
                # tangent meets r2req as x_i does, with no restart floor
                def solve(links, b):
                    return ferm._multishift(links[0], b, [shift],
                                            params)[0][0]
                return solve

            xs = [_Solved.apply(phi, x, apply_a, shifted_solve(p), u)
                  for x, p in zip(xs, ra.poles)]
            gu = torch.func.grad(quad)(u, xs)
            gu = g.to(gu.real.dtype) * gu
        elif ctx.needs_input_grad[0]:
            with torch.enable_grad():
                uu = u.detach().requires_grad_(True)
                (gu,) = torch.autograd.grad(quad(uu, xs), uu)
            gu = g.to(gu.real.dtype) * gu
        if ctx.needs_input_grad[1]:
            acc = ra.c0 * phi
            for r, x in zip(ra.residues, xs):
                acc = acc + r * x
            gphi = g.to(phi.real.dtype) * (2.0 * acc)
        return gu, gphi, None, None, None


@dataclasses.dataclass(frozen=True)
class StagRootedFermion:
    """Rooted staggered fermion S = phi^dag A(m)^{-nf/4} phi.

    Rational approximations (``solvers.rational``) in partial-fraction
    form, each evaluated by one multishift CG on A(m) = m^2 - D_eo D_oe
    (kernel B1 on the card, the plain fast-layout operator on the
    host): the heatbath phi = A^{+nf/8} xi_e, so Cov(phi) = A^{nf/4};
    the action S = c0 |phi|^2 + sum_i r_i phi^dag (A + s_i)^{-1} phi
    of A^{-nf/4}.  The approximations cover ``spectral_bounds``, a
    measured (lo, hi) bracket of A (:meth:`calibrate_spectral_range`),
    or else the analytic bound [m^2, m^2 + nd^2]."""

    lat: Lattice
    m: float
    nf: int = 1
    bc: str = "pppa"
    degree: int = 10
    params: SolverParams = SolverParams(r2req=1e-12, maxits=2000, restarts=1)
    force_params: SolverParams | None = None
    spectral_bounds: tuple | None = None

    def _spectral_range(self) -> tuple[float, float]:
        if self.spectral_bounds is not None:
            return tuple(self.spectral_bounds)
        # |eig(D_eo D_oe)| <= nd^2 for the staggered hop with its 1/2
        lo = self.m * self.m
        return lo, lo + float(self.lat.nd ** 2)

    def calibrate_spectral_range(self, u: torch.Tensor, safety: float = 1.2
                                 ) -> "StagRootedFermion":
        """A copy whose rational approximations cover the measured
        spectrum of A(m) on ``u`` (a 30-step Lanczos bracket,
        ``eigens.hisqev.spectral_range_stag``, on B1 for links on the
        card): lo = max(m^2 / 2, lo / safety), hi * safety."""
        from ..eigens.hisqev import spectral_range_stag
        lo, hi = spectral_range_stag(self.lat, u, self.m, bc=self.bc)
        mm = self.m * self.m
        lo = max(mm * 0.5, lo / safety)
        return dataclasses.replace(self, spectral_bounds=(lo, hi * safety))

    def _approx(self, num: int, den: int) -> RationalApprox:
        lo, hi = self._spectral_range()
        return rational_approx(num, den, lo, hi, self.degree)

    def _shifted_op(self, u: torch.Tensor, b_e: torch.Tensor) -> tuple:
        """(A(m) on the layout the solves run in, b_e in that layout,
        the map back to even-site vectors, the solves' global sums): the
        fast layout on 4-d lattices (:func:`stag_solve.fast_ops`: kernel
        B1 on the card; on the active mesh's blocks,
        ``stag_shard.solve_route``)."""
        s = st.new_stag_eo(self.lat, u, self.bc)
        mm = self.m * self.m
        if self.lat.nd != 4:
            return (lambda x: st.d2dd(s, x, parity=0) + mm * x), b_e, \
                (lambda x: x), None
        bf = sf.to_fast(b_e, self.lat)
        fs = sf.new_fast(s)
        base, _, dots = stag_shard.solve_route(
            None, fs, False, None, lambda: stag_solve.fast_ops(fs, bf))
        return (lambda x: base(x) + mm * x), bf, \
            partial(sf.from_fast, lat=self.lat), dots

    @torch.no_grad()
    def _multishift(self, u: torch.Tensor, phi: torch.Tensor, shifts,
                    sp: SolverParams) -> tuple[list[torch.Tensor],
                                               SolverStats]:
        """(A + s_i)^{-1} phi for every shift, one multishift CG."""
        op, b, back, dots = self._shifted_op(u, phi)
        xs, stats = cgm.cg_multishift(op, b, list(shifts), r2req=sp.r2req,
                                      maxits=sp.maxits, dots=dots or LOCAL)
        return [back(x) for x in xs], stats

    @torch.no_grad()
    def heatbath_from_noise(self, xi: torch.Tensor, u: torch.Tensor
                            ) -> torch.Tensor:
        """phi = A^{+nf/8} xi_e."""
        xi_e, _ = eo.pack(xi, self.lat.nd)
        op, b, back, dots = self._shifted_op(u, xi_e)
        phi, _ = self._approx(self.nf, 8).apply(
            op, b, r2req=self.params.r2req, maxits=self.params.maxits,
            dots=dots)
        return back(phi)

    def heatbath(self, gen: torch.Generator, u: torch.Tensor
                 ) -> torch.Tensor:
        return self.heatbath_from_noise(gaussian_eta(gen, self.lat, u.dtype),
                                        u)

    def check_solve(self, u: torch.Tensor, phi: torch.Tensor
                    ) -> tuple[int, float]:
        """The action's multishift solve at the action tolerance:
        (iterations, true relative residual of the smallest shift with
        the plain operator)."""
        ra = self._approx(-self.nf, 4)
        xs, stats = self._multishift(u, phi, ra.poles, self.params)
        i0 = min(range(len(ra.poles)), key=lambda i: ra.poles[i])
        with torch.no_grad():
            s = st.new_stag_eo(self.lat, u, self.bc)
            r = st.d2ee(s, xs[i0], self.m) + ra.poles[i0] * xs[i0] - phi
        return stats.iterations, _rel(r, phi)

    def make_action_fn(self) -> Callable:
        """Differentiable S(u, phi); the solve runs at ``force_params``
        while a gradient with respect to u is recorded (MD forces) and
        at ``params`` otherwise (Hamiltonian values)."""
        ra = self._approx(-self.nf, 4)
        fparams = (self.force_params if self.force_params is not None
                   else self.params)

        def s_act(u, phi):
            grad = torch.is_grad_enabled() and u.requires_grad
            return _RootedQuad.apply(u, phi, self, ra,
                                     fparams if grad else self.params)

        return s_act

    def action(self, u: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        return self.make_action_fn()(u, phi)
