"""Staggered pseudofermion and Pauli-Villars actions for HMC (port of the
plain-fermion part of ``qex_tpu.physics.stag_hmc``, with
``StagFermion.check_solve``).

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
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..lattice import Lattice
from ..ops import eo, linalg
from ..solvers.base import SolverParams
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
