"""Carry fields, operators and theory settings across from the JAX
package.

Arguments are read as plain attributes or numpy arrays, so this module
imports neither jax nor ``qex_tpu``: a ``qex_tpu`` object with the
attributes named below converts as well as any stand-in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from .device import resolve
from .gauge.action import GaugeActionCoeffs
from .gauge.smear import HypCoefs, StoutCoefs
from .lattice import Lattice
from .mcmc.theory import FermionSpec, GaugeActionSpec, LatticeFieldTheory
from .solvers.base import MGParams, SolverParams


def gauge_from_reference(u_np: np.ndarray,
                         device: torch.device | str | None = None,
                         dtype: torch.dtype = torch.complex64
                         ) -> torch.Tensor:
    """A numpy gauge field (nd, nc, nc, X, Y, Z, T) -> a tensor with the
    same layout on ``device`` (default: the CUDA card; raises without
    one)."""
    u_np = np.array(u_np)   # a writable copy: jax arrays are read-only
    if (u_np.ndim < 4 or u_np.shape[0] != u_np.ndim - 3
            or u_np.shape[1] != u_np.shape[2]):
        raise ValueError(f"not a (nd, nc, nc, *dims) gauge field: "
                         f"{u_np.shape}")
    return torch.from_numpy(u_np).to(device=resolve(device), dtype=dtype)


def _solver_params(sp: Any) -> SolverParams | None:
    if sp is None:
        return None
    return SolverParams(r2req=float(sp.r2req), maxits=int(sp.maxits),
                        restarts=int(sp.restarts),
                        sloppy=bool(getattr(sp, "sloppy", False)),
                        mesh=getattr(sp, "mesh", None),
                        backend=str(getattr(sp, "backend", "cg")),
                        mg=_mg_params(getattr(sp, "mg", None)))


def _mg_params(mp: Any) -> MGParams | None:
    if mp is None:
        return None
    return MGParams(**{f.name: type(f.default)(getattr(mp, f.name))
                       for f in dataclasses.fields(MGParams)})


def _smear(sm: Any) -> HypCoefs | StoutCoefs | None:
    """HypCoefs (alpha1..3) or StoutCoefs (rho) by their attributes."""
    if sm is None:
        return None
    if all(hasattr(sm, a) for a in ("alpha1", "alpha2", "alpha3")):
        return HypCoefs(float(sm.alpha1), float(sm.alpha2),
                        float(sm.alpha3))
    if hasattr(sm, "rho"):
        return StoutCoefs(float(sm.rho))
    raise TypeError(f"smear must be nHYP or stout coefficients, not "
                    f"{type(sm).__name__}")


def _gauge_spec(g: Any) -> GaugeActionSpec:
    c = g.coeffs
    return GaugeActionSpec(
        GaugeActionCoeffs(float(c.plaq), float(c.rect), float(c.pgm),
                          float(c.adjplaq)),
        steps=int(g.steps), scheme=str(g.scheme),
        smeared=bool(getattr(g, "smeared", False)))


def _fermion_spec(f: Any) -> FermionSpec:
    return FermionSpec(kind=str(f.kind), mass=float(f.mass),
                       steps=int(f.steps), scheme=str(f.scheme),
                       smeared=bool(getattr(f, "smeared", True)),
                       nf=int(getattr(f, "nf", 1)),
                       degree=int(getattr(f, "degree", 10)),
                       hmasses=tuple(float(h) for h in
                                     getattr(f, "hmasses", ())))


def theory_from_reference(lat: Any, gauge: Any, fermions: Sequence[Any] = (),
                          smear: Any = None, bc: str = "pppa",
                          solver_params: Any = None,
                          force_solver_params: Any = None,
                          tau: float = 1.0) -> LatticeFieldTheory:
    """The port's theory from the JAX ``LatticeFieldTheory`` constructor
    arguments (Lattice, GaugeActionSpec(s), FermionSpecs, smearing
    coefficients, SolverParams)."""
    gauges = gauge if isinstance(gauge, (list, tuple)) else (gauge,)
    sp = _solver_params(solver_params)
    return LatticeFieldTheory(
        Lattice(tuple(lat.dims), nc=int(lat.nc)),
        tuple(_gauge_spec(g) for g in gauges),
        fermions=tuple(_fermion_spec(f) for f in fermions),
        smear=_smear(smear), bc=str(bc),
        solver_params=sp if sp is not None else SolverParams(
            r2req=1e-12, maxits=2000, restarts=3),
        force_solver_params=_solver_params(force_solver_params),
        tau=float(tau))


def _tensor(a: Any, device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def wilson_from_reference(w: Any, device: torch.device | str | None = None,
                          dtype: torch.dtype = torch.complex64):
    """A JAX ``WilsonD`` (attributes lat, g, m), ``WilsonEO`` or
    ``FastWilsonEO`` (lat, g_e, g_o, m; the fast layout has 6-d links)
    -> the port's counterpart, links on ``device`` (default: the CUDA
    card)."""
    from .physics import wilson as wl
    from .physics import wilson_fast as wf
    device = resolve(device)
    lat = Lattice(tuple(w.lat.dims), nc=int(w.lat.nc))
    if hasattr(w, "g"):
        return wl.WilsonD(lat, _tensor(w.g, device, dtype), float(w.m))
    cls = wf.FastWilsonEO if np.ndim(w.g_e) == 6 else wl.WilsonEO
    return cls(lat, _tensor(w.g_e, device, dtype),
               _tensor(w.g_o, device, dtype), float(w.m))


def _plain_tensor(a: Any, device) -> torch.Tensor:
    """A numpy (or jax) float32, float64 or bfloat16 array -> a tensor of
    the same dtype and values (bfloat16 carried bit for bit)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def stag_generation_from_reference(p: Any,
                                   device: torch.device | str | None = None):
    """A JAX ``PallasStagEO`` (lat, g_e, g_o of shape (2, 4, 3, 3, Th, Z,
    YX)), ``PallasStagEO2`` (lat, g_e, g_o of shape (Th, Z, 2, 4, 3, 3,
    YX)) or ``PallasStagEO3`` (lat, l_e, l_o) -> the port's counterpart,
    links of the same dtype (float32, float64 or bfloat16) and values on
    ``device`` (default: the CUDA card)."""
    from .physics import stag_pallas, stag_pallas2, stag_pallas3
    device = resolve(device)
    lat = Lattice(tuple(p.lat.dims), nc=int(p.lat.nc))
    if hasattr(p, "l_e"):
        return stag_pallas3.PallasStagEO3(lat, _plain_tensor(p.l_e, device),
                                          _plain_tensor(p.l_o, device))
    ge, go = _plain_tensor(p.g_e, device), _plain_tensor(p.g_o, device)
    if tuple(ge.shape[:4]) == (2, 4, 3, 3):
        return stag_pallas.PallasStagEO(lat, ge, go)
    if tuple(ge.shape[2:6]) == (2, 4, 3, 3):
        return stag_pallas2.PallasStagEO2(lat, ge, go)
    raise ValueError(f"not a v1, v2 or v3 staggered operator: links of "
                     f"shape {tuple(ge.shape)}")


def mg_hierarchy_from_reference(h: Any,
                                device: torch.device | str | None = None,
                                dtype: torch.dtype = torch.complex64):
    """A JAX ``MGHierarchy`` (setups with lat, bs, w; assembled
    ``CoarseStencil``s with diag, hops, axes, or None; lats) -> the
    port's, on ``device`` (default: the CUDA card)."""
    from .mg.coarse import CoarseStencil
    from .mg.kcycle import MGHierarchy
    from .mg.twogrid import MGSetup
    device = resolve(device)

    def lat_of(lt):
        return Lattice(tuple(lt.dims), nc=int(lt.nc))

    def arr(a):
        return None if a is None else _tensor(a, device, dtype)

    setups = tuple(MGSetup(lat_of(s.lat), int(s.bs), arr(s.w))
                   for s in h.setups)
    stencils = tuple(
        None if c is None else CoarseStencil(
            arr(c.diag), tuple((arr(p), arr(m)) for p, m in c.hops),
            tuple(int(a) for a in c.axes))
        for c in h.stencils)
    return MGHierarchy(setups, stencils, tuple(lat_of(lt) for lt in h.lats))


def field_from_reference(a: Any, device: torch.device | str | None = None,
                         dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy (or jax) real angle field (xy spins, U(1) links) or
    integer clock field -> a tensor of the same shape and values on
    ``device`` (default: the CUDA card), of ``dtype`` if given, else of
    the array's own dtype."""
    x = torch.from_numpy(np.array(a))
    if x.is_complex():
        raise ValueError(f"not a real or integer field: {x.dtype}")
    return x.to(device=resolve(device), dtype=dtype or x.dtype)


def qn_state_from_reference(st: Any, device: torch.device | str | None = None,
                            dtype: torch.dtype = torch.float64):
    """A JAX ``qnhmc.QNState`` (s, y, valid, pos, h0) -> the port's, the
    ring buffer and its write position unchanged, on ``device``
    (default: the CUDA card)."""
    from .hmc.qnhmc import QNState
    device = resolve(device)
    return QNState(_tensor(st.s, device, dtype), _tensor(st.y, device, dtype),
                   _tensor(st.valid, device, torch.bool), int(st.pos),
                   float(st.h0))


def meta_history_from_reference(h: Any):
    """A JAX ``nambu.MetaHistory`` (centers, counts; host arrays) -> the
    port's, slot for slot."""
    from .hmc.nambu import MetaHistory
    out = MetaHistory(len(h.centers))
    out.centers[:] = np.asarray(h.centers)
    out.counts[:] = np.asarray(h.counts)
    return out
