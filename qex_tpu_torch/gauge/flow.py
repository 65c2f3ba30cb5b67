"""Wilson / gradient flow (port of ``qex_tpu.gauge.flow``; QEX wflow and
the measurement loop of gauge_flow).

The flow generator is Z(U) = -force of the chosen action, so the flow
descends that action.  The standard Wilson flow (Luscher,
arXiv:1006.4518) takes ``wilson_flow_coeffs(nc)`` = plaq 2 nc.

Luscher's RK3 (appendix C of 1006.4518):
    W1 = exp(1/4 Z0) W0
    W2 = exp(8/9 Z1 - 17/36 Z0) W1
    W3 = exp(3/4 Z2 - 8/9 Z1 + 17/36 Z0) W2,   Z_i = eps Z(W_i).

``flow`` is a host loop over the steps.  Its per-step measurements stay
on the device as 0-d tensors and are stacked once at the end, so a
caller reads them to the host once per segment.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..lattice import Lattice
from ..ops import linalg
from . import loops
from .action import GaugeActionCoeffs, gauge_force


def wilson_flow_coeffs(nc: int = 3) -> GaugeActionCoeffs:
    return GaugeActionCoeffs(plaq=2.0 * nc)


def flow_generator(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor
                   ) -> torch.Tensor:
    """Z(U) with dU/dt = Z U descending the action."""
    return -gauge_force(c, lat, u)


def _exp_mul(z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.stack([linalg.expm_mul(z[mu], u[mu])
                        for mu in range(u.shape[0])])


def flow_step(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor,
              eps: float) -> torch.Tensor:
    """One RK3 step of flow time ``eps``."""
    z0 = eps * flow_generator(c, lat, u)
    w1 = _exp_mul(0.25 * z0, u)
    z1 = eps * flow_generator(c, lat, w1)
    w2 = _exp_mul((8.0 / 9.0) * z1 - (17.0 / 36.0) * z0, w1)
    z2 = eps * flow_generator(c, lat, w2)
    return _exp_mul(0.75 * z2 - (8.0 / 9.0) * z1 + (17.0 / 36.0) * z0, w2)


class FlowMeasurement(NamedTuple):
    """Observables after a flow step (float64 tensors, stacked over the
    steps by :func:`flow`)."""

    t: torch.Tensor           # flow time after the step
    t2e_plaq: torch.Tensor    # t^2 E, plaquette discretisation
    t2e_clover: torch.Tensor  # t^2 E, clover discretisation
    topo_q: torch.Tensor      # clover topological charge
    plaq: torch.Tensor        # average plaquette


def measure_flow(lat: Lattice, u: torch.Tensor, t: float
                 ) -> FlowMeasurement:
    ep = loops.energy_density_plaq(lat, u)
    ec = loops.energy_density_clover(lat, u)
    q = (loops.topo_charge_clover(lat, u) if lat.nd == 4
         else torch.zeros((), dtype=torch.float64, device=u.device))
    pl = loops.plaquette(lat, u)
    tt = torch.tensor(t, dtype=torch.float64, device=u.device)
    return FlowMeasurement(t=tt, t2e_plaq=tt * tt * ep,
                           t2e_clover=tt * tt * ec, topo_q=q, plaq=pl)


def flow(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor, eps: float,
         steps: int, measure: bool = True, t0: float = 0.0
         ) -> tuple[torch.Tensor, FlowMeasurement | None]:
    """``steps`` RK3 steps of size ``eps`` from flow time ``t0``,
    measuring after every step when ``measure``; returns the flowed
    field and the stacked measurements (or None)."""
    ms = []
    t = t0
    with torch.no_grad():
        for _ in range(steps):
            u = flow_step(c, lat, u, eps)
            t = t + eps
            if measure:
                ms.append(measure_flow(lat, u, t))
    if not measure:
        return u, None
    return u, FlowMeasurement(*(torch.stack(col) for col in zip(*ms)))


def flow_segments(c: GaugeActionCoeffs, lat: Lattice, u: torch.Tensor,
                  segments: list[tuple[float, float]]
                  ) -> list[FlowMeasurement]:
    """Flow through [(t_max, dt), ...] segments, each to its t_max with
    its own step size, continuing from the previous (the XML deck's
    segments); one stacked measurement per segment."""
    out = []
    t = 0.0
    for t_max, dt in segments:
        n = max(1, round((t_max - t) / dt))
        u, ms = flow(c, lat, u, dt, n, t0=t)
        t = t + n * dt
        out.append(ms)
    return out
