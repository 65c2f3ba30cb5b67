"""Z_N clock model Monte Carlo: heatbath and Metropolis (port of
``qex_tpu.models.clock``).

Spins theta(x) = 2 pi k(x) / N for integer k, H = -beta sum_<xy>
cos(theta_x - theta_y).  The heatbath is an exact discrete Gibbs update
of one checkerboard at a time: the N states' logits against the frozen
neighbour field, sampled as argmax(logits + Gumbel noise) (the
categorical draw of the JAX package).  Each update is a core that takes
its draws as tensors (``*_from``) and a wrapper that draws them from a
``torch.Generator``.

The angles, logits and energies are float64 whatever the caller's
integer field: the JAX package forms the angles in float32, and its
tests here hold the port against it with those angles lifted to float64.
"""

from __future__ import annotations

import math

import torch

from .xy import _parity_mask


def angles(n_states: int, device=None) -> torch.Tensor:
    return 2.0 * math.pi * torch.arange(n_states, dtype=torch.float64,
                                        device=device) / n_states


def _theta(k: torch.Tensor, n_states: int) -> torch.Tensor:
    return 2.0 * math.pi * k.to(torch.float64) / n_states


def energy(k: torch.Tensor, beta: float, n_states: int) -> torch.Tensor:
    """H for an integer spin field k (values 0..N-1), float64."""
    th = _theta(k, n_states)
    e = 0.0
    for mu in range(k.dim()):
        e = e + torch.cos(torch.roll(th, -1, mu) - th).sum()
    return -beta * e


def magnetization(k: torch.Tensor, n_states: int) -> torch.Tensor:
    th = _theta(k, n_states)
    return torch.hypot(torch.cos(th).mean(), torch.sin(th).mean())


def _neighbor_field(k: torch.Tensor, n_states: int):
    """(cos_sum, sin_sum) of the neighbour spins per site."""
    th = _theta(k, n_states)
    c = s = 0.0
    for mu in range(k.dim()):
        for sgn in (-1, 1):
            tn = torch.roll(th, sgn, mu)
            c = c + torch.cos(tn)
            s = s + torch.sin(tn)
    return c, s


def heatbath_sweep_from(k: torch.Tensor, beta: float, n_states: int,
                        gumbel: torch.Tensor) -> torch.Tensor:
    """Exact discrete Gibbs sweep (even then odd checkerboard) from
    Gumbel noise ``gumbel`` (2, *shape, N), one field per parity."""
    par = _parity_mask(k.shape, k.device)
    ang = angles(n_states, k.device)
    for p in (0, 1):
        c, s = _neighbor_field(k, n_states)
        logits = beta * (torch.cos(ang) * c[..., None]
                         + torch.sin(ang) * s[..., None])
        new = torch.argmax(gumbel[p] + logits, dim=-1)
        k = torch.where(par == p, new.to(k.dtype), k)
    return k


def draw_heatbath(gen: torch.Generator, k: torch.Tensor, n_states: int
                  ) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform on [tiny, 1)."""
    u = torch.rand((2,) + tuple(k.shape) + (n_states,), generator=gen,
                   dtype=torch.float64, device=gen.device)
    u = torch.clamp(u, min=torch.finfo(torch.float64).tiny)
    return -torch.log(-torch.log(u))


def heatbath_sweep(gen: torch.Generator, k: torch.Tensor, beta: float,
                   n_states: int) -> torch.Tensor:
    return heatbath_sweep_from(k, beta, n_states,
                               draw_heatbath(gen, k, n_states))


def metropolis_sweep_from(k: torch.Tensor, beta: float, n_states: int,
                          prop: torch.Tensor, acc_u: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Checkerboard Metropolis with uniform state proposals ``prop`` (2,
    *shape) and accept uniforms ``acc_u`` (2, *shape).  Returns (k, the
    acceptance rate as a float64 scalar)."""
    par = _parity_mask(k.shape, k.device)
    acc_tot = 0.0
    for p in (0, 1):
        c, s = _neighbor_field(k, n_states)
        th_old, th_new = _theta(k, n_states), _theta(prop[p], n_states)
        de = -beta * ((torch.cos(th_new) - torch.cos(th_old)) * c
                      + (torch.sin(th_new) - torch.sin(th_old)) * s)
        acc = acc_u[p] < torch.exp(-de)
        k = torch.where(acc & (par == p), prop[p].to(k.dtype), k)
        acc_tot = acc_tot + 2.0 * (acc & (par == p)).to(torch.float64).mean()
    return k, acc_tot / 2


def draw_metropolis(gen: torch.Generator, k: torch.Tensor, n_states: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (2,) + tuple(k.shape)
    prop = torch.randint(n_states, shape, generator=gen, device=gen.device,
                         dtype=k.dtype)
    return prop, torch.rand(shape, generator=gen, dtype=torch.float64,
                            device=gen.device)


def metropolis_sweep(gen: torch.Generator, k: torch.Tensor, beta: float,
                     n_states: int) -> tuple[torch.Tensor, torch.Tensor]:
    return metropolis_sweep_from(k, beta, n_states,
                                 *draw_metropolis(gen, k, n_states))
