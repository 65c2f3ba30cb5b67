"""The benchmark's inputs, made from ``--seed`` on the device in a few
large calls: gauge links, right-hand sides, HMC momenta and
pseudofermion noise.  Each input has a generator of its own, seeded by
a hash of the run's seed and the input's label, so that an input can be
made again after the window (for the reference) without replaying the
others."""

from __future__ import annotations

import hashlib

import torch

from .reference import lattice as L


def derive(seed: int, *labels) -> int:
    """A 63-bit seed for the input named by ``labels``."""
    digest = hashlib.sha256(repr((int(seed),) + labels).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *labels) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *labels))


def gaussian_tah(gen: torch.Generator, shape) -> torch.Tensor:
    """tah of a complex Ginibre field (unit-variance real components),
    shape (3, 3, *shape), complex64: Gaussian in the algebra, with
    E[1/2 |p|^2] = 4 per matrix."""
    full = (3, 3) + tuple(shape)
    re = torch.randn(full, generator=gen, device=gen.device)
    im = torch.randn(full, generator=gen, device=gen.device)
    return L.tah(torch.complex(re, im))


def random_links(dims, scale: float, gen: torch.Generator) -> torch.Tensor:
    """expm(scale * tah(G)) per link, G Ginibre: links (4, 3, 3, *dims),
    complex64; the plaquette falls from 1 as ``scale`` grows."""
    a = torch.stack([gaussian_tah(gen, dims) for _ in range(4)])
    site_major = torch.movedim(scale * a, (1, 2), (-2, -1)).contiguous()
    return torch.movedim(torch.linalg.matrix_exp(site_major), (-2, -1),
                         (1, 2)).contiguous()


def quenched_start(dims, start: dict, gen: torch.Generator) -> torch.Tensor:
    """A start near equilibrium: ``random_links`` at ``start["scale"]``,
    then ``start["trajectories"]`` forced (no Metropolis) pure-gauge HMC
    trajectories of the Wilson action at ``start["beta"]`` (2MN,
    ``start["steps"]`` steps over ``start["tau"]``): complex64 links,
    the exponential in complex128, the force from the staple sums,
    F_mu = beta/3 tah(U_mu S_mu^dag).  Random links carry
    short-distance noise that the staggered HMC integrates badly
    (dH ~ 100 at 24^4); a few pure-gauge trajectories remove it."""
    from .reference import hmc as ref_hmc
    pr = L.Precision("complex64")
    u = random_links(dims, start["scale"], gen)
    c = start["beta"] / 3.0
    events = ref_hmc.schedule(
        [(start["steps"], ref_hmc.two_mn(start["lambda"]))], start["tau"])
    for _ in range(start["trajectories"]):
        p = momenta(dims, gen)
        for drift, coefs in events:
            if drift > 1e-9:
                u = torch.stack([L.mul(L.expm(
                    (drift * p[mu]).to(torch.complex128), order=10).to(
                        u.dtype), u[mu], pr) for mu in range(4)])
            if coefs:
                p = p - (coefs[0] * c) * torch.stack(
                    [L.tah(L.mul_na(u[mu], L.staple_sum(u, mu, pr), pr))
                     for mu in range(4)])
    return u.contiguous()


def start_links(dims, start: dict, device) -> torch.Tensor:
    """The cell's gauge field: :func:`quenched_start` from the fixed
    ``start["ensemble_seed"]``, the same for every run's seed (a field
    drawn per seed moved the CG iterations by 2%, so the seed would
    change the work); the seed draws the sources and momenta."""
    return quenched_start(dims, start,
                          generator(device, start["ensemble_seed"], "links"))


def momenta(dims, gen: torch.Generator) -> torch.Tensor:
    """HMC momenta (4, 3, 3, *dims), complex64, P ~ exp(-1/2 |p|^2)."""
    return torch.stack([gaussian_tah(gen, dims) for _ in range(4)])


def noise(dims, gen: torch.Generator) -> torch.Tensor:
    """Colour-vector noise (3, *dims), complex64, P ~ exp(-|xi|^2)."""
    shape = (3,) + tuple(dims)
    re = torch.randn(shape, generator=gen, device=gen.device)
    im = torch.randn(shape, generator=gen, device=gen.device)
    return torch.complex(re, im) * 0.7071067811865476


def source(dims, seed: int, index: int, device) -> torch.Tensor:
    """The ``index``-th right-hand side: a complex64 Gaussian on the even
    sites in the program's packed layout (3, X, Y, Z, T/2)."""
    gen = generator(device, seed, "source", index)
    shape = (3,) + tuple(dims[:3]) + (dims[3] // 2,)
    return torch.randn(shape, dtype=torch.complex64, generator=gen,
                       device=device)
