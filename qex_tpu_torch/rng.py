"""Resumable random streams and the noise distributions of the
stochastic estimators (port of ``qex_tpu.rng``).

The JAX package folds a draw counter into a threefry key; torch has no
counter-based generator, so a stream here is ``(seed, counter)`` and each
draw takes a ``torch.Generator`` seeded from that pair (:func:`seed_of`
mixes the words through numpy's ``SeedSequence``).  The pair is the whole
state, so a restart from :meth:`LatticeRNG.state` repeats the stream.
The values differ from the JAX package's (threefry cannot be reproduced
in torch); the distributions are the same.

Every sampler takes the generator explicitly and draws on its device
(a CUDA generator draws on the card, a CPU one on the host).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def seed_of(*words: int) -> int:
    """A 63-bit generator seed from a tuple of non-negative integers."""
    state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def seeded_generator(device: torch.device | str, *words: int
                     ) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of words."""
    return torch.Generator(device=device).manual_seed(seed_of(*words))


@dataclasses.dataclass
class LatticeRNG:
    """A resumable stream: each :meth:`next_generator` is seeded from
    ``(seed, counter)`` and bumps the counter."""

    seed: int
    counter: int = 0

    def next_generator(self, device: torch.device | str) -> torch.Generator:
        gen = seeded_generator(device, self.seed, self.counter)
        self.counter += 1
        return gen

    def state(self) -> dict:
        return {"seed": int(self.seed), "counter": int(self.counter)}

    @classmethod
    def from_state(cls, state: dict) -> "LatticeRNG":
        return cls(seed=int(state["seed"]), counter=int(state["counter"]))


def _real(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype


def uniform(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniform on [0, 1)."""
    return torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)


def gaussian(gen: torch.Generator, shape, dtype=torch.float32
             ) -> torch.Tensor:
    """Unit normals."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def gaussian_complex(gen: torch.Generator, shape, dtype=torch.complex64
                     ) -> torch.Tensor:
    """Complex gaussian with unit variance per real component
    (E|z|^2 = 2, as the reference's ``gaussian`` on complex types)."""
    rdt = _real(dtype)
    re = gaussian(gen, shape, rdt)
    return torch.complex(re, gaussian(gen, shape, rdt)).to(dtype)


def _randint(gen: torch.Generator, shape, high: int) -> torch.Tensor:
    return torch.randint(0, high, tuple(shape), generator=gen,
                         device=gen.device)


def z4_noise(gen: torch.Generator, shape, dtype=torch.complex64
             ) -> torch.Tensor:
    """Uniform over {1, i, -1, -i}."""
    vals = torch.tensor([1, 1j, -1, -1j], dtype=dtype, device=gen.device)
    return vals[_randint(gen, shape, 4)]


def z2_noise(gen: torch.Generator, shape, dtype=torch.complex64
             ) -> torch.Tensor:
    """Uniform over {+1, -1}."""
    return (1 - 2 * _randint(gen, shape, 2)).to(dtype)


def u1_noise(gen: torch.Generator, shape, dtype=torch.complex64
             ) -> torch.Tensor:
    """exp(i theta), theta uniform on [0, 2 pi)."""
    th = (2.0 * math.pi) * uniform(gen, shape, _real(dtype))
    return torch.polar(torch.ones_like(th), th).to(dtype)
