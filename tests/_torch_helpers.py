"""Shared inputs for the qex_tpu_torch parity tests: numpy-seeded fields
handed to both packages, and the comparison measures."""

import numpy as np
import pytest
import torch


def ginibre(rng, shape):
    """Complex Gaussian array with unit-variance real components."""
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def compile_ref(fn, *args):
    """``jax.jit(fn)`` lowered and compiled for ``args`` with XLA's CPU
    backend optimisation off: the reference programs run a few times on
    tiny lattices, where compiling dominates (about 2.5x faster)."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def compile_refs(*jobs):
    """:func:`compile_ref` of each ``(fn, *args)`` job, all at once in
    threads (``args`` may be ``jax.ShapeDtypeStruct``s): XLA compiles
    with the GIL released, so the independent reference programs of one
    fixture compile side by side.  The programs and their results are
    those of one compile_ref each."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        futures = [ex.submit(compile_ref, fn, *args) for fn, *args in jobs]
        return [f.result() for f in futures]


def random_links(rng, lat, scale=0.7):
    """expm(scale * tah(G)) per link from numpy Ginibre noise G, built
    with the JAX reference's own tah/expm (complex128)."""
    import jax

    from qex_tpu.ops import group, linalg
    g = ginibre(rng, (lat.nd, lat.nc, lat.nc) + tuple(lat.dims))
    links = jax.vmap(lambda m: linalg.expm(scale * group.tah(m)))
    return np.asarray(compile_ref(links, g)(g))


def t(a, dtype=None):
    """numpy (or jax) array -> CPU tensor, same values."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def n(x):
    """tensor -> numpy."""
    return x.detach().cpu().resolve_conj().resolve_neg().numpy()


def rel(got, ref):
    """Relative 2-norm deviation |got - ref| / |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def rel2(got, ref):
    """Squared relative deviation, the JAX kernel tests' measure."""
    return rel(got, ref) ** 2


@pytest.fixture(scope="module")
def single_threaded():
    """Native thread pools (numpy's OpenBLAS, torch's intra-op pool) at
    one thread for a test module.  Tier-1 runs six workers on the
    host's cores; oversubscribed, a multithreaded OpenBLAS eigensolve of
    a 384 x 384 matrix took 22-44 s instead of milliseconds."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)
