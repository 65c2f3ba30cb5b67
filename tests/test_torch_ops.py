"""Site linear algebra and group parity of qex_tpu_torch against qex_tpu
(complex128, 1e-12 relative), plus the random_tah distribution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import ginibre, n, rel, single_threaded, t  # noqa: F401
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.ops import group as jgroup
from qex_tpu.ops import linalg as jlinalg
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group, linalg

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (2, 2, 4, 4)
TOL = 1e-12


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(7)
    return ginibre(rng, (3, 3) + DIMS), ginibre(rng, (3, 3) + DIMS), \
        ginibre(rng, (3,) + DIMS)


@pytest.mark.parametrize("name", ["mul", "mul_an", "mul_na", "mul_aa"])
def test_products(mats, name):
    a, b, _ = mats
    ref = getattr(jlinalg, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(linalg, name)(t(a), t(b))
    assert rel(n(got), ref) < TOL


@pytest.mark.parametrize("name", ["mv", "mv_an"])
def test_matvec(mats, name):
    a, _, v = mats
    ref = getattr(jlinalg, name)(jnp.asarray(a), jnp.asarray(v))
    got = getattr(linalg, name)(t(a), t(v))
    assert rel(n(got), ref) < TOL


def test_adj_trace_eye(mats):
    a, _, _ = mats
    assert np.array_equal(n(linalg.adj(t(a))), np.asarray(
        jlinalg.adj(jnp.asarray(a))))
    assert rel(n(linalg.trace(t(a))), jlinalg.trace(jnp.asarray(a))) < TOL
    assert rel(n(linalg.re_trace(t(a))),
               jlinalg.re_trace(jnp.asarray(a))) < TOL
    assert np.array_equal(n(linalg.eye_like(t(a))),
                          np.asarray(jlinalg.eye_like(jnp.asarray(a))))


def test_global_sums(mats):
    a, b, _ = mats
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert rel(float(linalg.norm2(t(a))), float(jlinalg.norm2(ja))) < TOL
    assert rel(complex(linalg.dot(t(a), t(b))),
               complex(jlinalg.dot(ja, jb))) < TOL
    assert rel(float(linalg.redot(t(a), t(b))),
               float(jlinalg.redot(ja, jb))) < TOL
    # float64 accumulation of a complex64 field agrees with the f64 sum
    a64 = linalg.norm2(t(a).to(torch.complex64), dtype=torch.float64)
    assert a64.dtype == torch.float64
    assert rel(float(a64), float(jlinalg.norm2(ja))) < 1e-6


def test_tah_and_expm(mats):
    a, _, _ = mats
    ja = jnp.asarray(a)
    assert rel(n(group.tah(t(a))), jgroup.tah(ja)) < TOL
    p = 0.3 * jgroup.tah(ja)
    ref = jlinalg.expm(p)
    got = linalg.expm(t(np.asarray(p)))
    assert rel(n(got), ref) < TOL
    # exp of a TAH matrix is special unitary
    uu = linalg.mul_an(got, got)
    assert np.abs(n(uu) - np.eye(3).reshape(3, 3, 1, 1, 1, 1)).max() < TOL


def test_unit_gauge():
    ref = jgroup.unit_gauge(JLattice(DIMS), jnp.complex128)
    got = group.unit_gauge(Lattice(DIMS), torch.complex128, "cpu")
    assert np.array_equal(n(got), np.asarray(ref))


@pytest.mark.parametrize("nc", [2, 3])
def test_random_tah_equipartition(nc):
    """E[K] = (n^2-1)/2 per matrix for K = 1/2 |p|^2: mean over 4096
    matrices within 5 standard errors (Var K = (n^2-1)/2 per matrix)."""
    gen = torch.Generator().manual_seed(11)
    nmat = 4096
    p = group.random_tah(gen, (nmat,), nc, torch.complex128)
    k = 0.5 * (p.abs() ** 2).sum(dim=(0, 1))
    dof = nc * nc - 1
    assert torch.allclose(group.tah(p), p, atol=1e-15)
    se = (dof / 2) ** 0.5 / nmat ** 0.5
    assert abs(float(k.mean()) - dof / 2) < 5 * se
    assert abs(float(group.kinetic_energy(p)) - float(k.sum())) < 1e-9
