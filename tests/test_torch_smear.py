"""Smearing and its site algebra in qex_tpu_torch against qex_tpu
(complex128): closed-form det/inv, rsqrt_phm and the polar projections
to 1e-12; the projection's closed-form backward against jax.vjp to 1e-10
and by gradcheck; nHYP and stout smearing on 4^4 to 1e-12; the smeared
force pullback to 1e-10.

torch's gradient of a real loss is the conjugate of JAX's, so a JAX
cotangent g enters torch as conj(g) and the results compare conjugated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import compile_ref, ginibre, n, random_links, rel, t
from qex_tpu.gauge import smear as jsmear
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.ops import linalg as jlinalg
from qex_tpu_torch.gauge import smear
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import linalg

DIMS = (4, 4, 4, 4)
SITES = (4, 3)          # lattice axes of the site-algebra fields
TOL = 1e-12


def _near_unitary(rng, nc, scale=0.3):
    """Random unitary plus a Ginibre perturbation: well conditioned, so
    14 Newton-Schulz iterations converge to rounding."""
    q, _ = np.linalg.qr(ginibre(rng, (int(np.prod(SITES)), nc, nc)))
    q = np.moveaxis(q, 0, -1).reshape((nc, nc) + SITES)
    return q + scale * ginibre(rng, (nc, nc) + SITES)


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_det_inv(nc):
    rng = np.random.default_rng(30 + nc)
    m = ginibre(rng, (nc, nc) + SITES)
    assert rel(n(linalg.det(t(m))), np.asarray(jlinalg.det(m))) < TOL
    assert rel(n(linalg.inv(t(m))), np.asarray(jlinalg.inv(m))) < TOL


def test_rsqrt_phm():
    rng = np.random.default_rng(40)
    x = _near_unitary(rng, 3)
    h = np.asarray(jlinalg.mul_an(x, x))
    ref = np.asarray(jlinalg.rsqrt_phm(h))
    got = linalg.rsqrt_phm(t(h))
    assert rel(n(got), ref) < TOL
    # S H S = I
    shs = linalg.mul(linalg.mul(got, t(h)), got)
    assert np.abs(n(shs) - np.eye(3).reshape(3, 3, 1, 1)).max() < 1e-12


@pytest.mark.parametrize("nc", [2, 3])
def test_project_u_and_su(nc):
    rng = np.random.default_rng(50 + nc)
    x = _near_unitary(rng, nc)
    assert rel(n(linalg.project_u(t(x))),
               np.asarray(jlinalg.project_u(x))) < TOL
    su = linalg.project_su(t(x))
    assert rel(n(su), np.asarray(jlinalg.project_su(x))) < TOL
    assert np.abs(n(linalg.det(su)) - 1.0).max() < 1e-12


@pytest.mark.parametrize("nc", [2, 3])
def test_project_u_backward_matches_vjp(nc):
    rng = np.random.default_rng(60 + nc)
    x = _near_unitary(rng, nc)
    g = ginibre(rng, x.shape)
    _, vjp = jax.vjp(lambda a: jlinalg.project_u(a), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xx = t(x).requires_grad_(True)
    (got,) = torch.autograd.grad(linalg.project_u(xx), xx,
                                 grad_outputs=t(np.conj(g)))
    assert rel(np.conj(n(got)), np.asarray(ref)) < 1e-10


def test_project_u_backward_at_a_cold_start():
    """x = c I (every eigenvalue degenerate): finite, and as JAX."""
    x = 0.8 * np.broadcast_to(np.eye(3, dtype=complex).reshape(3, 3, 1, 1),
                              (3, 3) + SITES).copy()
    g = ginibre(np.random.default_rng(70), x.shape)
    _, vjp = jax.vjp(lambda a: jlinalg.project_u(a), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xx = t(x).requires_grad_(True)
    (got,) = torch.autograd.grad(linalg.project_u(xx), xx,
                                 grad_outputs=t(np.conj(g)))
    assert np.isfinite(n(got)).all()
    assert rel(np.conj(n(got)), np.asarray(ref)) < 1e-10


def test_project_u_gradcheck():
    x = _near_unitary(np.random.default_rng(80), 3)[..., :2, :1]
    xx = t(x).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a: linalg.project_u(a), (xx,),
                                    eps=1e-6, atol=1e-7, rtol=1e-5)


def test_project_u_saves_only_input_and_rsqrt():
    """The n=3 projection keeps (x, s) for its backward, never the
    Newton-Schulz iterates."""
    x = t(_near_unitary(np.random.default_rng(90), 3)).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda v: saved.append(v) or v, lambda v: v):
        linalg.project_u(x)
    assert len(saved) == 2


@pytest.fixture(scope="module")
def links():
    return random_links(np.random.default_rng(11), JLattice(DIMS), 0.5)


def test_nhyp_smear(links):
    c = smear.HypCoefs(0.4, 0.5, 0.5)
    jc = jsmear.HypCoefs(0.4, 0.5, 0.5)
    jlat = JLattice(DIMS)
    ref = compile_ref(lambda u: jsmear.nhyp_smear(jc, jlat, u), links)(links)
    got = smear.nhyp_smear(c, Lattice(DIMS), t(links))
    assert rel(n(got), np.asarray(ref)) < TOL


def test_stout_smear_and_inverse(links):
    c, jc = smear.StoutCoefs(0.1), jsmear.StoutCoefs(0.1)
    jlat, lat = JLattice(DIMS), Lattice(DIMS)

    def ref_fn(u):
        v = jsmear.stout_smear(jc, jlat, u)
        return v, jsmear.stout_smear_inv(jc, jlat, v)

    v_ref, u_back_ref = compile_ref(ref_fn, links)(links)
    v = smear.stout_smear(c, lat, t(links))
    assert rel(n(v), np.asarray(v_ref)) < TOL
    u_back = smear.stout_smear_inv(c, lat, v)
    assert rel(n(u_back), np.asarray(u_back_ref)) < TOL
    # the fixed point contracts by ~0.74 per iteration on this field:
    # 40 iterations (the default) leave ~5e-6, 120 reach rounding
    u_back = smear.stout_smear_inv(c, lat, v, iters=120)
    assert rel(n(u_back), links) < 1e-12


def test_smeared_force(links):
    rng = np.random.default_rng(12)
    chain = ginibre(rng, links.shape)
    jc = jsmear.HypCoefs(0.4, 0.5, 0.5)
    jlat = JLattice(DIMS)
    ref = compile_ref(lambda u, g: jsmear.smeared_force(jc, jlat, u, g),
                      links, chain)(links, chain)
    got = smear.smeared_force(smear.HypCoefs(0.4, 0.5, 0.5), Lattice(DIMS),
                              t(links), t(np.conj(chain)))
    assert rel(np.conj(n(got)), np.asarray(ref)) < 1e-10


def test_sym_staple(links):
    from qex_tpu.gauge.smear import sym_staple as jstaple
    for mu, nu in ((0, 1), (3, 2)):
        ref = np.asarray(jstaple(jnp.asarray(links[nu]),
                                 jnp.asarray(links[mu]), nu, mu, 4))
        got = smear.sym_staple(t(links[nu]), t(links[mu]), nu, mu, 4)
        assert rel(n(got), ref) < TOL
