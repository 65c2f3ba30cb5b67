"""The pure-gauge path on a card against the same code on the host in
complex128: five Wilson-flow steps at 4^4, the exact force-gradient
kick of the Symanzik force (forward mode) and of a staggered fermion
(a Hessian-vector product through its solve), and an HMC trajectory.

Imports only torch and qex_tpu_torch, so it runs where jax is absent:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_puregauge_gpu.py

Without a CUDA device every test here skips; the host side of each is
held against the JAX package by tests/test_torch_gauge.py and
tests/test_torch_puregauge.py.
"""

import math

import pytest
import torch

from qex_tpu_torch.gauge import action as ga
from qex_tpu_torch.gauge import flow as gf
from qex_tpu_torch.hmc import hmc, integrators
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group, linalg
from qex_tpu_torch.physics import stag_hmc
from qex_tpu_torch.solvers.base import SolverParams

LAT = Lattice((4, 4, 4, 4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(got, ref):
    got = got.to("cpu", ref.dtype)
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def _links(scale=0.3):
    gen = torch.Generator().manual_seed(11)
    return torch.stack([linalg.expm(scale * group.random_tah(
        gen, LAT.dims, 3, torch.complex128)) for _ in range(4)])


@pytest.mark.gpu
def test_flow_on_card_matches_host(cuda_device):
    u = _links()
    c = gf.wilson_flow_coeffs(3)
    vc, mc = gf.flow(c, LAT, u.to(cuda_device, torch.complex64), 0.02, 5)
    vh, mh = gf.flow(c, LAT, u, 0.02, 5)
    assert _rel(vc, vh) < 1e-5
    assert _rel(mc.t2e_clover, mh.t2e_clover) < 1e-5
    assert _rel(mc.plaq, mh.plaq) < 1e-6


@pytest.mark.gpu
def test_exact_fg_kicks_on_card_match_host(cuda_device):
    u = _links(0.5)
    frc = lambda c, lat: (lambda v: ga.gauge_force(c, lat, v))  # noqa: E731
    sym = frc(ga.symanzik(5.5), LAT)
    got = integrators.fg_force(u.to(cuda_device, torch.complex64), 0.01,
                               sym, hmc.gauge_update_u)
    ref = integrators.fg_force(u, 0.01, sym, hmc.gauge_update_u)
    assert _rel(got, ref) < 1e-5
    ferm = stag_hmc.StagFermion(LAT, 0.3, params=SolverParams(
        r2req=1e-12, maxits=1000, restarts=3))
    act = ferm.make_action_fn()
    phi = torch.randn((3, 4, 4, 4, 2), dtype=torch.complex128,
                      generator=torch.Generator().manual_seed(3))

    def kick(w, ph):
        return integrators.fg_force(
            w, 0.01, lambda v: ga.force_from_action(
                lambda x: act(x, ph), v), hmc.gauge_update_u,
            action_fn=lambda x: act(x, ph))

    got = kick(u.to(cuda_device, torch.complex64),
               phi.to(cuda_device, torch.complex64))
    assert _rel(got, kick(u, phi)) < 1e-4


@pytest.mark.gpu
def test_hmc_trajectory_on_card(cuda_device):
    c = ga.wilson(6.0)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    u = group.unit_gauge(LAT, torch.complex64, cuda_device)
    for _ in range(3):
        u, st = hmc.hmc_step(gen, u, lambda v: ga.full_action(c, LAT, v),
                             lambda v: ga.gauge_force(c, LAT, v),
                             integrators.get_integrator("FGI"), 1.0, 8,
                             always_accept=True)
        assert math.isfinite(st.dH)
    assert all(float(x) < 1e-10 for mu in range(4)
               for x in group.check_su(u[mu]).values())
