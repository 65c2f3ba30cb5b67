"""The rooted-staggered slice on a card: stag_solve.solve_multi through
kernel B1 (the float32 refinement below complex64's floor) and B1b (the
sloppy route on heavy masses), and the rooted fermion's action and
force through B1, each against the plain operator on the host in
complex128 at 8^4.

Imports only torch and qex_tpu_torch, so it runs where jax is absent:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_rhmc_gpu.py

Without a CUDA device every test here skips; the host side is held
against the JAX package by tests/test_torch_rhmc.py.
"""

import pytest
import torch

from qex_tpu_torch.gauge.action import force_from_action
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import eo, group, linalg
from qex_tpu_torch.physics import stag_hisq as sh
from qex_tpu_torch.physics import stag_hmc, stag_solve
from qex_tpu_torch.physics import staggered as st
from qex_tpu_torch.solvers.base import SolverParams

LAT = Lattice((8, 8, 8, 8))
R2REQ = 1e-10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(got, ref):
    got = got.to("cpu", ref.dtype)
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def _problem():
    gen = torch.Generator().manual_seed(23)
    u = torch.stack([linalg.expm(0.5 * group.random_tah(
        gen, LAT.dims, 3, torch.complex128)) for _ in range(4)])
    b = torch.randn(LAT.vector_shape(), dtype=torch.complex128,
                    generator=gen)
    return u, eo.pack(b, 4)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["f32_refined", "sloppy"])
def test_solve_multi_on_card(cuda_device, route):
    u, be = _problem()
    masses = (0.05, 0.1, 0.2) if route == "f32_refined" \
        else (0.4, 0.7, 1.0)
    counter = "launches" if route == "f32_refined" else "launches_bf16"
    before = getattr(sh.dslash_stag8, counter)
    s = st.new_stag_eo(LAT, u.to(cuda_device, torch.complex64))
    xs, _ = stag_solve.solve_multi(
        s, be.to(cuda_device, torch.complex64), masses,
        SolverParams(r2req=R2REQ, maxits=3000, restarts=3,
                     sloppy=route == "sloppy"))
    assert getattr(sh.dslash_stag8, counter) > before
    s64 = st.new_stag_eo(LAT, u)
    ref, _ = stag_solve.solve_multi(s64, be, masses, SolverParams(
        r2req=1e-24, maxits=3000, restarts=3))
    for x, r, m in zip(xs, ref, masses):
        x64 = x.to("cpu", torch.complex128)
        true = float(linalg.norm2(st.d2ee(s64, x64, m) - be)
                     / linalg.norm2(be))
        assert true <= 100 * R2REQ, (m, true)
        assert _rel(x, r) < 1e-4, m


@pytest.mark.gpu
def test_rooted_action_and_force_on_card(cuda_device):
    u, phi = _problem()
    before = sh.dslash_stag8.launches

    def run(dev, dtype, r2req):
        ferm = stag_hmc.StagRootedFermion(
            LAT, 0.1, nf=2, params=SolverParams(r2req=r2req, maxits=3000))
        uu, pp = u.to(dev, dtype), phi.to(dev, dtype)
        s_act = ferm.make_action_fn()
        return s_act(uu, pp), force_from_action(lambda w: s_act(w, pp), uu)

    s_card, f_card = run(cuda_device, torch.complex64, R2REQ)
    assert sh.dslash_stag8.launches > before
    s_host, f_host = run("cpu", torch.complex128, 1e-20)
    assert abs(float(s_card) - float(s_host)) < 1e-5 * abs(float(s_host))
    assert _rel(f_card, f_host) < 1e-4
