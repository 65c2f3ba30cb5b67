"""The spin models, compact U(1), the quasi-Newton, Nambu and RAHMC
samplers and gauge fixing on a card against the same cores on the host,
fed the same draws: the discrete updates (von Mises heatbath,
Metropolis, the Wolff cluster, the clock model) in float64 on both
sides, where they must agree to rounding; the molecular dynamics and
gauge fixing in float32 / complex64 on the card against float64 /
complex128 on the host, to 1e-5 relative.

Imports only torch and qex_tpu_torch, so it runs where jax is absent:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_models_gpu.py

Without a CUDA device every test here skips; the host side of each is
held against the JAX package by tests/test_torch_models.py and
tests/test_torch_samplers.py.
"""

import math
from functools import partial

import pytest
import torch

from qex_tpu_torch.apps import rahmc
from qex_tpu_torch.gauge import action as ga
from qex_tpu_torch.gauge import fix
from qex_tpu_torch.hmc import hmc, nambu, qnhmc
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.models import clock, u1, xy
from qex_tpu_torch.ops import group, linalg

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


def _on(dev, *xs):
    return [x.to(dev) if isinstance(x, torch.Tensor) else x for x in xs]


@pytest.mark.gpu
def test_xy_and_clock_cores_on_card_match_host(cuda_device):
    gen = torch.Generator().manual_seed(1)
    th = (2 * torch.rand((32, 24), generator=gen, dtype=torch.float64)
          - 1) * math.pi
    hb = xy.draw_heatbath(gen, th)
    got = xy.heatbath_sweep_from(th.to(cuda_device), 1.1,
                                 xy.VonMisesDraws(*_on(cuda_device, *hb)))
    assert _rel(got, xy.heatbath_sweep_from(th, 1.1, hb)) < 1e-12
    prop, acc = xy.draw_metropolis(gen, th)
    got, _ = xy.metropolis_sweep_from(th.to(cuda_device), 1.1, 1.0,
                                      *_on(cuda_device, prop, acc))
    assert _rel(got, xy.metropolis_sweep_from(th, 1.1, 1.0, prop, acc)[0]) \
        < 1e-12
    for _ in range(4):
        alpha, seed, bond_u = xy.draw_wolff(gen, th)
        b = xy.frozen_bonds(torch.cos(th - alpha), 1.1, bond_u)
        want, _ = xy.wolff_cluster(b, seed, check_every=1)
        got, _ = xy.wolff_cluster(b.to(cuda_device), seed, check_every=8)
        assert torch.equal(got.cpu(), want)
    assert _rel(xy.spin_flow(th.to(cuda_device), 0.05, 5),
                xy.spin_flow(th, 0.05, 5)) < 1e-12
    k = torch.randint(6, (32, 24), generator=gen)
    g = clock.draw_heatbath(gen, k, 6)
    assert torch.equal(
        clock.heatbath_sweep_from(k.to(cuda_device), 1.0, 6,
                                  g.to(cuda_device)).cpu(),
        clock.heatbath_sweep_from(k, 1.0, 6, g))
    prop, acc = clock.draw_metropolis(gen, k, 6)
    assert torch.equal(
        clock.metropolis_sweep_from(k.to(cuda_device), 1.0, 6,
                                    *_on(cuda_device, prop, acc))[0].cpu(),
        clock.metropolis_sweep_from(k, 1.0, 6, prop, acc)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(16, 12), (6, 4, 4)])
def test_u1_cores_on_card_match_host(cuda_device, dims):
    gen = torch.Generator().manual_seed(2)
    th = u1.random_field(gen, (len(dims),) + dims)
    d = u1.draw_heatbath(gen, th)
    got = u1.heatbath_sweep_from(th.to(cuda_device), 2.0,
                                 xy.VonMisesDraws(*_on(cuda_device, *d)))
    assert _rel(got, u1.heatbath_sweep_from(th, 2.0, d)) < 1e-12
    p = torch.randn(th.shape, generator=gen, dtype=torch.float64)
    for scheme in ("2MN", "FGI"):
        want, st = u1.hmc_step_from(th, p, 0.0, 2.0, 0.5, 4, scheme, True)
        got, gst = u1.hmc_step_from(th.to(cuda_device, torch.float32),
                                    p.to(cuda_device, torch.float32), 0.0,
                                    2.0, 0.5, 4, scheme, True)
        assert _rel(got, want) < 1e-5
        assert abs(gst["dH"] - st["dH"]) < 1e-3
        assert abs(gst["topo"] - round(gst["topo"])) < 1e-4


@pytest.mark.gpu
def test_qn_hmc_on_card_matches_host(cuda_device):
    gen = torch.Generator().manual_seed(3)
    L, beta = 8, 2.0
    tree = u1.max_tree_mask((L, L))
    x0 = torch.where(tree, 0.0, u1.random_field(gen, (2, L, L)))
    st = qnhmc.qn_init(4, x0.shape)
    for _ in range(4):
        xa = x0 + 0.1 * torch.where(tree, 0.0, torch.randn(
            x0.shape, generator=gen, dtype=torch.float64))
        xb = x0 + 0.1 * torch.where(tree, 0.0, torch.randn(
            x0.shape, generator=gen, dtype=torch.float64))
        st = qnhmc.qn_add(st, xa, u1.force(xa, beta), xb, u1.force(xb, beta),
                          yscale=1 / (2 * beta))
    q, z, _ = qnhmc.draw_qn(gen, x0.shape, 4, torch.float64)

    def run(dev, dtype):
        s = qnhmc.QNState(st.s.to(dev, dtype), st.y.to(dev, dtype),
                          st.valid.to(dev), st.pos, st.h0)
        ops = qnhmc.qn_prep(s, exclude=torch.tensor([True, False, False,
                                                     True], device=dev))
        return qnhmc.qn_hmc_step_from(
            x0.to(dev, dtype), q.to(dev, dtype), z.to(dev, dtype), 0.0, ops,
            lambda y: u1.action(y, beta), lambda y: u1.force(y, beta), 1.0,
            5, mask=tree.to(dev))

    want, st_h = run("cpu", torch.float64)
    got, st_c = run(cuda_device, torch.float32)
    assert _rel(got, want) < 1e-5 and abs(st_c["dH"] - st_h["dH"]) < 1e-3


def _links(scale=0.3):
    gen = torch.Generator().manual_seed(4)
    return torch.stack([linalg.expm(scale * group.random_tah(
        gen, LAT.dims, 3, torch.complex128)) for _ in range(4)])


@pytest.mark.gpu
def test_nambu_rahmc_and_gauge_fix_on_card_match_host(cuda_device):
    u = _links()
    gen = torch.Generator().manual_seed(5)
    c = ga.wilson(6.0)
    act, frc = partial(ga.full_action, c, LAT), partial(ga.gauge_force, c, LAT)
    p = hmc.draw_momenta(gen, u)
    want, dh, _ = rahmc.ra_step_from(u, p, 0.0, act, frc, 0.3, 0.5, 6)
    got, gdh, _ = rahmc.ra_step_from(u.to(cuda_device, torch.complex64),
                                     p.to(cuda_device, torch.complex64), 0.0,
                                     act, frc, 0.3, 0.5, 6)
    # dH: a difference of float64 sums over float32 links, so its error
    # scales with H (~1e4 here), not with dH
    h_scale = abs(float(act(u)))
    assert _rel(got, want) < 1e-5 and abs(gdh - dh) < 1e-6 * h_scale

    def system(dev, dtype):
        return nambu.NambuSystem(
            act, partial(ga.full_action, ga.wilson(5.5), LAT),
            nambu.generators(3, dtype, dev), target_force=frc)

    gens = nambu.generators(3, torch.complex128)
    pi, qi, _ = nambu.draw_nambu(gen, u, gens)
    want, dh, dg, _ = nambu.nambu_hmc_step_from(
        u, pi, qi, 0.0, system("cpu", torch.complex128), 0.3, 6)
    got, gdh, gdg, _ = nambu.nambu_hmc_step_from(
        u.to(cuda_device, torch.complex64), pi.to(cuda_device, torch.float32),
        qi.to(cuda_device, torch.float32), 0.0,
        system(cuda_device, torch.complex64), 0.3, 6)
    assert _rel(got, want) < 1e-5
    assert abs(gdh - dh) < 1e-6 * h_scale and abs(gdg - dg) < 1e-6 * h_scale
    g = group.random_su(gen, LAT.dims, 3, torch.complex128)
    uu = fix.apply_gauge_transform(LAT, u, g)
    want, fixed = fix.gauge_fix(LAT, uu, gauge="landau", iters=8)
    got, gfixed = fix.gauge_fix(LAT, uu.to(cuda_device, torch.complex64),
                                gauge="landau", iters=8)
    assert _rel(gfixed, fixed) < 1e-5
