"""The plain reference at tiny sizes: known cases, and the program's
own arithmetic on the host as a second witness."""

import math

import torch

from benchmark import fields
from benchmark.reference import hmc as ref_hmc
from benchmark.reference import lattice as L

PR = L.Precision("complex128")
DIMS = (4, 4, 4, 6)


def unit_links(dims):
    e = torch.eye(3, dtype=torch.complex128).reshape(3, 3, 1, 1, 1, 1)
    return e.expand((4, 3, 3) + dims).clone()


def rand_vec(dims, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((3,) + dims, dtype=torch.complex128, generator=g)


def test_unit_links_give_the_free_operator():
    # with the phases eta_mu and the antiperiodic t boundary folded into
    # unit links, D^2 = sum_mu nabla_mu^2: chi(x +- 2 mu) / 4 with a -1
    # where the two steps cross the t boundary, minus chi(x) per mu / 2
    g = L.phased(unit_links(DIMS), "pppa", PR)
    x = rand_vec(DIMS)
    got = L.dslash(g, L.dslash(g, x, PR), PR)
    t = torch.arange(DIMS[3]).reshape(1, 1, 1, 1, -1)
    want = -2.0 * x
    for mu in range(4):
        fwd, bwd = L.shift(x, mu, 2), L.shift(x, mu, -2)
        if mu == 3:
            fwd = torch.where(t >= DIMS[3] - 2, -fwd, fwd)
            bwd = torch.where(t < 2, -bwd, bwd)
        want = want + 0.25 * (fwd + bwd)
    assert float(L.norm2(got - want)) < 1e-26


def test_nhyp_of_unit_links_is_unit():
    u = unit_links(DIMS)
    v = L.nhyp(u, (0.4, 0.5, 0.5), PR)
    assert float(L.norm2(v - u)) < 1e-24


def test_projection_is_the_polar_factor():
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 3, 7), dtype=torch.complex128, generator=g)
    got = L.project_u(x, PR)
    uu, _s, vh = torch.linalg.svd(x.permute(2, 0, 1))
    want = (uu @ vh).permute(1, 2, 0)
    assert float(L.norm2(got - want)) < 1e-24


def test_cg_residual_matches_its_definition():
    u = fields.random_links(DIMS, 0.3, torch.Generator().manual_seed(2))
    v = L.phased(u.to(torch.complex128), "pppa", PR)
    b = rand_vec(DIMS, 3) * L.even_mask(DIMS, "cpu")

    def a(y):
        return L.normal_op(v, y, 0.05 ** 2, PR)
    x, its = L.cg(a, b, 1e-20, 4000, PR)
    r2 = L.true_r2(a, x, b)
    assert its > 0 and r2 <= 1e-18
    assert math.isclose(r2, float(L.norm2(b - a(x)) / L.norm2(b)),
                        rel_tol=1e-12)
    # the even sites stay even and A is hermitian on them
    y = rand_vec(DIMS, 4) * L.even_mask(DIMS, "cpu")
    assert float(L.norm2(a(y) * ~L.even_mask(DIMS, "cpu"))) == 0.0
    lhs, rhs = (y.conj() * a(b)).sum(), (a(y).conj() * b).sum()
    assert abs(complex(lhs - rhs)) < 1e-10 * abs(complex(lhs))


def test_pack_and_unpack_follow_the_packed_layout():
    full = rand_vec(DIMS, 5) * L.even_mask(DIMS, "cpu")
    packed = L.pack_even(full, DIMS)
    assert packed.shape == (3, 4, 4, 4, 3)
    assert torch.equal(L.unpack_even(packed, DIMS), full)
    x, y, z, th = 1, 2, 0, 1
    s = (x + y + z) % 2
    assert packed[0, x, y, z, th] == full[0, x, y, z, 2 * th + s]


def test_schedule_of_two_timescales():
    ev = ref_hmc.schedule([(2, ref_hmc.two_mn(0.2)), (1, ref_hmc.two_mn(0.2))],
                          1.0)
    assert math.isclose(sum(d for d, _k in ev), 1.0)
    kicks = [k for _d, k in ev]
    assert math.isclose(sum(k.get(0, 0.0) for k in kicks), 1.0)
    assert math.isclose(sum(k.get(1, 0.0) for k in kicks), 1.0)
    assert math.isclose(kicks[0][0], 0.1) and math.isclose(kicks[0][1], 0.2)


def test_exponential_against_matrix_exp():
    z = 0.9 * fields.gaussian_tah(torch.Generator().manual_seed(6), (5,))
    z = z.to(torch.complex128)
    want = torch.linalg.matrix_exp(z.permute(2, 0, 1)).permute(1, 2, 0)
    assert float(L.norm2(L.expm(z) - want)) < 1e-26


# --- the program on the host as a second witness (complex128) ---------------

def smooth_links(dims, seed):
    u = fields.random_links(dims, 0.27, torch.Generator().manual_seed(seed))
    return u.to(torch.complex128)


def test_nhyp_and_hisq_links_agree_with_the_program():
    from qex_tpu_torch.gauge import fat7
    from qex_tpu_torch.gauge.smear import HypCoefs, nhyp_smear
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import staggered as st
    from benchmark import harness
    lat = Lattice(DIMS)
    u = smooth_links(DIMS, 7)
    v_prog = nhyp_smear(HypCoefs(0.4, 0.5, 0.5), lat, u)
    v_ref = L.nhyp(u, (0.4, 0.5, 0.5), PR)
    assert float(L.norm2(v_prog - v_ref) / L.norm2(v_ref)) < 1e-26
    op = harness.load_json(harness.BENCH / "configs" / "hisq.json")["operator"]
    fat_p, long_p = fat7.hisq_links_lowmem(lat, st.phase_links(lat, u, "pppa"))
    fat_r, long_r = L.hisq_links(L.phased(u, "pppa", PR), PR, op["fat7"])
    assert float(L.norm2(fat_p - fat_r) / L.norm2(fat_r)) < 1e-26
    assert float(L.norm2(long_p - long_r) / L.norm2(long_r)) < 1e-26


def test_trajectory_agrees_with_the_program():
    from benchmark import harness
    from benchmark.kinds.hmc import build_theory
    from qex_tpu_torch.lattice import Lattice
    cfg = harness.load_json(harness.BENCH / "configs" / "spv.json")
    action = dict(cfg["action"])
    tight = {"r2req": 1e-24, "maxits": 5000, "restarts": 3}
    action.update(solver_action=tight, solver_force=tight)
    action["reference"] = {"r2_action": 1e-24, "r2_force": 1e-24,
                           "maxits": 5000}
    dims = (4, 4, 4, 4)
    th = build_theory(action, Lattice(dims))
    u = smooth_links(dims, 3)
    g = torch.Generator().manual_seed(4)
    p = fields.momenta(dims, g).to(torch.complex128)
    xi = [fields.noise(dims, g).to(torch.complex128) for _ in range(2)]
    phis = th.heatbath_from_noise([None] + xi, u)
    h0 = float(th.hamiltonian(u, p, phis))
    u1, p1 = th.trajectory(u, p, phis)
    dh = float(th.hamiltonian(u1, p1, phis)) - h0
    ref = ref_hmc.Config4(action, PR).trajectory(u, p, xi[0], xi[1])
    assert abs(dh - ref["dH"]) < 1e-6
    assert float(L.norm2(u1 - ref["u"]) / L.norm2(ref["u"])) < 1e-20
