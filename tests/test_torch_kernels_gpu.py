"""The CUDA kernels against their plain torch versions on a card: the
8-term stag8 hop (f32 links, B1; bf16 links, B1b) with a sloppy solve,
the 16-term HISQ hop (f32 links, B2; bf16 links, B2b) with a
multi-mass solve, the Wilson hop (f32 links, B3; bf16 links, B3b)
with f32 and sloppy eo solves, and the older staggered generations (v1
B4/B4b, v2 B5, v3 B6/B6b, v4 B7/B7b, the v3 split modes B8) with a CG
through each.

Imports only torch and qex_tpu_torch, so it runs where jax is absent:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

Without a CUDA device every test here skips (the kernels have no CPU
mode; their plain twins are covered by tests/test_torch_staggered.py,
tests/test_torch_hisq.py, tests/test_torch_wilson.py and
tests/test_torch_stag_generations.py).
"""

import pytest
import torch

from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group, linalg
from qex_tpu_torch.physics import stag_hisq as sh
from qex_tpu_torch.physics import staggered as st

TOL = 1e-12   # squared relative deviation, as the JAX kernel tests


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stag8 kernel has no CPU mode")
    return torch.device("cuda", 0)


def _rel2(got, ref):
    return float(((got - ref).abs() ** 2).sum() / (ref.abs() ** 2).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(8, 4, 4, 8), (6, 4, 2, 6), (4, 6, 8, 4)])
def test_stag8_kernel_matches_plain_on_card(cuda_device, dims):
    lat = Lattice(dims)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    u = torch.stack([linalg.expm(0.7 * group.random_tah(
        gen, lat.dims, 3, torch.complex64)) for _ in range(4)])
    p8 = sh.new_stag8(st.new_stag_eo(lat, u))
    x = torch.randn((3, dims[3] // 2, dims[2], dims[1] * dims[0]),
                    dtype=torch.complex64, generator=gen, device=cuda_device)
    before = sh.dslash_stag8.launches
    for parity in (0, 1):
        got = sh.dslash_stag8(p8, x, parity)
        torch.cuda.synchronize()
        assert _rel2(got, sh.dslash_stag8_plain(p8, x, parity)) < TOL
    got = sh.d2ee_stag8(p8, x, 0.3)
    ref = 0.09 * x - sh.dslash_stag8_plain(
        p8, sh.dslash_stag8_plain(p8, x, 1), 0)
    torch.cuda.synchronize()
    assert _rel2(got, ref) < TOL
    got = sh.d2dd_stag8(p8, x, 1)
    ref = -sh.dslash_stag8_plain(p8, sh.dslash_stag8_plain(p8, x, 0), 1)
    torch.cuda.synchronize()
    assert _rel2(got, ref) < TOL
    assert sh.dslash_stag8.launches == before + 6


@pytest.mark.gpu
def test_stag8_kernel_rejects_bad_operands(cuda_device):
    lat = Lattice((4, 4, 4, 4))
    u = torch.eye(3, dtype=torch.complex64, device=cuda_device).reshape(
        1, 3, 3, 1, 1, 1, 1).expand(lat.gauge_shape()).contiguous()
    p8 = sh.new_stag8(st.new_stag_eo(lat, u))
    x = torch.zeros((3, 2, 4, 16), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(TypeError):
        sh.dslash_stag8(p8, x.to(torch.complex128), 0)
    with pytest.raises(ValueError):
        sh.dslash_stag8(p8, x[:, :1], 0)
    with pytest.raises(ValueError):
        sh.dslash_stag8(p8, x.transpose(2, 3).contiguous().transpose(2, 3), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(8, 4, 4, 8), (6, 4, 2, 6)])
def test_stag8_bf16_kernel_matches_plain_on_card(cuda_device, dims):
    """Kernel B1b: the same hop on bf16 links.  bf16 -> f32 is exact,
    so kernel and twin differ only in summation order."""
    lat = Lattice(dims)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    u = torch.stack([linalg.expm(0.7 * group.random_tah(
        gen, lat.dims, 3, torch.complex64)) for _ in range(4)])
    s = st.new_stag_eo(lat, u)
    p8 = sh.new_stag8(s, links_dtype=torch.bfloat16)
    assert p8.l_e.dtype == torch.bfloat16
    x = torch.randn((3, dims[3] // 2, dims[2], dims[1] * dims[0]),
                    dtype=torch.complex64, generator=gen, device=cuda_device)
    before, before_f32 = sh.dslash_stag8.launches_bf16, sh.dslash_stag8.launches
    for parity in (0, 1):
        got = sh.dslash_stag8(p8, x, parity)
        torch.cuda.synchronize()
        assert _rel2(got, sh.dslash_stag8_plain(p8, x, parity)) < TOL
    got = sh.d2ee_stag8(p8, x, 0.3)
    ref = 0.09 * x - sh.dslash_stag8_plain(
        p8, sh.dslash_stag8_plain(p8, x, 1), 0)
    torch.cuda.synchronize()
    assert _rel2(got, ref) < TOL
    assert sh.dslash_stag8.launches_bf16 == before + 4
    assert sh.dslash_stag8.launches == before_f32
    # the bf16 operator is the f32 one up to link rounding (2^-9)
    f32 = sh.d2ee_stag8(sh.new_stag8(s), x, 0.3)
    assert 1e-8 < _rel2(got, f32) < 1e-4


@pytest.mark.gpu
def test_sloppy_solve_on_card(cuda_device):
    """bf16-link inner CG with f32 true-residual restarts reaches the
    requested true residual; both kernels launch."""
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((8, 8, 8, 8))
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    u = torch.stack([linalg.expm(0.7 * group.random_tah(
        gen, lat.dims, 3, torch.complex64)) for _ in range(4)])
    s = st.new_stag_eo(lat, u)
    b = torch.randn((3,) + lat.dims[:3] + (lat.dims[3] // 2,),
                    dtype=torch.complex64, generator=gen, device=cuda_device)
    before = (sh.dslash_stag8.launches, sh.dslash_stag8.launches_bf16)
    x, stats = stag_solve.solve_ee(
        s, b, 0.1, SolverParams(r2req=1e-10, maxits=2000, restarts=5,
                                sloppy=True))
    assert sh.dslash_stag8.launches > before[0]
    assert sh.dslash_stag8.launches_bf16 > before[1]
    s64 = st.new_stag_eo(lat, u.to(torch.complex128))
    r = st.d2ee(s64, x.to(torch.complex128), 0.1) - b.to(torch.complex128)
    assert float((r.abs() ** 2).sum() / (b.abs() ** 2).sum()) <= 1e-9


def _hisq16(lat, gen, links_dtype=torch.float32):
    """16-term links of expm(0.7 tah) links phased and HISQ-smeared as
    HisqFermion._links does."""
    from qex_tpu_torch.gauge import fat7
    u = torch.stack([linalg.expm(0.7 * group.random_tah(
        gen, lat.dims, 3, torch.complex64)) for _ in range(4)])
    fl, ll = fat7.hisq_links_lowmem(lat, st.phase_links(lat, u))
    return sh.new_hisq16(st.new_stag3_eo(lat, fl, ll),
                         links_dtype=links_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("links", ["f32", "bf16"])
@pytest.mark.parametrize("dims", [(4, 4, 4, 4), (8, 4, 4, 8),
                                  (24, 24, 24, 24), (6, 3, 5, 4),
                                  (8, 3, 5, 4)])
def test_hisq16_kernel_matches_plain_on_card(cuda_device, dims, links):
    """Kernels B2 (f32 links) and B2b (bf16 links) against the plain
    16-term hop on the same links: both parities and the fused d2ee and
    d2dd epilogues.  4^4 holds Th = 2 and the distance-3 wraps at
    extent 4; (6, 3, 5, 4) odd Y and Z, an x extent that is no multiple
    of the sites a thread takes (the per-site path) and V = 180 (a bf16
    plane of 360 B, not a multiple of 16); (8, 3, 5, 4) the vector path
    with odd Y and Z."""
    lat = Lattice(dims)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    ldt = torch.float32 if links == "f32" else torch.bfloat16
    p16 = _hisq16(lat, gen, ldt)
    assert p16.l_e.dtype == ldt
    x = torch.randn((3, dims[3] // 2, dims[2], dims[1] * dims[0]),
                    dtype=torch.complex64, generator=gen, device=cuda_device)
    counter = "launches" if links == "f32" else "launches_bf16"
    before = getattr(sh.dslash_hisq16, counter)
    for parity in (0, 1):
        got = sh.dslash_hisq16(p16, x, parity)
        torch.cuda.synchronize()
        assert _rel2(got, sh.dslash_hisq16_plain(p16, x, parity)) < TOL
    hop = lambda v, par: sh.dslash_hisq16_plain(p16, v, par)
    got = sh.d2ee_hisq16(p16, x, 0.3)
    torch.cuda.synchronize()
    assert _rel2(got, 0.09 * x - hop(hop(x, 1), 0)) < TOL
    got = sh.d2dd_hisq16(p16, x, 1)
    torch.cuda.synchronize()
    assert _rel2(got, -hop(hop(x, 0), 1)) < TOL
    assert getattr(sh.dslash_hisq16, counter) == before + 6


@pytest.mark.gpu
@pytest.mark.parametrize("links", ["f32", "bf16"])
def test_hisq16_kernel_unaligned_operands_on_card(cuda_device, links):
    """A spinor that starts 8 B past a 16-B boundary takes the kernel's
    per-site path, with the same result."""
    lat = Lattice((8, 4, 4, 8))
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    ldt = torch.float32 if links == "f32" else torch.bfloat16
    p16 = _hisq16(lat, gen, ldt)
    shape = (3, 4, 4, 32)
    buf = torch.randn(1 + 3 * 4 * 4 * 32, dtype=torch.complex64,
                      generator=gen, device=cuda_device)
    x = buf[1:].view(shape)
    assert x.data_ptr() % 16 == 8
    got = sh.dslash_hisq16(p16, x, 0, x_fuse=x, m2=0.09)
    torch.cuda.synchronize()
    ref = sh.dslash_hisq16_plain(p16, x, 0, x_fuse=x, m2=0.09)
    assert _rel2(got, ref) < TOL
    assert _rel2(got, sh.dslash_hisq16(p16, x.clone(), 0, x_fuse=x.clone(),
                                       m2=0.09)) < TOL


@pytest.mark.gpu
def test_hisq16_kernel_rejects_bad_operands(cuda_device):
    lat = Lattice((4, 4, 4, 4))
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    p16 = _hisq16(lat, gen)
    x = torch.zeros((3, 2, 4, 16), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(TypeError):
        sh.dslash_hisq16(p16, x.to(torch.complex128), 0)
    with pytest.raises(ValueError):
        sh.dslash_hisq16(p16, x[:, :1], 0)
    p8 = sh.new_stag8(st.new_stag_eo(lat, torch.eye(
        3, dtype=torch.complex64, device=cuda_device).reshape(
        1, 3, 3, 1, 1, 1, 1).expand(lat.gauge_shape()).contiguous()))
    with pytest.raises(ValueError):          # 8-term links, 16-term hop
        sh.dslash_hisq16(sh.Hisq16EO(lat, p8.l_e, p8.l_o), x, 0)


@pytest.mark.gpu
def test_hisq_multishift_on_card(cuda_device):
    """The multi-mass solve on kernel B2 reaches each mass's requested
    true residual (within the 100x that an unrestarted float32
    multishift allows)."""
    from qex_tpu_torch.physics import stag_hmc
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((8, 8, 8, 8))
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    u = torch.stack([linalg.expm(0.7 * group.random_tah(
        gen, lat.dims, 3, torch.complex64)) for _ in range(4)])
    ferm = stag_hmc.HisqFermion(lat, 0.1, params=SolverParams(
        r2req=1e-10, maxits=2000))
    b = torch.randn((3, 8, 8, 8, 4), dtype=torch.complex64, generator=gen,
                    device=cuda_device)
    before = sh.dslash_hisq16.launches
    masses = (0.1, 0.2, 0.4)
    xs, stats = ferm.solve_multi(u, b, masses)
    assert sh.dslash_hisq16.launches == before + 2 * stats.iterations
    s3 = st.new_stag3_eo(lat, *ferm._links(u))
    for m, x in zip(masses, xs):
        r = st.d2ee3(s3, x, m) - b
        assert float((r.abs() ** 2).sum() / (b.abs() ** 2).sum()) <= 1e-8


def _wilson(lat, gen, links_dtype=torch.float32, m=0.1):
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.physics import wilson_pallas as wp
    u = torch.stack([linalg.expm(0.7 * group.random_tah(
        gen, lat.dims, 3, torch.complex64)) for _ in range(4)])
    return u, wp.new_pallas_wilson(wl.new_wilson_eo(lat, u, m),
                                   links_dtype=links_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("links", ["f32", "bf16"])
@pytest.mark.parametrize("dims", [(6, 4, 4, 8), (4, 4, 8, 8),
                                  (8, 6, 4, 4)])
def test_wilson8_kernel_matches_plain_on_card(cuda_device, dims, links):
    """Kernels B3 (f32 links) and B3b (bf16 links) against the plain
    twin on the same links: both parities, the fused m_ee epilogue and
    m_ee_dag.  (8, 6, 4, 4) holds Th = 2, where a t hop wraps at once."""
    from qex_tpu_torch.physics import wilson_pallas as wp
    lat = Lattice(dims)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    ldt = torch.float32 if links == "f32" else torch.bfloat16
    _, pw = _wilson(lat, gen, ldt)
    assert pw.l_e.dtype == ldt
    x = torch.randn((4, 3, dims[3] // 2, dims[2], dims[1] * dims[0]),
                    dtype=torch.complex64, generator=gen, device=cuda_device)
    counter = "launches" if links == "f32" else "launches_bf16"
    before = getattr(wp.hop_w, counter)
    for parity in (0, 1):
        got = wp.hop_w(pw, x, parity)
        torch.cuda.synchronize()
        assert _rel2(got, wp.hop_w_plain(pw, x, parity)) < TOL
    hop = lambda v, par: wp.hop_w_plain(pw, v, par)
    got = wp.m_ee_w(pw, x)
    torch.cuda.synchronize()
    assert _rel2(got, pw.a * x - hop(hop(x, 1), 0) / pw.a) < TOL
    got = wp.m_ee_dag_w(pw, x)
    g5 = torch.tensor([1, 1, -1, -1], dtype=torch.complex64,
                      device=cuda_device).reshape(4, 1, 1, 1, 1)
    torch.cuda.synchronize()
    assert _rel2(got, g5 * (pw.a * (g5 * x)
                            - hop(hop(g5 * x, 1), 0) / pw.a)) < TOL
    assert getattr(wp.hop_w, counter) == before + 6


@pytest.mark.gpu
def test_wilson8_kernel_rejects_bad_operands(cuda_device):
    from qex_tpu_torch.physics import wilson_pallas as wp
    lat = Lattice((4, 4, 4, 4))
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    _, pw = _wilson(lat, gen)
    x = torch.zeros((4, 3, 2, 4, 16), dtype=torch.complex64,
                    device=cuda_device)
    with pytest.raises(TypeError):
        wp.hop_w(pw, x.to(torch.complex128), 0)
    with pytest.raises(ValueError):
        wp.hop_w(pw, x[:3], 0)
    with pytest.raises(ValueError):
        wp.hop_w(pw, x.transpose(3, 4).contiguous().transpose(3, 4), 0)
    with pytest.raises(ValueError):                 # float64 links
        wp.hop_w(wp.PallasWilsonEO(lat, pw.l_e.double(), pw.l_o.double(),
                                   pw.m), x, 0)
    with pytest.raises(ValueError):                 # links on the host
        wp.hop_w(wp.PallasWilsonEO(lat, pw.l_e.cpu(), pw.l_o.cpu(), pw.m),
                 x, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("sloppy", [False, True])
def test_wilson_solve_eo_on_card(cuda_device, sloppy):
    """The eo CGNE solve goes through B3 (and, sloppy, B3b) and never
    through the plain twin; it reaches the requested true residual."""
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.physics import wilson_pallas as wp
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((8, 8, 8, 8))
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    u, _ = _wilson(lat, gen)
    b = torch.randn((4, 3) + lat.dims, dtype=torch.complex64, generator=gen,
                    device=cuda_device)
    before = (wp.hop_w.launches, wp.hop_w.launches_bf16)
    plain = wp.hop_w_plain
    wp.hop_w_plain = None        # any call of the twin would fail
    try:
        x, stats = wl.solve_eo(wl.new_wilson_eo(lat, u, 0.1), b,
                               SolverParams(r2req=1e-10, maxits=1000,
                                            restarts=5, sloppy=sloppy))
    finally:
        wp.hop_w_plain = plain
    assert wp.hop_w.launches > before[0]
    assert (wp.hop_w.launches_bf16 > before[1]) == sloppy
    d = wl.new_wilson(lat, u.to(torch.complex128), 0.1)
    r = wl.wilson_d(d, x.to(torch.complex128)) - b.to(torch.complex128)
    assert float((r.abs() ** 2).sum() / (b.abs() ** 2).sum()) <= 1e-9


# --- the older staggered generations: B4-B8 ---------------------------------

def _fast_ops(lat, gen):
    from qex_tpu_torch.physics import stag_fast as sf
    u = torch.stack([linalg.expm(0.7 * group.random_tah(
        gen, lat.dims, 3, torch.complex64)) for _ in range(4)])
    return sf.new_fast(st.new_stag_eo(lat, u))


def _launch_count(inst):
    """The launch counter that a hop of benchmark instance ``inst``
    bumps."""
    from qex_tpu_torch.bench import exp_pallas3 as ep3
    from qex_tpu_torch.physics import stag_pallas as sp1
    from qex_tpu_torch.physics import stag_pallas2 as sp2
    from qex_tpu_torch.physics import stag_pallas3 as sp3
    from qex_tpu_torch.physics import stag_pallas4 as sp4
    if inst.kind == "split":
        return getattr(ep3.run, f"launches_{inst.mode}")
    fn = {"v1": sp1.dslash_pallas, "v2": sp2.dslash_pallas2,
          "v3": sp3.dslash_pallas3, "v4": sp4.dslash_pallas4,
          "s8": sh.dslash_stag8}[inst.kind]
    name = "launches" + ("_compute_only" if inst.compute_only else "") \
        + ("_bf16" if inst.links_dtype == torch.bfloat16 else "")
    return getattr(fn, name)


@pytest.mark.gpu
@pytest.mark.parametrize("links", ["f32", "bf16"])
@pytest.mark.parametrize("dims", [(8, 4, 4, 8), (6, 4, 2, 6), (4, 6, 8, 4)])
def test_stag_generations_match_plain_on_card(cuda_device, dims, links):
    """Kernels B4-B8 against their plain twins on the same links: both
    parities, and the d2ee/d2dd wrappers of v1-v4.  (6, 4, 2, 6) holds
    Z = 2 and Th = 3; (4, 6, 8, 4) Th = 2."""
    from qex_tpu_torch.bench import stag_generations as gens
    lat = Lattice(dims)
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    s = _fast_ops(lat, gen)
    x = torch.randn((3, dims[3] // 2, dims[2], dims[1] * dims[0]),
                    dtype=torch.complex64, generator=gen, device=cuda_device)
    ldt = torch.float32 if links == "f32" else torch.bfloat16
    for inst in gens.all_instances():
        if inst.links_dtype != ldt or inst.kind == "s8":
            continue
        op = gens.build(inst, s)
        v = gens.to_layout(inst.kind, x)
        hop, plain = gens.hop(inst, op), gens.plain_hop(inst, op)
        before = _launch_count(inst)
        for parity in (0, 1):
            got, ref = hop(v, parity), plain(v, parity)
            torch.cuda.synchronize()
            if inst.mode == "matvec":        # zero up to rounding
                assert float((got - ref).abs().max()) < 1e-5, inst.label
            else:
                assert _rel2(got, ref) < TOL, (inst.label, parity)
        assert _launch_count(inst) == before + 2, inst.label
        if inst.kind in ("split", "s8") or inst.compute_only:
            continue
        got = gens.d2ee(inst.kind, op)(v, 0.3)
        torch.cuda.synchronize()
        assert _rel2(got, 0.09 * v - plain(plain(v, 1), 0)) < TOL, inst.label


@pytest.mark.gpu
@pytest.mark.parametrize("links", ["f32", "bf16"])
@pytest.mark.parametrize("dims", [(8, 4, 4, 8), (6, 3, 5, 4), (5, 4, 4, 6),
                                  (24, 24, 24, 24), (24, 23, 25, 24)])
def test_v1_kernel_matches_plain_on_card(cuda_device, dims, links):
    """Kernels B4 (f32 links) and B4b (bf16 links) against the plain v1
    hop: both parities and d2ee, then with a spinor 4 B past a 16-B
    boundary (the per-site path).  The small shapes take the per-site
    path ((6, 3, 5, 4): odd Y and Z, V = 180; (5, 4, 4, 6): an odd x
    extent); 24^4 and (24, 23, 25, 24), odd Y and Z, the two-site
    path."""
    from qex_tpu_torch.physics import stag_pallas as sp1
    lat = Lattice(dims)
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    ldt = torch.float32 if links == "f32" else torch.bfloat16
    op = sp1.new_pallas(_fast_ops(lat, gen), ldt, device=cuda_device)
    shape = sp1.split_shape(lat)
    buf = torch.randn(1 + torch.Size(shape).numel(), generator=gen,
                      device=cuda_device)
    counter = "launches" if links == "f32" else "launches_bf16"
    before = getattr(sp1.dslash_pallas, counter)
    for x in (buf[:-1].view(shape), buf[1:].view(shape)):
        for parity in (0, 1):
            got = sp1.dslash_pallas(op, x, parity)
            torch.cuda.synchronize()
            assert _rel2(got, sp1.dslash_pallas_plain(op, x, parity)) < TOL
    plain = lambda v, par: sp1.dslash_pallas_plain(op, v, par)
    x = buf[:-1].view(shape)
    got = sp1.d2ee_pallas(op, x, 0.3)
    torch.cuda.synchronize()
    assert _rel2(got, 0.09 * x - plain(plain(x, 1), 0)) < TOL
    assert getattr(sp1.dslash_pallas, counter) == before + 6


@pytest.mark.gpu
def test_stag_generations_reject_bad_operands(cuda_device):
    from qex_tpu_torch.bench import exp_pallas3 as ep3
    from qex_tpu_torch.physics import stag_pallas as sp1
    from qex_tpu_torch.physics import stag_pallas2 as sp2
    from qex_tpu_torch.physics import stag_pallas3 as sp3
    lat = Lattice((4, 4, 4, 4))
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    s = _fast_ops(lat, gen)
    p1, p3 = sp1.new_pallas(s), sp3.new_pallas3(s)
    x = torch.zeros((2, 3, 2, 4, 16), dtype=torch.float32,
                    device=cuda_device)
    for hop in (lambda v: sp1.dslash_pallas(p1, v, 0),
                lambda v: sp3.dslash_pallas3(p3, v, 1)):
        with pytest.raises(TypeError):
            hop(x.double())
        with pytest.raises(ValueError):
            hop(x[:, :2])
        with pytest.raises(ValueError):
            hop(x.transpose(3, 4).contiguous().transpose(3, 4))
    with pytest.raises(ValueError):                  # v2 takes float32 only
        p2b = sp2.PallasStagEO2(lat, *(sp2.to_gridmajor_links(g) for g in (
            sp1.new_pallas(s, torch.bfloat16).g_e,
            sp1.new_pallas(s, torch.bfloat16).g_o)))
        sp2.dslash_pallas2(p2b, sp2.to_gridmajor_spinor(x), 0)
    with pytest.raises(ValueError):                  # B8 takes float32 only
        ep3.run(sp3.new_pallas3(s, torch.bfloat16).l_e, x, lat, 0, "full")
    with pytest.raises(ValueError):                  # links on the host
        sp3.dslash_pallas3(sp3.PallasStagEO3(lat, p3.l_e.cpu(),
                                             p3.l_o.cpu()), x, 0)
    with pytest.raises(ValueError):                  # v3 links, v1 hop
        sp1.dslash_pallas(sp1.PallasStagEO(lat, p3.l_e, p3.l_o), x, 0)


@pytest.mark.gpu
def test_stag_generations_cg_on_card(cuda_device):
    """CG through d2ee of v1-v4 (f32 links) reaches the requested true
    residual within 2 iterations of the 8-term kernel B1."""
    from qex_tpu_torch.bench import stag_generations as gens
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.solvers import cg
    lat = Lattice((8, 8, 8, 8))
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    s = _fast_ops(lat, gen)
    b = torch.randn((3, 4, 8, 64), dtype=torch.complex64, generator=gen,
                    device=cuda_device)
    s64 = sf.FastStagEO(lat, s.g_e.to(torch.complex128),
                        s.g_o.to(torch.complex128))
    its = {}
    for kind in ("s8", "v1", "v2", "v3", "v4"):
        inst = gens.Instance(kind)
        op, before = gens.build(inst, s), _launch_count(inst)
        a = gens.d2ee(kind, op)
        x, stats = cg.cg_solve(lambda v: a(v, 0.1),
                               gens.to_layout(kind, b), r2req=1e-10,
                               maxits=1000)
        assert _launch_count(inst) == before + 2 * stats.iterations
        r = sf.d2ee_fast(s64, gens.from_layout(kind, x).to(
            torch.complex128), 0.1) - b.to(torch.complex128)
        assert float((r.abs() ** 2).sum() / (b.abs() ** 2).sum()) <= 1e-9
        its[kind] = stats.iterations
    assert all(abs(n - its["s8"]) <= 2 for n in its.values()), its


@pytest.mark.gpu
def test_stag8_refuses_nc2_on_card(cuda_device):
    """The hop kernels are 3x3, as the JAX Pallas kernels are: a staggered
    solve at Nc = 2 on the card raises (no silent fallback to the plain
    operator); the host solve at Nc = 2 is tests/test_torch_nc.py's."""
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((4, 4, 4, 4), nc=2)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    u = torch.stack([linalg.expm(0.5 * group.random_tah(
        gen, lat.dims, 2, torch.complex64)) for _ in range(4)])
    b = torch.randn((2,) + lat.dims, dtype=torch.complex64, generator=gen,
                    device=cuda_device)
    before = sh.dslash_stag8.launches
    with pytest.raises(ValueError, match="links must be"):
        stag_solve.solve(st.new_stag_eo(lat, u, "pppp"), b, 0.2,
                         SolverParams(r2req=1e-10))
    assert sh.dslash_stag8.launches == before
