"""The domain-decomposed staggered operators on a card: B1/B1b and B2/B2b
on each rank's block plus the halo correction, against the unsplit
kernel operators on the same card.

Imports only torch and qex_tpu_torch, so it runs where jax is absent:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_parallel_gpu.py

A one-rank mesh (no process group) must give the unsplit operators bit
for bit; two ranks share the card through gloo, every exchange staged
through host memory.  Without a CUDA device every test here skips; the
host side is held against the JAX package by tests/test_torch_parallel.py.
"""

import pytest
import torch

from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group, linalg
from qex_tpu_torch.parallel.mesh import LatticeMesh, use_mesh
from qex_tpu_torch.physics import stag_fast as sf
from qex_tpu_torch.physics import stag_hisq as sh
from qex_tpu_torch.physics import stag_shard as shd
from qex_tpu_torch.physics import staggered as st

DIMS = (8, 8, 8, 16)
TOL = 1e-12            # squared relative, as the kernel tests


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _fields(dev):
    """(8-term links, 16-term links, vector) on ``dev``, the same in every
    process: random SU(3)-near links, and their squares as long links."""
    lat = Lattice(DIMS)
    gen = torch.Generator(device=dev).manual_seed(41)
    u = torch.stack([linalg.expm(0.5 * group.random_tah(
        gen, lat.dims, 3, torch.complex64)) for _ in range(4)])
    fs8 = sf.new_fast(st.new_stag_eo(lat, u))
    f16 = sf.new_fast3(st.new_stag3_eo(lat, u, 0.1 * torch.stack(
        [linalg.mul(v, v) for v in u])))
    X, Y, Z, T = DIMS
    x = torch.randn((3, T // 2, Z, Y * X), dtype=torch.complex64,
                    generator=gen, device=dev)
    return fs8, f16, x


def _rel2(a, b):
    return float(linalg.norm2(a - b, torch.float64)
                 / linalg.norm2(b, torch.float64))


def _ops(kind, f, ldt):
    if kind == "stag8":
        p = sh.new_stag8(f, ldt)
        return p, sh.d2ee_stag8, sh.d2dd_stag8
    p = sh.new_hisq16(f, ldt)
    return p, sh.d2ee_hisq16, sh.d2dd_hisq16


def _block_links(lm, kind, f, ldt):
    """The links a rank builds from its block of ``f``."""
    with use_mesh(lm):
        return _ops(kind, shd.block_of(lm, f), ldt)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["stag8", "hisq16"])
@pytest.mark.parametrize("ldt", [torch.float32, torch.bfloat16])
def test_one_rank_mesh_is_the_kernel(cuda_device, kind, ldt):
    fs8, f16, x = _fields(cuda_device)
    p, d2ee, d2dd = _ops(kind, fs8 if kind == "stag8" else f16, ldt)
    f = fs8 if kind == "stag8" else f16
    lm = LatticeMesh(Lattice(DIMS), (1, 1, 1, 1))
    pl = _block_links(lm, kind, f, ldt)
    assert torch.equal(shd.d2ee_sharded(lm, pl, x, 0.05), d2ee(p, x, 0.05))
    assert torch.equal(shd.d2dd_sharded(lm, pl, x), d2dd(p, x))


def _rank(rank, init, geom, queue):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=2,
                            rank=rank)
    try:
        from qex_tpu_torch.parallel.mesh import make_lattice_mesh
        dev = torch.device("cuda", 0)
        fs8, f16, x = _fields(dev)
        lm = make_lattice_mesh(Lattice(DIMS), geom)
        out = {}
        for kind, f in (("stag8", fs8), ("hisq16", f16)):
            for ldt in (torch.float32, torch.bfloat16):
                p, d2ee, d2dd = _ops(kind, f, ldt)
                pl = _block_links(lm, kind, f, ldt)
                xb = shd.fast_block(lm, x)
                wrapper = sh.dslash_stag8 if kind == "stag8" \
                    else sh.dslash_hisq16
                counter = "launches" if ldt == torch.float32 \
                    else "launches_bf16"
                before = getattr(wrapper, counter)
                ee = shd.gather_fast(lm, shd.d2ee_sharded(lm, pl, xb, 0.05))
                dd = shd.gather_fast(lm, shd.d2dd_sharded(lm, pl, xb))
                launches = getattr(wrapper, counter) - before
                out[(kind, str(ldt))] = (
                    _rel2(ee, d2ee(p, x, 0.05)), _rel2(dd, d2dd(p, x)),
                    launches)
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("geom", [(1, 1, 2, 1), (1, 1, 1, 2)])
def test_two_ranks_share_the_card(cuda_device, geom):
    import torch.multiprocessing as mp

    from qex_tpu_torch.parallel.distributed import free_port
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    mp.start_processes(_rank, args=(f"tcp://localhost:{free_port()}", geom,
                                    queue), nprocs=2, start_method="spawn")
    out = queue.get()
    for key, (r_ee, r_dd, launches) in out.items():
        assert r_ee < TOL and r_dd < TOL, key
        assert launches == 4, key
