"""The eigensolver and measurement tier on a card at 8^4: stag_eigs
through kernel B1 (plain staggered) and B2 (fat + naik links), svd_stag
through B1's single-parity hop, deflated CG and the condensate through
B1, each against the plain operator on the host in complex128.

Imports only torch and qex_tpu_torch, so it runs where jax is absent:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_eigens_gpu.py

Without a CUDA device every test here skips; the host side is held
against the JAX package by tests/test_torch_eigens.py and
tests/test_torch_measure.py.
"""

import numpy as np
import pytest
import torch

from qex_tpu_torch.eigens import hisqev, svdlanczos
from qex_tpu_torch.gauge import fat7
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.observables import condensate
from qex_tpu_torch.ops import group, linalg
from qex_tpu_torch.physics import stag_fast as sf
from qex_tpu_torch.physics import stag_hisq as sh
from qex_tpu_torch.physics import staggered as st
from qex_tpu_torch.solvers.base import SolverParams
from qex_tpu_torch.solvers.deflate import deflated_cg

LAT = Lattice((8, 8, 8, 8))
NEV = 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _links():
    gen = torch.Generator().manual_seed(31)
    return torch.stack([linalg.expm(0.3 * group.random_tah(
        gen, LAT.dims, 3, torch.complex128)) for _ in range(4)])


def _rayleigh(op, vecs):
    """Rayleigh quotients and true residuals of canonical even-site
    vectors under a plain complex128 operator on the host."""
    ths, rs = [], []
    for v in vecs.to("cpu", torch.complex128):
        v = v / torch.sqrt(linalg.norm2(v))
        av = op(v)
        th = float(linalg.dot(v, av).real)
        ths.append(th)
        rs.append(float(torch.sqrt(linalg.norm2(av - th * v))))
    return np.array(ths), np.array(rs)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["plain", "naik_links"])
def test_stag_eigs_on_card(cuda_device, kind):
    u = _links()
    if kind == "plain":
        counter = sh.dslash_stag8
        s64 = st.new_stag_eo(LAT, u)
        op = lambda v: st.d2dd(s64, v, parity=0)      # noqa: E731
        args = dict(u=u.to(cuda_device, torch.complex64))
        host = dict(u=u)
    else:
        counter = sh.dslash_hisq16
        fat, long = fat7.hisq_links_lowmem(LAT, st.phase_links(LAT, u))
        s64 = st.new_stag3_eo(LAT, fat, long)
        op = lambda v: st.d2dd3(s64, v, parity=0)     # noqa: E731
        args = dict(u=None, links=(fat.to(cuda_device, torch.complex64),
                                   long.to(cuda_device, torch.complex64)))
        host = dict(u=None, links=(fat, long))
    before = counter.launches
    res = hisqev.stag_eigs(LAT, n=NEV, tol=1e-6, **args)
    assert counter.launches > before
    assert res.vecs.device.type == cuda_device.type
    assert res.vecs.shape == (NEV, 3, 8, 8, 8, 4)
    ref = hisqev.stag_eigs(LAT, n=NEV, tol=1e-10, **host)
    th, rs = _rayleigh(op, res.vecs)
    # the card's eigenvalues are its vectors' Rayleigh quotients, and
    # both match the host's complex128 eigensolve
    assert np.abs(th - res.evals).max() < 1e-5 * ref.evals.max()
    assert np.abs(res.evals - ref.evals).max() < 1e-4 * ref.evals.max()
    assert rs.max() < 2e-3 and np.allclose(rs, res.resids, atol=1e-4)


@pytest.mark.gpu
def test_svd_stag_on_card(cuda_device):
    u = _links()
    before = sh.dslash_stag8.launches
    sig, uo, ve, info = svdlanczos.svd_stag(
        LAT, u.to(cuda_device, torch.complex64), 4, m=24, tol=1e-6)
    assert sh.dslash_stag8.launches > before
    assert uo.device.type == cuda_device.type
    assert ve.shape == (4, 3, 8, 8, 8, 4)
    ref = hisqev.stag_eigs(LAT, u, 4, tol=1e-10)
    assert np.abs(sig ** 2 - ref.evals).max() < 1e-4 * ref.evals.max()
    # D_oe v_i = sigma_i u_i, on the host in complex128
    s64 = st.new_stag_eo(LAT, u)
    for i in range(4):
        dv = st.dslash_eo(s64, ve[i].to("cpu", torch.complex128), 1)
        err = dv - sig[i] * uo[i].to("cpu", torch.complex128)
        assert float(torch.sqrt(linalg.norm2(err))) < 1e-3


@pytest.mark.gpu
def test_deflated_cg_and_pbp_on_card(cuda_device):
    u = _links()
    m = 0.05
    uc = u.to(cuda_device, torch.complex64)
    res = hisqev.stag_eigs(LAT, uc, NEV, tol=1e-6)
    evals, vecs = hisqev.deflation_basis(res, m)
    op, example = hisqev._normal_op(LAT, uc, "pppa", False, m=m)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    b = torch.randn(example.shape, dtype=example.dtype, generator=gen,
                    device=cuda_device)
    before = sh.dslash_stag8.launches
    x, stats = deflated_cg(op, b, evals, sf.to_fast(vecs, LAT),
                           r2req=1e-10, maxits=3000, restarts=3)
    assert sh.dslash_stag8.launches > before
    s64 = st.new_stag_eo(LAT, u)
    x64 = sf.from_fast(x, LAT).to("cpu", torch.complex128)
    b64 = sf.from_fast(b, LAT).to("cpu", torch.complex128)
    assert float(linalg.norm2(st.d2ee(s64, x64, m) - b64)
                 / linalg.norm2(b64)) < 1e-9

    noise = condensate.NOISES["z4"](gen, LAT.vector_shape(), torch.complex64)
    before = sh.dslash_stag8.launches
    card = condensate.pbp_staggered(None, LAT, uc, m, dilution="eo",
                                    params=SolverParams(r2req=1e-10,
                                                        maxits=3000),
                                    noises=noise[None])
    assert sh.dslash_stag8.launches > before
    host = condensate.pbp_staggered(
        None, LAT, u, m, dilution="eo",
        params=SolverParams(r2req=1e-22, maxits=3000),
        noises=noise.to("cpu", torch.complex128)[None])
    assert abs(card - host) < 1e-5 * abs(host)
