"""Layout and shift parity of qex_tpu_torch against qex_tpu: exact
equality on a 4x4x4x8 lattice (pure data movement, no arithmetic)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import ginibre, n, single_threaded, t  # noqa: F401
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.ops import eo as jeo
from qex_tpu.ops import shifts as jshifts
from qex_tpu.physics import stag_fast as jsf
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import eo, shifts
from qex_tpu_torch.physics import stag_fast as sf

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (4, 4, 4, 8)
LAT, JLAT = Lattice(DIMS), JLattice(DIMS)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(2024)
    full = ginibre(rng, (3,) + DIMS)
    half = ginibre(rng, (3,) + DIMS[:3] + (DIMS[3] // 2,))
    return full, half


def test_pack_unpack_exact(fields):
    full, _ = fields
    je, jo = jeo.pack(jnp.asarray(full), 4)
    te, to = eo.pack(t(full), 4)
    assert np.array_equal(n(te), np.asarray(je))
    assert np.array_equal(n(to), np.asarray(jo))
    assert np.array_equal(n(eo.unpack(te, to, 4)), full)


@pytest.mark.parametrize("dist", [1, 2, 3])
@pytest.mark.parametrize("mu", [0, 1, 2, 3])
def test_shift_eo_exact(fields, mu, dist):
    _, half = fields
    for sign in (+1, -1):
        for parity in (0, 1):
            ref = jeo.shift_eo(jnp.asarray(half), mu, sign, parity, 4, dist)
            got = eo.shift_eo(t(half), mu, sign, parity, 4, dist)
            assert np.array_equal(n(got), np.asarray(ref)), (sign, parity)


def test_fast_layout_roundtrip_exact(fields):
    _, half = fields
    ref = jsf.to_fast(jnp.asarray(half), JLAT)
    got = sf.to_fast(t(half), LAT)
    assert got.is_contiguous()
    assert np.array_equal(n(got), np.asarray(ref))
    assert np.array_equal(n(sf.from_fast(got, LAT)), half)


@pytest.mark.parametrize("mu", [0, 1, 2, 3])
def test_shift_fast_exact(fields, mu):
    _, half = fields
    hf = np.asarray(jsf.to_fast(jnp.asarray(half), JLAT))
    for sign in (+1, -1):
        for parity in (0, 1):
            ref = jsf.shift_fast(jnp.asarray(hf), mu, sign, parity, JLAT)
            got = sf.shift_fast(t(hf), mu, sign, parity, LAT)
            assert np.array_equal(n(got), np.asarray(ref)), (sign, parity)


@pytest.mark.parametrize("mu", [0, 1, 2, 3])
def test_shift_exact(fields, mu):
    full, _ = fields
    for sign in (+1, -1):
        for dist in (1, 3):
            ref = jshifts.shift(jnp.asarray(full), mu, sign, 4, dist)
            got = shifts.shift(t(full), mu, sign, 4, dist)
            assert np.array_equal(n(got), np.asarray(ref)), (sign, dist)


def test_package_imports_no_jax():
    """Every module of the port imports without loading jax or
    qex_tpu."""
    mods = sorted(
        "qex_tpu_torch." + ".".join(p.relative_to(REPO / "qex_tpu_torch")
                                    .with_suffix("").parts)
        for p in (REPO / "qex_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    assert {"qex_tpu_torch.gauge.smear", "qex_tpu_torch.apps.staghmc_spv",
            "qex_tpu_torch.utils.config", "qex_tpu_torch.io.checkpoint",
            "qex_tpu_torch.device", "qex_tpu_torch.physics.wilson_pallas",
            "qex_tpu_torch.mg.kcycle",
            "qex_tpu_torch.observables.mesons", "qex_tpu_torch.rng",
            "qex_tpu_torch.io.lime", "qex_tpu_torch.utils.params",
            "qex_tpu_torch.eigens.lanczos", "qex_tpu_torch.eigens.chebyshev",
            "qex_tpu_torch.eigens.refine", "qex_tpu_torch.eigens.svdlanczos",
            "qex_tpu_torch.eigens.hisqev", "qex_tpu_torch.solvers.deflate",
            "qex_tpu_torch.observables.condensate",
            "qex_tpu_torch.apps.eigs", "qex_tpu_torch.apps.measure",
            "qex_tpu_torch.models.xy", "qex_tpu_torch.models.clock",
            "qex_tpu_torch.models.u1", "qex_tpu_torch.hmc.qnhmc",
            "qex_tpu_torch.hmc.nambu", "qex_tpu_torch.gauge.fix",
            "qex_tpu_torch.utils.numdiff", "qex_tpu_torch.utils.spline",
            "qex_tpu_torch.apps.xy_mc", "qex_tpu_torch.apps.u1_mc",
            "qex_tpu_torch.apps.u1_qn_hmc", "qex_tpu_torch.apps.nambu_hmc",
            "qex_tpu_torch.apps.rahmc", "qex_tpu_torch.io.milc",
            "qex_tpu_torch.io.modfile", "qex_tpu_torch.io.timeslice",
            "qex_tpu_torch.io.native", "qex_tpu_torch.io.pario",
            "qex_tpu_torch.apps.lat_util", "qex_tpu_torch.utils.profile",
            "qex_tpu_torch.parallel.mesh", "qex_tpu_torch.parallel.halo",
            "qex_tpu_torch.parallel.distributed",
            "qex_tpu_torch.parallel.dryrun",
            "qex_tpu_torch.physics.stag_shard", "qex_tpu_torch.bench.suite",
            "qex_tpu_torch.physics.wilson_shard",
            "qex_tpu_torch.examples.ex0", "qex_tpu_torch.examples.ex1",
            "qex_tpu_torch.examples.harmonic"} <= set(mods)
    code = ("import sys, importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'qex_tpu.'))]; "
            "print(bad); sys.exit(1 if bad or 'jax' in sys.modules else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_the_card():
    """Without a device argument the entry points run on the CUDA card,
    and on a host without one they raise instead of building CPU
    tensors."""
    from qex_tpu_torch import convert
    from qex_tpu_torch.bench import stag_generations
    from qex_tpu_torch.mg import coarse, twogrid
    from qex_tpu_torch.observables import condensate, mesons
    from qex_tpu_torch.ops import group
    from qex_tpu_torch.physics import stag_pallas, stag_pallas2, stag_pallas3
    from qex_tpu_torch.physics import staggered as st
    u = np.zeros((4, 3, 3) + DIMS, complex)
    lat2 = type(LAT)((2, 2, 2, 2))
    g_half = t(np.zeros((4, 3, 3) + DIMS[:3] + (DIMS[3] // 2,), complex))
    s_host = sf.new_fast(st.StaggeredEO(LAT, g_half, g_half))
    builders = [
        lambda **kw: group.unit_gauge(LAT, **kw),
        lambda **kw: convert.gauge_from_reference(u, **kw),
        lambda **kw: st.staggered_phases(LAT, **kw),
        lambda **kw: st.bc_signs(LAT, **kw),
        lambda **kw: twogrid.mg_setup(lat2, lambda v: v, nvec=1,
                                      relax_iters=1, **kw).w,
        lambda **kw: coarse.assemble_stencil(lambda v: v, 1, (2, 2),
                                             torch.complex64, **kw).diag,
        lambda **kw: stag_pallas.new_pallas(s_host, **kw).g_e,
        lambda **kw: stag_pallas2.new_pallas2(s_host, **kw).g_e,
        lambda **kw: stag_pallas3.new_pallas3(s_host, **kw).l_e,
        lambda **kw: stag_generations.setup(lat2, **kw)[1],
        lambda **kw: mesons.point_source(LAT, 0, **kw),
        lambda **kw: mesons.wall_source(LAT, 1, **kw),
        lambda **kw: mesons.momentum_phase(LAT, (1, 0, 0), **kw),
        lambda **kw: condensate.dilution_masks(LAT, "eo", **kw)[0],
    ]
    for build in builders:
        if torch.cuda.is_available():
            assert build().is_cuda
            continue
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        assert build(device="cpu").device.type == "cpu"
