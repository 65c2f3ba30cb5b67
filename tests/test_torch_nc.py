"""Parity of qex_tpu_torch against qex_tpu at Nc = 1, 2 and 4 (the JAX
package's tests/test_multi_nc.py and tests/test_nc_generic.py sizes):
the plaquette, the Wilson action and its hand-staple force, ``expm``,
``gauge_update_u``, ``det`` and ``project_su`` on numpy-seeded 4^4
fields, and the staggered solve at Nc = 2, all in complex128.  Each JAX
reference is one program, compiled once.  The card's hop kernels are
3x3 only: tests/test_torch_kernels_gpu.py pins their refusal at Nc = 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import compile_ref, ginibre, n, rel, single_threaded, t
from qex_tpu.gauge import action as jga
from qex_tpu.gauge import loops as jloops
from qex_tpu.hmc import hmc as jhmc
from qex_tpu.lattice import Lattice as JLattice
from qex_tpu.ops import linalg as jlinalg
from qex_tpu.physics import stag_solve as jss
from qex_tpu.physics import staggered as jst
from qex_tpu.solvers.base import SolverParams as JSolverParams
from qex_tpu_torch.gauge import action as ga
from qex_tpu_torch.gauge import loops
from qex_tpu_torch.hmc import hmc
from qex_tpu_torch.lattice import Lattice
from qex_tpu_torch.ops import group, linalg
from qex_tpu_torch.physics import stag_solve, staggered as st
from qex_tpu_torch.solvers.base import SolverParams

pytestmark = pytest.mark.usefixtures("single_threaded")

DIMS = (4, 4, 4, 4)
BETA = 5.5
EPS = 0.3
TOL = 1e-12


def _tah(a: np.ndarray) -> np.ndarray:
    """Traceless anti-hermitian part per site of (nc, nc, ...) arrays."""
    ah = 0.5 * (a - np.conj(np.swapaxes(a, 0, 1)))
    nc = a.shape[0]
    tr = np.trace(ah, axis1=0, axis2=1) / nc
    return ah - np.einsum("ij,...->ij...", np.eye(nc), tr)


def _fields(nc: int, seed: int):
    """Links near the identity (U(1) phases at Nc = 1), a TAH momentum
    field (anti-hermitian phases at Nc = 1), and a non-unitary field for
    the projection."""
    rng = np.random.default_rng(seed)
    shape = (4, nc, nc) + DIMS
    if nc == 1:
        u = np.exp(1j * rng.uniform(-np.pi, np.pi, shape))
        p = 1j * rng.normal(size=shape)
    else:
        u = np.stack([_expm_np(0.6 * _tah(ginibre(rng, shape[1:])))
                      for _ in range(4)])
        p = np.stack([_tah(ginibre(rng, shape[1:])) for _ in range(4)])
    x = u + 0.2 * ginibre(rng, shape)
    return u, p, x


def _expm_np(a: np.ndarray) -> np.ndarray:
    """Per-site exponential of (nc, nc, ...) by eigendecomposition (the
    argument is anti-hermitian, so normal)."""
    m = np.moveaxis(a, (0, 1), (-2, -1))
    w, v = np.linalg.eig(m)
    e = np.einsum("...ij,...j,...kj->...ik", v, np.exp(w),
                  np.linalg.inv(v).swapaxes(-1, -2))
    return np.moveaxis(e, (-2, -1), (0, 1))


def _jax_gauge(nc: int):
    jlat = JLattice(DIMS, nc=nc)
    c = jga.wilson(BETA)

    def ref(u, p, x):
        return (jloops.plaquette(jlat, u), jga.full_action(c, jlat, u),
                jga.gauge_force(c, jlat, u),
                jnp.stack([jlinalg.expm(p[mu]) for mu in range(4)]),
                jhmc.gauge_update_u(u, p, EPS),
                jnp.stack([jlinalg.det(u[mu]) for mu in range(4)]),
                jnp.stack([jlinalg.project_su(x[mu]) for mu in range(4)]))

    return ref


@pytest.mark.parametrize("nc", [1, 2, 4])
def test_gauge_sector(nc):
    u, p, x = _fields(nc, 10 + nc)
    refs = [np.asarray(r) for r in
            compile_ref(_jax_gauge(nc), u, p, x)(u, p, x)]
    lat = Lattice(DIMS, nc=nc)
    c = ga.wilson(BETA)
    tu, tp, tx = t(u), t(p), t(x)
    got = [loops.plaquette(lat, tu), ga.full_action(c, lat, tu),
           ga.gauge_force(c, lat, tu),
           torch.stack([linalg.expm(tp[mu]) for mu in range(4)]),
           hmc.gauge_update_u(tu, tp, EPS),
           torch.stack([linalg.det(tu[mu]) for mu in range(4)]),
           torch.stack([linalg.project_su(tx[mu]) for mu in range(4)])]
    names = ("plaquette", "action", "force", "expm", "gauge_update_u",
             "det", "project_su")
    for name, g, r in zip(names, got, refs):
        assert rel(n(g), r) < TOL, (name, rel(n(g), r))
    # the projection lands in SU(nc)
    chk = group.check_su(torch.movedim(got[-1], 0, -1).reshape(
        nc, nc, -1))
    assert float(chk["unitarity_dev2_per_site"]) < 1e-20


def test_staggered_solve_nc2():
    """D(m) x = b at Nc = 2 on the host: the port's solution against
    JAX's, and the true residual of the full-lattice operator."""
    u, _, _ = _fields(2, 40)
    rng = np.random.default_rng(41)
    b = ginibre(rng, (2,) + DIMS)
    m = 0.2
    jlat, lat = JLattice(DIMS, nc=2), Lattice(DIMS, nc=2)

    def ref(u, b):
        s = jst.new_stag_eo(jlat, u, bc="pppp")
        return jss.solve(s, b, m, JSolverParams(r2req=1e-20))[0]

    x_ref = np.asarray(compile_ref(ref, u, b)(u, b))
    s = st.new_stag_eo(lat, t(u), bc="pppp")
    x, _ = stag_solve.solve(s, t(b), m, SolverParams(r2req=1e-20))
    assert rel(n(x), x_ref) < 1e-10
    r = st.d_full(lat, st.phase_links(lat, t(u), "pppp"), x, m) - t(b)
    assert float(linalg.norm2(r) / linalg.norm2(t(b))) < 1e-18
