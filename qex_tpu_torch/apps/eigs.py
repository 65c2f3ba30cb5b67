"""Staggered eigensolver program: lowest-N eigenpairs on a configuration
(port of ``qex_tpu.apps.eigs``).

Usage:
    python -m qex_tpu_torch.apps.eigs -gauge:cfg.scidac -nev:8 \
        -mass:0.0 -bc:pppa [-naik:true] [-degree:24] [-tol:1e-8] \
        [-refine:0] [-save:eigs.npz] [-deflate:true] [-cpu:true]
    (no -gauge -> hot start at -lat:X,Y,Z,T from -seed; .npz checkpoints
    are read at -lat)

It runs on the CUDA card in complex64 (the eigensolve on kernel B1, or
B2 with -naik:true); ``-cpu:true`` runs on the host in complex128.
Prints ``EIGEN i ev sv resid`` lines and ``EIGENinfo`` (hisqev report
style), ``EIGENshifted`` lines for -mass, and a ``DEFLATE`` line: plain
CG against CG deflated by the computed basis on the shifted operator,
with the ``deflation_pays`` decision.
"""

from __future__ import annotations

import sys
import time

import torch


def device_and_dtype(use_cpu: bool, prog: str):
    """(device, dtype) of an app run: the card in complex64, or the
    host in complex128 with -cpu:true; None where there is no card."""
    if use_cpu:
        return torch.device("cpu"), torch.complex128
    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device; pass -cpu:true to run on the host",
              file=sys.stderr)
        return None
    return torch.device("cuda"), torch.complex64


def gauge_field(gauge_file: str, lat_dims, seed: int, dtype, device):
    """(Lattice, links) from a SciDAC/LIME file (its own dims), an .npz
    checkpoint (at ``lat_dims``), or a hot start at ``lat_dims``:
    expm(0.5 random_tah) per link from a generator seeded by ``seed``."""
    from qex_tpu_torch.apps.staghmc_spv import hot_start
    from qex_tpu_torch.io import checkpoint as ckpt
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.utils.params import Params, default_setup
    if gauge_file and not gauge_file.endswith(".npz"):
        lat, u = default_setup(Params(argv=[gauge_file]), device)
        return lat, u.to(dtype)
    lat = Lattice(tuple(lat_dims))
    if gauge_file:
        return lat, ckpt.load_checkpoint(gauge_file, lat, dtype, device)[0]
    return lat, hot_start(lat, dtype, device, seed, scale=0.5)


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    from qex_tpu_torch.utils.params import Params
    prm = Params(argv)
    gauge_file = prm.str_param("gauge", "", "gauge file (.scidac/.npz)")
    lat_dims = prm.int_seq_param("lat", [8, 8, 8, 8],
                                 "lattice (when no gauge file)")
    nev = prm.int_param("nev", 8, "number of lowest eigenpairs")
    mass = prm.float_param("mass", 0.0, "report shift m (evals + m^2)")
    bc = prm.str_param("bc", "pppa", "fermion boundary conditions")
    naik = prm.bool_param("naik", False, "fat+naik (HISQ) operator")
    degree = prm.int_param("degree", 24, "Chebyshev filter degree")
    tol = prm.float_param("tol", 1e-8, "eigenpair residual tolerance")
    seed = prm.int_param("seed", 987654321, "RNG seed (hot start)")
    save = prm.str_param("save", "", "save eigenpairs to .npz")
    deflate_demo = prm.bool_param("deflate", True,
                                  "demo deflated vs plain CG")
    refine_iters = prm.int_param("refine", 0,
                                 "deflated inverse-iteration polish "
                                 "passes after the Lanczos")
    use_cpu = prm.bool_param("cpu", False, "run on the host")
    dd = device_and_dtype(use_cpu, "eigs")
    if dd is None:
        return 2
    device, dtype = dd

    import numpy as np

    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.eigens import hisqev

    lat, u = gauge_field(gauge_file, lat_dims, seed, dtype, device)
    print(f"# eigs: {lat.dims} nev={nev} naik={naik} bc={bc} "
          f"degree={degree} tol={tol:g} device={device}")
    t0 = time.perf_counter()
    with torch.no_grad():
        res = hisqev.stag_eigs(lat, u, nev, bc=bc, naik=naik,
                               degree=degree, tol=tol, verbose=True,
                               refine_iters=refine_iters)
    print(f"# eigensolve: {time.perf_counter() - t0:.2f} s, "
          f"{res.info['matvecs_A']} A-matvecs")
    if mass != 0.0:
        for i, ev in enumerate(res.evals + mass * mass):
            print(f"EIGENshifted {i} ev {ev:.12g} (m={mass})")
    if save:
        np.savez(save, evals=res.evals, svals=res.svals, resids=res.resids,
                 vecs=res.vecs.cpu().numpy())
        print(f"# saved {nev} eigenpairs -> {save}")
    if deflate_demo:
        with torch.no_grad():
            deflate_line(lat, u, res, bc, naik, mass if mass != 0.0 else 0.05,
                         seed, nev)
    return 0


def deflate_line(lat, u, res, bc: str, naik: bool, m_d: float, seed: int,
                 nev: int) -> None:
    """Print the DEFLATE line: plain restarted CG against deflated CG on
    m^2 - D_eo D_oe for a gaussian right-hand side from ``seed + 1``."""
    from qex_tpu_torch.eigens import hisqev
    from qex_tpu_torch.ops import linalg
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.rng import gaussian_complex, seeded_generator
    from qex_tpu_torch.solvers import cg as cgmod
    from qex_tpu_torch.solvers.deflate import deflated_cg, deflation_pays
    evals, vecs = hisqev.deflation_basis(res, m_d)
    op, example = hisqev._normal_op(lat, u, bc, naik, m=m_d)
    b = gaussian_complex(seeded_generator(example.device, seed + 1),
                         example.shape, example.dtype)
    x0, s0 = cgmod.cg_solve_restarted(op, b, r2req=1e-10, maxits=2000,
                                      restarts=2)
    x1, s1 = deflated_cg(op, b, evals, sf.to_fast(vecs, lat), r2req=1e-10,
                         maxits=2000, restarts=2)
    b2 = float(linalg.norm2(b))
    r0 = float(linalg.norm2(op(x0) - b)) / b2
    r1 = float(linalg.norm2(op(x1) - b)) / b2
    # the criterion reads the unshifted band
    pays = deflation_pays(res.evals, m_d)
    print(f"DEFLATE m={m_d}: plain CG its={s0.iterations} "
          f"rel_r2={r0:.2e} | deflated({nev}) its={s1.iterations} "
          f"rel_r2={r1:.2e} | auto-criterion: {'use' if pays else 'skip'} "
          f"(stag_solve gates on lambda_low vs m^2)")


if __name__ == "__main__":
    sys.exit(main())
