"""Measurement program: observables on stored gauge configurations (port
of ``qex_tpu.apps.measure``).

Usage:
    python -m qex_tpu_torch.apps.measure -gauge:cfg.scidac \
        -mass:0.1 -bc:pppa -mesons:true -pbp:true -noise:z4 \
        -nNoise:4 -dilution:eo [-wilsonMesons:true] [-cpu:true]
    (also -gauge:cfg.npz checkpoints at -lat; no -gauge -> hot start)

Prints ``MEASplaq``, ``MEASploop``, ``MEAStopo`` (clover charge), then
``MEASmeson`` (8 local staggered channels, 3 point-source solves on
kernel B1), ``MEASpbp`` (the stochastic condensate, solves on B1) and
``MEASwmeson`` (9 Wilson channels from 12 eo point-source solves on
kernel B3).  It runs on the CUDA card in complex64; ``-cpu:true`` runs
on the host in complex128.
"""

from __future__ import annotations

import sys
import time

import torch


def main(argv=None) -> int:
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    from qex_tpu_torch.apps.eigs import device_and_dtype, gauge_field
    from qex_tpu_torch.utils.params import Params
    prm = Params(argv)
    gauge_file = prm.str_param("gauge", "", "gauge file (.scidac/.npz)")
    lat_dims = prm.int_seq_param("lat", [8, 8, 8, 8],
                                 "lattice (when no gauge file)")
    mass = prm.float_param("mass", 0.1, "valence quark mass")
    bc = prm.str_param("bc", "pppa", "fermion boundary conditions")
    do_mesons = prm.bool_param("mesons", False, "meson correlators")
    do_pbp = prm.bool_param("pbp", False, "chiral condensate")
    noise = prm.str_param("noise", "z4", "pbp noise: z4|z2|u1|gauss")
    n_noise = prm.int_param("nNoise", 2, "noise vectors")
    dilution = prm.str_param("dilution", "none",
                             "pbp dilution: none|eo|corner3d")
    tol = prm.float_param("tol", 1e-12, "solver tolerance")
    seed = prm.int_param("seed", 987654321, "RNG seed")
    do_wilson = prm.bool_param("wilsonMesons", False,
                               "Wilson meson correlators (12 solves)")
    use_cpu = prm.bool_param("cpu", False, "run on the host")
    dd = device_and_dtype(use_cpu, "measure")
    if dd is None:
        return 2
    device, dtype = dd

    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.observables import condensate, mesons
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.rng import seeded_generator
    from qex_tpu_torch.solvers.base import SolverParams

    lat, u = gauge_field(gauge_file, lat_dims, seed, dtype, device)
    print(f"# measure: {lat.dims} mass={mass} bc={bc} device={device}")
    with torch.no_grad():
        pl = complex(loops.polyakov_loop(lat, u))
        print(f"MEASplaq {float(loops.plaquette(lat, u)):.12g}")
        print(f"MEASploop {pl.real:.10g} {pl.imag:.10g}")
        print(f"MEAStopo {float(loops.topo_charge_clover(lat, u)):.8g}")

        sp = SolverParams(r2req=tol, maxits=10000, restarts=3)
        if do_mesons:
            t0 = time.time()
            corr = mesons.stag_meson_correlators(
                lat, u, mass, bc=bc, channels=tuple(mesons.STAG_CHANNELS),
                params=sp)
            for ch, c in corr.items():
                print(f"MEASmeson {ch} "
                      + " ".join(f"{float(x):.10g}" for x in c.cpu()))
            print(f"# mesons in {time.time() - t0:.1f} s")
        if do_pbp:
            t0 = time.time()
            v = condensate.pbp_staggered(
                seeded_generator(device, seed + 1), lat, u, mass, bc=bc,
                noise=noise, n_noise=n_noise, dilution=dilution, params=sp)
            print(f"MEASpbp {v:.10g}")
            print(f"# pbp in {time.time() - t0:.1f} s")
        if do_wilson:
            t0 = time.time()
            w = wl.new_wilson_eo(lat, u, mass, bc=bc)
            cols = []
            for s0 in range(4):
                for c0 in range(lat.nc):
                    src = torch.zeros(lat.dirac_shape(), dtype=dtype,
                                      device=device)
                    src[(s0, c0) + (0,) * lat.nd] = 1.0
                    cols.append(wl.solve_eo(w, src, sp)[0])
            props = torch.stack(cols).reshape((4, lat.nc) + cols[0].shape)
            del cols
            corr = mesons.wilson_mesons_from_prop(lat, props,
                                                  mesons.WILSON_CHANNELS)
            for ch, c in corr.items():
                print(f"MEASwmeson {ch} "
                      + " ".join(f"{float(x):.10g}" for x in c.cpu()))
            print(f"# wilson mesons in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
