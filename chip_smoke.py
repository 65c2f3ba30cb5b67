#!/usr/bin/env python3
"""Drive the qex_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Phases, each printed as one JSON line:
  1. device: the card's name and power limit (nvidia-smi), the kernel build;
  2. kernel: the 8-term staggered CUDA kernel with float32 links (B1) and
     with bfloat16 links (B1b) against their plain torch version at 24^4
     and 8x4x4x8, and the 16-term HISQ kernel with float32 (B2) and
     bfloat16 links (B2b) at 24^4, 8x4x4x8, 4^4 and 6x3x5x4, with times
     (CUDA-graph replay, and eager launches beside), GB/s (624, 336,
     1,200 and 624 B/site: each input read once, the output written
     once), bounds and the share of this card's measured stream
     bandwidth;
  3. solve: stag_solve.solve at 24^4, m=0.05, r2req 1e-10 (complex64),
     with float32 links and sloppy (bf16 inner iterations, float32
     true-residual restarts);
  4. hmc: two trajectories of LatticeFieldTheory.hmc_step at 24^4, the
     BASELINE config-4 action without smearing (Wilson beta=7.0 + one
     staggered fermion m=0.05 + one Pauli-Villars boson m=0.5);
  5. ab: one 8^4 trajectory of that action with identical injected draws,
     once through the kernel on the card and once through the plain
     operator (CPU tensors take the plain fast-layout operator);
  6. hmc_smeared: config 4 as it is run, nHYP (0.4, 0.5, 0.5) on the
     matter links, at 24^4: two trajectories, then one more with the time
     split into smear forward, smear pullback, solves and the rest;
  7. app: the production app (qex_tpu_torch.apps.staghmc_spv.main) on the
     committed config-4 deck with sloppy solves, two trajectories with a
     checkpoint after each, then a resume from the first checkpoint that
     must repeat the second trajectory;
  8. ab_smeared: phase 5 for the smeared action with sloppy solves, from
     smoother links (see AB_SMEARED_START);
  9. hisq_solve: BASELINE config 5's solve at 32^3x64: HISQ fattening,
     HisqFermion.solve_multi at masses 0.05-0.4 on B2 with each mass's
     true residual, the sloppy solve at m=0.05 (B2b inner iterations, B2
     true residuals), and B2/B2b timed at that volume (graph replay and
     eager launches);
 10. hmc_hisq: two trajectories of a HISQ theory (Wilson beta=7.0 + one
     HISQ fermion m=0.05) at 24^4 from smoother links (see HISQ_START),
     the second split into fattening forward, fattening pullback, solves
     and the rest;
 11. ab_hisq: phase 5 for the HISQ theory at 8^4 from those links;
 12. wilson_kernel: the Wilson hop kernel with float32 (B3) and bfloat16
     links (B3b) against its plain twin, both parities, m_ee_w and
     m_ee_dag_w, at 6x4x4x8, 4x4x8x8, 24^3x32 and 32^3x64, timed at the
     last two (768 and 480 B/site, 1344 flop/site);
 13. wilson_solve: exp_wilson.py's eo CGNE solve at 24^3x32, m=0.1, bc
     pppa, r2req 1e-12, float32 links and sloppy;
 14. wilson_mesons: the 12 point-source propagators of the measure app
     through solve_eo at 24^3x32 and all nine Wilson meson channels;
 15. wilson_mg: exp_mg_ab.py's composition (m=0.005, bc pppp, r2req
     1e-8) at 8^3x16 and 16^3x32: CGNE through B3 against the K-cycle
     multigrid (setup, warm solve on the reused hierarchy, break-even);
 16. stag_generations_kernel: the older staggered kernels (v1 B4/B4b, v2
     B5, v3 B6/B6b, v4 B7/B7b with and without compute_only, the split
     modes B8) against their plain twins, both parities, with the
     d2ee/d2dd of each, at 8x4x4x8 and 32^4 (v1 also at 6x3x5x4); at
     32^4 each generation against the 8-term kernel B1/B1b on the same
     links, and B8's full mode against 1/2 (F - B) of the v3 links;
 17. stag_generations_time: the generation benchmark's A/B at 32^4
     (qex_tpu_torch.bench.stag_generations.ab, every instance, B1/B1b
     beside them), then each instance timed over 200 launches against
     its plain twin at 24^4 and 32^4;
 18. stag_generations_cg: solvers.cg.cg_solve at 32^4, m=0.1, r2req
     1e-10, through d2ee of v1, v2, v3, v4 and B1;
 then the pure-gauge path, which launches none of B1-B8:
 19. puregauge_accept: the chain of exp_accept_cpu.py through
     hmc.hmc_step at 8^3x16 (Wilson beta 6.0, 2MN, tau 1, cold start,
     complex64 fields, float64 H): 30 forced-accept warm-ups at 10
     steps, 5 Metropolis trajectories at 20 steps, then ACCEPT_N_MEAS
     measured ones; its plaquette mean must lie within ACCEPT_Z combined
     blocked-jackknife errors of ACCEPT_CPU.json's float64 chain, its
     <exp(-dH)> within ACCEPT_Z blocked-jackknife errors of 1, and its
     acceptance be at least ACCEPT_MIN;
 19a. northstar_accept: in a process of its own, started here and
     waited for after phase 41 (the chain is bound by host launches and
     holds a few MB of the card, so phases 20-41 run beside it), the
     production app staghmc_spv (complex64, the
     deck's own seeds) on the committed deck northstar_accept.xml (the
     north-star composition of config 4 at 4^4, tuned for acceptance)
     for its warm-up and NS_N_MEAS measured trajectories with the deck's
     -pbp_freq; the deck's sha256 must equal ACCEPT_NS_CPU.json's (the
     JAX app's complex128 chain on the host, exp_accept_ns_cpu.py), the
     plaquette mean and MEASpbp's mean in each Z_3 sector class of the
     Polyakov loop (real, complex) lie within 3 combined blocked-
     jackknife errors of that chain's, <exp(-dH)> within 3 errors of 1, the
     acceptance be at least 0.5, on 20 blocks of at least 2 tau_int of
     the reference's plaquette (the condensate on blocks of 2 tau_int of
     its own; qex_tpu_torch.utils.chain.gate; the card's own tau_int
     printed beside them); it launches B1 and no
     other kernel, and no plain twin; it prints the distance from the
     quenched control, s/trajectory, B1 launches per trajectory and peak
     memory;
 20. puregauge_config3: BASELINE config 3 (16^3x32, Wilson beta 6.0,
     2MN, tau 1): 30 forced warm-ups at 10 steps, then 4 Metropolis
     trajectories at each of 20, 24, 32 and 48 steps, with dH, the
     acceptance, s/trajectory and peak memory per step count, each
     beside the dH of a complex128 trajectory from the same (u, p); and
     the time and peak memory of one Symanzik (rect) force there;
 21. flow: BASELINE config 2, 50 Wilson-flow RK3 steps of 0.02 at 16^4
     from expm(0.3 tah) links, measured once at the end; and a 5-step
     4^4 flow on the card against the same flow on the host in
     complex128 (links, t^2 E_clover and t^2 E_plaq to TOL_FLOW);
 22. apps_gauge: puregauge_hmc (8^4 Symanzik, PG_APP_NTRAJ trajectories
     of which the first PG_APP_WARMUP are forced, --save; at least one
     after the warm-up must be accepted),
     gauge_flow --load of that checkpoint with both committed 8^4 flow
     decks, and staghmc_spv for one trajectory on a copy of the config-4
     deck at 8^4 with a rect gauge action and the FGI gauge integrator;
 then the rest of the staggered catalogue:
 23. stag_multi: stag_solve.solve_multi at 32^4 on Haar links, r2req
     1e-10, on exp_msloppy.py's light masses (0.025-0.2: the float32
     refinement on B1) and heavy masses (0.4-1.0, sloppy: a joint pass
     on B1b, refinement on B1), each mass's true residual within
     TOL_MULTI; solve_batched with 3 right-hand sides at 24^4, m=0.05,
     each within TOL_RES;
 24. rhmc: the app staghmc_spv on the config-4 deck with -nf=2 (one
     rooted fermion, nHYP) at 24^4, RHMC_NTRAJ trajectories with the
     split into smear forward, smear pullback, solves and the rest, the
     rational approximations' degree and error, the multishift's
     iterations and its smallest shift's true residual, also on rough
     unsmeared links;
 25. ab_rooted: phase 5 for config 4 with the rooted fermion (nHYP,
     from AB_SMEARED_START links);
 26. hasenbusch: the app mcmc_hmc on the committed deck
     hasenbusch_24.json (config 4 at 24^4 with Hasenbusch mass 0.2),
     2 trajectories; then one 24^4 trajectory of the HISQ theory of
     phase 10 with Hasenbusch mass 0.4, from HISQ_START links;
 27. ab_hisq_hasenbusch: phase 5 for that HISQ theory at 8^4;
 28. northstar32: B1 against its plain twin at 32^3x64 (TOL_KERNEL),
     then one hmc_step of config 4 as run (nHYP, exp_northstar32.py
     :45-56) at that volume from a cold start, with the split and the
     peak memory;
 then the measurement tier:
 29. eigs_hisq: exp_eigs24.py's run at 24^3x48 (expm(0.7 tah) links,
     HISQ fattening): the 16 lowest eigenpairs of the HISQ normal
     operator on B2 (degree 30, tol 1e-5, 25 restart cycles) with their
     true residuals (at most EIGS_MAX_RESID, as reported and recomputed
     through B2's plain twin in complex128) and each eigenvalue against
     its vector's Rayleigh quotient through that twin (EIGS_RQ_REL plus
     the float32 rounding floor); B2 against its plain twin on these
     links (TOL_KERNEL); two deflated inverse-iteration passes on
     that basis (their largest residual no larger); CG against deflated
     CG at m=0.05, r2req 1e-10, each to a true r^2 <= 10 x r2req, with
     deflation_pays' decision;
 30. eigs_stag: at 24^4 on expm(0.3 tah) links, 16 eigenpairs of the
     plain normal operator on B1, svd_stag's 8 triplets of D_oe on B1's
     single-parity hop (both converged; sigma^2 against the
     eigenvalues, TOL_SIGMA2),
     the rooted fermion's calibrated spectral range (inside [m^2/2,
     1.2 (m^2 + 16)]) and the rational approximations on it and on the
     analytic bound;
 31. measure: those links through io/lime (written, read back bit for
     bit, checksum verified), then the measure app on the file (mesons,
     z4 condensate with 4 noises and eo dilution, Wilson mesons; the
     plaquette to 1e-6, the pions and the condensate positive) and the
     eigs app (-nev:8 with its deflation line); then B3 against its plain
     twin on the links read back, at the app's mass and bc (TOL_KERNEL);
 32. app_pbp: staghmc_spv on the config-4 deck, one trajectory with
     pbp_freq=1 (a positive MEASpbp);
 then the remaining samplers, which launch none of B1-B8; each holds its
 cores on the card against the host on the same draws (the discrete
 updates in float64 on both sides to TOL_DISCRETE, the rest in float32
 against float64 to TOL_CARD_HOST) and reports its seconds and peak
 memory:
 33. xy: the xy_mc app at L=256, beta 1.1, from an ordered start,
     XY_UPDATES heatbath, Metropolis and Wolff updates in turn on one
     field, their energies within XY_Z combined blocked-jackknife errors
     of each other; a spin-flow measurement (the flow lowers E); three
     Wolff clusters on a thermalized field equal to scipy's connected
     component of the seed, the same at fixed-point strides 1, 4 and 16,
     each timed; the Z_6 clock model at L=256 (heatbath and Metropolis,
     with its magnetization);
 34. u1: the u1_mc app in 2D at L=128, beta 5: heatbath with one
     over-relaxation sweep and 2MN HMC, each plaquette within U1_Z
     blocked-jackknife errors of I1(5)/I0(5), every charge an integer to
     TOL_TOPO_INT, and a flowed charge;
 35. u1_qn: the u1_qn_hmc app at L=64 (6 streams, QN from sweep 8,
     maximal-tree fixing): <exp(-dH)> within QN_Z_CREUTZ errors of 1, the
     plaquette within QN_Z_PLAQ of I1/I0, the QN acceptance beside the
     plain-HMC sweeps';
 36. nambu: the nambu_hmc app at 16^4 (Wilson target, beta 6, guide
     WilsonStout, 3 stout steps, rho 0.1, 50 steps, 3 trajectories), one
     TopoCloverStoutMeta trajectory, |dH| at 25 against 50 steps at 8^4
     from the same draws (ratio in NAMBU_RATIO);
 37. rahmc: the rahmc app at 16^4 (beta 6, gamma 0.3, 24 steps, 1 HMC and
     3 RAHMC trajectories); at gamma = 0 its step against the leapfrog
     hmc_step from the same draws on the card;
 38. gauge_fix: Landau and Coulomb fixing at 16^4 of a random gauge
     transform of expm(0.3 tah) links: the plaquette kept to
     TOL_FIX_PLAQ, the violation below FIX_VIOL_DROP of its start, the
     functional never falling by more than TOL_FIX_MONOTONE;
 then the multi-rank path and the last tools:
 39. sharded: first a one-rank NCCL group in this process at (1,1,1,1):
     the block operators of B1 and B1b equal the unsharded kernel
     operators bit for bit, and a block solve; then four ranks started
     with torch.multiprocessing, processes sharing the card through gloo
     with every exchange and sum staged through host memory (so no time
     of this phase is a multi-GPU figure): B1/B1b at 24^4 and B2/B2b on
     config 5's HISQ links (expm(HISQ_START tah)) at 32^3x64, split
     (1,1,2,1) and (1,1,1,2) over two ranks each pair at once, then
     (1,1,2,2) over four: each sharded d2ee and d2dd against the
     unsharded kernel operator on the card (the links built by each
     rank from its block of the fast links, the backward links' shifts
     exchanging faces) and each rank's local hop against its plain
     twin on its block (TOL_KERNEL), and B3/B3b on
     blocks at 24^3x32 over (1,1,2,2), links built by each rank from its
     block of the gauge field, both parities, plain and fused, against
     the unsplit kernel (TOL_KERNEL); then, counted,
     solve_ee_sharded at 24^4 over (1,1,2,2), m=0.05, r2req 1e-10 (the
     iterations of stag_solve's, its true residual within TOL_RES, the
     seconds per iteration beside the unsharded solve's and the
     host-staging share), solve_multi_sharded on config 5's masses at
     32^3x64 (each true residual within TOL_MULTI), the block-resident
     path over (1,1,2,2) (every field of a trajectory each rank's
     block): two config-4 nHYP trajectories (sloppy: B1b and B1) and one
     HISQ trajectory (B2) at 8^4 cut in depth (SHARD_BLK_DEPTH,
     SHARD_HISQ_DEPTH), from expm(AB_SMEARED_START tah) and
     expm(HISQ_START tah), against this process's unsplit runs on the
     same draws (phase 5's gates), stag_eigs on B1 blocks at 8^4
     (TOL_BLOCK_EIG against the unsplit run), the Wilson eo solve on B3
     blocks at 24^3x32 (iterations within TOL_CG_ITS of the unsplit
     solve's, true residual within TOL_RES); two config-4
     trajectories (unsmeared) at 8^4 over (1,1,1,2) against the same
     draws without a mesh (phase 5's gates), and on the second pair the
     two ranks' pario file of 24^4 links read back and a flipped byte
     caught, the dry run (qex_tpu_torch.parallel.dryrun) over two ranks,
     and the app staghmc_spv under torchrun with -rank_geom=1x1x1x2 for
     one trajectory (8^4); last, once the ranks hold none of the
     phase's earlier fields, at 24^4 one smeared force evaluation on
     blocks (smear forward, the fermion's solve, the boson's operator,
     pullback), each rank's max_memory_allocated and its peak above the
     links and pseudofermions at most SHARD_MEM_RATIO of the same
     evaluation's unsplit numbers in this process, all printed;
 40. io_formats: LIME with the checksum codec and with its zlib loop at
     24^4 and 32^3x64, MILC, modfile and timeslice files at 24^4, each
     written from the card and read back bit for bit with its checksum;
     the pario file of phase 39 byte for byte the serial LIME file of its
     field; lat_util check and cmp;
 41. suite: qex_tpu_torch.bench.suite at 16^4, 0.02 s a measurement.
The launch counters are set to 0 just before each main-path phase (4, 6,
7, 9, 10, 13, 14, 15, the A/B of 17, 18-24, 26, 28-38, in each rank
of 39 before its solves, and in 19a's process before its chain) and read
just after it; 19, 20, 21, the pure-gauge
apps of 22 and 33-38 must launch no kernel, staghmc_spv B1.  Then
the card line, the kernels summary and, last, the ok line.  Any failed
check raises, so the script exits non-zero and prints no ok line;
without a CUDA device it exits non-zero at once.

``--profile`` instead runs a 24^4 f32 solve, a sloppy solve, one smeared
config-4 trajectory, one HISQ trajectory and a 24^3x32 Wilson eo solve
under torch.profiler and prints each one's wall time, device kernel
count, device-idle share and top operators.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED = 20261016
ROOT = Path(__file__).resolve().parent
TOL_KERNEL = 1e-12      # squared relative deviation, as the JAX kernel tests
TOL_RES = 1e-9          # true relative residual^2 of a solve at r2req 1e-10
# Kernel against plain trajectory at 8^4 (phases 5 and 8).  Both runs are
# float32 with the same draws; they differ by float32 rounding (the
# kernel sums in another order, and the plain run is on the host) and by
# where each CG stops within its tolerance.  Force solves stop at
# relative residual 1e-4 (r2req 1e-8), so forces may differ at 1e-4
# relative; integrated over tau=0.5 that moves links by far less than
# 1e-3.  dH is a float64 difference of sums of float32 per-site values:
# each run carries rounding of order eps_f32 * |H| (~6e-8 |H|), so two
# runs may differ by a small multiple of that; allow 1e-5 |H|.
TOL_AB_LINK = 1e-3
TOL_AB_DH_REL_H = 1e-5
# Phase 8 starts from smoother links, expm(0.3 tah), than phase 5's
# expm(0.7 tah).  From the rough start the smeared config-4 trajectory is
# unstable (|dH| ~ 6.5 |H| at 8^4), and float32 rounding grows along it:
# on the host alone, complex64 against complex128 with the plain
# operator (python -m qex_tpu_torch.apps.md_precision --cpu -ns=8 -nt=8)
# differ by 2.1e-3 in the links and 83 in dH (5.9e-4 and 28 with sloppy
# solves), against 7.7e-6 and 0.018 from the smooth start (|dH| ~ 1).
# So the rough start cannot tell a kernel fault from rounding.  The
# tolerances stay those of phase 5.
AB_SMEARED_START = 0.3
# The HISQ phases 10 and 11 start from expm(0.3 tah) links too.  From
# the expm(0.7 tah) start of the other phases the first HISQ force at
# 24^4 reaches 1.9e12 (max |F|; python -m qex_tpu_torch.apps.hisq_forces
# prints it): a few first-level fat7 links are nearly singular, where the
# exact derivative of the polar projection diverges (ROADMAP C4, C5), and
# the first gauge update overflows to NaN.  From expm(0.3 tah) the force
# stays below 1.5.
HISQ_START = 0.3
TOL_RESUME = 1e-10      # relative: a resume repeats the chain exactly
# The multishift solve has no restarts, so its true residual is held to
# 100x its r2req (phase 9).
TOL_MULTI = 1e-8
# H100 SXM data sheet (dense, 700 W): the bounds of the kernels line
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# per output site: flops (the reference's models) and bytes (links,
# spinor and output, each once) of the 8- and 16-term staggered hops and
# the Wilson hop
FLOPS_PER_SITE = {"stag8": 594, "hisq16": 1152, "wilson8": 1344}
BYTES_PER_SITE = {("stag8", torch.float32): 624,
                  ("stag8", torch.bfloat16): 336,
                  ("hisq16", torch.float32): 1200,
                  ("hisq16", torch.bfloat16): 624,
                  ("wilson8", torch.float32): 768,
                  ("wilson8", torch.bfloat16): 480}
KERNELS = {   # name: (hop kind, links dtype, launch counter)
    "stag8_dslash": ("stag8", torch.float32, "launches"),
    "stag8_dslash_bf16": ("stag8", torch.bfloat16, "launches_bf16"),
    "hisq16_dslash": ("hisq16", torch.float32, "launches"),
    "hisq16_dslash_bf16": ("hisq16", torch.bfloat16, "launches_bf16"),
    "wilson8_hop": ("wilson8", torch.float32, "launches"),
    "wilson8_hop_bf16": ("wilson8", torch.bfloat16, "launches_bf16"),
}
# the older staggered generations (phases 16-18): name -> (kind, links
# dtype, launch counter); kind v1..v4 or split, as the generation
# benchmark's Instance.kind, and for split the counter names the mode
KERNELS.update({
    "stag_v1_dslash": ("v1", torch.float32, "launches"),
    "stag_v1_dslash_bf16": ("v1", torch.bfloat16, "launches_bf16"),
    "stag_v2_dslash": ("v2", torch.float32, "launches"),
    "stag_v3_dslash": ("v3", torch.float32, "launches"),
    "stag_v3_dslash_bf16": ("v3", torch.bfloat16, "launches_bf16"),
    "stag_v4_dslash": ("v4", torch.float32, "launches"),
    "stag_v4_dslash_bf16": ("v4", torch.bfloat16, "launches_bf16"),
    "stag_v4_compute_only": ("v4", torch.float32, "launches_compute_only"),
    "stag_v4_compute_only_bf16": ("v4", torch.bfloat16,
                                  "launches_compute_only_bf16"),
    **{f"stag_v3_split_{m}": ("split", torch.float32, f"launches_{m}")
       for m in ("dma", "matvec", "shifts", "compute", "full")}})
GEN_KINDS = ("v1", "v2", "v3", "v4", "split")
SOURCES = {"stag8": "stag8_dslash.cu", "hisq16": "hisq16_dslash.cu",
           "wilson8": "wilson8_dslash.cu", "v1": "stag_v1_dslash.cu",
           "v2": "stag_v2_dslash.cu", "v3": "stag_v3_dslash.cu",
           "v4": "stag_v3_dslash.cu", "split": "stag_v3_dslash.cu"}
REPLACES = {"stag8": "qex_tpu/physics/stag_pallas_hisq.py:166",
            "hisq16": "qex_tpu/physics/stag_pallas_hisq.py:166",
            "wilson8": "qex_tpu/physics/wilson_pallas.py:167",
            "v1": "qex_tpu/physics/stag_pallas.py:69",
            "v2": "qex_tpu/physics/stag_pallas2.py:59",
            "v3": "qex_tpu/physics/stag_pallas3.py:123",
            "v4": "qex_tpu/physics/stag_pallas4.py:39",
            "split": "exp_pallas3.py:19"}
# an odd-extent shape for the kernel checks of B2/B2b (phase 2) and
# B4/B4b (phase 16): odd Y and Z, an x extent that the 16-term kernel's
# four-site path does not divide, V = 180 (a bf16 link plane of 360 B is
# no multiple of 16); its fields come from a generator of their own, so
# that the main-path phases draw what they drew before the check existed
ODD_DIMS = (6, 3, 5, 4)
# phases 16-18: the generation benchmark's volume and CG (exp_s8.py:36)
GEN_DIMS = (32, 32, 32, 32)
GEN_MASS = 0.1
TOL_CG_ITS = 2          # CG iterations within +-2 of B1's
# Wilson solves (phases 13-14): true relative r^2 of D x = b, by the
# plain operator in complex128; exp_wilson.py's r2req 1e-12 for phase 13
TOL_WILSON = 1e-11
# where the chip run keeps the app's checkpoints (gitignored)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
ACCEPT_N_MEAS = 100     # measured trajectories of the accepting chain
ACCEPT_CPU_BLOCK = 5    # blocks of the 40-point float64 series
ACCEPT_MIN_BLOCKS = 20
ACCEPT_Z = 3.0          # combined blocked-jackknife errors; the same
#                         bound holds <exp(-dH)> to 1 (Creutz's equality)
ACCEPT_MIN = 0.6
# phase 19a: the north-star chain on the card against ACCEPT_NS_CPU.json;
# the card side's measured trajectories (its warm-up is the deck's)
NS_DECK = ROOT / "qex_tpu_torch" / "apps" / "decks" / "northstar_accept.xml"
NS_N_MEAS = 160
NS_TIMEOUT_S = 900      # the chain's process, from its start
CONFIG3_NSTEPS = (20, 24, 32, 48)
# apps_gauge's puregauge_hmc from a cold start at 8^4 (Symanzik beta 6):
# the plaquette relaxes from 1 to ~0.75 in ~6 trajectories; at 30 steps
# the equilibrium dH is ~0.1-0.3
PG_APP_STEPS, PG_APP_WARMUP, PG_APP_NTRAJ = 30, 6, 10
TOL_FLOW = 1e-5         # relative, card complex64 against host complex128:
#                         links, t^2 E_clover and t^2 E_plaq
# phase 23: exp_msloppy.py's masses (:31, :32) and solve parameters
MULTI_LIGHT = (0.025, 0.05, 0.1, 0.2)
MULTI_HEAVY = (0.4, 0.5, 0.7, 1.0)
MULTI_R2REQ = 1e-10
RHMC_NTRAJ = 3
# phase 28: exp_northstar32.py's volume
NORTHSTAR_DIMS = (32, 32, 32, 64)
# phase 29: exp_eigs24.py's eigensolve (its :64-93): 16 pairs, degree 30,
# tol 1e-5, 25 restart cycles, then CG against deflated CG at m = 0.05
EIGS_DIMS = (24, 24, 24, 48)
EIGS_N, EIGS_DEGREE, EIGS_TOL, EIGS_RESTARTS = 16, 30, 1e-5, 25
EIGS_DEFLATE_MASS, EIGS_R2REQ = 0.05, 1e-10
EIGS_MAX_RESID = 2e-3
# An eigenvalue is the Rayleigh quotient of its vector with A v computed
# in float32 on the kernel; recomputed in complex128 it moves by the
# projection on v of that rounding, which is ~eps_f32 |A| per component
# with |A| <= the window's top, and independent from component to
# component, so ~eps_f32 |A| / sqrt(N) on a unit vector of N complex
# components: each eigenvalue may move by that plus 1e-6 of itself.
EIGS_RQ_REL = 1e-6
# phases 30-31: expm(0.3 tah) links at 24^4 (smooth enough for the
# Wilson solves at m = 0.05).  The SVD's 8 lowest triplets of D_oe, whose
# squares must match the eigensolve's lowest eigenvalues (relative): on
# these links the low band is a dense cluster (16 eigenvalues within
# 16%), which the unfiltered Golub-Kahan iteration resolves slowly, so
# it takes a larger basis and more restarts than its defaults (with 30
# vectors, 100 cycles stopped at a relative residual of 4e-3 with the
# 5th-8th off by 0.2-3%; with 96, 34 cycles converged on an H100)
MEAS_START = 0.3
SVD_N, SVD_M, SVD_TOL, SVD_RESTARTS = 8, 96, 1e-6, 300
TOL_SIGMA2 = 1e-3


def odd_generator():
    """The generator of the ODD_DIMS checks (see ODD_DIMS)."""
    return torch.Generator(device="cuda").manual_seed(SEED + 1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean per-call time of ``reps``
    back-to-back calls, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_time_ms(fn, reps: int = 200, rounds: int = 5) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    the graph replayed ``rounds`` times between CUDA events (median), so
    the host's cost of each launch lies outside the timed window."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def timed_once_s(fn):
    """(result, seconds) of one call, by CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def rel2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((got - ref).abs() ** 2).sum() / (ref.abs() ** 2).sum())


def random_links(lat, gen, dtype=torch.complex64, scale: float = 0.7):
    """expm(scale * random_tah) per link (0.7: tests/test_stag_pallas.py)."""
    from qex_tpu_torch.ops import group, linalg
    return torch.stack([linalg.expm(scale * group.random_tah(
        gen, lat.dims, lat.nc, dtype)) for _ in range(lat.nd)])


def _wrapper(kind: str):
    from qex_tpu_torch.bench import exp_pallas3 as ep3
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_pallas as sp1
    from qex_tpu_torch.physics import stag_pallas2 as sp2
    from qex_tpu_torch.physics import stag_pallas3 as sp3
    from qex_tpu_torch.physics import stag_pallas4 as sp4
    from qex_tpu_torch.physics import wilson_pallas as wp
    return {"stag8": sh.dslash_stag8, "hisq16": sh.dslash_hisq16,
            "wilson8": wp.hop_w, "v1": sp1.dslash_pallas,
            "v2": sp2.dslash_pallas2, "v3": sp3.dslash_pallas3,
            "v4": sp4.dslash_pallas4, "split": ep3.run}[kind]


def reset_counts() -> None:
    for kind, _ldt, counter in KERNELS.values():
        setattr(_wrapper(kind), counter, 0)


def read_counts() -> dict:
    return {name: getattr(_wrapper(kind), counter)
            for name, (kind, _ldt, counter) in KERNELS.items()}


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from qex_tpu_torch import _native
    sources = sorted(set(SOURCES.values()))
    t0 = time.perf_counter()
    _native.build(sources)                 # one nvcc each, in parallel
    for src in sources:
        _native.load(src)
    build_s = time.perf_counter() - t0
    nvcc, ptxas = {}, {}
    for src in sources:
        log = _native.BUILD_LOG.get(src, {})
        nvcc[src] = log.get("seconds")
        ptxas[src] = [ln.strip() for ln in log.get("ptxas", "").splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling" in ln]
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "nvcc_s": nvcc, "ptxas": ptxas})
    return {"smi": smi}


def stream_bandwidth_gbs() -> float:
    """Read+write bandwidth of an out-of-place scale over 512 MB."""
    n = 128 * 1024 * 1024
    x = torch.ones(n, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    ms = cuda_time_ms(lambda: torch.mul(x, 1.000001, out=y), reps=20)
    del x, y
    return 2 * 4 * n / (ms * 1e-3) / 1e9


def hisq_links(lat, u):
    """Fat and long links of u, phased and smeared as
    HisqFermion._links does (forward only)."""
    from qex_tpu_torch.gauge import fat7
    from qex_tpu_torch.physics import staggered as st
    return fat7.hisq_links_lowmem(lat, st.phase_links(lat, u))


def hop_fns(kind: str):
    """(hop, plain hop, d2ee) of the 8- or 16-term kernel."""
    from qex_tpu_torch.physics import stag_hisq as sh
    if kind == "stag8":
        return sh.dslash_stag8, sh.dslash_stag8_plain, sh.d2ee_stag8
    return sh.dslash_hisq16, sh.dslash_hisq16_plain, sh.d2ee_hisq16


def make_ops(kind: str, lat, u):
    """links dtype -> kernel-ready operator of links u (the 16-term one
    on their HISQ fat and long links, computed once)."""
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import staggered as st
    if kind == "stag8":
        s = st.new_stag_eo(lat, u)
        return lambda ldt: sh.new_stag8(s, links_dtype=ldt)
    s3 = st.new_stag3_eo(lat, *hisq_links(lat, u))
    return lambda ldt: sh.new_hisq16(s3, links_dtype=ldt)


def compare_hop(name: str, op, x, f32_op=None) -> dict:
    """Kernel against its plain twin on the same links: both parities
    and the fused d2ee; raises past TOL_KERNEL."""
    kind = KERNELS[name][0]
    hop, plain, d2ee = hop_fns(kind)
    res, max_abs = {}, 0.0
    for parity in (0, 1):
        got = hop(op, x, parity)
        ref = plain(op, x, parity)
        torch.cuda.synchronize()
        res[f"rel2_parity{parity}"] = rel2(got, ref)
        max_abs = max(max_abs, float((got - ref).abs().max()))
    m = 0.05
    got = d2ee(op, x, m)
    ref = (m * m) * x - plain(op, plain(op, x, 1), 0)
    torch.cuda.synchronize()
    res["rel2_d2ee"] = rel2(got, ref)
    res["max_abs_err"] = max(max_abs, float((got - ref).abs().max()))
    if f32_op is not None:
        # information only: the bf16 operator against the f32 one
        res["rel2_bf16_vs_f32_d2ee"] = rel2(got, d2ee(f32_op, x, m))
    for key in ("rel2_parity0", "rel2_parity1", "rel2_d2ee"):
        if not res[key] <= TOL_KERNEL:
            raise AssertionError(f"{name} at {tuple(x.shape)}: {key} "
                                 f"{res[key]}")
    return res


def time_hop(name: str, op, x, sites: int) -> dict:
    """Kernel time by CUDA-graph replay ("ms", the device time) and by
    eager launches, plain twin and fused d2ee times (CUDA events), GB/s
    by the bytes model and the kernel's bound at the data-sheet peaks."""
    kind, ldt, _ = KERNELS[name]
    hop, plain, d2ee = hop_fns(kind)
    nbytes = BYTES_PER_SITE[(kind, ldt)] * sites
    flops = FLOPS_PER_SITE[kind] * sites
    k_ms = graph_time_ms(lambda: hop(op, x, 0))
    eager_ms = cuda_time_ms(lambda: hop(op, x, 0), reps=200)
    p_ms = cuda_time_ms(lambda: plain(op, x, 0), reps=10)
    ee_ms = cuda_time_ms(lambda: d2ee(op, x, 0.05), reps=100)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    return {"ms": k_ms, "ms_eager_launches": eager_ms, "plain_ms": p_ms,
            "d2ee_ms": ee_ms,
            "gflops": flops / (k_ms * 1e-3) / 1e9,
            "bytes": nbytes, "gbs": nbytes / (k_ms * 1e-3) / 1e9,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def add_stream_share(rec: dict, bw: float) -> None:
    rec["stream_gbs"] = bw
    rec["share_of_stream_bw"] = rec["gbs"] / bw
    rec["bound_at_stream_us"] = rec["bytes"] / (bw * 1e9) * 1e6


def fast_vector(lat, gen):
    X, Y, Z, T = lat.dims
    return torch.randn((3, T // 2, Z, Y * X), dtype=torch.complex64,
                       generator=gen, device=gen.device)


def dims_label(dims) -> str:
    return (f"{dims[0]}^4" if len(set(dims)) == 1
            else "x".join(str(d) for d in dims))


def phase_kernel(gen) -> dict:
    """Each kernel against its plain twin at 24^4 (timed), 8x4x4x8 and,
    for the 16-term kernels, 4^4 (Th = 2, distance-3 wraps at extent
    4) and ODD_DIMS, on expm(0.7 tah) links (HISQ-smeared for the
    16-term ones)."""
    from qex_tpu_torch.lattice import Lattice
    out = {}
    for kind in ("stag8", "hisq16"):
        sizes = [(24, 24, 24, 24), (8, 4, 4, 8)]
        if kind == "hisq16":
            sizes += [(4, 4, 4, 4), ODD_DIMS]
        for i, dims in enumerate(sizes):
            lat = Lattice(dims)
            g = odd_generator() if dims == ODD_DIMS else gen
            build = make_ops(kind, lat, random_links(lat, g))
            f32_op = build(torch.float32)
            x = fast_vector(lat, g)
            for name, (k, ldt, _c) in KERNELS.items():
                if k != kind:
                    continue
                op = f32_op if ldt == torch.float32 else build(ldt)
                rec = {"dims": list(dims), "links": str(ldt)}
                rec.update(compare_hop(
                    name, op, x, f32_op if ldt == torch.bfloat16 else None))
                if i == 0:
                    rec.update(time_hop(name, op, x, lat.volume // 2))
                out.setdefault(name, {})[dims_label(dims)] = rec
    bw = stream_bandwidth_gbs()
    for recs in out.values():
        add_stream_share(recs["24^4"], bw)
        recs["24^4"]["max_abs_err"] = max(r["max_abs_err"]
                                          for r in recs.values())
    emit({"phase": "kernel", **out})
    res = {k: v["24^4"] for k, v in out.items()}
    res["stream_gbs"] = bw
    return res


def phase_solve(gen) -> dict:
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import eo
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((24, 24, 24, 24))
    m = 0.05
    u = random_links(lat, gen)
    s = st.new_stag_eo(lat, u)
    b = torch.randn(lat.vector_shape(), dtype=torch.complex64,
                    generator=gen, device=gen.device)
    s64 = st.new_stag_eo(lat, u.to(torch.complex128))
    be, bo = (v.to(torch.complex128) for v in eo.pack(b, 4))
    rhs = m * be - st.dslash_eo(s64, bo, 0)
    res = {"phase": "solve", "dims": list(lat.dims), "m": m}
    for route, sloppy in (("f32", False), ("sloppy", True)):
        params = SolverParams(r2req=1e-10, maxits=5000, restarts=5,
                              sloppy=sloppy)
        stag_solve.solve(s, b, m, params)                 # warm-up
        runs = []
        for _ in range(3):
            reset_counts()
            (x, stats), secs = timed_once_s(
                lambda: stag_solve.solve(s, b, m, params))
            runs.append((secs, stats, read_counts()))
        secs = statistics.median(r[0] for r in runs)
        stats, counts = runs[-1][1], runs[-1][2]
        # true residuals with the plain canonical operator in complex128
        xe, xo = (v.to(torch.complex128) for v in eo.pack(x, 4))
        true_ee = rel2(st.d2ee(s64, xe, m), rhs)
        re = m * xe + st.dslash_eo(s64, xo, 0) - be
        ro = m * xo + st.dslash_eo(s64, xe, 1) - bo
        true_full = float(((re.abs() ** 2).sum() + (ro.abs() ** 2).sum())
                          / ((be.abs() ** 2).sum() + (bo.abs() ** 2).sum()))
        rec = {"r2req": params.r2req, "iterations": stats.iterations,
               "solver_r2": stats.r2, "true_rel_r2_even_system": true_ee,
               "true_rel_r2_full_system": true_full, "seconds": secs,
               "seconds_runs": [r[0] for r in runs],
               "seconds_per_iteration": secs / stats.iterations,
               "gflops": stag_solve.cg_flops(lat, 4, 3, stats.iterations)
               / secs / 1e9, "kernel_launches": counts}
        if sloppy:
            # each inner iteration is one bf16 d2ee; each true residual
            # (one per restart, one at the end) one f32 d2ee
            rec["inner_iterations"] = counts["stag8_dslash_bf16"] // 2
            rec["true_residuals"] = counts["stag8_dslash"] // 2
        res[route] = rec
        if not true_ee <= TOL_RES:
            raise AssertionError(f"solve {route}: true residual {true_ee} "
                                 f"> {TOL_RES}")
        needed = ["stag8_dslash"] + (["stag8_dslash_bf16"] if sloppy else [])
        for k in needed:
            if counts[k] <= 0:
                raise AssertionError(f"solve {route}: {k} never launched")
    emit(res)
    return res


def config4_theory(lat, smear=None, sloppy: bool = False, mesh=None,
                   steps=(12, 6, 6), tau: float = 0.5):
    """exp_northstar32.py:45-56 composition (``smear=None``: unsmeared;
    ``mesh``: block-resident over a rank mesh; ``steps`` the gauge,
    fermion and boson step counts, ``tau`` the trajectory length, both
    cut for the block-resident runs)."""
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.mcmc.theory import (FermionSpec, GaugeActionSpec,
                                           LatticeFieldTheory)
    from qex_tpu_torch.solvers.base import SolverParams
    return LatticeFieldTheory(
        lat,
        gauge=GaugeActionSpec(ga.wilson(7.0), steps=steps[0], scheme="2MN"),
        fermions=[FermionSpec("fermion", mass=0.05, steps=steps[1],
                              scheme="2MN"),
                  FermionSpec("boson", mass=0.5, steps=steps[2],
                              scheme="2MN")],
        smear=smear, bc="pppa",
        solver_params=SolverParams(r2req=1e-10, maxits=1500, restarts=3,
                                   sloppy=sloppy, mesh=mesh),
        force_solver_params=SolverParams(r2req=1e-8, maxits=1500,
                                         restarts=2, sloppy=sloppy,
                                         mesh=mesh),
        tau=tau)


def hisq_theory(lat, mesh=None, steps=None, tau: float | None = None):
    """Config 5's fermion in an HMC (``qex_tpu_torch.apps.hisq_forces``);
    for the block-resident runs the same theory over ``mesh`` with
    ``steps`` (gauge, fermion) and ``tau`` cut in depth."""
    import dataclasses

    from qex_tpu_torch.apps.hisq_forces import hisq_theory as build
    from qex_tpu_torch.mcmc.theory import LatticeFieldTheory
    th = build(lat)
    if mesh is None and steps is None and tau is None:
        return th
    (g,), (f,) = th.gauges, th.fermions
    steps = steps or (g.steps, f.steps)
    return LatticeFieldTheory(
        lat, gauge=dataclasses.replace(g, steps=steps[0]),
        fermions=[dataclasses.replace(f, steps=steps[1])], bc=th.bc,
        solver_params=dataclasses.replace(th.solver_params, mesh=mesh),
        force_solver_params=dataclasses.replace(th.force_solver_params,
                                                mesh=mesh),
        tau=th.tau if tau is None else tau)


def run_trajectories(th, lat, gen, u, n: int, tag: str,
                     need: str = "stag8_dslash", first: int = 0,
                     always_accept: bool = False) -> tuple:
    """``n`` hmc_step calls, each with its time, dH, plaquette, kernel
    launches and peak memory; raises on a non-finite dH, a plaquette
    outside (0, 1) or no launch of kernel ``need``."""
    from qex_tpu_torch.gauge import loops
    trajs = []
    for i in range(first, first + n):
        before = read_counts()
        torch.cuda.reset_peak_memory_stats()
        (u, state), secs = timed_once_s(lambda: th.hmc_step(
            gen, u, always_accept=always_accept))
        plaq = float(loops.plaquette(lat, u))
        after = read_counts()
        rec = {"traj": i, "seconds": secs, "dH": state.dH,
               "accepted": state.accepted, "h_old": state.h_old,
               "plaquette": plaq,
               "kernel_launches": {k: after[k] - before[k] for k in after},
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        trajs.append(rec)
        if not math.isfinite(state.dH):
            raise AssertionError(f"{tag} traj {i}: dH is {state.dH}")
        if not 0.0 < plaq < 1.0:
            raise AssertionError(f"{tag} traj {i}: plaquette {plaq}")
        if rec["kernel_launches"][need] <= 0:
            raise AssertionError(f"{tag} traj {i}: no {need} launch")
    return u, trajs


def phase_hmc(gen) -> dict:
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice((24, 24, 24, 24))
    th = config4_theory(lat)
    u = random_links(lat, gen)
    plaq0 = float(loops.plaquette(lat, u))
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    u, trajs = run_trajectories(th, lat, gen, u, 2, "hmc")
    launches = read_counts()
    res = {"phase": "hmc", "dims": list(lat.dims), "plaquette_start": plaq0,
           "trajectories": trajs,
           "seconds_per_traj_median": statistics.median(
               r["seconds"] for r in trajs), "kernel_launches": launches}
    emit(res)
    return res


@contextlib.contextmanager
def split_timer(patches):
    """Host-clock split of what runs inside: each (key, owner, attribute)
    of ``patches`` is wrapped to add its time to ``key``, bracketed by
    device syncs (which cost a little time of their own).  Times are
    exclusive: a wrapped call inside another is subtracted from the
    outer one."""
    acc = {key: 0.0 for key, _o, _a in patches}
    inner = []                  # time of wrapped calls nested in each open
    saved = []

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                acc[key] += dt - inner.pop()
                if inner:
                    inner[-1] += dt
        return wrapper

    for key, owner, attr in patches:
        saved.append((owner, attr, attr in vars(owner),
                      vars(owner).get(attr)))
        setattr(owner, attr, timed(key, getattr(owner, attr)))
    try:
        yield acc
    finally:
        for owner, attr, had, old in reversed(saved):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)


def split_run(th, lat, gen, u, patches, tag, need, first,
              always_accept: bool = False):
    """One trajectory under :func:`split_timer`; returns (u, its record,
    the split with the remainder as "rest" and the wall time)."""
    with split_timer(patches) as split:
        t0 = time.perf_counter()
        u, trajs = run_trajectories(th, lat, gen, u, 1, tag, need, first,
                                    always_accept)
        wall = time.perf_counter() - t0
    split["rest"] = wall - sum(split.values())
    split["wall"] = wall
    return u, trajs[0], split


def phase_hmc_smeared(gen) -> dict:
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice((24, 24, 24, 24))
    th = config4_theory(lat, smear=HypCoefs(0.4, 0.5, 0.5))
    u = random_links(lat, gen)
    plaq0 = float(loops.plaquette(lat, u))
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    u, trajs = run_trajectories(th, lat, gen, u, 2, "hmc_smeared")
    launches = read_counts()
    from qex_tpu_torch.mcmc import md
    from qex_tpu_torch.physics import stag_solve
    u, split_traj, split = split_run(
        th, lat, gen, u, [("smear_forward", th, "_smear"),
                          ("smear_pullback", md, "_pullback"),
                          ("solves", stag_solve, "solve_ee")],
        "hmc_smeared split", "stag8_dslash", 2)
    res = {"phase": "hmc_smeared", "dims": list(lat.dims),
           "smear": "nHYP(0.4, 0.5, 0.5)", "plaquette_start": plaq0,
           "trajectories": trajs,
           "seconds_per_traj_median": statistics.median(
               r["seconds"] for r in trajs),
           "peak_mem_gib": max(r["peak_mem_gib"] for r in trajs),
           "kernel_launches": launches, "split_trajectory": split_traj,
           "split_seconds": split}
    emit(res)
    return res


def _app(argv: list[str]) -> list[str]:
    """Run the app's main in this process; echo and return its lines."""
    from qex_tpu_torch.apps import staghmc_spv
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = staghmc_spv.main(argv)
    lines = out.getvalue().splitlines()
    for ln in lines:
        print("  | " + ln, flush=True)
    if rc != 0:
        raise AssertionError(f"app exited {rc}")
    return lines


def _tag_values(lines: list[str], tag: str) -> list[float]:
    return [float(ln.split()[-1]) for ln in lines if ln.startswith(tag)]


def phase_app() -> dict:
    deck = str(ROOT / "qex_tpu_torch" / "apps" / "decks" / "config4_24.xml")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    base = ["--xml", deck, "-sloppy_solve=1", f"-save_path={CKPT_DIR}"]
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    t0 = time.perf_counter()
    lines = _app(base + ["--ntraj", "2", "-save_freq=1", "-check_solvers=1",
                         "-rev_check_freq=2"])
    secs = time.perf_counter() - t0
    launches = read_counts()
    for tag in ("Begin H", "End H", "MEASplaq ", "MEASplaq6", "MEASploop",
                "SOLVER", "REVCHECK"):
        if not any(ln.startswith(tag) for ln in lines):
            raise AssertionError(f"app: no {tag!r} line")
    verdicts = [ln for ln in lines if ln.startswith(("ACCEPT", "REJECT"))]
    dh = [float(ln.split()[2]) for ln in verdicts]
    if len(dh) != 2 or not all(math.isfinite(x) for x in dh):
        raise AssertionError(f"app: dH {dh}")
    for k in ("stag8_dslash", "stag8_dslash_bf16"):
        if launches[k] <= 0:
            raise AssertionError(f"app: {k} never launched")
    resumed = _app(base + ["--ntraj", "1", "-start_config=1"])
    h_first, h_resumed = _tag_values(lines, "Begin H"), \
        _tag_values(resumed, "Begin H")
    p_first, p_resumed = _tag_values(lines, "MEASplaq "), \
        _tag_values(resumed, "MEASplaq ")
    dev = {"begin_h": abs(h_resumed[0] - h_first[1]) / abs(h_first[1]),
           "plaquette": abs(p_resumed[0] - p_first[1]) / abs(p_first[1])}
    res = {"phase": "app", "dims": [24, 24, 24, 24], "sloppy": True,
           "dH": dh, "seconds_two_trajectories_and_checks": secs,
           "kernel_launches": launches, "resume_rel_dev": dev,
           "solver": [ln for ln in lines if ln.startswith("SOLVER")],
           "revcheck": [ln for ln in lines if ln.startswith("REVCHECK")]}
    emit(res)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    for k, v in dev.items():
        if not v <= TOL_RESUME:
            raise AssertionError(f"app: resume {k} deviates by {v}")
    return res


def _ab(gen, tag: str, theory, start: float = 0.7,
        needed: tuple = ("stag8_dslash",)) -> dict:
    """One 8^4 trajectory of ``theory(lat)`` with identical injected
    draws, through the kernels on the card and through the plain
    operators on the host; raises past the link and dH gates or if a
    kernel of ``needed`` never launched."""
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice((8, 8, 8, 8))
    th = theory(lat)
    u = random_links(lat, gen, scale=start)
    p = th.draw_momenta(gen, u)
    xis = th.draw_noise(gen, u)

    def run(dev):
        uu, pp = u.to(dev), p.to(dev)
        phis = th.heatbath_from_noise(
            [None if x is None else x.to(dev) for x in xis], uu)
        h_old = float(th.hamiltonian(uu, pp, phis))
        u1, p1 = th.trajectory(uu, pp, phis)
        h_new = float(th.hamiltonian(u1, p1, phis))
        return u1.cpu(), h_old, h_new - h_old

    before = read_counts()
    (u_k, h_k, dh_k), secs_k = timed_once_s(lambda: run("cuda"))
    after = read_counts()
    launches = {k: after[k] - before[k] for k in after}
    t0 = time.perf_counter()
    u_p, h_p, dh_p = run("cpu")
    secs_p = time.perf_counter() - t0
    link_dev = float((u_k - u_p).abs().max())
    ddh = abs(dh_k - dh_p)
    res = {"phase": tag, "dims": list(lat.dims), "start": start,
           "dH_kernel": dh_k,
           "dH_plain": dh_p, "abs_ddH": ddh, "h_old": h_k,
           "max_link_dev": link_dev, "tol_link": TOL_AB_LINK,
           "tol_ddH": TOL_AB_DH_REL_H * abs(h_k),
           "kernel_launches": launches, "seconds_kernel": secs_k,
           "seconds_plain_host": secs_p}
    emit(res)
    for k in needed:
        if launches[k] <= 0:
            raise AssertionError(f"{tag}: the kernel run never launched {k}")
    if not link_dev <= TOL_AB_LINK:
        raise AssertionError(f"{tag}: link deviation {link_dev}")
    if not ddh <= TOL_AB_DH_REL_H * abs(h_k):
        raise AssertionError(f"{tag}: |dH_kernel - dH_plain| = {ddh}")
    return res


def phase_hisq_solve(gen) -> dict:
    """BASELINE config 5's solve at 32^3x64 (bench_configs.py CONFIG7):
    fattening, the 4-mass multishift on B2 with each mass's true
    residual by the kernel's d2ee, the f32 and sloppy single-mass solves
    at m=0.05, and B2/B2b against their twins and timed at this volume."""
    import dataclasses
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import linalg
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_hmc
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((32, 32, 32, 64))
    torch.cuda.reset_peak_memory_stats()
    u = random_links(lat, gen)
    links, fat_s = timed_once_s(lambda: hisq_links(lat, u))
    X, Y, Z, T = lat.dims
    b = torch.randn((3, X, Y, Z, T // 2), dtype=torch.complex64,
                    generator=gen, device=gen.device)
    masses = (0.05, 0.1, 0.2, 0.4)
    ferm = stag_hmc.HisqFermion(lat, masses[0], params=SolverParams(
        r2req=1e-10, maxits=2000))
    p16 = sh.new_hisq16(st.new_stag3_eo(lat, *links))
    bf = sf.to_fast(b, lat)
    b2 = float(linalg.norm2(bf, torch.float64))

    def true_r2(x, m):          # with the kernel's operator
        r = sh.d2ee_hisq16(p16, sf.to_fast(x, lat), m) - bf
        return float(linalg.norm2(r, torch.float64)) / b2

    res = {"phase": "hisq_solve", "dims": list(lat.dims),
           "fattening_s": fat_s}
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    (xs, stats), secs = timed_once_s(
        lambda: ferm.solve_multi(u, b, masses, links=links))
    counts = read_counts()
    res["multishift"] = {
        "masses": list(masses), "r2req": ferm.params.r2req,
        "iterations": stats.iterations, "solver_r2": stats.r2,
        "seconds": secs, "seconds_per_iteration": secs / stats.iterations,
        "true_rel_r2": [true_r2(x, m) for x, m in zip(xs, masses)],
        "kernel_launches": counts}
    del xs
    main_counts = dict(counts)
    for route, sloppy in (("f32", False), ("sloppy", True)):
        f = dataclasses.replace(ferm, params=SolverParams(
            r2req=1e-10, maxits=2000, restarts=5, sloppy=sloppy))
        reset_counts()
        (x, st_), secs = timed_once_s(lambda: f.solve_ee(u, b,
                                                         links=links))
        counts = read_counts()
        rec = {"m": masses[0], "r2req": 1e-10, "iterations": st_.iterations,
               "solver_r2": st_.r2, "true_rel_r2": true_r2(x, masses[0]),
               "seconds": secs, "kernel_launches": counts}
        if sloppy:
            rec["inner_iterations"] = counts["hisq16_dslash_bf16"] // 2
            rec["true_residuals"] = counts["hisq16_dslash"] // 2
        res[f"solve_{route}"] = rec
        for k, v in counts.items():
            main_counts[k] += v
    res["kernel_launches"] = main_counts
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    x = fast_vector(lat, gen)
    bw = stream_bandwidth_gbs()
    for name, ldt in (("hisq16_dslash", torch.float32),
                      ("hisq16_dslash_bf16", torch.bfloat16)):
        op = p16 if ldt == torch.float32 else sh.new_hisq16(
            st.new_stag3_eo(lat, *links), links_dtype=ldt)
        rec = compare_hop(name, op, x)
        rec.update(time_hop(name, op, x, lat.volume // 2))
        add_stream_share(rec, bw)
        res[name] = rec
    emit(res)
    for i, m in enumerate(masses):
        if not res["multishift"]["true_rel_r2"][i] <= TOL_MULTI:
            raise AssertionError(f"hisq_solve: mass {m} true residual "
                                 f"{res['multishift']['true_rel_r2'][i]}")
    for route in ("f32", "sloppy"):
        if not res[f"solve_{route}"]["true_rel_r2"] <= TOL_RES:
            raise AssertionError(f"hisq_solve {route}: true residual "
                                 f"{res[f'solve_{route}']['true_rel_r2']}")
    for k in ("hisq16_dslash", "hisq16_dslash_bf16"):
        if main_counts[k] <= 0:
            raise AssertionError(f"hisq_solve: {k} never launched")
    return res


def phase_hmc_hisq(gen) -> dict:
    """Two HISQ trajectories at 24^4 from a random start, expm(0.3 tah)
    (see HISQ_START), the second
    split into fattening forward (fat7.hisq_links and its forward-only
    twin), fattening pullback (the rest of each force evaluation: the
    backward pass through the two fat7 levels, the small d2ee3 backward
    and the TAH projection), solves and the rest."""
    from qex_tpu_torch.gauge import fat7, loops
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.mcmc import theory as theory_mod
    from qex_tpu_torch.physics import stag_hmc
    lat = Lattice((24, 24, 24, 24))
    th = hisq_theory(lat)
    u = random_links(lat, gen, scale=HISQ_START)
    plaq0 = float(loops.plaquette(lat, u))
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    u, trajs = run_trajectories(th, lat, gen, u, 1, "hmc_hisq",
                                "hisq16_dslash")
    u, split_traj, split = split_run(
        th, lat, gen, u,
        [("fattening_forward", fat7, "hisq_links"),
         ("fattening_forward", fat7, "hisq_links_lowmem"),
         ("fattening_pullback", theory_mod, "force_from_action"),
         ("solves", stag_hmc.HisqFermion, "_solve_links")],
        "hmc_hisq split", "hisq16_dslash", 1)
    launches = read_counts()
    trajs.append(split_traj)
    res = {"phase": "hmc_hisq", "dims": list(lat.dims),
           "plaquette_start": plaq0, "trajectories": trajs,
           "seconds_per_traj": [r["seconds"] for r in trajs],
           "peak_mem_gib": max(r["peak_mem_gib"] for r in trajs),
           "kernel_launches": launches, "split_seconds": split}
    emit(res)
    return res


def wilson_op(lat, u, m: float, bc: str = "pppa"):
    """links dtype -> kernel-ready Wilson hop of links u (eo, mass m)."""
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.physics import wilson_pallas as wp
    w = wl.new_wilson_eo(lat, u, m, bc)
    return lambda ldt: wp.new_pallas_wilson(w, links_dtype=ldt)


def compare_wilson(name: str, pw, x) -> dict:
    """Kernel B3 / B3b against its plain twin on the same links: both
    parities, m_ee_w (fused epilogue) and m_ee_dag_w; raises past
    TOL_KERNEL."""
    from qex_tpu_torch.physics import wilson_pallas as wp
    res, max_abs = {}, 0.0

    def check(key, got, ref):
        nonlocal max_abs
        torch.cuda.synchronize()
        res[key] = rel2(got, ref)
        max_abs = max(max_abs, float((got - ref).abs().max()))

    for parity in (0, 1):
        check(f"rel2_parity{parity}", wp.hop_w(pw, x, parity),
              wp.hop_w_plain(pw, x, parity))

    def m_ee_plain(v):
        return pw.a * v - wp.hop_w_plain(pw, wp.hop_w_plain(pw, v, 1),
                                         0) / pw.a

    check("rel2_m_ee", wp.m_ee_w(pw, x), m_ee_plain(x))
    check("rel2_m_ee_dag", wp.m_ee_dag_w(pw, x),
          wp._g5(m_ee_plain(wp._g5(x))))
    res["max_abs_err"] = max_abs
    for key in ("rel2_parity0", "rel2_parity1", "rel2_m_ee",
                "rel2_m_ee_dag"):
        if not res[key] <= TOL_KERNEL:
            raise AssertionError(f"{name} at {tuple(x.shape)}: {key} "
                                 f"{res[key]}")
    return res


def time_wilson(name: str, pw, x, sites: int) -> dict:
    """Kernel, plain twin and m_ee_w times (CUDA events), GB/s by the
    bytes model and the kernel's bound at the data-sheet peaks."""
    from qex_tpu_torch.physics import wilson_pallas as wp
    _kind, ldt, _ = KERNELS[name]
    nbytes = BYTES_PER_SITE[("wilson8", ldt)] * sites
    flops = FLOPS_PER_SITE["wilson8"] * sites
    k_ms = cuda_time_ms(lambda: wp.hop_w(pw, x, 0), reps=200)
    p_ms = cuda_time_ms(lambda: wp.hop_w_plain(pw, x, 0), reps=5, rounds=3)
    ee_ms = cuda_time_ms(lambda: wp.m_ee_w(pw, x), reps=100)
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    flops_ms = flops / PEAK_F32_FLOPS * 1e3
    return {"ms": k_ms, "plain_ms": p_ms, "m_ee_ms": ee_ms,
            "gflops": flops / (k_ms * 1e-3) / 1e9,
            "bytes": nbytes, "gbs": nbytes / (k_ms * 1e-3) / 1e9,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def phase_wilson_kernel(gen) -> dict:
    """B3 and B3b against the plain twin at 6x4x4x8 (the JAX kernel
    test's geometry), 4x4x8x8, 24^3x32 (exp_wilson.py) and 32^3x64, on
    expm(0.7 tah) links; timed at the last two."""
    from qex_tpu_torch.lattice import Lattice
    out = {}
    timed = ((24, 24, 24, 32), (32, 32, 32, 64))
    for dims in ((6, 4, 4, 8), (4, 4, 8, 8)) + timed:
        lat = Lattice(dims)
        build = wilson_op(lat, random_links(lat, gen), 0.1)
        X, Y, Z, T = lat.dims
        x = torch.randn((4, 3, T // 2, Z, Y * X), dtype=torch.complex64,
                        generator=gen, device=gen.device)
        for name in ("wilson8_hop", "wilson8_hop_bf16"):
            ldt = KERNELS[name][1]
            pw = build(ldt)
            rec = {"dims": list(dims), "links": str(ldt)}
            rec.update(compare_wilson(name, pw, x))
            if dims in timed:
                rec.update(time_wilson(name, pw, x, lat.volume // 2))
            out.setdefault(name, {})[dims_label(dims)] = rec
            del pw
        del build, x
    bw = stream_bandwidth_gbs()
    for recs in out.values():
        for dims in timed:
            add_stream_share(recs[dims_label(dims)], bw)
    emit({"phase": "wilson_kernel", "stream_gbs": bw,
          "ptxas": ptxas_lines(SOURCES["wilson8"]), **out})
    res = {}
    for name, recs in out.items():
        res[name] = dict(recs["24x24x24x32"])
        res[name]["max_abs_err"] = max(r["max_abs_err"]
                                       for r in recs.values())
    return res


def wilson_true_r2(lat, u, m: float, bc: str, x, b) -> float:
    """|D x - b|^2 / |b|^2 with the plain operator in complex128."""
    from qex_tpu_torch.physics import wilson as wl
    d = wl.new_wilson(lat, u.to(torch.complex128), m, bc)
    b64 = b.to(torch.complex128)
    r = wl.wilson_d(d, x.to(torch.complex128)) - b64
    return float((r.abs() ** 2).sum() / (b64.abs() ** 2).sum())


def phase_wilson_solve(gen) -> dict:
    """exp_wilson.py's solve through wilson.solve_eo's routing:
    24^3x32, m=0.1, bc pppa, r2req 1e-12, maxits 1000, 3 restarts, on
    seeded expm(0.7 tah) links (not Haar links, as every phase here),
    float32 links (B3) and sloppy (B3b inner iterations)."""
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((24, 24, 24, 32))
    m = 0.1
    u = random_links(lat, gen)
    b = torch.randn((4, 3) + lat.dims, dtype=torch.complex64, generator=gen,
                    device=gen.device)
    w = wl.new_wilson_eo(lat, u, m)
    res = {"phase": "wilson_solve", "dims": list(lat.dims), "m": m}
    total = dict.fromkeys(KERNELS, 0)
    for route, sloppy in (("f32", False), ("sloppy", True)):
        params = SolverParams(r2req=1e-12, maxits=1000, restarts=3,
                              sloppy=sloppy)
        torch.cuda.synchronize()
        reset_counts()                     # count the main path only
        (x, stats), secs = timed_once_s(lambda: wl.solve_eo(w, b, params))
        counts = read_counts()
        true = wilson_true_r2(lat, u, m, "pppa", x, b)
        res[route] = {"r2req": params.r2req, "iterations": stats.iterations,
                      "solver_r2": stats.r2, "true_rel_r2": true,
                      "seconds": secs,
                      "seconds_per_iteration": secs / stats.iterations,
                      "kernel_launches": counts}
        for k, v in counts.items():
            total[k] += v
        if not true <= TOL_WILSON:
            raise AssertionError(f"wilson_solve {route}: true residual "
                                 f"{true} > {TOL_WILSON}")
        needed = ["wilson8_hop"] + (["wilson8_hop_bf16"] if sloppy else [])
        for k in needed:
            if counts[k] <= 0:
                raise AssertionError(f"wilson_solve {route}: {k} never "
                                     f"launched")
    res["kernel_launches"] = total
    emit(res)
    return res


def phase_wilson_mesons(gen) -> dict:
    """The measure app's Wilson mesons (qex_tpu/apps/measure.py:111-130):
    12 point-source solves through solve_eo at 24^3x32 (m=0.1, bc pppa,
    r2req 1e-10) and all nine channels; raises on a propagator's true
    residual, a non-finite correlator or a pion C(t) <= 0."""
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.observables import mesons
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice((24, 24, 24, 32))
    m, r2req = 0.1, 1e-10
    u = random_links(lat, gen)
    w = wl.new_wilson_eo(lat, u, m)
    params = SolverParams(r2req=r2req, maxits=1000, restarts=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                         # count the main path only
    t0 = time.perf_counter()
    cols, its, trues = [], [], []
    for s0 in range(4):
        for c0 in range(lat.nc):
            src = torch.zeros((4, lat.nc) + lat.dims, dtype=torch.complex64,
                              device=u.device)
            src[(s0, c0) + (0,) * lat.nd] = 1.0
            x, stats = wl.solve_eo(w, src, params)
            cols.append(x)
            its.append(stats.iterations)
            trues.append(wilson_true_r2(lat, u, m, "pppa", x, src))
    props = torch.stack(cols).reshape((4, lat.nc) + cols[0].shape)
    del cols
    corr = mesons.wilson_mesons_from_prop(lat, props, mesons.WILSON_CHANNELS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    res = {"phase": "wilson_mesons", "dims": list(lat.dims), "m": m,
           "r2req": r2req, "seconds": secs, "iterations": its,
           "true_rel_r2_max": max(trues),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "propagator_gib": props.numel() * props.element_size() / 2**30,
           "kernel_launches": launches,
           "correlators": {ch: [float(v) for v in c.cpu()]
                           for ch, c in corr.items()}}
    emit(res)
    if not max(trues) <= 10 * r2req:
        raise AssertionError(f"wilson_mesons: true residual {max(trues)}")
    for ch, c in corr.items():
        if not bool(torch.isfinite(c).all()):
            raise AssertionError(f"wilson_mesons: {ch} is not finite")
    if not bool((corr["pion"] > 0).all()):
        raise AssertionError("wilson_mesons: pion C(t) <= 0")
    if launches["wilson8_hop"] <= 0:
        raise AssertionError("wilson_mesons: wilson8_hop never launched")
    return res


def phase_wilson_mg(gen) -> dict:
    """exp_mg_ab.py's A/B (MG_AB_cpu.json's scale): m=0.005, bc pppp,
    r2req 1e-8, expm(0.45 tah) links, at 8^3x16 and 16^3x32.  CGNE is
    solve_eo (B3); MG is solve_mg with MGParams(nlevels=1, nvec=8,
    relax_iters=30, m=16, k_m=4, bottom_iters=16), its fine operator the
    plain wilson_d as in the JAX package.  Setup time = (build + solve)
    - (solve on the reused hierarchy)."""
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.solvers.base import MGParams, SolverParams
    m, r2req = 0.005, 1e-8
    p_cg = SolverParams(r2req=r2req, maxits=4000, restarts=2)
    p_mg = SolverParams(r2req=r2req, maxits=400, backend="mg",
                        mg=MGParams(nlevels=1, nvec=8, relax_iters=30,
                                    m=16, k_m=4, bottom_iters=16))
    res = {"phase": "wilson_mg", "m": m, "r2req": r2req, "scale": 0.45}
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    for dims in ((8, 8, 8, 16), (16, 16, 16, 32)):
        lat = Lattice(dims)
        u = random_links(lat, gen, scale=0.45)
        b = torch.randn((4, 3) + lat.dims, dtype=torch.complex64,
                        generator=gen, device=gen.device)
        weo = wl.new_wilson_eo(lat, u, m, "pppp")
        wl.solve_eo(weo, b, p_cg)                           # warm-up
        (x, st_cg), t_cg = timed_once_s(lambda: wl.solve_eo(weo, b, p_cg))
        true_cg = wilson_true_r2(lat, u, m, "pppp", x, b)
        w = wl.new_wilson(lat, u, m, "pppp")
        (x, st_mg, hier), t_build = timed_once_s(
            lambda: wl.solve_mg(w, b, p_mg))
        (x, st_mg, _), t_mg = timed_once_s(
            lambda: wl.solve_mg(w, b, p_mg, hierarchy=hier))
        true_mg = wilson_true_r2(lat, u, m, "pppp", x, b)
        t_setup = t_build - t_mg
        rec = {"cgne_eo": {"seconds": t_cg, "iterations": st_cg.iterations,
                           "true_rel_r2": true_cg},
               "mg_kcycle": {"seconds": t_mg, "setup_seconds": t_setup,
                             "iterations": st_mg.iterations,
                             "true_rel_r2": true_mg},
               "speedup_mg_over_cgne": t_cg / t_mg,
               "breakeven_solves": (t_setup / (t_cg - t_mg)
                                    if t_cg > t_mg else None)}
        res[dims_label(dims)] = rec
        del hier, x
        for tag, true in (("cgne", true_cg), ("mg", true_mg)):
            if not true <= 10 * r2req:
                raise AssertionError(f"wilson_mg {dims} {tag}: true "
                                     f"residual {true}")
    res["kernel_launches"] = read_counts()
    emit(res)
    if res["kernel_launches"]["wilson8_hop"] <= 0:
        raise AssertionError("wilson_mg: wilson8_hop never launched")
    return res


def gen_instances() -> dict:
    """Kernel name -> the generation benchmark's Instance, for the names
    of phases 16-18."""
    from qex_tpu_torch.bench import stag_generations as gens
    out = {}
    for name, (kind, ldt, counter) in KERNELS.items():
        if kind in GEN_KINDS:
            out[name] = gens.Instance(
                kind, ldt, compute_only="compute_only" in counter,
                mode=counter[len("launches_"):] if kind == "split" else None)
    return out


def ptxas_lines(source: str) -> list:
    """The kernel names, registers and spills of a build made in this
    process."""
    from qex_tpu_torch import _native
    return [ln.strip() for ln in _native.BUILD_LOG.get(source, {}).get(
        "ptxas", "").splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln]


def compare_generation(name: str, inst, op, x) -> dict:
    """One older-generation kernel against its plain twin on the same
    links: both parities and, for v1-v4 without compute_only, the d2ee
    (and for v3/v4 the d2dd) wrappers; raises past TOL_KERNEL."""
    from qex_tpu_torch.bench import stag_generations as gens
    hop, plain = gens.hop(inst, op), gens.plain_hop(inst, op)
    v = gens.to_layout(inst.kind, x)
    res, max_abs = {}, 0.0

    def check(key, got, ref, parity=None):
        nonlocal max_abs
        torch.cuda.synchronize()
        res[key] = (rel2(got, ref) if parity is None
                    else gens.deviation(inst, op, v, parity, got, ref))
        max_abs = max(max_abs, float((got - ref).abs().max()))

    for parity in (0, 1):
        check(f"rel2_parity{parity}", hop(v, parity), plain(v, parity),
              parity)
    if inst.kind != "split" and not inst.compute_only:
        m = GEN_MASS
        check("rel2_d2ee", gens.d2ee(inst.kind, op)(v, m),
              (m * m) * v - plain(plain(v, 1), 0))
        if inst.kind in ("v3", "v4"):
            from qex_tpu_torch.physics import stag_pallas3 as sp3
            from qex_tpu_torch.physics import stag_pallas4 as sp4
            d2dd = sp3.d2dd_pallas3 if inst.kind == "v3" else sp4.d2dd_pallas4
            check("rel2_d2dd", d2dd(op, v, 1), -plain(plain(v, 0), 1))
    res["max_abs_err"] = max_abs
    for key, val in res.items():
        if key.startswith("rel2") and not val <= TOL_KERNEL:
            raise AssertionError(f"{name} at {tuple(x.shape)}: {key} {val}")
    return res


def phase_stag_generations_kernel(gen) -> dict:
    """Phase 16: every older-generation instance against its twin at
    8x4x4x8 (the JAX kernel tests' geometry) and 32^4, and v1 (B4/B4b)
    also at ODD_DIMS, on expm(0.7 tah) links; at 32^4 also each
    generation against B1 (f32 links) or B1b (bf16 links) on the same
    gauge field, and B8's full mode against 1/2 (F - B) through B6 on
    links with the backward terms negated."""
    from qex_tpu_torch.bench import stag_generations as gens
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_pallas3 as sp3
    from qex_tpu_torch.physics import staggered as st
    insts = gen_instances()
    out = {name: {} for name in insts}
    res = {"phase": "stag_generations_kernel"}
    for dims in ((8, 4, 4, 8), ODD_DIMS, GEN_DIMS):
        lat = Lattice(dims)
        g = odd_generator() if dims == ODD_DIMS else gen
        s = sf.new_fast(st.new_stag_eo(lat, random_links(lat, g)))
        x = fast_vector(lat, g)
        b1 = {}
        if dims == GEN_DIMS:
            for ldt in (torch.float32, torch.bfloat16):
                b1[ldt] = sh.dslash_stag8(sh.new_stag8(s, links_dtype=ldt),
                                          x, 0)
        for name, inst in insts.items():
            if dims == ODD_DIMS and inst.kind != "v1":
                continue
            op = gens.build(inst, s)
            rec = {"dims": list(dims), "links": str(inst.links_dtype)}
            rec.update(compare_generation(name, inst, op, x))
            if b1 and inst.kind != "split" and not inst.compute_only:
                got = gens.from_layout(inst.kind, gens.hop(inst, op)(
                    gens.to_layout(inst.kind, x), 0))
                rec["rel2_vs_B1"] = rel2(got, b1[inst.links_dtype])
                if not rec["rel2_vs_B1"] <= TOL_KERNEL:
                    raise AssertionError(f"{name}: against the 8-term "
                                         f"kernel {rec['rel2_vs_B1']}")
            if b1 and inst.mode == "full":
                neg = torch.tensor([1.0] * 4 + [-1.0] * 4, device=x.device
                                   ).reshape(8, 1, 1, 1, 1, 1, 1)
                fb = sp3.PallasStagEO3(lat, op.l_e * neg, op.l_o * neg)
                v = gens.to_layout("split", x)
                got = gens.hop(inst, op)(v, 1)
                ref = 0.5 * sp3.dslash_pallas3(fb, v, 1)
                torch.cuda.synchronize()
                rec["rel2_vs_half_f_minus_b"] = rel2(got, ref)
                rec["rel2_vs_v3"] = rel2(got, sp3.dslash_pallas3(op, v, 1))
                if not rec["rel2_vs_half_f_minus_b"] <= TOL_KERNEL:
                    raise AssertionError(
                        f"{name}: against 1/2 (F - B) "
                        f"{rec['rel2_vs_half_f_minus_b']}")
            out[name][dims_label(dims)] = rec
            del op
        del s, x, b1
    res.update(out)
    res["ptxas"] = {src: ptxas_lines(src) for src in (
        "stag_v1_dslash.cu", "stag_v2_dslash.cu", "stag_v3_dslash.cu")}
    emit(res)
    return {name: max(r["max_abs_err"] for r in recs.values())
            for name, recs in out.items()}


def phase_stag_generations_time(gen) -> dict:
    """Phase 17: the generation benchmark's A/B at 32^4 over every
    instance (its main path: the counts are read around it), then each
    instance and B1/B1b timed at 24^4 ("at_24") and 32^4 by CUDA events
    over 200 launches, replayed from a CUDA graph ("ms", the kernel's
    device time) and launched from the host ("ms_eager_launches", which
    the wrapper's host cost bounds from below at some 22-39 us), with
    its plain twin, GB/s by its bytes per site, GFLOP/s by its flops per
    site and its bound at the data-sheet peaks and at the stream."""
    from qex_tpu_torch.bench import stag_generations as gens
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice(GEN_DIMS)
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    t0 = time.perf_counter()
    lines = []
    records = gens.ab(lat, gens.all_instances(), iters=50, seed=SEED,
                      emit=lambda line: lines.append(json.loads(line)))
    ab_s = time.perf_counter() - t0
    launches = read_counts()
    bw = stream_bandwidth_gbs()
    timed = dict(gen_instances())
    timed.update({"stag8_dslash": gens.Instance("s8"),
                  "stag8_dslash_bf16": gens.Instance("s8", torch.bfloat16)})
    out = {}
    for dims in ((24, 24, 24, 24), GEN_DIMS):
        tlat = Lattice(dims)
        s, x = gens.setup(tlat, SEED)
        for name, inst in timed.items():
            op = gens.build(inst, s)
            v = gens.to_layout(inst.kind, x)
            hop, plain = gens.hop(inst, op), gens.plain_hop(inst, op)
            k_ms = graph_time_ms(lambda: hop(v, 0))
            eager_ms = cuda_time_ms(lambda: hop(v, 0), reps=200)
            p_ms = cuda_time_ms(lambda: plain(v, 0), reps=5, rounds=3)
            n = tlat.volume // 2
            nbytes = gens.bytes_per_site(inst) * n
            flops = gens.flops_per_site(inst) * n
            bytes_ms = nbytes / PEAK_BYTES_S * 1e3
            flops_ms = flops / PEAK_F32_FLOPS * 1e3
            rec = {"ms": k_ms, "ms_eager_launches": eager_ms,
                   "plain_ms": p_ms,
                   "bytes_per_site": gens.bytes_per_site(inst),
                   "gflops": flops / (k_ms * 1e-3) / 1e9, "bytes": nbytes,
                   "gbs": nbytes / (k_ms * 1e-3) / 1e9,
                   "bound_ms": max(bytes_ms, flops_ms),
                   "bound_by": ("bytes" if bytes_ms >= flops_ms
                                else "operations")}
            add_stream_share(rec, bw)
            if dims == GEN_DIMS:
                out[name] = dict(rec, at_24=out[name])
            else:
                out[name] = rec
            del op
        del s, x
    res = {"phase": "stag_generations_time", "dims": list(GEN_DIMS),
           "stream_gbs": bw, "ab_seconds": ab_s, "ab": lines,
           "kernel_launches": launches, **out}
    emit(res)
    for rec in records:
        if not math.isfinite(rec["ms_per_hop"]):
            raise AssertionError(f"A/B {rec['instance']}: no time")
    for name in gen_instances():
        if launches[name] <= 0:
            raise AssertionError(f"stag_generations_time: {name} never "
                                 f"launched in the A/B")
    return res


def phase_stag_generations_cg(gen) -> dict:
    """Phase 18: cg_solve at 32^4 (exp_s8.py's m=0.1), r2req 1e-10, on
    expm(0.7 tah) links, through d2ee of v1, v2, v3, v4 (float32 links)
    and B1's d2ee_stag8; true r^2 by the complex128 fast-layout
    operator."""
    from qex_tpu_torch.bench import stag_generations as gens
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers import cg
    lat = Lattice(GEN_DIMS)
    m, r2req = GEN_MASS, 1e-10
    s = sf.new_fast(st.new_stag_eo(lat, random_links(lat, gen)))
    b = fast_vector(lat, gen)
    s64 = sf.FastStagEO(lat, s.g_e.to(torch.complex128),
                        s.g_o.to(torch.complex128))
    b64 = b.to(torch.complex128)
    res = {"phase": "stag_generations_cg", "dims": list(GEN_DIMS), "m": m,
           "r2req": r2req}
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    for kind in ("s8", "v1", "v2", "v3", "v4"):
        op = gens.build(gens.Instance(kind), s)
        a = gens.d2ee(kind, op)
        bk = gens.to_layout(kind, b)
        (x, stats), secs = timed_once_s(lambda: cg.cg_solve(
            lambda v: a(v, m), bk, r2req=r2req, maxits=3000))
        r = sf.d2ee_fast(s64, gens.from_layout(kind, x).to(
            torch.complex128), m) - b64
        true = float((r.abs() ** 2).sum() / (b64.abs() ** 2).sum())
        res[kind] = {"iterations": stats.iterations, "solver_r2": stats.r2,
                     "true_rel_r2": true, "seconds": secs,
                     "seconds_per_iteration": secs / stats.iterations}
        del op, x
    res["kernel_launches"] = read_counts()
    emit(res)
    its = res["s8"]["iterations"]
    for kind in ("s8", "v1", "v2", "v3", "v4"):
        if not res[kind]["true_rel_r2"] <= TOL_RES:
            raise AssertionError(f"stag_generations_cg {kind}: true "
                                 f"residual {res[kind]['true_rel_r2']}")
        if abs(res[kind]["iterations"] - its) > TOL_CG_ITS:
            raise AssertionError(f"stag_generations_cg {kind}: "
                                 f"{res[kind]['iterations']} iterations "
                                 f"against B1's {its}")
    for name in ("stag8_dslash", "stag_v1_dslash", "stag_v2_dslash",
                 "stag_v3_dslash", "stag_v4_dslash"):
        if res["kernel_launches"][name] <= 0:
            raise AssertionError(f"stag_generations_cg: {name} never "
                                 f"launched")
    return res


# --- the pure-gauge path ----------------------------------------------------

def no_launches(tag: str) -> dict:
    """The launch counts since the last reset; raises if any kernel was
    launched (the pure-gauge path runs no hop kernel)."""
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"{tag}: kernel launches {launches}")
    return launches


def wilson_hmc(lat, beta: float = 6.0):
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.hmc import integrators
    c = ga.wilson(beta)
    return (functools.partial(ga.full_action, c, lat),
            functools.partial(ga.gauge_force, c, lat),
            integrators.get_integrator("2MN"))


def phase_puregauge_accept(gen) -> dict:
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.hmc import hmc
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import group
    from qex_tpu_torch.utils import resample
    lat = Lattice((8, 8, 8, 16))
    act, frc, scheme = wilson_hmc(lat)
    u = group.unit_gauge(lat, torch.complex64, "cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(30):
        u, _st = hmc.hmc_step(gen, u, act, frc, scheme, 1.0, 10,
                              always_accept=True)
    for _ in range(5):
        u, _st = hmc.hmc_step(gen, u, act, frc, scheme, 1.0, 20)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plaqs, dhs, accs = [], [], []
    for _ in range(ACCEPT_N_MEAS):
        u, st = hmc.hmc_step(gen, u, act, frc, scheme, 1.0, 20)
        plaqs.append(float(loops.plaquette(lat, u)))
        dhs.append(st.dH)
        accs.append(st.accepted)
    t2 = time.perf_counter()
    launches = no_launches("puregauge_accept")
    cpu = json.loads((ROOT / "ACCEPT_CPU.json").read_text())
    cpu_mean, cpu_err = resample.jackknife(cpu["plaq_series"],
                                           block=ACCEPT_CPU_BLOCK)
    block = ACCEPT_N_MEAS // ACCEPT_MIN_BLOCKS
    mean, err = resample.jackknife(plaqs, block=block)
    z = abs(mean - cpu_mean) / math.hypot(err, cpu_err)
    acc = sum(accs) / len(accs)
    # Creutz's equality <exp(-dH)> = 1: a biased MD breaks it even where
    # it accepts
    creutz, creutz_err = resample.jackknife([math.exp(-d) for d in dhs],
                                            block=block)
    creutz_z = abs(creutz - 1.0) / creutz_err
    cpu_creutz = resample.jackknife([math.exp(-d) for d in cpu["dH"]],
                                    block=ACCEPT_CPU_BLOCK)
    res = {"phase": "puregauge_accept", "dims": list(lat.dims),
           "n_meas": ACCEPT_N_MEAS, "acceptance": acc,
           "plaq_mean": mean, "plaq_err": err, "block": block,
           "n_blocks": ACCEPT_N_MEAS // block,
           "tau_int": resample.autocorrelation_time(plaqs),
           "cpu_f64_plaq_mean": cpu_mean, "cpu_f64_plaq_err": cpu_err,
           "cpu_block": ACCEPT_CPU_BLOCK,
           "cpu_n_blocks": len(cpu["plaq_series"]) // ACCEPT_CPU_BLOCK,
           "cpu_acceptance": cpu["acceptance"], "z": z,
           "dH_mean": statistics.fmean(dhs),
           "dH_rms": math.sqrt(statistics.fmean(d * d for d in dhs)),
           "exp_minus_dH_mean": creutz, "exp_minus_dH_err": creutz_err,
           "exp_minus_dH_z": creutz_z,
           "cpu_f64_exp_minus_dH": list(cpu_creutz),
           "seconds_warmup": t1 - t0,
           "seconds_per_traj_20_steps": (t2 - t1) / ACCEPT_N_MEAS,
           "seconds": t2 - t0, "kernel_launches": launches}
    emit(res)
    if not all(math.isfinite(x) for x in plaqs + dhs):
        raise AssertionError("puregauge_accept: non-finite plaquette or dH")
    if not z <= ACCEPT_Z:
        raise AssertionError(f"puregauge_accept: plaquette {mean} +- {err} "
                             f"is {z:.2f} sigma from the float64 chain's "
                             f"{cpu_mean} +- {cpu_err}")
    if not creutz_z <= ACCEPT_Z:
        raise AssertionError(f"puregauge_accept: <exp(-dH)> {creutz} +- "
                             f"{creutz_err} is {creutz_z:.2f} sigma from 1")
    if not acc >= ACCEPT_MIN:
        raise AssertionError(f"puregauge_accept: acceptance {acc}")
    return res


def northstar_chain(out_path: str) -> int:
    """The chain of phase 19a, in the process that runs it: the port's
    app on the deck with the launch counts set to 0 just before and read
    just after, plain B1 calls on card tensors counted; writes the app's
    lines, seconds (host clock, CUDA sync), counts and peak memory to
    ``out_path`` as JSON."""
    import re

    from qex_tpu_torch.apps import staghmc_spv
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.utils.config import HMCConfig
    cfg = HMCConfig.from_xml(str(NS_DECK))
    pbp_freq = int(re.search(r"<pbp_freq>\s*(\d+)\s*</pbp_freq>",
                             NS_DECK.read_text()).group(1))
    ntraj = cfg.no_metropolis_until + NS_N_MEAS
    plain_calls = []
    plain = sh.dslash_stag8_plain

    def counted_plain(p8, x, *a, **k):
        if x.is_cuda:
            plain_calls.append(1)
        return plain(p8, x, *a, **k)

    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                         # count the main path only
    sh.dslash_stag8_plain = counted_plain
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = staghmc_spv.main(["--xml", str(NS_DECK), "--ntraj",
                                   str(ntraj), f"-pbp_freq={pbp_freq}"])
        torch.cuda.synchronize()
    finally:
        sh.dslash_stag8_plain = plain
    Path(out_path).write_text(json.dumps({
        "rc": rc, "ntraj": ntraj, "seconds": time.perf_counter() - t0,
        "launches": read_counts(), "plain_calls": len(plain_calls),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "lines": out.getvalue().splitlines()}))
    return 0


def start_northstar_accept() -> dict:
    """Phase 19a, begun: check the deck against ACCEPT_NS_CPU.json and
    start :func:`northstar_chain` in a process of its own on the card.
    The chain is bound by its host launches (~2 s a 4^4 trajectory, a few
    MB of the card), so the later phases run beside it; the process is
    killed if the script ends first."""
    import atexit
    import hashlib
    ref = json.loads((ROOT / "ACCEPT_NS_CPU.json").read_text())
    sha = hashlib.sha256(NS_DECK.read_bytes()).hexdigest()
    if sha != ref["deck_sha256"]:
        raise AssertionError(f"northstar_accept: deck sha256 {sha} is not "
                             f"the reference chain's {ref['deck_sha256']}")
    out = ROOT / "build" / "northstar_accept.json"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    log = open(ROOT / "build" / "northstar_accept.err", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--northstar-chain",
         str(out)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "out": out, "log": log, "ref": ref, "sha": sha,
            "t0": time.perf_counter()}


def finish_northstar_accept(run: dict) -> dict:
    """Phase 19a, ended: wait for the chain and hold it against the
    reference (``utils.chain.gate``); raises on a failed gate, a kernel
    other than B1, a plain B1 call on the card or a failed process."""
    from qex_tpu_torch.utils import chain
    from qex_tpu_torch.utils.config import HMCConfig
    rc = run["proc"].wait(timeout=max(
        1.0, NS_TIMEOUT_S - (time.perf_counter() - run["t0"])))
    wall = time.perf_counter() - run["t0"]
    run["log"].close()
    if rc != 0 or not run["out"].exists():
        raise AssertionError(
            f"northstar_accept: the chain's process exited {rc}: "
            + (ROOT / "build" / "northstar_accept.err").read_text()[-3000:])
    child = json.loads(run["out"].read_text())
    lines, launches, ref = child["lines"], child["launches"], run["ref"]
    (ROOT / "build" / "northstar_accept.log").write_text(
        "\n".join(lines) + "\n")
    if child["rc"] != 0:
        raise AssertionError(f"northstar_accept: staghmc_spv exited "
                             f"{child['rc']}")
    cfg = HMCConfig.from_xml(str(NS_DECK))
    series = chain.parse_app_lines(lines)
    g = chain.gate(series, ref["stats"])
    que = ref["quenched"]["stats"]["plaq"]
    app_s = [float(ln.split("(")[1].split()[0]) for ln in lines
             if ln.startswith(("ACCEPT", "REJECT"))]
    ntraj = child["ntraj"]
    res = {"phase": "northstar_accept", "dims": list(cfg.dims),
           "tau": cfg.tau, "steps": [cfg.g_steps, cfg.f_steps,
                                     cfg.pv_steps],
           "warmup": cfg.no_metropolis_until, "n_meas": len(series["dH"]),
           "deck_sha256": run["sha"], "acceptance": g["acceptance"],
           "block": g["block"], "n_blocks": g["n_blocks"],
           "pbp_block": g["pbp_block"], "pbp_n_blocks": g["pbp_n_blocks"],
           "tau_int": g["tau_int"],
           "plaq": g["plaq"], "ref_plaq": ref["stats"]["plaq"],
           "z_plaq": g["z_plaq"], "real_share": g["real_share"],
           "ref_real_share": ref["stats"]["real_share"],
           **{k: g[k] for k in chain.CLASSES},
           **{f"ref_{k}": ref["stats"][k] for k in chain.CLASSES},
           "z_pbp": g["z_pbp"], "pbp_all_sectors": g["pbp"],
           "exp_minus_dH": g["exp_minus_dH"], "z_creutz": g["z_creutz"],
           "ref_acceptance": ref["acceptance"],
           "ref_block": ref["stats"]["block"],
           "z_quenched": chain.z_score(g["plaq"], que),
           "ref_z_fermion": ref["z_fermion_by"],
           "dH_rms": math.sqrt(statistics.fmean(
               d * d for d in series["dH"])),
           "seconds": child["seconds"],
           "seconds_per_traj": child["seconds"] / ntraj,
           "app_seconds_per_traj_median": statistics.median(app_s),
           "wall_from_start_s": wall,
           "b1_launches_per_traj": launches["stag8_dslash"] / ntraj,
           "max_memory_allocated_gib": child["max_memory_allocated"] / 2**30,
           "plain_twin_calls_on_card": child["plain_calls"],
           "kernel_launches": launches, "failures": g["failures"]}
    emit(res)
    if launches["stag8_dslash"] <= 0:
        raise AssertionError("northstar_accept: B1 never launched")
    others = {k: v for k, v in launches.items()
              if v and k != "stag8_dslash"}
    if others or child["plain_calls"]:
        raise AssertionError(f"northstar_accept: other kernels {others}, "
                             f"{child['plain_calls']} plain B1 calls on the "
                             "card")
    if g["failures"]:
        raise AssertionError("northstar_accept: " + "; ".join(g["failures"]))
    return res


def phase_northstar_accept() -> dict:
    """Phase 19a alone: start the chain and wait for it."""
    return finish_northstar_accept(start_northstar_accept())


def phase_puregauge_config3(gen) -> dict:
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.hmc import hmc
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import group
    lat = Lattice((16, 16, 16, 32))
    act, frc, scheme = wilson_hmc(lat)
    u = group.unit_gauge(lat, torch.complex64, "cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(30):
        u, _st = hmc.hmc_step(gen, u, act, frc, scheme, 1.0, 10,
                              always_accept=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rows = []
    for ns in CONFIG3_NSTEPS:
        torch.cuda.reset_peak_memory_stats()
        dhs, accs, dhs64, secs = [], [], [], 0.0
        for _ in range(4):
            # momenta and uniform drawn once, in float64: the chain's
            # float32 trajectory and a float64 control from the same
            # (u, p), which the chain does not follow
            u64 = u.to(torch.complex128)
            p64 = hmc.draw_momenta(gen, u64)
            r = hmc.draw_uniform(gen)
            (u, st), s32 = timed_once_s(lambda: hmc.hmc_step_from(
                u, p64.to(torch.complex64), r, act, frc, scheme, 1.0, ns))
            secs += s32
            dhs.append(st.dH)
            accs.append(st.accepted)
            _, st64 = hmc.hmc_step_from(u64, p64, r, act, frc, scheme, 1.0,
                                        ns)
            dhs64.append(st64.dH)
        if not all(math.isfinite(d) for d in dhs + dhs64):
            raise AssertionError(f"puregauge_config3: dH {dhs} {dhs64}")
        rows.append({"nsteps": ns, "dH": dhs,
                     "dH_mean": statistics.fmean(dhs),
                     "dH_rms": math.sqrt(statistics.fmean(
                         d * d for d in dhs)),
                     "acceptance": sum(accs) / 4,
                     "seconds_per_traj": secs / 4,
                     "peak_mem_gib":
                         torch.cuda.max_memory_allocated() / 2**30,
                     "dH_f64_md": dhs64,
                     "dH_f64_md_rms": math.sqrt(statistics.fmean(
                         d * d for d in dhs64)),
                     "dH_f32_minus_f64_md_max": max(
                         abs(a - b) for a, b in zip(dhs, dhs64))})
    plaq = float(loops.plaquette(lat, u))
    launches = no_launches("puregauge_config3")
    rect = functools.partial(ga.gauge_force, ga.symanzik(6.0), lat, u)
    _f, rect_first_s = timed_once_s(rect)     # includes torch.func set-up
    del _f
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    f, rect_s = timed_once_s(rect)
    rect_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if not bool(torch.isfinite(torch.view_as_real(f)).all()):
        raise AssertionError("puregauge_config3: rect force not finite")
    del f
    res = {"phase": "puregauge_config3", "dims": list(lat.dims),
           "seconds_warmup_30x10": warm_s, "by_nsteps": rows,
           "plaquette": plaq, "links_gib": u.numel() * 8 / 2**30,
           "rect_force_seconds": rect_s,
           "rect_force_first_call_seconds": rect_first_s,
           "rect_force_peak_extra_gib": rect_peak,
           "kernel_launches": launches}
    emit(res)
    if not 0.0 < plaq < 1.0:
        raise AssertionError(f"puregauge_config3: plaquette {plaq}")
    return res


def phase_flow(gen) -> dict:
    from qex_tpu_torch.gauge import flow as gf
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice((16, 16, 16, 16))
    c = gf.wilson_flow_coeffs(lat.nc)
    u = random_links(lat, gen, scale=0.3)
    plaq0 = float(loops.plaquette(lat, u))
    gf.flow(c, lat, u, 0.02, 1, measure=False)            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    v, _ = gf.flow(c, lat, u, 0.02, 50, measure=False)
    m = gf.measure_flow(lat, v, 0.02 * 50)
    t2e = float(m.t2e_clover)
    secs = time.perf_counter() - t0
    plaq1 = float(m.plaq)
    launches = no_launches("flow")
    # the same 5-step flow at 4^4 on the card and on the host
    small = Lattice((4, 4, 4, 4))
    w = random_links(small, gen, dtype=torch.complex128, scale=0.3)
    wc, mc = gf.flow(c, small, w.to(torch.complex64), 0.02, 5)
    wh, mh = gf.flow(c, small, w.cpu(), 0.02, 5)
    dev = {"links": float(torch.linalg.vector_norm(wc.cpu() - wh)
                          / torch.linalg.vector_norm(wh)),
           "t2e_clover": float((mc.t2e_clover.cpu() - mh.t2e_clover).abs()
                               .max() / mh.t2e_clover.abs().max()),
           "t2e_plaq": float((mc.t2e_plaq.cpu() - mh.t2e_plaq).abs()
                             .max() / mh.t2e_plaq.abs().max())}
    res = {"phase": "flow", "dims": list(lat.dims), "eps": 0.02,
           "steps": 50, "seconds": secs, "t2e_clover": t2e,
           "t2e_plaq": float(m.t2e_plaq), "topo_q": float(m.topo_q),
           "plaquette_before": plaq0, "plaquette_after": plaq1,
           "card_vs_host_4c4_rel_dev": dev, "kernel_launches": launches}
    emit(res)
    if not plaq1 > plaq0:
        raise AssertionError(f"flow: plaquette {plaq0} -> {plaq1}")
    if not (math.isfinite(t2e) and t2e > 0.0):
        raise AssertionError(f"flow: t2E_clover {t2e}")
    for k in ("links", "t2e_clover", "t2e_plaq"):
        x = dev[k]
        if not x <= TOL_FLOW:
            raise AssertionError(f"flow: card and host {k} differ by {x}")
    return res


def _run_main(main_fn, argv: list[str]) -> list[str]:
    """Run an app's main in this process; echo and return its lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    lines = out.getvalue().splitlines()
    for ln in lines:
        print("  | " + ln, flush=True)
    if rc != 0:
        raise AssertionError(f"{argv}: exited {rc}")
    return lines


def _finite_numbers(lines: list[str], tag: str, n: int) -> list[list[float]]:
    """The numeric words of the ``n`` lines starting with ``tag``;
    raises on a missing line or a non-finite number."""
    rows = []
    for ln in lines:
        if ln.startswith(tag):
            nums = []
            for w in ln.replace("(", " ").split():
                try:
                    nums.append(float(w))
                except ValueError:
                    continue
            if not all(math.isfinite(x) for x in nums):
                raise AssertionError(f"non-finite number in {ln!r}")
            rows.append(nums)
    if len(rows) != n:
        raise AssertionError(f"{len(rows)} {tag!r} lines, expected {n}")
    return rows


def phase_apps_gauge() -> dict:
    import tempfile
    import xml.etree.ElementTree as ET
    from qex_tpu_torch.apps import gauge_flow, puregauge_hmc, staghmc_spv
    decks = ROOT / "qex_tpu_torch" / "apps" / "decks"
    res = {"phase": "apps_gauge"}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ckpt = str(Path(tmp) / "puregauge_8.npz")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        lines = _run_main(puregauge_hmc.main, [
            "--lattice", "8", "8", "8", "8", "--c1", "-0.0833333",
            "--steps", str(PG_APP_STEPS), "--warmup", str(PG_APP_WARMUP),
            "--ntraj", str(PG_APP_NTRAJ), "--save", ckpt])
        res["puregauge_hmc_s"] = time.perf_counter() - t0
        trajs = _finite_numbers(lines, "traj ", PG_APP_NTRAJ)
        res["puregauge_hmc_traj"] = trajs
        accepted = [ln for ln in lines if ln.startswith("traj ")
                    and " ACCEPT " in ln and "[warmup]" not in ln]
        res["puregauge_hmc_accepted_after_warmup"] = len(accepted)
        if not accepted:
            raise AssertionError("apps_gauge: puregauge_hmc accepted no "
                                 "trajectory after its warm-up")
        flows = {}
        for deck in ("flow_wilson_8.xml", "flow_rect_8.xml"):
            t0 = time.perf_counter()
            lines = _run_main(gauge_flow.main, [
                "--xml", str(decks / deck), "--load", ckpt])
            rows = _finite_numbers(lines, "FLOW ", 9)
            flows[deck] = {"seconds": time.perf_counter() - t0,
                           "last": rows[-1]}
        res["gauge_flow"] = flows
        res["kernel_launches_pure_gauge"] = no_launches("apps_gauge")
        tree = ET.parse(decks / "config4_24.xml")
        root = tree.getroot()
        for path, val in (("action/geom/Ns", "8"), ("action/geom/Nt", "8"),
                          ("action/gauge/gauge_act", "rect"),
                          ("hmc/gauge_int_alg", "FGI")):
            root.find(path).text = val
        rect = ET.SubElement(root.find("action/gauge"), "rect")
        ET.SubElement(rect, "c1").text = repr(-1.0 / 12.0)
        deck = str(Path(tmp) / "config4_8_rect_fgi.xml")
        tree.write(deck)
        reset_counts()
        t0 = time.perf_counter()
        lines = _run_main(staghmc_spv.main, ["--xml", deck, "--ntraj", "1"])
        res["staghmc_spv_rect_fgi_s"] = time.perf_counter() - t0
        launches = read_counts()
        res["staghmc_spv_kernel_launches"] = launches
        for tag in ("Begin H", "End H", "MEASplaq "):
            _finite_numbers(lines, tag, 1)
        res["staghmc_spv_dH"] = _finite_numbers(
            [ln for ln in lines if ln.startswith(("ACCEPT", "REJECT"))],
            "", 1)[0][0]
        if launches["stag8_dslash"] <= 0:
            raise AssertionError("apps_gauge: staghmc_spv never launched B1")
        others = {k: v for k, v in launches.items()
                  if k != "stag8_dslash" and v}
        if others:
            raise AssertionError(f"apps_gauge: staghmc_spv launched {others}")
    emit(res)
    return res


# --- the rest of the staggered catalogue ------------------------------------

def _even_true_r2(s64, x_e, m: float, b_e) -> float:
    """|A(m) x - b|^2 / |b|^2 of the even system, with the plain
    canonical operator in complex128."""
    from qex_tpu_torch.physics import staggered as st
    x = x_e.to(torch.complex128)
    return rel2(st.d2ee(s64, x, m), b_e.to(torch.complex128))


def phase_stag_multi(gen) -> dict:
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import eo, group
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice(GEN_DIMS)
    u = torch.stack([group.random_su(gen, lat.dims, lat.nc, torch.complex64)
                     for _ in range(lat.nd)])
    s = st.new_stag_eo(lat, u)
    s64 = st.new_stag_eo(lat, u.to(torch.complex128))
    b = eo.pack(torch.randn(lat.vector_shape(), dtype=torch.complex64,
                            generator=gen, device=gen.device), 4)[0]
    res = {"phase": "stag_multi", "dims": list(lat.dims),
           "links": "Haar random", "r2req": MULTI_R2REQ}
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    runs = {}
    for route, masses, sloppy in (("f32_refined", MULTI_LIGHT, False),
                                  ("sloppy", MULTI_HEAVY, True)):
        params = SolverParams(r2req=MULTI_R2REQ, maxits=1200, restarts=3,
                              sloppy=sloppy)
        before = read_counts()
        (xs, stats), secs = timed_once_s(
            lambda: stag_solve.solve_multi(s, b, masses, params))
        after = read_counts()
        runs[route] = (masses, xs, {
            "masses": list(masses), "sloppy": sloppy,
            "iterations": stats.iterations, "solver_r2": stats.r2,
            "seconds": secs,
            "kernel_launches": {k: after[k] - before[k] for k in after}})
    blat = Lattice((24, 24, 24, 24))
    bu = random_links(blat, gen)
    bs = torch.randn((3,) + blat.vector_shape(), dtype=torch.complex64,
                     generator=gen, device=gen.device)
    bsolve = st.new_stag_eo(blat, bu)
    before = read_counts()
    (xb, bstats), bsecs = timed_once_s(lambda: stag_solve.solve_batched(
        bsolve, bs, 0.05, SolverParams(r2req=MULTI_R2REQ, maxits=5000,
                                       restarts=5)))
    after = read_counts()
    launches = read_counts()
    for route, (masses, xs, rec) in runs.items():
        rec["true_rel_r2"] = [_even_true_r2(s64, x, m, b)
                              for x, m in zip(xs, masses)]
        res[route] = rec
    del runs, xs
    b64 = st.new_stag_eo(blat, bu.to(torch.complex128))
    true_b = []
    for bb, x in zip(bs, xb):
        be, bo = (v.to(torch.complex128) for v in eo.pack(bb, 4))
        rhs = 0.05 * be - st.dslash_eo(b64, bo, 0)
        true_b.append(_even_true_r2(b64, eo.pack(x, 4)[0], 0.05, rhs))
    res["batched"] = {"dims": list(blat.dims), "m": 0.05, "nrhs": 3,
                      "iterations": [x.iterations for x in bstats],
                      "seconds": bsecs, "true_rel_r2_even_system": true_b,
                      "kernel_launches": {k: after[k] - before[k]
                                          for k in after}}
    res["kernel_launches"] = launches
    emit(res)
    for route in ("f32_refined", "sloppy"):
        for m, r2 in zip(res[route]["masses"], res[route]["true_rel_r2"]):
            if not r2 <= TOL_MULTI:
                raise AssertionError(f"stag_multi {route}: mass {m} true "
                                     f"residual {r2}")
    for k, route in (("stag8_dslash", "f32_refined"),
                     ("stag8_dslash_bf16", "sloppy")):
        if res[route]["kernel_launches"][k] <= 0:
            raise AssertionError(f"stag_multi {route}: {k} never launched")
    for r2 in true_b:
        if not r2 <= TOL_RES:
            raise AssertionError(f"stag_multi batched: true residual {r2}")
    if res["batched"]["kernel_launches"]["stag8_dslash"] <= 0:
        raise AssertionError("stag_multi batched: B1 never launched")
    return res


def rooted_theory(lat, nf: int = 2):
    """Config 4 as it is run (nHYP) with the fermion rooted to ``nf``."""
    import dataclasses
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.mcmc.theory import FermionSpec, LatticeFieldTheory
    th = config4_theory(lat, smear=HypCoefs(0.4, 0.5, 0.5))
    fermions = [dataclasses.replace(f, kind="rooted", nf=nf)
                if f.kind == "fermion" else f for f in th.fermions]
    return LatticeFieldTheory(lat, th.gauges, fermions, th.smear_coefs,
                              th.bc, th.solver_params,
                              th.force_solver_params, th.tau)


def hisq_hasenbusch_theory(lat):
    """Phase 10's HISQ theory with one Hasenbusch mass, 0.4."""
    import dataclasses
    from qex_tpu_torch.mcmc.theory import LatticeFieldTheory
    th = hisq_theory(lat)
    fermions = [dataclasses.replace(f, hmasses=(0.4,))
                for f in th.fermions]
    return LatticeFieldTheory(lat, th.gauges, fermions, th.smear_coefs,
                              th.bc, th.solver_params,
                              th.force_solver_params, th.tau)


def _split_patches():
    """smear forward, smear pullback and solves (single-mass and
    multishift) of a staggered theory, for :func:`split_timer`."""
    from qex_tpu_torch.mcmc import md
    from qex_tpu_torch.mcmc.theory import LatticeFieldTheory
    from qex_tpu_torch.physics import stag_hmc, stag_solve
    return [("smear_forward", LatticeFieldTheory, "_smear"),
            ("smear_pullback", md, "_pullback"),
            ("solves", stag_solve, "solve_ee"),
            ("solves", stag_hmc.StagRootedFermion, "_multishift")]


def _traj_lines(lines: list[str], prefixes: tuple) -> list[dict]:
    """dH and seconds of the app's trajectory verdict lines."""
    out = []
    for ln in lines:
        if ln.startswith(prefixes):
            words = ln.replace("(", " ").split()
            out.append({"dH": float(words[words.index("dH") + 1]),
                        "seconds": float(words[words.index("s)") - 1]),
                        "line": ln})
    return out


def phase_rhmc(gen) -> dict:
    from qex_tpu_torch.apps import staghmc_spv
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_hmc
    from qex_tpu_torch.solvers.base import SolverParams
    from qex_tpu_torch.solvers.rational import rational_approx
    deck = str(ROOT / "qex_tpu_torch" / "apps" / "decks" / "config4_24.xml")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                         # count the main path only
    with split_timer(_split_patches()) as split:
        t0 = time.perf_counter()
        lines = _run_main(staghmc_spv.main, [
            "--xml", deck, "--ntraj", str(RHMC_NTRAJ), "-nf=2",
            "-check_solvers=1", "-save_freq=0"])
        wall = time.perf_counter() - t0
    split["rest"] = wall - sum(split.values())
    split["wall"] = wall
    launches = read_counts()
    trajs = _traj_lines(lines, ("ACCEPT", "REJECT"))
    plaqs = [r[0] for r in _finite_numbers(lines, "MEASplaq ", RHMC_NTRAJ)]
    solver = [ln.split() for ln in lines if ln.startswith("SOLVER rooted")]
    m, mm = 0.05, 0.05 ** 2
    approx = {}
    for key, (num, den) in (("heatbath_A^(+nf/8)", (2, 8)),
                            ("action_A^(-nf/4)", (-2, 4))):
        ra = rational_approx(num, den, mm, mm + 16.0, 10)
        approx[key] = {"degree": ra.degree, "max_rel_err": ra.max_rel_err,
                       "lo": ra.lo, "hi": ra.hi, "smallest_shift":
                       min(ra.poles)}
    # the same multishift on rough unsmeared expm(0.7 tah) links, where
    # the smallest shift's complex64 residual may stall above r2req, at
    # the deck's mass and a lighter one
    lat = Lattice((24, 24, 24, 24))
    u = random_links(lat, gen)
    probe = []
    for mp in (m, 0.01):
        ferm = stag_hmc.StagRootedFermion(lat, mp, nf=2, params=SolverParams(
            r2req=1e-10, maxits=3000, restarts=3))
        its, r2 = ferm.check_solve(u, ferm.heatbath(gen, u))
        probe.append({"m": mp, "multishift_iterations": its,
                      "smallest_shift_true_rel_r2": r2})
    del u
    res = {"phase": "rhmc", "dims": [24, 24, 24, 24], "nf": 2, "m": m,
           "trajectories": trajs,
           "seconds_per_traj": [r["seconds"] for r in trajs],
           "plaquettes": plaqs, "split_seconds": split,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "rational": approx,
           "multishift_iterations": [int(w[w.index("its") + 1])
                                     for w in solver],
           "smallest_shift_true_rel_r2": [float(w[w.index("relr2") + 1])
                                          for w in solver],
           "rough_links_probe": {"links": "expm(0.7 tah), unsmeared",
                                 "r2req": 1e-10, "by_mass": probe},
           "kernel_launches": launches}
    emit(res)
    if len(trajs) != RHMC_NTRAJ or not all(math.isfinite(r["dH"])
                                           for r in trajs):
        raise AssertionError(f"rhmc: dH {[r['dH'] for r in trajs]}")
    if not all(0.0 < p < 1.0 for p in plaqs):
        raise AssertionError(f"rhmc: plaquettes {plaqs}")
    if launches["stag8_dslash"] <= 0:
        raise AssertionError("rhmc: B1 never launched")
    return res


def phase_hasenbusch(gen) -> dict:
    from qex_tpu_torch.apps import mcmc_hmc
    from qex_tpu_torch.lattice import Lattice
    deck = str(ROOT / "qex_tpu_torch" / "apps" / "decks"
               / "hasenbusch_24.json")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                         # count the main path only
    t0 = time.perf_counter()
    lines = _run_main(mcmc_hmc.main, ["--json", deck, "--ntraj", "2"])
    secs = time.perf_counter() - t0
    app_launches = read_counts()
    trajs = _traj_lines(lines, ("traj ",))
    _finite_numbers(lines, "traj ", 2)
    plaqs = [float(ln.split("MEASplaq ")[1].split()[0]) for ln in lines
             if ln.startswith("traj ")]
    res = {"phase": "hasenbusch", "deck": "hasenbusch_24.json",
           "terms": lines[0], "mcmc_hmc_trajectories": trajs,
           "mcmc_hmc_seconds": secs, "plaquettes": plaqs,
           "mcmc_hmc_peak_mem_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "mcmc_hmc_kernel_launches": app_launches}
    lat = Lattice((24, 24, 24, 24))
    th = hisq_hasenbusch_theory(lat)
    u = random_links(lat, gen, scale=HISQ_START)
    u, htrajs = run_trajectories(th, lat, gen, u, 1, "hasenbusch hisq",
                                 "hisq16_dslash")
    launches = read_counts()
    res.update({"hisq_terms": [t.name for t in th.terms],
                "hisq_trajectory": htrajs[0], "kernel_launches": launches})
    emit(res)
    if len(trajs) != 2 or not all(math.isfinite(r["dH"]) for r in trajs):
        raise AssertionError(f"hasenbusch: mcmc_hmc dH {trajs}")
    if not all(0.0 < p < 1.0 for p in plaqs):
        raise AssertionError(f"hasenbusch: plaquettes {plaqs}")
    if app_launches["stag8_dslash"] <= 0:
        raise AssertionError("hasenbusch: mcmc_hmc never launched B1")
    return res


def phase_northstar32(gen) -> dict:
    """One config-4 trajectory (nHYP) at exp_northstar32.py's volume from
    its cold start, after B1 is held against its plain twin at that
    volume (both parities and the fused d2ee, TOL_KERNEL) on rough links
    and a vector of a generator of their own, so that the trajectory
    draws what it drew before the check existed."""
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import group
    lat = Lattice(NORTHSTAR_DIMS)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    check = compare_hop("stag8_dslash",
                        make_ops("stag8", lat, random_links(lat, g))(
                            torch.float32), fast_vector(lat, g))
    torch.cuda.empty_cache()
    th = config4_theory(lat, smear=HypCoefs(0.4, 0.5, 0.5))
    u = group.unit_gauge(lat, torch.complex64, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                         # count the main path only
    # accepted whatever its dH: from the cold start a rejected
    # trajectory would leave the plaquette at 1
    u, rec, split = split_run(th, lat, gen, u, _split_patches(),
                              "northstar32", "stag8_dslash", 0,
                              always_accept=True)
    res = {"phase": "northstar32", "dims": list(lat.dims),
           "stag8_dslash_vs_plain": check, "trajectory": rec,
           "seconds_per_traj": rec["seconds"], "split_seconds": split,
           "peak_mem_gib": rec["peak_mem_gib"],
           "kernel_launches": read_counts()}
    emit(res)
    return res


# --- the measurement tier ----------------------------------------------------

def _even_fast_plain(kind: str, op):
    """A(m) x = m^2 x - D D x through the plain twin of the 8- or
    16-term kernel, in x's precision (complex128 on the card for the
    checks)."""
    _hop, plain, _d2ee = hop_fns(kind)

    def apply(x, m: float = 0.0):
        return plain(op, plain(op, x, 1), 0, x_fuse=x, m2=m * m)
    return apply


def _rq_check(apply64, vecs_fast) -> tuple[list, list]:
    """Rayleigh quotients and true residual norms of unit fast-layout
    vectors under a complex128 operator."""
    ths, rs = [], []
    for v in vecs_fast:
        v = v.to(torch.complex128)
        v = v / torch.linalg.vector_norm(v)
        av = apply64(v)
        th = float(torch.vdot(v.flatten(), av.flatten()).real)
        ths.append(th)
        rs.append(float(torch.linalg.vector_norm(av - th * v)))
    return ths, rs


def phase_eigs_hisq(gen) -> dict:
    """exp_eigs24.py's run (ROUND3.md:120-137) at full size: 16 lowest
    eigenpairs of the HISQ normal operator at 24^3x48 on B2, then two
    deflated inverse-iteration passes on that basis, then CG against
    deflated CG at m = 0.05."""
    from qex_tpu_torch.eigens import hisqev
    from qex_tpu_torch.eigens.refine import refine_inverse_dev
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers import cg
    from qex_tpu_torch.solvers.deflate import deflated_cg, deflation_pays
    lat = Lattice(EIGS_DIMS)
    u = random_links(lat, gen)
    links = hisq_links(lat, u)
    del u
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                         # count the main path only
    t0 = time.perf_counter()
    with torch.no_grad():
        res = hisqev.stag_eigs(lat, None, EIGS_N, links=links,
                               degree=EIGS_DEGREE, tol=EIGS_TOL,
                               max_restarts=EIGS_RESTARTS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    op, example = hisqev._normal_op(lat, None, "pppa", True, links)
    vecs = sf.to_fast(res.vecs, lat)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref_evals, ref_vecs, ref_resids, _ = refine_inverse_dev(op, vecs,
                                                                iters=2)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    # deflation A/B on A(m) = m^2 - D D, the refined basis
    m = EIGS_DEFLATE_MASS
    op_m, _ = hisqev._normal_op(lat, None, "pppa", True, links, m=m)
    b = torch.randn(example.shape, dtype=example.dtype, generator=gen,
                    device=example.device)
    ab = {}
    for route in ("plain", "deflated"):
        def solve():
            if route == "plain":
                return cg.cg_solve_restarted(op_m, b, r2req=EIGS_R2REQ,
                                             maxits=3000, restarts=2)
            return deflated_cg(op_m, b, ref_evals + m * m, ref_vecs,
                               r2req=EIGS_R2REQ, maxits=3000, restarts=2)
        (x, stats), s_ = timed_once_s(solve)
        ab[route] = {"iterations": stats.iterations, "seconds": s_, "x": x}
    launches = read_counts()
    # the checks: B2's plain twin in complex128 on the card
    p16 = sh.new_hisq16(sf.new_fast3(st.new_stag3_eo(lat, *links)))
    kcheck = compare_hop("hisq16_dslash", p16, fast_vector(lat, gen))
    apply64 = _even_fast_plain("hisq16", p16)
    rq, true_r = _rq_check(apply64, vecs)
    b64 = b.to(torch.complex128)
    for route in ab:
        x64 = ab[route].pop("x").to(torch.complex128)
        ab[route]["true_rel_r2"] = rel2(apply64(x64, m), b64)
    pays = deflation_pays(res.evals, m)
    rq_dev = [abs(a - b_) for a, b_ in zip(rq, res.evals)]
    rq_floor = 2.0 ** -24 * res.info["window"][1] / math.sqrt(vecs[0].numel())
    tol_rq = [EIGS_RQ_REL * abs(e) + rq_floor for e in res.evals]
    out = {"phase": "eigs_hisq", "dims": list(lat.dims), "n": EIGS_N,
           "degree": res.info["degree"], "tol": EIGS_TOL,
           "max_restarts": EIGS_RESTARTS, "evals": res.evals.tolist(),
           "svals": res.svals.tolist(), "true_residuals": res.resids.tolist(),
           "matvecs_A": res.info["matvecs_A"], "cycles": res.info["cycles"],
           "converged": res.info["converged"],
           "window": list(res.info["window"]), "seconds": secs,
           "peak_mem_gib": peak,
           "rayleigh_c128_abs_dev": rq_dev, "rayleigh_tol": tol_rq,
           "true_residuals_c128": true_r,
           "hisq16_vs_plain": kcheck,
           "refined": {"iters": 2, "seconds": refine_s,
                       "evals": ref_evals.tolist(),
                       "true_residuals": ref_resids.tolist()},
           "deflation_ab": {"m": m, "r2req": EIGS_R2REQ, **ab,
                            "deflation_pays": pays},
           "kernel_launches": launches}
    emit(out)
    if not all(math.isfinite(r) and r <= EIGS_MAX_RESID for r in res.resids):
        raise AssertionError(f"eigs_hisq: true residuals {res.resids}")
    if not max(ref_resids) <= max(res.resids):
        raise AssertionError(f"eigs_hisq: refined residuals {ref_resids} "
                             f"above {res.resids}")
    if not all(d <= tl for d, tl in zip(rq_dev, tol_rq)):
        raise AssertionError(f"eigs_hisq: eigenvalues against their "
                             f"Rayleigh quotients {rq_dev}, limits {tol_rq}")
    if not all(math.isfinite(r) and r <= EIGS_MAX_RESID for r in true_r):
        raise AssertionError(f"eigs_hisq: complex128 true residuals "
                             f"{true_r}")
    for route, rec in ab.items():
        if not rec["true_rel_r2"] <= 10 * EIGS_R2REQ:
            raise AssertionError(f"eigs_hisq: {route} CG true r2 "
                                 f"{rec['true_rel_r2']}")
    if launches["hisq16_dslash"] <= 0:
        raise AssertionError("eigs_hisq: B2 never launched")
    return out


def phase_eigs_stag(gen) -> tuple[dict, torch.Tensor]:
    """Plain-staggered eigenpairs (B1) and the Golub-Kahan SVD of D_oe
    (B1's single-parity hop) at 24^4 on expm(0.3 tah) links, and the
    rooted fermion's calibrated spectral range; returns the links for
    the measure phase."""
    from qex_tpu_torch.eigens import hisqev, svdlanczos
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_hmc
    from qex_tpu_torch.solvers.rational import rational_approx
    lat = Lattice((24, 24, 24, 24))
    u = random_links(lat, gen, scale=MEAS_START)
    m = 0.05
    mm = m * m
    torch.cuda.synchronize()
    reset_counts()                         # count the main path only
    with torch.no_grad():
        res, eig_s = timed_once_s(lambda: hisqev.stag_eigs(
            lat, u, EIGS_N, tol=EIGS_TOL, max_restarts=EIGS_RESTARTS))
        (sig, _uo, _ve, sinfo), svd_s = timed_once_s(
            lambda: svdlanczos.svd_stag(lat, u, SVD_N, m=SVD_M,
                                        tol=SVD_TOL,
                                        max_restarts=SVD_RESTARTS))
        ferm, cal_s = timed_once_s(lambda: stag_hmc.StagRootedFermion(
            lat, m, nf=2).calibrate_spectral_range(u))
    launches = read_counts()
    lo, hi = ferm.spectral_bounds
    approx = {}
    for name, (a, b_) in (("calibrated", (lo, hi)),
                          ("analytic", (mm, mm + 16.0))):
        ra = rational_approx(-2, 4, a, b_, 10)
        approx[name] = {"lo": a, "hi": b_, "degree": ra.degree,
                        "max_rel_err": ra.max_rel_err}
    sig_dev = [abs(s * s - e) / e for s, e in zip(sig, res.evals)]
    out = {"phase": "eigs_stag", "dims": list(lat.dims),
           "links": f"expm({MEAS_START} tah)", "evals": res.evals.tolist(),
           "true_residuals": res.resids.tolist(),
           "matvecs_A": res.info["matvecs_A"], "cycles": res.info["cycles"],
           "converged": res.info["converged"],
           "window": list(res.info["window"]), "eigs_seconds": eig_s,
           "svd_n": SVD_N, "svd_m": SVD_M, "svd_max_restarts": SVD_RESTARTS,
           "svd_sigma": sig.tolist(), "svd_cycles": sinfo["cycles"],
           "svd_converged": sinfo["converged"],
           "svd_matvecs": sinfo["matvecs"],
           "svd_relative_residual": sinfo["relative_residual"],
           "svd_seconds": svd_s, "sigma2_vs_evals_rel_dev": sig_dev,
           "sigma2_tol": TOL_SIGMA2, "calibrate_seconds": cal_s,
           "rooted_m": m, "rational_A^(-1/2)": approx,
           "kernel_launches": launches}
    emit(out)
    if not (res.info["converged"] and sinfo["converged"]):
        raise AssertionError(f"eigs_stag: not converged: eigensolve "
                             f"{res.info['converged']}, SVD "
                             f"{sinfo['converged']}")
    if not max(sig_dev) <= TOL_SIGMA2:
        raise AssertionError(f"eigs_stag: sigma^2 against evals {sig_dev}")
    if not (mm / 2 <= lo < hi <= 1.2 * (mm + 16.0)):
        raise AssertionError(f"eigs_stag: calibrated bracket {(lo, hi)}")
    if launches["stag8_dslash"] <= 0:
        raise AssertionError("eigs_stag: B1 never launched")
    return out, u


def phase_measure(u, gen) -> dict:
    """Phase 30's links through io/lime and back, then the measure and
    eigs apps on the file; B3 against its plain twin on those links."""
    import tempfile

    import numpy as np

    from qex_tpu_torch.apps import eigs as eigs_app
    from qex_tpu_torch.apps import measure as measure_app
    from qex_tpu_torch.gauge import loops
    from qex_tpu_torch.io import lime
    from qex_tpu_torch.lattice import Lattice
    lat = Lattice(tuple(u.shape[-4:]))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "cfg24.lime")
        written = u.cpu().numpy()
        t0 = time.perf_counter()
        lime.save_gauge(path, lat, u)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = lime.load_gauge(path, lat)      # verifies the checksum
        read_s = time.perf_counter() - t0
        if not np.array_equal(back, written):
            raise AssertionError("measure: links read back differ")
        plaq = float(loops.plaquette(lat, u))
        torch.cuda.synchronize()
        reset_counts()                         # count the main path only
        t0 = time.perf_counter()
        lines = _run_main(measure_app.main, [
            f"-gauge:{path}", "-mass:0.05", "-mesons:true", "-pbp:true",
            "-noise:z4", "-nNoise:4", "-dilution:eo", "-wilsonMesons:true"])
        measure_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        elines = _run_main(eigs_app.main, [f"-gauge:{path}", "-nev:8",
                                           "-deflate:true"])
        eigs_s = time.perf_counter() - t0
        launches = read_counts()
        # the Wilson hop the app ran (mass, bc, links) against its twin
        ub = torch.from_numpy(back.astype(np.complex64)).to(u.device)
        X, Y, Z, T = lat.dims
        x = torch.randn((4, 3, T // 2, Z, Y * X), dtype=torch.complex64,
                        generator=gen, device=u.device)
        kcheck = compare_wilson("wilson8_hop", wilson_op(
            lat, ub, 0.05, "pppa")(torch.float32), x)
        del ub
    meas_plaq = _finite_numbers(lines, "MEASplaq", 1)[0][0]
    mesons = _finite_numbers(lines, "MEASmeson", 8)
    wmesons = _finite_numbers(lines, "MEASwmeson", 9)
    pbp = _finite_numbers(lines, "MEASpbp", 1)[0][0]
    eig = _finite_numbers(elines, "EIGEN ", 8)
    out = {"phase": "measure", "dims": list(lat.dims),
           "lime_write_s": write_s, "lime_read_s": read_s,
           "measure_seconds": measure_s, "eigs_seconds": eigs_s,
           "MEASplaq": meas_plaq, "plaquette_written": plaq,
           "MEASpbp": pbp,
           "pion5": [ln for ln in lines if ln.startswith("MEASmeson pion5")],
           "wilson_pion": [ln for ln in lines
                           if ln.startswith("MEASwmeson pion")],
           "eigen": [ln for ln in elines if ln.startswith("EIGEN")],
           "deflate": [ln for ln in elines if ln.startswith("DEFLATE")],
           "wilson8_vs_plain": kcheck, "kernel_launches": launches}
    emit(out)
    if not abs(meas_plaq - plaq) <= 1e-6:
        raise AssertionError(f"measure: MEASplaq {meas_plaq} != {plaq}")
    if not (all(x > 0 for x in mesons[0][:]) and
            all(x > 0 for x in wmesons[0][:]) and pbp > 0):
        raise AssertionError("measure: pion5, Wilson pion or pbp not > 0")
    if not all(math.isfinite(r[-1]) for r in eig):
        raise AssertionError("measure: EIGEN residual not finite")
    for k in ("stag8_dslash", "wilson8_hop"):
        if launches[k] <= 0:
            raise AssertionError(f"measure: {k} never launched")
    return out


def phase_app_pbp() -> dict:
    """staghmc_spv on the config-4 deck with pbp_freq=1, one trajectory
    at 24^4."""
    import tempfile
    import xml.etree.ElementTree as ET

    from qex_tpu_torch.apps import staghmc_spv
    tree = ET.parse(ROOT / "qex_tpu_torch" / "apps" / "decks"
                    / "config4_24.xml")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        deck = str(Path(tmp) / "config4_24_pbp.xml")
        tree.write(deck)
        torch.cuda.synchronize()
        reset_counts()                         # count the main path only
        t0 = time.perf_counter()
        lines = _run_main(staghmc_spv.main, [
            "--xml", deck, "--ntraj", "1", "-pbp_freq=1", "-save_freq=0"])
        secs = time.perf_counter() - t0
    launches = read_counts()
    pbp = _finite_numbers(lines, "MEASpbp", 1)[0][0]
    out = {"phase": "app_pbp", "dims": [24, 24, 24, 24], "MEASpbp": pbp,
           "seconds": secs, "kernel_launches": launches}
    emit(out)
    if not pbp > 0:
        raise AssertionError(f"app_pbp: MEASpbp {pbp}")
    if launches["stag8_dslash"] <= 0:
        raise AssertionError("app_pbp: B1 never launched")
    return out


# --- phases 33-38: the remaining samplers (no hop kernel) ----------------------
#
# Each runs at the size users run, through the apps where there is one,
# and holds its deterministic cores on the card against the host on the
# same injected draws: the discrete updates (von Mises heatbath,
# Metropolis, the Wolff cluster, the clock model) in float64 on both
# sides (an accept decision a float32 rounding apart flips a site, so
# they must agree to TOL_DISCRETE), the molecular dynamics and gauge
# fixing in float32 / complex64 on the card against float64 / complex128
# on the host (TOL_CARD_HOST).  None launches B1-B8.
TOL_DISCRETE = 1e-12
TOL_CARD_HOST = 1e-5
# xy: L=256 at beta 1.1 (near the BKT point), ordered start.  The three
# algorithms run in turn on one field (heatbath, then Metropolis, then
# Wolff), XY_UPDATES each, so that the two later chains start
# thermalized; the heatbath's first quarter is dropped.  Each energy mean
# carries a blocked jackknife over 10 blocks.  With 100 updates each
# (blocks of 10) the pairwise z reached 4.9 over six seeds at L=64 on the
# host (the Metropolis and Wolff energies' tau_int up to 24 updates); with
# 400 it stayed under 3 over eight.
XY_L, XY_BETA, XY_UPDATES, XY_Z = 256, 1.1, 400, 4.0
XY_WOLFF_CHECKS = (1, 4, 16)     # fixed-point test strides timed
CLOCK_N, CLOCK_BETA, CLOCK_SWEEPS = 6, 1.0, 100
# u1: 2D L=128, beta 5: <plaq> = I1(5)/I0(5) up to exponentially small
# torus corrections (tests/test_u1.py:6-7); heatbath sweeps and 2MN HMC
# trajectories after U1_THERM heatbath sweeps from the random start (HMC
# from a random start approaches the plaquette slowly: 0.896 after 60
# trajectories from a cold start at L=64, against 0.8934)
U1_L, U1_BETA, U1_N, U1_THERM, U1_Z = 128, 5.0, 200, 40, 4.0
U1_PLAQ_EXACT = 0.8933831370440849       # scipy iv(1, 5) / iv(0, 5)
TOL_TOPO_INT = 1e-4
# u1_qn: the app at L=64, 6 streams, QN from sweep 8, maximal-tree
# fixing, streams thermalized by 40 heatbath sweeps and tree-fixed.  The
# app's default QN trajectory (tau 2 in 10 leapfrog steps) accepts none
# at L=64 (dH rms 16-26, in the JAX app too); tau 1 in 20 steps accepts
# 0.86-0.88 on the host.
QN_ARGS = ["-L:64", "-nstream:6", "-qnbegin:8", "-trajs:48", "-therm:40",
           "-qntau:1", "-qnsteps:20"]
QN_Z_CREUTZ, QN_Z_PLAQ = 3.0, 4.0
# nambu: 16^4, Wilson target beta 6, WilsonStout guide (3 steps, rho 0.1)
NAMBU_ARGS = ["-lat:16,16,16,16", "-beta:6.0", "-nact:WilsonStout",
              "-nstout:3", "-rho:0.1", "-nbeta:6.0", "-tau:1.0", "-steps:50",
              "-trajs:3"]
NAMBU_GATE_DIMS = (8, 8, 8, 8)
NAMBU_RATIO = (2.0, 8.0)     # |dH(25 steps)| / |dH(50 steps)|: 4 at 2nd order
# rahmc: 16^4, beta 6, gamma 0.3, 24 steps, 1 HMC + 3 RAHMC trajectories
RAHMC_ARGS = ["-lat:16,16,16,16", "-beta:6.0", "-gamma:0.3", "-tau:1.0",
              "-steps:24", "-trajs:4", "-hmcUntil:1"]
# and gamma = 0 against leapfrog on the card from the same draws, in
# complex128: the conformal leapfrog kicks twice with eps/2 where the two
# halves meet, leapfrog once with eps, and in complex64 that rounding
# alone moved dH by 5.7e-5 at 8^4 (4.2e-6 at 4^4, growing with the
# volume) on the host; the complex64 figures are reported beside
TOL_RAHMC_DH, TOL_RAHMC_LINKS = 1e-4, 1e-5
# gauge_fix: 16^4, a random gauge transform of expm(0.3 tah) links;
# the violation falls below 1e-7 of its start within 100 sweeps at 8^4
# on the host (float32 floor ~1e-14)
FIX_DIMS, FIX_ITERS, FIX_EVERY = (16, 16, 16, 16), 200, 20
TOL_FIX_PLAQ, FIX_VIOL_DROP = 1e-6, 1e-5
TOL_FIX_MONOTONE = 1e-6      # float32 noise of the functional


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(dev):
    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated() / 2**30
    return None


def _rel_dev(got: torch.Tensor, ref: torch.Tensor) -> float:
    got = got.to("cpu", ref.dtype)
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def _jack(series, blocks: int = 10):
    """(mean, blocked-jackknife error) over ``blocks`` blocks."""
    from qex_tpu_torch.utils import resample
    return resample.jackknife(series, block=max(1, len(series) // blocks))


def _gate(tag: str, ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(f"{tag}: {msg}")


def _app_dev(dev) -> list[str]:
    return ["-cpu:true"] if torch.device(dev).type == "cpu" else []


def _check_card_host(tag: str, devs: dict) -> dict:
    for k, v in devs.items():
        tol = TOL_DISCRETE if k.startswith("discrete") else TOL_CARD_HOST
        _gate(tag, v <= tol, f"card against host: {k} deviates by {v}")
    return devs


def _xy_card_host(dev) -> dict:
    """xy and clock cores on ``dev`` against the host, same draws."""
    from qex_tpu_torch.models import clock, xy
    gen = torch.Generator().manual_seed(SEED + 33)
    th = (2 * torch.rand((64, 48), generator=gen, dtype=torch.float64)
          - 1) * math.pi
    hb = xy.draw_heatbath(gen, th)
    devs = {"discrete_heatbath": _rel_dev(
        xy.heatbath_sweep_from(th.to(dev), XY_BETA, xy.VonMisesDraws(
            hb.theta0.to(dev), hb.u.to(dev))),
        xy.heatbath_sweep_from(th, XY_BETA, hb))}
    prop, acc = xy.draw_metropolis(gen, th)
    devs["discrete_metropolis"] = _rel_dev(
        xy.metropolis_sweep_from(th.to(dev), XY_BETA, 1.0, prop.to(dev),
                                 acc.to(dev))[0],
        xy.metropolis_sweep_from(th, XY_BETA, 1.0, prop, acc)[0])
    alpha, seed, bond_u = xy.draw_wolff(gen, th)
    devs["discrete_wolff"] = _rel_dev(
        xy.wolff_update_from(th.to(dev), XY_BETA, alpha, seed,
                             bond_u.to(dev))[0],
        xy.wolff_update_from(th, XY_BETA, alpha, seed, bond_u, 1)[0])
    devs["spin_flow_f32"] = _rel_dev(
        xy.spin_flow(th.to(dev, torch.float32), 0.05, 10),
        xy.spin_flow(th, 0.05, 10))
    k = torch.randint(CLOCK_N, (64, 48), generator=gen)
    g = clock.draw_heatbath(gen, k, CLOCK_N)
    kh = clock.heatbath_sweep_from(k, CLOCK_BETA, CLOCK_N, g)
    kc = clock.heatbath_sweep_from(k.to(dev), CLOCK_BETA, CLOCK_N, g.to(dev))
    devs["discrete_clock_heatbath"] = float((kc.cpu() != kh).float().mean())
    prop, acc = clock.draw_metropolis(gen, k, CLOCK_N)
    kh = clock.metropolis_sweep_from(k, CLOCK_BETA, CLOCK_N, prop, acc)[0]
    kc = clock.metropolis_sweep_from(k.to(dev), CLOCK_BETA, CLOCK_N,
                                     prop.to(dev), acc.to(dev))[0]
    devs["discrete_clock_metropolis"] = float((kc.cpu() != kh).float().mean())
    return devs


def _segments(lines: list[str]) -> dict:
    """The xy_mc app's multi-algorithm output: per algorithm, its E/bond
    series, its |M| series and its seconds."""
    out, cur = {}, None
    for ln in lines:
        w = ln.split()
        if ln.startswith("# algo "):
            cur = out.setdefault(w[2], {"E": [], "M": [], "seconds": None})
        elif ln.startswith("MEAS") and cur is not None:
            cur["E"].append(float(w[4]))
            cur["M"].append(float(w[6]))
        elif cur is not None and len(w) >= 6 and w[3] == "updates":
            cur["seconds"] = float(w[5])
    return out


def phase_xy(gen, dev="cuda", L=XY_L, updates=XY_UPDATES) -> dict:
    """The xy_mc app at L x L from an ordered start, the Wolff cluster
    against scipy's connected component, the fixed-point stride, the
    clock model, and the cores on the card against the host."""
    from qex_tpu_torch.apps import xy_mc
    from qex_tpu_torch.models import clock, xy
    tag = "xy"
    _sync(dev)
    reset_counts()
    _reset_peak(dev)
    t0 = time.perf_counter()
    lines = _run_main(xy_mc.main, [
        f"-L:{L}", f"-beta:{XY_BETA}", "-algo:heatbath,metropolis,wolff",
        f"-sweeps:{updates}", "-meas:1", "-start:ordered",
        f"-seed:{SEED}"] + _app_dev(dev))
    app_s = time.perf_counter() - t0
    seg = _segments(lines)
    stats = {}
    for name, s in seg.items():
        e = s["E"][updates // 4:] if name == "heatbath" else s["E"]
        _gate(tag, len(s["E"]) == updates and all(map(math.isfinite, e)),
              f"{name}: {len(s['E'])} finite energies, expected {updates}")
        m, err = _jack(e)
        stats[name] = {"E_per_bond": m, "err": err, "n": len(e),
                       "E_per_site": 2 * m, "abs_M_last": s["M"][-1],
                       "seconds_per_update": s["seconds"] / updates}
    zs = {}
    names = list(stats)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            zs[f"{a}-{b}"] = (abs(stats[a]["E_per_bond"]
                                  - stats[b]["E_per_bond"])
                              / math.hypot(stats[a]["err"], stats[b]["err"]))
    app_peak = _peak_gib(dev)
    # one flowed measurement: 20 RK4 steps of 0.05 after 20 heatbath sweeps
    flow_lines = _run_main(xy_mc.main, [
        f"-L:{L}", f"-beta:{XY_BETA}", "-algo:heatbath", "-sweeps:20",
        "-meas:20", "-start:ordered", "-flowTime:1.0", "-flowDt:0.05",
        f"-seed:{SEED + 1}"] + _app_dev(dev))
    fl = [ln.split() for ln in flow_lines if ln.startswith("MEAS")][0]
    e_before, e_flow = float(fl[4]), float(fl[10])
    # a Wolff cluster on a thermalized field against scipy's connected
    # component of its seed; the fixed-point strides on the same bonds
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    idx = np.arange(L * L).reshape(L, L)
    th = torch.zeros((L, L), dtype=torch.float32, device=dev)
    for _ in range(50):
        th = xy.heatbath_sweep(gen, th, XY_BETA)
    strides, masks = {}, {}
    for rep in range(3):
        alpha, seed, bond_u = xy.draw_wolff(gen, th)
        bonds = xy.frozen_bonds(torch.cos(th - alpha), XY_BETA, bond_u)
        for k in XY_WOLFF_CHECKS:
            _sync(dev)
            t1 = time.perf_counter()
            mask, sweeps = xy.wolff_cluster(bonds, seed, check_every=k)
            _sync(dev)
            strides.setdefault(k, []).append(
                {"seconds": time.perf_counter() - t1, "sweeps": sweeps,
                 "host_reads": -(-sweeps // k)})
            masks[k] = mask
        for k in XY_WOLFF_CHECKS:
            _gate(tag, torch.equal(masks[k], masks[1]),
                  f"stride {k} gives another cluster than stride 1")
        b = bonds.cpu().numpy()
        rows = np.concatenate([idx[b[mu]] for mu in range(2)])
        cols = np.concatenate([np.roll(idx, -1, mu)[b[mu]]
                               for mu in range(2)])
        graph = coo_matrix((np.ones(len(rows)), (rows, cols)),
                           shape=(L * L, L * L))
        _, lab = connected_components(graph, directed=False)
        want = lab == lab[seed]
        _gate(tag, bool((masks[1].cpu().numpy().reshape(-1) == want).all()),
              "the Wolff cluster is not the seed's connected component")
        strides[XY_WOLFF_CHECKS[0]][-1]["cluster_fraction"] = float(
            want.mean())
        th = torch.where(masks[1], 2.0 * alpha + math.pi - th, th)
    # the clock model, Z_6 at L x L: heatbath then Metropolis from cold
    k = torch.zeros((L, L), dtype=torch.int64, device=dev)
    clock_out = {}
    for name in ("heatbath", "metropolis"):
        _sync(dev)
        t1 = time.perf_counter()
        es = []
        for _ in range(CLOCK_SWEEPS):
            if name == "heatbath":
                k = clock.heatbath_sweep(gen, k, CLOCK_BETA, CLOCK_N)
            else:
                k, _acc = clock.metropolis_sweep(gen, k, CLOCK_BETA, CLOCK_N)
            es.append(float(clock.energy(k, CLOCK_BETA, CLOCK_N))
                      / (2 * L * L))
        secs = time.perf_counter() - t1
        mag = float(clock.magnetization(k, CLOCK_N))
        clock_out[name] = {"seconds_per_sweep": secs / CLOCK_SWEEPS,
                           "E_per_bond_last_half": _jack(es[CLOCK_SWEEPS // 2:]),
                           "abs_M": mag}
        _gate(tag, 0.0 <= mag <= 1.0 and all(map(math.isfinite, es)),
              f"clock {name}: |M| {mag}")
    launches = no_launches(tag)
    devs = _check_card_host(tag, _xy_card_host(dev))
    res = {"phase": tag, "L": L, "beta": XY_BETA, "updates": updates,
           "app_seconds": app_s, "chains": stats, "z": zs,
           "flow": {"E_per_bond": e_before, "flowE_per_bond": e_flow},
           "wolff_strides": strides, "wolff_check_app": xy.WOLFF_CHECK,
           "clock_Z6": clock_out, "peak_mem_gib": app_peak,
           "card_vs_host": devs, "kernel_launches": launches}
    emit(res)
    for pair, z in zs.items():
        _gate(tag, z <= XY_Z, f"energies {pair} differ by {z:.2f} sigma")
    _gate(tag, e_flow < e_before,
          f"the spin flow raised E/bond {e_before} -> {e_flow}")
    return res


def _meas_u1(lines: list[str]) -> dict:
    """The u1_mc app's MEAS lines: plaquette, charge, flowed charge, dH
    and accept columns by name."""
    cols: dict = {}
    for ln in lines:
        if not ln.startswith("MEAS"):
            continue
        w = ln.split()
        cols.setdefault("plaq", []).append(float(w[4]))
        for key in ("topo", "dH", "acc", "flowTopo"):
            if key in w:
                cols.setdefault(key, []).append(float(w[w.index(key) + 1]))
    return cols


def _u1_card_host(dev) -> dict:
    from qex_tpu_torch.models import u1, xy
    gen = torch.Generator().manual_seed(SEED + 34)
    th = u1.random_field(gen, (2, 32, 24))
    d = u1.draw_heatbath(gen, th)
    devs = {"discrete_heatbath": _rel_dev(
        u1.heatbath_sweep_from(th.to(dev), U1_BETA, xy.VonMisesDraws(
            d.theta0.to(dev), d.u.to(dev))),
        u1.heatbath_sweep_from(th, U1_BETA, d))}
    th = u1.heatbath_sweep(gen, th, U1_BETA)
    p = torch.randn(th.shape, generator=gen, dtype=torch.float64)
    want, _ = u1.hmc_step_from(th, p, 0.0, U1_BETA, 1.0, 10)
    got, _ = u1.hmc_step_from(th.to(dev, torch.float32),
                              p.to(dev, torch.float32), 0.0, U1_BETA, 1.0, 10)
    devs["hmc_2mn_f32"] = _rel_dev(got, want)
    return devs


def phase_u1(gen, dev="cuda", L=U1_L, n=U1_N) -> dict:
    """The u1_mc app in 2D: heatbath with one over-relaxation sweep, and
    2MN HMC, each after U1_THERM heatbath sweeps; a flowed charge."""
    from qex_tpu_torch.apps import u1_mc
    tag = "u1"
    base = [f"-L:{L}", f"-beta:{U1_BETA}", "-meas:1", f"-therm:{U1_THERM}"]
    _sync(dev)
    reset_counts()
    _reset_peak(dev)
    out = {}
    for algo, extra in (("heatbath", [f"-sweeps:{n}", "-or:1"]),
                        ("hmc", [f"-trajs:{n}", "-tau:2.0", "-steps:10",
                                 "-scheme:2MN"])):
        t0 = time.perf_counter()
        lines = _run_main(u1_mc.main, base + [f"-algo:{algo}",
                                              f"-seed:{SEED + len(out)}"]
                          + extra + _app_dev(dev))
        secs = time.perf_counter() - t0
        # the app's own time of its n updates (the heatbath sweeps of
        # -therm run before its clock starts)
        app_s = [float(ln.split()[5]) for ln in lines
                 if ln.startswith(f"# {n} {algo} updates in")][0]
        c = _meas_u1(lines)
        plaq = c["plaq"][n // 5:]
        m, err = _jack(plaq)
        topo_dev = max(abs(q - round(q)) for q in c["topo"])
        out[algo] = {"plaq": m, "err": err, "n": len(plaq),
                     "z": (m - U1_PLAQ_EXACT) / err,
                     "topo_max_dev_from_int": topo_dev,
                     "topo_last": c["topo"][-1],
                     "seconds_per_update": app_s / n, "app_seconds": secs}
        if algo == "hmc":
            out[algo]["acceptance"] = sum(c["acc"]) / len(c["acc"])
            out[algo]["dH_rms"] = math.sqrt(statistics.fmean(
                d * d for d in c["dH"]))
    peak = _peak_gib(dev)
    flow = _meas_u1(_run_main(u1_mc.main, [
        f"-L:{L}", f"-beta:{U1_BETA}", "-algo:heatbath", "-sweeps:1",
        "-therm:20", "-flowTime:1.0", "-flowDt:0.02", f"-seed:{SEED + 9}"]
        + _app_dev(dev)))
    launches = no_launches(tag)
    devs = _check_card_host(tag, _u1_card_host(dev))
    res = {"phase": tag, "L": L, "beta": U1_BETA, "exact": U1_PLAQ_EXACT,
           "chains": out, "flow_topo": flow["flowTopo"][0],
           "topo_before_flow": flow["topo"][0], "peak_mem_gib": peak,
           "card_vs_host": devs, "kernel_launches": launches}
    emit(res)
    for algo, r in out.items():
        _gate(tag, abs(r["z"]) <= U1_Z,
              f"{algo} plaquette {r['plaq']} +- {r['err']} is "
              f"{r['z']:.2f} sigma from I1/I0 = {U1_PLAQ_EXACT}")
        _gate(tag, r["topo_max_dev_from_int"] <= TOL_TOPO_INT,
              f"{algo} charge off an integer by "
              f"{r['topo_max_dev_from_int']}")
    qf = flow["flowTopo"][0]
    _gate(tag, abs(qf - round(qf)) <= TOL_TOPO_INT, f"flowed charge {qf}")
    return res


def phase_u1_qn(gen, dev="cuda", args=QN_ARGS) -> dict:
    """The u1_qn_hmc app: <exp(-dH)> and the plaquette of the QN sweeps,
    the acceptance of QN against plain-HMC sweeps."""
    from qex_tpu_torch.apps import u1_qn_hmc
    from qex_tpu_torch.hmc import qnhmc
    from qex_tpu_torch.models import u1
    tag = "u1_qn"
    qnbegin = int([a for a in args if a.startswith("-qnbegin:")][0][9:])
    _sync(dev)
    reset_counts()
    _reset_peak(dev)
    t0 = time.perf_counter()
    lines = _run_main(u1_qn_hmc.main, args + [f"-seed:{SEED}"]
                      + _app_dev(dev))
    secs = time.perf_counter() - t0
    peak = _peak_gib(dev)
    rows = [ln.split() for ln in lines if ln.startswith("MEAS")]
    sweeps = sorted({int(r[2]) for r in rows})
    by = {s: [r for r in rows if int(r[2]) == s] for s in sweeps}

    def col(rs, i):
        return [float(r[i]) for r in rs]

    qn = [s for s in sweeps if s >= qnbegin]
    plain = [s for s in sweeps if s < qnbegin]
    acc_qn = statistics.fmean(col([r for s in qn for r in by[s]], 12))
    acc_plain = statistics.fmean(col([r for s in plain for r in by[s]], 12))
    # per sweep: the mean over the streams; the plaquette after the first
    # quarter of the QN sweeps, <exp(-dH)> over all of them
    creutz = [statistics.fmean(math.exp(-d) for d in col(by[s], 10))
              for s in qn]
    plaq = [statistics.fmean(col(by[s], 6)) for s in qn[len(qn) // 4:]]
    c_m, c_e = _jack(creutz)
    p_m, p_e = _jack(plaq)
    launches = no_launches(tag)
    # card against host: one QN trajectory from the same draws
    g2 = torch.Generator().manual_seed(SEED + 35)
    L8 = 8
    tree = u1.max_tree_mask((L8, L8))
    x0 = torch.where(tree, 0.0, u1.random_field(g2, (2, L8, L8)))
    st = qnhmc.qn_init(4, x0.shape)
    for _ in range(4):
        xa = x0 + 0.1 * torch.where(tree, 0.0, torch.randn(
            x0.shape, generator=g2, dtype=torch.float64))
        xb = x0 + 0.1 * torch.where(tree, 0.0, torch.randn(
            x0.shape, generator=g2, dtype=torch.float64))
        st = qnhmc.qn_add(st, xa, u1.force(xa, U1_BETA), xb,
                          u1.force(xb, U1_BETA), yscale=0.1)
    q, z, _ = qnhmc.draw_qn(g2, x0.shape, 4, torch.float64)

    def one(d, dtype):
        s = qnhmc.QNState(st.s.to(d, dtype), st.y.to(d, dtype),
                          st.valid.to(d), st.pos, st.h0)
        return qnhmc.qn_hmc_step_from(
            x0.to(d, dtype), q.to(d, dtype), z.to(d, dtype), 0.0,
            qnhmc.qn_prep(s), lambda y: u1.action(y, U1_BETA),
            lambda y: u1.force(y, U1_BETA), 1.0, 20, mask=tree.to(d))[0]

    devs = _check_card_host(tag, {"qn_hmc_f32": _rel_dev(
        one(dev, torch.float32), one("cpu", torch.float64))})
    res = {"phase": tag, "args": args, "seconds": secs,
           "seconds_per_traj": secs / len(rows), "trajectories": len(rows),
           "acceptance_qn": acc_qn, "acceptance_plain": acc_plain,
           "exp_minus_dH": c_m, "exp_minus_dH_err": c_e,
           "exp_minus_dH_z": (c_m - 1.0) / c_e, "plaq": p_m, "plaq_err": p_e,
           "plaq_z": (p_m - U1_PLAQ_EXACT) / p_e, "exact": U1_PLAQ_EXACT,
           "peak_mem_gib": peak, "card_vs_host": devs,
           "kernel_launches": launches}
    emit(res)
    _gate(tag, abs(res["exp_minus_dH_z"]) <= QN_Z_CREUTZ,
          f"<exp(-dH)> {c_m} +- {c_e} is {res['exp_minus_dH_z']:.2f} "
          "sigma from 1")
    _gate(tag, abs(res["plaq_z"]) <= QN_Z_PLAQ,
          f"plaquette {p_m} +- {p_e} is {res['plaq_z']:.2f} sigma from "
          f"I1/I0")
    return res


def _traj_rows(lines: list[str]) -> list[dict]:
    """``_traj_lines`` of the nambu_hmc and rahmc apps with their verdict,
    dG, MEASplaq and MEAStopo; raises on a non-finite number."""
    rows = _traj_lines(lines, ("traj",))
    for r in rows:
        w = r.pop("line").replace("(", " ").split()
        r["accepted"] = "ACCEPT" in w
        for key in ("dG", "MEASplaq", "MEAStopo"):
            if key in w:
                r[key] = float(w[w.index(key) + 1])
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite number in {' '.join(w)!r}")
    return rows


def _smooth_links(lat, gen, dtype):
    """``random_links`` at scale 0.3, built in complex128."""
    return random_links(lat, gen, torch.complex128, 0.3).to(dtype)


def _nambu_system(lat, dtype, dev, nstout: int = 3):
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.gauge.smear import StoutCoefs, stout_smear
    from qex_tpu_torch.hmc import nambu
    c = ga.wilson(6.0)

    def guide(uu):
        for _ in range(nstout):
            uu = stout_smear(StoutCoefs(0.1), lat, uu)
        return ga.full_action(c, lat, uu)
    return nambu.NambuSystem(functools.partial(ga.full_action, c, lat), guide,
                             nambu.generators(3, dtype, dev),
                             target_force=functools.partial(ga.gauge_force,
                                                            c, lat))


def phase_nambu(gen, dev="cuda", args=NAMBU_ARGS,
                gate_dims=NAMBU_GATE_DIMS) -> dict:
    """The nambu_hmc app (3 trajectories, the first a forced warm-up), one
    metadynamics trajectory, |dH| against the step count, the card
    against the host."""
    from qex_tpu_torch.apps import nambu_hmc
    from qex_tpu_torch.hmc import nambu
    from qex_tpu_torch.lattice import Lattice
    tag = "nambu"
    _sync(dev)
    reset_counts()
    _reset_peak(dev)
    t0 = time.perf_counter()
    rows = _traj_rows(_run_main(nambu_hmc.main, args + [f"-seed:{SEED}"]
                                + _app_dev(dev)))
    secs = time.perf_counter() - t0
    peak = _peak_gib(dev)
    _reset_peak(dev)
    meta_args = [a for a in args if not a.startswith(("-nact:", "-trajs:"))]
    t0 = time.perf_counter()
    meta = _traj_rows(_run_main(nambu_hmc.main, meta_args + [
        "-nact:TopoCloverStoutMeta", "-trajs:1", f"-seed:{SEED + 1}"]
        + _app_dev(dev)))
    meta_s = time.perf_counter() - t0
    meta_peak = _peak_gib(dev)
    # |dH| at 25 and 50 steps from the same (u, pi, qi)
    lat = Lattice(gate_dims)
    u = _smooth_links(lat, gen, torch.complex64)
    sy = _nambu_system(lat, torch.complex64, u.device)
    pi, qi, _ = nambu.draw_nambu(gen, u, sy.gens)
    dh = {ns: nambu.nambu_hmc_step_from(u, pi, qi, 0.0, sy, 1.0, ns)[1]
          for ns in (25, 50)}
    ratio = abs(dh[25]) / abs(dh[50])
    launches = no_launches(tag)
    small = Lattice((4, 4, 4, 4))
    uh = _smooth_links(small, torch.Generator().manual_seed(SEED + 36),
                       torch.complex128)
    g2 = torch.Generator().manual_seed(SEED + 37)
    pih, qih, _ = nambu.draw_nambu(g2, uh, nambu.generators(
        3, torch.complex128))
    want = nambu.nambu_hmc_step_from(
        uh, pih, qih, 0.0, _nambu_system(small, torch.complex128, "cpu", 1),
        0.5, 10)[0]
    got = nambu.nambu_hmc_step_from(
        uh.to(dev, torch.complex64), pih.to(dev, torch.float32),
        qih.to(dev, torch.float32), 0.0,
        _nambu_system(small, torch.complex64, dev, 1), 0.5, 10)[0]
    devs = _check_card_host(tag, {"trajectory_c64": _rel_dev(got, want)})
    res = {"phase": tag, "args": args, "trajs": rows, "seconds": secs,
           "seconds_per_traj": [r["seconds"] for r in rows],
           "peak_mem_gib": peak, "meta": meta, "meta_seconds": meta_s,
           "meta_peak_mem_gib": meta_peak, "gate_dims": list(gate_dims),
           "dH_25": dh[25], "dH_50": dh[50], "ratio": ratio,
           "card_vs_host": devs, "kernel_launches": launches}
    emit(res)
    _gate(tag, len(rows) == 3 and len(meta) == 1, "missing traj lines")
    _gate(tag, NAMBU_RATIO[0] <= ratio <= NAMBU_RATIO[1],
          f"|dH| ratio 25/50 steps {ratio} (dH {dh})")
    return res


def phase_rahmc(gen, dev="cuda", args=RAHMC_ARGS, dims=(16, 16, 16, 16)
                ) -> dict:
    """The rahmc app (1 HMC, 3 RAHMC trajectories); gamma = 0 against the
    leapfrog hmc_step from the same draws on the card; the card against
    the host."""
    from qex_tpu_torch.apps import rahmc
    from qex_tpu_torch.gauge import action as ga
    from qex_tpu_torch.hmc import hmc, integrators
    from qex_tpu_torch.lattice import Lattice
    tag = "rahmc"
    _sync(dev)
    reset_counts()
    _reset_peak(dev)
    t0 = time.perf_counter()
    rows = _traj_rows(_run_main(rahmc.main, args + [f"-seed:{SEED}"]
                                + _app_dev(dev)))
    secs = time.perf_counter() - t0
    peak = _peak_gib(dev)
    lat = Lattice(dims)
    c = ga.wilson(6.0)
    act = functools.partial(ga.full_action, c, lat)
    frc = functools.partial(ga.gauge_force, c, lat)
    u = _smooth_links(lat, gen, torch.complex64)
    p, _ = rahmc.draw(gen, u)
    gamma0 = {}
    for name, dtype in (("c128", torch.complex128), ("c64", torch.complex64)):
        uc, pc = u.to(dtype), p.to(dtype)
        u0, dh0, _ = rahmc.ra_step_from(uc, pc, 0.0, act, frc, 0.0, 1.0, 24)
        with torch.no_grad():
            ulf, st = hmc.hmc_step_from(uc, pc, 0.0, act, frc,
                                        integrators.get_integrator("LF"),
                                        1.0, 24)
        gamma0[name] = {"dH_ra": dh0, "dH_lf": st.dH,
                        "dH_diff": abs(dh0 - st.dH),
                        "links_rel_dev": float(
                            torch.linalg.vector_norm(u0 - ulf)
                            / torch.linalg.vector_norm(ulf))}
        del uc, pc, u0, ulf
    launches = no_launches(tag)
    small = Lattice((4, 4, 4, 4))
    uh = _smooth_links(small, torch.Generator().manual_seed(SEED + 38),
                       torch.complex128)
    ph = hmc.draw_momenta(torch.Generator().manual_seed(SEED + 39), uh)
    a4 = functools.partial(ga.full_action, c, small)
    f4 = functools.partial(ga.gauge_force, c, small)
    want = rahmc.ra_step_from(uh, ph, 0.0, a4, f4, 0.3, 1.0, 24)[0]
    got = rahmc.ra_step_from(uh.to(dev, torch.complex64),
                             ph.to(dev, torch.complex64), 0.0, a4, f4, 0.3,
                             1.0, 24)[0]
    devs = _check_card_host(tag, {"trajectory_c64": _rel_dev(got, want)})
    res = {"phase": tag, "args": args, "trajs": rows, "seconds": secs,
           "seconds_per_traj": [r["seconds"] for r in rows],
           "peak_mem_gib": peak, "gamma0_vs_lf": gamma0,
           "card_vs_host": devs, "kernel_launches": launches}
    emit(res)
    _gate(tag, len(rows) == 4, "missing traj lines")
    g0 = gamma0["c128"]
    _gate(tag, g0["dH_diff"] <= TOL_RAHMC_DH,
          f"gamma = 0 dH {g0['dH_ra']} against leapfrog {g0['dH_lf']}")
    _gate(tag, g0["links_rel_dev"] <= TOL_RAHMC_LINKS,
          f"gamma = 0 links deviate by {g0['links_rel_dev']}")
    return res


def phase_gauge_fix(gen, dev="cuda", dims=FIX_DIMS, iters=FIX_ITERS) -> dict:
    """Landau and Coulomb fixing of a random gauge transform of smooth
    links: the plaquette kept, the violation's drop, the functional's
    history; the card against the host."""
    from qex_tpu_torch.gauge import fix, loops
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import group
    tag = "gauge_fix"
    lat = Lattice(dims)
    u = _smooth_links(lat, gen, torch.complex64)
    uu = fix.apply_gauge_transform(lat, u, group.random_su(
        gen, lat.dims, 3, torch.complex64))
    plaq0 = float(loops.plaquette(lat, uu))
    _sync(dev)
    reset_counts()
    out = {}
    for gauge in ("landau", "coulomb"):
        dirs = fix.gauge_dirs(lat, gauge)
        f0 = float(fix.functional(lat, uu, dirs))
        v0 = float(fix.violation(lat, uu, dirs))
        hist = []
        _reset_peak(dev)
        secs = 0.0
        t1 = time.perf_counter()
        for i, g in enumerate(fix.gauge_fix_iter(lat, uu, gauge=gauge,
                                                 iters=iters)):
            if (i + 1) % FIX_EVERY == 0:
                _sync(dev)
                secs += time.perf_counter() - t1
                fu = fix.apply_gauge_transform(lat, uu, g).to(uu.dtype)
                hist.append([i + 1, float(fix.functional(lat, fu, dirs)),
                             float(fix.violation(lat, fu, dirs))])
                t1 = time.perf_counter()
        peak = _peak_gib(dev)
        fu = fix.apply_gauge_transform(lat, uu, g).to(uu.dtype)
        plaq1 = float(loops.plaquette(lat, fu))
        fs = [f0] + [h[1] for h in hist]
        out[gauge] = {"functional_start": f0, "violation_start": v0,
                      "history": hist, "plaq_change": plaq1 - plaq0,
                      "seconds": secs, "seconds_per_sweep": secs / iters,
                      "peak_mem_gib": peak,
                      "max_functional_drop": max(
                          0.0, max(a - b for a, b in zip(fs, fs[1:])))}
    launches = no_launches(tag)
    small = Lattice((4, 4, 4, 4))
    g2 = torch.Generator().manual_seed(SEED + 40)
    us = fix.apply_gauge_transform(small, _smooth_links(
        small, g2, torch.complex128), group.random_su(
            g2, small.dims, 3, torch.complex128))
    want = fix.gauge_fix(small, us, gauge="landau", iters=8)[1]
    got = fix.gauge_fix(small, us.to(dev, torch.complex64), gauge="landau",
                        iters=8)[1]
    devs = _check_card_host(tag, {"fixed_links_c64": _rel_dev(got, want)})
    res = {"phase": tag, "dims": list(dims), "iters": iters, "gauges": out,
           "plaquette": plaq0, "card_vs_host": devs,
           "kernel_launches": launches}
    emit(res)
    for gauge, r in out.items():
        _gate(tag, abs(r["plaq_change"]) <= TOL_FIX_PLAQ,
              f"{gauge}: plaquette moved by {r['plaq_change']}")
        _gate(tag, r["history"][-1][2] <= FIX_VIOL_DROP * r["violation_start"],
              f"{gauge}: violation {r['history'][-1][2]} from "
              f"{r['violation_start']}")
        _gate(tag, r["max_functional_drop"] <= TOL_FIX_MONOTONE,
              f"{gauge}: the functional fell by {r['max_functional_drop']}")
    return res


# --- the domain-decomposed path on the one card ------------------------------

# phase 39 (sharded): ranks are processes sharing the card over gloo, every
# exchange staged through host memory; geometries and volumes
SHARD_GEOMS2 = ((1, 1, 2, 1), (1, 1, 1, 2))
SHARD_GEOM4 = (1, 1, 2, 2)
SHARD_DIMS8 = (24, 24, 24, 24)
SHARD_DIMS16 = (32, 32, 32, 64)          # config 5's volume
SHARD_HMC_DIMS = (8, 8, 8, 8)
SHARD_BLK_DIMS = (8, 8, 8, 8)            # block-resident trajectories, eigs
SHARD_WIL_DIMS = (24, 24, 24, 32)        # B3/B3b on blocks, the block solve
SHARD_MEM_DIMS = (24, 24, 24, 24)        # the smeared force's peak memory
SHARD_MEM_RATIO = 0.40       # a rank's peaks over the unsplit evaluation's
# eight restart cycles of a degree-4 filter: float32 does not resolve
# the 8^4 spectrum's lowest eigenvalues (3e-7) to a relative 1e-6, and
# the block and unsplit runs are held to the same cycles
SHARD_EIG_ARGS = dict(tol=1e-6, seed=1, degree=4, m=32, max_restarts=8)
# eigenvalues of the block run against the unsplit one, absolute: four
# times the largest deviation read on the card (2.4e-9, the second of
# the four, the same in two runs; 1.4e-9 in a run of 4848 applies), a
# thousandth of the lowest eigenvalue (1.1e-5)
TOL_BLOCK_EIG = 1e-8
SHARD_BLK_DEPTH = dict(steps=(6, 3, 3), tau=0.25)   # config 4 cut in depth
SHARD_HISQ_DEPTH = dict(steps=(6, 3), tau=0.25)
SHARD_APP_ARGS = ["-ns=8", "-nt=8", "-rank_geom=1x1x1x2", "--ntraj", "1"]
CONFIG5_MASSES = (0.05, 0.1, 0.2, 0.4)
# phase 40 (io_formats): the volumes of the io row of PERF.md; MILC,
# modfile and timeslice files at the first only (at 32^3x64 their numpy
# codecs took 25.5, 3.9 and 24.3 s on an H100's host, over the phase's
# time)
IO_DIMS = ((24, 24, 24, 24), (32, 32, 32, 64))


def _seeded_links(lat, dev, seed: int, scale: float):
    """expm(scale * tah) links from a generator of their own, the same
    in every process that asks (a rank's field equals the parent's)."""
    return random_links(lat, torch.Generator(device=dev).manual_seed(seed),
                        scale=scale)


def _shard_fields(dev, dims8, dims16):
    """(8-term fast links, 16-term fast links, vector 8, vector 16), the
    same in every process: B1's expm(0.7 tah) links and B2's fat and long
    links of expm(HISQ_START tah) links."""
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import staggered as st
    lat8, lat16 = Lattice(dims8), Lattice(dims16)
    fs8 = sf.new_fast(st.new_stag_eo(lat8, _seeded_links(lat8, dev, SEED + 21,
                                                         0.7)))
    with torch.no_grad():
        f16 = sf.new_fast3(st.new_stag3_eo(lat16, *hisq_links(
            lat16, _seeded_links(lat16, dev, SEED + 22, HISQ_START))))
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    return fs8, f16, fast_vector(lat8, g), fast_vector(lat16, g)


def _shard_operators(lm, kind: str, f, x, m: float) -> dict:
    """For float32 and bfloat16 links: the sharded d2ee and d2dd, on the
    links each rank builds from its block of ``f`` (the backward links'
    shifts exchanging faces), against the unsharded kernel operators on
    the same card (gathered), and each rank's local hop (both parities)
    against its plain twin on its block; squared relative deviations,
    the worst over the ranks."""
    from qex_tpu_torch.parallel.mesh import use_mesh
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_shard as shd
    new, d2ee, d2dd, hop = (
        (sh.new_stag8, sh.d2ee_stag8, sh.d2dd_stag8, sh.dslash_stag8)
        if kind == "stag8" else
        (sh.new_hisq16, sh.d2ee_hisq16, sh.d2dd_hisq16, sh.dslash_hisq16))
    out = {}
    xb = shd.fast_block(lm, x)
    for ldt in (torch.float32, torch.bfloat16):
        name = f"{kind}_dslash" + ("_bf16" if ldt == torch.bfloat16 else "")
        p = new(f, ldt)
        with use_mesh(lm):
            pl = new(shd.block_of(lm, f), ldt)
        ee = shd.gather_fast(lm, shd.d2ee_sharded(lm, pl, xb, m))
        dd = shd.gather_fast(lm, shd.d2dd_sharded(lm, pl, xb))
        ref_ee, ref_dd = d2ee(p, x, m), d2dd(p, x)
        local = [rel2(hop(pl, xb, par), shd.hop3_ref(
            pl.lat, pl.l_e if par == 0 else pl.l_o, xb, par))
            for par in (0, 1)]
        worst = lm.all_gather(torch.tensor(max(local), dtype=torch.float64,
                                           device=x.device))
        out[name] = {"rel2_d2ee": rel2(ee, ref_ee),
                     "rel2_d2dd": rel2(dd, ref_dd),
                     "rel2_local_hop_vs_twin": float(max(worst)),
                     "max_abs_err": max(float((ee - ref_ee).abs().max()),
                                        float((dd - ref_dd).abs().max()))}
        del p, pl
    return out


def _wilson_block_operators(dev, dims) -> dict:
    """B3 and B3b on the four ranks' blocks at ``dims`` over (1,1,2,2),
    links built by each rank from its block of the gauge field, against
    the unsplit kernel on the same card (gathered); both parities, the
    plain hop and the fused Schur epilogue; squared relative deviations,
    the worst over the ranks (rank 0's record)."""
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.parallel.mesh import (local_block, make_lattice_mesh,
                                             use_mesh)
    from qex_tpu_torch.physics import stag_shard as shd
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.physics import wilson_pallas as wp
    from qex_tpu_torch.physics import wilson_shard as wsh
    lat = Lattice(dims)
    lm = make_lattice_mesh(lat, SHARD_GEOM4)
    u = _seeded_links(lat, dev, SEED + 36, 0.7)
    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    X, Y, Z, T = dims
    x = torch.randn((4, 3, T // 2, Z, Y * X), dtype=torch.complex64,
                    generator=g, device=dev)
    w = wl.new_wilson_eo(lat, u, 0.1)
    with use_mesh(lm):
        wb = wl.new_wilson_eo(lat, local_block(lm, u), 0.1)
    xb = local_block(lm, x, "fast")
    out = {}
    for ldt in (torch.float32, torch.bfloat16):
        name = "wilson8_hop" + ("_bf16" if ldt == torch.bfloat16 else "")
        p = wp.new_pallas_wilson(w, ldt)
        pb = wsh.links_w(lm, wb, ldt)
        devs, err = [], 0.0
        for par in (0, 1):
            for fuse in (None, x):
                got = wsh.hop_sharded(lm, pb, xb, par, None if fuse is None
                                      else xb)
                got = shd.gather_fast(lm, got)
                ref = wp.hop_w(p, x, par, fuse)
                devs.append(rel2(got, ref))
                err = max(err, float((got - ref).abs().max()))
        worst = lm.all_gather(torch.tensor(max(devs), dtype=torch.float64,
                                           device=x.device))
        out[name] = {"rel2_hop": float(max(worst)), "max_abs_err": err}
        del p, pb
    return out


def _force_peak(th, gen, u) -> dict:
    """One smeared force evaluation of ``th`` at links ``u`` (smear
    forward, the fermion's solve and the boson's operator on the
    smeared links, the pullback: the shared kick of ``mcmc.md``) after
    a heatbath; the card's peak allocation during it above what was
    allocated before (the links and pseudofermions included there),
    and torch's own ``max_memory_allocated``."""
    from qex_tpu_torch.mcmc import md
    from qex_tpu_torch.parallel.mesh import use_mesh
    cuda = u.is_cuda
    with use_mesh(th.mesh):
        phis = th.heatbath(gen, u)
        kicks = [(i, 1.0, 0.0) for i, t in enumerate(th.terms) if t.smeared]
        p = torch.zeros_like(u)
        if cuda:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p = md._shared_smeared_kick(th._smear, th.terms, kicks, u, p, phis)
        if cuda:
            torch.cuda.synchronize()
    rec = {"seconds": time.perf_counter() - t0,
           "force_norm2": float(th.mesh.all_reduce(
               (p.abs() ** 2).sum().double()) if th.mesh is not None
               else (p.abs() ** 2).sum())}
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        rec.update(max_memory_allocated=peak, base_allocated=base,
                   peak_bytes=peak - base)
    return rec


def _block_stage(rank: int, dev: str, sizes: dict, lap) -> dict:
    """Phase 39's block-resident path on four ranks at (1,1,2,2): two
    config-4 nHYP trajectories (sloppy solves: B1b, B1), one HISQ
    trajectory (B2), ``stag_eigs`` on B1, the Wilson eo solve on B3, and
    at ``mem_dims`` one smeared force evaluation with its peak memory;
    every field is this rank's block.  Rank 0 hands back the gathered
    results; the parent runs the same unsplit (:func:`_block_refs`)."""
    from qex_tpu_torch.eigens import hisqev
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.parallel.mesh import (gather_field, local_block,
                                             make_lattice_mesh, use_mesh)
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.solvers.base import SolverParams
    rec = {}
    lat = Lattice(sizes["blk_dims"])
    lm = make_lattice_mesh(lat, SHARD_GEOM4)

    def run(tag, th, u, gen, n):
        st0, t0 = dict(lm.stats), time.perf_counter()
        ub, dhs = local_block(lm, u), []
        del u
        for _ in range(n):
            ub, state = th.hmc_step(gen, ub, always_accept=True)
            dhs.append(state.dH)
        if ub.is_cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        u1 = gather_field(lm, ub)
        rec[tag] = {"dH": dhs, "h_old": state.h_old, "seconds": secs,
                    "host_staged_s": lm.stats["staged_s"] - st0["staged_s"],
                    "links": u1.cpu().numpy() if rank == 0 else None}
        lap(f"block_{tag}")

    run("config4", config4_theory(lat, smear=HypCoefs(0.4, 0.5, 0.5),
                                  sloppy=True, mesh=lm, **SHARD_BLK_DEPTH),
        _seeded_links(lat, dev, SEED + 30, AB_SMEARED_START),
        torch.Generator(device=dev).manual_seed(SEED + 31), 2)
    run("hisq", hisq_theory(lat, mesh=lm, **SHARD_HISQ_DEPTH),
        _seeded_links(lat, dev, SEED + 32, HISQ_START),
        torch.Generator(device=dev).manual_seed(SEED + 33), 1)
    t0 = time.perf_counter()
    with use_mesh(lm):
        r = hisqev.stag_eigs(lat, local_block(lm, _seeded_links(
            lat, dev, SEED + 34, 0.7)), 4, **SHARD_EIG_ARGS)
    rec["eigs"] = {"evals": [float(v) for v in r.evals],
                   "matvecs": r.info["matvecs_A"],
                   "seconds": time.perf_counter() - t0}
    lap("block_eigs")
    latw = Lattice(sizes["wil_dims"])
    lmw = make_lattice_mesh(latw, SHARD_GEOM4)
    uw = _seeded_links(latw, dev, SEED + 36, 0.7)
    bw = torch.randn((4, 3) + latw.dims, dtype=torch.complex64,
                     generator=torch.Generator(device=dev).manual_seed(
                         SEED + 38), device=dev)
    st0, t0 = dict(lmw.stats), time.perf_counter()
    with use_mesh(lmw):
        x, stats = wl.solve_eo(wl.new_wilson_eo(latw, local_block(lmw, uw),
                                                0.1),
                               local_block(lmw, bw),
                               SolverParams(r2req=1e-10, maxits=2000))
    secs = time.perf_counter() - t0
    x = gather_field(lmw, x)
    rec["wilson"] = {"iterations": stats.iterations, "seconds": secs,
                     "host_staged_s": lmw.stats["staged_s"] - st0["staged_s"]}
    if rank == 0:
        wd = wl.new_wilson(latw, uw.to(torch.complex128), 0.1)
        b64 = bw.to(torch.complex128)
        r = wl.wilson_d(wd, x.to(torch.complex128)) - b64
        rec["wilson"]["true_rel_r2"] = float((r.abs() ** 2).sum()
                                             / (b64.abs() ** 2).sum())
    del uw, bw, x
    lap("block_wilson")
    return rec


def _force_mem_stage(dev: str, sizes: dict) -> dict:
    """Phase 39's memory check on four ranks at (1,1,2,2): one smeared
    force evaluation on blocks at ``mem_dims`` (:func:`_force_peak`),
    entered with nothing of the phase's earlier fields allocated, and
    every rank's ``max_memory_allocated`` and peak above what it held
    before the evaluation."""
    import gc

    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.parallel.mesh import local_block, make_lattice_mesh
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    latm = Lattice(sizes["mem_dims"])
    lmm = make_lattice_mesh(latm, SHARD_GEOM4)
    um = local_block(lmm, _seeded_links(latm, dev, SEED + 35,
                                        AB_SMEARED_START))
    th = config4_theory(latm, smear=HypCoefs(0.4, 0.5, 0.5), sloppy=True,
                        mesh=lmm)
    f = _force_peak(th, torch.Generator(device=dev).manual_seed(SEED + 39),
                    um)
    f["resident_before"] = resident
    for key in ("max_memory_allocated", "peak_bytes", "resident_before"):
        got = lmm.all_gather(torch.tensor(float(f[key]), dtype=torch.float64,
                                          device=dev))
        f["rank_" + key] = [float(v) for v in got]
    return f


def _block_refs(dev: str, sizes: dict) -> dict:
    """The unsplit runs of :func:`_block_stage` on the same draws, in
    this process: the trajectories, the eigensolve, the Wilson solve's
    iterations and the smeared force evaluation's peak memory."""
    import gc

    from qex_tpu_torch.eigens import hisqev
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import wilson as wl
    from qex_tpu_torch.solvers.base import SolverParams
    out = {}
    lat = Lattice(sizes["blk_dims"])
    for tag, th, start, seed, n in (
            ("config4", config4_theory(lat, smear=HypCoefs(0.4, 0.5, 0.5),
                                       sloppy=True, **SHARD_BLK_DEPTH),
             AB_SMEARED_START, 30, 2),
            ("hisq", hisq_theory(lat, **SHARD_HISQ_DEPTH), HISQ_START, 32,
             1)):
        u = _seeded_links(lat, dev, SEED + seed, start)
        gen = torch.Generator(device=dev).manual_seed(SEED + seed + 1)
        dhs = []
        for _ in range(n):
            u, state = th.hmc_step(gen, u, always_accept=True)
            dhs.append(state.dH)
        out[tag] = {"dH": dhs, "h_old": state.h_old,
                    "links": u.cpu().numpy()}
    r = hisqev.stag_eigs(lat, _seeded_links(lat, dev, SEED + 34, 0.7), 4,
                         **SHARD_EIG_ARGS)
    out["eigs"] = [float(v) for v in r.evals]
    latw = Lattice(sizes["wil_dims"])
    bw = torch.randn((4, 3) + latw.dims, dtype=torch.complex64,
                     generator=torch.Generator(device=dev).manual_seed(
                         SEED + 38), device=dev)
    _, stats = wl.solve_eo(wl.new_wilson_eo(
        latw, _seeded_links(latw, dev, SEED + 36, 0.7), 0.1), bw,
        SolverParams(r2req=1e-10, maxits=2000))
    out["wilson_iterations"] = stats.iterations
    if dev != "cpu":
        gc.collect()
        torch.cuda.empty_cache()
        latm = Lattice(sizes["mem_dims"])
        th = config4_theory(latm, smear=HypCoefs(0.4, 0.5, 0.5), sloppy=True)
        out["force_mem"] = _force_peak(
            th, torch.Generator(device=dev).manual_seed(SEED + 39),
            _seeded_links(latm, dev, SEED + 35, AB_SMEARED_START))
    return out


def _shard_rank(rank: int, nranks: int, init: str, dev: str, sizes: dict,
                queue) -> None:
    """One rank of phase 39 (see :func:`phase_sharded`)."""
    import torch.distributed as dist
    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    torch.set_num_threads(1)
    # a timeout, so that a rank left waiting fails instead of hanging
    dist.init_process_group("gloo", init_method=init, world_size=nranks,
                            rank=rank, timeout=datetime.timedelta(
                                seconds=300))
    try:
        rec = _shard_checks(rank, dev, sizes)
        if dev != "cpu":
            # once _shard_checks has returned, so that none of its whole
            # fields is still allocated while the peak is read
            rec["blocks"]["force_mem"] = _force_mem_stage(dev, sizes)
        queue.put((rank, rec))
    finally:
        dist.destroy_process_group()


def _shard_checks(rank: int, dev: str, sizes: dict) -> dict:
    import torch.distributed as dist
    from qex_tpu_torch.io import lime, pario
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.ops import eo, linalg
    from qex_tpu_torch.parallel import dryrun
    from qex_tpu_torch.parallel.mesh import (gather_field, local_block,
                                             make_lattice_mesh)
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_shard as shd
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers.base import SolverParams
    cuda = dev != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [time.perf_counter()]
    laps = {}

    def lap(name):
        sync()
        marks.append(time.perf_counter())
        laps[name] = marks[-1] - marks[-2]

    lat8, lat16 = Lattice(sizes["dims8"]), Lattice(sizes["dims16"])
    fs8, f16, x8, x16 = _shard_fields(dev, sizes["dims8"], sizes["dims16"])
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[rank // 2]
    out = {"operators": {}, "seconds": laps}
    lap("fields")
    # the operators: the pairs' geometries at once, then the four ranks'
    for geom, group in ((SHARD_GEOMS2[rank // 2], pair), (SHARD_GEOM4, None)):
        for kind, lat, f, x, m in (("stag8", lat8, fs8, x8, 0.05),
                                   ("hisq16", lat16, f16, x16, 0.05)):
            lm = make_lattice_mesh(lat, geom, group=group)
            res = _shard_operators(lm, kind, f, x, m)
            if lm.rank == 0:
                out["operators"][f"{kind} {geom}"] = res
    res = _wilson_block_operators(dev, sizes["wil_dims"])
    if rank == 0:
        out["operators"][f"wilson8 {SHARD_GEOM4}"] = res
    dist.barrier()
    lap("operators")

    # --- the main path, counted ------------------------------------------
    sync()
    reset_counts()
    lm = make_lattice_mesh(lat8, SHARD_GEOM4)
    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    b = torch.randn(lat8.vector_shape(), dtype=x8.dtype, generator=g,
                    device=dev)
    be, bo = eo.pack(b, 4)
    s8 = st.StaggeredEO(lat8, sf.from_fast(fs8.g_e, lat8),
                        sf.from_fast(fs8.g_o, lat8))
    rhs = 0.05 * be - st.dslash_eo(s8, bo, 0)
    params = SolverParams(r2req=1e-10, maxits=5000, restarts=5)
    stats0 = dict(lm.stats)
    fs8_b, rhs_b = shd.block_of(lm, fs8), local_block(lm, rhs, "eo")
    sync()
    t0 = time.perf_counter()
    x_e, stats = shd.solve_ee_sharded(lm, fs8_b, rhs_b, 0.05, params)
    sync()
    secs = time.perf_counter() - t0
    x_e = gather_field(lm, x_e, "eo")
    del fs8_b, rhs_b
    staged = lm.stats["staged_s"] - stats0["staged_s"]
    copies = lm.stats["copy_s"] - stats0["copy_s"]
    # B2: config 5's multishift on the four ranks
    lm16 = make_lattice_mesh(lat16, SHARD_GEOM4)
    b16 = sf.from_fast(x16, lat16)
    f16_b = shd.block_of(lm16, f16)
    sync()
    t0 = time.perf_counter()
    xs16, stats16 = shd.solve_multi_sharded(
        lm16, f16_b, local_block(lm16, b16, "eo"), CONFIG5_MASSES,
        SolverParams(r2req=1e-10, maxits=2000))
    sync()
    secs16 = time.perf_counter() - t0
    xs16 = [gather_field(lm16, x, "eo") for x in xs16]
    del f16_b
    dist.barrier()
    lap("solves")
    # block-resident trajectories, the Wilson block solve, the block
    # eigensolve and the smeared force's peak memory, on four ranks
    out["blocks"] = _block_stage(rank, dev, sizes, lap)
    dist.barrier()
    # two config-4 trajectories over a pair, the other pair's first rank
    # running them without a mesh on the same draws; then pario and the
    # dry run over the second pair
    app = None
    if rank == 2 and sizes.get("app_argv"):
        # the app under torchrun, two ranks of its own, while this pair
        # and the first run their trajectories, pario and the dry run
        app = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "2", "--master_port", str(sizes["app_port"]),
             "-m", "qex_tpu_torch.apps.staghmc_spv", *sizes["app_argv"]],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    lat_h = Lattice(sizes["hmc_dims"])
    u_h = _seeded_links(lat_h, dev, SEED + 25, AB_SMEARED_START)
    if rank <= 2:
        lm_h = (make_lattice_mesh(lat_h, SHARD_GEOMS2[1], group=pair)
                if rank < 2 else None)
        th = config4_theory(lat_h, mesh=lm_h)
        gen_h = torch.Generator(device=dev).manual_seed(SEED + 26)
        u1, dhs = (u_h if lm_h is None else local_block(lm_h, u_h)), []
        for _ in range(2):
            u1, state = th.hmc_step(gen_h, u1, always_accept=True)
            dhs.append(state.dH)
        if lm_h is not None:
            u1 = gather_field(lm_h, u1)
        out["hmc"] = {"dH": dhs, "h_old": state.h_old,
                      "links": u1.cpu().numpy()}
        lap("hmc")
    if rank >= 2:
        lat_io = Lattice(sizes["io_dims"])
        lm_io = make_lattice_mesh(lat_io, (1, 1, 1, 2), group=pair)
        u_io = _seeded_links(lat_io, dev, SEED + 27, 0.7)
        path = sizes["pario_path"]
        blk = local_block(lm_io, u_io)
        t0 = time.perf_counter()
        pario.save_gauge_parallel(path, lat_io, lm_io, blk)
        t_w = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = pario.load_gauge_parallel(path, lat_io, lm_io, device=dev)
        t_r = time.perf_counter() - t0
        rec = {"write_s": t_w, "read_s": t_r,
               "read_back_equal": bool(torch.equal(back, blk)),
               "checksum_route": pario.native.last_route}
        bad = path + ".bad"
        if lm_io.rank == 0:
            raw = bytearray(Path(path).read_bytes())
            off = dict((t, o) for t, o, _ in pario._scan_records(path))[
                "scidac-binary-data"]
            raw[off + 4321] ^= 0x5A
            Path(bad).write_bytes(bytes(raw))
        lm_io.barrier()
        try:
            pario.load_gauge_parallel(bad, lat_io, lm_io)
            rec["flipped_byte"] = "not detected"
        except ValueError as e:
            rec["flipped_byte"] = str(e)
        out["pario"] = rec
        lap("pario")
        t0 = time.perf_counter()
        out["dryrun"] = dryrun.body(dev, 2, pg=pair)
        out["dryrun"]["seconds"] = time.perf_counter() - t0
        lap("dryrun")
        if app is not None:
            t0, proc = app
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
            out["app"] = {"rc": proc.returncode, "lines": stdout.splitlines(),
                          "stderr_tail": stderr[-8000:],
                          "seconds": time.perf_counter() - t0}
            lap("app_wait")
    sync()
    out["kernel_launches"] = read_counts()
    dist.barrier()
    lap("main_path_end")

    if rank == 0:
        # the same solve unsharded on this card, its true residual by the
        # plain canonical operator in complex128
        s = st.StaggeredEO(lat8, s8.g_e, s8.g_o)
        sync()
        t0 = time.perf_counter()
        x_ref, stats_ref = stag_solve.solve_ee(s, rhs, 0.05, params)
        sync()
        secs_ref = time.perf_counter() - t0
        s64 = st.StaggeredEO(lat8, s8.g_e.to(torch.complex128),
                             s8.g_o.to(torch.complex128))
        p16 = sh.new_hisq16(f16)
        bf16 = sf.to_fast(b16, lat16)
        b2 = float(linalg.norm2(bf16, torch.float64))
        out["solve_ee"] = {
            "dims": list(lat8.dims), "rank_geom": list(SHARD_GEOM4),
            "m": 0.05, "r2req": params.r2req,
            "iterations": stats.iterations,
            "iterations_unsharded": stats_ref.iterations,
            "true_rel_r2": _even_true_r2(s64, x_e, 0.05, rhs),
            "true_rel_r2_unsharded": _even_true_r2(s64, x_ref, 0.05, rhs),
            "seconds": secs, "seconds_unsharded": secs_ref,
            "seconds_per_iteration": secs / max(stats.iterations, 1),
            "seconds_per_iteration_unsharded":
                secs_ref / max(stats_ref.iterations, 1),
            "host_staged_s": staged, "host_copy_s": copies,
            "host_staging_share": staged / secs}
        out["solve_multi"] = {
            "dims": list(lat16.dims), "rank_geom": list(SHARD_GEOM4),
            "masses": list(CONFIG5_MASSES), "r2req": 1e-10,
            "iterations": stats16.iterations, "seconds": secs16,
            "seconds_per_iteration": secs16 / max(stats16.iterations, 1),
            "true_rel_r2": [float(linalg.norm2(
                sh.d2ee_hisq16(p16, sf.to_fast(x, lat16), m) - bf16,
                torch.float64)) / b2 for x, m in zip(xs16, CONFIG5_MASSES)]}
    return out


def _spawn(fn, nranks: int, args: tuple, timeout: float) -> dict:
    """Run ``fn(rank, nranks, *args, queue)`` in ``nranks`` processes;
    {rank: what it put}.  Raises if a rank fails or they outlast
    ``timeout`` seconds."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.start_processes(fn, args=(nranks, *args, queue),
                               nprocs=nranks, join=False,
                               start_method="spawn")
    deadline = time.monotonic() + timeout
    got = {}
    try:
        while len(got) < nranks:
            if not queue.empty():
                r, res = queue.get()
                got[r] = res
            elif procs.join(timeout=0.1):
                if queue.empty():
                    raise AssertionError(f"{nranks} ranks ended with "
                                         f"{len(got)} results")
            elif time.monotonic() > deadline:
                raise AssertionError(f"{nranks} ranks outlasted {timeout} s")
        while not procs.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"{nranks} ranks outlasted {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    return got


def _nccl_one_rank(dims8) -> dict:
    """A one-rank NCCL group at (1,1,1,1) in this process: the block
    operators (B1, no exchange) equal the unsharded kernel operators bit
    for bit, and a block solve's all-reduced sums go through NCCL."""
    import torch.distributed as dist
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.parallel.distributed import free_port
    from qex_tpu_torch.parallel.mesh import make_lattice_mesh, use_mesh
    from qex_tpu_torch.physics import stag_fast as sf
    from qex_tpu_torch.physics import stag_hisq as sh
    from qex_tpu_torch.physics import stag_shard as shd
    from qex_tpu_torch.solvers.base import SolverParams
    lat = Lattice(dims8)
    fs8, _, x, _ = _shard_fields("cuda", dims8, (8, 8, 8, 8))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        lm = make_lattice_mesh(lat, (1, 1, 1, 1))
        rec = {"backend": dist.get_backend()}
        for ldt in (torch.float32, torch.bfloat16):
            p = sh.new_stag8(fs8, ldt)
            with use_mesh(lm):
                pl = sh.new_stag8(shd.block_of(lm, fs8), ldt)
            xb = shd.fast_block(lm, x)
            rec[str(ldt)] = {
                "d2ee_equal": bool(torch.equal(
                    shd.d2ee_sharded(lm, pl, xb, 0.05),
                    sh.d2ee_stag8(p, x, 0.05))),
                "d2dd_equal": bool(torch.equal(
                    shd.d2dd_sharded(lm, pl, xb), sh.d2dd_stag8(p, x)))}
        _, stats = shd.solve_ee_sharded(lm, fs8, sf.from_fast(x, lat), 0.05,
                                        SolverParams(r2req=1e-10,
                                                     maxits=5000))
        rec["solve_iterations"] = stats.iterations
        rec["solve_r2"] = stats.r2
    finally:
        dist.destroy_process_group()
    return rec


def phase_sharded(dev: str = "cuda", sizes: dict | None = None) -> dict:
    """Phase 39: the domain-decomposed path with four ranks sharing the
    card through host-staged gloo (see the module docstring), the
    one-rank NCCL group, the app under two ranks."""
    from qex_tpu_torch.parallel.distributed import free_port
    sizes = dict({"dims8": SHARD_DIMS8, "dims16": SHARD_DIMS16,
                  "hmc_dims": SHARD_HMC_DIMS, "io_dims": IO_DIMS[0],
                  "blk_dims": SHARD_BLK_DIMS, "wil_dims": SHARD_WIL_DIMS,
                  "mem_dims": SHARD_MEM_DIMS,
                  "pario_path": str(ROOT / "build" / "chip_smoke_pario.lime")},
                 **(sizes or {}))
    Path(sizes["pario_path"]).parent.mkdir(parents=True, exist_ok=True)
    res = {"phase": "sharded", "ranks": 4, "backend": "gloo",
           "note": "four processes share one card; every exchange and sum "
                   "is staged through host memory: not a multi-GPU figure"}
    if dev != "cpu":
        # the ranks and the app share the card with this process: hand
        # back what its allocator holds from the earlier phases
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res["nccl_one_rank"] = _nccl_one_rank(sizes["dims8"])
        res["nccl_one_rank"]["seconds"] = time.perf_counter() - t0
        deck = str(ROOT / "qex_tpu_torch" / "apps" / "decks"
                   / "config4_24.xml")
        sizes.update(app_argv=["--xml", deck, *SHARD_APP_ARGS],
                     app_port=free_port())
    t0 = time.perf_counter()
    got = _spawn(_shard_rank, 4, (f"tcp://localhost:{free_port()}", dev,
                                  sizes), timeout=600)
    res["ranks_seconds"] = time.perf_counter() - t0
    r0, r2 = got[0], got[2]
    t0 = time.perf_counter()
    res["blocks"] = _block_record(r0["blocks"], _block_refs(dev, sizes),
                                  sizes)
    res["blocks"]["unsplit_seconds"] = time.perf_counter() - t0
    res["operators"] = {**r0["operators"], **r2["operators"]}
    res["solve_ee"], res["solve_multi"] = r0["solve_ee"], r0["solve_multi"]
    u_mesh, u_ref = r0["hmc"].pop("links"), r2["hmc"].pop("links")
    res["hmc"] = {"dims": list(sizes["hmc_dims"]),
                  "rank_geom": list(SHARD_GEOMS2[1]),
                  "dH_mesh": r0["hmc"]["dH"], "dH": r2["hmc"]["dH"],
                  "h_old": r2["hmc"]["h_old"],
                  "max_link_dev": float(abs(u_mesh - u_ref).max())}
    res["pario"], res["dryrun"] = r2["pario"], r2["dryrun"]
    res["rank_seconds"] = {"rank0": r0["seconds"], "rank2": r2["seconds"]}
    launches = {k: sum(got[r]["kernel_launches"][k] for r in got)
                for k in got[0]["kernel_launches"]}
    if "app" in r2:
        app = r2["app"]
        for ln in app["lines"]:
            print("  | " + ln, flush=True)
        res["app"] = {"argv": SHARD_APP_ARGS, "rc": app["rc"],
                      "seconds": app["seconds"],
                      "dH": [float(ln.split()[2]) for ln in app["lines"]
                             if ln.startswith(("ACCEPT", "REJECT"))]}
        if app["rc"] != 0:
            res["app"]["stderr_tail"] = app["stderr_tail"]
    res["kernel_launches"] = launches
    emit(res)
    _check_sharded(res, dev)
    _check_blocks(res["blocks"], dev)
    return res


def _block_record(got: dict, ref: dict, sizes: dict) -> dict:
    """Phase 39's block-resident numbers beside the unsplit ones."""
    rec = {"rank_geom": list(SHARD_GEOM4)}
    for tag in ("config4", "hisq"):
        g, r = got[tag], ref[tag]
        rec[tag] = {"dims": list(sizes["blk_dims"]), "dH_blocks": g["dH"],
                    "dH": r["dH"], "h_old": r["h_old"],
                    "seconds": g["seconds"],
                    "host_staged_s": g["host_staged_s"],
                    "max_link_dev": float(abs(g["links"]
                                              - r["links"]).max())}
    rec["eigs"] = dict(got["eigs"], dims=list(sizes["blk_dims"]),
                       evals_unsplit=ref["eigs"])
    rec["wilson"] = dict(got["wilson"], dims=list(sizes["wil_dims"]),
                         iterations_unsplit=ref["wilson_iterations"])
    if "force_mem" in got:
        g, r = got["force_mem"], ref["force_mem"]
        rec["force_mem"] = {
            "dims": list(sizes["mem_dims"]),
            "rank_max_memory_allocated": g["rank_max_memory_allocated"],
            "rank_peak_bytes": g["rank_peak_bytes"],
            "rank_resident_before": g["rank_resident_before"],
            "unsplit_max_memory_allocated": r["max_memory_allocated"],
            "unsplit_peak_bytes": r["peak_bytes"],
            "worst_ratio": max(g["rank_max_memory_allocated"])
            / r["max_memory_allocated"],
            "worst_ratio_peak_bytes": max(g["rank_peak_bytes"])
            / r["peak_bytes"],
            "seconds": g["seconds"], "seconds_unsplit": r["seconds"],
            "force_norm2": g["force_norm2"],
            "force_norm2_unsplit": r["force_norm2"],
            "note": "four processes share one card"}
    return rec


def _check_blocks(rec: dict, dev: str) -> None:
    for tag in ("config4", "hisq"):
        h = rec[tag]
        if not h["max_link_dev"] <= TOL_AB_LINK:
            raise AssertionError(f"blocks: {tag} link deviation {h}")
        for a, b in zip(h["dH_blocks"], h["dH"]):
            if not abs(a - b) <= TOL_AB_DH_REL_H * abs(h["h_old"]):
                raise AssertionError(f"blocks: {tag} dH {h}")
    e = rec["eigs"]
    for a, b in zip(e["evals"], e["evals_unsplit"]):
        if not abs(a - b) <= TOL_BLOCK_EIG:
            raise AssertionError(f"blocks: eigenvalues {e}")
    w = rec["wilson"]
    if abs(w["iterations"] - w["iterations_unsplit"]) > TOL_CG_ITS \
            or not w["true_rel_r2"] <= TOL_RES:
        raise AssertionError(f"blocks: Wilson solve {w}")
    if dev != "cpu":
        f = rec["force_mem"]
        if not max(f["worst_ratio"], f["worst_ratio_peak_bytes"]) <= \
                SHARD_MEM_RATIO:
            raise AssertionError(f"blocks: peak memory {f}")
        if not abs(f["force_norm2"] - f["force_norm2_unsplit"]) <= \
                1e-3 * f["force_norm2_unsplit"]:
            raise AssertionError(f"blocks: smeared force {f}")


def _check_sharded(res: dict, dev: str) -> None:
    for key, rec in res["operators"].items():
        for name, r in rec.items():
            for k in (("rel2_hop",) if name.startswith("wilson8") else
                      ("rel2_d2ee", "rel2_d2dd", "rel2_local_hop_vs_twin")):
                if not r[k] <= TOL_KERNEL:
                    raise AssertionError(f"sharded {key} {name}: {k} {r[k]}")
    for ldt, r in res.get("nccl_one_rank", {}).items():
        if isinstance(r, dict) and not (r["d2ee_equal"] and r["d2dd_equal"]):
            raise AssertionError(f"sharded: one-rank NCCL group {ldt} "
                                 "differs from the unsharded operator")
    if dev != "cpu" or "app" in res:
        if res["app"]["rc"] != 0 or len(res["app"]["dH"]) != 1 \
                or not math.isfinite(res["app"]["dH"][0]):
            raise AssertionError(f"sharded: app {res['app']}")
    s = res["solve_ee"]
    if s["iterations"] != s["iterations_unsharded"]:
        raise AssertionError(f"sharded: {s['iterations']} CG iterations "
                             f"against {s['iterations_unsharded']}")
    if not s["true_rel_r2"] <= TOL_RES:
        raise AssertionError(f"sharded: solve true residual "
                             f"{s['true_rel_r2']}")
    for m, r in zip(CONFIG5_MASSES, res["solve_multi"]["true_rel_r2"]):
        if not r <= TOL_MULTI:
            raise AssertionError(f"sharded: multishift mass {m} true "
                                 f"residual {r}")
    h = res["hmc"]
    if not h["max_link_dev"] <= TOL_AB_LINK:
        raise AssertionError(f"sharded: hmc link deviation {h}")
    for a, b in zip(h["dH_mesh"], h["dH"]):
        if not abs(a - b) <= TOL_AB_DH_REL_H * abs(h["h_old"]):
            raise AssertionError(f"sharded: hmc dH {h}")
    p = res["pario"]
    if not (p["read_back_equal"]
            and "checksum mismatch" in p["flipped_byte"]):
        raise AssertionError(f"sharded: pario {p}")
    needed = ("stag8_dslash", "hisq16_dslash") if dev != "cpu" else ()
    for k in needed:
        if res["kernel_launches"][k] <= 0:
            raise AssertionError(f"sharded: {k} never launched")


def _time_io(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_io_formats(dev: str = "cuda", dims_list=IO_DIMS,
                     pario_rec: dict | None = None) -> dict:
    """Phase 40: MILC, modfile, timeslice and SciDAC/LIME files of
    expm(0.7 tah) links at each volume, written from the card, read back
    bit for bit, checksums verified; LIME with the checksum codec and
    with its zlib loop (the io row of PERF.md); the two ranks' pario file
    of phase 39 against the serial LIME file of the same field; lat_util
    check and cmp."""
    import tempfile

    import numpy as np

    from qex_tpu_torch.apps import lat_util
    from qex_tpu_torch.io import lime, milc, modfile, native, timeslice
    from qex_tpu_torch.lattice import Lattice
    res = {"phase": "io_formats", "codec_built": native.library() is not None}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as td:
        for dims in dims_list:
            lat = Lattice(dims)
            u = _seeded_links(lat, dev, SEED + 27, 0.7)
            arr = u.cpu().numpy()
            rec = {}
            path = str(Path(td) / "cfg.lime")
            for route in ("native", "zlib"):
                with (native.zlib_only() if route == "zlib"
                      else contextlib.nullcontext()):
                    _, t_w = _time_io(lambda: lime.save_gauge(path, lat, u))
                    route_w = native.last_route
                    back, t_r = _time_io(lambda: lime.load_gauge(path, lat))
                    rec[f"lime_{route}"] = {
                        "route": route_w, "write_s": t_w, "read_s": t_r,
                        "bytes": Path(path).stat().st_size,
                        "bit_equal": bool(np.array_equal(back, arr))}
            res[dims_label(dims)] = rec
            if dims != tuple(dims_list[0]):
                del u, arr, back
                continue
            mpath = str(Path(td) / "cfg.milc")
            _, t_w = _time_io(lambda: milc.save_milc(mpath, lat, u))
            (back, _ts), t_r = _time_io(lambda: milc.load_milc(mpath))
            rec["milc"] = {"write_s": t_w, "read_s": t_r,
                           "bit_equal": bool(np.array_equal(back, arr))}
            fpath = str(Path(td) / "cfg.mod")
            w = modfile.ModFileWriter(fpath, userdata="<info>links</info>")
            _, t_w = _time_io(lambda: w.add_field(modfile.pack_key((0,)), lat,
                                                  u, precision="F"))
            w.close()
            r = modfile.ModFileReader(fpath)
            back, t_r = _time_io(lambda: r.read_field(
                modfile.pack_key((0,)), lat, (4, 3, 3), precision="F"))
            r.close()
            rec["modfile"] = {"write_s": t_w, "read_s": t_r,
                              "bit_equal": bool(np.array_equal(back, arr))}
            tpath = str(Path(td) / "cfg.ts")
            _, t_w = _time_io(
                lambda: timeslice.write_timeslices(tpath, lat, u))
            back, t_r = _time_io(lambda: np.stack(
                [timeslice.read_timeslice(tpath, lat, (4, 3, 3), t)[..., 0]
                 for t in range(lat.dims[3])], axis=-1))
            rec["timeslice"] = {"write_s": t_w, "read_s": t_r,
                                "bit_equal": bool(np.array_equal(back, arr))}
            # the serial file of phase 39's field, and lat_util on both
            if pario_rec is not None:
                ppath = str(ROOT / "build" / "chip_smoke_pario.lime")
                res["pario"] = dict(pario_rec, bytes_equal_serial=(
                    Path(ppath).read_bytes() == Path(path).read_bytes()))
            out = io.StringIO()
            other = str(Path(td) / "other.lime")
            lime.save_gauge(other, lat, arr * 1.001)
            with contextlib.redirect_stdout(out):
                rc = [lat_util.main(["check", path]
                                    + (["--cpu"] if dev == "cpu" else [])),
                      lat_util.main(["cmp", path, path]),
                      lat_util.main(["cmp", path, other])]
            res["lat_util"] = {"rc": rc,
                               "lines": out.getvalue().splitlines()}
            del u, arr, back
    emit(res)
    for dims in dims_list:
        for fmt, r in res[dims_label(dims)].items():
            if not r["bit_equal"]:
                raise AssertionError(f"io_formats {dims} {fmt}: read back "
                                     "differs")
    if res["lat_util"]["rc"] != [0, 0, 1]:
        raise AssertionError(f"io_formats: lat_util {res['lat_util']}")
    if pario_rec is not None and not res["pario"]["bytes_equal_serial"]:
        raise AssertionError("io_formats: the pario file differs from the "
                             "serial file")
    return res


def phase_suite() -> dict:
    """Phase 41: bench/suite at 16^4 with a 0.02 s budget a measurement;
    its lines are printed as they come."""
    from qex_tpu_torch.bench import suite
    t0 = time.perf_counter()
    rc = suite.main(["--lat", "16", "16", "16", "16", "--budget", "0.02"])
    res = {"phase": "suite", "rc": rc, "seconds": time.perf_counter() - t0}
    emit(res)
    if rc != 0:
        raise AssertionError(f"suite exited {rc}")
    return res


def profiled(tag: str, fn) -> dict:
    """Run ``fn`` once under torch.profiler: wall time, device kernel
    count and busy time (sum of kernel durations; one stream, so they
    do not overlap), and the ten operators with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    top = sorted(prof.key_averages(),
                 key=lambda a: -a.self_device_time_total)[:10]
    res = {"phase": f"profile_{tag}", "wall_s": wall,
           "device_kernels": len(kernels), "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall,
           "top_self_device_ms": [[a.key[:60], a.count,
                                   a.self_device_time_total / 1e3]
                                  for a in top]}
    emit(res)
    return res


def profile_main() -> int:
    """``--profile``: one f32 and one sloppy solve, one smeared config-4
    trajectory and one HISQ trajectory at 24^4, and one Wilson eo solve
    at 24^3x32, under torch.profiler (not part of the checked run)."""
    from qex_tpu_torch.gauge.smear import HypCoefs
    from qex_tpu_torch.lattice import Lattice
    from qex_tpu_torch.physics import stag_solve
    from qex_tpu_torch.physics import staggered as st
    from qex_tpu_torch.solvers.base import SolverParams
    phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lat = Lattice((24, 24, 24, 24))
    u = random_links(lat, gen)
    s = st.new_stag_eo(lat, u)
    b = torch.randn(lat.vector_shape(), dtype=torch.complex64,
                    generator=gen, device=gen.device)
    for route, sloppy in (("solve_f32", False), ("solve_sloppy", True)):
        params = SolverParams(r2req=1e-10, maxits=5000, restarts=5,
                              sloppy=sloppy)
        stag_solve.solve(s, b, 0.05, params)              # warm-up
        profiled(route, lambda: stag_solve.solve(s, b, 0.05, params))
    th = config4_theory(lat, smear=HypCoefs(0.4, 0.5, 0.5))
    th.hmc_step(gen, u)                                   # warm-up
    profiled("hmc_smeared", lambda: th.hmc_step(gen, u))
    th = hisq_theory(lat)
    u = random_links(lat, gen, scale=HISQ_START)
    th.hmc_step(gen, u)                                   # warm-up
    profiled("hmc_hisq", lambda: th.hmc_step(gen, u))
    from qex_tpu_torch.physics import wilson as wl
    lat = Lattice((24, 24, 24, 32))
    w = wl.new_wilson_eo(lat, random_links(lat, gen), 0.1)
    b = torch.randn((4, 3) + lat.dims, dtype=torch.complex64, generator=gen,
                    device=gen.device)
    params = SolverParams(r2req=1e-12, maxits=1000, restarts=3)
    wl.solve_eo(w, b, params)                             # warm-up
    profiled("wilson_solve_f32", lambda: wl.solve_eo(w, b, params))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import qex_tpu_torch  # noqa: F401  (pins full-f32 arithmetic)
    from qex_tpu_torch.gauge.smear import HypCoefs
    smeared_theory = functools.partial(
        config4_theory, smear=HypCoefs(0.4, 0.5, 0.5), sloppy=True)
    if sys.argv[1:] == ["--profile"]:
        return profile_main()
    if sys.argv[1:2] == ["--northstar-chain"]:
        return northstar_chain(sys.argv[2])

    t_start = time.perf_counter()
    dev = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kern = phase_kernel(gen)
    phase_solve(gen)
    phase_hmc(gen)
    _ab(gen, "ab", config4_theory)
    smeared = phase_hmc_smeared(gen)
    app = phase_app()
    _ab(gen, "ab_smeared", smeared_theory, start=AB_SMEARED_START,
        needed=("stag8_dslash", "stag8_dslash_bf16"))
    hsolve = phase_hisq_solve(gen)
    hhmc = phase_hmc_hisq(gen)
    _ab(gen, "ab_hisq", hisq_theory, start=HISQ_START,
        needed=("hisq16_dslash",))
    kern.update(phase_wilson_kernel(gen))
    wsolve = phase_wilson_solve(gen)
    wmesons = phase_wilson_mesons(gen)
    wmg = phase_wilson_mg(gen)
    gen_err = phase_stag_generations_kernel(gen)
    gtime = phase_stag_generations_time(gen)
    gcg = phase_stag_generations_cg(gen)
    phase_puregauge_accept(gen)
    ns_run = start_northstar_accept()
    phase_puregauge_config3(gen)
    phase_flow(gen)
    phase_apps_gauge()
    smulti = phase_stag_multi(gen)
    rhmc = phase_rhmc(gen)
    _ab(gen, "ab_rooted", rooted_theory, start=AB_SMEARED_START)
    hasen = phase_hasenbusch(gen)
    _ab(gen, "ab_hisq_hasenbusch", hisq_hasenbusch_theory, start=HISQ_START,
        needed=("hisq16_dslash",))
    ns32 = phase_northstar32(gen)
    eigs_hisq = phase_eigs_hisq(gen)
    eigs_stag, u_meas = phase_eigs_stag(gen)
    meas = phase_measure(u_meas, gen)
    del u_meas
    app_pbp = phase_app_pbp()
    phase_xy(gen)
    phase_u1(gen)
    phase_u1_qn(gen)
    phase_nambu(gen)
    phase_rahmc(gen)
    phase_gauge_fix(gen)
    sharded = phase_sharded()
    phase_io_formats(pario_rec=sharded["pario"])
    phase_suite()
    ns_accept = finish_northstar_accept(ns_run)
    kern["stag8_dslash"]["max_abs_err"] = max(
        kern["stag8_dslash"]["max_abs_err"],
        ns32["stag8_dslash_vs_plain"]["max_abs_err"])
    kern["hisq16_dslash"]["max_abs_err"] = max(
        kern["hisq16_dslash"]["max_abs_err"],
        eigs_hisq["hisq16_vs_plain"]["max_abs_err"])
    kern["wilson8_hop"]["max_abs_err"] = max(
        kern["wilson8_hop"]["max_abs_err"],
        meas["wilson8_vs_plain"]["max_abs_err"])
    for name, err in gen_err.items():
        kern[name] = dict(gtime[name], max_abs_err=err)
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(dev["smi"], flush=True)
    # each kernel's main path: the smeared config-4 trajectories, the
    # app, the north-star chain, the multi-mass and batched solves, the rooted and Hasenbusch
    # runs, the 32^3x64 trajectory, the plain eigensolve, SVD and
    # calibration, the measure and eigs apps, the app's condensate and
    # the sharded solves, trajectories and dry run for the 8-term
    # kernels, config 5's solves, the HISQ trajectories (with and
    # without a Hasenbusch mass), the HISQ eigensolve and the sharded
    # multishift and dry run for the 16-term ones, the Wilson solves,
    # mesons, MG A/B and the measure app's Wilson mesons for the Wilson
    # hop, the generation benchmark's A/B and CG for the older
    # staggered kernels
    paths = {"stag8": (smeared, app, ns_accept, smulti, rhmc, hasen, ns32,
                       eigs_stag, meas, app_pbp, sharded),
             "hisq16": (hsolve, hhmc, hasen, eigs_hisq, sharded),
             "wilson8": (wsolve, wmesons, wmg, meas, sharded),
             **{kind: (gtime, gcg) for kind in GEN_KINDS}}
    kernels = []
    for name, (kind, _ldt, _c) in KERNELS.items():
        k = kern[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"qex_tpu_torch/csrc/{SOURCES[kind]}",
            "replaces": REPLACES[kind],
            "launches": sum(ph["kernel_launches"][name]
                            for ph in paths[kind]),
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_us": k["bound_ms"] * 1e3, "bound_by": k["bound_by"],
            "library_ms": None})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
