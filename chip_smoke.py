#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. device   print the card's name and power limit; pin TF32 off;
  2. build    compile the K1 Cholesky (single-matrix and batched), K8
              rank-k update and K2-batched LDL^T kernels from
              madqp_tpu_torch/csrc/, one nvcc
              per source, in parallel; print ptxas's registers, stack and
              spills per kernel (their shared memory is dynamic, set by
              each source's smem_bytes) and count the FP64 tensor-core
              instructions (DMMA) in each library's SASS, which must be
              there in the three that hold a DMMA tile product (float64:
              K1, K8, K2-batched); K2-batched's shared tier's CTAs
              (matrices) per SM at order 128 from the occupancy API, at
              least ldl_batched.CTAS_PER_SM (2 in float64, 4 in float32);
  3. K1       K1 against its plain PyTorch versions in float32 and float64
              at n in SIZES: the version that follows its route's kernel
              (pallas_chol.ROUTE_REFERENCE, factor error relative to max|L|
              within pallas_chol.ROUTE_TOL) and the 64-column one (within 1e-5 /
              1e-12), reconstruction residual, the NaN contract on a
              non-SPD input, two runs bit-equal; CUDA-event timings of the
              kernel, its route's plain version and torch.linalg.cholesky
              at TIMED_SIZES;
  4. main     madqp_tpu_torch.solve on random_qp(500, 200, seed) for seeds
              0-3 with the headline benchmark's options and
              linear_solver="pallas": status, iteration count and objective
              against madqp_tpu_torch/testdata/jax_reference.json, and the
              K1 launch count; seed 0 once more with linear_solver="dense";
  5. large    random_qp(2000, 1000) (W is 2500 x 2500), same checks;
  6. K8       K8 against its plain version in float32 and float64 at the
              shapes of SYRK_SHAPES, out of place and as panel_chol calls
              it, on views of a larger matrix, in place
              (max|out - plain| / max|plain| <= 1e-5 / 1e-12; a NaN in one
              row of B gives NaN in the same places in both; two runs
              bit-equal; the rest of the parent matrix untouched), and
              CUDA-event timings of the kernel, the plain version and
              torch.addmm at SYRK_TIMED beside the bound of the work the
              update needs (syrk_ops); then the kernel's time summed over
              the launches of one factorization trial of the blocked cell;
  7. blocked  madqp_tpu_torch.autosolve on random_qp(2000, 1000): bucketing
              pads it to W 4096 x 4096 and S 1024 x 1024 and picks
              linear_solver="blocked", whose panel Cholesky runs K8 for
              every trailing update of a panel or stripe that has columns
              left (blocked_dense.panel_update_shapes: 18 launches per
              factorization trial); checked against the reference's
              autosolve_n2000 entry;
  8. variants random_qp(500, 200, seed=0) with each dense KKT variant of
              the reference's n500_variants (blocked, inverse, K2 with LU,
              K2.5 with the signed blocked LDL^T, whose K (800, 800) takes
              seven K2-batched launches per trial: blocked_ldl on the card
              is ldl_blocks); these launch no K8;
  9. batched K1 against its plain version on (B, n, n) stacks at
              BATCHED_SHAPES in float32 and float64, at the edges of every
              route of pallas_chol.batched_route (registers for n <= 32,
              a warp or a CTA per matrix in shared memory up to the limit
              n_max, the persistent kernel with a lane axis above it) and
              at the two-stage cell's and the weak-scaling shape's stacks
              and at public two-stage sets' own second-stage widths
              (PUBLISHED_SHAPES: the lane-axis kernel at 256-1024 lanes):
              one launch per stack, phase 3's tolerances per matrix, one
              non-SPD matrix gives NaN on its own diagonal only and leaves
              the others' factors bit-equal, two runs bit-equal, and on
              the persistent route each lane's factor equals the 2-D call
              on that matrix bit for bit; CUDA-event timings of the
              kernel, its route's plain version and
              torch.linalg.cholesky_ex on the stack at BATCHED_TIMED;
 10. batched  solve_batched on 512 x dense_dummy_qp(32, 16, seed=i) with
              bench.py's batched options and endgame="f64", through
              linear_solver="pallas" (K1 in registers for S, a warp per
              matrix for W: two launches per factorization trial of the
              whole batch) and
              "dense": every lane's status, iterations and objective
              against the reference's batched512 entry, and instances/s;
              then the four n = 500 headline QPs as one batch with
              "pallas" (W 600^2 above n_max: the persistent kernel with a
              lane axis; S 200^2 a CTA per matrix; one launch each per
              factorization trial) against the n500 entries;
 11. layer    qp_layer on a batch of 64 random QPs (n = 32, m = 8) in
              float64, forward and backward, with "pallas" and "dense":
              gradients of all six inputs for four lanes against the
              reference's qp_layer64 entry;
 12. two-stage solve_two_stage on random_two_stage(n0=128, ns=96, ms=48,
              m0=16, N=1024) (98,432 variables) with "pallas" and "dense"
              in float64 and "pallas" with the float32 factorization and
              one refinement step: status, iterations, objective, x0 and
              the norms of x and y against the reference's two_stage_1024
              entry; under "pallas" each factorization trial is one `cta`
              launch (U), one `warp64` (S) and two `single` (C00, S0);
 13. pipeline the structured suite's large tier (19 families, seed 0)
              written by write_suite as MPS/QPS files and run through the
              suite runner (tools/run_suite_torch.py::run_instance: read_mps
              -> presolve_qp -> scale_qp -> solve, bucketed, with
              "pallas" -> unscale_stats) in float64 and with
              --mixed-precision, then the tests/data/real_mm corpus
              through --dir in float64: every record against the
              reference's suite_large / real_mm entries (status;
              objective within 1e-8 of the reference's float64 one, or
              MIXED_RTOL mixed; iterations within 1, or MIXED_ITER_BAND
              mixed, one-sided for the transport family), the corpus
              against its published optima; an "error:" record
              fails, K1 (one `single` launch per factored W or S per trial)
              must run.  Prints each instance's wall and iterations/s and
              the tier's totals;
 14. host     the host path on the card's machine (no kernel launches):
              the native sparse LDL built from native/src/sparse_ldl.cpp
              (madqp_tpu_torch.native.available() must hold); the corpus
              through the runner's --backend host against its published
              optima (the gzip file read); the large tier (seed 0, read
              back from MPS files) through --backend host against the
              reference runner's host_large records (iterations equal:
              the same C++ LDL runs in both; objective within 1e-9);
              the xlarge portfolio QP through solve_host (solved within
              40 iterations); phase 10's batched-512 cell with
              endgame="auto", whose float32 failures the host path
              re-solves (the count printed; every lane held as in phase
              10);
 15. sparse   the xlarge tier's members on the normal equations up to
              dense_normal_limit (XLARGE_NORMAL: 12 LP families and svm,
              read back from MPS files) through --backend sparse-device
              --sparse-kkt auto: S assembled on the card and factored as
              one dense matrix, by the panel Cholesky with K8 from m =
              1024; in float64 against the reference runner's host_xlarge
              records (status; iterations within 1, or within
              MIXED_ITER_BAND for the transport family) and its
              sparse_xlarge records of the JAX dense-normal path
              (objective within 1e-8: on illscaled_5000_0 that path's
              own optimum lies 2.0e-7 from the host path's), and with
              --mixed-precision --endgame host (status; the endgame on
              the host, svm's dense columns handing over to the host K2;
              objective within MIXED_RTOL of the float64 host record, or
              within twice the reference's own mixed record's distance
              where that is larger: 3.3e-6 on blending_400_0, 6.4e-4 on
              illscaled_5000_0); per member m, the assembly, the panel path, its K8
              launches (counted from 0 just before the solve) and the
              solve and endgame seconds; then gridlp_100's S assembled and
              factored twice from one iterate, bit-equal;
 16. supernodal the xlarge LP above dense_normal_limit, bandedlp_30000_0
              (m = 15000 after presolve, read back from its MPS file),
              through --backend sparse-device: the supernodal schedule
              (one _BucketScan of 9 rounds of 128 fronts, w_pad 128,
              u_pad 8), each front stack's F11 factored by K1's batched
              form (`cta`: 9 launches per factorization trial); in
              float64 with the JAX record's iterations and objective
              within 1e-8 (supernodal_xlarge), and with --mixed-precision
              --endgame host (the float32 phase's floored LDL^T in torch
              ops, no K1; objective within MIXED_RTOL of the float64 host
              record); gridlp_100_0 and staircase_2000p24_0 forced onto
              the path (dense_normal_limit = 0) against their host_xlarge
              records (iterations within 1, objective within 1e-8); per run
              the factorization trials, K1 launches by route per trial and
              per iteration, solve seconds and the schedule; K1 on the F11
              stacks captured from the bandedlp solve (its first trial's
              at ROUTE_TOL, its last trial's ill-conditioned ones by
              backward error and within n cond eps of the route's plain
              version), (128, 128, 128) float64 timed against
              torch.linalg.cholesky_ex beside its bound, and a chain
              step's one front on its stack route and on the 2-D launch;
              bandedlp's supernodal KKT built (host symbolic seconds), its
              S assembled and factored twice from one iterate, bit-equal,
              with ms per factorization and per backsolve; the
              --mixed-precision run's float32 fronts factored by
              K2-batched (one launch per front stack and trial);
 17. sparse QP a. K2-batched (the signed no-pivot LDL^T of a stack,
              csrc/ldl_batched.cu) against its plain version
              (ldl_batched.ldl_batched_reference) on quasi-definite stacks
              at LDL_WIDTHS x LDL_BATCHES, float32 and float64, with and
              without the pivot floor (ldl_batched.TOL relative to max|L|
              and max|d| per matrix), one launch per stack, two runs
              bit-equal, a zero pivot's inf / NaN in its own matrix only;
              CUDA-event times at LDL_TIMED beside the plain version and
              the bound, and for orientation only ldl_factor_ex (which
              pivots) and cholesky_ex on an SPD stack;
              b. the xlarge tier's QP members with a general Hessian
              (chainqp_50000, cvxqp_20000, lasso_50000, portfolio_800;
              read back from QPS files) through --backend sparse-device
              --sparse-kkt auto, the augmented K2 system whose every front
              stack K2-batched factors: in float64 against the reference
              runner's augmented_xlarge records (status, iterations within
              1, objective within 1e-8) and with --mixed-precision
              --endgame host (iterations within MIXED_ITER_BAND, objective
              within MIXED_RTOL of the float64 record or twice the
              reference's own distance); --sparse-kkt condensed on chainqp
              and cvxqp in float64 (K1's batched form on C's fronts;
              iterations within COND_ITER_BAND of condensed_xlarge) and
              cvxqp with --mixed-precision --endgame krylov; per run the
              factorization trials by route (the augmented system's all
              replays of one graph but its capture), the K2-batched and K1
              launches per trial run on the card (a capture runs twice),
              solve and host symbolic seconds; K2-batched on cvxqp's
              and chainqp's captured fronts (each member's last float64
              trial; backward error within LDL_BACKWARD_TOL of
              max|L||D||L^T|, pivot signs as the plain version's; each
              member's largest stack timed beside its bound, chainqp's
              (438, 128, 128); --save-fronts DIR keeps them for
              tools/ldl_times_torch.py --stacks), cvxqp's K assembled and
              factored twice bit-equal, and
              MPCSolver(kkt_system="sparse-augmented") on it against
              solve_sparse_qp;
 18. sparse batch solve_sparse_batched of 16 same-pattern instances at the
              reference's sweep sizes (testdata's sparse_batched runs:
              banded_sparse_lp(2000, 1000, band=5) and grid_lp(40) on
              the normal equations in float64 and with the float32
              factorization, chain_qp(10000) on the augmented system):
              every lane's status, iterations (equal; within
              MIXED_ITER_BAND with the float32 phase) and objective
              (1e-8) against the reference's batch; K1-batched and
              K2-batched once per front stack and factorization trial for
              the whole batch (every stack B times as deep as one
              instance's); the lane-stacked fronts of the first and last
              trials against the kernels' plain versions (K1 as in phase
              16, K2 as in phase 17, the floored float32 fronts by their
              L D L^T against the plain version's, relative to
              max|L||D||L^T|, and equal pivot signs); the float64 LP
              batches twice,
              bit-equal, their warm wall against the serial loop of the
              port's single supernodal solves, and K1 `cta` on a captured
              (16 x 8, 128, 128) stack against cholesky_ex;
 19. backends every dense KKT backend of a single solve on a batch
              (BatchedMPCSolver, bench.py's batched options, endgame="f64")
              against the reference's batched_backends records: (a)
              batched-512 under condensed blocked, condensed
              solve_mode="inverse" with "dense" and "pallas", K2 and K2.5
              with LU and with linear_solver="blocked" (the signed LDL^T:
              K2-batched on K (512, 58, 58)); (b) the n = 500 QPs (seeds
              0-3) under k2-blocked (K (4, 800, 800): seven K2-batched
              launches of 128-wide diagonal blocks per trial) and condensed
              blocked; (c) four random_qp(2000, 1000) with "blocked" (W
              (4, 2500, 2500): the panel Cholesky's K8 updates, each one
              launch for the four lanes, len(panel_update_shapes(2500)) per
              trial of W): every lane's status, iterations (within 1) and
              objective (1e-8), and each run's launches; then K8's lane
              axis at (c)'s launch shapes (4 lanes, each a view into its own
              matrix) against its plain version (SYRK_TOL), timed beside
              the plain version, torch.baddbmm and the bound of the four
              updates, panel_chol on 1, 2 and 4 lanes with
              len(panel_update_shapes(2500)) K8 launches each; and
              K2-batched on BACKEND_LDL_STACKS in float32 and float64, with
              and without the floor, at ldl_batched.TOL with equal pivot
              signs, timed beside the plain version and the bound;
 20. mesh     the sharded paths (mesh=, torch.distributed) on a one-rank
              NCCL group (MASTER_ADDR / MASTER_PORT / RANK=0 /
              WORLD_SIZE=1) under a one-rank DeviceMesh: phase 10's
              batched-512 with "pallas", phase 12's two_stage_1024 with
              "pallas" in float64 and phase 18's 16 x banded_sparse_lp(2000,
              1000) in float64, each bit-equal to its phase's unsharded run
              (status, iterations and x of every instance: with one rank
              every gather and sum is a copy), against the same JAX records
              and with the same K1 launches by route; the group is
              destroyed at the end.
Phase 6 also holds and times K8 at every launch shape of the panel
Cholesky of the largest m that phase 15 factors (blocked_dense.
panel_update_shapes), in float32 and float64.

Every launch counter is set to 0 just before each solve phase and read
just after it.  The line before the last is a JSON object describing the
kernels (times at the shape the path runs most: K1 at n = 600 float32, K8
at (3840, 1792, 256) float32, the first and largest in-stripe update of
the blocked cell's W (its launches include phase 15's), batched K1 at (512, 42) float32, W of the batched
cell, and the persistent K1 with a lane axis at (4, 600) float32, W of the
n = 500 batch, and K2-batched at (128, 128, 128) float64, the
augmented fronts' shape, with the shared tier's occupancy; the launches of K1 include phase 12's and phase
13's, those of K1-batched phase 12's, phase 16's float64 runs', phase
17's condensed runs' and phase 18's on its batched tiers, those of
K1-lanes phase 16's and 17's on the lane axis, those of K2-batched phases
7, 8, 15 (the card's blocked_ldl: ops/blocked_dense.py::ldl_blocks), 16,
17, 18 and 19's, those of K8 and K1-batched phase 19's too, those of K1
and K1-batched phase 20's);
the last line is {"ok": true, "device": {...}}.
Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result.
"""

import collections
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# max|L - L_plain| / max|L_plain| against the 64-column plain version
# (cholesky_lower_reference, what cholesky_lower runs on the CPU)
TOL_FACTOR = {"float32": 1e-5, "float64": 1e-12}
TOL_RESIDUAL = {"float32": 1e-4, "float64": 1e-12}  # ||L L^T - A||_F / ||A||_F
# 16 and 128: S0 and C00 of the two-stage cell (phase 12); 32, 64, 128,
# 256, 512, 1024 and 2048: the bucketed W and S orders of phase 13
SIZES = (1, 16, 32, 37, 63, 64, 65, 128, 129, 200, 256, 512, 600, 1000, 1024, 2048,
         2500)
TIMED_SIZES = (200, 600, 1000, 2048, 2500)
DETERMINISM_SIZES = (600, 2500)
MAIN_SHAPES = (200, 600)  # S and W of the n=500 headline problem
TIMING_RUNS = 20
BURST = 5  # calls per timed sample
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: the host queues a burst meanwhile
SOLVE_OPTIONS = dict(tol=1e-8, max_ncorr=0, factorization_dtype="float32",
                     max_refine_steps=1, print_level=40)
# K8 (r, c, k): ragged and rectangular edges, and the blocked path's shapes
# (blocked_dense.panel_update_shapes of W 4096 and S 1024: in-stripe
# updates of the first stripe (3840, 1792, 256) ... (2304, 256, 256), the
# cross-stripe (2048, 2048, 2048), the second stripe's (1792, 1792, 256)
# ... (256, 256, 256), S's (768, 768, 256) ...), the shape of the earlier
# rows of PERF.md (4096, 2048, 256) and a deep narrow one.
SYRK_SHAPES = ((1, 1, 1), (37, 37, 5), (300, 200, 40), (3840, 1792, 256),
               (2304, 256, 256), (2048, 2048, 2048), (1792, 1792, 256),
               (768, 768, 256), (256, 256, 256), (4096, 2048, 256),
               (256, 256, 2048))
# Timed, and giving max_abs_err; (4096, 2048, 256) for continuity with the
# earlier rows of PERF.md.
SYRK_TIMED = ((3840, 1792, 256), (2048, 2048, 2048), (1792, 1792, 256),
              (768, 768, 256), (4096, 2048, 256))
SYRK_TOL = {"float32": 1e-5, "float64": 1e-12}   # max|out - plain| / max|plain|
# Scenario stacks at public two-stage sets' own second-stage widths (U:
# columns, S: rows): SSN's 706 and 175 and 20-term's 124 rows with 1024
# scenarios, storm's 528 rows with 1024 and its 1259 columns with 256 (the
# phase holds about ten copies of a stack).  All but 124 are above n_max
# in float64, so they run the lane-axis kernel.
PUBLISHED_SHAPES = ((1024, 706), (1024, 175), (1024, 124), (256, 1259), (1024, 528))
# Batched K1 (B, n): the batched cell's W and S, qp_layer's (64, 32) and
# (64, 8), the edges of the routes (8, 16, 32, 64, 32-column blocks), the
# largest order one CTA holds ("max") and the first it does not, S and W of
# the n = 500 QPs as one batch (S one CTA per matrix in float32, above the
# limit in float64; W above it), W of the n = 2000 QP, and large stacks of
# mid-size matrices, where the CTA per matrix is of 4 warps, not 8.
BATCHED_SHAPES = ((512, 42), (512, 16), (64, 1), (64, 8), (64, 31), (64, 32),
                  (64, 33), (64, 63), (64, 64), (64, 65), (16, "max"), (16, "max+1"),
                  (4, 200), (4, 600), (4, 2500), (512, 100), (256, 160),
                  # the two-stage cell's U and S stacks (phase 12) and the
                  # weak-scaling shape's (benchmarks/exp_scaling.py:77)
                  (1024, 96), (1024, 48), (8, 20), (8, 12), *PUBLISHED_SHAPES)
BATCHED_TIMED = ((512, 42), (512, 16), (64, 32), (4, 200), (4, 600), (512, 100),
                 (1024, 96), (1024, 48), (8, 20), (8, 12), *PUBLISHED_SHAPES)
BATCH = 512
BATCHED_OPTIONS = dict(tol=1e-8, print_level=40, factorization_dtype="float32",
                       max_refine_steps=1, endgame="f64")  # + the step rule
LAYER = dict(lanes=64, n=32, m=8, tol=1e-10)  # qp_layer batch of phase 11
# Phase 13.  The corpus's published optima (tests/test_real_corpus.py:21-29;
# HS35_gz is HS35 compressed), held as that file's --dir check holds them:
# |objective - optimum| <= max(1e-6, 1e-7 |optimum|).
PUBLISHED = {
    "HS21": -99.96,
    "HS35": 1.0 / 9.0,
    "HS35_gz": 1.0 / 9.0,
    "HS76": -4.68181818181818,
    "HS51": 0.0,
    "HS52": 1859.0 / 349.0,
    "HS53": 176.0 / 43.0,
    "HS118": 664.82045,
}
# Iterations are held within 1 of the reference's in float64.  With the
# float32 factorization (--mixed-precision) they are held within
# MIXED_ITER_BAND, the band of tests/test_torch_solver.py's
# RESCUE_ITER_BAND (one stall window of 5 plus a margin of 3): which
# float32 trials pass near a singular Schur complement differs between
# Cholesky routines.  Measured on the H100 against the JAX CPU records:
# within 3, but for the transport family, whose balance rows are linearly
# dependent.  There transport_40x50_0 takes 21 iterations on the card (two
# runs), 68 in the JAX record (LAPACK's float32 Cholesky), 63 through the
# port's dense path on the CPU: MIXED_ONE_SIDED holds the family only to
# no more than the reference's count plus the band.
MIXED_ITER_BAND = 8
MIXED_ONE_SIDED = ("transport_",)
# A mixed-precision objective is held against the reference's float64
# objective of the same instance within MIXED_RTOL relative.  Measured on
# the H100: at most 2.6e-8 (illscaled_500_0; the next 1.2e-8,
# setcover_400_0).  The reference's own mixed records lie up to 1.2e-7
# (blending_120_0) from its float64 objectives, and 1.29e-5 on
# illscaled_500_0.
MIXED_RTOL = 1e-6
# Phase 15: the xlarge families whose rows after presolve are at most
# dense_normal_limit (12288), the LPs and svm (diagonal Hessian); bandedlp
# (15000 rows) takes the supernodal path (phase 16).
XLARGE_NORMAL = ("transport", "multicomm", "staircase", "blending", "fixed",
                 "assignment", "setcover", "diet", "illscaled", "redundant",
                 "ranges", "gridlp", "svm")
PANEL_MIN = 1024   # blocked_dense._PANEL_MIN: the panel Cholesky (K8) from here
# Phase 16: the xlarge LP above dense_normal_limit (the supernodal path
# under "auto"), and two members forced onto it (dense_normal_limit = 0),
# held to their host_xlarge records.
SUPERNODAL = "bandedlp_30000_0"
FORCED_SUPERNODAL = ("gridlp_100_0", "staircase_2000p24_0")


_T0 = time.perf_counter()


def phase(name):
    print(f"== {name}  [{time.perf_counter() - _T0:.1f} s into the run]", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def device_phase(torch):
    phase("1. device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    # Full-f32 products: the f32 factorization's accuracy rests on them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device: {name}")
    return name, smi


def build_phase(torch, k1, k8, k2):
    phase("2. build")
    from madqp_tpu_torch.ops import _build

    # (source, loader, holds the tile product, so DMMA in float64)
    libs = ((k1.SOURCE, k1._library, True),
            (k1.SOURCE_BATCHED, k1._batched_library, False),
            (k8.SOURCE, k8._library, True),
            (k2.SOURCE, k2._library, True))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        paths = list(pool.map(lambda lib: _build.build(lib[0]), libs))
    for _, load, _ in libs:
        load()
    print(f"built {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s")
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    for (source, _, tile), path in zip(libs, paths):
        # ptxas's report: "Compiling entry function '<mangled>'" then
        # "Function properties" (stack, spills) and "Used N registers".
        name = None
        for line in _build.build_log(source).splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name and ("spill" in line or "registers" in line):
                print(f"  ptxas {name}: {line.strip()}")
        if cuobjdump.is_file():
            sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                                  capture_output=True, text=True, timeout=120,
                                  check=True).stdout
            dmma = sum(1 for line in sass.splitlines() if "DMMA" in line)
            print(f"  {path.name}: {dmma} DMMA instructions in the SASS")
            check(dmma > 0 or not tile, f"{path.name}: the float64 path has no DMMA")
        else:
            print(f"  {path.name}: no cuobjdump beside nvcc; SASS not read")
    # K2-batched's shared tier: matrices (CTAs) one SM holds at once at
    # order 128, against what its launch bounds ask for.
    occupancy = {}
    for dname in ("float32", "float64"):
        occupancy[dname] = k2.occupancy(getattr(torch, dname), k2.MAX_N)
        print(f"  K2-batched shared tier, {dname}, n = {k2.MAX_N}: {occupancy[dname]} CTAs "
              f"(matrices) per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor; launch "
              f"bounds {k2.CTAS_PER_SM[dname]}, {k2.WARPS[dname]} warps a CTA)")
        check(occupancy[dname] >= k2.CTAS_PER_SM[dname],
              f"K2-batched {dname}: {occupancy[dname]} matrices per SM, want "
              f"{k2.CTAS_PER_SM[dname]}")
    return occupancy


def bound_ms(flops, nbytes, dname):
    """Least time for the work on the card, and what sets it: the H100's
    published peaks (madqp_tpu_torch/utils/roofline.py's H100: 67 TFLOP/s
    float32 on the CUDA cores and float64 on the FP64 tensor cores, 3.35
    TB/s)."""
    from madqp_tpu_torch.utils import roofline

    return roofline.bound_ms(flops, nbytes, dname, roofline.H100)


def chol_bound_ms(batch, n, element_size, dname):
    """Bound of `batch` Cholesky factors of order n (`roofline.factor_ops`,
    `roofline.cholesky_bytes`)."""
    from madqp_tpu_torch.utils import roofline

    return bound_ms(roofline.factor_ops(batch, n),
                    roofline.cholesky_bytes(batch, n, element_size), dname)


def spd_matrix(torch, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, n))
    A = P @ P.T / n + np.eye(n)
    return torch.as_tensor(A, dtype=dtype, device="cuda")


def factor_ok(torch, L):
    d = torch.diagonal(L)
    return bool((torch.isfinite(d) & (d > 0)).all())


def cuda_median_ms(torch, fn, runs=TIMING_RUNS, burst=BURST):
    """Median over `runs` samples of the device time per call, each sample
    a burst of back-to-back calls between two CUDA events.  The stream
    first spins for about a millisecond (torch.cuda._sleep), which the host
    uses to queue the whole burst, so a call whose device work is shorter
    than the host's time to issue it is timed on the device and not at the
    host's pace (a call longer than that is timed at the host's pace, as
    the plain versions are)."""
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def plain_errors(torch, k1, A, L, route, worst):
    """L (the kernel's factor of A, one matrix or a stack) against the
    plain version of its route and against the 64-column one: returns the
    largest max|L - P| of the route's and the largest max|L - P| / max|P|
    per matrix of each, and keeps the largest of each relative error by
    (route, dtype) in `worst`."""
    Lp = k1.ROUTE_REFERENCE[route](A)
    L64 = k1.cholesky_lower_reference(A)
    torch.cuda.synchronize()
    rels = []
    for P in (Lp, L64):
        diff = (L - P).abs()
        rels.append(float((diff.amax(dim=(-2, -1)) / P.abs().amax(dim=(-2, -1))).max()))
    key = (route, str(A.dtype).split(".")[-1])
    worst[key] = [max(w, r) for w, r in zip(worst.get(key, (0.0, 0.0)), rels)]
    return float((L - Lp).abs().max()), rels[0], rels[1]


def print_worst(k1, worst):
    for (route, dname), (rel, rel64) in sorted(worst.items()):
        print(f"  worst {dname} route={route}: rel_err={rel:.3e} against its own plain "
              f"version (tol {k1.ROUTE_TOL[route][dname]:g}), {rel64:.3e} against the "
              f"64-column one (tol {TOL_FACTOR[dname]:g})")


def kernel_phase(torch, k1):
    phase("3. K1 against plain version")
    main_err, timings, worst = 0.0, {}, {}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for n in SIZES:
            A = spd_matrix(torch, n, dtype, seed=n)
            L = k1.cholesky_lower(A)
            abs_err, rel, rel64 = plain_errors(torch, k1, A, L, "single", worst)
            A64, L64 = A.double(), L.double()
            resid = float(torch.linalg.norm(L64 @ L64.T - A64) / torch.linalg.norm(A64))
            upper_zero = bool((torch.triu(L, 1) == 0).all())
            # Non-SPD input: a negative diagonal entry midway.
            B = A.clone()
            B[n // 2, n // 2] = -1.0
            Lb = k1.cholesky_lower(B)
            nan_same = all(bool(torch.equal(torch.isnan(torch.diagonal(Lb)),
                                            torch.isnan(torch.diagonal(plain(B)))))
                           for plain in (k1.ROUTE_REFERENCE["single"],
                                         k1.cholesky_lower_reference))
            bad_ok = (factor_ok(torch, Lb), factor_ok(torch, k1.ROUTE_REFERENCE["single"](B)))
            same = (bool(torch.equal(L, k1.cholesky_lower(A)))
                    if n in DETERMINISM_SIZES else True)
            print(f"{dname} n={n}: rel_err={rel:.3e} (tol {k1.ROUTE_TOL['single'][dname]:g}) "
                  f"rel_err_64={rel64:.3e} (tol {TOL_FACTOR[dname]:g}) "
                  f"max_abs_err={abs_err:.3e} resid={resid:.3e} "
                  f"non-SPD factor_ok kernel/plain={bad_ok} nan_diag_same={nan_same}"
                  + (f" rerun_bit_equal={same}" if n in DETERMINISM_SIZES else ""))
            check(same, f"{dname} n={n}: two runs differ")
            check(rel <= k1.ROUTE_TOL["single"][dname],
                  f"{dname} n={n}: kernel differs from its route's plain version")
            check(rel64 <= TOL_FACTOR[dname], f"{dname} n={n}: kernel differs from plain")
            check(resid <= TOL_RESIDUAL[dname], f"{dname} n={n}: residual {resid:.3e}")
            check(upper_zero, f"{dname} n={n}: strict upper triangle not zero")
            check(bad_ok == (False, False) and nan_same,
                  f"{dname} n={n}: non-SPD contract broken")
            if dname == "float32" and n in MAIN_SHAPES:
                main_err = max(main_err, abs_err)
            if n in TIMED_SIZES:
                t = {
                    "kernel": cuda_median_ms(torch, lambda: k1.cholesky_lower(A)),
                    # the route's plain version, a Python loop over columns:
                    # fewer samples
                    "plain": cuda_median_ms(
                        torch, lambda: k1.ROUTE_REFERENCE["single"](A), runs=5, burst=1),
                    "torch.linalg.cholesky": cuda_median_ms(
                        torch, lambda: torch.linalg.cholesky(A)),
                }
                t["bound"], t["bound_by"] = chol_bound_ms(1, n, A.element_size(), dname)
                timings[(dname, n)] = t
                print(f"  time {dname} n={n} (median of {TIMING_RUNS} bursts of {BURST}, ms): "
                      + ", ".join(f"{k}={v:.4f}" for k, v in t.items()
                                  if k != "bound_by") + f" ({t['bound_by']}); "
                      f"kernel/library {t['kernel'] / t['torch.linalg.cholesky']:.2f}")
    print_worst(k1, worst)
    return main_err, timings


def reset_counts(k1, k8):
    """Set every kernel's launch counter to 0 (just before a solve phase)."""
    from madqp_tpu_torch.ops import ldl_batched

    k1.cholesky_lower.launches = 0
    k1.cholesky_lower.routes.clear()
    k8.syrk_update.launches = 0
    ldl_batched.ldl_lower_batched.launches = 0


def solve_checked(mt, qp, want, entry="solve", iter_slack=0, **options):
    """Solve on the card, check status / iterations / objective against the
    JAX reference, and return the stats."""
    t0 = time.perf_counter()
    st = getattr(mt, entry)(qp, device="cuda",
                            step_rule=mt.AdaptiveStep(0.995),
                            regularization=mt.FixedRegularization(1e-8, -1e-8),
                            **SOLVE_OPTIONS, **options)
    secs = time.perf_counter() - t0
    rel = abs(st.objective - want["objective"]) / abs(want["objective"])
    print(f"{qp.name} [{entry} {options}]: status={st.status.name} "
          f"iter={st.iter} (ref {want['iter']}) objective={st.objective!r} "
          f"rel={rel:.2e} factorizations={st.counters.factorizations} "
          f"solve_s={secs:.3f} iter/s={st.iter / secs:.2f}")
    check(int(st.status) == want["status"], f"{qp.name}: status {st.status.name}")
    check(abs(st.iter - want["iter"]) <= iter_slack,
          f"{qp.name}: {st.iter} iterations, reference {want['iter']}")
    check(rel <= 1e-8, f"{qp.name}: objective off by {rel:.2e}")
    return st


def main_path_phase(mt, k1, k8, ref):
    phase("4. main path: random_qp(500, 200), linear_solver='pallas'")
    reset_counts(k1, k8)
    fact = 0
    for seed in range(4):
        before = k1.cholesky_lower.launches
        st = solve_checked(mt, mt.random_qp(500, 200, seed=seed, ineq=True),
                           ref["n500"][str(seed)], linear_solver="pallas")
        n = k1.cholesky_lower.launches - before
        print(f"  K1 launches {n} for {st.counters.factorizations} factorizations")
        check(n >= 2 * st.counters.factorizations > 0, f"K1 launched {n} times")
        fact += st.counters.factorizations
    launches = k1.cholesky_lower.launches
    check(launches > 0, "main path never launched K1")
    check(k8.syrk_update.launches == 0, "the pallas path launched K8")
    reset_counts(k1, k8)
    solve_checked(mt, mt.random_qp(500, 200, seed=0, ineq=True),
                  ref["n500"]["0"], linear_solver="dense")
    check(k1.cholesky_lower.launches == 0, "dense solve launched K1")
    return launches, fact


def large_phase(mt, k1, ref):
    phase("5. large: random_qp(2000, 1000), linear_solver='pallas'")
    before = k1.cholesky_lower.launches
    st = solve_checked(mt, mt.random_qp(2000, 1000, seed=0), ref["n2000"],
                       linear_solver="pallas")
    n = k1.cholesky_lower.launches - before
    check(n >= 2 * st.counters.factorizations > 0, f"K1 launched {n} times")


def random_syrk(torch, r, c, k, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = torch.randn((r, c), generator=g, dtype=dtype, device="cuda")
    B = torch.randn((r, k), generator=g, dtype=dtype, device="cuda")
    return C, B / max(k, 1) ** 0.5


def syrk_in_place(torch, k8, C, B, dname):
    """The update as panel_chol makes it: C and B views of larger matrices
    (offset by 64 rows and columns, other row strides), out=C.  Returns the
    relative error against the plain version and whether the parent matrix
    outside the block kept its bits."""
    r, c = C.shape
    k = B.shape[1]
    S = torch.zeros((r + 64, c + 64 + 7), dtype=C.dtype, device="cuda")
    S.normal_(generator=torch.Generator(device="cuda").manual_seed(r + c))
    Z = torch.zeros((r + 64, k + 3), dtype=C.dtype, device="cuda")
    Cv, Bv = S[64:, 64:64 + c], Z[64:, 1:k + 1]
    Cv.copy_(C)
    Bv.copy_(B)
    S0 = S.clone()
    plain = k8.syrk_update_reference(C, B)
    k8.syrk_update(Cv, Bv, out=Cv)
    torch.cuda.synchronize()
    rel = float((Cv - plain).abs().max()) / float(plain.abs().max())
    S0[64:, 64:64 + c] = Cv
    return rel, bool(torch.equal(S, S0))


def syrk_phase(torch, k8, normal_m):
    """K8 at SYRK_SHAPES, one blocked-cell trial, and every launch shape
    of the panel Cholesky of phase 15's largest S (order normal_m)."""
    from madqp_tpu_torch.ops.blocked_dense import panel_update_shapes
    from madqp_tpu_torch.utils import roofline

    phase("6. K8 against plain version")
    path_err, timings = 0.0, {}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for i, (r, c, k) in enumerate(SYRK_SHAPES):
            C, B = random_syrk(torch, r, c, k, dtype, seed=i)
            out = k8.syrk_update(C, B)
            plain = k8.syrk_update_reference(C, B)
            torch.cuda.synchronize()
            abs_err = float((out - plain).abs().max())
            rel = abs_err / float(plain.abs().max())
            same = bool(torch.equal(out, k8.syrk_update(C, B)))
            rel_ip, rest_kept = syrk_in_place(torch, k8, C, B, dname)
            # NaN planted in one row of B: that row and column of the
            # output, and nothing else, in both.
            row = r // 2
            Bn = B.clone()
            Bn[row, k // 2] = float("nan")
            nan_k = torch.isnan(k8.syrk_update(C, Bn))
            nan_p = torch.isnan(k8.syrk_update_reference(C, Bn))
            nan_ok = (bool(torch.equal(nan_k, nan_p)) and bool(nan_k[row].all())
                      and (row >= c or bool(nan_k[:, row].all()))
                      and int(nan_k.sum()) == c + (r - 1 if row < c else 0))
            print(f"{dname} (r, c, k)=({r}, {c}, {k}): rel_err={rel:.3e} "
                  f"in_place_rel_err={rel_ip:.3e} (tol {SYRK_TOL[dname]:g}) "
                  f"max_abs_err={abs_err:.3e} rerun_bit_equal={same} "
                  f"rest_of_parent_kept={rest_kept} nan_contract={nan_ok}")
            check(rel <= SYRK_TOL[dname], f"K8 {dname} {(r, c, k)} differs from plain")
            check(rel_ip <= SYRK_TOL[dname],
                  f"K8 {dname} {(r, c, k)} in place differs from plain")
            check(same and rest_kept, f"K8 {dname} {(r, c, k)}: rerun or parent")
            check(nan_ok, f"K8 {dname} {(r, c, k)}: NaN contract broken")
            if dname == "float32" and (r, c, k) in SYRK_TIMED:
                path_err = max(path_err, abs_err)
            if (r, c, k) in SYRK_TIMED:
                timings[(dname, (r, c, k))] = time_syrk(torch, k8, C, B, dname)
        # One factorization trial of the blocked cell: the kernel's time
        # summed over its launches, against the bound of the work needed.
        shapes = panel_update_shapes(4096) + panel_update_shapes(1024)
        each = {}
        for j, shape in enumerate(sorted(set(shapes))):
            C, B = random_syrk(torch, *shape, dtype, seed=100 + j)
            O = torch.empty_like(C)
            each[shape] = cuda_median_ms(torch, lambda: k8.syrk_update(C, B, out=O))
        trial = sum(each[shape] for shape in shapes)
        need = sum(roofline.syrk_ops(*shape) for shape in shapes)
        issued = sum(k8.syrk_tile_ops(*shape) for shape in shapes)
        bound, by = bound_ms(need, 0.0, dname)
        print(f"  {dname} one factorization trial ({len(shapes)} launches): "
              f"kernel {trial:.4f} ms summed over medians, bound {bound:.4f} ms "
              f"({by}); {need / 1e9:.2f} GFLOP needed, {issued / 1e9:.2f} "
              f"GFLOP issued by the tiles, {need / trial / 1e9:.2f} TFLOP/s")
        timings[(dname, "trial")] = {"kernel": trial, "bound": bound}
        # The dense-normal sparse LP (phase 15): each launch of one panel
        # Cholesky of its largest normal matrix.
        shapes = panel_update_shapes(normal_m)
        print(f"  {dname} dense-normal path, S of order {normal_m}: "
              f"{len(shapes)} K8 launches per factorization")
        sums = collections.Counter()
        for j, shape in enumerate(shapes):
            C, B = random_syrk(torch, *shape, dtype, seed=200 + j)
            out = k8.syrk_update(C, B)
            plain = k8.syrk_update_reference(C, B)
            torch.cuda.synchronize()
            rel = float((out - plain).abs().max()) / float(plain.abs().max())
            check(rel <= SYRK_TOL[dname],
                  f"K8 {dname} {shape} (dense-normal) differs from plain: {rel:.3e}")
            t = time_syrk(torch, k8, C, B, dname)
            print(f"    rel_err={rel:.3e} (tol {SYRK_TOL[dname]:g})")
            for key in ("kernel", "plain", "torch.addmm", "bound"):
                sums[key] += t[key]
        print(f"  {dname} one dense-normal factorization of order {normal_m}, K8 "
              "summed over its launches (ms): "
              + ", ".join(f"{k}={v:.4f}" for k, v in sums.items()))
        timings[(dname, "normal")] = dict(sums)
    return path_err, timings


def time_syrk(torch, k8, C, B, dname):
    """Median ms of the kernel (into a preallocated out, so the inputs stay
    the same), the plain version and torch.addmm, and the bound."""
    from madqp_tpu_torch.utils import roofline

    r, c = C.shape
    k = B.shape[1]
    O = torch.empty_like(C)
    Bc = B[:c].T
    t = {
        "kernel": cuda_median_ms(torch, lambda: k8.syrk_update(C, B, out=O)),
        "plain": cuda_median_ms(torch, lambda: k8.syrk_update_reference(C, B)),
        "torch.addmm": cuda_median_ms(
            torch, lambda: torch.addmm(C, B, Bc, beta=1, alpha=-1)),
    }
    ops = roofline.syrk_ops(r, c, k)
    t["bound"], t["bound_by"] = bound_ms(
        ops, roofline.syrk_bytes(r, c, k, C.element_size()), dname)
    print(f"  time {dname} {(r, c, k)} (median of {TIMING_RUNS} bursts of {BURST}, ms): "
          + ", ".join(f"{key}={v:.4f}" for key, v in t.items() if key != "bound_by")
          + f" ({t['bound_by']}); {ops / 1e9:.3f} GFLOP needed, kernel "
            f"{ops / t['kernel'] / 1e9:.2f} TFLOP/s of them, "
            f"kernel/addmm {t['kernel'] / t['torch.addmm']:.2f}")
    return t


def blocked_phase(torch, mt, k1, k8, ref):
    from madqp_tpu_torch.ops.blocked_dense import panel_update_shapes
    from madqp_tpu_torch.utils import roofline
    from madqp_tpu_torch.solver.driver import bucket_shape

    phase("7. blocked main path: autosolve(random_qp(2000, 1000))")
    qp = mt.random_qp(2000, 1000, seed=0)
    reset_counts(k1, k8)
    st = solve_checked(mt, qp, ref["autosolve_n2000"], entry="autosolve",
                       iter_slack=1)
    launches = k8.syrk_update.launches
    fact = st.counters.factorizations
    # The orders the bucketed path factors: the standard form's sizes
    # through the bucket rule.
    info = mt.build_standard_form_sparse(qp)[1]
    n_tot, m_tot = bucket_shape(info.n, info.m)
    shapes = panel_update_shapes(n_tot) + panel_update_shapes(m_tot)
    need = sum(roofline.syrk_ops(*shape) for shape in shapes)
    issued = sum(k8.syrk_tile_ops(*shape) for shape in shapes)
    bound, by = bound_ms(need, 0.0, "float32")
    print(f"  bucketed W {n_tot}^2, S {m_tot}^2: K8 launches {launches} "
          f"for {fact} factorization trials ({len(shapes)} per trial expected; "
          f"per trial {need / 1e9:.2f} GFLOP of trailing update needed, "
          f"{issued / 1e9:.2f} GFLOP issued by the tiles, float32 "
          f"bound {bound:.4f} ms ({by})); K1 launches {k1.cholesky_lower.launches}")
    check(launches >= 12 * fact > 0, f"K8 launched {launches} times")
    check(launches == len(shapes) * fact, "K8 launch count off the panel structure")
    check(len(shapes) == 18, f"{len(shapes)} K8 launches per trial, not 18")
    check(k1.cholesky_lower.launches == 0, "the blocked path launched K1")
    n2 = k2_launches()
    print(f"  K2-batched launches {n2} (a float64 trial's blocked_ldl below order 1024)")
    return launches, fact, n2


def k2_launches():
    from madqp_tpu_torch.ops import ldl_batched

    return ldl_batched.ldl_lower_batched.launches


def variants_phase(mt, k1, k8, ref):
    """Phase 8; returns the K2-batched launches (the card's blocked_ldl:
    one per 128-wide diagonal block of each signed factorization)."""
    phase("8. dense KKT variants: random_qp(500, 200, seed=0)")
    launches = 0
    for name, want in ref["n500_variants"].items():
        reset_counts(k1, k8)
        solve_checked(mt, mt.random_qp(500, 200, seed=0, ineq=True), want,
                      iter_slack=1, **want["options"])
        check(k8.syrk_update.launches == 0, f"the n = 500 variant {name} launched K8")
        print(f"  {name}: K2-batched launches {k2_launches()}")
        if name == "k2.5-blocked":   # K (800, 800): 7 blocks of 128 per trial
            check(k2_launches() > 0 and k2_launches() % 7 == 0,
                  f"k2.5-blocked: {k2_launches()} K2-batched launches")
        launches += k2_launches()
    return launches


def spd_stack(torch, batch, n, dtype, seed):
    """P P^T / n + I from a seed: with NumPy, as the card tests make it, up
    to 64M entries; above (the published widths, where NumPy would take
    tens of seconds) from the card's generator, symmetrized exactly."""
    if batch * n * n <= 1 << 26:
        rng = np.random.default_rng(seed)
        P = rng.standard_normal((batch, n, n))
        A = P @ P.transpose(0, 2, 1) / max(n, 1) + np.eye(n)
        return torch.as_tensor(A, dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P = torch.randn(batch, n, n, generator=gen, device="cuda", dtype=torch.float64)
    A = P @ P.mT / n
    A = 0.5 * (A + A.mT) + torch.eye(n, dtype=torch.float64, device="cuda")
    return A.to(dtype)


def batched_kernel_phase(torch, k1):
    phase("9. batched K1 against plain version")
    main_err, lanes_err, timings, worst = 0.0, 0.0, {}, {}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        n_max = k1.batched_max_n(dtype, "cuda")
        print(f"{dname}: one CTA holds n <= {n_max} (the card's opt-in shared memory)")
        for batch, n in BATCHED_SHAPES:
            if not isinstance(n, int):
                n = n_max + (n == "max+1")
            route = k1.batched_route(n, n_max)
            A = spd_stack(torch, batch, n, dtype, seed=n)
            before = dict(k1.cholesky_lower.routes)
            L = k1.cholesky_lower(A)
            launched = {r: c - before.get(r, 0) for r, c in k1.cholesky_lower.routes.items()
                        if c != before.get(r, 0)}
            abs_err, rel, rel64 = plain_errors(torch, k1, A, L, route, worst)
            A64, L64 = A.double(), L.double()
            resid = float((torch.linalg.norm(L64 @ L64.mT - A64, dim=(1, 2))
                           / torch.linalg.norm(A64, dim=(1, 2))).max())
            upper_zero = bool((torch.triu(L, 1) == 0).all())
            same = bool(torch.equal(L, k1.cholesky_lower(A)))
            # One non-SPD matrix (a negative diagonal entry midway): NaN on
            # its own diagonal, at the plain version's places; the other
            # factors keep their bits.
            bad = batch // 2
            B = A.clone()
            B[bad, n // 2, n // 2] = -1.0
            Lb = k1.cholesky_lower(B)
            d = torch.diagonal(Lb, dim1=1, dim2=2)
            lanes_ok = torch.arange(batch, device="cuda") != bad
            contract = (bool(torch.equal((torch.isfinite(d) & (d > 0)).all(1), lanes_ok))
                        and bool(torch.equal(Lb[lanes_ok], L[lanes_ok])))
            for plain in (k1.ROUTE_REFERENCE[route], k1.cholesky_lower_reference):
                dp = torch.diagonal(plain(B), dim1=1, dim2=2)
                contract = (contract and bool(torch.equal(torch.isnan(d), torch.isnan(dp)))
                            and bool(torch.equal((torch.isfinite(dp) & (dp > 0)).all(1),
                                                 lanes_ok)))
            # On the persistent route each lane is the 2-D call on its matrix.
            one = (all(bool(torch.equal(L[i], k1.cholesky_lower(A[i].contiguous())))
                       for i in range(batch))
                   if route == "persistent" else True)
            print(f"{dname} (B, n)=({batch}, {n}) route={route}: rel_err={rel:.3e} (tol "
                  f"{k1.ROUTE_TOL[route][dname]:g}) rel_err_64={rel64:.3e} (tol "
                  f"{TOL_FACTOR[dname]:g}) max_abs_err={abs_err:.3e} resid={resid:.3e} "
                  f"launches={launched} rerun_bit_equal={same} one_bad_lane_contract={contract}"
                  + (f" lanes_equal_2d={one}" if route == "persistent" else ""))
            check(launched == {route: 1},
                  f"{dname} {(batch, n)}: launches {launched}, not one on {route}")
            check(same, f"{dname} {(batch, n)}: two runs differ")
            check(rel <= k1.ROUTE_TOL[route][dname],
                  f"{dname} {(batch, n)}: kernel differs from its route's plain version")
            check(rel64 <= TOL_FACTOR[dname], f"{dname} {(batch, n)}: kernel differs from plain")
            check(resid <= TOL_RESIDUAL[dname], f"{dname} {(batch, n)}: residual {resid:.3e}")
            check(upper_zero, f"{dname} {(batch, n)}: strict upper triangle not zero")
            check(contract, f"{dname} {(batch, n)}: per-lane non-SPD contract broken")
            check(one, f"{dname} {(batch, n)}: a lane differs from the 2-D call")
            if dname == "float32" and (batch, n) in ((512, 42), (512, 16)):
                main_err = max(main_err, abs_err)
            if dname == "float32" and (batch, n) == (4, 600):
                lanes_err = abs_err
            if (batch, n) in BATCHED_TIMED:
                t = {
                    "kernel": cuda_median_ms(torch, lambda: k1.cholesky_lower(A)),
                    # the route's plain version, a Python loop over columns:
                    # fewer samples
                    "plain": cuda_median_ms(
                        torch, lambda: k1.ROUTE_REFERENCE[route](A), runs=5, burst=1),
                    "torch.linalg.cholesky_ex": cuda_median_ms(
                        torch, lambda: torch.linalg.cholesky_ex(A)),
                }
                t["bound"], t["bound_by"] = chol_bound_ms(
                    batch, n, A.element_size(), dname)
                timings[(dname, (batch, n))] = t
                print(f"  time {dname} (B, n)=({batch}, {n}) route={route} (median of "
                      f"{TIMING_RUNS} bursts of {BURST}, ms): "
                      + ", ".join(f"{k}={v:.4f}" for k, v in t.items() if k != "bound_by")
                      + f" ({t['bound_by']}); kernel/library "
                      f"{t['kernel'] / t['torch.linalg.cholesky_ex']:.2f}, "
                      f"kernel/bound {t['kernel'] / t['bound']:.1f}")
    print_worst(k1, worst)
    return main_err, lanes_err, timings


def check_lanes(stats, want, label, iter_slack=1):
    """Each lane's status, iterations (within iter_slack: a float32 phase
    may hand over an iteration apart) and objective (1e-8 relative)
    against the reference's per-lane lists."""
    moved = 0
    for i, st in enumerate(stats):
        rel = abs(st.objective - want["objective"][i]) / max(abs(want["objective"][i]), 1.0)
        check(int(st.status) == want["status"][i], f"{label} lane {i}: {st.status.name}")
        check(abs(st.iter - want["iter"][i]) <= iter_slack,
              f"{label} lane {i}: {st.iter} iterations, reference {want['iter'][i]}")
        check(rel <= 1e-8, f"{label} lane {i}: objective off by {rel:.2e}")
        moved += st.iter != want["iter"][i]
    print(f"  {label}: {len(stats)} lanes match the reference; {moved} lanes "
          f"an iteration apart; iterations {min(s.iter for s in stats)}-"
          f"{max(s.iter for s in stats)}")


def batched_path_phase(torch, mt, k1, k8, ref, unsharded):
    """Phase 10; keeps the pallas run's stats and K1 routes in
    unsharded["batched512"] (phase 20 repeats it on a mesh)."""
    phase(f"10. batched: solve_batched on {BATCH} x dense_dummy_qp(32, 16)")
    qps = [mt.dense_dummy_qp(32, 16, seed=i) for i in range(BATCH)]
    options = dict(BATCHED_OPTIONS, step_rule=mt.AdaptiveStep(0.995),
                   regularization=mt.FixedRegularization(1e-8, -1e-8))
    launches = None
    for backend in ("pallas", "dense"):
        solver = mt.BatchedMPCSolver.from_problems(qps, device="cuda",
                                                   linear_solver=backend, **options)
        reset_counts(k1, k8)
        t0 = time.perf_counter()
        stats = solver.solve_all()
        first = time.perf_counter() - t0
        n = k1.cholesky_lower.launches
        routes = dict(k1.cholesky_lower.routes)
        check(k8.syrk_update.launches == 0, f"batched {backend} launched K8")
        check_lanes(stats, ref["batched512"], f"batched512 {backend}")
        t0 = time.perf_counter()
        solver.solve_batch()
        warm = time.perf_counter() - t0
        top = max(st.iter for st in stats)
        print(f"  {backend}: K1 launches {n} by route {routes} (lanes up to {top} "
              f"iterations; two per factorization trial of the batch); first solve "
              f"{first:.3f} s, warm solve {warm:.3f} s: {BATCH / warm:.1f} instances/s")
        if backend == "pallas":
            unsharded["batched512"] = (stats, routes)
            check(n % 2 == 0 and n >= 2 * (top + 1), f"batched K1 launched {n} times")
            check(routes == {"warp64": n // 2, "warp16": n // 2},
                  f"batched K1 routes {routes}: W (n = 42) and S (n = 16) once per trial")
            launches = n
        else:
            check(n == 0, "the dense batched solve launched K1")

    # The n = 500 headline QPs as one batch: W 600^2 is above the one-CTA
    # limit, so K1 runs the persistent kernel with a lane axis; S 200^2
    # one CTA per matrix.  One launch each per factorization trial.
    reset_counts(k1, k8)
    stats = mt.solve_batched(
        [mt.random_qp(500, 200, seed=s, ineq=True) for s in range(4)], device="cuda",
        step_rule=mt.AdaptiveStep(0.995),
        regularization=mt.FixedRegularization(1e-8, -1e-8),
        linear_solver="pallas", **SOLVE_OPTIONS)
    want = {key: [ref["n500"][str(s)][key] for s in range(4)]
            for key in ("status", "iter", "objective")}
    check_lanes(stats, want, "n500 x 4 pallas")
    routes = dict(k1.cholesky_lower.routes)
    trials = routes.get("persistent", 0)
    top = max(st.iter for st in stats)
    print(f"  K1 launches {k1.cholesky_lower.launches} by route {routes}: {trials} "
          f"factorization trials, two launches each (iterations {[st.iter for st in stats]})")
    check(trials >= top + 1, f"the n = 500 batch ran {trials} trials on W")
    check(routes == {"persistent": trials, "cta": trials},
          f"the n = 500 batch: routes {routes}, not one W and one S launch per trial")
    return launches, trials


def layer_problem(seed, n=LAYER["n"], m=LAYER["m"]):
    """One strictly convex QP of phase 11, from `seed` with NumPy: H SPD, b
    feasible, a box around a feasible point (some bounds end up active)."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    H = M @ M.T + n * np.eye(n)
    c = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    x_feas = rng.normal(size=n)
    b = A @ x_feas
    lb = x_feas - rng.uniform(0.05, 2.0, size=n)
    ub = x_feas + rng.uniform(0.05, 2.0, size=n)
    return H, c, A, b, lb, ub


def layer_weights(n=LAYER["n"]):
    """The loss of phase 11 is sum(w * x^2) + 0.1 * sum(y)."""
    return np.linspace(0.5, 1.5, n)


def layer_phase(torch, mt, k1, k8, ref):
    phase(f"11. qp_layer: {LAYER['lanes']} random QPs (n = {LAYER['n']}), float64")
    want = ref["qp_layer64"]
    data = [layer_problem(seed) for seed in range(LAYER["lanes"])]
    stacked = [torch.tensor(np.stack([d[j] for d in data]), device="cuda",
                            requires_grad=True) for j in range(6)]
    w = torch.as_tensor(layer_weights(), device="cuda")
    for backend in ("pallas", "dense"):
        reset_counts(k1, k8)
        t0 = time.perf_counter()
        sol = mt.qp_layer(*stacked, tol=LAYER["tol"], print_level=40,
                          linear_solver=backend)
        loss = (w * sol.x ** 2).sum() + 0.1 * sol.y.sum()
        grads = torch.autograd.grad(loss, stacked)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(bool((sol.status == 1).all()), f"qp_layer {backend}: a lane unsolved")
        worst = 0.0
        for lane, rec in want["lanes"].items():
            i = int(lane)
            check(int(sol.iters[i]) == rec["iter"],
                  f"qp_layer {backend} lane {i}: {int(sol.iters[i])} iterations, "
                  f"reference {rec['iter']}")
            for g, name in zip(grads, ("H", "c", "A", "b", "lb", "ub")):
                ref_g = torch.as_tensor(rec["grads"][name], dtype=torch.float64,
                                        device="cuda")
                rel = float((g[i] - ref_g).abs().max() / ref_g.abs().max())
                worst = max(worst, rel)
                check(rel <= 1e-7, f"qp_layer {backend} lane {i}: grad {name} off by {rel:.2e}")
        print(f"  {backend}: forward + backward {secs:.3f} s, iterations "
              f"{int(sol.iters.min())}-{int(sol.iters.max())}, K1 launches "
              f"{k1.cholesky_lower.launches}, worst gradient error {worst:.2e} "
              f"(tol 1e-7) over lanes {sorted(int(k) for k in want['lanes'])}")
        check((k1.cholesky_lower.launches > 0) == (backend == "pallas"),
              f"qp_layer {backend}: K1 launches {k1.cholesky_lower.launches}")


def two_stage_phase(torch, mt, k1, k8, ref, unsharded):
    """Phase 12: solve_two_stage on the reference's two-stage problem under
    each of its option sets; returns the K1 launches of its pallas solves
    by source (the persistent kernel's, the batched kernels') and keeps the
    float64 pallas run's stats and K1 routes in unsharded["two_stage"]."""
    entry = ref["two_stage_1024"]
    spec = entry["problem"]
    phase(f"12. two-stage: solve_two_stage on random_two_stage({spec})")
    t0 = time.perf_counter()
    prob, lb, ub = mt.random_two_stage(**spec, device="cuda")
    print(f"  n = {prob.n}, m = {prob.m}: U ({prob.N}, {prob.ns}^2), S ({prob.N}, "
          f"{prob.ms}^2), C00 {prob.n0}^2, S0 {prob.m0}^2; built and uploaded in "
          f"{time.perf_counter() - t0:.3f} s")
    single = batched = 0
    for name, want in entry["solves"].items():
        options = want["options"]
        reset_counts(k1, k8)
        t0 = time.perf_counter()
        st = mt.solve_two_stage(prob, lb, ub, device="cuda", print_level=40, **options)
        wall = time.perf_counter() - t0
        routes = dict(k1.cholesky_lower.routes)
        trials = routes.get("cta", 0)
        fact = st.counters.factorizations
        rel = abs(st.objective - want["objective"]) / abs(want["objective"])
        x0_err = float(np.abs(st.solution[:prob.n0] - np.asarray(want["x0"])).max())
        norms = (np.linalg.norm(st.solution), np.linalg.norm(st.multipliers))
        norm_rel = max(abs(got - w) / w for got, w in zip(
            norms, (want["norm_x"], want["norm_y"])))
        print(f"  {name} {options}: status={st.status.name} iter={st.iter} (ref "
              f"{want['iter']}) objective={st.objective!r} rel={rel:.2e} "
              f"x0_err={x0_err:.2e} norm_rel={norm_rel:.2e} wall={wall:.3f} s "
              f"iter/s={st.iter / wall:.2f} factorizations={fact} K1 launches by "
              f"route {routes}")
        slack = 1 if options.get("factorization_dtype") else 0
        check(int(st.status) == want["status"], f"two-stage {name}: {st.status.name}")
        check(abs(st.iter - want["iter"]) <= slack,
              f"two-stage {name}: {st.iter} iterations, reference {want['iter']}")
        check(rel <= 1e-8, f"two-stage {name}: objective off by {rel:.2e}")
        check(x0_err <= 1e-7, f"two-stage {name}: x0 off by {x0_err:.2e}")
        check(norm_rel <= 1e-8, f"two-stage {name}: |x| or |y| off by {norm_rel:.2e}")
        check(k8.syrk_update.launches == 0, f"two-stage {name} launched K8")
        if name == "pallas":
            unsharded["two_stage"] = (st, routes)
        if options["linear_solver"] == "pallas":
            # Each factorization trial: U on the CTA tier, S on the warp
            # tier, C00 and S0 on the persistent kernel.
            check(routes == {"cta": trials, "warp64": trials, "single": 2 * trials}
                  and trials >= fact > 0,
                  f"two-stage {name}: K1 routes {routes} for {fact} factorizations")
            single += 2 * trials
            batched += 2 * trials
        else:
            check(k1.cholesky_lower.launches == 0, f"two-stage {name} launched K1")
    return single, batched


def pipeline_record_checks(rec, want, optimum, mixed):
    """The failures of one runner record against the reference's record
    `want` and its float64 objective `optimum`."""
    name = rec["name"]
    status = rec["status"]
    if isinstance(status, str):
        # an exception recorded by the runner never passes; a presolve
        # verdict only where the reference's record has the same one
        if status.startswith("error:") or status != want["status"]:
            return [f"{name}: record status {status!r}, reference {want['status']!r}"]
        return []
    fails = []
    if status != want["status"] or rec.get("status_detail") != want["status_detail"]:
        fails.append(f"{name}: {rec.get('status_detail')}, reference {want['status_detail']}")
    rel = abs(rec["objective"] - optimum) / max(abs(optimum), 1.0)
    if not rel <= (MIXED_RTOL if mixed else 1e-8):
        fails.append(f"{name}: objective off by {rel:.2e}")
    gap = rec["iter"] - want["iter"]
    if mixed and name.startswith(MIXED_ONE_SIDED):
        gap = max(gap, 0)
    if abs(gap) > (MIXED_ITER_BAND if mixed else 1):
        fails.append(f"{name}: {rec['iter']} iterations, reference {want['iter']}")
    return fails


def run_pipeline(k1, k8, runner, instances, args, ref, smi, label, orders=None,
                 optima=None):
    """Every instance through the suite runner's `run_instance` with the
    options of the runner's command line `args` (K1: `--linear-solver
    pallas`), against the reference's records `ref` and float64 objectives
    `optima` (default: the records' own); prints a line per instance and the
    totals, and returns (failures, K1 launches, records)."""
    options = runner.solve_options(runner.parser().parse_args(args))
    mixed = "--mixed-precision" in args
    fails, records = [], []
    reset_counts(k1, k8)
    t_all = time.perf_counter()
    iters = 0
    for name, qp in instances:
        before = k1.cholesky_lower.launches
        t0 = time.perf_counter()
        rec = runner.run_instance(name, qp, options)
        wall = time.perf_counter() - t0
        n = k1.cholesky_lower.launches - before
        want = ref[name]
        optimum = (optima or ref)[name]["objective"]
        fails += pipeline_record_checks(rec, want, optimum, mixed)
        if isinstance(rec["status"], int) and n < rec["iter"]:
            fails.append(f"{name}: {n} K1 launches in {rec['iter']} iterations")
        rel = (abs(rec["objective"] - optimum) / max(abs(optimum), 1.0)
               if isinstance(rec["status"], int) else float("nan"))
        shape = f" W {orders[name]['W']} S {orders[name]['S']}" if orders else ""
        iters += max(rec["iter"], 0)
        solve_s = rec["total_time"]
        rate = f"{rec['iter'] / solve_s:.2f}" if solve_s > 0 else "-"
        print(f"  {label} {name}{shape}: {rec.get('status_detail', rec['status'])} "
              f"iter={rec['iter']} (ref {want['iter']}) objective={rec['objective']!r} "
              f"rel={rel:.2e} wall={wall:.3f} s solve={solve_s:.3f} s "
              f"iter/s={rate} K1 launches {n}", flush=True)
        records.append(rec)
    total = time.perf_counter() - t_all
    routes = dict(k1.cholesky_lower.routes)
    launches = k1.cholesky_lower.launches
    print(f"  {label} total: {len(instances)} instances, {iters} iterations, wall "
          f"{total:.3f} s, solves {sum(max(r['total_time'], 0) for r in records):.3f} s, "
          f"{iters / total:.2f} iterations/s; K1 launches {launches} by route {routes} "
          f"({smi})")
    if launches == 0 or set(routes) != {"single"}:
        fails.append(f"{label}: K1 launches {launches} by route {routes}")
    if k8.syrk_update.launches:
        fails.append(f"{label}: launched K8")
    return fails, launches, records


def pipeline_phase(mt, k1, k8, ref, smi):
    """Phase 13: the structured suite's large tier (seed 0) written as MPS
    files and run through tools/run_suite_torch.py's run_instance (read ->
    presolve -> Ruiz scaling -> solve with K1 -> unscale), in float64 and
    with --mixed-precision; then the real_mm corpus through --dir in
    float64.  Returns the K1 launches of the phase."""
    import tempfile

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "tools"))
    import run_suite_torch as runner

    phase("13. pipeline: write_suite('large', seeds=(0,)) -> read_mps -> presolve "
          "-> scale -> solve (K1) -> unscale, and the real_mm corpus")
    large = ref["suite_large"]["instances"]
    fails, launches = [], 0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        mt.write_suite(d, size="large", seeds=(0,))
        instances = runner.read_dir(d)
        print(f"  {len(instances)} instances written and read back in "
              f"{time.perf_counter() - t0:.3f} s")
        check([nm for nm, _ in instances] == sorted(large),
              f"large tier: {[nm for nm, _ in instances]}")
        for label, args in (("f64", ["--linear-solver", "pallas"]),
                            ("mixed", ["--linear-solver", "pallas", "--mixed-precision"])):
            want = {nm: large[nm][label] for nm in large}
            f, n, _ = run_pipeline(k1, k8, runner, instances, args, want, smi,
                                   label, orders=large,
                                   optima={nm: large[nm]["f64"] for nm in large})
            fails += f
            launches += n
    corpus = runner.read_dir(str(root / "tests" / "data" / "real_mm"))
    check(sorted(nm for nm, _ in corpus) == sorted(ref["real_mm"]),
          f"corpus: {[nm for nm, _ in corpus]}")
    f, n, records = run_pipeline(k1, k8, runner, corpus, ["--linear-solver", "pallas"],
                                 ref["real_mm"], smi, "real_mm")
    fails += f
    launches += n
    for rec in records:
        opt = PUBLISHED[rec["name"]]
        if not abs(rec["objective"] - opt) <= max(1e-6, 1e-7 * abs(opt)):
            fails.append(f"{rec['name']}: objective {rec['objective']!r}, published {opt!r}")
    for msg in fails:
        print(f"  FAIL {msg}")
    check(not fails, f"pipeline: {len(fails)} failures")
    return launches


def runner_module():
    """tools/run_suite_torch.py of this checkout, imported."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import run_suite_torch

    return run_suite_torch


def cpu_model():
    """The host CPU's model and core count (the host path's seconds run on
    it): /proc/cpuinfo's model name, or its vendor, family and model
    numbers where a machine reports no name."""
    import os
    import platform

    fields = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    model = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model") if fields.get(k))
    return f"{model or platform.machine()}, {os.cpu_count()} cores"


def host_phase(torch, mt, k1, k8, ref, smi):
    """Phase 14: the host path, which launches no kernel: the native
    library, the corpus and the large tier through the runner's --backend
    host, the xlarge portfolio QP, and the batched-512 cell with the host
    rescue of endgame="auto"."""
    import tempfile

    from madqp_tpu_torch import native
    from madqp_tpu_torch.models import suite

    phase("14. host path: native sparse LDL, corpus and large tier through "
          "--backend host, portfolio xlarge, batched-512 with endgame='auto'")
    t0 = time.perf_counter()
    lib = native.build()
    check(native.available(), "the native library does not load")
    print(f"  {Path(lib).name} built and loaded in {time.perf_counter() - t0:.2f} s; "
          f"host CPU: {cpu_model()}")
    runner = runner_module()
    root = Path(__file__).resolve().parent
    fails = []
    reset_counts(k1, k8)
    options = runner.solve_options(runner.parser().parse_args(
        ["--backend", "host", "--tol", "1e-9"]))
    corpus = runner.read_dir(str(root / "tests" / "data" / "real_mm"))
    check("HS35_gz" in dict(corpus), "the gzip file of the corpus was not read")
    for name, qp in corpus:
        rec = runner.run_instance(name, qp, options)
        opt = PUBLISHED[name]
        ok = (rec["status"] == 1
              and abs(rec["objective"] - opt) <= max(1e-6, 1e-7 * abs(opt)))
        print(f"  corpus {name}: {rec.get('status_detail', rec['status'])} "
              f"iter={rec['iter']} objective={rec['objective']!r} published {opt!r} "
              f"solve={rec['total_time']:.3f} s")
        if not ok:
            fails.append(f"corpus {name}: {rec['status']} {rec['objective']!r}")
    want = ref["host_large"]
    options = runner.solve_options(runner.parser().parse_args(["--backend", "host"]))
    total, iters = 0.0, 0
    with tempfile.TemporaryDirectory() as d:
        mt.write_suite(d, size="large", seeds=(0,))
        instances = runner.read_dir(d)
    check(sorted(nm for nm, _ in instances) == sorted(want), "large tier names")
    for name, qp in instances:
        rec = runner.run_instance(name, qp, options)
        w = want[name]
        rel = (abs(rec["objective"] - w["objective"]) / max(abs(w["objective"]), 1.0)
               if isinstance(rec["status"], int) else float("nan"))
        total += max(rec["total_time"], 0.0)
        iters += max(rec["iter"], 0)
        print(f"  host {name}: {rec.get('status_detail', rec['status'])} iter={rec['iter']} "
              f"(ref {w['iter']}) rel={rel:.2e} solve={rec['total_time']:.3f} s "
              f"linear_solver={rec['linear_solver_time']}")
        if not (rec["status"] == w["status"] and rec.get("status_detail") == w["status_detail"]
                and rec["iter"] == w["iter"] and rel <= 1e-9):
            fails.append(f"host {name}: {rec.get('status_detail', rec['status'])} "
                         f"iter {rec['iter']} (ref {w['iter']}) rel {rel:.2e}")
    print(f"  host large tier: {len(instances)} instances, {iters} iterations, "
          f"{total:.3f} s of solves on {cpu_model()}")
    qp = suite._MAKERS["portfolio"](*suite._DIMS["portfolio"]["xlarge"], seed=0)
    qp_p, _, ok = mt.presolve_qp(qp)
    check(ok, "portfolio xlarge: presolve")
    qp_s, _ = mt.scale_qp(qp_p)
    t0 = time.perf_counter()
    st = mt.solve_host(qp_s, tol=1e-8, max_iter=300, max_ncorr=3,
                       step_rule=mt.AdaptiveStep(0.995),
                       regularization=mt.FixedRegularization(1e-8, -1e-8), print_level=40)
    print(f"  portfolio xlarge (n = {qp.nvar}): {st.status.name} iter={st.iter} "
          f"{time.perf_counter() - t0:.3f} s")
    if not (st.success and st.iter <= 40):
        fails.append(f"portfolio xlarge: {st.status.name} in {st.iter} iterations")
    check(k1.cholesky_lower.launches == 0 and k8.syrk_update.launches == 0,
          "the host path launched a kernel")
    # Phase 10's cell with the default endgame: the host re-solves the
    # lanes whose float32 phase fails.
    qps = [mt.dense_dummy_qp(32, 16, seed=i) for i in range(BATCH)]
    solver = mt.BatchedMPCSolver.from_problems(
        qps, device="cuda", linear_solver="pallas", step_rule=mt.AdaptiveStep(0.995),
        regularization=mt.FixedRegularization(1e-8, -1e-8),
        **dict(BATCHED_OPTIONS, endgame="auto"))
    t0 = time.perf_counter()
    stats = solver.solve_all()
    print(f"  batched512 endgame='auto': {len(solver._rescue_overrides)} lanes re-solved "
          f"on the host, {time.perf_counter() - t0:.3f} s")
    check_lanes(stats, ref["batched512"], "batched512 endgame='auto'")
    for msg in fails:
        print(f"  FAIL {msg}")
    check(not fails, f"host path: {len(fails)} failures")


def rel_err(got, want):
    return abs(got - want) / max(abs(want), 1.0)


def last_kkt():
    """The KKT of the latest sparse solve: the last entry touched in the
    pattern cache."""
    from madqp_tpu_torch.solver import sparse_common

    return next(reversed(sparse_common._KERNEL_CACHE.values()))[0]


def sparse_phase(torch, mt, k1, k8, ref, smi):
    """Phase 15: the xlarge tier's normal-equations members through the
    runner's --backend sparse-device on the card, in float64 and with the
    float32 phase and the host endgame; then the determinism of gridlp's
    assembly and factorization.  Returns the K8 and K2-batched launches of
    the phase (K2: the float64 blocked_ldl of a normal matrix below order
    1024)."""
    import tempfile

    from madqp_tpu_torch.io.mps_write import write_mps
    from madqp_tpu_torch.ops.blocked_dense import panel_update_shapes
    from madqp_tpu_torch.solver import sparse_qp

    phase("15. sparse LP on the card: the xlarge tier's normal-equations members, "
          "--backend sparse-device --sparse-kkt auto")
    runner = runner_module()
    want = ref["host_xlarge"]
    fails, launches, egs, matmul, ldl = [], 0, {}, set(), 0
    # What the dense-column member hands the host endgame (called from the
    # sparse drivers' shared tail, sparse_qp._solve_phases).
    orig_endgame = sparse_qp._host_endgame

    def spy(qp, opts, final, info, std, t0, kkt_system="k2"):
        egs["kkt"] = kkt_system
        return orig_endgame(qp, opts, final, info, std, t0, kkt_system=kkt_system)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for name, qp in mt.structured_suite("xlarge", seeds=(0,), families=XLARGE_NORMAL):
            write_mps(qp, str(Path(d) / f"{name}.{'qps' if qp.H is not None else 'mps'}"))
        instances = runner.read_dir(d)
    print(f"  {len(instances)} instances written and read back in "
          f"{time.perf_counter() - t0:.3f} s")
    check(sorted(nm for nm, _ in instances) == sorted(want), "xlarge member names")
    sparse_qp._host_endgame = spy
    try:
        for label, args in (("f64", []), ("mixed", ["--mixed-precision", "--endgame", "host"])):
            options = runner.solve_options(runner.parser().parse_args(
                ["--backend", "sparse-device", "--sparse-kkt", "auto"] + args))
            mixed = bool(args)
            for name, qp in instances:
                w = want[name]
                egs.clear()
                reset_counts(k1, k8)
                t0 = time.perf_counter()
                rec = runner.run_instance(name, qp, options)
                wall = time.perf_counter() - t0
                n8 = k8.syrk_update.launches
                launches += n8
                ldl += k2_launches()
                kkt = last_kkt()
                panel = kkt.m >= PANEL_MIN
                if kkt.assembly == "matmul":
                    matmul.add(name)
                per = len(panel_update_shapes(kkt.m)) if panel else 0
                if not isinstance(rec["status"], int):
                    fails.append(f"{label} {name}: record {rec['status']}")
                    continue
                dense = ref["sparse_xlarge"][name]
                rel = rel_err(rec["objective"], w["objective"])     # the host record
                rel_dense = rel_err(rec["objective"], dense[label]["objective"])
                gap = rec["iter"] - w["iter"]
                band = MIXED_ITER_BAND if name.startswith(MIXED_ONE_SIDED) else 1
                # the float64 bound: the reference's own dense-normal record
                # (1e-8); the float32 phase: the float64 host record, within
                # MIXED_RTOL or twice the reference's own mixed distance
                bound = (max(MIXED_RTOL, 2 * rel_err(dense["mixed"]["objective"],
                                                     w["objective"]))
                         if mixed else 1e-8)
                print(f"  {label} {name}: m={kkt.m} (ref {w['m']}) assembly={kkt.assembly} "
                      f"panel={panel} {rec.get('status_detail')} iter={rec['iter']} "
                      f"(host ref {w['iter']}, dense-normal ref {dense[label]['iter']}) "
                      f"rel={rel:.2e} to the host record, {rel_dense:.2e} to the "
                      f"dense-normal record (bound {bound:.1e}) K8 launches {n8} "
                      f"({per} per factorization) K2-batched {k2_launches()} "
                      f"solve={rec['total_time']:.3f} s "
                      f"endgame={rec.get('endgame_backend', '-')} "
                      f"{rec.get('endgame_time', 0.0):.3f} s wall={wall:.3f} s", flush=True)
                ok = (rec["status"] == 1 and kkt.m == w["m"]
                      and (rel if mixed else rel_dense) <= bound
                      and (mixed or abs(gap) <= band)
                      and k1.cholesky_lower.launches == 0
                      and (n8 > 0 and n8 % per == 0 if panel else n8 == 0))
                if mixed:
                    ok = ok and rec.get("endgame_backend") in ("host", "host-cold")
                    if kkt.assembly == "matmul":
                        ok = ok and egs.get("kkt") == "k2"
                    print(f"    endgame system: host {egs.get('kkt')}")
                elif panel:
                    ok = ok and n8 >= per * rec["iter"]
                if not ok:
                    fails.append(f"{label} {name}: {rec.get('status_detail')} iter "
                                 f"{rec['iter']} (ref {w['iter']}) rel {rel:.2e} K8 {n8} "
                                 f"m {kkt.m} endgame {rec.get('endgame_backend')} "
                                 f"{egs.get('kkt')}")
    finally:
        sparse_qp._host_endgame = orig_endgame
    print(f"  matmul assembly (dense columns; the host K2 endgame): {sorted(matmul)}")
    check("svm_3000x200_0" in matmul, "svm's dense columns did not take the matmul assembly")
    determinism_check(torch, mt, dict(instances)["gridlp_100_0"])
    for msg in fails:
        print(f"  FAIL {msg}")
    check(not fails, f"sparse LP: {len(fails)} failures")
    return launches, ldl


def determinism_check(torch, mt, qp):
    """gridlp_100's normal matrix assembled and factored twice from one
    iterate (a seeded Σ, δ_c = -1e-8) on the card: the factor, its inverse
    and the scale bit-equal; seconds of one assembly + factorization."""
    from madqp_tpu_torch.solver.sparse_lp import DeviceSparseNormalKKT, make_problem

    qp_s, _ = mt.scale_qp(mt.presolve_qp(qp)[0])
    std = mt.build_standard_form_sparse(qp_s)[0]
    t0 = time.perf_counter()
    kkt = DeviceSparseNormalKKT(std.A, mode="dense")
    symbolic = time.perf_counter() - t0
    prob = make_problem(std, kkt, torch.float64, "cuda")
    rng = np.random.default_rng(0)
    pr = torch.as_tensor(rng.uniform(0.5, 2.0, std.n), device="cuda")
    del_c = torch.tensor(-1e-8, dtype=torch.float64, device="cuda")
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (L, iL), _, scale, _, _ = kkt.factorize(prob, pr, del_c)
        torch.cuda.synchronize()
        runs.append(((L, iL, scale), time.perf_counter() - t0))
    (a, t_a), (b, t_b) = runs
    same = all(bool(torch.equal(u, v)) for u, v in zip(a, b))
    print(f"  gridlp_100 S (m = {kkt.m}, {kkt.assembly}, {kkt.npairs} pairs): host "
          f"symbolic {symbolic:.3f} s; assembled and factored twice in {t_a:.3f} s and "
          f"{t_b:.3f} s; factor, inverse and scale bit-equal: {same}")
    check(same, "gridlp_100: two assemblies and factorizations differ")


def front_schedule(kkt):
    """(stacks per factorization, "w_pad x u_pad x count [x steps]" per
    schedule item) of a supernodal KKT."""
    from madqp_tpu_torch.ops import sparse_chol as SC

    items, stacks = [], 0
    symb = kkt.bs if hasattr(kkt, "bs") else kkt.symb   # the augmented KKT's, or the others'
    for it in symb.schedule:
        steps = it.steps if isinstance(it, SC._BucketScan) else (
            it.count if isinstance(it, SC._Chain) else 1)
        lanes = 1 if isinstance(it, SC._Chain) else it.count
        stacks += steps
        items.append(f"{type(it).__name__}(w {it.w_pad}, u {it.u_pad}, {lanes} x {steps})")
    return stacks, items


def supernodal_phase(torch, mt, k1, k8, ref, smi):
    """Phase 16: the supernodal sparse LP on the card.  bandedlp_30000_0
    through the runner's --backend sparse-device in float64 and with
    --mixed-precision --endgame host; gridlp_100_0 and staircase_2000p24_0
    forced onto the path; K1 on the fronts captured from the bandedlp
    solve against its route's plain version and cholesky_ex; the chain
    step's two routes; the factorization twice, bit-equal.  Returns (K1
    launches of the batched tiers, of the lane axis, K2-batched launches
    (the float32 phase's fronts), worst front error, front timings)."""
    import tempfile

    from madqp_tpu_torch.io.mps_write import write_mps
    from madqp_tpu_torch.ops import ldl_batched as k2
    from madqp_tpu_torch.ops import sparse_chol as SC
    from madqp_tpu_torch.solver import sparse_lp

    phase("16. supernodal sparse LP on the card: bandedlp_30000_0 (m = 15000) through "
          "--backend sparse-device; gridlp_100_0 and staircase_2000p24_0 forced")
    runner = runner_module()
    want, host = ref["supernodal_xlarge"][SUPERNODAL], ref["host_xlarge"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for name, qp in mt.structured_suite("xlarge", seeds=(0,),
                                            families=("bandedlp", "gridlp", "staircase")):
            write_mps(qp, str(Path(d) / f"{name}.mps"))
        instances = dict(runner.read_dir(d))
    print(f"  {len(instances)} instances written and read back in "
          f"{time.perf_counter() - t0:.3f} s")
    # Count the factorization trials, and keep the fronts' F11 stacks of the
    # first and the last trial (copies; K1 is not launched for them here).
    trials, fronts = [0], {}
    orig_factorize, orig_chol = sparse_lp.DeviceSparseNormalKKT.factorize, SC.cholesky_lower_routed

    def counted(self, *args):
        trials[0] += 1
        fronts.pop("last", None)
        return orig_factorize(self, *args)

    def captured(F):
        key = "first" if trials[0] == 1 else "last"
        fronts.setdefault(key, []).append(F.clone())
        return orig_chol(F)

    runs = [(SUPERNODAL, "f64", [], {}),
            (SUPERNODAL, "mixed", ["--mixed-precision", "--endgame", "host"], {}),
            *[(nm, "forced", [], {"dense_normal_limit": 0}) for nm in FORCED_SUPERNODAL]]
    fails, batched, lanes, ldl, bandedlp_fronts = [], 0, 0, 0, {}
    sparse_lp.DeviceSparseNormalKKT.factorize = counted
    SC.cholesky_lower_routed = captured
    try:
        for name, label, args, extra in runs:
            options = runner.solve_options(runner.parser().parse_args(
                ["--backend", "sparse-device", "--sparse-kkt", "auto"] + args))
            options.update(extra)
            trials[0] = 0
            fronts.clear()
            reset_counts(k1, k8)
            t0 = time.perf_counter()
            rec = runner.run_instance(name, instances[name], options)
            wall = time.perf_counter() - t0
            routes = dict(k1.cholesky_lower.routes)
            n1, n8, nt = k1.cholesky_lower.launches, k8.syrk_update.launches, trials[0]
            n2 = k2.ldl_lower_batched.launches
            kkt = last_kkt()
            stacks, items = front_schedule(kkt)
            if not isinstance(rec["status"], int):
                fails.append(f"{label} {name}: record {rec['status']}")
                continue
            ldl += n2
            lanes += routes.get("persistent", 0)
            batched += n1 - routes.get("persistent", 0) - routes.get("single", 0)
            mixed = label == "mixed"
            if label == "forced":
                w = host[name]
                bound, rel = 1e-8, rel_err(rec["objective"], w["objective"])
                iter_ok = abs(rec["iter"] - w["iter"]) <= 1
            elif mixed:
                w = want["mixed"]
                rel = rel_err(rec["objective"], want["host"]["objective"])
                bound = max(MIXED_RTOL, 2 * rel_err(w["objective"], want["host"]["objective"]))
                iter_ok = abs(rec["iter"] - w["iter"]) <= MIXED_ITER_BAND
            else:
                w = want["f64"]
                bound, rel = 1e-8, rel_err(rec["objective"], w["objective"])
                iter_ok = rec["iter"] == w["iter"]
            per_trial = {r: c / max(nt, 1) for r, c in routes.items()}
            print(f"  {label} {name}: m={kkt.m} mode={kkt.mode} {rec.get('status_detail')} "
                  f"iter={rec['iter']} (ref {w['iter']}) rel={rel:.2e} (bound {bound:.1e}) "
                  f"solve={rec['total_time']:.3f} s wall={wall:.3f} s endgame="
                  f"{rec.get('endgame_backend', '-')} {rec.get('endgame_time', 0.0):.3f} s; "
                  f"{nt} factorization trials, K1 launches {n1} by route {routes} "
                  f"({per_trial} per trial; {n1 / max(rec['iter'], 1):.1f} per iteration), "
                  f"K2-batched {n2} ({n2 / max(nt, 1):.1f} per trial), K8 {n8}; schedule "
                  f"{stacks} front stacks: {items}", flush=True)
            ok = (rec["status"] == 1 and iter_ok and rel <= bound and kkt.mode == "batched"
                  and n8 == 0 and kkt.m == (want["m"] if name == SUPERNODAL else host[name]["m"]))
            if mixed:
                # the float32 phase factors on the pivot-floored LDL^T
                # (K2-batched, one launch per front stack), the endgame on
                # the host: no K1 launch
                ok = (ok and kkt.use_ldl and n1 == 0 and n2 == stacks * nt and n2 > 0
                      and rec.get("endgame_backend") in ("host", "host-cold"))
            else:
                ok = ok and n1 == stacks * nt and n1 > 0 and n2 == 0
            if name == SUPERNODAL and label == "f64":
                bandedlp_fronts = dict(fronts)
            if not ok:
                fails.append(f"{label} {name}: {rec.get('status_detail')} iter {rec['iter']} "
                             f"(ref {w['iter']}) rel {rel:.2e} K1 {n1} ({stacks} x {nt}) "
                             f"K8 {n8} mode {kkt.mode}")
    finally:
        sparse_lp.DeviceSparseNormalKKT.factorize = orig_factorize
        SC.cholesky_lower_routed = orig_chol
    for msg in fails:
        print(f"  FAIL {msg}")
    check(not fails, f"supernodal sparse LP: {len(fails)} failures")
    err, times = front_kernel_check(torch, k1, bandedlp_fronts)
    supernodal_determinism(torch, mt, instances[SUPERNODAL])
    return batched, lanes, ldl, err, times


# Phase 16: K1 on the fronts of the bandedlp solve's last factorization
# trial, whose F11 near the optimum are ill-conditioned: two orders of the
# same sums part by about cond(F11) times the rounding unit.  Each factor
# is held by its backward error, max|L L^T - F| / max|F| per matrix, within
# FRONT_BACKWARD_TOL, and against its route's plain version within
# n cond(F11) eps of max|L| per matrix (measured on the H100: 6.3e-12 and
# 3.7e-11 in two calls, the plain version's cuBLAS products differing),
# not at ROUTE_TOL, which the first trial's well-conditioned fronts meet.
FRONT_BACKWARD_TOL = 1e-14


def front_kernel_check(torch, k1, fronts):
    """K1 on the F11 stacks of the bandedlp solve's first factorization
    trial against its route's plain version (ROUTE_TOL), and on its last
    trial's (backward error, FRONT_TOL); the first stack timed against
    cholesky_ex beside its bound; then a chain step (one front) on its
    stack route and on the 2-D persistent launch.  A warm-started phase
    (no well-conditioned first trial) passes only "last"."""
    check(fronts.get("last"), "no front stacks captured")
    worst = {}
    for trial, stacks in fronts.items():
        for F in stacks:
            dname = str(F.dtype).split(".")[-1]
            route = k1.batched_route(F.shape[-1], k1.batched_max_n(F.dtype, F.device))
            L = k1.cholesky_lower(F)
            P = k1.ROUTE_REFERENCE[route](F)
            scale = P.abs().amax(dim=(-2, -1)).clamp_min(1e-300)
            e = float(((L - P).abs().amax(dim=(-2, -1)) / scale).max())
            Fl = torch.tril(F) + torch.tril(F, -1).mT
            back = float(((L @ L.mT - Fl).abs().amax(dim=(-2, -1))
                          / Fl.abs().amax(dim=(-2, -1))).max())
            d = torch.diagonal(L, dim1=-2, dim2=-1)
            w = worst.setdefault(trial, [0.0, 0.0, 0.0])
            if trial == "first":
                bound = k1.ROUTE_TOL[route][dname]
                ratio = e / bound
            else:
                ev = torch.linalg.eigvalsh(Fl)
                cond = ev[..., -1] / ev[..., 0]
                per = (L - P).abs().amax(dim=(-2, -1)) / scale
                bound = F.shape[-1] * torch.finfo(F.dtype).eps * cond
                ratio = float((per / bound).max())
                w[2] = max(w[2], float(cond.max()))
            w[0], w[1] = max(w[0], e), max(w[1], back)
            check(ratio <= 1.0 and back <= FRONT_BACKWARD_TOL,
                  f"{trial} trial's front stack {tuple(F.shape)} {route}: error {e:.2e} "
                  f"({ratio:.2f} of its bound), backward error {back:.2e}")
            check(bool((torch.isfinite(d) & (d > 0)).all()),
                  f"front stack {tuple(F.shape)}: not SPD")
    F = fronts["last"][0]
    dname = str(F.dtype).split(".")[-1]
    route = k1.batched_route(F.shape[-1], k1.batched_max_n(F.dtype, F.device))
    t = {"kernel": cuda_median_ms(torch, lambda: k1.cholesky_lower(F)),
         "plain": cuda_median_ms(torch, lambda: k1.ROUTE_REFERENCE[route](F), runs=5, burst=1),
         "torch.linalg.cholesky_ex": cuda_median_ms(torch, lambda: torch.linalg.cholesky_ex(F))}
    t["bound"], t["bound_by"] = chol_bound_ms(F.shape[0], F.shape[-1], F.element_size(), dname)
    one, two = F[:1].contiguous(), F[0].contiguous()
    chain = {"stack of one": cuda_median_ms(torch, lambda: k1.cholesky_lower(one)),
             "2-D persistent": cuda_median_ms(torch, lambda: k1.cholesky_lower(two))}
    first = worst.get("first", [float("nan")] * 3)
    print(f"  K1 on the front stacks {sorted({tuple(f.shape) for f in fronts['last']})} "
          f"{dname} ({route}): against the route's plain version, worst error "
          f"{first[0]:.2e} on the first trial's (bound "
          f"{k1.ROUTE_TOL[route][dname]:.0e}), {worst['last'][0]:.2e} on the last trial's "
          f"(bound n cond eps per matrix, largest cond {worst['last'][2]:.2e}); worst backward "
          f"error {max(w[1] for w in worst.values()):.2e}; "
          f"{tuple(F.shape)}: kernel {t['kernel']:.4f} ms, plain {t['plain']:.3f} ms, "
          f"cholesky_ex {t['torch.linalg.cholesky_ex']:.4f} ms, bound {t['bound']:.4f} ms "
          f"({t['bound_by']}); a chain step (one front {F.shape[-1]}^2): {route} stack of one "
          f"{chain['stack of one']:.4f} ms, 2-D persistent {chain['2-D persistent']:.4f} ms",
          flush=True)
    return max(w[0] for w in worst.values()), t


def supernodal_determinism(torch, mt, qp):
    """bandedlp's supernodal KKT built (host symbolic seconds) and its S
    assembled and factored twice from one iterate (a seeded Σ, δ_c =
    -1e-8): panels and scale bit-equal; ms of one assembly +
    factorization and of one backsolve."""
    from madqp_tpu_torch.solver.sparse_lp import DeviceSparseNormalKKT, make_problem

    qp_s, _ = mt.scale_qp(mt.presolve_qp(qp)[0])
    std = mt.build_standard_form_sparse(qp_s)[0]
    t0 = time.perf_counter()
    kkt = DeviceSparseNormalKKT(std.A)
    symbolic = time.perf_counter() - t0
    prob = make_problem(std, kkt, torch.float64, "cuda")
    rng = np.random.default_rng(0)
    pr = torch.as_tensor(rng.uniform(0.5, 2.0, std.n), device="cuda")
    rx = torch.as_tensor(rng.standard_normal(std.n), device="cuda")
    ry = torch.as_tensor(rng.standard_normal(std.m), device="cuda")
    del_c = torch.tensor(-1e-8, dtype=torch.float64, device="cuda")
    kkt.factorize(prob, pr, del_c)   # the schedule's index arrays to the card
    a = kkt.factorize(prob, pr, del_c)
    b = kkt.factorize(prob, pr, del_c)
    same = (all(bool(torch.equal(u, v)) for u, v in zip(a[0], b[0]))
            and bool(torch.equal(a[2], b[2])))
    fact_ms = cuda_median_ms(torch, lambda: kkt.factorize(prob, pr, del_c), runs=10, burst=1)
    solve_ms = cuda_median_ms(torch, lambda: kkt.solve(a, rx, ry), runs=10, burst=1)
    dx, dy = kkt.solve(a, rx, ry)
    A = std.A.tocsr()
    x, y = dx.cpu().numpy(), dy.cpu().numpy()
    rxn, ryn = rx.cpu().numpy(), ry.cpu().numpy()
    res = max(float(np.abs(pr.cpu().numpy() * x + A.T @ y - rxn).max()),
              float(np.abs(A @ x - 1e-8 * y - ryn).max())) / max(np.abs(rxn).max(),
                                                                   np.abs(ryn).max())
    print(f"  bandedlp S (m = {kkt.m}): host symbolic {symbolic:.3f} s; assembled and "
          f"factored in {fact_ms:.3f} ms, one backsolve {solve_ms:.3f} ms; two "
          f"factorizations bit-equal: {same}; KKT residual {res:.2e}; factor_ok "
          f"{bool(kkt.factor_ok(a))}", flush=True)
    check(same, "bandedlp: two supernodal factorizations differ")
    check(bool(kkt.factor_ok(a)) and res < 1e-8, "bandedlp: supernodal KKT solve")


# Phase 17: K2-batched against its plain version at the widths of the
# signed fronts (w_pad is a pad class <= 128) and its batches, and the
# xlarge QP members on the augmented and condensed systems.
LDL_WIDTHS = (8, 16, 32, 33, 64, 96, 128)
LDL_BATCHES = (1, 128, 1024)
LDL_TIMED = ((128, 128), (1024, 128), (128, 32), (1024, 8))
# the xlarge QP members with a general Hessian (augmented_xlarge), the two
# condensed ones (condensed_xlarge), and the member of the bit-equality,
# front and MPCSolver checks
AUGMENTED = ("chainqp", "cvxqp", "lasso", "portfolio")
CONDENSED = ("chainqp_50000_0", "cvxqp_20000_0")
KRYLOV = "cvxqp_20000_0"
QP_PROBE = "cvxqp_20000_0"
# the members whose last float64 factorization trial's F11 stacks K2-batched
# is checked and timed on (chainqp_50000's (438, 128, 128) is the largest
# stack of the sparse QP path)
FRONT_PROBES = (QP_PROBE, "chainqp_50000_0")
# The condensed path's float64 iteration count moves with its fronts'
# Cholesky rounding (ROADMAP.md Queue 3: by up to 2 between
# Cholesky routines on the CPU tests' problems): held within this band of
# the JAX record.
COND_ITER_BAND = 3
# K2-batched on the fronts of the front probes' last factorization trial
# (quasi-definite, ill-conditioned near the optimum): each matrix's
# backward error max|F - L D L^T| within this bound of max(|L| |D| |L^T|),
# the scale of the no-pivot LDL^T's error bound (gamma_n |L||D||L^T|), and
# every pivot's sign and finiteness that of the plain version.  Relative
# to max|F| instead, the plain version's own error on such fronts reaches
# 1.5e-12 (chain_qp(2000)'s fronts on a CPU, element growth |L||D||L^T| /
# |F| up to 1.5e4), and it is printed beside.
LDL_BACKWARD_TOL = 1e-14


def quasi_definite(torch, batch, n, dtype, seed):
    """A stack of quasi-definite [P C^T; C -Q] matrices (P, Q SPD) and
    their pivot signs, from `seed` with NumPy (on the card above 64M
    entries)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((batch, n, n))
    M = M @ M.transpose(0, 2, 1) / n + np.eye(n)
    k = n // 2
    M[:, k:, k:] *= -1.0
    s = np.ones((batch, n))
    s[:, k:] = -1.0
    return (torch.as_tensor(M, dtype=dtype, device="cuda"),
            torch.as_tensor(s, dtype=dtype, device="cuda"))


def ldl_bound_ms(batch, n, element_size, dname):
    """Bound of `batch` no-pivot LDL^T of order n (`roofline.factor_ops`,
    `roofline.ldl_bytes`)."""
    from madqp_tpu_torch.utils import roofline

    return bound_ms(roofline.factor_ops(batch, n),
                    roofline.ldl_bytes(batch, n, element_size), dname)


def ldl_errors(L, d, Lp, dp):
    """max|L - Lp| / max|Lp| and max|d - dp| / max|dp|, worst matrix."""
    eL = float(((L - Lp).abs().amax(dim=(-2, -1)) / Lp.abs().amax(dim=(-2, -1))).max())
    ed = float(((d - dp).abs().amax(-1) / dp.abs().amax(-1)).max())
    return eL, ed


def ldl_kernel_phase(torch, k2):
    """Phase 17a: K2-batched against its plain version on quasi-definite
    stacks at LDL_WIDTHS x LDL_BATCHES, float32 and float64, with and
    without the pivot floor; a zero pivot's inf / NaN in its own matrix
    only; two runs bit-equal; CUDA-event times at LDL_TIMED beside the
    plain version, the bound and two library calls for orientation only
    (ldl_factor_ex pivots; cholesky_ex on an SPD stack).  Returns (the
    largest float64 error at (128, 128), timings)."""
    phase("17a. K2-batched against plain version")
    main_err, timings, worst = 0.0, {}, {}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        tol = k2.TOL[dname]
        for B in LDL_BATCHES:
            for n in LDL_WIDTHS:
                F, s = quasi_definite(torch, B, n, dtype, seed=B + n)
                for floor in (False, True):
                    sg, fl = (s, 1e-6) if floor else (None, 0.0)
                    before = k2.ldl_lower_batched.launches
                    L, d = k2.ldl_lower_batched(F, sg, fl)
                    torch.cuda.synchronize()
                    launched = k2.ldl_lower_batched.launches - before
                    Lp, dp = k2.ldl_batched_reference(F, sg, fl)
                    eL, ed = ldl_errors(L, d, Lp, dp)
                    L2, d2 = k2.ldl_lower_batched(F, sg, fl)
                    same = bool(torch.equal(L, L2) and torch.equal(d, d2))
                    upper = bool((torch.triu(L, 1) == 0).all())
                    w = worst.setdefault(dname, [0.0, 0.0])
                    w[0], w[1] = max(w[0], eL), max(w[1], ed)
                    if dname == "float64" and (B, n) == (128, 128):
                        main_err = max(main_err, float((L - Lp).abs().max()))
                    check(launched == 1 and same and upper and eL <= tol and ed <= tol,
                          f"K2 {dname} ({B}, {n}) floor={floor}: launches {launched}, "
                          f"rel_err L {eL:.2e} d {ed:.2e} (tol {tol:g}), bit-equal {same}")
        # a zero pivot (a zero row and column) in one matrix of the stack
        for n in (16, 65, 128):
            F, _ = quasi_definite(torch, 6, n, dtype, seed=n)
            Z = F.clone()
            Z[2, n // 3, :] = 0.0
            Z[2, :, n // 3] = 0.0
            L, d = k2.ldl_lower_batched(Z)
            L0, d0 = k2.ldl_lower_batched(F)
            finite = (torch.isfinite(L).all(dim=(-2, -1))
                      & torch.isfinite(d).all(-1)).tolist()
            keep = [0, 1, 3, 4, 5]
            check(finite == [i != 2 for i in range(6)]
                  and bool(torch.equal(L[keep], L0[keep])),
                  f"K2 {dname} n={n}: a zero pivot reached other matrices ({finite})")
        print(f"  {dname}: {len(LDL_BATCHES) * len(LDL_WIDTHS) * 2} stacks, worst rel_err "
              f"L {worst[dname][0]:.2e} d {worst[dname][1]:.2e} (tol {tol:g}); one launch "
              f"each, bit-equal twice; a zero pivot's inf/NaN stays in its own matrix")
        for B, n in LDL_TIMED:
            F, _ = quasi_definite(torch, B, n, dtype, seed=B * n)
            S = F.clone()
            S[:, n // 2:, n // 2:] *= -1.0   # SPD, the same shape
            # ldl_factor_ex takes 0.1-3.4 s a stack on the H100:
            # three samples of one call
            t = {"kernel": cuda_median_ms(torch, lambda: k2.ldl_lower_batched(F)),
                 "plain": cuda_median_ms(torch, lambda: k2.ldl_batched_reference(F),
                                         runs=5, burst=1),
                 "ldl_factor_ex": cuda_median_ms(torch, lambda: torch.linalg.ldl_factor_ex(F),
                                                 runs=3, burst=1),
                 "cholesky_ex": cuda_median_ms(torch, lambda: torch.linalg.cholesky_ex(S))}
            t["bound"], t["bound_by"] = ldl_bound_ms(B, n, F.element_size(), dname)
            timings[(dname, (B, n))] = t
            print(f"  time {dname} ({B}, {n}, {n}) (ms): kernel {t['kernel']:.4f}, plain "
                  f"{t['plain']:.3f}, bound {t['bound']:.4f} ({t['bound_by']}); for "
                  f"orientation only: ldl_factor_ex (pivots) {t['ldl_factor_ex']:.4f}, "
                  f"cholesky_ex on an SPD stack {t['cholesky_ex']:.4f}", flush=True)
    return main_err, timings


def qp_record_checks(rec, w, bound, band, optimum):
    """(ok, rel) of a runner record against the reference's record `w`:
    status, iterations within `band`, objective within `bound` of
    `optimum`."""
    if not isinstance(rec["status"], int):
        return False, float("nan")
    rel = rel_err(rec["objective"], optimum)
    return (rec["status"] == 1 and rec.get("status_detail") == w["status_detail"]
            and abs(rec["iter"] - w["iter"]) <= band and rel <= bound), rel


def sparse_qp_phase(torch, mt, k1, k8, k2, ref, smi, save_fronts=None):
    """Phase 17b: the xlarge QP members through the runner's --backend
    sparse-device (auto: the augmented K2 system) in float64 and with
    --mixed-precision --endgame host, and --sparse-kkt condensed on
    chainqp and cvxqp (float64, and cvxqp with the krylov endgame); then
    K2-batched on the captured fronts of FRONT_PROBES (saved to
    `save_fronts`/<name>.pt if given), one K assembled and factored twice,
    and MPCSolver(kkt_system="sparse-augmented").  Returns (K2-batched
    launches, K1 launches of the batched tiers and of the lane axis, front
    timings by probe)."""
    import tempfile

    from madqp_tpu_torch.io.mps_write import write_mps
    from madqp_tpu_torch.ops import blocked_dense as BD
    from madqp_tpu_torch.ops import sparse_chol as SC
    from madqp_tpu_torch.solver import sparse_common, sparse_condensed, sparse_qp

    phase("17b. sparse QP on the card: the xlarge QP members through --backend "
          "sparse-device (augmented K2; condensed K1 on chainqp and cvxqp)")
    runner = runner_module()
    aug, cond = ref["augmented_xlarge"], ref["condensed_xlarge"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for name, qp in mt.structured_suite("xlarge", seeds=(0,), families=AUGMENTED):
            write_mps(qp, str(Path(d) / f"{name}.qps"))
        instances = dict(runner.read_dir(d))
    print(f"  {len(instances)} instances written and read back in "
          f"{time.perf_counter() - t0:.3f} s")
    check(sorted(instances) == sorted(aug), f"xlarge QP members: {sorted(instances)}")
    # Time the host symbolic phase (the KKT's construction), keep the front
    # probes' last trial's F11 stacks, and count the factorization trials by
    # route from the kernels' own counters (`MPCKernel.factorizations`): the
    # augmented KKT's trials replay a graph, which calls `factorize` only at
    # its capture.  The clones taken at the capture are the graph's, so every
    # replay writes its fronts into them: they end as the last trial's.
    symbolic, fronts = [0.0], {}
    kkts = (sparse_qp.DeviceSparseAugmentedKKT, sparse_condensed.DeviceSparseCondensedKKT)
    orig = {cls: (cls.__init__, cls.factorize) for cls in kkts}
    orig_ldl = BD.ldl_lower_batched
    capture = [None]

    def patch(cls):
        init, fact = orig[cls]

        def timed_init(self, *a, **kw):
            t = time.perf_counter()
            init(self, *a, **kw)
            symbolic[0] += time.perf_counter() - t

        def kept(self, *a):
            if capture[0]:
                fronts[capture[0]] = []
            return fact(self, *a)
        cls.__init__, cls.factorize = timed_init, kept

    def trial_counts():
        """Each cached sparse kernel and its trials by route, as they stand."""
        return {id(kernel): (kernel, collections.Counter(kernel.factorizations))
                for _, kernel in sparse_common._KERNEL_CACHE.values()}

    def trials_since(before):
        """The trials by route that the cached kernels made since `before`."""
        got = collections.Counter()
        for _, kernel in sparse_common._KERNEL_CACHE.values():
            got += kernel.factorizations - before.get(id(kernel), (None, collections.Counter()))[1]
        return got

    def captured(F, sgn=None, floor=0.0):
        if capture[0]:
            fronts[capture[0]].append(F.clone())
        return orig_ldl(F, sgn=sgn, floor=floor)

    runs = [(nm, label, args) for nm in sorted(aug)
            for label, args in (("f64", []), ("mixed", ["--mixed-precision", "--endgame",
                                                         "host"]))]
    runs += [(nm, "condensed", ["--sparse-kkt", "condensed"]) for nm in CONDENSED]
    runs += [(KRYLOV, "krylov", ["--sparse-kkt", "condensed", "--mixed-precision",
                                 "--endgame", "krylov"])]
    fails, launches, k1_batched, k1_lanes = [], 0, 0, 0
    for cls in kkts:
        patch(cls)
    BD.ldl_lower_batched = captured
    try:
        for name, label, args in runs:
            argv = ["--backend", "sparse-device"] + args
            if "--sparse-kkt" not in args:
                argv += ["--sparse-kkt", "auto"]
            options = runner.solve_options(runner.parser().parse_args(argv))
            symbolic[0] = 0.0
            capture[0] = name if name in FRONT_PROBES and label == "f64" else None
            reset_counts(k1, k8)
            before = trial_counts()
            t0 = time.perf_counter()
            rec = runner.run_instance(name, instances[name], options)
            wall = time.perf_counter() - t0
            n2, n1 = k2.ldl_lower_batched.launches, k1.cholesky_lower.launches
            routes, by_route = dict(k1.cholesky_lower.routes), trials_since(before)
            # a trial that captures runs on the card twice: the warm-up, then
            # its replay
            nt, on_card = sum(by_route.values()), sum(by_route.values()) + by_route["capture"]
            launches += n2
            k1_lanes += routes.get("persistent", 0)
            k1_batched += n1 - routes.get("persistent", 0) - routes.get("single", 0)
            kkt = last_kkt()
            stacks, items = front_schedule(kkt)
            f64 = aug[name]["f64"] if name in aug else None
            if label == "f64":
                w = aug[name]["f64"]
                ok, rel = qp_record_checks(rec, w, 1e-8, 1, w["objective"])
                ok = (ok and n2 == stacks * on_card and n1 == 0 and kkt.m == aug[name]["m"]
                      and by_route["eager"] == 0)
            elif label == "mixed":
                w = aug[name]["mixed"]
                bound = max(MIXED_RTOL, 2 * rel_err(w["objective"], f64["objective"]))
                ok, rel = qp_record_checks(rec, w, bound, MIXED_ITER_BAND, f64["objective"])
                ok = (ok and n1 == 0 and n2 == stacks * on_card and n2 > 0
                      and by_route["eager"] == 0
                      and rec.get("endgame_backend") in ("host", "host-cold"))
            else:
                w = cond[name]["f64" if label == "condensed" else "krylov"]
                band = COND_ITER_BAND if label == "condensed" else MIXED_ITER_BAND
                bound = 1e-8 if label == "condensed" else MIXED_RTOL
                ok, rel = qp_record_checks(rec, w, bound, band, cond[name]["f64"]["objective"])
                if label == "condensed":   # K1's batched form on C's SPD fronts, eager
                    ok = ok and n1 == stacks * on_card == stacks * by_route["eager"] and n2 == 0
                else:                      # the float32 fronts on K2-batched, then CG
                    ok = (ok and n2 > 0 and n1 == 0
                          and rec.get("endgame_backend") == w["endgame_backend"])
            print(f"  {label} {name}: {rec.get('status_detail', rec['status'])} "
                  f"iter={rec['iter']} (ref {w['iter']}) rel={rel:.2e} solve="
                  f"{rec['total_time']:.3f} s wall={wall:.3f} s host symbolic "
                  f"{symbolic[0]:.3f} s endgame={rec.get('endgame_backend', '-')} "
                  f"{rec.get('endgame_time', 0.0):.3f} s; {nt} factorization trials "
                  f"{dict(by_route)}, K2-batched launches {n2} ({n2 / max(on_card, 1):.1f} "
                  f"per run of a trial on the card), K1 {n1} "
                  f"{routes}; schedule {stacks} front stacks: {items}", flush=True)
            if not ok:
                fails.append(f"{label} {name}: {rec.get('status_detail', rec['status'])} "
                             f"iter {rec['iter']} (ref {w['iter']}) rel {rel:.2e} "
                             f"K2 {n2} K1 {n1} ({stacks} x {on_card}; {dict(by_route)})")
    finally:
        for cls in kkts:
            cls.__init__, cls.factorize = orig[cls]
        BD.ldl_lower_batched = orig_ldl
    for msg in fails:
        print(f"  FAIL {msg}")
    check(not fails, f"sparse QP: {len(fails)} failures")
    check(sorted(fronts) == sorted(FRONT_PROBES), f"fronts captured of {sorted(fronts)}")
    times = {name: ldl_front_check(torch, k2, name, stacks) for name, stacks in fronts.items()}
    if save_fronts:
        Path(save_fronts).mkdir(parents=True, exist_ok=True)
        for name, stacks in fronts.items():
            torch.save([f.cpu() for f in stacks], Path(save_fronts) / f"{name}.pt")
        print(f"  front stacks saved to {save_fronts}")
    fronts.clear()
    augmented_determinism(torch, mt, instances[QP_PROBE])
    mpcsolver_check(mt, runner, instances[QP_PROBE], aug[QP_PROBE]["f64"])
    print("  laplqp_150_0 not run: its host symbolic phase alone took 312 s on a "
          "CPU (ROADMAP.md Queue 3); tests/test_torch_sparse_qp.py covers the "
          "host-full reroute under a lowered MADQP_MAX_UPDATE_ENTRIES")
    return launches, k1_batched, k1_lanes, times


def ldl_front_check(torch, k2, name, fronts):
    """K2-batched on the F11 stacks of member `name`'s last factorization
    trial: each matrix's backward error within LDL_BACKWARD_TOL, every
    pivot's sign and finiteness that of the plain version (so the same
    factor_ok verdict), and the largest stack timed beside its bound.  A
    matrix whose plain factor is not finite (in a batch, a lane that has
    stopped is still factored and its factor thrown away, as under the
    reference's vmap) has no backward error: the kernel's must be
    non-finite on exactly those matrices, which are counted."""
    check(bool(fronts), f"{name}: no front stacks captured")

    def finite(L, d):
        return torch.isfinite(L).all(dim=(-2, -1)) & torch.isfinite(d).all(-1)

    def backward(L, d, Fl, keep):
        """max|F - L D L^T| per matrix over max(|L||D||L^T|) and over max|F|,
        on the matrices `keep`."""
        L, d, Fl = L[keep], d[keep], Fl[keep]
        if not L.shape[0]:
            return 0.0, 0.0
        err = (L * d[..., None, :] @ L.mT - Fl).abs().amax(dim=(-2, -1))
        growth = ((L.abs() * d.abs()[..., None, :]) @ L.abs().mT).amax(dim=(-2, -1))
        return float((err / growth).max()), float((err / Fl.abs().amax(dim=(-2, -1))).max())

    worst, skipped = [0.0, 0.0, 0.0, 0.0], 0
    for F in fronts:
        L, d = k2.ldl_lower_batched(F)
        Lp, dp = k2.ldl_batched_reference(F)
        Fl = torch.tril(F) + torch.tril(F, -1).mT
        keep = finite(Lp, dp)
        skipped += int((~keep).sum())
        back, back_f = backward(L, d, Fl, keep)
        back_p, back_pf = backward(Lp, dp, Fl, keep)
        same_signs = bool(torch.equal(torch.sign(d), torch.sign(dp))
                          and torch.equal(torch.isfinite(d), torch.isfinite(dp))
                          and torch.equal(finite(L, d), keep))
        worst = [max(w, v) for w, v in zip(worst, (back, back_f, back_p, back_pf))]
        check(back <= LDL_BACKWARD_TOL and same_signs,
              f"front stack {tuple(F.shape)}: backward error {back:.2e} (plain {back_p:.2e}), "
              f"pivot signs equal {same_signs}")
    F = max(fronts, key=lambda f: f.shape[0] * f.shape[-1])
    dname = str(F.dtype).split(".")[-1]
    t = {"kernel": cuda_median_ms(torch, lambda: k2.ldl_lower_batched(F)),
         "plain": cuda_median_ms(torch, lambda: k2.ldl_batched_reference(F), runs=5, burst=1)}
    t["bound"], t["bound_by"] = ldl_bound_ms(F.shape[0], F.shape[-1], F.element_size(), dname)
    print(f"  K2-batched on {name}'s last trial's front stacks "
          f"{sorted({tuple(f.shape) for f in fronts})} {dname}: worst backward error "
          f"{worst[0]:.2e} of max|L||D||L^T| (plain {worst[2]:.2e}, bound "
          f"{LDL_BACKWARD_TOL:g}), {worst[1]:.2e} of max|F| (plain {worst[3]:.2e}); pivot "
          f"signs as the plain version's ({skipped} matrices non-finite in both); "
          f"{tuple(F.shape)}: kernel {t['kernel']:.4f} ms, "
          f"plain {t['plain']:.3f} ms, bound {t['bound']:.4f} ms ({t['bound_by']})",
          flush=True)
    return t


def augmented_determinism(torch, mt, qp):
    """The probe's augmented K assembled and factored twice from one iterate
    (a seeded Σ, δ_c = -1e-8) on the card: factors and scale bit-equal;
    host symbolic seconds, ms per factorization and per backsolve, the KKT
    residual of one solve within 10 times that of the same solve on the
    CPU."""
    from madqp_tpu_torch.solver.sparse_lp import make_problem
    from madqp_tpu_torch.solver.sparse_qp import DeviceSparseAugmentedKKT

    qp_s, _ = mt.scale_qp(mt.presolve_qp(qp)[0])
    std = mt.build_standard_form_sparse(qp_s)[0]
    t0 = time.perf_counter()
    kkt = DeviceSparseAugmentedKKT(std.H, std.A)
    symbolic = time.perf_counter() - t0
    prob = make_problem(std, kkt, torch.float64, "cuda")
    rng = np.random.default_rng(0)
    pr = torch.as_tensor(rng.uniform(0.5, 2.0, std.n), device="cuda")
    rx = torch.as_tensor(rng.standard_normal(std.n), device="cuda")
    ry = torch.as_tensor(rng.standard_normal(std.m), device="cuda")
    del_c = torch.tensor(-1e-8, dtype=torch.float64, device="cuda")
    a = kkt.factorize(prob, pr, del_c)
    b = kkt.factorize(prob, pr, del_c)
    (pa, da, ga), (pb, db, gb) = a[0], b[0]
    same = (all(bool(torch.equal(u, v)) for u, v in zip(pa + da, pb + db))
            and bool(torch.equal(ga, gb)) and bool(torch.equal(a[1], b[1])))
    fact_ms = cuda_median_ms(torch, lambda: kkt.factorize(prob, pr, del_c), runs=10, burst=1)
    solve_ms = cuda_median_ms(torch, lambda: kkt.solve(a, rx, ry), runs=10, burst=1)
    A, H = std.A.tocsr(), std.H.tocsr()
    rxn, ryn, prn = rx.cpu().numpy(), ry.cpu().numpy(), pr.cpu().numpy()

    def residual(dx, dy):
        dx, dy = dx.cpu().numpy(), dy.cpu().numpy()
        return max(float(np.abs(H @ dx + prn * dx + A.T @ dy - rxn).max()),
                   float(np.abs(A @ dx - 1e-8 * dy - ryn).max())) / max(np.abs(rxn).max(),
                                                                        np.abs(ryn).max())

    res = residual(*kkt.solve(a, rx, ry))
    # the same factorization and solve on the CPU (the reference's
    # blocked_ldl on the fronts): K is quasi-definite with delta_c = -1e-8,
    # so the residual of one solve without refinement is cond-bound there too
    cpu = torch.device("cpu")
    prob_c = make_problem(std, kkt, torch.float64, cpu)
    f_c = kkt.factorize(prob_c, pr.cpu(), del_c.cpu())
    res_cpu = residual(*kkt.solve(f_c, rx.cpu(), ry.cpu()))
    print(f"  {qp.name} K (order {std.n + std.m}): host symbolic {symbolic:.3f} s; "
          f"assembled and factored in {fact_ms:.3f} ms, one backsolve {solve_ms:.3f} ms; "
          f"two factorizations bit-equal: {same}; KKT residual {res:.2e} (the CPU's "
          f"{res_cpu:.2e}); factor_ok {bool(kkt.factor_ok(a))}", flush=True)
    check(same, f"{qp.name}: two augmented factorizations differ")
    check(bool(kkt.factor_ok(a)) and res <= max(10 * res_cpu, 1e-12),
          f"{qp.name}: augmented KKT solve")


def mpcsolver_check(mt, runner, qp, want):
    """MPCSolver(kkt_system="sparse-augmented") on the probe's presolved and
    scaled problem with the runner's options: the same iterations and
    objective as solve_sparse_qp's, and the runner record's iterations."""
    args = runner.parser().parse_args(["--backend", "sparse-device"])
    opts = {k: v for k, v in runner.solve_options(args).items()
            if k not in ("backend", "sparse_kkt", "kkt_system")}
    qp_s, _ = mt.scale_qp(mt.presolve_qp(qp)[0])
    t0 = time.perf_counter()
    st = mt.MPCSolver(qp_s, kkt_system="sparse-augmented", **opts).solve()
    secs = time.perf_counter() - t0
    ref = mt.solve_sparse_qp(qp_s, **opts)
    print(f"  MPCSolver(kkt_system='sparse-augmented') on {qp.name}: {st.status.name} "
          f"iter={st.iter} (solve_sparse_qp {ref.iter}, JAX record {want['iter']}) "
          f"objective={st.objective!r} (solve_sparse_qp {ref.objective!r}) {secs:.3f} s",
          flush=True)
    check(st.status == ref.status == mt.Status.SOLVE_SUCCEEDED and st.iter == ref.iter
          and abs(st.iter - want["iter"]) <= 1
          and rel_err(st.objective, ref.objective) <= 1e-12,
          f"{qp.name}: MPCSolver differs from solve_sparse_qp")


# Phase 18: the shared-pattern sparse batch at the reference's sweep sizes
# (testdata's sparse_batched runs, 16 lanes each, their options stored with
# them).  The float64 LP runs run twice (bit-equal; the second is the warm
# wall) and against the serial loop of the port's single supernodal solves
# of the same instances.
SPARSE_BATCH_TIMED = ("bandedlp_f64", "gridlp_f64")


def sparse_batch_problems(mt, run):
    """The instances of a sparse_batched run (chain_qp is in models.suite)."""
    from madqp_tpu_torch.models import suite

    gen = getattr(mt, run["generator"], None) or getattr(suite, run["generator"])
    return [gen(seed=s, **run["kwargs"]) for s in run["seeds"]]


def floored_ldl_check(torch, k2, name, fronts):
    """K2-batched on the float32 phase's floored fronts (F, sgn, floor) of
    every captured trial: the kernel's L D L^T within LDL_BACKWARD_TOL,
    scaled to the dtype's rounding unit, of the plain version's (both
    carry the same floor perturbation), relative to max(|L||D||L^T|) per
    matrix, and the plain version's pivot signs.  Returns the worst
    reconstruction difference; the factors' differences relative to
    max|L| and max|d| are printed beside it (element growth amplifies
    them: ldl_batched.TOL holds them on well-scaled stacks, phase 17a)."""
    worst, rel = 0.0, [0.0, 0.0]
    for trial, stacks in fronts.items():
        for F, sgn, floor in stacks:
            L, d = k2.ldl_lower_batched(F, sgn, floor)
            Lp, dp = k2.ldl_batched_reference(F, sgn, floor)
            same = bool(torch.equal(torch.sign(d), torch.sign(dp))
                        and torch.equal(torch.isfinite(d), torch.isfinite(dp)))
            diff = (L * d[..., None, :] @ L.mT - Lp * dp[..., None, :] @ Lp.mT)
            growth = ((L.abs() * d.abs()[..., None, :]) @ L.abs().mT).amax(dim=(-2, -1))
            back = float((diff.abs().amax(dim=(-2, -1)) / growth).max())
            tol = LDL_BACKWARD_TOL * torch.finfo(F.dtype).eps / torch.finfo(torch.float64).eps
            eL, ed = ldl_errors(L, d, Lp, dp)
            worst, rel = max(worst, back), [max(rel[0], eL), max(rel[1], ed)]
            check(same and back <= tol,
                  f"{name} {trial} trial's floored stack {tuple(F.shape)}: L D L^T against "
                  f"the plain version's {back:.2e} of max|L||D||L^T| (tol {tol:.2e}), "
                  f"pivot signs equal {same}")
    print(f"  K2-batched on {name}'s floored float32 fronts "
          f"{sorted({tuple(f.shape) for f, _, _ in fronts.get('last', [])})}: L D L^T "
          f"within {worst:.2e} of the plain version's (of max|L||D||L^T|); factors apart by "
          f"{rel[0]:.2e} (L) and {rel[1]:.2e} (d) of their largest; pivot signs equal",
          flush=True)
    return worst


def sparse_batch_phase(torch, mt, k1, k8, k2, ref, smi, unsharded):
    """Phase 18: solve_sparse_batched on the card.  Per run: every lane's
    status, objective (1e-8 relative) and iterations (equal in float64,
    within MIXED_ITER_BAND with the float32 phase) against the reference's
    batch; K1-batched and K2-batched launched once per front stack and
    factorization trial for the whole batch; the lane-stacked fronts of
    the first and last trials held against the kernels' plain versions;
    the float64 LP batches twice, bit-equal, and timed against the serial
    loop of single solves.  Returns (K1 launches of the batched tiers,
    K2-batched launches); keeps each run's stats, K1 routes and K2-batched
    launches in unsharded[run] (phase 20 repeats bandedlp_f64 on a mesh)."""
    from madqp_tpu_torch.ops import blocked_dense as BD
    from madqp_tpu_torch.ops import sparse_chol as SC
    from madqp_tpu_torch.solver import sparse_lp, sparse_qp

    phase("18. the shared-pattern sparse batch: solve_sparse_batched of 16 instances "
          "(banded_sparse_lp(2000, 1000) and grid_lp(40), float64 and mixed; "
          "chain_qp(10000) on the augmented system)")
    runs = ref["sparse_batched"]
    kkts = (sparse_lp.DeviceSparseNormalKKT, sparse_qp.DeviceSparseAugmentedKKT)
    orig = {cls: cls.factorize for cls in kkts}
    orig_chol, orig_ldl = SC.cholesky_lower_routed, BD.ldl_lower_batched
    trials, used = collections.Counter(), {}
    cur, fronts = [None], {}

    def signed(kkt):
        return isinstance(kkt, sparse_qp.DeviceSparseAugmentedKKT) or kkt.use_ldl

    def patch(cls):
        fact = orig[cls]

        def counted(self, *a):
            trials[id(self)] += 1
            used[id(self)] = self
            cur[0] = self
            # keep the first trial's stacks and the latest trial's of each KKT
            fronts.setdefault(id(self), {}).pop("last", None)
            return fact(self, *a)
        cls.factorize = counted

    def keep(item):
        key = "first" if trials[id(cur[0])] == 1 else "last"
        fronts[id(cur[0])].setdefault(key, []).append(item)

    def captured_chol(F):
        keep(F.clone())
        return orig_chol(F)

    def captured_ldl(F, sgn=None, floor=0.0):
        keep((F.clone(), sgn, floor))
        return orig_ldl(F, sgn=sgn, floor=floor)

    def batch(run, qps):
        trials.clear()
        used.clear()
        fronts.clear()
        reset_counts(k1, k8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = mt.solve_sparse_batched(qps, device="cuda", **run["options"])
        wall = time.perf_counter() - t0
        return res, wall, dict(k1.cholesky_lower.routes), k2.ldl_lower_batched.launches

    fails, k1_batched, k2_launches = [], 0, 0
    for cls in kkts:
        patch(cls)
    SC.cholesky_lower_routed, BD.ldl_lower_batched = captured_chol, captured_ldl
    try:
        for name, run in runs.items():
            qps = sparse_batch_problems(mt, run)
            mixed = "factorization_dtype" in run["options"]
            res, wall, routes, n2 = batch(run, qps)
            unsharded[name] = (res, routes, n2)
            n1 = sum(routes.values())
            nb = n1 - routes.get("persistent", 0) - routes.get("single", 0)
            k1_batched, k2_launches = k1_batched + nb, k2_launches + n2
            # launches expected: the KKT's front stacks x its trials
            want1 = want2 = 0
            sched = []
            for key, kkt in used.items():
                stacks, items = front_schedule(kkt)
                sched.append(f"{'LDL' if signed(kkt) else 'Cholesky'} "
                             f"{kkt.fact_dtype or torch.float64}: {trials[key]} trials x "
                             f"{stacks} stacks {items}")
                if signed(kkt):
                    want2 += stacks * trials[key]
                else:
                    want1 += stacks * trials[key]
            bad = []
            for i, (r, status, it, obj) in enumerate(zip(res, run["status"], run["iter"],
                                                         run["objective"])):
                band = MIXED_ITER_BAND if mixed else 0
                if not (int(r.status) == status == 1 and abs(r.iter - it) <= band
                        and rel_err(r.objective, obj) <= 1e-8):
                    bad.append(f"lane {i}: {r.status.name} iter {r.iter} (ref {it}) "
                               f"rel {rel_err(r.objective, obj):.2e}")
            iters = [r.iter for r in res]
            print(f"  {name}: {len(res)} lanes, iterations {iters} (ref {run['iter']}); "
                  f"worst objective rel "
                  f"{max(rel_err(r.objective, o) for r, o in zip(res, run['objective'])):.2e}; "
                  f"wall {wall:.3f} s, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; K1 launches {n1} "
                  f"{routes}, K2-batched {n2} "
                  f"(expected {want1} and {want2}: once per front stack and trial for the "
                  f"whole batch); {'; '.join(sched)}", flush=True)
            ok = not bad and n1 == nb == want1 and n2 == want2 and (want1 + want2) > 0
            if not ok:
                fails.append(f"{name}: {bad[:4]} K1 {n1} (want {want1}) K2 {n2} (want {want2})")
                continue
            captured = dict(fronts)
            for key, fr in captured.items():
                kkt, last = used[key], fr.get("last", fr["first"])
                if signed(kkt) and kkt.pivot_floor > 0:
                    floored_ldl_check(torch, k2, name, fr)
                elif signed(kkt):
                    ldl_front_check(torch, k2, name, [F for F, _, _ in last])
                elif mixed:
                    # the float64 phase 2 starts warm, near the optimum:
                    # every trial's fronts are held as a last trial's
                    front_kernel_check(torch, k1, {"last": fr["first"] + fr.get("last", [])})
                else:
                    front_kernel_check(torch, k1, {"first": fr["first"], "last": last})
            fronts.clear()
            if name not in SPARSE_BATCH_TIMED:
                continue
            again, warm, _, _ = batch(run, qps)
            same = all(np.array_equal(a.solution, b.solution)
                       and np.array_equal(a.multipliers, b.multipliers)
                       and a.iter == b.iter for a, b in zip(res, again))
            check(same, f"{name}: two runs of the batch differ")
            opts = dict(run["options"])
            mt.solve_sparse_lp(qps[0], mode="batched", device="cuda", **opts)   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serial = [mt.solve_sparse_lp(qp, mode="batched", device="cuda", **opts)
                      for qp in qps]
            torch.cuda.synchronize()
            t_serial = time.perf_counter() - t0
            same_iters = [s.iter for s in serial] == iters
            print(f"  {name}: two runs bit-equal; warm batch {warm:.3f} s "
                  f"({len(qps) / warm:.2f} instances/s) against the serial loop of single "
                  f"solves {t_serial:.3f} s ({len(qps) / t_serial:.2f} instances/s): "
                  f"{t_serial / warm:.2f}x; serial iterations equal the lanes': "
                  f"{same_iters}; {smi}", flush=True)
    finally:
        for cls in kkts:
            cls.factorize = orig[cls]
        SC.cholesky_lower_routed, BD.ldl_lower_batched = orig_chol, orig_ldl
    for msg in fails:
        print(f"  FAIL {msg}")
    check(not fails, f"sparse batch: {len(fails)} failures")
    return k1_batched, k2_launches


# Phase 19.  K2-batched on the batch's new stacks: K of batched-512 (42 + 16),
# W and S of its float64 phase, and a 128-wide diagonal block of the n = 500
# batch's K (4, 800, 800), float32 and float64.
BACKEND_LDL_STACKS = ((512, 58), (512, 42), (512, 16), (4, 128))
BACKEND_PANEL_ORDER = 2500   # W of random_qp(2000, 1000): run (c)'s panel Cholesky
BACKEND_PANEL_LANES = (1, 2, 4)


def backend_k8_check(torch, k8, n=BACKEND_PANEL_ORDER, lanes=4):
    """K8's lane axis at the launch shapes of the panel Cholesky of order n
    on `lanes` lanes, each lane a view into its own padded matrix as
    panel_chol makes it: against the plain version (SYRK_TOL), float32 and
    float64, and timed beside the plain version, torch.baddbmm (the library
    call) and the bound of `lanes` updates (roofline.syrk_ops per lane).
    Then panel_chol on 1, 2 and 4 lanes: K8 launches per factorization =
    len(panel_update_shapes(n)) at every lane count, each lane's factor
    against the 2-D call of its matrix.  Returns (float32 max abs error,
    timings per (dtype, shape), per-factorization sums)."""
    from madqp_tpu_torch.ops.blocked_dense import panel_chol, panel_update_shapes
    from madqp_tpu_torch.utils import roofline

    shapes = panel_update_shapes(n)
    err, timings, sums = 0.0, {}, {}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        total = collections.Counter()
        for j, (r, c, k) in enumerate(shapes):
            g = torch.Generator(device="cuda").manual_seed(300 + j)
            S = torch.randn((lanes, r + 64, c + 64), generator=g, dtype=dtype, device="cuda")
            Z = torch.randn((lanes, r + 64, k + 8), generator=g, dtype=dtype,
                            device="cuda") / k ** 0.5
            C, B = S[:, 64:, 64:], Z[:, 64:, 8:]
            plain = k8.syrk_update_reference(C, B)
            S0 = S.clone()
            before = k8.syrk_update.launches
            k8.syrk_update(C, B, out=C)
            torch.cuda.synchronize()
            launched = k8.syrk_update.launches - before
            abs_err = float((C - plain).abs().max())
            rel = abs_err / float(plain.abs().max())
            S0[:, 64:, 64:] = C
            kept = bool(torch.equal(S, S0))
            check(launched == 1 and rel <= SYRK_TOL[dname] and kept,
                  f"K8 lanes {dname} {lanes} x {(r, c, k)}: launches {launched}, "
                  f"rel_err {rel:.2e} (tol {SYRK_TOL[dname]:g}), rest kept {kept}")
            if dname == "float32":
                err = max(err, abs_err)
            Cc, O = C.clone(), torch.empty_like(C)
            Bt = B[:, :c].mT
            t = {"kernel": cuda_median_ms(torch, lambda: k8.syrk_update(Cc, B, out=O)),
                 "plain": cuda_median_ms(torch, lambda: k8.syrk_update_reference(Cc, B)),
                 "torch.baddbmm": cuda_median_ms(
                     torch, lambda: torch.baddbmm(Cc, B, Bt, beta=1, alpha=-1))}
            t["bound"], t["bound_by"] = bound_ms(
                lanes * roofline.syrk_ops(r, c, k),
                lanes * roofline.syrk_bytes(r, c, k, C.element_size()), dname)
            timings[(dname, (r, c, k))] = t
            for key in ("kernel", "plain", "torch.baddbmm", "bound"):
                total[key] += t[key]
            print(f"  K8 lanes {dname} {lanes} x (r, c, k)=({r}, {c}, {k}): rel_err={rel:.3e} "
                  f"(tol {SYRK_TOL[dname]:g}) max_abs_err={abs_err:.3e}; ms: "
                  + ", ".join(f"{key}={v:.4f}" for key, v in t.items() if key != "bound_by")
                  + f" ({t['bound_by']}); kernel/baddbmm {t['kernel'] / t['torch.baddbmm']:.2f}",
                  flush=True)
        sums[dname] = dict(total)
        print(f"  K8 lanes {dname}: one factorization of {lanes} x {n}^2 "
              f"({len(shapes)} launches), summed over medians (ms): "
              + ", ".join(f"{key}={v:.4f}" for key, v in total.items()))
    # launches per factorization whatever the lane count
    g = torch.Generator(device="cuda").manual_seed(n)
    P = torch.randn((max(BACKEND_PANEL_LANES), n, n), generator=g, dtype=torch.float64,
                    device="cuda")
    A = P @ P.mT / n
    A = 0.5 * (A + A.mT) + torch.eye(n, dtype=torch.float64, device="cuda")
    del P
    for lanes_n in BACKEND_PANEL_LANES:
        before = k8.syrk_update.launches
        L = panel_chol(A[:lanes_n])
        torch.cuda.synchronize()
        launched = k8.syrk_update.launches - before
        one = float((L[-1] - panel_chol(A[lanes_n - 1])).abs().max() / L[-1].abs().max())
        print(f"  panel_chol on {lanes_n} lane(s) of order {n}: K8 launches {launched} "
              f"(panel_update_shapes: {len(shapes)}); last lane against its 2-D call "
              f"{one:.2e}")
        check(launched == len(shapes), f"panel_chol on {lanes_n} lanes: {launched} K8 launches")
        check(one <= 1e-12, f"panel_chol lane against 2-D call: {one:.2e}")
    return err, timings, sums


def backend_ldl_check(torch, k2):
    """K2-batched on BACKEND_LDL_STACKS, float32 and float64, with the
    pivot floor (K2.5's float32 instance) and without: against the plain
    version at ldl_batched.TOL, equal pivot signs; timed beside the plain
    version and the bound.  Returns the timings."""
    timings = {}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        tol = k2.TOL[dname]
        for B, n in BACKEND_LDL_STACKS:
            F, sg = quasi_definite(torch, B, n, dtype, seed=7 * n + B)
            for fl in (0.0, 1e-6):
                s = sg if fl else None
                L, d = k2.ldl_lower_batched(F, s, fl)
                Lp, dp = k2.ldl_batched_reference(F, s, fl)
                eL, ed = ldl_errors(L, d, Lp, dp)
                signs = bool(torch.equal(torch.sign(d), torch.sign(dp)))
                check(eL <= tol and ed <= tol and signs,
                      f"K2 {dname} ({B}, {n}) floor {fl}: rel_err L {eL:.2e} d {ed:.2e} "
                      f"(tol {tol:g}), signs equal {signs}")
            t = {"kernel": cuda_median_ms(torch, lambda: k2.ldl_lower_batched(F)),
                 "plain": cuda_median_ms(torch, lambda: k2.ldl_batched_reference(F),
                                         runs=5, burst=1)}
            t["bound"], t["bound_by"] = ldl_bound_ms(B, n, F.element_size(), dname)
            timings[(dname, (B, n))] = t
            print(f"  K2 {dname} ({B}, {n}, {n}): rel_err L {eL:.2e} d {ed:.2e} (tol {tol:g}), "
                  f"pivot signs equal; ms: kernel {t['kernel']:.4f}, plain {t['plain']:.3f}, "
                  f"bound {t['bound']:.4f} ({t['bound_by']})", flush=True)
    return timings


def backends_phase(torch, mt, k1, k8, k2, ref):
    """Phase 19: every dense KKT backend of a single solve on a batch
    (BatchedMPCSolver), against the reference's batched_backends records:
    (a) batched-512 under condensed blocked, condensed inverse (dense and
    pallas), K2 and K2.5 with LU and with the blocked signed LDL^T; (b)
    the n = 500 headline QPs (seeds 0-3) under k2-blocked (K (4, 800, 800):
    seven K2-batched launches per trial) and condensed-blocked; (c) four
    random_qp(2000, 1000) under condensed-blocked (W (4, 2500, 2500): the
    panel Cholesky, len(panel_update_shapes(2500)) stacked K8 launches per
    trial of W).  Every lane's status, iterations (within 1) and objective
    (1e-8); the launches of each run read just after it.  Then K8's lane
    axis and K2-batched on the batch's stacks against their plain
    versions.  Returns (K1 launches, K8 launches, K2-batched launches,
    K8 float32 error, K8 timings, K8 sums, K2 timings)."""
    from madqp_tpu_torch.ops.blocked_dense import panel_update_shapes

    phase("19. dense KKT backends on a batch: batched-512 under seven backends, "
          "the n = 500 batch, 4 x random_qp(2000, 1000) blocked")
    t_phase = time.perf_counter()
    options = dict(BATCHED_OPTIONS, step_rule=mt.AdaptiveStep(0.995),
                   regularization=mt.FixedRegularization(1e-8, -1e-8))
    n1 = n8 = n2 = 0
    per_w = len(panel_update_shapes(BACKEND_PANEL_ORDER))
    for name, batch in ref["batched_backends"].items():
        t0 = time.perf_counter()
        qps = [getattr(mt, batch["generator"])(seed=s, **batch["kwargs"])
               for s in batch["seeds"]]
        built = time.perf_counter() - t0
        for run, want in batch["runs"].items():
            solver = mt.BatchedMPCSolver.from_problems(qps, device="cuda", **options,
                                                       **want["options"])
            reset_counts(k1, k8)
            t0 = time.perf_counter()
            stats = solver.solve_all()
            secs = time.perf_counter() - t0
            c1, c8, c2 = k1.cholesky_lower.launches, k8.syrk_update.launches, k2_launches()
            routes = dict(k1.cholesky_lower.routes)
            n1, n8, n2 = n1 + c1, n8 + c8, n2 + c2
            print(f"  {name} {run}: {len(qps)} lanes, solve {secs:.3f} s (problems built "
                  f"in {built:.3f} s); launches K1 {c1} {routes}, K8 {c8}, K2-batched {c2}",
                  flush=True)
            check_lanes(stats, want, f"{name} {run}")
            blocked = want["options"].get("linear_solver") == "blocked"
            k2sys = want["options"].get("kkt_system", "condensed") != "condensed"
            pallas = want["options"].get("linear_solver") == "pallas"
            check((c1 > 0) == pallas, f"{name} {run}: K1 launched {c1} times")
            if blocked and k2sys:
                check(c2 > 0 and c8 == 0, f"{name} {run}: K2 {c2}, K8 {c8}")
                if name == "n500x4":
                    check(c2 % 7 == 0, f"{name} {run}: {c2} K2 launches, not 7 per trial")
            elif not blocked:
                check(c2 == 0 and c8 == 0, f"{name} {run}: K2 {c2}, K8 {c8}")
            if name == "n2000x4":
                check(c8 > 0 and c8 % per_w == 0,
                      f"{name} {run}: {c8} K8 launches, not {per_w} per trial of W")
    print(f"  runs done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    k8_err, k8_times, k8_sums = backend_k8_check(torch, k8)
    k2_times = backend_ldl_check(torch, k2)
    print(f"  phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return n1, n8, n2, k8_err, k8_times, k8_sums, k2_times


# Phase 20: the sharded paths on a one-rank mesh.  With one rank every
# gather and sum is a copy, so each run must equal its unsharded phase's
# bit for bit: status, iterations and x of every instance.
def same_stats(got, want, label):
    """Status, iterations and solution of every instance bit-equal."""
    got, want = (v if isinstance(v, list) else [v] for v in (got, want))
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not (g.status == w.status and g.iter == w.iter
                   and np.array_equal(g.solution, w.solution))]
    check(len(got) == len(want) and not bad,
          f"{label}: {len(bad)} of {len(want)} instances differ from the unsharded run "
          f"(first {bad[:5]})")


def mesh_phase(torch, mt, k1, k8, k2, ref, unsharded):
    """Phase 20: a one-rank NCCL group and a one-rank DeviceMesh; phase
    10's batched-512 (pallas), phase 12's two_stage_1024 (pallas, float64)
    and phase 18's 16 x banded_sparse_lp(2000, 1000) (float64) through
    mesh=: each bit-equal to its phase's unsharded run, against its JAX
    record as that phase holds it, with that phase's K1 launches by route.
    Returns the K1 launches (single matrix, batched tiers) and K2-batched's."""
    import datetime
    import os
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    phase("20. one-rank mesh: batched-512, two_stage_1024 and the sparse batch through "
          "mesh= on a one-rank NCCL group, against their unsharded runs")
    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                      WORLD_SIZE="1")
    dist.init_process_group("nccl", timeout=datetime.timedelta(seconds=300))
    single = batched = ldl = 0
    try:
        mesh = {axis: init_device_mesh("cuda", (1,), mesh_dim_names=(axis,))
                for axis in ("batch", "scen")}
        print(f"  NCCL {torch.cuda.nccl.version()}, group of one "
              f"up in {time.perf_counter() - t_phase:.2f} s", flush=True)

        def run(label, fn, want_routes, want_stats):
            reset_counts(k1, k8)
            t0 = time.perf_counter()
            out = fn()
            wall = time.perf_counter() - t0
            routes = dict(k1.cholesky_lower.routes)
            n2 = k2.ldl_lower_batched.launches
            same_stats(out, want_stats, f"mesh {label}")
            check(routes == want_routes, f"mesh {label}: K1 routes {routes}, the unsharded "
                                         f"run's {want_routes}")
            check(k8.syrk_update.launches == 0, f"mesh {label} launched K8")
            print(f"  {label}: bit-equal to the unsharded run; {wall:.3f} s; K1 launches "
                  f"{routes}, K2-batched {n2}", flush=True)
            return out, routes, n2

        qps = [mt.dense_dummy_qp(32, 16, seed=i) for i in range(BATCH)]
        options = dict(BATCHED_OPTIONS, step_rule=mt.AdaptiveStep(0.995),
                       regularization=mt.FixedRegularization(1e-8, -1e-8),
                       linear_solver="pallas")
        want, want_routes = unsharded["batched512"]
        stats, routes, n2 = run("batched512 pallas", lambda: mt.solve_batched(
            qps, mesh=mesh["batch"], device="cuda", **options), want_routes, want)
        check_lanes(stats, ref["batched512"], "mesh batched512 pallas")
        batched += sum(routes.values())
        ldl += n2

        entry = ref["two_stage_1024"]
        prob, lb, ub = mt.random_two_stage(**entry["problem"], device="cuda")
        want, want_routes = unsharded["two_stage"]
        rec = entry["solves"]["pallas"]
        st, routes, n2 = run("two_stage_1024 pallas", lambda: mt.solve_two_stage(
            prob, lb, ub, mesh=mesh["scen"], device="cuda", print_level=40,
            **rec["options"]), want_routes, want)
        x0_err = float(np.abs(st.solution[:prob.n0] - np.asarray(rec["x0"])).max())
        check(int(st.status) == rec["status"] and st.iter == rec["iter"]
              and rel_err(st.objective, rec["objective"]) <= 1e-8 and x0_err <= 1e-7,
              f"mesh two_stage_1024: {st.status.name} iter {st.iter} (ref {rec['iter']}), "
              f"x0 off by {x0_err:.2e}")
        single += routes.get("single", 0)
        batched += sum(routes.values()) - routes.get("single", 0)
        ldl += n2
        del prob, lb, ub

        sb = ref["sparse_batched"]["bandedlp_f64"]
        want, want_routes, _ = unsharded["bandedlp_f64"]
        res, routes, n2 = run("16 x banded_sparse_lp(2000, 1000) float64", lambda:
                              mt.solve_sparse_batched(sparse_batch_problems(mt, sb),
                                                      mesh=mesh["batch"], device="cuda",
                                                      **sb["options"]),
                              want_routes, want)
        bad = [i for i, r in enumerate(res)
               if not (int(r.status) == sb["status"][i] and r.iter == sb["iter"][i]
                       and rel_err(r.objective, sb["objective"][i]) <= 1e-8)]
        check(not bad, f"mesh sparse batch: lanes {bad} off the reference")
        batched += sum(routes.values())
        ldl += n2
    finally:
        dist.destroy_process_group()
    secs = time.perf_counter() - t_phase
    print(f"  phase 20 took {secs:.1f} s", flush=True)
    return single, batched, ldl


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--save-fronts", metavar="DIR",
                        help="save the front stacks phase 17 captures to DIR/<member>.pt "
                             "(tools/ldl_times_torch.py --stacks times them)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import madqp_tpu_torch as mt
    from madqp_tpu_torch.ops import ldl_batched as k2
    from madqp_tpu_torch.ops import pallas_chol as k1
    from madqp_tpu_torch.ops import syrk as k8

    ref_path = Path(mt.__file__).resolve().parent / "testdata" / "jax_reference.json"
    ref = json.loads(ref_path.read_text())

    name, smi = device_phase(torch)
    k2_occupancy = build_phase(torch, k1, k8, k2)
    k1_err, k1_times = kernel_phase(torch, k1)
    k1_launches, k1_fact = main_path_phase(mt, k1, k8, ref)
    large_phase(mt, k1, ref)
    # the largest normal matrix phase 15 factors (rows after presolve)
    normal_m = max(rec["m"] for rec in ref["host_xlarge"].values())
    k8_err, k8_times = syrk_phase(torch, k8, normal_m)
    k8_launches, k8_fact, blocked_ldl = blocked_phase(torch, mt, k1, k8, ref)
    variants_ldl = variants_phase(mt, k1, k8, ref)
    kb_err, kl_err, kb_times = batched_kernel_phase(torch, k1)
    unsharded = {}   # phases 10, 12 and 18's runs, which phase 20 repeats on a mesh
    kb_launches, kl_launches = batched_path_phase(torch, mt, k1, k8, ref, unsharded)
    layer_phase(torch, mt, k1, k8, ref)
    ts_single, ts_batched = two_stage_phase(torch, mt, k1, k8, ref, unsharded)
    pipe_launches = pipeline_phase(mt, k1, k8, ref, smi)
    host_phase(torch, mt, k1, k8, ref, smi)
    sparse_launches, sparse_ldl = sparse_phase(torch, mt, k1, k8, ref, smi)
    sn_batched, sn_lanes, sn_ldl, _, _ = supernodal_phase(torch, mt, k1, k8, ref, smi)
    k2_err, k2_times = ldl_kernel_phase(torch, k2)
    qp_ldl, qp_batched, qp_lanes, _ = sparse_qp_phase(torch, mt, k1, k8, k2, ref, smi,
                                                      args.save_fronts)
    sb_batched, sb_ldl = sparse_batch_phase(torch, mt, k1, k8, k2, ref, smi, unsharded)
    bk_k1, bk_k8, bk_ldl, *_ = backends_phase(torch, mt, k1, k8, k2, ref)
    mesh_single, mesh_batched, mesh_ldl = mesh_phase(torch, mt, k1, k8, k2, ref, unsharded)

    t600 = k1_times[("float32", 600)]
    t8 = k8_times[("float32", (3840, 1792, 256))]
    tb = kb_times[("float32", (512, 42))]
    tl = kb_times[("float32", (4, 600))]
    t2 = k2_times[("float64", (128, 128))]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "cholesky_lower",
        "route": "cuda",
        "source": "madqp_tpu_torch/csrc/cholesky.cu",
        "replaces": "madqp_tpu/ops/pallas_chol.py:158",
        "launches": k1_launches + ts_single + pipe_launches + mesh_single,
        "max_abs_err": k1_err,
        "ms": t600["kernel"],
        "plain_ms": t600["plain"],
        "bound_ms": t600["bound"],
        "bound_by": t600["bound_by"],
        "library_ms": t600["torch.linalg.cholesky"],
    }, {
        "name": "syrk_update",
        "route": "cuda",
        "source": "madqp_tpu_torch/csrc/syrk.cu",
        "replaces": "benchmarks/exp_pallas_rl_chol.py:120",
        "launches": k8_launches + sparse_launches + bk_k8,
        "max_abs_err": k8_err,
        "ms": t8["kernel"],
        "plain_ms": t8["plain"],
        "bound_ms": t8["bound"],
        "bound_by": t8["bound_by"],
        "library_ms": t8["torch.addmm"],
    }, {
        "name": "K1-batched",
        "route": "cuda",
        "source": "madqp_tpu_torch/csrc/cholesky_batched.cu",
        "replaces": "madqp_tpu/ops/pallas_chol.py:158",
        "launches": (kb_launches + ts_batched + sn_batched + qp_batched + sb_batched + bk_k1
                     + mesh_batched),
        "max_abs_err": kb_err,
        "ms": tb["kernel"],
        "plain_ms": tb["plain"],
        "bound_ms": tb["bound"],
        "bound_by": tb["bound_by"],
        "library_ms": tb["torch.linalg.cholesky_ex"],
    }, {
        "name": "K1-lanes",
        "route": "cuda",
        "source": "madqp_tpu_torch/csrc/cholesky.cu",
        "replaces": "madqp_tpu/ops/pallas_chol.py:158",
        "launches": kl_launches + sn_lanes + qp_lanes,
        "max_abs_err": kl_err,
        "ms": tl["kernel"],
        "plain_ms": tl["plain"],
        "bound_ms": tl["bound"],
        "bound_by": tl["bound_by"],
        "library_ms": tl["torch.linalg.cholesky_ex"],
    }, {
        "name": "K2-batched",
        "route": "cuda",
        "source": "madqp_tpu_torch/csrc/ldl_batched.cu",
        "replaces": "madqp_tpu/ops/blocked_dense.py:37 via madqp_tpu/ops/sparse_chol.py:1306",
        "launches": (blocked_ldl + variants_ldl + sparse_ldl + sn_ldl + qp_ldl + sb_ldl
                     + bk_ldl + mesh_ldl),
        "max_abs_err": k2_err,
        "ms": t2["kernel"],
        "plain_ms": t2["plain"],
        "bound_ms": t2["bound"],
        "bound_by": t2["bound_by"],
        "library_ms": None,
        "occupancy": k2_occupancy,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
