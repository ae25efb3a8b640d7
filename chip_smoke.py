#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. device   print the card's name and power limit; pin TF32 off;
  2. build    compile the K1 Cholesky (single-matrix and batched) and K8
              rank-k update kernels from madqp_tpu_torch/csrc/, one nvcc
              per source, in parallel; print ptxas's registers, stack and
              spills per kernel (their shared memory is dynamic, set by
              each source's smem_bytes) and count the FP64 tensor-core
              instructions (DMMA) in each library's SASS, which must be
              there in the two that hold the tile product (float64);
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
              K2.5 with the signed blocked LDL^T); these launch no K8;
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
              the tier's totals.

Every launch counter is set to 0 just before each solve phase and read
just after it.  The line before the last is a JSON object describing the
kernels (times at the shape the path runs most: K1 at n = 600 float32, K8
at (3840, 1792, 256) float32, the first and largest in-stripe update of
the blocked cell's W, batched K1 at (512, 42) float32, W of the batched
cell, and the persistent K1 with a lane axis at (4, 600) float32, W of the
n = 500 batch; the launches of K1 include phase 12's and phase 13's, those of
K1-batched phase 12's);
the last line is {"ok": true, "device": {...}}.
Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result.
"""

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
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense) for the
# bounds: float32 on the CUDA cores (TF32 would lose the accuracy the
# factorization needs); float64 on the FP64 tensor cores, which cuBLAS
# uses (the 34 TFLOP/s of the FP64 CUDA cores is no lower bound:
# torch.addmm beats it).
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
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


def phase(name):
    print(f"== {name}", flush=True)


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


def build_phase(k1, k8):
    phase("2. build")
    from madqp_tpu_torch.ops import _build

    # (source, loader, holds the tile product, so DMMA in float64)
    libs = ((k1.SOURCE, k1._library, True),
            (k1.SOURCE_BATCHED, k1._batched_library, False),
            (k8.SOURCE, k8._library, True))
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


def bound_ms(flops, nbytes, dname):
    """Least time for the work on the card, and what sets it."""
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chol_bound_ms(batch, n, element_size, dname):
    """Bound of `batch` Cholesky factors of order n: B n^3/3 operations;
    each lower triangle read once (all a symmetric input needs) and each
    factor, its zero upper triangle included, written once."""
    return bound_ms(batch * n ** 3 / 3,
                    batch * (n * (n + 1) // 2 + n * n) * element_size, dname)


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
    k1.cholesky_lower.launches = 0
    k1.cholesky_lower.routes.clear()
    k8.syrk_update.launches = 0


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


def syrk_phase(torch, k8):
    from madqp_tpu_torch.ops.blocked_dense import panel_update_shapes

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
        need = sum(k8.syrk_ops(*shape) for shape in shapes)
        issued = sum(k8.syrk_tile_ops(*shape) for shape in shapes)
        bound, by = bound_ms(need, 0.0, dname)
        print(f"  {dname} one factorization trial ({len(shapes)} launches): "
              f"kernel {trial:.4f} ms summed over medians, bound {bound:.4f} ms "
              f"({by}); {need / 1e9:.2f} GFLOP needed, {issued / 1e9:.2f} "
              f"GFLOP issued by the tiles, {need / trial / 1e9:.2f} TFLOP/s")
        timings[(dname, "trial")] = {"kernel": trial, "bound": bound}
    return path_err, timings


def time_syrk(torch, k8, C, B, dname):
    """Median ms of the kernel (into a preallocated out, so the inputs stay
    the same), the plain version and torch.addmm, and the bound."""
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
    ops = k8.syrk_ops(r, c, k)
    t["bound"], t["bound_by"] = bound_ms(
        ops, (2 * r * c + r * k) * C.element_size(), dname)
    print(f"  time {dname} {(r, c, k)} (median of {TIMING_RUNS} bursts of {BURST}, ms): "
          + ", ".join(f"{key}={v:.4f}" for key, v in t.items() if key != "bound_by")
          + f" ({t['bound_by']}); {ops / 1e9:.3f} GFLOP needed, kernel "
            f"{ops / t['kernel'] / 1e9:.2f} TFLOP/s of them, "
            f"kernel/addmm {t['kernel'] / t['torch.addmm']:.2f}")
    return t


def blocked_phase(torch, mt, k1, k8, ref):
    from madqp_tpu_torch.ops.blocked_dense import panel_update_shapes
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
    need = sum(k8.syrk_ops(*shape) for shape in shapes)
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
    return launches, fact


def variants_phase(mt, k1, k8, ref):
    phase("8. dense KKT variants: random_qp(500, 200, seed=0)")
    reset_counts(k1, k8)
    for name, want in ref["n500_variants"].items():
        solve_checked(mt, mt.random_qp(500, 200, seed=0, ineq=True), want,
                      iter_slack=1, **want["options"])
    check(k8.syrk_update.launches == 0, "an n = 500 variant launched K8")


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


def batched_path_phase(torch, mt, k1, k8, ref):
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


def two_stage_phase(torch, mt, k1, k8, ref):
    """Phase 12: solve_two_stage on the reference's two-stage problem under
    each of its option sets; returns the K1 launches of its pallas solves
    by source (the persistent kernel's, the batched kernels')."""
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import madqp_tpu_torch as mt
    from madqp_tpu_torch.ops import pallas_chol as k1
    from madqp_tpu_torch.ops import syrk as k8

    ref_path = Path(mt.__file__).resolve().parent / "testdata" / "jax_reference.json"
    ref = json.loads(ref_path.read_text())

    name, smi = device_phase(torch)
    build_phase(k1, k8)
    k1_err, k1_times = kernel_phase(torch, k1)
    k1_launches, k1_fact = main_path_phase(mt, k1, k8, ref)
    large_phase(mt, k1, ref)
    k8_err, k8_times = syrk_phase(torch, k8)
    k8_launches, k8_fact = blocked_phase(torch, mt, k1, k8, ref)
    variants_phase(mt, k1, k8, ref)
    kb_err, kl_err, kb_times = batched_kernel_phase(torch, k1)
    kb_launches, kl_launches = batched_path_phase(torch, mt, k1, k8, ref)
    layer_phase(torch, mt, k1, k8, ref)
    ts_single, ts_batched = two_stage_phase(torch, mt, k1, k8, ref)
    pipe_launches = pipeline_phase(mt, k1, k8, ref, smi)

    t600 = k1_times[("float32", 600)]
    t8 = k8_times[("float32", (3840, 1792, 256))]
    tb = kb_times[("float32", (512, 42))]
    tl = kb_times[("float32", (4, 600))]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "cholesky_lower",
        "route": "cuda",
        "source": "madqp_tpu_torch/csrc/cholesky.cu",
        "replaces": "madqp_tpu/ops/pallas_chol.py:158",
        "launches": k1_launches + ts_single + pipe_launches,
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
        "launches": k8_launches,
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
        "launches": kb_launches + ts_batched,
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
        "launches": kl_launches,
        "max_abs_err": kl_err,
        "ms": tl["kernel"],
        "plain_ms": tl["plain"],
        "bound_ms": tl["bound"],
        "bound_by": tl["bound_by"],
        "library_ms": tl["torch.linalg.cholesky_ex"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
