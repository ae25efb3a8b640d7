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
  3. K1       K1 against its plain PyTorch version in float32 and float64
              at n in SIZES (factor error relative to max|L| <= 1e-5 /
              1e-12, reconstruction residual, the NaN contract on a non-SPD
              input, two runs bit-equal), and CUDA-event timings of the
              kernel, the plain version and torch.linalg.cholesky at
              TIMED_SIZES;
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
              BATCHED_SHAPES in float32 and float64 (phase 3's
              tolerances per matrix; one non-SPD matrix gives NaN on its
              own diagonal only and leaves the others' factors bit-equal;
              two runs bit-equal; above the shared-memory limit n_max the
              persistent kernel runs once per matrix), and CUDA-event
              timings of the kernel, the plain version and
              torch.linalg.cholesky_ex on the stack at BATCHED_TIMED;
 10. batched  solve_batched on 512 x dense_dummy_qp(32, 16, seed=i) with
              bench.py's batched options and endgame="f64", through
              linear_solver="pallas" (K1 one CTA per matrix: two launches
              per factorization trial of the whole batch, W and S) and
              "dense": every lane's status, iterations and objective
              against the reference's batched512 entry, and instances/s;
              then the four n = 500 headline QPs as one batch with
              "pallas" (W 600^2 above n_max: the persistent kernel once per
              lane) against the n500 entries;
 11. layer    qp_layer on a batch of 64 random QPs (n = 32, m = 8) in
              float64, forward and backward, with "pallas" and "dense":
              gradients of all six inputs for four lanes against the
              reference's qp_layer64 entry.

Every launch counter is set to 0 just before each solve phase and read
just after it.  The line before the last is a JSON object describing the
kernels (times at the shape the path runs most: K1 at n = 600 float32, K8
at (3840, 1792, 256) float32, the first and largest in-stripe update of
the blocked cell's W, batched K1 at (512, 42) float32, W of the batched
cell); the last line is {"ok": true, "device": {...}}.
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

TOL_FACTOR = {"float32": 1e-5, "float64": 1e-12}    # max|L - L_plain| / max|L_plain|
TOL_RESIDUAL = {"float32": 1e-4, "float64": 1e-12}  # ||L L^T - A||_F / ||A||_F
SIZES = (1, 37, 63, 64, 65, 129, 200, 600, 1000, 2500)
TIMED_SIZES = (200, 600, 1000, 2500)
DETERMINISM_SIZES = (600, 2500)
MAIN_SHAPES = (200, 600)  # S and W of the n=500 headline problem
TIMING_RUNS = 20
BURST = 5  # calls per timed sample
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
# Batched K1 (B, n): the batched cell's W and S, ragged block edges, the
# largest order one CTA holds ("max") and the first it does not, and W of
# the n = 500 QP (above the limit).
BATCHED_SHAPES = ((512, 42), (512, 16), (64, 1), (64, 63), (64, 64), (64, 65),
                  (16, "max"), (16, "max+1"), (4, 600))
BATCHED_TIMED = ((512, 42), (512, 16), (4, 600))
BATCH = 512
BATCHED_OPTIONS = dict(tol=1e-8, print_level=40, factorization_dtype="float32",
                       max_refine_steps=1, endgame="f64")  # + the step rule
LAYER = dict(lanes=64, n=32, m=8, tol=1e-10)  # qp_layer batch of phase 11


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
    a burst of back-to-back calls between two CUDA events, so the host's
    time to issue a call hides behind the previous call's run."""
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def kernel_phase(torch, k1):
    phase("3. K1 against plain version")
    main_err, timings = 0.0, {}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for n in SIZES:
            A = spd_matrix(torch, n, dtype, seed=n)
            L = k1.cholesky_lower(A)
            Lp = k1.cholesky_lower_reference(A)
            torch.cuda.synchronize()
            abs_err = float((L - Lp).abs().max())
            rel = abs_err / float(Lp.abs().max())
            A64, L64 = A.double(), L.double()
            resid = float(torch.linalg.norm(L64 @ L64.T - A64) / torch.linalg.norm(A64))
            upper_zero = bool((torch.triu(L, 1) == 0).all())
            # Non-SPD input: a negative diagonal entry midway.
            B = A.clone()
            B[n // 2, n // 2] = -1.0
            Lb, Lbp = k1.cholesky_lower(B), k1.cholesky_lower_reference(B)
            nan_same = bool((torch.isnan(torch.diagonal(Lb))
                             == torch.isnan(torch.diagonal(Lbp))).all())
            bad_ok = (factor_ok(torch, Lb), factor_ok(torch, Lbp))
            same = (bool(torch.equal(L, k1.cholesky_lower(A)))
                    if n in DETERMINISM_SIZES else True)
            print(f"{dname} n={n}: rel_err={rel:.3e} (tol {TOL_FACTOR[dname]:g}) "
                  f"max_abs_err={abs_err:.3e} resid={resid:.3e} "
                  f"non-SPD factor_ok kernel/plain={bad_ok} nan_diag_same={nan_same}"
                  + (f" rerun_bit_equal={same}" if n in DETERMINISM_SIZES else ""))
            check(same, f"{dname} n={n}: two runs differ")
            check(rel <= TOL_FACTOR[dname], f"{dname} n={n}: kernel differs from plain")
            check(resid <= TOL_RESIDUAL[dname], f"{dname} n={n}: residual {resid:.3e}")
            check(upper_zero, f"{dname} n={n}: strict upper triangle not zero")
            check(bad_ok == (False, False) and nan_same,
                  f"{dname} n={n}: non-SPD contract broken")
            if dname == "float32" and n in MAIN_SHAPES:
                main_err = max(main_err, abs_err)
            if n in TIMED_SIZES:
                t = {
                    "kernel": cuda_median_ms(torch, lambda: k1.cholesky_lower(A)),
                    # a Python loop over columns, ~0.1-0.4 s a call: fewer samples
                    "plain": cuda_median_ms(
                        torch, lambda: k1.cholesky_lower_reference(A), runs=5, burst=1),
                    "torch.linalg.cholesky": cuda_median_ms(
                        torch, lambda: torch.linalg.cholesky(A)),
                }
                t["bound"], t["bound_by"] = chol_bound_ms(1, n, A.element_size(), dname)
                timings[(dname, n)] = t
                print(f"  time {dname} n={n} (median of {TIMING_RUNS} bursts of {BURST}, ms): "
                      + ", ".join(f"{k}={v:.4f}" for k, v in t.items()
                                  if k != "bound_by") + f" ({t['bound_by']}); "
                      f"kernel/library {t['kernel'] / t['torch.linalg.cholesky']:.2f}")
    return main_err, timings


def reset_counts(k1, k8):
    """Set every kernel's launch counter to 0 (just before a solve phase)."""
    k1.cholesky_lower.launches = 0
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
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((batch, n, n))
    A = P @ P.transpose(0, 2, 1) / max(n, 1) + np.eye(n)
    return torch.as_tensor(A, dtype=dtype, device="cuda")


def batched_kernel_phase(torch, k1):
    phase("9. batched K1 against plain version")
    main_err, timings = 0.0, {}
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        n_max = k1.batched_max_n(dtype, "cuda")
        print(f"{dname}: one CTA holds n <= {n_max} (the card's opt-in shared memory)")
        for batch, n in BATCHED_SHAPES:
            if not isinstance(n, int):
                n = n_max + (n == "max+1")
            A = spd_stack(torch, batch, n, dtype, seed=n)
            before = k1.cholesky_lower.launches
            L = k1.cholesky_lower(A)
            launched = k1.cholesky_lower.launches - before
            Lp = k1.cholesky_lower_reference(A)
            torch.cuda.synchronize()
            diff = (L - Lp).abs()
            abs_err = float(diff.max())
            rel = float((diff.amax(dim=(1, 2)) / Lp.abs().amax(dim=(1, 2))).max())
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
            Lb, Lbp = k1.cholesky_lower(B), k1.cholesky_lower_reference(B)
            d, dp = (torch.diagonal(M, dim1=1, dim2=2) for M in (Lb, Lbp))
            lanes_ok = torch.arange(batch, device="cuda") != bad
            contract = (bool(torch.equal((torch.isfinite(d) & (d > 0)).all(1), lanes_ok))
                        and bool(torch.equal((torch.isfinite(dp) & (dp > 0)).all(1), lanes_ok))
                        and bool(torch.equal(torch.isnan(d), torch.isnan(dp)))
                        and bool(torch.equal(Lb[lanes_ok], L[lanes_ok])))
            expect = 1 if n <= n_max else batch
            print(f"{dname} (B, n)=({batch}, {n}): rel_err={rel:.3e} (tol "
                  f"{TOL_FACTOR[dname]:g}) max_abs_err={abs_err:.3e} resid={resid:.3e} "
                  f"launches={launched} rerun_bit_equal={same} one_bad_lane_contract={contract}")
            check(launched == expect, f"{dname} {(batch, n)}: {launched} launches, not {expect}")
            check(same, f"{dname} {(batch, n)}: two runs differ")
            check(rel <= TOL_FACTOR[dname], f"{dname} {(batch, n)}: kernel differs from plain")
            check(resid <= TOL_RESIDUAL[dname], f"{dname} {(batch, n)}: residual {resid:.3e}")
            check(upper_zero, f"{dname} {(batch, n)}: strict upper triangle not zero")
            check(contract, f"{dname} {(batch, n)}: per-lane non-SPD contract broken")
            if dname == "float32" and (batch, n) in ((512, 42), (512, 16)):
                main_err = max(main_err, abs_err)
            if (batch, n) in BATCHED_TIMED:
                t = {
                    "kernel": cuda_median_ms(torch, lambda: k1.cholesky_lower(A)),
                    # a Python loop over columns: fewer samples
                    "plain": cuda_median_ms(
                        torch, lambda: k1.cholesky_lower_reference(A), runs=5, burst=1),
                    "torch.linalg.cholesky_ex": cuda_median_ms(
                        torch, lambda: torch.linalg.cholesky_ex(A)),
                }
                t["bound"], t["bound_by"] = chol_bound_ms(
                    batch, n, A.element_size(), dname)
                timings[(dname, (batch, n))] = t
                print(f"  time {dname} (B, n)=({batch}, {n}) (median of {TIMING_RUNS} "
                      f"bursts of {BURST}, ms): "
                      + ", ".join(f"{k}={v:.4f}" for k, v in t.items() if k != "bound_by")
                      + f" ({t['bound_by']}); kernel/library "
                      f"{t['kernel'] / t['torch.linalg.cholesky_ex']:.2f}")
    return main_err, timings


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
        check(k8.syrk_update.launches == 0, f"batched {backend} launched K8")
        check_lanes(stats, ref["batched512"], f"batched512 {backend}")
        t0 = time.perf_counter()
        solver.solve_batch()
        warm = time.perf_counter() - t0
        top = max(st.iter for st in stats)
        print(f"  {backend}: K1 launches {n} (lanes up to {top} iterations; two per "
              f"factorization trial of the batch); first solve {first:.3f} s, warm "
              f"solve {warm:.3f} s: {BATCH / warm:.1f} instances/s")
        if backend == "pallas":
            check(n % 2 == 0 and n >= 2 * (top + 1), f"batched K1 launched {n} times")
            launches = n
        else:
            check(n == 0, "the dense batched solve launched K1")

    # The n = 500 headline QPs as one batch: W 600^2 is above the one-CTA
    # limit, so K1 runs the persistent kernel once per lane.
    reset_counts(k1, k8)
    stats = mt.solve_batched(
        [mt.random_qp(500, 200, seed=s, ineq=True) for s in range(4)], device="cuda",
        step_rule=mt.AdaptiveStep(0.995),
        regularization=mt.FixedRegularization(1e-8, -1e-8),
        linear_solver="pallas", **SOLVE_OPTIONS)
    want = {key: [ref["n500"][str(s)][key] for s in range(4)]
            for key in ("status", "iter", "objective")}
    check_lanes(stats, want, "n500 x 4 pallas")
    print(f"  K1 launches {k1.cholesky_lower.launches} "
          f"(iterations {[st.iter for st in stats]})")
    check(k1.cholesky_lower.launches > 0, "the n = 500 batch launched no K1")
    return launches


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
    kb_err, kb_times = batched_kernel_phase(torch, k1)
    kb_launches = batched_path_phase(torch, mt, k1, k8, ref)
    layer_phase(torch, mt, k1, k8, ref)

    t600 = k1_times[("float32", 600)]
    t8 = k8_times[("float32", (3840, 1792, 256))]
    tb = kb_times[("float32", (512, 42))]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "cholesky_lower",
        "route": "cuda",
        "source": "madqp_tpu_torch/csrc/cholesky.cu",
        "replaces": "madqp_tpu/ops/pallas_chol.py:158",
        "launches": k1_launches,
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
        "launches": kb_launches,
        "max_abs_err": kb_err,
        "ms": tb["kernel"],
        "plain_ms": tb["plain"],
        "bound_ms": tb["bound"],
        "bound_by": tb["bound_by"],
        "library_ms": tb["torch.linalg.cholesky_ex"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
