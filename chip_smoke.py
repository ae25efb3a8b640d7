#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. device   print the card's name and power limit; pin TF32 off;
  2. build    compile the K1 Cholesky and K8 rank-k update kernels from
              madqp_tpu_torch/csrc/, one nvcc per source, in parallel; print
              ptxas's registers, stack and spills per kernel (their shared
              memory is dynamic, set by each source's smem_bytes) and
              count the FP64 tensor-core instructions (DMMA) in each
              library's SASS, which must be there (the float64 tile product);
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
              K2.5 with the signed blocked LDL^T); these launch no K8.

Every launch counter is set to 0 just before each solve phase and read
just after it.  The line before the last is a JSON object describing the
kernels (times at the shape the path runs most: K1 at n = 600 float32, K8
at (3840, 1792, 256) float32, the first and largest in-stripe update of
the blocked cell's W); the last line is {"ok": true, "device": {...}}.
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


def build_phase(kernels):
    phase("2. build")
    from madqp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        paths = list(pool.map(lambda k: k.build_library(), kernels))
    for k in kernels:
        k._library()
    print(f"built {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s")
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    for k, path in zip(kernels, paths):
        # ptxas's report: "Compiling entry function '<mangled>'" then
        # "Function properties" (stack, spills) and "Used N registers".
        name = None
        for line in _build.build_log(k.SOURCE).splitlines():
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
            check(dmma > 0, f"{path.name}: the float64 path has no DMMA")
        else:
            print(f"  {path.name}: no cuobjdump beside nvcc; SASS not read")


def bound_ms(flops, nbytes, dname):
    """Least time for the work on the card, and what sets it."""
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
                # n^3/3 operations; A read once, L written once
                t["bound"], t["bound_by"] = bound_ms(
                    n ** 3 / 3, 2 * n * n * A.element_size(), dname)
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
    build_phase((k1, k8))
    k1_err, k1_times = kernel_phase(torch, k1)
    k1_launches, k1_fact = main_path_phase(mt, k1, k8, ref)
    large_phase(mt, k1, ref)
    k8_err, k8_times = syrk_phase(torch, k8)
    k8_launches, k8_fact = blocked_phase(torch, mt, k1, k8, ref)
    variants_phase(mt, k1, k8, ref)

    t600 = k1_times[("float32", 600)]
    k1_bound, k1_by = bound_ms(600.0 ** 3 / 3, 2 * 600 * 600 * 4, "float32")
    t8 = k8_times[("float32", (3840, 1792, 256))]
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
        "bound_ms": k1_bound,
        "bound_by": k1_by,
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
