#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. device   print the card's name and power limit; pin TF32 off;
  2. build    compile the K1 Cholesky and K8 rank-k update kernels from
              madqp_tpu_torch/csrc/, one nvcc per source, in parallel;
  3. K1       K1 against its plain PyTorch version in float32 and float64
              at n in {1, 37, 64, 200, 600, 2500} (factor error relative to
              max|L| <= 1e-5 / 1e-12, reconstruction residual, the NaN
              contract on a non-SPD input), and CUDA-event timings of the
              kernel, the plain version and torch.linalg.cholesky;
  4. main     madqp_tpu_torch.solve on random_qp(500, 200, seed) for seeds
              0-3 with the headline benchmark's options and
              linear_solver="pallas": status, iteration count and objective
              against madqp_tpu_torch/testdata/jax_reference.json, and the
              K1 launch count; seed 0 once more with linear_solver="dense";
  5. large    random_qp(2000, 1000) (W is 2500 x 2500), same checks;
  6. K8       K8 against its plain version in float32 and float64 at the
              shapes of SYRK_SHAPES (max|out - plain| / max|plain| <= 1e-5 /
              1e-12; a NaN in one row of B gives NaN in the same places in
              both), and CUDA-event timings of the kernel, the plain
              version and torch.addmm at the blocked path's shapes
              (SYRK_PATH), beside the bound of the work the update
              needs (syrk_ops);
  7. blocked  madqp_tpu_torch.autosolve on random_qp(2000, 1000): bucketing
              pads it to W 4096 x 4096 and S 1024 x 1024 and picks
              linear_solver="blocked", whose panel Cholesky runs K8 for
              every trailing update (21 launches per factorization trial);
              checked against the reference's autosolve_n2000 entry;
  8. variants random_qp(500, 200, seed=0) with each dense KKT variant of
              the reference's n500_variants (blocked, inverse, K2 with LU,
              K2.5 with the signed blocked LDL^T); these launch no K8.

Every launch counter is set to 0 just before each solve phase and read
just after it.  The line before the last is a JSON object describing the
kernels (times at the shape the path runs most: K1 at n = 600 float32, K8
at (4096, 2048, 256) float32); the last line is {"ok": true, "device":
{...}}.  Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.
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
SIZES = (1, 37, 64, 200, 600, 2500)
TIMED_SIZES = (200, 600, 2500)
MAIN_SHAPES = (200, 600)  # S and W of the n=500 headline problem
TIMING_RUNS = 20
SOLVE_OPTIONS = dict(tol=1e-8, max_ncorr=0, factorization_dtype="float32",
                     max_refine_steps=1, print_level=40)
# K8 (r, c, k): ragged and rectangular edges; the blocked path's shapes
# (S 1024: in-stripe; W 4096: two stripes of 2048, in-stripe, cross-stripe
# and second-stripe updates); a multi-stripe in-stripe update of a 2304
# matrix and its cross-stripe update.
SYRK_SHAPES = ((1, 1, 1), (37, 37, 5), (300, 200, 40), (1024, 1024, 256),
               (2048, 2048, 256), (4096, 2048, 256), (2048, 2048, 2048),
               (2304, 2048, 256), (256, 256, 2048))
# The shapes the blocked path runs, timed and giving max_abs_err.
SYRK_PATH = ((1024, 1024, 256), (2048, 2048, 256), (4096, 2048, 256),
             (2048, 2048, 2048))
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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        paths = list(pool.map(lambda k: k.build_library(), kernels))
    for k in kernels:
        k._library()
    print(f"built {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s")


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


def cuda_median_ms(torch, fn, runs=TIMING_RUNS):
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
            print(f"{dname} n={n}: rel_err={rel:.3e} (tol {TOL_FACTOR[dname]:g}) "
                  f"max_abs_err={abs_err:.3e} resid={resid:.3e} "
                  f"non-SPD factor_ok kernel/plain={bad_ok} nan_diag_same={nan_same}")
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
                    "plain": cuda_median_ms(torch, lambda: k1.cholesky_lower_reference(A)),
                    "torch.linalg.cholesky": cuda_median_ms(
                        torch, lambda: torch.linalg.cholesky(A)),
                }
                # n^3/3 operations; A read once, L written once
                t["bound"], t["bound_by"] = bound_ms(
                    n ** 3 / 3, 2 * n * n * A.element_size(), dname)
                timings[(dname, n)] = t
                print(f"  time {dname} n={n} (median of {TIMING_RUNS}, ms): "
                      + ", ".join(f"{k}={v:.4f}" for k, v in t.items()
                                  if k != "bound_by") + f" ({t['bound_by']})")
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


def syrk_phase(torch, k8):
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
                  f"(tol {SYRK_TOL[dname]:g}) max_abs_err={abs_err:.3e} "
                  f"nan_contract={nan_ok}")
            check(rel <= SYRK_TOL[dname], f"K8 {dname} {(r, c, k)} differs from plain")
            check(nan_ok, f"K8 {dname} {(r, c, k)}: NaN contract broken")
            if dname == "float32" and (r, c, k) in SYRK_PATH:
                path_err = max(path_err, abs_err)
            if (r, c, k) in SYRK_PATH:
                Bc = B[:c].T
                t = {
                    "kernel": cuda_median_ms(torch, lambda: k8.syrk_update(C, B)),
                    "plain": cuda_median_ms(
                        torch, lambda: k8.syrk_update_reference(C, B)),
                    "torch.addmm": cuda_median_ms(
                        torch, lambda: torch.addmm(C, B, Bc, beta=1, alpha=-1)),
                }
                ops = syrk_ops(r, c, k)
                bound, by = bound_ms(ops, (2 * r * c + r * k) * C.element_size(),
                                     dname)
                t["bound"], t["bound_by"] = bound, by
                timings[(dname, (r, c, k))] = t
                print(f"  time {dname} {(r, c, k)} (median of {TIMING_RUNS}, ms): "
                      + ", ".join(f"{key}={v:.4f}" for key, v in t.items()
                                  if key != "bound_by")
                      + f" ({by}); {ops / 1e9:.3f} GFLOP needed, kernel "
                        f"{ops / t['kernel'] / 1e9:.2f} TFLOP/s of them")
    return path_err, timings


def syrk_ops(r, c, k):
    """Operations C - B B[:c]^T needs: the top (c, c) block of the product
    is symmetric, so only its lower triangle (c (c + 1) k) and the (r - c,
    c) block below it (2 (r - c) c k) have to be computed."""
    return float(c * (c + 1) * k + 2 * (r - c) * c * k)


def panel_updates(n, panel=256, outer=2048):
    """K8 launches in one panel_chol of order n (ops/blocked_dense.py), and
    the operations its trailing updates need.  Per stripe of width w over h
    rows: one in-stripe update per panel, whose B is zero above the
    panel's last row, so it needs only the (h - c0 - panel, w - c0 - panel)
    block below and right of the panel at c0; and one (h - w, h - w, w)
    cross-stripe update when rows remain below the stripe.  Together that
    is the Cholesky's own trailing-update work: the sum over panels of
    t (t + 1) panel, for t the order of the matrix left after the panel."""
    npad = -(-n // panel) * panel
    count, flops, j0 = 0, 0.0, 0
    while j0 < npad:
        w = min(outer, npad - j0)
        h = npad - j0
        for c0 in range(0, w, panel):
            count += 1
            flops += syrk_ops(h - c0 - panel, w - c0 - panel, panel)
        if h > w:
            count += 1
            flops += syrk_ops(h - w, h - w, w)
        j0 += w
    return count, flops


def blocked_phase(mt, k1, k8, ref):
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
    (w_launches, w_flops), (s_launches, s_flops) = (
        panel_updates(n_tot), panel_updates(m_tot))
    per_trial = w_launches + s_launches
    bound, by = bound_ms(w_flops + s_flops, 0.0, "float32")
    print(f"  bucketed W {n_tot}^2, S {m_tot}^2: K8 launches {launches} "
          f"for {fact} factorization trials ({per_trial} per trial expected, "
          f"{(w_flops + s_flops) / 1e9:.2f} GFLOP of trailing update needed "
          f"per trial, float32 bound "
          f"{bound:.4f} ms ({by})); K1 launches {k1.cholesky_lower.launches}")
    check(launches >= 12 * fact > 0, f"K8 launched {launches} times")
    check(launches == per_trial * fact, "K8 launch count off the panel structure")
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
    k8_launches, k8_fact = blocked_phase(mt, k1, k8, ref)
    variants_phase(mt, k1, k8, ref)

    t600 = k1_times[("float32", 600)]
    k1_bound, k1_by = bound_ms(600.0 ** 3 / 3, 2 * 600 * 600 * 4, "float32")
    t8 = k8_times[("float32", (4096, 2048, 256))]
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
