"""The reference values that chip_smoke.py checks the port against.

`madqp_tpu_torch/testdata/jax_reference.json` holds status, iteration
count and objective of the JAX package on the smoke's problems, all with
the headline options (float32 factorization, one refinement step):
  * n500 / n2000: the headline benchmark QP random_qp(500, 200, seed) for
    seeds 0-3 and random_qp(2000, 1000, seed=0) through `solve`;
  * autosolve_n2000: random_qp(2000, 1000, seed=0) through `autosolve`,
    which buckets it to W 2048^2, S 1024^2 and picks the blocked backend;
  * n500_variants: random_qp(500, 200, seed=0) with each dense KKT variant
    (its extra options are stored beside its result, and chip_smoke.py
    reads them from there);
  * batched512: per-lane status / iterations / objective of the batched
    solver on 512 x dense_dummy_qp(32, 16, seed=i) with bench.py's batched
    options and endgame="f64" (smoke phase 10);
  * qp_layer64: iterations and the gradients of all six inputs of
    qp_layer for four lanes of the smoke's batch of 64 random QPs (phase
    11; the problems come from chip_smoke.layer_problem);
  * two_stage_1024: status, iterations, objective, the first-stage x0 and
    the norms of x and y of `solve_two_stage` on random_two_stage(n0=128,
    ns=96, ms=48, m0=16, N=1024, seed=0) under each of three option sets
    (phase 12; default options otherwise).  The reference's Schur system
    takes the library Cholesky whatever linear_solver says, so its
    "pallas" and "dense" entries are one solve;
  * suite_large: the reference runner's record (benchmarks/run_suite.py
    ::run_instance: status, status_detail, iterations, objective) of each
    instance of the structured suite's large tier, seed 0, written with
    write_suite and read back from its MPS file, under the runner's
    default options (float64, dense) and with --mixed-precision, plus the
    bucketed orders of W (null where the problem has no Hessian: W is
    then diagonal and never factored) and S (phase 13);
  * real_mm: the same record of the eight files of tests/data/real_mm,
    float64, the runner's default options (phase 13's corpus);
  * host_large: the reference runner's record of each large-tier instance
    (seed 0, read back from its MPS file) with --backend host, the host
    path with the native sparse LDL (phase 14);
  * host_xlarge: the same record of the xlarge tier's members that ride
    the normal equations up to dense_normal_limit (HOST_XLARGE: the LP
    families but bandedlp, and svm), with the number of rows after
    presolve; phase 15 holds the port's dense-normal sparse LP on the card
    to them;
  * sparse_xlarge: the reference runner's record of the same members with
    --backend sparse-device --sparse-kkt auto (the JAX dense-normal path),
    float64 and --mixed-precision --endgame host: where the dense-normal
    path itself ends apart from the host path (an ill-scaled member in
    float64, and any member under the float32 phase), phase 15 holds the
    card to these.
  * augmented_xlarge: the reference runner's --backend sparse-device
    records of the xlarge tier's QP members with a general Hessian
    (AUGMENTED_XLARGE: the augmented K2 system under --sparse-kkt auto),
    float64 and --mixed-precision --endgame host, with the rows after
    presolve; condensed_xlarge: --sparse-kkt condensed on chainqp and
    cvxqp, float64 and --mixed-precision --endgame krylov (phase 17).
    laplqp_150 is left out: the smoke does not run it (its host symbolic
    phase alone takes minutes).
  * sparse_batched: per-lane status / iterations / objective of
    solve_sparse_batched on 16 same-pattern instances (seeds 0-15) of each
    run of SPARSE_BATCHED_RUNS, stored with its generator, keywords, seeds
    and options, which chip_smoke.py reads (phase 18), and the JAX batch's
    first wall on the CPU that wrote it (about 13-60 s each, chain_qp's
    about 280 s).
  * batched_backends: per-lane status / iterations / objective of the
    batched solver under every dense KKT backend (BACKEND_RUNS' options on
    top of batched512's), on the batches of BACKEND_BATCHES: the 512
    dense_dummy_qp(32, 16) lanes under all seven, the n = 500 headline QPs
    (seeds 0-3) under k2-blocked and condensed-blocked, and four
    random_qp(2000, 1000) (seeds 0-3) under condensed-blocked, whose W
    (2500^2) takes the panel Cholesky with K8 (phase 19).  Each batch is
    stored with its generator, keywords, seeds and runs, and each run with
    its options and the CPU seconds of the write run.
  * mesh: the JAX package's sharded solves on the CPU mesh at
    benchmarks/multihost.py's sizes (MESH_RUNS): batched, 16 x
    dense_dummy_qp(32, 16) with the lanes over 4 devices; schur,
    random_two_stage(n0=16, ns=12, ms=8, m0=4, N=16, seed=0) with the
    scenarios over 4 devices; default options: status, iterations,
    objective (tools/multihost_torch.py holds the port to them;
    tests/test_torch_multihost.py recomputes them).
The card's machine has no JAX, so the smoke reads them from the file; this
test regenerates them on the CPU and asserts the committed file still
holds them.

The n500 / n2000 entries use linear_solver="dense": interpret-mode Pallas
at these sizes is slow, and the two backends iterate identically on these
problems (tests/test_pallas.py::test_solver_with_pallas_backend, and the
n=500 seeds 0-3 check recorded in CHANGES.md).

All 512 batched lanes have one shape (no padding), so each lane's result
is independent of the batch: the staleness check recomputes CHECKED_LANES
as a batch of their own and compares them with the file.

Regenerate the file with:  python tests/test_torch_reference.py --write
(or only some entries:  ... --write --keys host_large host_xlarge)
"""

import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

import madqp_tpu as mq

REPO = Path(__file__).resolve().parent.parent
REF_PATH = REPO / "madqp_tpu_torch" / "testdata" / "jax_reference.json"
BATCH = 512
CHECKED_LANES = (0, 1, 97, 200, 311, 402, 480, 511)
LAYER_LANES = (0, 21, 42, 63)


def _smoke():
    """chip_smoke.py as a module (its problem generators; it imports no
    JAX and nothing of the port at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# Extra options of each n = 500 KKT variant (on top of the headline ones).
VARIANTS = {
    "blocked": {"linear_solver": "blocked"},
    "inverse": {"solve_mode": "inverse"},
    "k2": {"kkt_system": "k2"},
    "k2.5-blocked": {"kkt_system": "k2.5", "linear_solver": "blocked"},
}


def _headline():
    return dict(print_level=40, tol=1e-8, max_ncorr=0,
                step_rule=mq.AdaptiveStep(0.995),
                regularization=mq.FixedRegularization(1e-8, -1e-8),
                factorization_dtype="float32", max_refine_steps=1)


def _options():
    return dict(_headline(), linear_solver="dense")


def _record(stats):
    return {"status": int(stats.status), "iter": int(stats.iter),
            "objective": float(stats.objective)}


def batched_reference(lanes):
    """Per-lane lists of the batched solve of dense_dummy_qp(32, 16, seed=i)
    for i in `lanes`, with the smoke's phase-10 options."""
    from madqp_tpu.parallel import BatchedMPCSolver

    stats = BatchedMPCSolver.from_problems(
        [mq.dense_dummy_qp(32, 16, seed=i) for i in lanes],
        tol=1e-8, print_level=40, step_rule=mq.AdaptiveStep(0.995),
        regularization=mq.FixedRegularization(1e-8, -1e-8),
        factorization_dtype="float32", max_refine_steps=1,
        endgame="f64").solve_all()
    recs = [_record(st) for st in stats]
    return {key: [r[key] for r in recs] for key in ("status", "iter", "objective")}


def layer_reference():
    """qp_layer iterations and gradients (all six inputs) of the loss
    sum(w * x^2) + 0.1 * sum(y) for LAYER_LANES of the smoke's batch."""
    import jax
    import jax.numpy as jnp

    smoke = _smoke()
    w = jnp.asarray(smoke.layer_weights())
    tol = smoke.LAYER["tol"]

    def loss(*args):
        sol = mq.qp_layer(*args, tol=tol, print_level=40)
        return jnp.sum(w * sol.x ** 2) + 0.1 * jnp.sum(sol.y)

    grad = jax.grad(loss, argnums=tuple(range(6)))
    lanes = {}
    for i in LAYER_LANES:
        data = [jnp.asarray(a) for a in smoke.layer_problem(i)]
        sol = mq.qp_layer(*data, tol=tol, print_level=40)
        lanes[str(i)] = {
            "iter": int(sol.iters),
            "grads": {name: np.asarray(g).tolist()
                      for name, g in zip(("H", "c", "A", "b", "lb", "ub"), grad(*data))},
        }
    return {"problems": "chip_smoke.layer_problem(seed), seeds 0.."
                        f"{smoke.LAYER['lanes'] - 1}", **smoke.LAYER,
            "lanes": lanes}


def dense_reference():
    """The single-problem entries of the file."""
    n500 = mq.random_qp(500, 200, seed=0, ineq=True)
    out = {
        "source": "madqp_tpu on the CPU (tests/test_torch_reference.py), "
                  "float32 factorization, max_refine_steps=1, tol=1e-8, "
                  "max_ncorr=0, AdaptiveStep(0.995), "
                  "FixedRegularization(1e-8, -1e-8); n500 and n2000: solve "
                  "with linear_solver='dense'; autosolve_n2000: autosolve "
                  "with its own routing (pad_mode='bucket', "
                  "linear_solver='blocked'); n500_variants: solve on seed 0 "
                  "with each entry's options; batched512: BatchedMPCSolver "
                  "with the same options (max_ncorr default 0), "
                  "endgame='f64', linear_solver='dense'; qp_layer64: qp_layer, "
                  "float64, default options, tol as stored",
        "n500": {str(seed): _record(mq.solve(
            mq.random_qp(500, 200, seed=seed, ineq=True), **_options()))
            for seed in range(4)},
        "n2000": _record(mq.solve(mq.random_qp(2000, 1000, seed=0),
                                  **_options())),
        "autosolve_n2000": _record(mq.autosolve(
            mq.random_qp(2000, 1000, seed=0), **_headline())),
        "n500_variants": {
            name: {"options": extra,
                   **_record(mq.solve(n500, **_headline(), **extra))}
            for name, extra in VARIANTS.items()},
    }
    return out


# Phase 12's problem (random_two_stage's arguments but N) and option sets.
TWO_STAGE = dict(n0=128, ns=96, ms=48, m0=16, seed=0, qp=True)
TWO_STAGE_N = (1024, 512, 256)  # the largest N that every option set solves
TWO_STAGE_OPTIONS = {
    "pallas": {"linear_solver": "pallas"},
    "dense": {"linear_solver": "dense"},
    "pallas_f32": {"linear_solver": "pallas", "factorization_dtype": "float32",
                   "max_refine_steps": 1},
}


def two_stage_record(prob, lb, ub, options):
    from madqp_tpu.parallel import solve_two_stage

    st = solve_two_stage(prob, lb, ub, print_level=40, **options)
    y = np.asarray(st.multipliers)
    return {"options": options, **_record(st),
            "x0": np.asarray(st.solution[:TWO_STAGE["n0"]]).tolist(),
            "norm_x": float(np.linalg.norm(st.solution)),
            "norm_y": float(np.linalg.norm(y))}


def two_stage_reference(names=tuple(TWO_STAGE_OPTIONS), sizes=TWO_STAGE_N):
    """`solve_two_stage` on TWO_STAGE at the largest N of `sizes` where
    every option set of `names` reaches SOLVE_SUCCEEDED."""
    from madqp_tpu.parallel import random_two_stage

    for N in sizes:
        prob, lb, ub = random_two_stage(N=N, **TWO_STAGE)
        recs = {name: two_stage_record(prob, lb, ub, TWO_STAGE_OPTIONS[name])
                for name in names}
        if all(rec["status"] == 1 for rec in recs.values()):
            return {"problem": dict(TWO_STAGE, N=N), "solves": recs}
    raise RuntimeError("no N of TWO_STAGE_N solves under every option set")


def runner_options(mixed=False):
    """benchmarks/run_suite.py's default options (its main), dense path;
    mixed = --mixed-precision."""
    opts = dict(print_level=40, tol=1e-8, max_iter=300, max_ncorr=3,
                kkt_system="condensed", linear_solver="dense",
                step_rule=mq.AdaptiveStep(0.995),
                regularization=mq.FixedRegularization(1e-8, -1e-8),
                backend="device", pad_mode="bucket")
    if mixed:
        opts.update(factorization_dtype="float32", max_refine_steps=1)
    return opts


SUITE_OPTIONS = {"f64": False, "mixed": True}
# Recomputed only by the --write run, not by the staleness check
# (tests/test_torch_reference_suite.py), for its time on a shared CPU: the
# instances with a bucketed W or S of order 1024 or more, 21 s in float64
# and 34 s mixed of the tier's 31 s and 51 s on an idle 8-core host.
_LARGEST = ("bandedlp_4000_0", "gridlp_32_0", "cvxqp_2000_0", "chainqp_2000_0",
            "lasso_2000_0", "laplqp_40_0", "svm_300x40_0")
STALE_SKIP = {"f64": _LARGEST, "mixed": _LARGEST}


def _run_suite():
    sys.path.insert(0, str(REPO / "benchmarks"))
    import run_suite

    return run_suite


def runner_record(name, qp, mixed=False):
    rec = _run_suite().run_instance(name, qp, runner_options(mixed))
    return {k: rec.get(k) for k in ("status", "status_detail", "iter", "objective")}


def kkt_orders(qp):
    """Bucketed (W, S) orders of the dense solve of `qp` after the runner's
    presolve and scaling; W is None when the problem has no Hessian."""
    qp_s, _ = mq.scale_qp(mq.presolve_qp(qp)[0])
    prob = mq.MPCSolver(qp_s, **runner_options()).prob
    m, n = prob.A.shape
    return (None if prob.H is None else int(n)), int(m)


def suite_large_reference(skip=None, sets=tuple(SUITE_OPTIONS)):
    """suite_large (module docstring) under the option sets `sets`; `skip`
    maps an option set to the instance names left out."""
    from madqp_tpu.models.suite import write_suite

    skip = skip or {}
    out = {"problems": "write_suite(size='large', seeds=(0,)), read back with read_mps",
           "options": {k: {"linear_solver": "dense", "mixed_precision": v}
                       for k, v in SUITE_OPTIONS.items()},
           "instances": {}}
    with tempfile.TemporaryDirectory() as d:
        for path in write_suite(d, size="large", seeds=(0,)):
            name = os.path.basename(path).split(".")[0]
            qp = mq.read_mps(path)
            W, S = kkt_orders(qp)
            rec = {"W": W, "S": S}
            for key in sets:
                if name not in skip.get(key, ()):
                    rec[key] = runner_record(name, qp, SUITE_OPTIONS[key])
            out["instances"][name] = rec
    return out


# The xlarge members of phase 15: every LP family with m <= 12288 rows
# (dense_normal_limit; bandedlp's 15000 take the supernodal path) and svm,
# a QP with a diagonal Hessian.
HOST_XLARGE = ("transport", "multicomm", "staircase", "blending", "fixed",
               "assignment", "setcover", "diet", "illscaled", "redundant",
               "ranges", "gridlp", "svm")


def host_options():
    """benchmarks/run_suite.py's options under --backend host."""
    opts = runner_options()
    opts.pop("pad_mode")
    return dict(opts, backend="host")


def host_tier_reference(size, families=(), keep=None):
    """{name: record} of the reference runner's --backend host on the
    structured suite's `size` tier, seed 0, each instance written as an
    MPS file and read back (only the names in `keep`, when given); the
    record gains `m`, the rows after presolve."""
    from madqp_tpu.io.mps_write import write_mps
    from madqp_tpu.models.suite import structured_suite

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, qp in structured_suite(size, seeds=(0,), families=families):
            if keep is not None and name not in keep:
                continue
            path = os.path.join(d, f"{name}.{'qps' if qp.H is not None else 'mps'}")
            write_mps(qp, path)
            qp = mq.read_mps(path)
            rec = _run_suite().run_instance(name, qp, host_options())
            out[name] = {k: rec.get(k) for k in ("status", "status_detail", "iter",
                                                  "objective")}
            out[name]["m"] = int(mq.presolve_qp(qp)[0].ncon)
    return out


def sparse_options(mixed=False):
    """benchmarks/run_suite.py's options under --backend sparse-device
    --sparse-kkt auto (and --mixed-precision --endgame host)."""
    opts = dict(host_options(), backend="sparse-device", sparse_kkt="auto")
    if mixed:
        opts.update(factorization_dtype="float32", max_refine_steps=1, endgame="host")
    return opts


def sparse_xlarge_reference(keep=None):
    """{name: {"f64": record, "mixed": record}} of the reference runner's
    --backend sparse-device on the HOST_XLARGE members (xlarge, seed 0,
    read back from MPS files)."""
    from madqp_tpu.io.mps_write import write_mps
    from madqp_tpu.models.suite import structured_suite

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, qp in structured_suite("xlarge", seeds=(0,), families=HOST_XLARGE):
            if keep is not None and name not in keep:
                continue
            path = os.path.join(d, f"{name}.{'qps' if qp.H is not None else 'mps'}")
            write_mps(qp, path)
            qp = mq.read_mps(path)
            out[name] = {}
            for key, mixed in SUITE_OPTIONS.items():
                rec = _run_suite().run_instance(name, qp, sparse_options(mixed))
                out[name][key] = {k: rec.get(k) for k in (
                    "status", "status_detail", "iter", "objective", "endgame_backend")}
    return out


SUPERNODAL_XLARGE = ("bandedlp",)


def supernodal_xlarge_reference(keep=None, labels=("host", "host_mixed", "f64", "mixed")):
    """{name: {label: record}} of the reference runner on the xlarge LP
    member above dense_normal_limit (bandedlp_30000_0, m = 15000 after
    presolve: --backend sparse-device takes the supernodal path), seed 0,
    read back from an MPS file: --backend host in float64 ("host", with
    `m`) and with --mixed-precision ("host_mixed"), and --backend
    sparse-device in float64 ("f64") and with --mixed-precision --endgame
    host ("mixed", with its endgame backend).  `labels` picks the records
    made."""
    from madqp_tpu.io.mps_write import write_mps
    from madqp_tpu.models.suite import structured_suite

    keys = ("status", "status_detail", "iter", "objective")
    options = {"host": host_options(),
               "host_mixed": dict(host_options(), factorization_dtype="float32",
                                  max_refine_steps=1),
               "f64": sparse_options(), "mixed": sparse_options(mixed=True)}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, qp in structured_suite("xlarge", seeds=(0,), families=SUPERNODAL_XLARGE):
            if keep is not None and name not in keep:
                continue
            path = os.path.join(d, f"{name}.mps")
            write_mps(qp, path)
            qp = mq.read_mps(path)
            out[name] = {"m": int(mq.presolve_qp(qp)[0].ncon)}
            for label in labels:
                rec = _run_suite().run_instance(name, qp, options[label])
                out[name][label] = {k: rec.get(k) for k in keys + (
                    ("endgame_backend",) if label == "mixed" else ())}
    return out


AUGMENTED_XLARGE = ("chainqp", "cvxqp", "lasso", "portfolio")
CONDENSED_XLARGE = ("chainqp", "cvxqp")
RECORD_KEYS = ("status", "status_detail", "iter", "objective", "endgame_backend")


def _xlarge_records(families, options, rows=False):
    """{name: {label: record}} of the reference runner on the xlarge tier's
    `families` (seed 0, each written as an MPS/QPS file and read back)
    under each of `options` ({label: runner options}); with `rows`, also
    `m`, the rows after presolve."""
    from madqp_tpu.io.mps_write import write_mps
    from madqp_tpu.models.suite import structured_suite

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, qp in structured_suite("xlarge", seeds=(0,), families=families):
            path = os.path.join(d, f"{name}.{'qps' if qp.H is not None else 'mps'}")
            write_mps(qp, path)
            qp = mq.read_mps(path)
            out[name] = {"m": int(mq.presolve_qp(qp)[0].ncon)} if rows else {}
            for label, opts in options.items():
                rec = _run_suite().run_instance(name, qp, opts)
                out[name][label] = {k: rec.get(k) for k in RECORD_KEYS}
    return out


def augmented_xlarge_reference():
    """The reference runner's --backend sparse-device --sparse-kkt auto
    records of the xlarge tier's QP members with a general Hessian
    (AUGMENTED_XLARGE: auto takes the augmented K2 system on each), float64
    ("f64") and --mixed-precision --endgame host ("mixed"), with `m`
    (smoke phase 17)."""
    return _xlarge_records(AUGMENTED_XLARGE, {"f64": sparse_options(),
                                              "mixed": sparse_options(mixed=True)}, rows=True)


def condensed_xlarge_reference():
    """The same with --sparse-kkt condensed on CONDENSED_XLARGE: float64
    ("f64") and --mixed-precision --endgame krylov ("krylov")."""
    cond = dict(sparse_options(), sparse_kkt="condensed")
    krylov = dict(sparse_options(mixed=True), sparse_kkt="condensed", endgame="krylov")
    return _xlarge_records(CONDENSED_XLARGE, {"f64": cond, "krylov": krylov})


def host_large_reference(keep=None):
    return host_tier_reference("large", keep=keep)


def host_xlarge_reference(keep=None):
    return host_tier_reference("xlarge", HOST_XLARGE, keep=keep)


def real_mm_reference():
    data = REPO / "tests" / "data" / "real_mm"
    return {f.split(".")[0]: runner_record(f.split(".")[0], mq.read_mps(str(data / f)))
            for f in sorted(os.listdir(data))}


# Phase 18: the shared-pattern sparse batch at the reference's sweep sizes
# (benchmarks/bench_sparse_batched.py: batch 16, banded_sparse_lp(2000,
# 1000, band=5), grid_lp(g=40); its options, tol 1e-8, and with
# --mixed-precision the float32 factorization and two refinement steps),
# and the augmented system on chain_qp(n=10000).  Each run's generator,
# keywords, seeds and options are stored beside its per-lane records, and
# the smoke reads them from there.
SPARSE_BATCH = 16
SPARSE_F32 = dict(factorization_dtype="float32", max_refine_steps=2)
SPARSE_BATCHED_RUNS = {
    "bandedlp_f64": ("banded_sparse_lp", dict(n=2000, m=1000, band=5), {}),
    "bandedlp_mixed": ("banded_sparse_lp", dict(n=2000, m=1000, band=5), SPARSE_F32),
    "gridlp_f64": ("grid_lp", dict(g=40), {}),
    "gridlp_mixed": ("grid_lp", dict(g=40), SPARSE_F32),
    "chainqp_f64": ("chain_qp", dict(n=10000), {}),
}


def sparse_batch_problems(pkg, generator, kwargs, seeds):
    """The batch's instances from the package `pkg` (chain_qp lives in its
    models.suite)."""
    suite = importlib.import_module(pkg.__name__ + ".models.suite")
    gen = getattr(pkg, generator, None) or getattr(suite, generator)
    return [gen(seed=s, **kwargs) for s in seeds]


def sparse_batched_reference(runs=tuple(SPARSE_BATCHED_RUNS), seeds=range(SPARSE_BATCH)):
    """Per-lane status / iterations / objective of the reference's
    solve_sparse_batched for each run (with its generator, keywords, seeds
    and options), and its warm wall on this CPU."""
    import time

    from madqp_tpu.parallel import solve_sparse_batched

    out = {}
    for name in runs:
        generator, kwargs, extra = SPARSE_BATCHED_RUNS[name]
        options = dict(tol=1e-8, print_level=40, **extra)
        qps = sparse_batch_problems(mq, generator, kwargs, seeds)
        t0 = time.perf_counter()
        stats = solve_sparse_batched(qps, **options)
        recs = [_record(st) for st in stats]
        out[name] = {"generator": generator, "kwargs": kwargs, "seeds": list(seeds),
                     "options": options, "cpu_first_s": time.perf_counter() - t0,
                     **{key: [r[key] for r in recs] for key in ("status", "iter", "objective")}}
    return out


# Phase 19: every dense KKT backend of a single solve on a batch (extra
# options on top of batched512's), and the batches it runs them on.
BACKEND_RUNS = {
    "condensed-blocked": {"linear_solver": "blocked"},
    "inverse-dense": {"solve_mode": "inverse", "linear_solver": "dense"},
    "inverse-pallas": {"solve_mode": "inverse", "linear_solver": "pallas"},
    "k2": {"kkt_system": "k2"},
    "k2.5": {"kkt_system": "k2.5"},
    "k2-blocked": {"kkt_system": "k2", "linear_solver": "blocked"},
    "k2.5-blocked": {"kkt_system": "k2.5", "linear_solver": "blocked"},
}
BACKEND_BATCHES = {
    "batched512": ("dense_dummy_qp", dict(n=32, m=16), range(BATCH), tuple(BACKEND_RUNS)),
    "n500x4": ("random_qp", dict(n=500, m=200, ineq=True), range(4),
               ("k2-blocked", "condensed-blocked")),
    "n2000x4": ("random_qp", dict(n=2000, m=1000), range(4), ("condensed-blocked",)),
}


def backend_options(pkg, run):
    """The options of a phase-19 run in the package `pkg`: batched512's
    with the run's extra ones."""
    return dict(tol=1e-8, print_level=40, step_rule=pkg.AdaptiveStep(0.995),
                regularization=pkg.FixedRegularization(1e-8, -1e-8),
                factorization_dtype="float32", max_refine_steps=1, endgame="f64",
                **BACKEND_RUNS[run])


def batched_backends_reference(batches=tuple(BACKEND_BATCHES), lanes=None, only=None):
    """Per-lane lists of the reference's batched solve of each batch under
    each of its runs (only the seeds in `lanes` and the runs in `only`, if
    given)."""
    import time

    from madqp_tpu.parallel import BatchedMPCSolver

    out = {}
    for name in batches:
        generator, kwargs, seeds, runs = BACKEND_BATCHES[name]
        seeds = list(seeds if lanes is None else lanes)
        qps = [getattr(mq, generator)(seed=s, **kwargs) for s in seeds]
        recs = {}
        for run in (runs if only is None else only):
            t0 = time.perf_counter()
            stats = BatchedMPCSolver.from_problems(qps, **backend_options(mq, run)).solve_all()
            rows = [_record(st) for st in stats]
            recs[run] = {"options": BACKEND_RUNS[run],
                         "cpu_s": time.perf_counter() - t0,
                         **{key: [r[key] for r in rows]
                            for key in ("status", "iter", "objective")}}
        out[name] = {"generator": generator, "kwargs": kwargs, "seeds": seeds,
                     "runs": recs}
    return out


# benchmarks/multihost.py's problems at its sizes over 4 devices.
MESH_DEVICES = 4
MESH_RUNS = {
    "batched": dict(generator="dense_dummy_qp", kwargs=dict(n=32, m=16), seeds=list(range(16)),
                    options=dict(print_level=40)),
    "schur": dict(problem=dict(n0=16, ns=12, ms=8, m0=4, N=16, seed=0, qp=True),
                  options=dict(print_level=40)),
}


def mesh_reference():
    """The reference's sharded solves of MESH_RUNS on a mesh of
    MESH_DEVICES CPU devices (status, iterations, objective; per lane for
    the batch)."""
    import jax

    from madqp_tpu.parallel import BatchedMPCSolver, random_two_stage, solve_two_stage

    assert len(jax.devices()) >= MESH_DEVICES, "needs XLA_FLAGS=--xla_force_host_platform_device_count=8"
    run = MESH_RUNS["batched"]
    qps = [getattr(mq, run["generator"])(seed=s, **run["kwargs"]) for s in run["seeds"]]
    stats = BatchedMPCSolver.from_problems(
        qps, mesh=jax.make_mesh((MESH_DEVICES,), ("batch",)), **run["options"]).solve_all()
    rows = [_record(st) for st in stats]
    out = {"devices": MESH_DEVICES,
           "batched": dict(run, **{key: [r[key] for r in rows]
                                   for key in ("status", "iter", "objective")})}
    run = MESH_RUNS["schur"]
    prob, lb, ub = random_two_stage(**run["problem"])
    st = solve_two_stage(prob, lb, ub, mesh=jax.make_mesh((MESH_DEVICES,), ("scen",)),
                         **run["options"])
    out["schur"] = dict(run, **_record(st))
    return out


def generate_reference():
    return {**dense_reference(), "batched512": batched_reference(range(BATCH)),
            "qp_layer64": layer_reference(), "two_stage_1024": two_stage_reference(),
            "suite_large": suite_large_reference(), "real_mm": real_mm_reference(),
            "host_large": host_large_reference(), "host_xlarge": host_xlarge_reference(),
            "sparse_xlarge": sparse_xlarge_reference(),
            "supernodal_xlarge": supernodal_xlarge_reference(),
            "augmented_xlarge": augmented_xlarge_reference(),
            "condensed_xlarge": condensed_xlarge_reference(),
            "sparse_batched": sparse_batched_reference(),
            "batched_backends": batched_backends_reference(), "mesh": mesh_reference()}


def _flatten(ref):
    rows = {f"n500/{seed}": rec for seed, rec in ref["n500"].items()}
    rows["n2000"] = ref["n2000"]
    rows["autosolve_n2000"] = ref["autosolve_n2000"]
    for name, rec in ref["n500_variants"].items():
        rows[f"n500_variants/{name}"] = rec
    return rows


def test_committed_reference_matches_jax():
    """Status and iterations equal; objective to 1e-10 relative (the last
    digits of an XLA:CPU reduction may differ between CPU models)."""
    committed = _flatten(json.loads(REF_PATH.read_text()))
    fresh = _flatten(dense_reference())
    assert committed.keys() == fresh.keys()
    for key, want in fresh.items():
        got = committed[key]
        assert got["status"] == want["status"] == 1, key
        assert got["iter"] == want["iter"], key
        assert got["objective"] == pytest.approx(want["objective"], rel=1e-10), key
        assert got.get("options") == want.get("options"), key


def test_committed_batched_lanes_match_jax():
    """CHECKED_LANES of batched512 recomputed as a batch of their own:
    status and iterations equal, objective to 1e-10 relative."""
    committed = json.loads(REF_PATH.read_text())["batched512"]
    assert all(len(v) == BATCH for v in committed.values())
    fresh = batched_reference(CHECKED_LANES)
    for j, i in enumerate(CHECKED_LANES):
        assert committed["status"][i] == fresh["status"][j] == 1, i
        assert committed["iter"][i] == fresh["iter"][j], i
        assert committed["objective"][i] == pytest.approx(fresh["objective"][j],
                                                          rel=1e-10), i


def test_committed_layer_gradients_match_jax():
    """qp_layer64: iterations equal, every gradient to 1e-10 relative to
    its largest magnitude."""
    committed = json.loads(REF_PATH.read_text())["qp_layer64"]
    fresh = layer_reference()
    assert {k: v for k, v in committed.items() if k != "lanes"} == \
        {k: v for k, v in fresh.items() if k != "lanes"}
    assert committed["lanes"].keys() == fresh["lanes"].keys()
    for lane, want in fresh["lanes"].items():
        got = committed["lanes"][lane]
        assert got["iter"] == want["iter"], lane
        for name, g in want["grads"].items():
            g = np.asarray(g)
            np.testing.assert_allclose(np.asarray(got["grads"][name]), g, rtol=1e-10,
                                       atol=1e-10 * np.abs(g).max(), err_msg=f"{lane} {name}")


def test_committed_two_stage_matches_jax():
    """two_stage_1024: the float64 solve recomputed (about a minute on the
    CPU): status and iterations equal, objective, x0 and the norms to 1e-10
    relative.  The reference's Schur system ignores linear_solver, so its
    "pallas" entry must equal its "dense" one; the float32 entry is
    recomputed only by the --write run."""
    committed = json.loads(REF_PATH.read_text())["two_stage_1024"]
    assert committed["problem"]["N"] in TWO_STAGE_N
    assert committed["problem"] == dict(TWO_STAGE, N=committed["problem"]["N"])
    solves = committed["solves"]
    assert solves.keys() == TWO_STAGE_OPTIONS.keys()
    for name, rec in solves.items():
        assert rec["options"] == TWO_STAGE_OPTIONS[name] and rec["status"] == 1, name
        assert len(rec["x0"]) == TWO_STAGE["n0"], name
    assert {k: v for k, v in solves["pallas"].items() if k != "options"} == \
        {k: v for k, v in solves["dense"].items() if k != "options"}
    fresh = two_stage_reference(("dense",), (committed["problem"]["N"],))["solves"]["dense"]
    got = solves["dense"]
    assert got["status"] == fresh["status"] and got["iter"] == fresh["iter"]
    for key in ("objective", "norm_x", "norm_y"):
        assert got[key] == pytest.approx(fresh[key], rel=1e-10), key
    np.testing.assert_allclose(got["x0"], fresh["x0"], rtol=1e-10, atol=1e-12)


def _same_record(got, want, key, obj_rtol=1e-10):
    assert got["status"] == want["status"], key
    assert got["status_detail"] == want["status_detail"], key
    assert got["iter"] == want["iter"], key
    assert got["objective"] == pytest.approx(want["objective"], rel=obj_rtol), key


def test_committed_real_mm_matches_jax():
    committed = json.loads(REF_PATH.read_text())["real_mm"]
    fresh = real_mm_reference()
    assert committed.keys() == fresh.keys() and len(fresh) == 8
    for name, want in fresh.items():
        _same_record(committed[name], want, name)


def test_committed_sparse_batched_matches_jax():
    """sparse_batched: each run's description is SPARSE_BATCHED_RUNS' with
    16 seeds, every lane solved; the float64 banded run's first four lanes
    recomputed as a batch of their own (lanes of one pattern are
    independent): status and iterations equal, objective to 1e-10."""
    committed = json.loads(REF_PATH.read_text())["sparse_batched"]
    assert committed.keys() == SPARSE_BATCHED_RUNS.keys()
    for name, (generator, kwargs, extra) in SPARSE_BATCHED_RUNS.items():
        rec = committed[name]
        assert (rec["generator"], rec["kwargs"]) == (generator, kwargs), name
        assert rec["options"] == dict(tol=1e-8, print_level=40, **extra), name
        assert rec["seeds"] == list(range(SPARSE_BATCH)), name
        assert rec["status"] == [1] * SPARSE_BATCH, name
    got = committed["bandedlp_f64"]
    fresh = sparse_batched_reference(("bandedlp_f64",), range(4))["bandedlp_f64"]
    assert fresh["status"] == got["status"][:4]
    assert fresh["iter"] == got["iter"][:4]
    np.testing.assert_allclose(fresh["objective"], got["objective"][:4], rtol=1e-10)


def test_committed_batched_backends_match_jax():
    """batched_backends: each batch's description and runs are
    BACKEND_BATCHES' with BACKEND_RUNS' options, every lane solved; two
    lanes of batched512 under k2.5-blocked (the floored float32 signed
    LDL^T) recomputed as a batch of their own: status and iterations
    equal, objective to 1e-10."""
    committed = json.loads(REF_PATH.read_text())["batched_backends"]
    assert committed.keys() == BACKEND_BATCHES.keys()
    for name, (generator, kwargs, seeds, runs) in BACKEND_BATCHES.items():
        rec = committed[name]
        assert (rec["generator"], rec["kwargs"], rec["seeds"]) == (generator, kwargs,
                                                                   list(seeds)), name
        assert tuple(rec["runs"]) == runs, name
        for run, r in rec["runs"].items():
            assert r["options"] == BACKEND_RUNS[run], (name, run)
            assert r["status"] == [1] * len(seeds), (name, run)
    lanes = (0, 311)
    want = batched_backends_reference(("batched512",), lanes, ("k2.5-blocked",))[
        "batched512"]["runs"]["k2.5-blocked"]
    got = committed["batched512"]["runs"]["k2.5-blocked"]
    for j, i in enumerate(lanes):
        assert got["status"][i] == want["status"][j] and got["iter"][i] == want["iter"][j], i
        assert got["objective"][i] == pytest.approx(want["objective"][j], rel=1e-10), i


if __name__ == "__main__":
    # the mesh entry's 4 devices (tests/conftest.py gives the tests 8)
    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--keys" in sys.argv:
        keys = sys.argv[sys.argv.index("--keys") + 1:]
        makers = {"suite_large": suite_large_reference, "real_mm": real_mm_reference,
                  "host_large": host_large_reference, "host_xlarge": host_xlarge_reference,
                  "sparse_xlarge": sparse_xlarge_reference,
                  "supernodal_xlarge": supernodal_xlarge_reference,
                  "augmented_xlarge": augmented_xlarge_reference,
                  "condensed_xlarge": condensed_xlarge_reference,
                  "sparse_batched": sparse_batched_reference,
                  "batched_backends": batched_backends_reference,
                  "mesh": mesh_reference}
        ref = json.loads(REF_PATH.read_text())
        ref.update({k: makers[k]() for k in keys})
    else:
        ref = generate_reference()
    text = json.dumps(ref, indent=1) + "\n"
    if "--write" in sys.argv:
        REF_PATH.write_text(text)
    print(text, end="")
