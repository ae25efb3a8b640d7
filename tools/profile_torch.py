#!/usr/bin/env python3
"""Device time by layer for the port's dense and batched solves on one
CUDA card.

Run from the root of a checkout:

    python3 tools/profile_torch.py --out profile.json [--cells NAME ...]

For the n = 500 headline QP (`random_qp(500, 200)`, with
`linear_solver="pallas"` and `"dense"`) and the n = 2000 QP
(`random_qp(2000, 1000)`, through `solve` with pallas and through
`autosolve`, which buckets it to W 4096^2 / S 1024^2 and takes the blocked
backend), all with the headline options, and the batched cell
(`solve_batched` of 512 x `dense_dummy_qp(32, 16)`, `bench.py`'s options
with `endgame="f64"`, with `"pallas"` (K1's batched kernels) and
`"dense"`; set-up once, then `solve_batch`), and the four n = 500 QPs as
one batch with `"pallas"` (W above the shared-memory limit: the persistent
K1 with a lane axis), and the two-stage cell (`solve_two_stage` on the
problem of testdata/jax_reference.json's two_stage_1024 entry, default
options, with `"pallas"` and `"dense"` alternating in one process), and
the suite cell (the structured suite's large tier, seed 0, written as MPS
files and run through the suite runner's `run_instance` with its default
options and `"pallas"`: host seconds by stage, parse, presolve, scale,
solve and unscale, then all 19 runs profiled, the idle share over the
solves' walls): times
unprofiled solves on the host clock after one warm-up solve, then
profiles one solve with torch.profiler, sums kernel time by layer (K1,
K8, library Cholesky, triangular solves, matmul, reductions,
elementwise) and the host time of the CUDA runtime calls by name (the
launches, and the port's own kernels' attribute and occupancy queries).
The idle share is 1 - (sum of kernel times) / (wall of the
profiled solve): the solve runs on one stream, so kernels do not overlap,
and the profiler's host overhead inflates the wall, so the share is an
upper bound.  `init_s` is the solve's set-up (standard form and upload)
from its counters.  Prints the card's name and power limit first and the
JSON record last; writes the record to `--out`.
"""

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

# Kernel-name fragments -> layer, first match wins.  The port's kernels
# come first: K1 is one launch per factorization or per stack (the
# batched kernels, by route: registers, shared memory; and
# madqp_cholesky_kernel, the persistent kernel, for one matrix or, with
# its lane axis, a stack above n_max), K8 one per update
# (madqp_syrk_kernel); no name holds a fragment of the library layers
# below, their float64 DMMA tiles included.
LAYERS = (
    ("K1 batched, registers (n <= 32)", ("madqp_cholesky_batched_regs",)),
    ("K1 batched, shared memory (a warp or a CTA per matrix)",
     ("madqp_cholesky_batched_shared",)),
    ("K1 persistent (one matrix, or a stack above n_max)", ("madqp_cholesky",)),
    ("K8 syrk_update (panel Cholesky trailing update)", ("madqp_syrk",)),
    ("library cholesky (factorize)", ("potrf", "getrf_wo_pivot", "trf4_set_info")),
    ("triangular solves (cholesky_solve)", ("trsv", "trsm")),
    ("matmul / matvec", ("gemm", "gemv", "cutlass", "xmma", "dot_kernel")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "where", "fill", "copy", "index")),
)
HEADLINE = dict(tol=1e-8, max_ncorr=0, factorization_dtype="float32",
                max_refine_steps=1, print_level=40)
BATCH = 512


def layer_of(kernel_name):
    name = kernel_name.lower()
    for layer, keys in LAYERS:
        if any(k in name for k in keys):
            return layer
    return "other: " + kernel_name[:60]


def solve(torch, mt, qp, entry, options):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = getattr(mt, entry)(qp, device="cuda", step_rule=mt.AdaptiveStep(0.995),
                            regularization=mt.FixedRegularization(1e-8, -1e-8),
                            **HEADLINE, **options)
    torch.cuda.synchronize()
    if not st.success:
        raise RuntimeError(f"{qp.name} [{entry} {options}]: {st.status.name}")
    return st, time.perf_counter() - t0


def device_profile(torch, run):
    """Profile one call of `run`: returns (its result, its wall in s,
    kernel busy us by layer, launches by layer, host us in CUDA runtime
    calls by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, launches = collections.Counter(), collections.Counter()
    runtime_us = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # device_time_total replaced cuda_time_total in newer releases
            busy_us[layer_of(e.name)] += (e.device_time_total
                                          if hasattr(e, "device_time_total")
                                          else e.cuda_time_total)
            launches[layer_of(e.name)] += 1
        elif e.name.startswith("cuda"):  # a CUDA runtime call, on the host
            runtime_us[e.name] += e.cpu_time_total
    return out, wall, busy_us, launches, runtime_us


def summary(wall, busy_us, launches, runtime_us, **extra):
    busy_ms = sum(busy_us.values()) / 1e3
    return {"wall_ms": wall * 1e3, **extra, "kernel_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / (wall * 1e3),
            "layers_ms": {k: v / 1e3 for k, v in busy_us.most_common()},
            "launches": dict(launches.most_common()),
            "host_runtime_calls_ms": {k: v / 1e3 for k, v in runtime_us.most_common(8)}}


def profile_cell(torch, mt, shape, seeds, entry="solve", **options):
    """`random_qp(*shape, seed)` for each of `seeds` through `mt.<entry>`
    with `options`, then seeds[0] profiled."""
    def make(seed):
        return mt.random_qp(*shape, seed=seed, ineq=True)

    solve(torch, mt, make(seeds[0]), entry, options)  # warm-up
    runs = []
    for seed in seeds:
        st, wall = solve(torch, mt, make(seed), entry, options)
        runs.append({"seed": seed, "wall_s": wall, "iters": st.iter,
                     "init_s": st.counters.init_time})
    (st, _), wall, busy_us, launches, runtime_us = device_profile(
        torch, lambda: solve(torch, mt, make(seeds[0]), entry, options))
    return {
        "unprofiled": runs,
        "profiled": summary(wall, busy_us, launches, runtime_us, seed=seeds[0],
                            iters=st.iter, factorizations=st.counters.factorizations),
    }


def profile_batch_n500(torch, mt, reps=3):
    """The n = 500 QPs of seeds 0-3 as one batch through `solve_batched`
    with `"pallas"` and the headline options: a warm-up, `reps` unprofiled
    calls, then one profiled."""
    qps = [mt.random_qp(500, 200, seed=s, ineq=True) for s in range(4)]

    def run():
        stats = mt.solve_batched(qps, device="cuda", step_rule=mt.AdaptiveStep(0.995),
                                 regularization=mt.FixedRegularization(1e-8, -1e-8),
                                 linear_solver="pallas", **HEADLINE)
        torch.cuda.synchronize()
        if not all(st.success for st in stats):
            raise RuntimeError("n = 500 batch: a lane unsolved")
        return stats

    run()  # warm-up
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    stats, wall, busy_us, launches, runtime_us = device_profile(torch, run)
    return {
        "unprofiled": {"wall_s": walls},
        "profiled": summary(wall, busy_us, launches, runtime_us, lanes=len(stats),
                            iters=[st.iter for st in stats]),
    }


def profile_batched(torch, mt, backend, reps=3):
    """`BatchedMPCSolver` of BATCH x dense_dummy_qp(32, 16, seed=i) with
    `linear_solver=backend`: set-up timed once, a warm-up `solve_batch`,
    `reps` unprofiled ones (instances/s), then one profiled."""
    t0 = time.perf_counter()
    solver = mt.BatchedMPCSolver.from_problems(
        [mt.dense_dummy_qp(32, 16, seed=i) for i in range(BATCH)], device="cuda",
        tol=1e-8, print_level=40, step_rule=mt.AdaptiveStep(0.995),
        regularization=mt.FixedRegularization(1e-8, -1e-8),
        factorization_dtype="float32", max_refine_steps=1, endgame="f64",
        linear_solver=backend)
    setup = time.perf_counter() - t0
    solver.solve_batch()  # warm-up
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        final = solver.solve_batch()
        walls.append(time.perf_counter() - t0)
    ok = int((final.status == 1).sum())
    if ok != BATCH:
        raise RuntimeError(f"batched {backend}: {BATCH - ok} lanes unsolved")
    final, wall, busy_us, launches, runtime_us = device_profile(torch, solver.solve_batch)
    return {
        "setup_s": setup,
        "unprofiled": {"wall_s": walls,
                       "instances_per_s": [BATCH / w for w in walls]},
        "profiled": summary(wall, busy_us, launches, runtime_us, lanes=BATCH,
                            max_iters=int(final.k.max())),
    }


def profile_two_stage(torch, mt, reps=5):
    """`solve_two_stage` on the two_stage_1024 problem with default options,
    `linear_solver="pallas"` and `"dense"` in one process: the problem
    built on the card once (set-up), a warm-up solve of each, `reps` pairs
    of unprofiled solves in alternating order (pallas first, then dense
    first), then one profiled solve of each."""
    ref = Path(mt.__file__).resolve().parent / "testdata" / "jax_reference.json"
    spec = json.loads(ref.read_text())["two_stage_1024"]["problem"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob, lb, ub = mt.random_two_stage(**spec, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0

    def run(backend):
        st = mt.solve_two_stage(prob, lb, ub, device="cuda", print_level=40,
                                linear_solver=backend)
        if not st.success:
            raise RuntimeError(f"two-stage {backend}: {st.status.name}")
        return st

    backends = ("pallas", "dense")
    for backend in backends:
        run(backend)  # warm-up
    walls = {backend: [] for backend in backends}
    for rep in range(reps):
        for backend in backends[::1 if rep % 2 == 0 else -1]:
            t0 = time.perf_counter()
            run(backend)
            walls[backend].append(time.perf_counter() - t0)
    profiled = {}
    for backend in backends:
        st, wall, busy_us, launches, runtime_us = device_profile(torch, lambda: run(backend))
        profiled[backend] = summary(wall, busy_us, launches, runtime_us, iters=st.iter,
                                    factorizations=st.counters.factorizations)
    return {"problem": spec, "setup_s": setup, "unprofiled": {"wall_s": walls},
            "profiled": profiled}


def profile_suite_large(torch, mt, linear_solver="pallas"):
    """The structured suite's large tier (seed 0) through the suite runner
    (tools/run_suite_torch.py): `write_suite` to a temporary directory,
    `read_dir` (parse seconds per file), then `run_instance` on every file
    with the runner's default options and `linear_solver` (host seconds of
    presolve, scale, solve and unscale per instance, after one warm-up run
    of the first instance); then the 19 runs once more under the profiler,
    whose idle share is taken over the solves' own walls."""
    import tempfile

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import run_suite_torch as runner

    options = runner.solve_options(runner.parser().parse_args(
        ["--linear-solver", linear_solver]))
    parse_s = {}
    with tempfile.TemporaryDirectory() as d:
        mt.write_suite(d, size="large", seeds=(0,))
        instances = runner.read_dir(d, parse_s=parse_s)

    def run_all(per):
        records = []
        for name, qp in instances:
            per[name] = {"parse_s": parse_s[name]}
            rec = runner.run_instance(name, qp, options, stages=per[name])
            if rec["status"] != 1:
                raise RuntimeError(f"{name}: {rec['status']} {rec.get('status_detail')}")
            per[name]["iters"] = rec["iter"]
            records.append(rec)
        return records

    runner.run_instance(*instances[0], options)  # warm-up: builds the kernels
    per = {}
    run_all(per)
    stages = collections.Counter()
    for rec in per.values():
        for key in ("parse_s", "presolve_s", "scale_s", "solve_s", "unscale_s"):
            stages[key] += rec[key]
    per_profiled = {}
    records, wall, busy_us, launches, runtime_us = device_profile(
        torch, lambda: run_all(per_profiled))
    solve_wall = sum(rec["solve_s"] for rec in per_profiled.values())
    return {"options": {k: v for k, v in options.items()
                        if k not in ("step_rule", "regularization")},
            "host_s_by_stage": dict(stages), "instances": per,
            "profiled": summary(solve_wall, busy_us, launches, runtime_us,
                                run_wall_ms=wall * 1e3,
                                iters=sum(rec["iter"] for rec in records))}


CELLS = {
    "n500_pallas": lambda torch, mt: profile_cell(
        torch, mt, (500, 200), (1, 2, 3, 1, 2, 3), linear_solver="pallas"),
    "n500_dense": lambda torch, mt: profile_cell(
        torch, mt, (500, 200), (1, 2, 3, 1, 2, 3), linear_solver="dense"),
    "n2000_pallas": lambda torch, mt: profile_cell(
        torch, mt, (2000, 1000), (0, 0, 0), linear_solver="pallas"),
    "n2000_autosolve": lambda torch, mt: profile_cell(
        torch, mt, (2000, 1000), (0, 0, 0), entry="autosolve"),
    "batched512_pallas": lambda torch, mt: profile_batched(torch, mt, "pallas"),
    "batched512_dense": lambda torch, mt: profile_batched(torch, mt, "dense"),
    "n500x4_batch_pallas": lambda torch, mt: profile_batch_n500(torch, mt),
    "two_stage_1024": lambda torch, mt: profile_two_stage(torch, mt),
    "suite_large_pallas": lambda torch, mt: profile_suite_large(torch, mt),
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", required=True, help="JSON file to write")
    parser.add_argument("--cells", nargs="+", choices=sorted(CELLS),
                        default=list(CELLS), help="cells to profile (default: all)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the checkout
    import madqp_tpu_torch as mt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    record = {"card": card,
              "cells": {name: CELLS[name](torch, mt) for name in args.cells}}
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
