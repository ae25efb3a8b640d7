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
with `endgame="f64"`, with `"pallas"` (K1 one CTA per matrix) and
`"dense"`; set-up once, then `solve_batch`): times unprofiled solves on the
host clock after one warm-up solve, then profiles one solve with
torch.profiler and sums kernel time by layer (K1, K8, library Cholesky,
triangular solves, matmul, reductions, elementwise).  The idle share is 1 - (sum of kernel times) / (wall of the
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
# come first: K1 is one launch per factorization (madqp_cholesky_kernel),
# K8 one per update (madqp_syrk_kernel); neither name holds a fragment of
# the library layers below, its float64 DMMA tiles included.
LAYERS = (
    ("K1 batched cholesky (one CTA per matrix)", ("madqp_cholesky_batched",)),
    ("K1 cholesky (factorize)", ("madqp_cholesky",)),
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
    kernel busy ms by layer, launches by layer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, launches = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # device_time_total replaced cuda_time_total in newer releases
            busy_us[layer_of(e.name)] += (e.device_time_total
                                          if hasattr(e, "device_time_total")
                                          else e.cuda_time_total)
            launches[layer_of(e.name)] += 1
    return out, wall, busy_us, launches


def summary(wall, busy_us, launches, **extra):
    busy_ms = sum(busy_us.values()) / 1e3
    return {"wall_ms": wall * 1e3, **extra, "kernel_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / (wall * 1e3),
            "layers_ms": {k: v / 1e3 for k, v in busy_us.most_common()},
            "launches": dict(launches.most_common())}


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
    (st, _), wall, busy_us, launches = device_profile(
        torch, lambda: solve(torch, mt, make(seeds[0]), entry, options))
    return {
        "unprofiled": runs,
        "profiled": summary(wall, busy_us, launches, seed=seeds[0], iters=st.iter,
                            factorizations=st.counters.factorizations),
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
    final, wall, busy_us, launches = device_profile(torch, solver.solve_batch)
    return {
        "setup_s": setup,
        "unprofiled": {"wall_s": walls,
                       "instances_per_s": [BATCH / w for w in walls]},
        "profiled": summary(wall, busy_us, launches, lanes=BATCH,
                            max_iters=int(final.k.max())),
    }


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
