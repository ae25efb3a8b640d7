#!/usr/bin/env python3
"""Scenario-sweep throughput of the port on one CUDA card: the
shared-pattern sparse batch (`solve_sparse_batched`) against the serial
loop of single supernodal solves of the same instances (the port's
counterpart of benchmarks/bench_sparse_batched.py).

Run from the root of a checkout:

    python3 tools/sparse_batched_torch.py --out sparse_batched.json \\
        [--patterns grid40 grid100 banded] [--batches 8 16 32] [--precisions f64 mixed]

Patterns: grid_lp(g=40) and grid_lp(g=100) (the gridlp_100 pattern,
m = 10000) and banded_sparse_lp(2000, 1000, band=5), each instance seed s
for lane s; precisions: float64 ("f64") and the float32 factorization with
two refinement steps ("mixed"), the reference script's options otherwise
(tol 1e-8).  Per pattern, precision and batch size B: one cold batch (the
symbolic phase and the first launches), then the warm batch timed on the
host clock (instances/s), then the batch once more under torch.profiler
(`utils/profiling.py::device_profile`: kernel launches per lockstep
iteration, the idle share, K1's and K2-batched's device time).  The
factorization's rate: `utils/roofline.py::schedule_flops` and
`schedule_bytes` of the pattern's schedule, times B and the factorization
trials, over K1's and K2-batched's device time (the fronts' products and
triangular solves are outside it, so this overstates the rate of the whole
factorization; bytes at 8 per element, the float32 phase's included).
The serial loop: single solves of the first SERIAL
instances (`solve_sparse_lp(mode="batched")`, the same supernodal KKT,
one warm-up solve first), its instances/s against the batch's.  Prints
the card's name and power limit first and the JSON record last; writes
the record to `--out`.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PATTERNS = {
    "grid40": ("grid_lp", dict(g=40)),
    "grid100": ("grid_lp", dict(g=100)),
    "banded": ("banded_sparse_lp", dict(n=2000, m=1000, band=5)),
}
PRECISIONS = {"f64": {}, "mixed": dict(factorization_dtype="float32", max_refine_steps=2)}
OPTIONS = dict(tol=1e-8, print_level=40)
SERIAL = 8
# kernel-name fragments of the factorization's kernels (K1's batched and
# persistent forms, K2-batched)
FACTOR_KERNELS = ("madqp_cholesky", "madqp_ldl")


def run_config(torch, mt, pattern, precision, batch):
    from madqp_tpu_torch.ops import ldl_batched as k2
    from madqp_tpu_torch.ops import pallas_chol as k1
    from madqp_tpu_torch.ops import sparse_chol as SC
    from madqp_tpu_torch.parallel import sparse_batched as SB
    from madqp_tpu_torch.utils import profiling, roofline

    gen, kw = PATTERNS[pattern]
    qps = [getattr(mt, gen)(seed=s, **kw) for s in range(batch)]
    opts = dict(OPTIONS, **PRECISIONS[precision])

    def solve():
        res = mt.solve_sparse_batched(qps, device="cuda", **opts)
        torch.cuda.synchronize()
        return res

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solve()
    cold = time.perf_counter() - t0
    k1.cholesky_lower.launches, k2.ldl_lower_batched.launches = 0, 0
    t0 = time.perf_counter()
    res = solve()
    warm = time.perf_counter() - t0
    fact_launches = k1.cholesky_lower.launches + k2.ldl_lower_batched.launches
    iters = max(r.iter for r in res)   # lockstep iterations of the batch
    _, prof = profiling.device_profile(solve)
    factor_ms = sum(ms for name, ms in prof["kernel_ms_by_name"].items()
                    if any(k in name for k in FACTOR_KERNELS))
    launches = sum(prof["launches_by_name"].values())
    # the pattern's schedule (the latest KKT of the cache: both phases of a
    # mixed run share it), its front stacks per trial, and the trials of
    # the warm batch (every trial launches one kernel per front stack)
    kkt = [v for key, v in SB._BATCHED_CACHE.items() if key[-1] == "kkt"][-1]
    bs = kkt.symb
    per_trial = sum(it.steps if isinstance(it, SC._BucketScan) else
                    it.count if isinstance(it, SC._Chain) else 1 for it in bs.schedule)
    trials = fact_launches / per_trial
    flops = roofline.schedule_flops(bs) * batch
    nbytes = roofline.schedule_bytes(bs, 8) * batch
    return {
        "pattern": pattern, "precision": precision, "batch": batch,
        "m": qps[0].ncon, "n": qps[0].nvar,
        "solved": sum(r.status.name == "SOLVE_SUCCEEDED" for r in res),
        "iters": [r.iter for r in res], "cold_s": cold, "warm_s": warm,
        "instances_per_s": batch / warm,
        "launches_per_iter": launches / iters,
        "factor_launches_per_iter": fact_launches / iters,
        "front_stacks_per_trial": per_trial, "factorization_trials": trials,
        "idle_share": prof["idle_share"], "profiled_wall_s": prof["wall_s"],
        "kernel_ms": prof["kernel_ms"], "factor_kernel_ms": factor_ms,
        "schedule_flops_x_batch": flops, "schedule_bytes_x_batch": nbytes,
        "factor_rate": roofline.roofline_report(
            flops * trials, nbytes * trials, max(factor_ms, 1e-9) / 1e3,
            dtype="float64"),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def run_serial(torch, mt, pattern, precision):
    gen, kw = PATTERNS[pattern]
    qps = [getattr(mt, gen)(seed=s, **kw) for s in range(SERIAL)]
    opts = dict(OPTIONS, **PRECISIONS[precision])
    if precision == "mixed":
        # the batch's two-phase scheme: a float64 state, phase 2 on the card
        opts.update(endgame="f64", phase1_dtype="float64")
    mt.solve_sparse_lp(qps[0], mode="batched", device="cuda", **opts)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = [mt.solve_sparse_lp(qp, mode="batched", device="cuda", **opts) for qp in qps]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"instances": SERIAL, "wall_s": wall, "instances_per_s": SERIAL / wall,
            "iters": [r.iter for r in res]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", required=True, help="JSON file to write")
    parser.add_argument("--patterns", nargs="+", choices=sorted(PATTERNS),
                        default=["grid40", "grid100", "banded"])
    parser.add_argument("--batches", nargs="+", type=int, default=[8, 16, 32])
    parser.add_argument("--precisions", nargs="+", choices=sorted(PRECISIONS),
                        default=["f64", "mixed"])
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sparse_batched_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the checkout
    import madqp_tpu_torch as mt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    record = {"card": card, "configs": []}
    for pattern in args.patterns:
        for precision in args.precisions:
            serial = run_serial(torch, mt, pattern, precision)
            print(f"{pattern} {precision} serial: {serial}", flush=True)
            for batch in args.batches:
                rec = run_config(torch, mt, pattern, precision, batch)
                rec["serial"] = serial
                rec["speedup"] = rec["instances_per_s"] / serial["instances_per_s"]
                record["configs"].append(rec)
                print(json.dumps(rec), flush=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
