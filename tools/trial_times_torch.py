#!/usr/bin/env python3
"""Host and device time of one factorization trial and one direction of
the sparse augmented KKT on one CUDA card, eager and replayed as a CUDA
graph (`solver/mpc.py::TrialGraph`, `DirectionGraph`), and the trials by
route over whole solves, on the benchmark's CVXQP1_M, 2_M and 3_M
(n = 1000, float64, tol 1e-8; `qpbench/configs/mm_cvxqp_m.json`).

Run from the root of a checkout:

    python3 tools/trial_times_torch.py [--iteration 3] [--repeats 7] [--solves 4]

For each instance the trial and the direction are those of the iteration
after `--iteration` calls (the starting point first); the trial is the
iteration's first (del_c = 0, which fails on CVXQP).  Host time is the
call's own wall time, up to its return (nothing is read back); device time
is the span between two CUDA events around it.  Each is the median of
`--repeats` calls after one untimed call (the graph's capture).  Then
`--solves` solves of the instance on one cached kernel, and the kernel's
trials and directions by route (`MPCKernel.factorizations`, `.directions`).
Prints one JSON line per instance.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OPTIONS = {"dtype": "float64", "tol": 1e-8, "print_level": 40, "kkt_system": "sparse-augmented"}


def timed(torch, fn, args, repeats):
    """[host ms, device ms], medians of `repeats` calls of fn(*args)."""
    fn(*args)
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(repeats):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn(*args)
        host.append(1e3 * (time.perf_counter() - t0))
        stop.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(stop))
    return [round(statistics.median(host), 3), round(statistics.median(device), 3)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iteration", type=int, default=3)
    parser.add_argument("--repeats", type=int, default=7)
    parser.add_argument("--solves", type=int, default=4)
    args = parser.parse_args()

    import torch

    import madqp_tpu_torch as mt
    from madqp_tpu_torch.solver.mpc import DirectionGraph, TrialGraph
    from qpbench import port
    from qpbench.generators.cvxqp import cvxqp

    for variant in (1, 2, 3):
        qp = port.problem(cvxqp(1000, variant))
        solver = mt.MPCSolver(qp, device="cuda", **OPTIONS)
        kernel, p = solver.kernel, solver.prob
        state = kernel.init_state(p, solver._x0, solver._y0, solver._lb0, solver._ub0)
        for _ in range(args.iteration):
            state = kernel.iteration(p, state)
        state, g, c_res, jacl, _, _ = kernel._residuals(p, state)
        del_w, del_c, _, _ = kernel._work_regularization(p, state)
        trial = (p, state.x, state.lb, state.ub, state.zl, state.zu, del_w, del_c)
        factors, del_w, del_c, ok = kernel.factorize_with_retry(*trial)
        direction = (p, state, factors, g, jacl, c_res, del_w, del_c)
        out = {"name": qp.name,
               "trial_eager_host_dev_ms": timed(torch, kernel._factorize, trial, args.repeats),
               "trial_replay_host_dev_ms": timed(torch, TrialGraph(kernel), trial, args.repeats),
               "direction_eager_host_dev_ms": timed(torch, kernel._direction, direction,
                                                    args.repeats),
               "direction_replay_host_dev_ms": timed(torch, DirectionGraph(kernel), direction,
                                                     args.repeats)}
        before = (dict(kernel.factorizations), dict(kernel.directions))
        iters = [mt.MPCSolver(qp, device="cuda", **OPTIONS).solve().iter
                 for _ in range(args.solves)]
        out.update(solves_iter=iters, trials_before=before[0], directions_before=before[1],
                   trials=dict(kernel.factorizations), directions=dict(kernel.directions))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
