"""The control of the check: the plain reference put in the program's place
and computed in float32, the precision below the configurations' float64.
A run with it has to come out not correct.

    python3 qpbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

For each seed: the cell's pool, one call (the whole cell's load: every
lane of the call) answered by the reference in float32, and the check of a
benchmark run on those answers; prints one JSON line per seed with the
numbers compared and `correct`.  The float32 method stops where it stalls
and reports success whatever it reached, so only the check's numbers can
catch it.  It runs on the host (NumPy) and needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


class ControlEntry:
    """An entry whose calls the reference answers in `dtype`."""

    def __init__(self, reference, dtype=np.float32):
        self.reference, self.dtype = reference, dtype

    def prepare(self, instances):
        return instances

    def call(self, instances, options, device):
        from qpbench.compare import solve_groups

        return (instances, solve_groups(self.reference, instances, dtype=self.dtype)), {}

    def answers(self, raw):
        from qpbench.compare import Answer

        instances, results = raw
        out = []
        for p, (x, y, zl, zu, iters, _) in zip(instances, results):
            # the objective as the low precision computes it
            xl = x.astype(self.dtype)
            f = 0.5 * xl @ (p.H.astype(self.dtype) @ xl) + p.c.astype(self.dtype) @ xl
            out.append(Answer(status="SOLVE_SUCCEEDED", objective=float(f),
                              x=x.astype(np.float64), y=y.astype(np.float64),
                              zl=zl.astype(np.float64), zu=zu.astype(np.float64),
                              iters=int(iters)))
        return out


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from qpbench import harness

    cell = harness.load_json("workloads", f"{args.workload}.json")
    cell["traffic_params"] = {**cell["traffic_params"], "warm_calls": 0}
    entry = ControlEntry(harness.find("reference", cell["config"]))
    for seed in args.seed:
        result = harness.run(args.workload, seed, 0.0, False, t0=t0, device="cpu", cell=cell,
                             entry=entry)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
