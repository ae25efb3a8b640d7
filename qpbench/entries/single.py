"""One call: one instance through `MPCSolver(qp, ...)` and `.solve()`."""

from __future__ import annotations

import time

from qpbench import port


def prepare(instances):
    return [port.problem(p) for p in instances]


def call(problems, options, device):
    from madqp_tpu_torch import MPCSolver

    stats = []
    spans = {"construct_s": 0.0}
    for qp in problems:
        t0 = time.perf_counter()
        solver = MPCSolver(qp, device=device, **options)
        spans["construct_s"] += time.perf_counter() - t0
        stats.append(solver.solve())
    return stats, spans


def answers(stats):
    return [port.answer(s) for s in stats]
