"""Iterations per call (`ExecutionStats.iter`)."""


def read(run):
    return sum(sum(c.iters) for c in run.calls) / len(run.calls)
