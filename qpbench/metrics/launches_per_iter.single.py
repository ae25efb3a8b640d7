"""Kernels launched in the device-traced block (the profiler's device
events, copies and fills left out) per iteration of its solves."""

from qpbench.trace import launches


def read(run):
    iters = sum(sum(c.iters) for c in run.traced_calls or [])
    count = launches(run.trace) if run.trace else 0
    return count / iters if count and iters else None
