"""Kernels launched inside `iter.direction` spans (by the launch time of
their CUDA runtime call) per iteration, in the program spans'
device-traced block (`qpbench/spans.py`)."""

from qpbench.spans import readings


def read(run):
    return readings(run).get("direction_launches_per_iter")
