"""Seconds of the CUDA libraries' first loads (built already) in a fresh
process's set-up: the `kernel.load` spans (`qpbench/spans.py`)."""

from qpbench.spans import readings


def read(run):
    return readings(run).get("kernel_load_s")
