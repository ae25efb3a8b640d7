"""Share of the device's idle time, in the program spans' device-traced
block, that falls inside `iter.direction` spans (the sweeps,
refinement and residual checks; `qpbench/spans.py`)."""

from qpbench.spans import readings


def read(run):
    return readings(run).get("idle_in_direction_pct")
