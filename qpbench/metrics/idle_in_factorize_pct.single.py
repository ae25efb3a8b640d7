"""Share of the device's idle time, in the program spans' device-traced
block, that falls inside `iter.factorize` spans (the assembly and the
fronts' launches; `qpbench/spans.py`)."""

from qpbench.spans import readings


def read(run):
    return readings(run).get("idle_in_factorize_pct")
