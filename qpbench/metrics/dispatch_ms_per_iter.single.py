"""Milliseconds per iteration of the `iter` spans less the host reads
inside them: the host issuing the iteration's work, in the
program-span block (`qpbench/spans.py`)."""

from qpbench.spans import readings


def read(run):
    return readings(run).get("dispatch_ms_per_iter")
