"""Milliseconds the host waited in those reads (`sync.*` spans inside
`iter` spans) per iteration, in the program-span block
(`qpbench/spans.py`)."""

from qpbench.spans import readings


def read(run):
    return readings(run).get("sync_wait_ms_per_iter")
