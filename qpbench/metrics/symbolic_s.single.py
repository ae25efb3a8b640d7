"""Seconds of the sparse KKT's symbolic analysis in a fresh process's
set-up: the `construct.kkt` spans that missed the pattern cache, one
call per instance (`qpbench/spans.py`)."""

from qpbench.spans import readings


def read(run):
    return readings(run).get("symbolic_s")
