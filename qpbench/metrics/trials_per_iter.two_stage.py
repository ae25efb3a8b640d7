"""Factorization trials per iteration: `schur.scenarios` spans over `iter`
spans in the Schur-span block (`qpbench/schur_spans.py`); 1.0 when no
trial fails and regularization never escalates."""

from qpbench.schur_spans import readings


def read(run):
    return readings(run).get("trials_per_iter")
