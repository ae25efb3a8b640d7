"""The S stack factorization's share of its roofline: the least time an
H100 takes to factor the (N, ms, ms) stack (`schur_spans.s_factor_bound_ms`,
counted from the shape, whatever route factors it) over the device time
of the operations launched inside each `schur.factor_S` span, in percent
(`qpbench/schur_spans.py`)."""

from qpbench.schur_spans import readings


def read(run):
    return readings(run).get("s_factor_bound_pct")
