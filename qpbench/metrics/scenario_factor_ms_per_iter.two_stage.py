"""Device milliseconds of the operations launched inside the Schur path's
`schur.scenarios` spans (forming each trial's S stack, factoring it and
X = S^-1 T) per iteration, in the Schur-span block
(`qpbench/schur_spans.py`)."""

from qpbench.schur_spans import readings


def read(run):
    return readings(run).get("scenario_factor_ms_per_iter")
