"""Device milliseconds of the operations launched inside `schur.solve`
spans (the Schur system's solves: the streams over W, the S and first-stage
back-substitutions) per iteration, in the Schur-span block
(`qpbench/schur_spans.py`)."""

from qpbench.schur_spans import readings


def read(run):
    return readings(run).get("schur_solve_ms_per_iter")
