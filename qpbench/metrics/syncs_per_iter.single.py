"""Host reads of device values (`to_host`, the program's `sync.<site>`
spans) inside the MPC loop's `iter` spans, per iteration, in the
program-span block (`qpbench/spans.py`)."""

from qpbench.spans import readings


def read(run):
    return readings(run).get("syncs_per_iter")
