"""Share of the calls' wall in which no operation ran on the card:
100 (1 - busy / wall).  Busy is the union of the device intervals of the
device-traced block; the wall is the untraced block's, which makes the
same calls (the same instances in the same order, so the same device
work) without the profiler's cost on the host, which stretches even a
trace of the card's activity alone."""


def read(run):
    if not run.trace or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)
