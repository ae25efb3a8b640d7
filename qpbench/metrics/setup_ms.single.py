"""Milliseconds per call in `MPCSolver(qp, ...)` (standard form, upload,
the KKT and its symbolic analysis from the pattern cache): the
benchmark's span around the construction, in calls made without the
profiler."""


def read(run):
    spans = [c.spans["construct_s"] for c in run.calls if "construct_s" in c.spans]
    return 1e3 * sum(spans) / len(spans) if spans else None
