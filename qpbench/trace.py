"""The benchmark's reading of a `torch.profiler` trace of the card.

`profiled` runs a block of calls under the profiler, with the card's
activity only or with the host's too.  `summarize` reduces its trace to
what the per-layer readers need: the device's busy seconds as the union
of the intervals in which an operation ran on it (kernels, copies and
fills; never a sum, which would count overlapping work twice), the time
and count of every kernel by name, the longest idle gaps with the host
operation that was running in each, and the block's wall from the host
clock.
"""

from __future__ import annotations

import collections


def union_seconds(intervals) -> tuple[float, list]:
    """(the length of the union of [start, end) intervals in ns, as
    seconds; the gaps between the merged intervals, as (start, end))."""
    busy, gaps, cur = 0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e9, gaps


def profiled(block, device, host: bool):
    """(calls, summary) of `block()`, which returns (calls, wall seconds),
    run under `torch.profiler`: with `host`, host operations are recorded
    too (they name the idle gaps, and stretch the wall); without, only
    the card's."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host or device == "cpu" else []
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        calls, wall = block()
    return calls, summarize(prof, wall)


def summarize(prof, window_s: float, top: int = 10) -> dict:
    """What the readers take from the trace of one traced window."""
    import numpy as np
    from torch.autograd import DeviceType

    device, host_names, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((s, s + e.duration_ns(), e.name()))
        else:
            host.append((s, s + e.duration_ns()))
            host_names.append(e.name())
    busy_s, gaps = union_seconds((s, e) for s, e, _ in device)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name in device:
        kernels[name][0] += 1
        kernels[name][1] += (e - s) / 1e9
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = np.array(host, dtype=np.int64).reshape(-1, 2)
    idle = []
    for gs, ge in gaps[:top]:
        # the innermost host operation running in the middle of the gap
        mid = (gs + ge) // 2
        cover = np.flatnonzero((spans[:, 0] <= mid) & (mid <= spans[:, 1]))
        name = "host"
        if cover.size:
            name = host_names[cover[np.argmin(spans[cover, 1] - spans[cover, 0])]]
        idle.append([name, (ge - gs) / 1e9])
    ops = sorted(([name, t] for name, (_, t) in kernels.items()), key=lambda v: -v[1])
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": {name: {"count": c, "seconds": t} for name, (c, t) in kernels.items()},
        "device_ops": ops[:top],
        "idle_gaps": idle,
    }


def kernel_stats(summary: dict, *needles: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds one of
    `needles`."""
    count, seconds = 0, 0.0
    for name, k in summary["kernels"].items():
        if any(n in name for n in needles):
            count += k["count"]
            seconds += k["seconds"]
    return count, seconds


def launches(summary: dict) -> int:
    """The kernels launched in the window (copies and fills left out)."""
    return sum(k["count"] for name, k in summary["kernels"].items()
               if not name.startswith(("Memcpy", "Memset")))
