"""Profiling helpers (port of `madqp_tpu/utils/profiling.py`), and the
program's own spans and host reads.

* `trace(log_dir)`: a `torch.profiler` trace of the enclosed block (the
  host, and the card's kernels when there is one), written to `log_dir` as
  a Chrome trace (chrome://tracing, Perfetto, TensorBoard).
* `device_profile(run)`: one call of `run` under the profiler: its wall,
  the card's busy time (the union of the intervals in which an operation
  ran on it) and launches by kernel name, the host's time in CUDA runtime
  calls by name, and the idle share 1 - busy / wall (the profiler's own
  host cost inflates the wall, so the share is an upper bound).
* Spans: `enable()` turns the recorder on and `disable()` off; it is off
  by default.  `span(name)` times the enclosed block on
  `time.perf_counter_ns()` with its parent span and the `solve()` it
  belongs to; off, it returns one shared no-op context manager and reads
  no clock.  `drain()` hands over the spans recorded so far.  While a
  `torch.profiler` runs, each span also opens a `record_function` of its
  name, so the program's phases show in an operator's trace.
* Host reads: `to_host(tensor, site)` is the one way the solver loop reads
  device values (each read waits for the card to finish the work queued
  before it).  Off, it is `tensor.tolist()`; on, the read is also a span
  `sync.<site>`, so the reads are counted and their waits timed.
* `anchor()`: the pair (`time.time_ns()`, `time.perf_counter_ns()`) read
  back to back when the recorder was enabled.  A `torch.profiler` event's
  `start_ns()` is on the first clock, the spans on the second:
  `to_profiler_ns` maps a span's time onto the profiler's timeline.

The layer boundaries the spans mark: `solve` (`MPCSolver.solve`,
`solve_two_stage`), `construct` and `construct.kkt` (the solver's
construction and the sparse KKT's pattern-cache lookup, `value` True where
the symbolic analysis ran), `kernel.load` (a CUDA library built or
loaded), `iter` (one call of an MPC kernel's `iteration`, `value` the
iteration count of a single solve) and its phases `iter.residuals`,
`iter.factorize` (one per factorization trial), `iter.direction` and
`iter.step`; inside the two-stage Schur KKT `schur.scenarios` (a trial's
scenario stacks: S = W U^-1 W', its factor, X = S^-1 T), within it
`schur.factor_S` (the S stack's factorization alone), `schur.first` (the
first-stage Schur complement and its factors) and `schur.solve`.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import NamedTuple, Optional

import torch


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    `log_dir/trace.json` (the profiler's record_function ranges, the
    program's spans among them, included)."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def union_ns(intervals) -> int:
    """The length of the union of [start, end) intervals: time in which
    any of them runs, overlaps counted once."""
    total, cur = 0, None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur is not None else 0)


def device_profile(run):
    """Profile one call of `run`.  Returns (its result, a dict: wall_s,
    kernel_ms (the card's busy time: the union of its operations'
    intervals), idle_share, kernel_ms_by_name, launches_by_name and
    runtime_ms_by_name, the host's CUDA runtime calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    cuda = torch.cuda.is_available()
    with profile(activities=_activities()) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ns, launches = collections.Counter(), collections.Counter()
    runtime_ns, intervals = collections.Counter(), []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            intervals.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            busy_ns[e.name()] += e.duration_ns()
            launches[e.name()] += 1
        elif e.name().startswith("cuda"):  # a CUDA runtime call, on the host
            runtime_ns[e.name()] += e.duration_ns()
    busy_ms = union_ns(intervals) / 1e6
    return out, {"wall_s": wall, "kernel_ms": busy_ms,
                 "idle_share": 1.0 - busy_ms / (wall * 1e3),
                 "kernel_ms_by_name": {k: v / 1e6 for k, v in busy_ns.most_common()},
                 "launches_by_name": dict(launches.most_common()),
                 "runtime_ms_by_name": {k: v / 1e6 for k, v in runtime_ns.most_common()}}


# -- the program's spans --------------------------------------------------


class Span(NamedTuple):
    """One recorded span: times on `time.perf_counter_ns()`; `parent` the
    index of the enclosing span in the same `drain()` (-1 for none);
    `solve` the id of the `solve()` it belongs to (0 for none); `value`
    what the span was opened with (an iteration count, a cache miss)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    solve: int
    value: object


class _Recorder:
    """The process's span recorder (one thread: the solver loop's)."""

    def __init__(self):
        self.on = False
        self.anchor: Optional[tuple] = None
        self.rows: list = []      # [name, start, end, parent, solve, value]
        self.stack: list = []     # indices of the open spans
        self.solves = 0


_REC = _Recorder()
_NOOP = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("row", "rf")

    def __init__(self, name: str, value):
        self.row = [name, 0, 0, -1, 0, value]
        self.rf = None

    def __enter__(self):
        row, rec = self.row, _REC
        if rec.stack:
            parent = rec.rows[rec.stack[-1]]
            row[3], row[4] = rec.stack[-1], parent[4]
        if row[0] == "solve":
            rec.solves += 1
            row[4] = rec.solves
        rec.stack.append(len(rec.rows))
        rec.rows.append(row)
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(row[0])
            self.rf.__enter__()
        row[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.row[2] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _REC.stack.pop()
        return False


def enable() -> None:
    """Turn the recorder on and read the clock anchor."""
    _REC.on = True
    _REC.anchor = (time.time_ns(), time.perf_counter_ns())


def disable() -> None:
    """Turn the recorder off; spans recorded so far stay for `drain()`."""
    _REC.on = False


def anchor() -> Optional[tuple]:
    """(time.time_ns(), time.perf_counter_ns()) read back to back at the
    last `enable()`; None before it."""
    return _REC.anchor


def to_profiler_ns(perf_ns: int) -> int:
    """A span time mapped onto the `torch.profiler` timeline (its events'
    `start_ns()`), through the anchor."""
    wall, perf = _REC.anchor
    return perf_ns - perf + wall


def span(name: str, value=None):
    """A context manager that records the enclosed block as span `name`
    (with `value`) while the recorder is on; off, the shared no-op."""
    if not _REC.on:
        return _NOOP
    return _OpenSpan(name, value)


def drain() -> list:
    """The spans closed since the last drain, as `Span`s in the order they
    were opened, parents by index into this list (-1 for a parent still
    open); spans still open stay with the recorder."""
    rec = _REC
    keep = set(rec.stack)
    done = [i for i in range(len(rec.rows)) if i not in keep]
    index = {old: new for new, old in enumerate(done)}
    out = [Span(r[0], r[1], r[2], index.get(r[3], -1), r[4], r[5])
           for r in (rec.rows[i] for i in done)]
    rec.rows = [rec.rows[i] for i in rec.stack]
    rec.stack = list(range(len(rec.rows)))
    for i, r in enumerate(rec.rows):
        r[3] = i - 1 if i else -1
    return out


def to_host(tensor: torch.Tensor, site: str, numpy: bool = False):
    """Read `tensor` on the host: `tensor.tolist()` (a Python scalar for a
    0-d tensor) or, with `numpy`, a float64 NumPy copy.  While the
    recorder is on the read is also the span `sync.<site>`: its count is
    the number of host syncs at `site`, its length their wait."""
    if not _REC.on:
        return _read(tensor, numpy)
    with _OpenSpan("sync." + site, None):
        return _read(tensor, numpy)


def _read(tensor: torch.Tensor, numpy: bool):
    return tensor.detach().to("cpu", torch.float64).numpy() if numpy else tensor.tolist()
