"""The program's own spans and host reads, for the per-layer metrics that
read them (`madqp_tpu_torch.utils.profiling`: `enable`, `span`, `drain`,
`to_host`'s `sync.<site>` spans).

The harness hands a reader the `Run` record alone, and turns no tracing
on.  So, in a `--trace 1` run, these readers make blocks of their own once
the harness's window and its check are over, with the cell's entry,
instances and options (taken from the `harness.run` that calls them), and
share what they read (`readings`):

* set-up, in a fresh process (its set-up is what a run pays, and no
  profiler has run in it) with the recorder on, one call per instance of
  the pool, as the harness's warm calls: the `construct.kkt` spans that
  ran the symbolic analysis (`symbolic_s`) and the `kernel.load` spans
  (`kernel_load_s`);
* spans, in that process: `trace_calls` calls with the recorder on: the
  host reads inside `iter` spans (`syncs_per_iter`, `sync_wait_ms_per_iter`)
  and the `iter` spans' time less those reads (`dispatch_ms_per_iter`),
  over the block's iterations;
* device (a card only), in the run's process: as many calls with the
  recorder on under the profiler with the card's activity only.  The
  spans are mapped onto the profiler's host clock through the recorder's
  anchor; each device-idle gap is placed on that clock before the launch
  call of the operation that ends it (`idle_gaps`), cut at the spans'
  boundaries, and each piece goes to the innermost span open over it
  (`idle_in_factorize_pct`, `idle_in_direction_pct`: shares of the
  block's idle time under `iter.factorize` and `iter.direction`); kernels
  launched inside `iter.direction` spans, by the start of their CUDA
  runtime launch call (`direction_launches_per_iter`).

Without the recorder in the program (before it had one) nothing is read.
With it, a reading that cannot be made (no `harness.run` frame holding
`CONTEXT_KEYS`, a child process that failed, an error on the card) is
the line `qpbench: program spans FAILED: <why>` on standard error, and
the metrics are missing from the result line.  Set-up that ran the
compiler (`ops/_build.py`'s `build.builds`), in the run or in the child,
is a warning line: `setup_s` or `kernel_load_s` then holds a build.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
IDLE_SPANS = ("iter.factorize", "iter.direction")
# the locals of `harness.run` the readers take the cell from
CONTEXT_KEYS = ("cell", "config", "entry", "device", "seed", "pool", "start", "trace")


class Failed(RuntimeError):
    """A program-span reading that could not be made."""


def readings(run) -> dict:
    """The program-span readings of `run` (made once, then kept on it)."""
    got = getattr(run, "program_spans", None)
    if got is None:
        got = {}
        try:
            got = _measure()
        except Exception as e:   # the readings missing, said loudly; the run kept
            traceback.print_exc()
            from qpbench import harness

            harness.log(f"program spans FAILED: {type(e).__name__}: {e}")
        run.program_spans = got
    return got


def _recorder():
    try:
        from madqp_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") else None


def _context():
    """The locals of the `harness.run` this reader is called from."""
    from qpbench import harness

    frame = sys._getframe(1)
    while frame is not None and frame.f_code is not harness.run.__code__:
        frame = frame.f_back
    return None if frame is None else frame.f_locals


def _measure() -> dict:
    prof = _recorder()
    if prof is None:
        return {}
    ctx = _context()
    if ctx is None:
        raise Failed("not called from qpbench.harness.run")
    missing = [k for k in CONTEXT_KEYS if k not in ctx]
    if missing:
        raise Failed(f"harness.run holds no {', '.join(missing)}")
    if not ctx["trace"]:
        return {}
    from qpbench import harness

    cell, config, entry, device = ctx["cell"], ctx["config"], ctx["entry"], ctx["device"]
    _warn_builds("the run's set-up", _builds())
    out = fresh_process_readings(cell, config, ctx["seed"], device)
    _warn_builds("the fresh process's set-up", out.pop("kernel_builds", {}))
    harness.log(f"program spans, fresh process: {out.get('calls')} calls in "
                f"{out.get('wall_s')} s, shares of the wall {out.get('coverage')}")
    if device == "cpu":
        return out
    from torch.profiler import ProfilerActivity, profile

    pool, start = ctx["pool"], ctx["start"]
    problems = [entry.prepare(call) for call in pool]
    prof.disable()
    prof.drain()
    prof.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            b0 = prof.to_profiler_ns(time.perf_counter_ns())
            iters = _calls(entry, problems, start, cell["traffic_params"]["trace_calls"],
                           config["options"], device)
            b1 = prof.to_profiler_ns(time.perf_counter_ns())
    finally:
        prof.disable()
    spans = [s._replace(start_ns=prof.to_profiler_ns(s.start_ns),
                        end_ns=prof.to_profiler_ns(s.end_ns)) for s in prof.drain()]
    out.update(device_readings(p.profiler.kineto_results.events(), spans, iters, b0, b1))
    harness.log(f"program spans, device-traced: {(b1 - b0) / 1e9:.3f} s, device operations "
                f"timed by their launch call {out.get('ops_timed_by_their_launch')}")
    return out


def _builds() -> dict:
    """Compiler runs of this process so far, by source file."""
    from madqp_tpu_torch.ops import _build

    return dict(getattr(_build.build, "builds", {}))


def _warn_builds(where: str, builds: dict) -> None:
    if builds:
        from qpbench import harness

        harness.log(f"warning: {where} ran the compiler ({builds}): its seconds hold the "
                    "build, not a load")


def _calls(entry, problems, start: int, n: int, options: dict, device) -> int:
    """`n` calls from `start` round the pool, as the harness makes them;
    the iterations they took."""
    from qpbench import harness

    iters = 0
    for k in range(n):
        raw, _ = entry.call(problems[(start + k) % len(problems)], options, device)
        harness._sync(device)
        iters += sum(a.iters for a in entry.answers(raw))
    return iters


# -- set-up and the spans block: a fresh process ----------------------------------


def fresh_process_readings(cell: dict, config: dict, seed: int, device) -> dict:
    """The set-up and spans-block readings of a fresh process, one in
    which no profiler has run."""
    job = json.dumps({"cell": cell, "config": config, "seed": seed, "device": str(device)})
    code = "from qpbench import spans; spans._child()"
    out = subprocess.run([sys.executable, "-c", code], input=job, cwd=ROOT, text=True,
                         capture_output=True, timeout=900)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise Failed(f"the fresh process exited with {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _child() -> None:
    """Set-up with the recorder on (one call per instance of the pool, as
    the harness's warm calls), then `trace_calls` calls with it on."""
    job = json.loads(sys.stdin.read())
    from madqp_tpu_torch.utils import profiling

    from qpbench import harness

    cell, config, device = job["cell"], job["config"], job["device"]
    traffic = cell["traffic_params"]
    profiling.enable()
    pool, start = harness.find("generators", config["generator"]).make_pool(
        config, traffic, job["seed"])
    entry = harness.find("entries", cell["entry"])
    problems = [entry.prepare(call) for call in pool]
    _calls(entry, problems, 0, len(problems), config["options"], device)
    profiling.disable()
    spans = profiling.drain()
    out = {"symbolic_s": _seconds(s for s in spans if s.name == "construct.kkt" and s.value),
           "kernel_builds": _builds()}
    loads = [s for s in spans if s.name == "kernel.load"]
    if loads:
        out["kernel_load_s"] = _seconds(loads)

    n = traffic["trace_calls"]
    profiling.enable()
    t0 = time.perf_counter_ns()
    iters = _calls(entry, problems, start, n, config["options"], device)
    wall_ns = time.perf_counter_ns() - t0
    profiling.disable()
    spans = profiling.drain()
    out.update(loop_readings(spans, iters), calls=n, wall_s=wall_ns / 1e9,
               coverage=coverage(spans, wall_ns))
    print(json.dumps(out))


def _seconds(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9


# -- the spans block -------------------------------------------------------------


def _ancestors(spans, i: int):
    """Span `i` and the spans it lies in, innermost first."""
    while i >= 0:
        yield spans[i]
        i = spans[i].parent


def loop_readings(spans, iters: int) -> dict:
    """Host reads inside `iter` spans, their wait, and the `iter` spans'
    time less those reads, per iteration."""
    if not iters or not any(s.name == "iter" for s in spans):
        return {}
    reads = [s for i, s in enumerate(spans) if s.name.startswith("sync.")
             and any(a.name == "iter" for a in _ancestors(spans, i))]
    wait = sum(s.end_ns - s.start_ns for s in reads)
    in_iter = sum(s.end_ns - s.start_ns for s in spans if s.name == "iter")
    return {"syncs_per_iter": len(reads) / iters,
            "sync_wait_ms_per_iter": wait / 1e6 / iters,
            "dispatch_ms_per_iter": (in_iter - wait) / 1e6 / iters}


def coverage(spans, wall_ns: int) -> dict:
    """Shares of a block's wall inside `construct` or `solve` spans, inside
    `iter` spans, inside `construct`, inside `solve` but outside any `iter`
    (starting state, summary, statistics), and of that last in the reads
    of the final state (`sync.finish`)."""
    def total(name):
        return sum(s.end_ns - s.start_ns for s in spans if s.name == name)

    top = total("construct") + total("solve")
    return {"top": top / wall_ns, "iter": total("iter") / wall_ns,
            "construct": total("construct") / wall_ns,
            "solve_outside_iter": (total("solve") - total("iter")) / wall_ns,
            "finish_read": total("sync.finish") / wall_ns}


# -- the device block --------------------------------------------------------------


def device_ops(events) -> tuple[list, float]:
    """[(device start, device end, host start, name)] of a profile's device
    operations (kernels, copies, fills) in device-start order, and the
    share of them whose host start is the start of the CUDA runtime (or
    driver) call that launched it, found by correlation id; the others,
    where the trace holds no such call, take their device start."""
    from torch.autograd import DeviceType

    runtime, ops = {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            ops.append(e)
        elif e.name().startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
    out = []
    for e in ops:
        start, launch = e.start_ns(), runtime.get(e.correlation_id())
        out.append((start, start + e.duration_ns(), start if launch is None else launch,
                    e.name()))
    out.sort()
    found = sum(e.correlation_id() in runtime for e in ops)
    return out, found / len(ops) if ops else 0.0


def idle_gaps(ops, begin: int, end: int) -> list:
    """The device's idle gaps within a block [begin, end) of the host
    clock, each placed on the host clock where the host caused it: a gap
    between two operations ends at the launch of the operation that ends
    it (the device waited for that launch), with its length on the device;
    the block's leading gap ends at the first launch, its trailing one
    starts where the last operation ended (through its own launch).  The
    device's timestamps are used only for lengths: over a block of
    seconds they stray from the host's by up to milliseconds."""
    if not ops:
        return [(begin, end)]
    gaps = [(begin, ops[0][2])] if ops[0][2] > begin else []
    busy_to, shift = ops[0][1], ops[0][0] - ops[0][2]
    for start, stop, launch, _ in ops[1:]:
        if start > busy_to:
            gaps.append((launch - (start - busy_to), launch))
        if stop > busy_to:
            busy_to, shift = stop, start - launch
    if end > busy_to - shift:
        gaps.append((busy_to - shift, end))
    return gaps


def attribute(gaps, spans) -> tuple[list, int]:
    """Each gap cut at the spans' boundaries, each piece given to the
    innermost span open over it: (idle ns per span, idle ns outside every
    span).  Spans nest (one thread, opened and closed in order), so the
    innermost span is fixed between two consecutive boundaries.  Gaps may
    overlap (each counts in full)."""
    times = [t for g in gaps for t in g] + [t for s in spans for t in (s.start_ns, s.end_ns)]
    t0 = min(times) if times else 0
    gs = np.sort(np.array([g[0] for g in gaps], dtype=np.int64) - t0)
    ge = np.sort(np.array([g[1] for g in gaps], dtype=np.int64) - t0)
    cs = np.concatenate([[0], np.cumsum(gs)])
    ce = np.concatenate([[0], np.cumsum(ge)])
    total = int(ce[-1] - cs[-1])

    def idle_until(t):
        """Idle ns of all gaps before time t (arrays of times)."""
        t = np.asarray(t, dtype=np.int64) - t0
        i, j = np.searchsorted(gs, t, side="right"), np.searchsorted(ge, t, side="right")
        return (i * t - cs[i]) - (j * t - ce[j])

    events = sorted([(s.end_ns, 0, -i) for i, s in enumerate(spans)]
                    + [(s.start_ns, 1, i) for i, s in enumerate(spans)])
    if not events:
        return [], total
    upto = idle_until([t for t, _, _ in events]).tolist()
    per_span, open_, outside = [0] * len(spans), [], upto[0] + total - upto[-1]
    for k, (t, kind, i) in enumerate(events):
        if k and open_:
            per_span[open_[-1]] += upto[k] - upto[k - 1]
        elif k:
            outside += upto[k] - upto[k - 1]
        if kind:
            open_.append(i)
        else:
            open_.remove(-i)
    return per_span, outside


def device_readings(events, spans, iters: int, begin: int, end: int) -> dict:
    """The device block's idle shares under `IDLE_SPANS` and the kernels
    launched inside `iter.direction` per iteration (spans and the block's
    [begin, end) already on the profiler's host clock)."""
    ops, timed = device_ops(events)
    if not ops or not iters:
        return {}
    per_span, outside = attribute(idle_gaps(ops, begin, end), spans)
    idle = sum(per_span) + outside
    out = {}
    for name in IDLE_SPANS:
        under = sum(ns for i, ns in enumerate(per_span)
                    if any(a.name == name for a in _ancestors(spans, i)))
        out[f"idle_in_{name.split('.')[1]}_pct"] = 100.0 * under / idle if idle else 0.0
    direction = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "iter.direction")
    starts = np.array([d[0] for d in direction], dtype=np.int64)
    ends = np.array([d[1] for d in direction], dtype=np.int64)
    t = np.array([launch for _, _, launch, name in ops
                  if not name.startswith(("Memcpy", "Memset"))], dtype=np.int64)
    j = np.searchsorted(starts, t, side="right") - 1
    inside = (j >= 0) & (t <= ends[np.maximum(j, 0)]) if len(starts) else np.zeros(0, bool)
    out["direction_launches_per_iter"] = float(inside.sum()) / iters
    out["ops_timed_by_their_launch"] = timed
    return out
