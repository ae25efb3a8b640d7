"""The Schur path's spans, for the per-layer metrics of the two-stage cell
(`madqp_tpu_torch.utils.profiling`, opened in `parallel/structured.py`:
`schur.scenarios` per factorization trial (forming the scenarios' S
stack, factoring it, X = S^-1 T), `schur.factor_S` inside it (the S
stack's factorization alone), `schur.first` and `schur.solve`).

In a `--trace 1` run, once the harness's window and its check are over,
the readers make one block of `trace_calls` calls of the cell (its entry,
pool and options, taken from the `harness.run` that calls them, as
`spans.py` does) in the run's process, with the recorder on and, on a
card, under the profiler with the card's activity only.  From it:

* `scenario_factor_ms_per_iter`, `schur_solve_ms_per_iter`: the device
  time of the operations launched inside `schur.scenarios` and
  `schur.solve` spans (by the start of the CUDA runtime call that
  launched each, `spans.device_ops`), per iteration of the block's solves;
* `s_factor_bound_pct`: the S stack factorization's share of its
  roofline, 100 x (`s_factor_bound_ms` times the `schur.factor_S` spans)
  over the device time launched inside them;
* `trials_per_iter`: `schur.scenarios` spans over `iter` spans.

Without a card only `trials_per_iter` is read.  A program without the
recorder, or without the Schur spans, gives nothing to read: the metrics
are left out.  A reading that cannot be made is the line `qpbench: Schur
spans FAILED: <why>` on standard error, and the metrics are missing.
"""

from __future__ import annotations

import traceback

import numpy as np

from qpbench import spans

# The card's peaks the bound is taken against: one NVIDIA H100 SXM, dense
# float64 on the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
LAUNCHED_IN = {"scenario_factor_ms": "schur.scenarios", "schur_solve_ms": "schur.solve",
               "factor_S_ms": "schur.factor_S"}


def s_factor_bound_ms(stacks: int, n: int, itemsize: int) -> float:
    """The least time one H100 takes to factor a (stacks, n, n) stack of
    SPD matrices, whatever route factors it: the Cholesky operations,
    stacks n^3 / 3, at the float64 peak, or the bytes of reading the stack
    and writing its factor, 2 stacks n^2 itemsize, at the memory's peak,
    whichever is longer."""
    flops = stacks * n ** 3 / 3.0
    moved = 2.0 * stacks * n * n * itemsize
    return 1e3 * max(flops / PEAK_FLOPS, moved / PEAK_BYTES_PER_S)


def readings(run) -> dict:
    """The Schur-span readings of `run` (made once, then kept on it)."""
    got = getattr(run, "schur_spans", None)
    if got is None:
        got = {}
        try:
            got = _measure()
        except Exception as e:   # the readings missing, said loudly; the run kept
            traceback.print_exc()
            from qpbench import harness

            harness.log(f"Schur spans FAILED: {type(e).__name__}: {e}")
        run.schur_spans = got
    return got


def _measure() -> dict:
    prof = spans._recorder()
    if prof is None:
        return {}
    ctx = spans._context()
    if ctx is None:
        raise spans.Failed("not called from qpbench.harness.run")
    missing = [k for k in spans.CONTEXT_KEYS if k not in ctx]
    if missing:
        raise spans.Failed(f"harness.run holds no {', '.join(missing)}")
    if not ctx["trace"]:
        return {}
    from qpbench import harness

    cell, config, entry, device, pool = (ctx[k] for k in ("cell", "config", "entry", "device",
                                                           "pool"))
    problems = [entry.prepare(call) for call in pool]
    n = cell["traffic_params"]["trace_calls"]
    args = (entry, problems, ctx["start"], n, config["options"], device)
    prof.disable()
    prof.drain()
    prof.enable()
    try:
        if str(device) == "cpu":
            iters = spans._calls(*args)
        else:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as p:
                iters = spans._calls(*args)
    finally:
        prof.disable()
    recorded = prof.drain()
    out = span_readings(recorded)
    if str(device) != "cpu" and out:
        mapped = [s._replace(start_ns=prof.to_profiler_ns(s.start_ns),
                             end_ns=prof.to_profiler_ns(s.end_ns)) for s in recorded]
        stack = pool[0][0].blocks["W_s"]
        bound = s_factor_bound_ms(stack.shape[0], stack.shape[1], stack.element_size())
        out.update(device_readings(p.profiler.kineto_results.events(), mapped, iters, bound))
    harness.log(f"Schur spans: {n} calls, {iters} iterations, {out}")
    return out


def span_readings(recorded) -> dict:
    """`trials_per_iter` from the recorded spans (nothing without the
    Schur spans)."""
    names = [s.name for s in recorded]
    if "schur.scenarios" not in names or "iter" not in names:
        return {}
    return {"trials_per_iter": names.count("schur.scenarios") / names.count("iter")}


def launched_in(ops, recorded, name: str) -> float:
    """Device ms of the operations whose launch call starts inside a span
    `name` (spans of one name do not overlap)."""
    inside = sorted((s.start_ns, s.end_ns) for s in recorded if s.name == name)
    if not inside or not ops:
        return 0.0
    starts = np.array([s for s, _ in inside], dtype=np.int64)
    ends = np.array([e for _, e in inside], dtype=np.int64)
    launch = np.array([op[2] for op in ops], dtype=np.int64)
    j = np.searchsorted(starts, launch, side="right") - 1
    hit = (j >= 0) & (launch <= ends[np.maximum(j, 0)])
    ns = np.array([op[1] - op[0] for op in ops], dtype=np.int64)
    return float(ns[hit].sum()) / 1e6


def device_readings(events, recorded, iters: int, bound_ms: float) -> dict:
    """The device readings of the profiled block (spans already on the
    profiler's clock)."""
    ops, timed = spans.device_ops(events)
    if not ops or not iters:
        return {}
    ms = {key: launched_in(ops, recorded, name) for key, name in LAUNCHED_IN.items()}
    out = {"scenario_factor_ms_per_iter": ms["scenario_factor_ms"] / iters,
           "schur_solve_ms_per_iter": ms["schur_solve_ms"] / iters,
           "ops_timed_by_their_launch": timed}
    factors = sum(s.name == "schur.factor_S" for s in recorded)
    if ms["factor_S_ms"] > 0:
        out["s_factor_bound_pct"] = 100.0 * bound_ms * factors / ms["factor_S_ms"]
    return out
