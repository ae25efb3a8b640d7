#!/usr/bin/env python3
"""The program's spans on one CUDA card: their clock, and the syncs they
do not see.

Run from the root of a checkout:

    python3 tools/tracing_torch.py --out tracing.json [--workload mm_cvxqp_m.rotate]
        [--phases clock syncs]

* clock: a `torch.cuda._sleep` kernel launched inside a span `probe`,
  under the profiler with the card's activity only (and again with the
  host's too): the span mapped onto the profiler's clock through
  `utils.profiling.anchor()`, the launch call's and the kernel's times on
  it, and whether the trace of the card's activity alone holds the CUDA
  runtime calls (and their correlation with the kernels); then over one
  solve of the cell's last instance, how far each kernel's device start
  lies after its launch call (the error of timing a launch by the
  kernel's start).
* syncs: for each instance of the benchmark cell's pool (its
  configuration's size and options), after a warm solve, one solve with
  the recorder on: the `to_host` reads per iteration
  (`qpbench.spans.loop_readings`) and each span's ms per iteration (the
  `iter.*` phases); and one solve under
  `torch.cuda.set_sync_debug_mode("warn")`: every synchronizing
  operation by source line and the innermost span it ran in.

Prints the card's name and power limit first and the JSON record last;
writes the record to `--out`.
"""

import argparse
import collections
import json
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


class Cell:
    """The benchmark cell's instances and options (`qpbench/harness.py`)."""

    def __init__(self, name: str):
        from qpbench import harness

        cell = harness.load_json("workloads", f"{name}.json")
        config = harness.load_json("configs", f"{cell['config']}.json")
        self.entry = harness.find("entries", cell["entry"])
        pool, _ = harness.find("generators", config["generator"]).make_pool(
            config, cell["traffic_params"], 0)
        self.problems = [self.entry.prepare(call) for call in pool]
        self.options = config["options"]

    def solve(self, i: int) -> int:
        """Call `i` of the pool on the card; the iterations it took."""
        raw, _ = self.entry.call(self.problems[i], self.options, "cuda")
        return sum(a.iters for a in self.entry.answers(raw))


def clock(cell: Cell):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from madqp_tpu_torch.utils import profiling as P

    rows = []
    for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            torch.cuda.synchronize()
            P.enable()
            with profile(activities=acts) as prof:
                with P.span("probe"):
                    torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
            P.disable()
            (probe,) = [s for s in P.drain() if s.name == "probe"]
            lo, hi = P.to_profiler_ns(probe.start_ns), P.to_profiler_ns(probe.end_ns)
            events = list(prof.profiler.kineto_results.events())
            kernel = [e for e in events if e.device_type() == DeviceType.CUDA]
            host = [e for e in events if e.device_type() != DeviceType.CUDA]
            launch = [e for e in host if "Launch" in e.name()]
            mirror = [e for e in host if e.name() == "probe"]
            row = {"activities": [str(a) for a in acts],
                   "host_event_names": sorted({e.name() for e in host})[:20],
                   "span_us": (hi - lo) / 1e3}
            if kernel:
                k = kernel[0]
                row.update(kernel=k.name(), kernel_corr=k.correlation_id(),
                           kernel_start_after_span_us=(k.start_ns() - lo) / 1e3,
                           kernel_end_after_span_end_us=(k.start_ns() + k.duration_ns() - hi) / 1e3)
            if launch:
                e = launch[0]
                row.update(launch=e.name(), launch_corr=e.correlation_id(),
                           launch_after_span_start_us=(e.start_ns() - lo) / 1e3,
                           launch_end_before_span_end_us=(hi - e.start_ns() - e.duration_ns()) / 1e3)
            if mirror:
                m = mirror[0]
                row.update(record_function_start_minus_span_us=(m.start_ns() - lo) / 1e3,
                           record_function_end_minus_span_us=(m.start_ns() + m.duration_ns() - hi)
                           / 1e3)
            rows.append(row)
            print("clock", json.dumps(row), flush=True)

    # the error of timing a launch by its kernel's device start, over one solve
    last = len(cell.problems) - 1
    cell.solve(last)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cell.solve(last)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    runtime = {e.correlation_id(): e.start_ns() for e in events
               if e.device_type() != DeviceType.CUDA and "Launch" in e.name()}
    lags, unmatched = [], 0
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.name().startswith(("Memcpy", "Memset")):
            t = runtime.get(e.correlation_id())
            if t is None:
                unmatched += 1
            else:
                lags.append((e.start_ns() - t) / 1e3)
    lags.sort()
    q = statistics.quantiles(lags, n=100) if len(lags) > 1 else [float("nan")] * 99
    lag = {"kernels_matched": len(lags), "kernels_unmatched": unmatched,
           "lag_us_median": q[49], "lag_us_p90": q[89], "lag_us_p99": q[98],
           "lag_us_max": lags[-1] if lags else None, "lag_us_min": lags[0] if lags else None}
    print("launch lag", json.dumps(lag), flush=True)
    return {"probes": rows, "launch_lag": lag}


def syncs(cell: Cell):
    import torch

    from madqp_tpu_torch.utils import profiling as P
    from qpbench import spans

    out = {}
    for i in range(len(cell.problems)):
        cell.solve(i)
        torch.cuda.synchronize()
        P.enable()
        try:
            iters = cell.solve(i)
            torch.cuda.synchronize()
        finally:
            P.disable()
        recorded = P.drain()
        reads = spans.loop_readings(recorded, iters)
        phase_ms = collections.Counter()
        for s in recorded:
            phase_ms[s.name] += (s.end_ns - s.start_ns) / 1e6 / iters
        found = collections.Counter()

        def show(message, category, filename, lineno, file=None, line=None):
            rec = P._REC
            inner = rec.rows[rec.stack[-1]][0] if rec.stack else "-"
            where = f"{str(filename).replace(str(ROOT) + '/', '')}:{lineno}"
            found[(where, inner, str(message).split("\n")[0][:80])] += 1

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            saved, warnings.showwarning = warnings.showwarning, show
            torch.cuda.set_sync_debug_mode("warn")
            P.enable()
            try:
                cell.solve(i)
                torch.cuda.synchronize()
            finally:
                P.disable()
                torch.cuda.set_sync_debug_mode("default")
                warnings.showwarning = saved
        P.drain()
        rows = [{"where": w, "span": s, "message": m, "count": c}
                for (w, s, m), c in found.most_common()]
        out[f"call{i}"] = {"iters": iters, "reads": reads, "ms_per_iter": dict(phase_ms),
                           "syncs": rows}
        print("syncs call", i, "iters", iters, "reads", json.dumps(reads), flush=True)
        print("    ms per iteration", json.dumps(dict(phase_ms)), flush=True)
        for r in rows:
            print("   ", r["count"], r["where"], r["span"], r["message"], flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--workload", default="mm_cvxqp_m.rotate")
    ap.add_argument("--phases", nargs="*", default=["clock", "syncs"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/tracing_torch.py measures the CUDA card: none found")
    rec = {"card": card(), "torch": torch.__version__, "cuda": torch.version.cuda}
    print(rec["card"], flush=True)
    cell = Cell(args.workload)
    if "clock" in args.phases:
        rec["clock"] = clock(cell)
    if "syncs" in args.phases:
        rec["syncs"] = syncs(cell)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: rec[k] for k in ("card", "torch", "cuda")}))


if __name__ == "__main__":
    main()
