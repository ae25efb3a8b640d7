"""The benchmark's driver: one run of one cell.

Everything is found by name.  `BENCHMARK.json` lists the cells and the
metrics; a cell is `workloads/<cell>.json` (its configuration, entry,
traffic parameters and check), a configuration `configs/<name>.json`
(sizes and solver options), its generator `generators/<generator>.py`
(`make_pool`), its plain reference `reference/<name>.py` (`solve`), the
timed call `entries/<entry>.py` (`prepare`, `call`), and each metric a
reader `metrics/<metric>.py` (`read(run)`, None where it finds nothing to
read).  A later cell, configuration or metric is a new file and a new line
of `BENCHMARK.json`.

A run: the instance pool from the seed, the program's problems, the warm
calls (set-up ends there), then the window: calls one after another, each
timed on the host clock, until `--seconds` have passed and the calls made
are a multiple of the cell's `window_multiple` (closed loop, one caller;
a window of whole rotations of the pool gives every seed the same work).
With `--trace 1` the window is three blocks of the cell's `trace_calls`
calls instead: one untraced (the spans and iterations), one under the
profiler with device activity only (busy seconds, kernels and the
window's wall, which the host-side tracing would stretch), and one with
host activity too, which only names the idle gaps of the breakdown.
After the window the answers kept from it are judged (`compare.judge`)
and the metrics read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from qpbench import compare
from qpbench.problem import seed_sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names the run must not hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "madqp_tpu")


@dataclasses.dataclass
class Call:
    wall_s: float
    spans: dict              # the entry's spans ("construct_s")
    statuses: list
    iters: list


@dataclasses.dataclass
class Run:
    setup_s: float
    window_s: float          # the window's wall; traced: the untraced block's
    calls: list
    trace: dict = None       # trace.summarize of the device-only traced block
    traced_calls: list = None  # the calls of that block


def load_json(*parts) -> dict:
    return json.loads(HERE.joinpath(*parts).read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(kind: str, name: str):
    """The module `qpbench/<kind>/<name>.py` (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    key = f"qpbench.{kind}._{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: the end-to-end ones without
    trace, the per-layer ones with it (each listed for the cell, or for
    every cell when it names none)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(f"qpbench: {msg}", file=sys.stderr, flush=True)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, t0: float,
        device="cuda", cell: dict = None, config: dict = None, entry=None) -> dict:
    """One run; returns the result line's object.  `cell`, `config` and
    `entry` replace what the name finds (the tests run small copies, and
    the control puts the reference in the program's place)."""
    cell = cell or load_json("workloads", f"{cell_name}.json")
    config = config or load_json("configs", f"{cell['config']}.json")
    traffic = cell["traffic_params"]
    entry = entry or find("entries", cell["entry"])
    options = config["options"]

    pool, start = find("generators", config["generator"]).make_pool(config, traffic, seed)
    problems = [entry.prepare(call) for call in pool]
    rng = np.random.default_rng(seed_sequence(seed, 1))
    kept, k = [], 0

    def call():
        nonlocal k
        i = (start + k) % len(pool)
        k += 1
        t = time.perf_counter()
        raw, spans = entry.call(problems[i], options, device)
        _sync(device)
        wall = time.perf_counter() - t
        answers = entry.answers(raw)
        kept.extend((i, lane, answers[lane]) for lane in sample_lanes(answers, cell["check"], rng))
        return Call(wall_s=wall, spans=spans, statuses=[a.status for a in answers],
                    iters=[a.iters for a in answers])

    def block(done):
        """Calls until `done(calls, seconds)` holds on a whole number of
        `window_multiple`s; (calls, wall seconds)."""
        calls, w0 = [], time.perf_counter()
        while True:
            calls.append(call())
            if (done(calls, time.perf_counter() - w0)
                    and len(calls) % traffic.get("window_multiple", 1) == 0):
                return calls, time.perf_counter() - w0

    log(f"pool of {len(pool)} calls at {time.perf_counter() - t0:.2f} s")
    for _ in range(traffic["warm_calls"]):
        log(f"warm call {k}: {call().wall_s:.3f} s")
    kept.clear()
    setup_s = time.perf_counter() - t0

    summary, traced, named_calls = None, [], []
    if not trace:
        calls, window_s = block(lambda calls, s: s >= seconds)
    else:
        from qpbench.trace import profiled

        n = traffic["trace_calls"]
        calls, window_s = block(lambda calls, s: len(calls) >= n)
        log(f"untraced: {len(calls)} calls in {window_s:.3f} s")
        traced, summary = profiled(lambda: block(lambda calls, s: len(calls) >= n), device,
                                   host=False)
        log(f"device-traced: {len(traced)} calls in {summary['window_s']:.3f} s")
        named_calls, named = profiled(lambda: block(lambda calls, s: len(calls) >= n), device,
                                      host=True)
        log(f"host-traced: {n} calls in {named['window_s']:.3f} s")
        summary["idle_gaps"] = named["idle_gaps"]
    log(f"window: {len(calls)} calls in {window_s:.3f} s: "
        + " ".join(f"{c.wall_s:.3f}" for c in calls))
    device_rec = device_info(device)
    del problems

    checks = compare.judge(pool, kept, cell["check"], find("reference", cell["config"]),
                           rng)
    log(f"{len(kept)} answers judged at {time.perf_counter() - t0:.2f} s")
    record = Run(setup_s=setup_s, window_s=window_s, calls=calls, trace=summary,
                 traced_calls=traced)
    metrics = {}
    for m in cell_metrics(benchmark(), cell_name, trace):
        value = find("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    statuses = [s for c in calls + traced + named_calls for s in c.statuses]
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(statuses),
        "failed": sum(s != "SOLVE_SUCCEEDED" for s in statuses),
        "metrics": metrics,
        "device": device_rec,
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def sample_lanes(answers, check: dict, rng) -> list:
    """The lanes of one call whose answers are kept for the check: a draw
    of `sample_per_call` from the seed, the lane that took the most
    iterations, and every lane that did not succeed."""
    n = len(answers)
    lanes = set(rng.choice(n, size=min(n, check["sample_per_call"]), replace=False).tolist())
    lanes.add(int(np.argmax([a.iters for a in answers])))
    lanes.update(j for j, a in enumerate(answers) if a.status != "SOLVE_SUCCEEDED")
    return sorted(lanes)
