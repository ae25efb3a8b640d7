"""Profiling helpers (port of `madqp_tpu/utils/profiling.py`).

* `trace(log_dir)`: a `torch.profiler` trace of the enclosed block (the
  host, and the card's kernels when there is one), written to `log_dir` as
  a Chrome trace (chrome://tracing, Perfetto, TensorBoard).
* `device_profile(run)`: one call of `run` under the profiler: its wall,
  the card's kernel time and launches by kernel name, the host's time in
  CUDA runtime calls by name, and the idle share 1 - kernel time / wall
  (the solves run on one stream, so kernels do not overlap; the
  profiler's own host cost inflates the wall, so the share is an upper
  bound).
* `time_solve_stages(solver)`: seconds per host stage of an `MPCSolver`:
  the symbolic phase of a sparse KKT, the set-up (standard form, upload,
  kernel binding), the pre-loop state, the whole loop, and the time the
  loop's host syncs wait (the termination flags, `factor_ok` per trial,
  the direction's failure flag: each reads device scalars, so it waits for
  the card to finish the work queued before it).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

# The tensor methods through which the solver loop reads device values on
# the host (each one a device sync on the card).
_SYNCS = ("item", "tolist", "__bool__", "__int__", "__float__")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    `log_dir/trace.json` (the profiler's record_function ranges included)."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_profile(run):
    """Profile one call of `run`.  Returns (its result, a dict: wall_s,
    kernel_ms (the card's busy time), idle_share, kernel_ms_by_name,
    launches_by_name and runtime_ms_by_name, the host's CUDA runtime
    calls)."""
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
    busy_us, launches = collections.Counter(), collections.Counter()
    runtime_us = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # device_time_total replaced cuda_time_total in newer releases
            busy_us[e.name] += (e.device_time_total if hasattr(e, "device_time_total")
                                else e.cuda_time_total)
            launches[e.name] += 1
        elif e.name.startswith("cuda"):  # a CUDA runtime call, on the host
            runtime_us[e.name] += e.cpu_time_total
    busy_ms = sum(busy_us.values()) / 1e3
    return out, {"wall_s": wall, "kernel_ms": busy_ms,
                 "idle_share": 1.0 - busy_ms / (wall * 1e3),
                 "kernel_ms_by_name": {k: v / 1e3 for k, v in busy_us.most_common()},
                 "launches_by_name": dict(launches.most_common()),
                 "runtime_ms_by_name": {k: v / 1e3 for k, v in runtime_us.most_common()}}


@contextlib.contextmanager
def _count_syncs():
    """Count the host's reads of tensor values (`_SYNCS`) inside the block
    and the seconds they take: yields a dict {"syncs", "sync_s"} that is
    filled as the block runs."""
    stats = {"syncs": 0, "sync_s": 0.0}
    saved = {name: getattr(torch.Tensor, name) for name in _SYNCS}

    def timed(fn):
        def inner(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                stats["syncs"] += 1
                stats["sync_s"] += time.perf_counter() - t0
        return inner

    for name, fn in saved.items():
        setattr(torch.Tensor, name, timed(fn))
    try:
        yield stats
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def time_solve_stages(solver, reps: int = 3) -> dict:
    """Host-stage timings of a port `MPCSolver` (its first-phase kernel),
    averaged over `reps` runs: `symbolic_s` (a sparse KKT's symbolic phase,
    built anew; 0 for the dense KKTs), `setup_s` (the solver's construction:
    standard form, upload, kernel binding, from its counters), `init_s`
    (the pre-loop state), `solve_s` (the whole stepped loop, the pre-loop
    state included), `sync_s` and `syncs` (the loop's host reads of device
    values, and the seconds they wait), `iters` and `s_per_iter`."""
    from ..solver.sparse_common import stepped_solve

    kernel, dev = solver.kernel, solver.device
    args = (solver.prob, solver._x0, solver._y0, solver._lb0, solver._ub0)
    symbolic = 0.0
    if getattr(solver, "_sparse", False):
        t0 = time.perf_counter()
        solver._sparse_make()
        symbolic = time.perf_counter() - t0
    init_t, solve_t, sync_t, syncs = [], [], [], []
    iters = 0
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        kernel.init_state(*args)
        _sync(dev)
        init_t.append(time.perf_counter() - t0)
        with _count_syncs() as st:
            t0 = time.perf_counter()
            final = stepped_solve(kernel, *args)
            _sync(dev)
            solve_t.append(time.perf_counter() - t0)
        sync_t.append(st["sync_s"])
        syncs.append(st["syncs"])
        iters = int(final.k)
    init_s = sum(init_t) / reps
    solve_s = sum(solve_t) / reps
    return {
        "symbolic_s": symbolic,
        "setup_s": float(solver.cnt.init_time),
        "init_s": init_s,
        "solve_s": solve_s,
        "sync_s": sum(sync_t) / reps,
        "syncs": sum(syncs) / reps,
        "iters": iters,
        "s_per_iter": (solve_s - init_s) / max(1, iters),
    }
