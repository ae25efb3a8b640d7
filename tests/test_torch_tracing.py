"""The program's spans and host reads (`madqp_tpu_torch/utils/profiling.py`)
on the CPU.

Off (the default) nothing is recorded and `span` is one shared no-op that
allocates nothing.  On, the MPC loop's phases nest under `iter`, every host
read of device values is a `sync.<site>` span, the sparse KKT's symbolic
analysis shows as a `construct.kkt` miss, and the returned statistics are
bit for bit those of an untraced solve.  The clock anchor puts a
`torch.profiler` range opened inside a span within that span.
"""

import collections
import tracemalloc
from collections import OrderedDict

import numpy as np
import pytest
import torch

import madqp_tpu_torch as mt
from madqp_tpu_torch.ops import _build
from madqp_tpu_torch.parallel import BatchedMPCSolver
from madqp_tpu_torch.solver import mpc
from madqp_tpu_torch.solver import sparse_common as SC
from madqp_tpu_torch.utils import profiling as P

QUIET = dict(print_level=40)


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with the recorder off and empty, so that
    no test (nor a worker's next test) inherits its spans."""
    P.disable()
    P.drain()
    yield
    P.disable()
    P.drain()


def _sparse_qp():
    return mt.random_qp(40, 20, seed=3)


def _solve(qp, **kw):
    return mt.MPCSolver(qp, device="cpu", **QUIET, **kw).solve()


def _traced(fn):
    P.enable()
    try:
        out = fn()
    finally:
        P.disable()
    return out, P.drain()


def _under(spans, s, name):
    """Whether span `s` lies inside a span called `name`."""
    while s.parent >= 0:
        s = spans[s.parent]
        if s.name == name:
            return True
    return False


def _stats_fields(st):
    return (st.status, st.objective, st.iter, st.primal_feas, st.dual_feas,
            st.complementarity, st.solution, st.multipliers, st.multipliers_L,
            st.multipliers_U, st.constraints)


def test_off_records_nothing():
    assert P.span("iter") is P._NOOP and P.span("solve", 3) is P._NOOP
    with P.span("iter") as s:
        assert s is None
    assert P.to_host(torch.tensor(2.5, dtype=torch.float64), "termination") == 2.5
    got = P.to_host(torch.arange(3.0), "finish", numpy=True)
    assert got.dtype == np.float64 and got.tolist() == [0.0, 1.0, 2.0]
    _solve(_sparse_qp(), kkt_system="sparse-augmented")
    assert P.drain() == []


def test_span_allocates_nothing_when_off():
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        # held, so that anything allocated in the module would still be live
        held = [P.span("iter.direction") for _ in range(1000)]
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, P.__file__)]
    grown = [d for d in after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "lineno") if d.size_diff > 0]
    assert grown == [] and len(set(map(id, held))) == 1


@pytest.mark.parametrize("kw", [dict(), dict(kkt_system="sparse-augmented")],
                         ids=["dense", "sparse-augmented"])
def test_stats_equal_with_tracing_on_and_off(kw):
    qp = _sparse_qp()
    off = _solve(qp, **kw)
    on, spans = _traced(lambda: _solve(qp, **kw))
    assert spans
    for a, b in zip(_stats_fields(off), _stats_fields(on)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(kkt_system="sparse-augmented")],
                         ids=["dense", "sparse-augmented"])
def test_iteration_spans(kw, monkeypatch):
    calls = []
    step = mpc.MPCKernel.iteration

    def counted(self, p, state):
        calls.append(1)
        return step(self, p, state)

    monkeypatch.setattr(mpc.MPCKernel, "iteration", counted)
    stats, spans = _traced(lambda: _solve(_sparse_qp(), **kw))
    names = collections.Counter(s.name for s in spans)
    assert names["iter"] == len(calls) > stats.iter > 0
    assert names["solve"] == 1 and names["construct"] == 1
    for s in spans:
        if s.name.startswith("iter."):
            assert spans[s.parent].name == "iter", s
        if s.name.startswith("sync.") and s.name != "sync.finish":
            assert _under(spans, s, "iter"), s   # every read of the loop
        assert s.start_ns <= s.end_ns
    solve = next(s for s in spans if s.name == "solve")
    assert all(s.solve == solve.solve > 0 for s in spans if s.name.startswith(("iter", "sync")))
    assert {"iter.residuals", "iter.factorize", "iter.direction", "iter.step",
            "sync.termination", "sync.factor_ok", "sync.dir_failed", "sync.finish"} <= set(names)
    # one factorization trial, at least, per call that did the work
    assert names["iter.factorize"] >= names["iter.direction"] == names["iter.step"]
    assert names["sync.factor_ok"] == names["iter.factorize"]
    assert [s.value for s in spans if s.name == "iter"][:2] == [0, 0]


def test_sparse_syncs_per_iteration():
    stats, spans = _traced(lambda: _solve(_sparse_qp(), kkt_system="sparse-augmented"))
    inside = [s for s in spans if s.name.startswith("sync.") and _under(spans, s, "iter")]
    assert len(inside) / stats.iter >= 3
    # the starting point and the last check besides the iterations
    assert sum(s.name == "iter" for s in spans) == stats.iter + 2


def test_symbolic_miss_then_hit(monkeypatch):
    monkeypatch.setattr(SC, "_KERNEL_CACHE", OrderedDict())
    qp = _sparse_qp()
    kw = dict(device="cpu", kkt_system="sparse-augmented", **QUIET)
    _, spans = _traced(lambda: [mt.MPCSolver(qp, **kw) for _ in range(2)])
    kkt = [s for s in spans if s.name == "construct.kkt"]
    assert [s.value for s in kkt] == [True, False]
    assert all(spans[s.parent].name == "construct" for s in kkt)
    assert kkt[0].end_ns - kkt[0].start_ns > kkt[1].end_ns - kkt[1].start_ns


def test_anchor_maps_profiler_ranges_into_spans():
    from torch.profiler import ProfilerActivity, profile, record_function

    P.enable()
    wall, perf = P.anchor()
    assert abs(P.to_profiler_ns(perf) - wall) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("probe"):
            with record_function("inner"):
                torch.ones(64).cumsum(0)
    P.disable()
    (probe,) = P.drain()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    inner, mirrored = events["inner"], events["probe"]   # the span's own range
    lo, hi = P.to_profiler_ns(probe.start_ns), P.to_profiler_ns(probe.end_ns)
    slack = 100_000   # ns
    assert lo - slack <= inner.start_ns() <= inner.end_ns() <= hi + slack
    assert mirrored.start_ns() <= inner.start_ns() and inner.end_ns() <= mirrored.end_ns()


def test_drain_keeps_open_spans():
    P.enable()
    with P.span("solve"):
        with P.span("iter", 0):
            pass
        first = P.drain()
        with P.span("iter", 1):
            pass
    second = P.drain()
    assert [(s.name, s.parent) for s in first] == [("iter", -1)]
    assert [(s.name, s.value, s.parent) for s in second] == [("solve", None, -1), ("iter", 1, 0)]
    assert second[0].solve == second[1].solve == first[0].solve > 0


def test_batched_spans_and_reads():
    qps = [mt.random_qp(12, 6, seed=s) for s in range(3)]
    solver = BatchedMPCSolver.from_problems(qps, device="cpu", **QUIET)
    stats, spans = _traced(solver.solve_all)
    names = collections.Counter(s.name for s in spans)
    assert all(st.status.name == "SOLVE_SUCCEEDED" for st in stats)
    assert names["iter"] == names["sync.work"] > 0
    assert names["sync.retry"] >= names["iter.direction"] > 0
    for s in spans:
        if s.name.startswith("iter."):
            assert spans[s.parent].name == "iter", s


def test_krylov_reads():
    qp = mt.banded_sparse_lp(120, 60, band=4, seed=1)
    stats, spans = _traced(lambda: _solve(qp, kkt_system="sparse-normal",
                                          factorization_dtype="float32", endgame="krylov"))
    assert stats.status.name == "SOLVE_SUCCEEDED"
    assert any(s.name == "sync.pcg" for s in spans)


def test_kernel_load_span_and_build_count(monkeypatch):
    from madqp_tpu_torch import native

    monkeypatch.setattr(_build, "_loaded", {})
    built = _build.library_path(native.SOURCE).exists()
    before = _build.build.builds[native.SOURCE.name]
    try:
        _, spans = _traced(native._load)
    except RuntimeError as e:   # no host compiler: the build itself failed
        pytest.skip(str(e))
    (load,) = [s for s in spans if s.name == "kernel.load"]
    assert load.value == native.SOURCE.name
    assert _build.build.builds[native.SOURCE.name] == before + (0 if built else 1)
