"""The readers of the program's spans (`qpbench/spans.py`): a traced small
run on the CPU reports the host-side ones and none of the device ones, a
program without the recorder gives nothing to read, and the arithmetic that
gives each idle gap to the spans and each kernel to its launch holds on
synthetic traces."""

import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from qpbench import harness, spans
from qpbench.tests.test_qpbench_harness import CELL, small

HOST = ("syncs_per_iter.single", "sync_wait_ms_per_iter.single",
        "dispatch_ms_per_iter.single", "symbolic_s.single")
DEVICE = ("idle_in_factorize_pct.single", "idle_in_direction_pct.single",
          "direction_launches_per_iter.single")


def S(name, start, end, parent=-1, value=None):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, parent=parent, solve=1,
                           value=value)


def _traced_small():
    cell, config = small()
    cell["traffic_params"] = {**cell["traffic_params"], "trace_calls": 3}
    return harness.run(CELL, 2 ** 31 + 11, 0.01, True, t0=time.perf_counter(), device="cpu",
                       cell=cell, config=config)


def test_traced_run_reports_the_host_readings():
    result = _traced_small()
    assert result["correct"] and result["attempted"] == 3 * 3
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(HOST) <= set(got) and not set(DEVICE) & set(got)
    # the termination read, a factorization trial or more, and the
    # direction's flag in every iteration that did the work
    assert got["syncs_per_iter.single"] >= 3
    assert got["dispatch_ms_per_iter.single"] > 0 and got["sync_wait_ms_per_iter.single"] >= 0
    assert got["symbolic_s.single"] > 0


def test_nothing_read_without_the_recorder(monkeypatch):
    """The parent program has no recorder: the readers find nothing."""
    monkeypatch.setattr(spans, "_recorder", lambda: None)
    run = SimpleNamespace()
    assert spans.readings(run) == {}
    for name in HOST + DEVICE:
        assert harness.find("metrics", name).read(run) is None


def test_outside_the_harness_the_readings_fail_loudly(capsys):
    assert spans.readings(SimpleNamespace()) == {}
    assert "qpbench: program spans FAILED: " in capsys.readouterr().err


def test_the_context_is_harness_runs_locals():
    """The readers take the cell from `harness.run`'s frame: every name
    they read is one of its locals."""
    code = harness.run.__code__
    assert set(spans.CONTEXT_KEYS) <= set(code.co_varnames) | set(code.co_cellvars)


@pytest.mark.parametrize("ctx", [{"trace": True}, "bad cell"])
def test_a_reading_not_made_fails_loudly(monkeypatch, capsys, ctx):
    """A context without the keys, and a fresh process that fails (here on
    a cell it cannot read), give the FAILED line and no readings."""
    if ctx == "bad cell":
        ctx = {k: None for k in spans.CONTEXT_KEYS} | {"trace": True, "device": "cpu",
                                                        "cell": {}, "config": {}}
    monkeypatch.setattr(spans, "_context", lambda: ctx)
    assert spans.readings(SimpleNamespace()) == {}
    assert "qpbench: program spans FAILED: " in capsys.readouterr().err


def test_idle_gaps_placed_before_the_launch_that_ends_them():
    # (device start, device end, host launch, name): B overlaps A on the
    # device; C comes 10 after them on the device, launched at host 38
    ops = [(10, 20, 5, "A"), (15, 30, 12, "B"), (40, 50, 38, "C")]
    assert spans.idle_gaps(ops, 0, 60) == [(0, 5), (28, 38), (48, 60)]
    assert spans.idle_gaps([], 5, 9) == [(5, 9)]


def test_attribution_of_idle_gaps():
    # iter [0, 100) holding factorize [10, 40) (with a read [30, 40)) and
    # direction [40, 90); a span-free stretch after 100
    tree = [S("iter", 0, 100), S("iter.factorize", 10, 40, 0), S("sync.factor_ok", 30, 40, 1),
            S("iter.direction", 40, 90, 0)]
    gaps = [(5, 15), (35, 45), (60, 70), (95, 120)]
    per_span, outside = spans.attribute(gaps, tree)
    assert per_span == [5 + 5, 5, 5, 5 + 10] and outside == 20
    assert sum(per_span) + outside == sum(e - s for s, e in gaps)
    # the pieces under each span sum to no more than the gaps inside it
    for i, s in enumerate(tree):
        under = sum(ns for j, ns in enumerate(per_span)
                    if any(a is s for a in spans._ancestors(tree, j)))
        inside = sum(max(0, min(e, s.end_ns) - max(b, s.start_ns)) for b, e in gaps)
        assert under == inside


def test_loop_readings():
    tree = [S("solve", 0, 1000), S("iter", 0, 400, 0), S("sync.termination", 10, 30, 1),
            S("iter", 400, 900, 0), S("iter.step", 800, 900, 3), S("sync.dir_failed", 850, 900, 4),
            S("sync.finish", 950, 990, 0)]
    got = spans.loop_readings(tree, 2)
    assert got == pytest.approx({"syncs_per_iter": 1.0, "sync_wait_ms_per_iter": 35 / 1e6,
                                 "dispatch_ms_per_iter": 830 / 2e6})
    cover = spans.coverage([S("construct", 0, 100)] + tree, 2000)
    assert cover == pytest.approx({"top": 0.55, "iter": 0.45, "construct": 0.05,
                                   "solve_outside_iter": 0.05, "finish_read": 0.02})


class E:
    def __init__(self, name, start, dur, cuda, corr):
        self.args = (name, start, dur, cuda, corr)

    def name(self):
        return self.args[0]

    def start_ns(self):
        return self.args[1]

    def duration_ns(self):
        return self.args[2]

    def device_type(self):
        return DeviceType.CUDA if self.args[3] else DeviceType.CPU

    def correlation_id(self):
        return self.args[4]


def test_device_block_readings():
    events = [E("cudaLaunchKernel", 45, 2, False, 1), E("k_sweep", 95, 10, True, 1),
              E("cudaLaunchKernel", 20, 2, False, 2), E("k_front", 50, 5, True, 2),
              E("Memcpy HtoD", 60, 1, True, 3), E("k_orphan", 70, 5, True, 9)]
    ops, timed = spans.device_ops(events)
    assert [(o[2], o[3]) for o in ops] == [(20, "k_front"), (60, "Memcpy HtoD"),
                                           (70, "k_orphan"), (45, "k_sweep")]
    assert timed == 0.5
    gaps = spans.idle_gaps(ops, 0, 120)
    # k_sweep ran 50 after its launch call: its gap of 20 ends at 45 on the
    # host, and what follows it on the device is placed through it
    assert gaps == [(0, 20), (55, 60), (61, 70), (25, 45), (55, 120)]
    tree = [S("iter", 0, 100), S("iter.factorize", 10, 40, 0), S("iter.direction", 40, 90, 0)]
    per_span, outside = spans.attribute(gaps, tree)
    assert per_span == [10 + 10, 10 + 15, 5 + 5 + 9 + 35] and outside == 20
    got = spans.device_readings(events, tree, 1, 0, 120)
    # launched inside direction: k_sweep (45) and k_orphan (70)
    assert got["direction_launches_per_iter"] == 2.0
    assert got["idle_in_factorize_pct"] == pytest.approx(100 * 25 / 119)
    assert got["idle_in_direction_pct"] == pytest.approx(100 * 54 / 119)
