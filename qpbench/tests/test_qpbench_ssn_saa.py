"""The two-stage cell `ssn_saa.replications` on the CPU: its files found by
name, small copies of it through `harness.run` (correct, traced, and the
float32 reference in the program's place not correct), and the cell run
from a copy of the benchmark to which only files and lines were added."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from qpbench import control, harness, schur_spans

ROOT = Path(__file__).resolve().parents[2]
QPB = ROOT / "qpbench"
CELL = "ssn_saa.replications"
NEW_METRICS = {"scenario_factor_ms_per_iter.two_stage", "schur_solve_ms_per_iter.two_stage",
               "s_factor_bound_pct.two_stage", "trials_per_iter.two_stage"}


def small(scenarios=4):
    """The cell and its configuration (SSN's widths) at `scenarios`
    scenarios."""
    cell = harness.load_json("workloads", f"{CELL}.json")
    config = harness.load_json("configs", "ssn_saa.json")
    config["scenarios"] = scenarios
    return cell, config


def test_found_by_name():
    bench = harness.benchmark()
    cell = harness.load_json("workloads", f"{CELL}.json")
    config = harness.load_json("configs", f"{cell['config']}.json")
    assert harness.find("generators", config["generator"]).make_pool
    assert harness.find("entries", cell["entry"]).call
    assert harness.find("reference", cell["config"]).solve
    assert {c["name"] for c in bench["configs"]} >= {"ssn_saa"}
    assert {w["name"]: w["chips"] for w in bench["workloads"]}[CELL] == 1
    e2e = {m["name"] for m in harness.cell_metrics(bench, CELL, False)}
    per_layer = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert e2e == {"setup_s", "solve_s"} and per_layer == NEW_METRICS
    for name in per_layer:
        assert callable(harness.find("metrics", name).read)


def test_small_copy_correct_and_traced():
    cell, config = small()
    for trace in (False, True):
        result = harness.run(CELL, 2 ** 31 + 3, 0.01, trace, t0=time.perf_counter(),
                             device="cpu", cell=cell, config=config)
        assert result["correct"], result["checks"]
        assert result["attempted"] % 3 == 0 and result["failed"] == 0
        assert set(result["checks"]) == {"bad_status", "kkt_res", "obj_res", "obj_gap"}
    # no card: only the span count is read
    assert set(result["metrics"]) == {"trials_per_iter.two_stage"}
    assert 0.5 < result["metrics"]["trials_per_iter.two_stage"]["value"] <= 1.0


def test_float32_reference_not_correct():
    cell, config = small()
    cell["traffic_params"] = {**cell["traffic_params"], "warm_calls": 0}
    entry = control.ControlEntry(harness.find("reference", cell["config"]))
    result = harness.run(CELL, 7, 0.0, False, t0=time.perf_counter(), device="cpu", cell=cell,
                         config=config, entry=entry)
    assert not result["correct"], result["checks"]


def test_s_factor_bound():
    """The bound of factoring the cell's S stack on one H100: its bytes
    (read the stack, write the factor) at 3.35 TB/s, longer than its
    operations at 67 TFLOP/s."""
    ms = schur_spans.s_factor_bound_ms(8192, 175, 8)
    assert abs(ms - 2 * 8192 * 175 ** 2 * 8 / 3.35e12 * 1e3) < 1e-12
    assert 8192 * 175 ** 3 / 3 / 67e12 * 1e3 < ms


def test_readings_of_the_device_block():
    """Device time is given to the span whose interval holds the
    operation's launch call; the bound's share counts every factor_S
    span."""
    from madqp_tpu_torch.utils.profiling import Span

    spans = [Span("iter", 0, 100, -1, 1, 0), Span("schur.scenarios", 10, 40, 0, 1, None),
             Span("schur.factor_S", 20, 30, 1, 1, None), Span("schur.solve", 50, 60, 0, 1, None),
             Span("iter", 100, 200, -1, 1, 1), Span("schur.scenarios", 110, 140, 4, 1, None),
             Span("schur.factor_S", 120, 130, 5, 1, None)]
    # (device start, device end, launch, name)
    ops = [(15, 2_000_015, 12, "gemm"), (25, 4_000_025, 22, "k1"), (55, 1_000_055, 52, "solve"),
           (125, 4_000_125, 121, "k1"), (300, 1_000_300, 150, "outside")]
    assert schur_spans.launched_in(ops, spans, "schur.scenarios") == 10.0
    assert schur_spans.launched_in(ops, spans, "schur.factor_S") == 8.0
    assert schur_spans.launched_in(ops, spans, "schur.solve") == 1.0
    assert schur_spans.span_readings(spans) == {"trials_per_iter": 1.0}
    assert schur_spans.span_readings(spans[:1]) == {}


def test_added_as_files_only(tmp_path):
    """A configuration and a cell of the two-stage kind added as files and
    lines of BENCHMARK.json, in a copy of the benchmark, are found and
    run."""
    shutil.copytree(QPB, tmp_path / "qpbench",
                    ignore=shutil.ignore_patterns("_cache", "_archive", "__pycache__"))
    bench = harness.benchmark()
    cell, config = small()
    config["name"] = "ssn_small"
    cell["config"] = "ssn_small"
    (tmp_path / "qpbench/configs/ssn_small.json").write_text(json.dumps(config))
    (tmp_path / "qpbench/workloads/ssn_small.replications.json").write_text(json.dumps(cell))
    (tmp_path / "qpbench/reference/ssn_small.py").write_text(
        "from qpbench.reference.ssn_saa import solve  # noqa: F401\n")
    bench["workloads"].append({"name": "ssn_small.replications", "config": "ssn_small",
                               "traffic": "replications", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("ssn_small.replications")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, json; sys.path.insert(0, '.'); from qpbench import harness; "
            "print(json.dumps(harness.run('ssn_small.replications', 3, 0.01, False, "
            "t0=time.perf_counter(), device='cpu')))")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, check=True,
                         capture_output=True, text=True, timeout=600)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["attempted"] == 3
    assert set(result["metrics"]) == {"setup_s", "solve_s"}
