"""The harness: everything found by name, the result line, the module
checks, the traced run, and `correct` against the control and the
faults, on small copies of the rotate cell on the CPU."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from qpbench import control, harness, trace

ROOT = Path(__file__).resolve().parents[2]
QPB = ROOT / "qpbench"
CELL = "mm_cvxqp_m.rotate"


def small(cell_name=CELL, **options):
    """The cell and its configuration at the published S size (n = 100),
    with extra solver options."""
    cell = harness.load_json("workloads", f"{cell_name}.json")
    config = harness.load_json("configs", f"{cell['config']}.json")
    config["n"] = 100
    config["options"] = {**config["options"], **options}
    return cell, config


def run_small(**kw):
    cell, config = small(**kw.pop("options", {}))
    return harness.run(CELL, 2 ** 31 + 5, 0.01, False, t0=time.perf_counter(), device="cpu",
                       cell=cell, config=config, **kw)


@pytest.fixture(scope="module")
def sound():
    return run_small()


def test_every_name_found():
    bench = harness.benchmark()
    names = [w["name"] for w in bench["workloads"]]
    names += [p.stem for p in (QPB / "workloads").glob("*.json")]
    for name in names:
        cell = harness.load_json("workloads", f"{name}.json")
        config = harness.load_json("configs", f"{cell['config']}.json")
        harness.find("generators", config["generator"]).make_pool
        harness.find("entries", cell["entry"]).call
        harness.find("reference", cell["config"]).solve
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.find("metrics", m["name"]).read)


def test_cell_metrics_follow_benchmark():
    bench = harness.benchmark()
    e2e = {m["name"] for m in harness.cell_metrics(bench, CELL, False)}
    per_layer = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert {"setup_s", "solve_s"} <= e2e
    assert per_layer and not per_layer & e2e


def test_sound_run_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] % 3 == 0 and sound["failed"] == 0


def test_result_keys(sound):
    assert list(sound) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(sound["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in sound["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in sound["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_traced_run():
    """The traced blocks on the CPU: the per-layer metrics that need no
    card, the device keys and the breakdown; `correct` as untraced."""
    cell, config = small()
    result = harness.run(CELL, 2 ** 31 + 5, 0.01, True, t0=time.perf_counter(), device="cpu",
                         cell=cell, config=config)
    n = cell["traffic_params"]["trace_calls"]
    assert result["correct"], result["checks"]
    assert result["attempted"] == 3 * n and result["failed"] == 0
    assert {"iters.single", "setup_ms.single"} <= set(result["metrics"])
    assert "device_idle_pct.single" not in result["metrics"]   # no card: nothing to read
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_not_correct():
    cell, config = small()
    cell["traffic_params"] = {**cell["traffic_params"], "warm_calls": 0}
    entry = control.ControlEntry(harness.find("reference", cell["config"]))
    result = harness.run(CELL, 7, 0.0, False, t0=time.perf_counter(), device="cpu",
                         cell=cell, config=config, entry=entry)
    assert not result["correct"], result["checks"]


def test_fault_state_unchanged(monkeypatch):
    """Each step returns the iterate it was given."""
    from madqp_tpu_torch.solver.mpc import MPCKernel

    step = MPCKernel.iteration

    def unchanged(self, p, state):
        new = step(self, p, state)
        return new._replace(x=state.x, y=state.y, zl=state.zl, zu=state.zu)

    monkeypatch.setattr(MPCKernel, "iteration", unchanged)
    result = run_small(options={"max_iter": 30})
    assert not result["correct"], result["checks"]


def test_fault_answer_altered(monkeypatch):
    """One component of each returned solution moved by 1e-4."""
    from madqp_tpu_torch.models.qp import TransformInfo

    recover = TransformInfo.recover_x

    def altered(self, x_int):
        x = recover(self, x_int)
        x[0] += 1e-4
        return x

    monkeypatch.setattr(TransformInfo, "recover_x", altered)
    result = run_small()
    assert not result["correct"], result["checks"]


def test_added_as_files_only(tmp_path):
    """A configuration, a cell and a metric added as files and lines of
    BENCHMARK.json, in a copy of the benchmark, are found and run."""
    shutil.copytree(QPB, tmp_path / "qpbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = harness.benchmark()
    config = harness.load_json("configs", "mm_cvxqp_m.json")
    config["n"] = 100
    (tmp_path / "qpbench/configs/mm_cvxqp_s.json").write_text(json.dumps(config))
    cell = harness.load_json("workloads", f"{CELL}.json")
    cell["config"] = "mm_cvxqp_s"
    (tmp_path / "qpbench/workloads/mm_cvxqp_s.rotate.json").write_text(json.dumps(cell))
    (tmp_path / "qpbench/reference/mm_cvxqp_s.py").write_text(
        "from qpbench.reference.mm_cvxqp_m import solve  # noqa: F401\n")
    (tmp_path / "qpbench/metrics/calls.py").write_text("def read(run):\n    return len(run.calls)\n")
    bench["workloads"].append({"name": "mm_cvxqp_s.rotate", "config": "mm_cvxqp_s",
                               "traffic": "rotate", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock"})
    bench["end_to_end"][0]["workloads"].append("mm_cvxqp_s.rotate")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, json; sys.path.insert(0, '.'); from qpbench import harness; "
            "print(json.dumps(harness.run('mm_cvxqp_s.rotate', 3, 0.01, False, "
            "t0=time.perf_counter(), device='cpu')))")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, check=True,
                         capture_output=True, text=True, timeout=600)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["calls"]["value"] == 3
    assert set(result["metrics"]) == {"calls", "setup_s", "solve_s"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_imported_by_name():
    for path in QPB.rglob("*.py"):
        if any(part.startswith("_") for part in path.relative_to(QPB).parts[:-1]):
            continue  # the ignored run directories (`_cache`, `_archive`)
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "madqp_tpu_torch_like", sys)
    assert "madqp_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "madqp_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert {"madqp_tpu", "jaxlib"} <= set(harness.forbidden_modules())


def test_reference_imports_nothing_of_the_program():
    for path in (QPB / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "madqp_tpu_torch", path
    code = ("import sys; sys.path.insert(0, '.'); from qpbench.generators import cvxqp; "
            "from qpbench.reference import mm_cvxqp_m; "
            "mm_cvxqp_m.solve([cvxqp.cvxqp(100, 2)]); "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('madqp')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_union_of_device_intervals():
    busy, gaps = trace.union_seconds([(0, 10), (5, 20), (30, 40), (40, 45)])
    assert busy == 35e-9 and gaps == [(20, 30)]


def test_run_refuses_without_card_or_program(tmp_path):
    """No card, or a directory with only BENCHMARK.json and the benchmark:
    no result and a code other than 0."""
    shutil.copytree(QPB, tmp_path / "qpbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "qpbench/run.py", "--workload", CELL, "--seed", "1",
                              "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                             text=True, timeout=600)
        import torch

        if torch.cuda.is_available() and cwd == ROOT:
            continue
        assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    out = subprocess.run([sys.executable, "qpbench/run.py", "--workload", CELL, "--seed",
                          str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert np.isfinite(result["metrics"]["solve_s"]["value"])
