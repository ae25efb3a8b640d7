"""tools/multihost_torch.py, the port's counterpart of
benchmarks/multihost.py (tests/test_multiprocess.py runs that one), on the
CPU: two gloo ranks spawned by the tool, both modes at the JAX script's
sizes, each held to the `mesh` entry of
madqp_tpu_torch/testdata/jax_reference.json (the JAX package's sharded
solves over 4 CPU devices; tests/test_torch_reference.py::mesh_reference
writes it)."""

import json
import subprocess
import sys
from pathlib import Path

from test_torch_reference import MESH_RUNS, REF_PATH

REPO = Path(__file__).resolve().parent.parent


def test_tool_matches_the_jax_record(tmp_path):
    out = tmp_path / "multihost.json"
    cmd = [sys.executable, str(REPO / "tools" / "multihost_torch.py"), "--device", "cpu",
           "--backend", "gloo", "--num-processes", "2", "--mode", "batched", "schur",
           "--n-instances", str(len(MESH_RUNS["batched"]["seeds"])),
           "--scenarios", str(MESH_RUNS["schur"]["problem"]["N"]), "--out", str(out)]
    proc = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    text = proc.stdout
    committed = json.loads(REF_PATH.read_text())["mesh"]
    assert proc.returncode == 0, text[-3000:]
    assert "mesh over 2 devices across 2 process(es)" in text
    assert "batched: 16/16 solved" in text
    assert "schur: SOLVE_SUCCEEDED" in text and "(16 scenarios over 2 devices" in text
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["world"] == 2 and rec["failures"] == []
    assert rec["identical_stats_on_every_rank"] == {"batched": True, "schur": True}
    for r in rec["ranks"]:
        assert r["runs"]["batched"]["reference"]["n_mismatched"] == 0
        assert r["runs"]["schur"]["reference"]["n_mismatched"] == 0
        assert r["runs"]["batched"]["iterations"] == committed["batched"]["iter"]
        assert r["runs"]["schur"]["iterations"] == committed["schur"]["iter"]
