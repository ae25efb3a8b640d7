"""`utils/roofline.py` and `utils/profiling.py` against the JAX package's
(`madqp_tpu/utils/roofline.py`, `madqp_tpu/utils/profiling.py`).

The schedule and dense models equal the reference's on the same patterns;
`chip_peaks` off the card gives NaN peaks, from a module that imports no
jax; `device_profile` counts the card's busy time as a union of intervals;
and chip_smoke.py's bound helpers, which now take their counts and
peaks from roofline.py, give the numbers of their earlier inline formulas
(67 TFLOP/s, 3.35 TB/s) at the shapes PERF.md section 6 reports.
"""

import ast
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import madqp_tpu as mq
from madqp_tpu.ops import sparse_chol as J
from madqp_tpu.utils import roofline as JR
from madqp_tpu_torch.ops import sparse_chol as T
from madqp_tpu_torch.utils import profiling as TP
from madqp_tpu_torch.utils import roofline as TR

REPO = Path(__file__).resolve().parents[1]


def normal_pattern(qp):
    import scipy.sparse as sp

    A = sp.csr_matrix(qp.A)
    return (A @ A.T).tocsc() + sp.identity(A.shape[0], format="csc")


@pytest.mark.parametrize("make,order,mode", [
    (lambda: mq.grid_lp(12), "nd", "greedy"),
    (lambda: mq.banded_sparse_lp(600, 300, band=5), "rcm", "level"),
    (lambda: mq.netflow_grid_lp(10), "amd", "greedy"),
], ids=["grid-nd", "banded-level", "netflow-amd"])
def test_schedule_model_equals_reference(make, order, mode):
    S = normal_pattern(make())
    bj = J.analyze_batched(S, order=order, schedule_mode=mode)
    bt = T.analyze_batched(S, order=order, schedule_mode=mode)
    assert TR.schedule_flops(bt) == JR.schedule_flops(bj) > 0
    for size in (4, 8):
        assert TR.schedule_bytes(bt, size) == JR.schedule_bytes(bj, size) > 0


@pytest.mark.parametrize("n", [1, 37, 128, 1000])
def test_dense_model_equals_reference(n):
    assert TR.dense_ldl_flops(n) == JR.dense_ldl_flops(n)
    assert TR.dense_ldl_bytes(n, 8) == JR.dense_ldl_bytes(n, 8)


def test_chip_peaks_off_the_card_and_no_jax():
    tree = ast.parse((REPO / "madqp_tpu_torch" / "utils" / "roofline.py").read_text())
    imported = {a.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names}
    imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
    assert not imported & {"jax", "jaxlib", "madqp_tpu"}
    peaks = TR.chip_peaks("cpu")
    assert peaks.name.startswith("unknown")
    assert all(math.isnan(v) for v in (peaks.bf16_tflops, peaks.f32_tflops,
                                       peaks.f64_tflops, peaks.hbm_gbps))
    if not torch.cuda.is_available():
        assert math.isnan(TR.chip_peaks().f32_tflops)
    rep = TR.roofline_report(2e9, 1e9, 0.5, device="cpu")
    assert rep["gflops"] == 4.0 and rep["gbps"] == 2.0
    assert rep["mfu"] is None and rep["hbm_frac"] is None


def test_roofline_report_on_h100_peaks(monkeypatch):
    monkeypatch.setattr(TR, "chip_peaks", lambda device=None: TR.H100)
    rep = TR.roofline_report(67e9, 3.35e9, 1e-3, dtype="float64")
    assert rep["mfu"] == 1.0 and rep["hbm_frac"] == 1.0
    assert TR.H100.tflops("float32") == TR.H100.tflops("float64") == 67.0


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def old_bound(flops, nbytes):
    """chip_smoke.py's inline bound before roofline.py held it."""
    t_ops = flops / 67e12 * 1e3
    t_bytes = nbytes / 3.35e12 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# PERF.md section 6's shapes: K1 single at 600 and 2048, the batched and
# lane-axis stacks, the supernodal fronts (128, 128, 128) and the cta
# stacks (1024, 96) and (1024, 124); K2-batched at (438, 128), (128, 128)
# and (1024, 8).
CHOL = [(1, 600, 4), (1, 2048, 8), (512, 42, 4), (4, 600, 4), (128, 128, 8),
        (1024, 96, 8), (1024, 124, 8), (2048, 128, 8)]
LDL = [(438, 128, 8), (128, 128, 8), (1024, 8, 4), (128, 32, 4)]
SYRK = [(3840, 1792, 256, 4), (2048, 2048, 2048, 8), (4096, 2048, 256, 4)]


def test_chip_smoke_bounds_unchanged():
    cs = chip_smoke()
    for batch, n, size in CHOL:
        dname = "float64" if size == 8 else "float32"
        want = old_bound(batch * n ** 3 / 3, batch * (n * (n + 1) // 2 + n * n) * size)
        assert cs.chol_bound_ms(batch, n, size, dname) == want
    for batch, n, size in LDL:
        dname = "float64" if size == 8 else "float32"
        want = old_bound(batch * n ** 3 / 3,
                         batch * (n * (n + 1) // 2 + n * n + n) * size)
        assert cs.ldl_bound_ms(batch, n, size, dname) == want
    for r, c, k, size in SYRK:
        ops = float(c * (c + 1) * k + 2 * (r - c) * c * k)
        assert TR.syrk_ops(r, c, k) == ops
        dname = "float64" if size == 8 else "float32"
        assert (cs.bound_ms(ops, TR.syrk_bytes(r, c, k, size), dname)
                == old_bound(ops, (2 * r * c + r * k) * size))


def test_device_profile_busy_is_a_union():
    """Two overlapping device intervals count once in the busy time, as
    `qpbench/trace.py::union_seconds` counts them."""
    assert TP.union_ns([(0, 10), (5, 20)]) == 20
    assert TP.union_ns([(30, 40), (0, 10), (5, 20), (40, 45)]) == 35
    assert TP.union_ns([]) == 0


def test_device_profile_and_trace_on_the_cpu(tmp_path):
    out, prof = TP.device_profile(lambda: torch.ones(3).sum())
    assert float(out) == 3.0 and prof["wall_s"] > 0
    if not torch.cuda.is_available():
        assert prof["kernel_ms"] == 0 and prof["launches_by_name"] == {}
    with TP.trace(str(tmp_path)):
        np.testing.assert_equal(torch.arange(4).sum().item(), 6)
    assert (tmp_path / "trace.json").stat().st_size > 0
