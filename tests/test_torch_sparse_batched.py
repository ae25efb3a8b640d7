"""The shared-pattern sparse batch (`parallel/sparse_batched.py`) on the CPU
against the JAX package's `solve_sparse_batched`.

The cases of tests/test_sparse_batched.py at its sizes (n <= 120): the LP
against the reference's batch, the separable QP on the normal equations and
a general QP on the augmented system, the two-phase float32 scheme (its
mesh half is tests/test_torch_mesh_sparse.py's; here a mesh that is not a
DeviceMesh raises TypeError), ragged patterns rejected and the pattern cache reused across values.  Per lane: status;
iterations equal in float64, within ITER_BAND where a float32 phase runs
(ROADMAP.md Queue 3: which float32 trials pass follows the LAPACK build);
objective to 1e-8 relative; x, y, zl and zu to 1e-6.  Each lane of the
port's batch also equals the port's single sparse solve of its instance
with the same KKT to 1e-10, with equal iterations.
"""

import functools

import numpy as np
import pytest
import torch

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.parallel import solve_sparse_batched as jax_batched
from madqp_tpu_torch.parallel import sparse_batched as SB

ITER_BAND = 8
TOL = dict(tol=1e-8, print_level=0)
F32 = dict(factorization_dtype="float32", max_refine_steps=2)

# name -> (generator name, its keywords, seeds, solver options)
CASES = {
    "lp": ("banded_sparse_lp", dict(n=120, m=60, band=4), range(4), {}),
    "lp-inverse": ("banded_sparse_lp", dict(n=120, m=60, band=4), range(3),
                   dict(solve_mode="inverse")),
    "qp-normal": ("separable_qp", dict(n=90, m=45, band=4), range(3), {}),
    "qp-augmented": ("random_qp", dict(n=36, m=18, ineq=True), range(3),
                     dict(kkt_system="augmented")),
    "two-phase": ("banded_sparse_lp", dict(n=100, m=50, band=4), range(5), F32),
    "cache-a": ("banded_sparse_lp", dict(n=100, m=50, band=4), (0, 1), {}),
    "cache-b": ("banded_sparse_lp", dict(n=100, m=50, band=4), (7, 8), {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per module (tests/test_torch_pipeline.py says why)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def problems(pkg, case):
    gen, kw, seeds, _ = CASES[case]
    return [getattr(pkg, gen)(seed=s, **kw) for s in seeds]


@functools.lru_cache(maxsize=None)
def reference(case):
    return jax_batched(problems(mq, case), **TOL, **CASES[case][3])


def port(case):
    return mt.solve_sparse_batched(problems(mt, case), device="cpu", **TOL, **CASES[case][3])


def assert_lanes_match(got, want, band=0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.status.name == w.status.name == "SOLVE_SUCCEEDED"
        assert abs(g.iter - w.iter) <= band, (g.iter, w.iter)
        assert g.objective == pytest.approx(w.objective, rel=1e-8, abs=1e-12)
        for field in ("solution", "multipliers", "multipliers_L", "multipliers_U"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field),
                                       rtol=0, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("case", ["lp", "lp-inverse", "qp-normal", "qp-augmented",
                                  "two-phase"])
def test_batch_matches_reference(case):
    """The batch's lanes against the reference's batch of the same
    instances (the LP, the separable QP on the normal equations, the
    general QP on the augmented system, the two-phase scheme)."""
    band = ITER_BAND if CASES[case][3].get("factorization_dtype") else 0
    assert_lanes_match(port(case), reference(case), band)


def single(qp, case):
    """The port's single sparse solve of one instance with the batch's KKT
    (the supernodal "batched" mode) and the batch's two-phase scheme (as in
    the reference's batch, a float64 state in phase 1 and the float64
    phase 2 on the device)."""
    opts = dict(TOL, **CASES[case][3])
    if opts.pop("kkt_system", None) == "augmented":
        return mt.solve_sparse_qp(qp, kkt_system="augmented", device="cpu", **opts)
    if opts.get("factorization_dtype"):
        opts.update(endgame="f64", phase1_dtype="float64")
    return mt.solve_sparse_lp(qp, mode="batched", device="cpu", **opts)


@pytest.mark.parametrize("case", ["lp", "qp-augmented", "two-phase"])
def test_lanes_equal_single_solves(case):
    """Lane independence: every lane of the batch is the single solve of its
    instance, to 1e-10, in as many iterations (a lane frozen or retried
    never moves another)."""
    qps = problems(mt, case)
    for lane, qp in zip(port(case), qps):
        one = single(qp, case)
        assert lane.status == one.status and lane.iter == one.iter
        assert lane.objective == pytest.approx(one.objective, rel=1e-10, abs=1e-12)
        for field in ("solution", "multipliers", "multipliers_L", "multipliers_U"):
            np.testing.assert_allclose(getattr(lane, field), getattr(one, field),
                                       rtol=0, atol=1e-10, err_msg=field)


def test_mesh_is_not_ported():
    """mesh= is ported (tests/test_torch_mesh_sparse.py runs it over
    ranks); a mesh that is not a torch.distributed DeviceMesh raises
    TypeError."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        mt.solve_sparse_batched(problems(mt, "two-phase"), mesh=object(), device="cpu")


def test_ragged_patterns_rejected():
    qps = [mt.banded_sparse_lp(n=100, m=50, band=4, seed=0),
           mt.banded_sparse_lp(n=80, m=40, band=4, seed=0)]
    with pytest.raises(ValueError, match="sparsity pattern"):
        mt.solve_sparse_batched(qps, print_level=0, device="cpu")


def test_cache_reuse_across_values():
    """A second same-pattern batch hits the pattern cache (no new KKT) and
    solves its NEW values as the reference does."""
    res_a = port("cache-a")
    n_entries = len(SB._BATCHED_CACHE)
    assert n_entries >= 1
    res_b = port("cache-b")
    assert len(SB._BATCHED_CACHE) == n_entries
    assert_lanes_match(res_b, reference("cache-b"))
    assert res_b[0].objective != pytest.approx(res_a[0].objective, rel=1e-3)


def test_empty_batch_and_cuda_default():
    assert mt.solve_sparse_batched([], device="cpu") == []
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            mt.solve_sparse_batched(problems(mt, "cache-a"), print_level=0)
