"""The suite runner's --batched mode on the CPU against the reference's.

tools/run_suite_torch.py::run_batched solves the structured suite's small
tier (seed 0) as one lockstep `BatchedMPCSolver` per power-of-two size
bucket of nvar + ncon; the reference's runner (benchmarks/run_suite.py's
main) groups the same way and runs its own `BatchedMPCSolver` per bucket.
Per lane: status, objective (1e-8 relative) and iterations, the latter
not on the transport family (tests/test_torch_pipeline.py says why).  The
batched mode solves the raw problems (no presolve, no scaling, as the
reference's): the illscaled family's rows and columns span 1e+-6 there
and its 1e-8 stopping point depends on reduction order, which
tests/test_parallel.py and tests/test_torch_batched.py leave unpinned
too, so it is compared by status.
"""

import pytest

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.models import suite as JSuite
from test_torch_pipeline import ITER_UNSTABLE, T, options
from test_torch_pipeline import one_torch_thread  # noqa: F401  (an autouse fixture)

BATCHED_STATUS_ONLY = ("illscaled_",)


def test_batched_small_tier_matches_reference():
    """--batched: one lockstep batch per power-of-two size bucket, against
    the reference's batched solver on the same buckets (its main's
    grouping), per-lane status, iterations and objective."""
    from madqp_tpu.parallel import BatchedMPCSolver as JBatched

    instances = list(mt.structured_suite("small", seeds=(0,)))
    opts = options(mt, "dense", "cpu")
    got = {r["name"]: r for r in T.run_batched(instances, opts)}
    jopts = {k: v for k, v in options(mq, "dense").items() if k not in ("backend", "pad_mode")}
    groups = {}
    for nm, qp in JSuite.structured_suite("small", seeds=(0,)):
        groups.setdefault(T._bucket(qp.nvar + qp.ncon), []).append((nm, qp))
    assert len(groups) > 1
    for batch in groups.values():
        stats = JBatched.from_problems([qp for _, qp in batch], **jopts).solve_all()
        for (nm, _), st in zip(batch, stats):
            rec = got.pop(nm)
            assert rec["status"] == int(st.status == mq.Status.SOLVE_SUCCEEDED), nm
            assert rec["linear_solver_time"] is None and rec["warm_time"] is None
            if nm.startswith(BATCHED_STATUS_ONLY):
                continue
            assert rec["objective"] == pytest.approx(st.objective, rel=1e-8, abs=1e-12), nm
            if not nm.startswith(ITER_UNSTABLE):
                assert rec["iter"] == st.iter, nm
    assert not got
