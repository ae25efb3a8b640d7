"""The suite runner with `linear_solver="pallas"` on the CPU: the port's K1
path (on the CPU its plain version, `cholesky_lower_reference`) against
the reference runner's Pallas path (interpret mode off the TPU) on the
tests/data/real_mm corpus: status, status_detail, objective (1e-8
relative) and iterations.  The medium tier's `pallas` runs are held in
tests/test_torch_pipeline.py against the reference's dense records; on
two of its instances the reference's Pallas path fails, and the one that
fails deterministically is pinned here: lasso_200_0 has no rows, and
`pallas_cholesky` of its 0 x 0 Schur complement raises TypeError
(madqp_tpu/ops/pallas_chol.py:152-163 slices a 128-block out of an empty
matrix), so the record says error:TypeError.  (The other,
transport_12x15_0, runs to MAXIMUM_ITERATIONS: the family's singular
Schur complement, ROADMAP Queue 3.)
"""

import pytest

import madqp_tpu as mq
import madqp_tpu_torch as mt
from test_torch_pipeline import R, T, assert_same_record, corpus_pairs, medium_problems, options
from test_torch_pipeline import one_torch_thread  # noqa: F401  (an autouse fixture)


def test_reference_pallas_fails_without_rows():
    """The reference's own Pallas record of lasso_200_0, so that this file
    notices when it changes; the port's K1 solves it (an empty S launches
    nothing)."""
    rec = R.run_instance("lasso_200_0", medium_problems()[0]["lasso_200_0"],
                         options(mq, "pallas"))
    assert rec["status"] == "error:TypeError"


@pytest.mark.parametrize("name,jqp,tqp", corpus_pairs(), ids=lambda v: v if isinstance(v, str) else "")
def test_corpus_pallas_matches_reference(name, jqp, tqp):
    want = R.run_instance(name, jqp, options(mq, "pallas"))
    got = T.run_instance(name, tqp, options(mt, "pallas", "cpu"))
    assert_same_record(got, want)
