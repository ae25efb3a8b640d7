"""Staleness check of the pipeline entries of
madqp_tpu_torch/testdata/jax_reference.json (written by
tests/test_torch_reference.py --write; chip_smoke.py phase 13 holds the
card to them): the reference runner's records of the structured suite's
large tier, seed 0, read back from MPS files, recomputed with the JAX
package on the CPU, one option set per case, the instances of
test_torch_reference.STALE_SKIP left out.  Bucketed orders equal, status,
status_detail and iterations equal, objective to 1e-10 relative.
"""

import json

import pytest

from test_torch_reference import (REF_PATH, STALE_SKIP, SUITE_OPTIONS, _same_record,
                                  suite_large_reference)


@pytest.mark.parametrize("key", list(SUITE_OPTIONS))
def test_committed_suite_large_matches_jax(key):
    committed = json.loads(REF_PATH.read_text())["suite_large"]
    fresh = suite_large_reference(STALE_SKIP, sets=(key,))
    assert {k: v for k, v in committed.items() if k != "instances"} == \
        {k: v for k, v in fresh.items() if k != "instances"}
    assert committed["instances"].keys() == fresh["instances"].keys()
    assert len(fresh["instances"]) == 19
    for name, want in fresh["instances"].items():
        got = committed["instances"][name]
        assert (got["W"], got["S"]) == (want["W"], want["S"]), name
        assert got[key]["status"] == 1, name
        if key in want:
            _same_record(got[key], want[key], name)
        else:
            assert name in STALE_SKIP[key]
