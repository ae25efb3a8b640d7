"""The MPS/QPS reader and writer: the port against the JAX package.

Same inputs through `madqp_tpu.io` and `madqp_tpu_torch.io`: the MPS text
of tests/test_pipeline.py and tests/test_mps_conformance.py, the QPS files
of tests/data/real_mm (one gzip-compressed) and a bz2 copy.  Every field of
the parsed `QuadraticProblem` must be equal: arrays with np.array_equal
(and equal dtype), the sparse matrices with equal indptr, indices and data,
the name, the objective constant and the sense.  `write_mps` of both
packages must write the same bytes, which read back to equal problems.
"""

import bz2
import dataclasses
import gzip
import io
import os

import numpy as np
import pytest
import scipy.sparse as sp

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.io import mps as JMps
from madqp_tpu.io import write_mps as j_write
from madqp_tpu_torch.io import mps as TMps
from madqp_tpu_torch.io import write_mps as t_write
from test_mps_conformance import ALL_FIXTURES
from test_pipeline import MPS_LP, MPS_QP

CORPUS = os.path.join(os.path.dirname(__file__), "data", "real_mm")
CORPUS_FILES = sorted(os.listdir(CORPUS))

TEXTS = {
    "pipeline_lp": MPS_LP,
    "pipeline_qp": MPS_QP,
    "pipeline_max": MPS_LP.replace("NAME          TESTLP", "NAME  T\nOBJSENSE\n    MAX"),
    **{f"conformance_{i}": t for i, t in enumerate(ALL_FIXTURES)},
}


def _same_value(a, b, what):
    if sp.issparse(a) or sp.issparse(b):
        assert sp.issparse(a) and sp.issparse(b), what
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape and a.dtype == b.dtype, what
        for part in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(a, part), getattr(b, part)), (what, part)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, what
        assert np.array_equal(a, b, equal_nan=True), what
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (what, a, b)


def assert_same_qp(got, want):
    """Every field of two QuadraticProblems (one per package) bit-equal."""
    assert type(got).__name__ == type(want).__name__ == "QuadraticProblem"
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        _same_value(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("key", sorted(TEXTS))
def test_parse_matches_reference(key):
    want = JMps.parse_mps(io.StringIO(TEXTS[key]))
    got = TMps.parse_mps(io.StringIO(TEXTS[key]))
    assert_same_qp(got, want)


@pytest.mark.parametrize("fname", CORPUS_FILES)
def test_read_corpus_matches_reference(fname):
    path = os.path.join(CORPUS, fname)
    assert_same_qp(mt.read_mps(path), mq.read_mps(path))


@pytest.mark.parametrize("opener,suffix", [(gzip.open, ".mps.gz"), (bz2.open, ".mps.bz2")])
def test_read_compressed_matches_reference(tmp_path, opener, suffix):
    path = str(tmp_path / f"testlp{suffix}")
    with opener(path, "wt") as f:
        f.write(MPS_LP)
    assert_same_qp(mt.read_mps(path), mq.read_mps(path))


def test_garbage_rejected_like_reference():
    text = "GARBAGE\nNOT AN MPS\n"
    with pytest.raises(ValueError) as want:
        JMps.parse_mps(io.StringIO(text))
    with pytest.raises(ValueError) as got:
        TMps.parse_mps(io.StringIO(text))
    assert str(got.value) == str(want.value)


def _round_trip_cases():
    cases = {key: (lambda t=t: (JMps.parse_mps(io.StringIO(t)), TMps.parse_mps(io.StringIO(t))))
             for key, t in TEXTS.items()}
    for fname in CORPUS_FILES:
        path = os.path.join(CORPUS, fname)
        cases[fname] = lambda p=path: (mq.read_mps(p), mt.read_mps(p))
    # tests/test_pipeline.py::TestMPSRoundTrip's generated problems
    cases["random_lp"] = lambda: (mq.random_lp(25, 10, seed=4), mt.random_lp(25, 10, seed=4))
    cases["random_qp"] = lambda: (mq.random_qp(20, 8, seed=5), mt.random_qp(20, 8, seed=5))
    cases["dense_dummy"] = lambda: (mq.dense_dummy_qp(15, 6, seed=6),
                                    mt.dense_dummy_qp(15, 6, seed=6))
    return cases


ROUND_TRIPS = _round_trip_cases()


@pytest.mark.parametrize("key", sorted(ROUND_TRIPS))
def test_write_read_round_trip_matches_reference(tmp_path, key):
    jqp, tqp = ROUND_TRIPS[key]()
    assert_same_qp(tqp, jqp)
    jpath, tpath = str(tmp_path / "ref.qps"), str(tmp_path / "port.qps")
    j_write(jqp, jpath)
    t_write(tqp, tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    assert_same_qp(mt.read_mps(tpath), mq.read_mps(jpath))
