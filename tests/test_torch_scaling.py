"""Ruiz scaling: the port against the JAX package.

The inputs of tests/test_pipeline.py's TestRuizScaling (a random sparse
matrix with entries spread over eight decades; a dense_dummy_qp with A and
the row bounds scaled by 1e3), every presolve input of
tests/test_torch_presolve.py, and each of them presolved first, as the
suite runner does.  Bit-equal: the Ruiz factors (Dr, Dc) and the scaled
problem.  `unscale_stats` of the port acting on a port `ExecutionStats`
gives the reference's result on the reference's stats of the same numbers,
bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.models import ruiz_scaling_factors as j_ruiz
from madqp_tpu.models import scaling as JSc
from madqp_tpu_torch.models import scaling as TSc
from test_torch_mps import _same_value, assert_same_qp
from test_torch_presolve import (PRESOLVE_CASES, assert_same_record,
                                 assert_same_stats, execution_stats)


def _random_sparse():
    """TestRuizScaling.test_equilibration's matrix (its `rng` fixture is
    default_rng(42))."""
    rng = np.random.default_rng(42)
    A = sp.random(40, 60, density=0.1, random_state=7, format="csr")
    A.data = A.data * 10 ** rng.uniform(-4, 4, size=A.nnz)
    return A


def _worsened_dummy(pkg):
    """TestRuizScaling.test_scaled_solve_unscales_to_same_solution's QP."""
    qp = pkg.dense_dummy_qp(12, 6, seed=3)
    qp.A = qp.A.multiply(1e3).tocsr()
    qp.lcon = qp.lcon * 1e3
    qp.ucon = qp.ucon * 1e3
    return qp


def _presolved(make):
    return lambda pkg: pkg.presolve_qp(make(pkg))[0]


SCALE_CASES = {"worsened_dummy": _worsened_dummy,
               **{f"raw_{k}": v for k, v in PRESOLVE_CASES.items()},
               **{f"presolved_{k}": _presolved(v) for k, v in PRESOLVE_CASES.items()}}


@pytest.mark.parametrize("kw", [dict(), dict(max_iter=50, tol=1e-6)],
                         ids=["defaults", "tight"])
def test_ruiz_factors_match_reference(kw):
    A = _random_sparse()
    assert_same_record(mt.ruiz_scaling_factors(A.copy(), **kw),
                       j_ruiz(A.copy(), **kw))


@pytest.mark.parametrize("name", sorted(SCALE_CASES))
def test_scale_qp_matches_reference(name):
    make = SCALE_CASES[name]
    jqp, tqp = make(mq), make(mt)
    assert_same_qp(tqp, jqp)
    js, jf = mq.scale_qp(jqp)
    ts, tf = mt.scale_qp(tqp)
    assert type(tf) is mt.RuizScaling
    assert_same_record(tf, jf)
    assert_same_qp(ts, js)


@pytest.mark.parametrize("name", ["worsened_dummy", "raw_planted_qp", "raw_random_lp_0"])
def test_unscale_stats_matches_reference(name):
    jqp = SCALE_CASES[name](mq)
    _, jf = mq.scale_qp(jqp)
    _, tf = mt.scale_qp(SCALE_CASES[name](mt))
    rng = np.random.default_rng(3)
    n, m = jqp.nvar, jqp.ncon
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    zl, zu, cons = rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.standard_normal(m)
    got = mt.unscale_stats(tf, execution_stats(mt, x, y, zl, zu, cons))
    want = mq.unscale_stats(jf, execution_stats(mq, x, y, zl, zu, cons))
    assert type(got) is mt.ExecutionStats
    assert_same_stats(got, want)
    _same_value(TSc.unscale_solution(tf, x), JSc.unscale_solution(jf, x), "x")
    _same_value(TSc.unscale_multipliers(tf, y), JSc.unscale_multipliers(jf, y), "y")
