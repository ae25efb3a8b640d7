"""Presolve and postsolve: the port against the JAX package.

Every input of tests/test_pipeline.py's presolve classes (TestPresolve,
TestActivityPresolve, TestDuplicateRows, TestDuplicateRowEdgeCases,
TestPresolveRound2) goes through `presolve_qp` of both packages.  Bit-equal:
the flag, `PresolveInfo`'s status, index sets, fixed values and
reduction records, the reduced problem, and the postsolve (`postsolve_x`,
`postsolve_y`, `postsolve`, `postsolve_stats`) of the same seeded reduced
vectors.
"""

import dataclasses

import numpy as np
import pytest

import madqp_tpu as mq
import madqp_tpu_torch as mt
from test_torch_mps import _same_value, assert_same_qp

INF = np.inf


def _qp(pkg, **kw):
    return pkg.QuadraticProblem(**kw)


def _planted(pkg, with_h):
    """TestPresolve.test_planted_structure_postsolve_exact's problem."""
    rng = np.random.default_rng(7 + with_h)
    n_core, m_core = 12, 6
    A_core = rng.standard_normal((m_core, n_core))
    x_feas = rng.uniform(0.5, 1.5, n_core)
    b_core = A_core @ x_feas
    n, m = n_core + 3, m_core + 4
    A = np.zeros((m, n))
    A[:m_core, :n_core] = A_core
    A[:m_core, n_core] = rng.standard_normal(m_core)
    lcon = np.concatenate([b_core, [2.0, -INF, -1.0, 3.0]])
    ucon = np.concatenate([b_core, [2.0, 4.0, 1.0, 3.0]])
    A[m_core, 0] = 2.0
    A[m_core + 1, 1] = 4.0
    A[m_core + 3, 2] = 1.0
    A[m_core + 3, n - 1] = 2.0
    lvar, uvar = np.full(n, 0.0), np.full(n, INF)
    lvar[n_core] = uvar[n_core] = 0.7
    lvar[n_core + 1], uvar[n_core + 1] = 0.0, 2.0
    lvar[n - 1], uvar[n - 1] = -INF, INF
    c = rng.uniform(0.5, 2.0, n)
    H = None
    if with_h:
        d = np.zeros(n)
        d[:n_core] = rng.uniform(0.1, 1.0, n_core)
        d[n_core] = 0.5
        H = np.diag(d)
    return _qp(pkg, c=c, A=A, H=H, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar)


def _dup_rows(pkg, lcon2, ucon2, scale=2.0):
    """TestDuplicateRows._qp: row 2 = scale * row 1."""
    return _qp(pkg, c=np.array([1.0, -2.0]),
               A=np.array([[1.0, 1.0], [scale, scale], [1.0, -1.0]]),
               lcon=np.array([0.0, lcon2, -1.0]), ucon=np.array([1.5, ucon2, 1.0]),
               lvar=np.zeros(2), uvar=np.full(2, 2.0))


# name -> builder(package); the tests/test_pipeline.py test each comes from
PRESOLVE_CASES = {
    "empty_row_dropped": lambda p: _qp(
        p, c=np.array([1.0, 1.0]), A=np.array([[1.0, 1.0], [0.0, 0.0]]),
        lcon=np.array([1.0, -1.0]), ucon=np.array([1.0, 1.0]),
        lvar=np.zeros(2), uvar=np.full(2, INF)),
    "empty_row_infeasible": lambda p: _qp(
        p, c=np.array([1.0]), A=np.array([[0.0]]), lcon=np.array([1.0]),
        ucon=np.array([2.0]), lvar=np.zeros(1), uvar=np.ones(1)),
    "eq_singleton_plus_empty_column": lambda p: _qp(
        p, c=np.array([1.0, -2.0]), A=np.array([[1.0, 0.0]]), lcon=np.array([0.5]),
        ucon=np.array([0.5]), lvar=np.zeros(2), uvar=np.array([INF, 3.0])),
    "empty_column_unbounded": lambda p: _qp(
        p, c=np.array([1.0, -2.0]), A=np.array([[1.0, 0.0]]), lcon=np.array([0.5]),
        ucon=np.array([0.5]), lvar=np.zeros(2), uvar=np.full(2, INF)),
    "bound_crossing_infeasible": lambda p: _qp(
        p, c=np.array([1.0]), A=np.array([[1.0]]), lcon=np.array([0.0]),
        ucon=np.array([1.0]), lvar=np.array([2.0]), uvar=np.array([1.0])),
    "eq_singleton_violating_bounds": lambda p: _qp(
        p, c=np.array([1.0, 1.0]), A=np.array([[2.0, 0.0], [1.0, 1.0]]),
        lcon=np.array([10.0, 1.0]), ucon=np.array([10.0, 2.0]),
        lvar=np.zeros(2), uvar=np.array([1.0, INF])),
    "ineq_singleton_becomes_bound": lambda p: _qp(
        p, c=np.array([-1.0, 1.0]), A=np.array([[1.0, 1.0], [2.0, 0.0]]),
        lcon=np.array([1.0, -INF]), ucon=np.array([INF, 3.0]),
        lvar=np.zeros(2), uvar=np.array([2.0, INF])),
    "free_column_singleton": lambda p: _qp(
        p, c=np.array([1.0, 2.0, 3.0]), A=np.array([[1.0, 1.0, 2.0], [1.0, -1.0, 0.0]]),
        lcon=np.array([4.0, -1.0]), ucon=np.array([4.0, 1.0]),
        lvar=np.array([0.0, 0.0, -INF]), uvar=np.array([INF, INF, INF])),
    "planted_lp": lambda p: _planted(p, False),
    "planted_qp": lambda p: _planted(p, True),
    "maximize": lambda p: _qp(
        p, c=np.array([1.0, 1.0, 0.5]), A=np.array([[1.0, 1.0, 0.0], [0.0, 2.0, 0.0]]),
        lcon=np.array([-INF, 1.0]), ucon=np.array([3.0, 1.0]),
        lvar=np.zeros(3), uvar=np.array([INF, INF, 1.0]), minimize=False),
    "chained_fixpoint": lambda p: _qp(
        p, c=np.ones(3), A=np.array([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 1.0]]),
        lcon=np.array([1.0, 3.0, 5.0]), ucon=np.array([1.0, 3.0, 5.0]),
        lvar=np.zeros(3), uvar=np.full(3, 10.0)),
    "activity_redundant_row": lambda p: _qp(
        p, c=np.array([1.0, 2.0]), A=np.array([[1.0, 1.0], [1.0, -1.0]]),
        lcon=np.array([-INF, 0.0]), ucon=np.array([5.0, 0.0]),
        lvar=np.zeros(2), uvar=np.ones(2)),
    "activity_infeasible": lambda p: _qp(
        p, c=np.ones(2), A=np.array([[1.0, 1.0]]), lcon=np.array([3.0]),
        ucon=np.array([INF]), lvar=np.zeros(2), uvar=np.ones(2)),
    "dup_rows_tighter": lambda p: _dup_rows(p, 0.0, 2.0, 2.0),
    "dup_rows_looser": lambda p: _dup_rows(p, -10.0, 30.0, 2.0),
    "dup_rows_negative_scale": lambda p: _dup_rows(p, -2.4, -0.5, -2.0),
    "dup_rows_conflicting": lambda p: _dup_rows(p, 3.5, 10.0, 2.0),
    "parallel_after_fixed": lambda p: _qp(
        p, c=np.array([1.0, -2.0, 0.0]), A=np.array([[1.0, 1.0, -5.0], [2.0, 2.0, 7.0]]),
        lcon=np.array([-5.0, 7.0]), ucon=np.array([-3.5, 9.0]),
        lvar=np.array([0.0, 0.0, 1.0]), uvar=np.array([2.0, 2.0, 1.0])),
    "inverted_range_clamps": lambda p: _qp(
        p, c=np.array([1.0, 1.0]), A=np.array([[1.0, 1.0], [2.0, 2.0]]),
        lcon=np.array([0.0, 2.0 + 1e-11]), ucon=np.array([1.0, 4.0]),
        lvar=np.zeros(2), uvar=np.ones(2)),
    "merge_then_eq_singleton": lambda p: _qp(
        p, c=np.array([1.0, -2.0]), A=np.array([[1.0, 1.0], [2.0, 2.0]]),
        lcon=np.array([0.0, 2.0]), ucon=np.array([1.5, 2.0]),
        lvar=np.array([0.0, 0.3]), uvar=np.array([2.0, 0.3])),
    "forcing_row_lower": lambda p: _qp(
        p, c=np.array([-1.0, -2.0, 1.0]), A=np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]]),
        lcon=np.array([-INF, 1.0]), ucon=np.array([0.0, INF]),
        lvar=np.zeros(3), uvar=np.full(3, 5.0)),
    "forcing_row_upper": lambda p: _qp(
        p, c=np.array([3.0, 4.0]), A=np.array([[1.0, 1.0]]), lcon=np.array([10.0]),
        ucon=np.array([INF]), lvar=np.zeros(2), uvar=np.full(2, 5.0)),
    "dominated_column_fixed": lambda p: _qp(
        p, c=np.array([2.0, 1.0, 1.0]), A=np.array([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),
        lcon=np.array([3.0, 1.0]), ucon=np.array([3.0, 1.0]),
        lvar=np.zeros(3), uvar=np.array([INF, INF, 2.0])),
    "dominated_column_unbounded": lambda p: _qp(
        p, c=np.array([-2.0, -1.0]), A=np.array([[1.0, 1.0]]), lcon=np.array([-INF]),
        ucon=np.array([4.0]), lvar=np.full(2, -INF), uvar=np.full(2, INF)),
    "duplicate_column_merge": lambda p: _qp(
        p, c=np.array([1.0, 1.0, 2.0]), A=np.array([[1.0, 1.0, 1.0]]),
        lcon=np.array([5.0]), ucon=np.array([5.0]),
        lvar=np.zeros(3), uvar=np.array([2.0, 2.0, 10.0])),
    "duplicate_column_scaled": lambda p: _qp(
        p, c=np.array([1.0, 2.0]), A=np.array([[1.0, 2.0], [1.0, 2.0]])[:1],
        lcon=np.array([4.0]), ucon=np.array([4.0]),
        lvar=np.zeros(2), uvar=np.array([1.0, 3.0])),
    **{f"random_lp_{s}": (lambda p, s=s: p.random_lp(25, 10, seed=s)) for s in range(4)},
}


def assert_same_record(got, want):
    """Two reduction records (or Ruiz factors) of the same kind, field by field."""
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        _same_value(getattr(got, f.name), getattr(want, f.name), f.name)


def execution_stats(pkg, x, y, zl, zu, cons):
    return pkg.ExecutionStats(
        status=pkg.Status.SOLVE_SUCCEEDED, objective=1.25, solution=x,
        constraints=cons, multipliers=y, multipliers_L=zl, multipliers_U=zu,
        iter=7, counters=pkg.Counters())


def assert_same_stats(got, want):
    for name in ("solution", "constraints", "multipliers", "multipliers_L",
                 "multipliers_U"):
        _same_value(np.asarray(getattr(got, name)), np.asarray(getattr(want, name)), name)
    assert got.objective == want.objective and got.iter == want.iter


@pytest.mark.parametrize("name", sorted(PRESOLVE_CASES))
def test_presolve_matches_reference(name):
    make = PRESOLVE_CASES[name]
    jred, jinfo, jok = mq.presolve_qp(make(mq))
    tred, tinfo, tok = mt.presolve_qp(make(mt))
    assert tok == jok and tinfo.status.value == jinfo.status.value
    assert_same_qp(tred, jred)
    assert_same_qp(tinfo.original, jinfo.original)
    for field in ("keep_rows", "keep_cols", "fixed_cols", "fixed_vals", "nvar", "ncon"):
        _same_value(getattr(tinfo, field), getattr(jinfo, field), field)
    assert len(tinfo.ops) == len(jinfo.ops)
    for top, jop in zip(tinfo.ops, jinfo.ops):
        assert_same_record(top, jop)


@pytest.mark.parametrize("name", sorted(PRESOLVE_CASES))
def test_postsolve_matches_reference(name):
    make = PRESOLVE_CASES[name]
    _, jinfo, _ = mq.presolve_qp(make(mq))
    _, tinfo, _ = mt.presolve_qp(make(mt))
    rng = np.random.default_rng(sum(map(ord, name)))
    nr, mr = len(jinfo.keep_cols), len(jinfo.keep_rows)
    x, y = rng.uniform(-1.0, 2.0, nr), rng.standard_normal(mr)
    zl, zu = rng.uniform(0.0, 1.0, nr), rng.uniform(0.0, 1.0, nr)
    _same_value(tinfo.postsolve_x(x), jinfo.postsolve_x(x), "postsolve_x")
    _same_value(tinfo.postsolve_y(y), jinfo.postsolve_y(y), "postsolve_y")
    for got, want in zip(tinfo.postsolve(x, y, zl, zu), jinfo.postsolve(x, y, zl, zu)):
        _same_value(got, want, "postsolve")
    for got, want in zip(tinfo.postsolve(x, y), jinfo.postsolve(x, y)):
        _same_value(got, want, "postsolve without bound duals")
    cons = rng.standard_normal(mr)
    got = tinfo.postsolve_stats(execution_stats(mt, x, y, zl, zu, cons))
    want = jinfo.postsolve_stats(execution_stats(mq, x, y, zl, zu, cons))
    assert type(got) is mt.ExecutionStats
    assert_same_stats(got, want)
