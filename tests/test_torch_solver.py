"""Port-side equivalents of tests/test_solver.py and
tests/test_certificates.py: each dense configuration of the reference
suite runs through both packages, which must agree.

Convergent float64 solves: same status and iteration count, objective to
1e-10 relative (1e-12 absolute near zero), solution to 1e-7.  With the
float32 factorization, a solve the float32 phase finishes: same status,
iterations within 1, objective to 1e-8 relative.  A float32 phase that
stalls and hands over to the float64 rescue: same status, the rescue
taken in both packages, iterations within RESCUE_ITER_BAND, objective to
1e-9 relative, solution to 1e-6.  Solves that end on diverging iterates
(infeasible / unbounded) compare the certified status only: how many
iterations a divergence takes to cross the detection thresholds depends
on roundoff in iterates of size ~1e10.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.models import suite as JSuite
from madqp_tpu.models.qp import StandardQP as JStd
from madqp_tpu.solver import certificates as JC
from madqp_tpu.utils.status import Status as JStatus
from madqp_tpu_torch.models import suite as TSuite
from madqp_tpu_torch.models.qp import StandardQP as TStd
from madqp_tpu_torch.solver import certificates as TC
from madqp_tpu_torch.utils.status import Status as TStatus

QUIET = dict(print_level=40)

# Where a float32 phase stalls, the iteration it hands over at depends on
# whether float32 Cholesky factors of near-singular Schur complements
# (smallest eigenvalue at float32 rounding) pass: on bit-equal inputs
# LAPACK's spotrf passes where MKL's fails and the reverse, and torch's
# threaded float64 GEMMs move the inputs by ~1e-17 as well.  Measured
# spread 2-5 iterations under 1, 2 and 6 torch threads; the band is one
# stall window (phase 1's stall_exit of 5) plus a margin of 3 above the
# worst reading.
RESCUE_ITER_BAND = 8


def phase1_options(options):
    """The rescue's float32 phase run alone: stall detection armed as the
    two-phase driver arms it, and no float64 phase after it."""
    return dict(options, precision_scheme="simple", stall_exit=5,
                max_iter=min(options.get("max_iter", 3000), 80))


def _qp(pkg, **fields):
    return pkg.QuadraticProblem(**fields)


def _ranges_lp(pkg):
    rng = np.random.default_rng(9)
    n, m = 30, 18
    A = rng.standard_normal((m, n))
    mid = A @ rng.uniform(0.0, 1.0, size=n)
    return _qp(pkg, c=rng.standard_normal(n) + 1.0, A=A, lcon=mid - 0.3,
               ucon=mid + 0.3, lvar=np.zeros(n), uvar=np.full(n, 2.0))


def _maximize(pkg):
    return _qp(pkg, c=np.array([1.0, 0.0]), H=sp.csr_matrix(-2.0 * np.eye(2)),
               A=np.zeros((0, 2)), lcon=np.zeros(0), ucon=np.zeros(0),
               lvar=np.zeros(2), uvar=np.ones(2), minimize=False)


def _infeasible_lp(pkg):
    return _qp(pkg, c=np.ones(2), A=np.array([[1.0, 1.0], [1.0, 1.0]]),
               lcon=np.array([1.0, 2.0]), ucon=np.array([1.0, 2.0]),
               lvar=np.zeros(2), uvar=np.full(2, np.inf))


def _unbounded_lp(pkg):
    return _qp(pkg, c=np.array([-1.0]), A=np.zeros((0, 1)), lcon=np.zeros(0),
               ucon=np.zeros(0), lvar=np.zeros(1), uvar=np.array([np.inf]))


def _unbounded_lp_con(pkg):
    return _qp(pkg, c=np.array([-1.0, -1.0]), A=np.array([[1.0, -1.0]]),
               lcon=np.zeros(1), ucon=np.zeros(1), lvar=np.zeros(2),
               uvar=np.full(2, np.inf))


def _qp_2d(pkg, c, H):
    return _qp(pkg, c=np.array(c), A=np.zeros((0, 2)), lcon=np.zeros(0),
               ucon=np.zeros(0), lvar=np.zeros(2), uvar=np.full(2, np.inf),
               H=np.array(H))


def _transport(pkg):
    """The structured suite's rank-deficient transportation LP, presolved
    and scaled by each package's own pipeline (bit-equal,
    tests/test_torch_presolve.py and tests/test_torch_scaling.py): the
    float32 phase stalls and the float64 rescue finishes the solve."""
    suite = JSuite if pkg is mq else TSuite
    qp_p, _, ok = pkg.presolve_qp(suite.transport_lp(12, 15, seed=0))
    assert ok
    return pkg.scale_qp(qp_p)[0]


# name -> (problem builder, option builder, comparison: True = same path,
# "f32" = float32 factorization tolerances, "rescue" = a float32 phase that
# hands over to the float64 rescue, False = status only)
CASES = {
    "simple_lp": (lambda p: p.simple_lp(), lambda p: {}, True),
    "simple_lp_normal": (lambda p: p.simple_lp(), lambda p: dict(kkt_system="normal"), True),
    "simple_lp_noreg": (lambda p: p.simple_lp(),
                        lambda p: dict(regularization=p.NoRegularization()), True),
    "ddqp_10_0": (lambda p: p.dense_dummy_qp(10, 0, seed=10), lambda p: {}, True),
    "ddqp_10_5": (lambda p: p.dense_dummy_qp(10, 5, seed=15), lambda p: {}, True),
    "ddqp_50_10": (lambda p: p.dense_dummy_qp(50, 10, seed=60), lambda p: {}, True),
    "equality_ncorr0": (lambda p: p.dense_dummy_qp(20, 15, equality_cons=(0, 1, 2, 7), seed=7),
                        lambda p: {}, True),
    "equality_ncorr5": (lambda p: p.dense_dummy_qp(20, 15, equality_cons=(0, 1, 2, 7), seed=7),
                        lambda p: dict(max_ncorr=5), True),
    "fixed_vars": (lambda p: p.dense_dummy_qp(20, 15, fixed_variables=(0, 1), seed=11),
                   lambda p: {}, True),
    "fixed_vars_eq": (lambda p: p.dense_dummy_qp(20, 15, fixed_variables=(0, 1),
                                                 equality_cons=(0, 1, 2, 7), seed=11),
                      lambda p: {}, True),
    "step_adaptive": (lambda p: p.dense_dummy_qp(10, 5, seed=5),
                      lambda p: dict(step_rule=p.AdaptiveStep(0.99)), True),
    "step_conservative": (lambda p: p.dense_dummy_qp(10, 5, seed=5),
                          lambda p: dict(step_rule=p.ConservativeStep(0.99)), True),
    "step_mehrotra": (lambda p: p.dense_dummy_qp(10, 5, seed=5),
                      lambda p: dict(step_rule=p.MehrotraAdaptiveStep(0.99)), True),
    "reg_fixed": (lambda p: p.dense_dummy_qp(10, 5, seed=5),
                  lambda p: dict(regularization=p.FixedRegularization(1e-8, -1e-9),
                                 rethrow_error=True), True),
    "reg_adaptive": (lambda p: p.dense_dummy_qp(10, 5, seed=5),
                     lambda p: dict(regularization=p.AdaptiveRegularization(1e-8, -1e-9, 1e-9),
                                    rethrow_error=True), True),
    "random_lp": (lambda p: p.random_lp(60, 25, seed=1), lambda p: {}, True),
    "ranges_lp": (_ranges_lp, lambda p: {}, True),
    "eq_qp": (lambda p: p.random_qp(30, 10, seed=3, ineq=False), lambda p: {}, True),
    "max_iter_1": (lambda p: p.dense_dummy_qp(10, 5, seed=5), lambda p: dict(max_iter=1), True),
    "no_scaling": (lambda p: p.dense_dummy_qp(10, 5, seed=5), lambda p: dict(scaling=False), True),
    "maximize": (_maximize, lambda p: {}, True),
    "bounded_qp": (lambda p: _qp_2d(p, [-1.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]),
                   lambda p: dict(max_iter=300), True),
    "feasible_not_flagged": (lambda p: p.dense_dummy_qp(15, 8, seed=9), lambda p: {}, True),
    "farkas_not_fooled": (lambda p: p.dense_dummy_qp(30, 12, seed=3),
                          lambda p: dict(max_iter=2), True),
    "rescue_transport": (_transport, lambda p: dict(
        tol=1e-8, max_ncorr=2, factorization_dtype="float32", max_refine_steps=1), "rescue"),
    "f32_single_phase": (lambda p: p.random_qp(60, 24, seed=0, ineq=True), lambda p: dict(
        tol=1e-8, factorization_dtype="float32", max_refine_steps=1), "f32"),
    "infeasible_lp": (_infeasible_lp, lambda p: dict(max_iter=300), False),
    "farkas_upgrades_max_iter": (_infeasible_lp, lambda p: dict(max_iter=8), False),
    "unbounded_lp": (_unbounded_lp, lambda p: dict(max_iter=300), False),
    "unbounded_lp_constraint": (_unbounded_lp_con, lambda p: dict(max_iter=300), False),
    "unbounded_qp_singular_h": (lambda p: _qp_2d(p, [0.0, -1.0], [[1.0, 0.0], [0.0, 0.0]]),
                                lambda p: dict(max_iter=300), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_reference(name):
    make, options, same_path = CASES[name]
    want = mq.solve(make(mq), **QUIET, **options(mq))
    got = mt.solve(make(mt), device="cpu", **QUIET, **options(mt))
    assert got.status.name == want.status.name
    if not same_path:
        return
    if same_path == "rescue":
        # the float32 phase alone stalls short of tol in both packages, so
        # both solves above went through the float64 rescue
        for pkg, full, kw in ((mq, want, {}), (mt, got, dict(device="cpu"))):
            p1 = pkg.solve(make(pkg), **kw, **QUIET, **phase1_options(options(pkg)))
            assert p1.status.name != "SOLVE_SUCCEEDED" and full.iter > p1.iter
        assert abs(got.iter - want.iter) <= RESCUE_ITER_BAND, (got.iter, want.iter)
        assert got.objective == pytest.approx(want.objective, rel=1e-9)
        np.testing.assert_allclose(got.solution, want.solution, atol=1e-6)
        return
    if same_path == "f32":
        assert abs(got.iter - want.iter) <= 1
        assert got.objective == pytest.approx(want.objective, rel=1e-8)
        return
    assert got.iter == want.iter
    assert got.objective == pytest.approx(want.objective, rel=1e-10, abs=1e-12)
    np.testing.assert_allclose(got.solution, want.solution, atol=1e-7)
    np.testing.assert_allclose(got.multipliers, want.multipliers, atol=1e-6)


# ---------------------------------------------------------------------------
# Certificates (tests/test_certificates.py inputs through both packages)
# ---------------------------------------------------------------------------


def _std(cls, c, A, b, has_lb, has_ub, H=None):
    n = len(c)
    return cls(c0=np.float64(0.0), c=np.asarray(c, float), H=H,
               A=np.asarray(A, float), b=np.asarray(b, float),
               lb=np.zeros(n), ub=np.zeros(n),
               has_lb=np.asarray(has_lb, bool), has_ub=np.asarray(has_ub, bool))


def _infeas(cls):
    return _std(cls, [1.0, 1.0], [[1.0, 1.0], [1.0, 1.0]], [1.0, 2.0],
                [True, True], [False, False])


def _unbnd(cls, H=None):
    return _std(cls, [-1.0, -1.0], [[1.0, -1.0]], [0.0], [True, True],
                [False, False], H=H)


FARKAS = {
    "diverged_ray": 1e9 * np.array([1.0, -1.0]) + np.array([0.3, -0.2]),
    "small_iterate": np.array([1.0, -1.0]),
    "non_certificate": 1e9 * np.array([1.0, 1.0]),
    "zero": np.zeros(2),
    "nonfinite": np.array([np.nan, np.inf]),
}

RAYS = {
    "descent_ray": (None, 1e9 * np.array([1.0, 1.0]) + np.array([0.4, 0.1])),
    "small_iterate": (None, np.array([1.0, 1.0])),
    "bound_incompatible": (None, -1e9 * np.ones(2)),
    "nonzero_A_component": (None, 1e9 * np.array([1.0, 0.5])),
    "curved_hessian": (np.eye(2), 1e9 * np.ones(2)),
    "null_hessian": (np.array([[1.0, -1.0], [-1.0, 1.0]]), 1e9 * np.ones(2)),
}


@pytest.mark.parametrize("case", sorted(FARKAS))
def test_farkas_certificate_matches_reference(case):
    y = FARKAS[case]
    assert TC.farkas_certificate(_infeas(TStd), y) == \
        JC.farkas_certificate(_infeas(JStd), y)


@pytest.mark.parametrize("case", sorted(RAYS))
def test_unbounded_certificate_matches_reference(case):
    H, x = RAYS[case]
    assert TC.unbounded_certificate(_unbnd(TStd, H), x) == \
        JC.unbounded_certificate(_unbnd(JStd, H), x)


@pytest.mark.parametrize("status", ["MAXIMUM_ITERATIONS_EXCEEDED",
                                    "DIVERGING_ITERATES", "SOLVE_SUCCEEDED",
                                    "ERROR_IN_STEP_COMPUTATION"])
@pytest.mark.parametrize("problem", ["infeasible", "unbounded"])
def test_certify_exit_status_matches_reference(problem, status):
    x = 1e9 * np.ones(2) if problem == "unbounded" else np.ones(2)
    y = 1e9 * np.array([1.0, -1.0]) if problem == "infeasible" else np.zeros(1)
    build = _infeas if problem == "infeasible" else _unbnd
    got = TC.certify_exit_status(build(TStd), x, y, TStatus[status])
    want = JC.certify_exit_status(build(JStd), x, y, JStatus[status])
    assert got.name == want.name
