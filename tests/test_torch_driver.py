"""The driver's paths around the MPC loop, the port against the JAX
package: the mixed-precision rescue, warm starts (full, partial, with
fixed variables, maximization), solve-time option overrides, exit
certificates, the wall-time limit, linear-solver timing, the iteration
table and dtype placement.  Tolerances as in tests/test_torch_solver.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import madqp_tpu as mq
import madqp_tpu_torch as mt

QUIET = dict(print_level=40)


def _on(pkg):
    """The port takes its device explicitly; the reference has no such option."""
    return dict(device="cpu") if pkg is mt else {}


def _maximize(pkg):
    return pkg.QuadraticProblem(
        c=np.array([1.0, 0.0]), H=sp.csr_matrix(-2.0 * np.eye(2)),
        A=np.zeros((0, 2)), lcon=np.zeros(0), ucon=np.zeros(0),
        lvar=np.zeros(2), uvar=np.ones(2), minimize=False)


def _solve_pair(make, **kw):
    want = mq.solve(make(mq), print_level=40, **kw)
    got = mt.solve(make(mt), device="cpu", print_level=40, **kw)
    return got, want


def test_mixed_precision_rescue_matches_reference():
    """phase1_max_iter=2 stops the float32 phase unconverged, so the
    warm-started float64 rescue runs; iterations add up across phases."""
    got, want = _solve_pair(lambda pkg: pkg.random_qp(60, 30, seed=1),
                            factorization_dtype="float32", max_refine_steps=1,
                            phase1_max_iter=2)
    assert int(got.status) == int(want.status) == 1
    assert got.iter == want.iter > 2
    assert got.objective == pytest.approx(want.objective, rel=1e-10)


def test_warm_then_cold_with_override_matches_reference():
    def run(pkg):
        qp = pkg.dense_dummy_qp(15, 8, seed=3)
        first = pkg.MPCSolver(qp, print_level=40, **_on(pkg)).solve()
        s = pkg.MPCSolver(qp, print_level=40, **_on(pkg))
        s.set_initial_point(x=first.solution, y=first.multipliers,
                            zl=first.multipliers_L, zu=first.multipliers_U)
        warm = s.solve()
        s.clear_initial_point()
        cold = s.solve(tol=1e-6)  # a solve-time option override
        return first, warm, cold

    for got, want in zip(run(mt), run(mq)):
        assert int(got.status) == int(want.status)
        assert got.iter == want.iter
        assert got.objective == pytest.approx(want.objective, rel=1e-10)


def test_infeasible_problem_certified_like_reference():
    """x1 + x2 = 5 in the unit box: the duals diverge and the exit is
    certified by a Farkas ray in both packages."""
    def qp(pkg):
        return pkg.QuadraticProblem(
            c=np.array([1.0, 1.0]), A=np.array([[1.0, 1.0]]),
            lcon=np.array([5.0]), ucon=np.array([5.0]),
            lvar=np.zeros(2), uvar=np.ones(2))

    got, want = _solve_pair(qp, max_iter=200)
    assert got.status == mt.Status.INFEASIBLE_PROBLEM_DETECTED
    assert (int(got.status), got.iter) == (int(want.status), want.iter)


def test_device_is_required():
    """The default device is the CUDA card, so a solve meant for the card
    never lands on the host unnoticed: without a card the entry points
    raise torch's own error; with one they place the problem there."""
    if torch.cuda.is_available():
        assert mt.MPCSolver(mt.simple_lp(), print_level=40).prob.c.is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        mt.solve(mt.simple_lp(), print_level=40)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        mt.MPCSolver(mt.simple_lp(), print_level=40)


def test_wall_time_limit():
    st = mt.solve(mt.dense_dummy_qp(20, 10), device="cpu", print_level=40,
                  max_wall_time=0.0)
    assert st.status == mt.Status.MAXIMUM_WALLTIME_EXCEEDED


def test_measure_linear_solver():
    st = mt.solve(mt.dense_dummy_qp(20, 10), device="cpu", print_level=40,
                  measure_linear_solver=True)
    assert st.success and st.linear_solver_time > 0.0


def test_iteration_table_matches_reference(capsys):
    def table(pkg):
        pkg.solve(pkg.dense_dummy_qp(12, 6, seed=2), print_level=20, **_on(pkg))
        lines = capsys.readouterr().out.splitlines()
        return [ln.split()[0] for ln in lines if ln[:4].strip().isdigit()]

    rows = table(mt)
    assert rows == table(mq) and rows[0] == "0"


def test_state_stays_on_requested_dtype():
    """float64 state with float32 factors, and no change of the global
    default dtype."""
    s = mt.MPCSolver(mt.random_qp(30, 10, seed=2), device="cpu", print_level=40,
                     factorization_dtype="float32", max_refine_steps=1)
    assert s.prob.A.dtype == s._x0.dtype == torch.float64
    assert s.kernel.kkt.fact_dtype == torch.float32
    assert s.solve().success
    assert torch.get_default_dtype() == torch.float32


@pytest.mark.parametrize("variant", ["full", "x_only", "fixed_vars", "maximize"])
def test_warm_start_matches_reference(variant):
    def run(pkg):
        qp = {"full": lambda: pkg.dense_dummy_qp(25, 12, seed=8),
              "x_only": lambda: pkg.dense_dummy_qp(20, 10, seed=12),
              "fixed_vars": lambda: pkg.dense_dummy_qp(12, 6, fixed_variables=(0, 1), seed=3),
              "maximize": lambda: _maximize(pkg)}[variant]()
        cold = pkg.solve(qp, **QUIET, **_on(pkg))
        s = pkg.MPCSolver(qp, **QUIET, **_on(pkg))
        if variant == "x_only":
            s.set_initial_point(x=cold.solution)
        else:
            s.set_initial_point(x=cold.solution, y=cold.multipliers,
                                zl=cold.multipliers_L, zu=cold.multipliers_U)
        return s.solve()

    got, want = run(mt), run(mq)
    assert got.status.name == want.status.name == "SOLVE_SUCCEEDED"
    assert got.iter == want.iter
    assert got.objective == pytest.approx(want.objective, rel=1e-10, abs=1e-12)


def test_solve_time_override_matches_reference():
    def run(pkg):
        return pkg.MPCSolver(pkg.dense_dummy_qp(10, 5, seed=5), **QUIET,
                             **_on(pkg)).solve(max_iter=2)

    got, want = run(mt), run(mq)
    assert got.status.name == want.status.name == "MAXIMUM_ITERATIONS_EXCEEDED"
    assert got.iter == want.iter == 2
