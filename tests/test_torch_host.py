"""The host path (madqp_tpu_torch.solver.host) against the JAX package's.

* `solve_host` on the cases of tests/test_native.py and
  tests/test_solver.py (simple LP, LP on the normal equations, QP on K2,
  Gondzio, a banded LP at n = 4000, an unbounded and an infeasible LP):
  the same status and iterations, objective within 1e-9 relative, the
  solution and multipliers within 1e-7;
* a warm start (`set_initial_point_internal`) from the same internal
  point, in both packages, to the same tolerances;
* the seven corpus files of tests/data/real_mm and the gzip file through
  `solve_host` at their published optima (tests/test_real_corpus.py's
  tolerance, 1e-6 absolute) and against the reference's solve;
* the runner's --backend host: the corpus through --dir against the
  reference runner's records, and the large tier against the committed
  host_large records (status, iterations equal, objective 1e-9);
* the xlarge portfolio QP within 40 iterations (tests/test_suite.py:127).
"""

import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.solver.host import HostMPCSolver as JHost
from madqp_tpu.solver.host import solve_host as jax_solve_host
from madqp_tpu_torch.solver.host import HostMPCSolver

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data" / "real_mm"
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO / "benchmarks"))
import run_suite  # noqa: E402
import run_suite_torch as T  # noqa: E402

OBJ_RTOL = 1e-9
ITERATE_TOL = 1e-7
PUBLISHED = {"HS21": -99.96, "HS35": 1.0 / 9.0, "HS76": -4.68181818181818,
             "HS51": 0.0, "HS52": 1859.0 / 349.0, "HS53": 176.0 / 43.0,
             "HS118": 664.82045}


def _infeasible(pkg):
    return pkg.QuadraticProblem(
        c=np.ones(2), A=sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 1.0]])),
        lcon=np.array([1.0, 2.0]), ucon=np.array([1.0, 2.0]),
        lvar=np.zeros(2), uvar=np.full(2, np.inf))


def _unbounded(pkg):
    return pkg.QuadraticProblem(
        c=np.array([-1.0, -1.0]), A=np.array([[1.0, -1.0]]),
        lcon=np.zeros(1), ucon=np.zeros(1),
        lvar=np.zeros(2), uvar=np.full(2, np.inf))


def _fixed(pkg):
    return pkg.FixedRegularization(1e-8, -1e-8)


# (problem, options) from each package
CASES = {
    "simple_lp": (lambda P: P.simple_lp(), lambda P: dict(print_level=40)),
    "lp_normal": (lambda P: P.random_lp(60, 25, seed=1),
                  lambda P: dict(print_level=40, kkt_system="normal",
                                 regularization=_fixed(P))),
    "qp_k2": (lambda P: P.dense_dummy_qp(25, 12, seed=4),
              lambda P: dict(print_level=40, regularization=_fixed(P))),
    "gondzio": (lambda P: P.dense_dummy_qp(20, 10, seed=6),
                lambda P: dict(print_level=40, max_ncorr=3, regularization=_fixed(P))),
    "banded_lp": (lambda P: P.banded_sparse_lp(4000, 2000, seed=0),
                  lambda P: dict(print_level=40, kkt_system="normal", max_iter=100,
                                 regularization=_fixed(P))),
    "mehrotra_adaptive_reg": (lambda P: P.dense_dummy_qp(18, 7, seed=2),
                              lambda P: dict(print_level=40, max_ncorr=2,
                                             step_rule=P.MehrotraAdaptiveStep(0.99),
                                             regularization=P.AdaptiveRegularization())),
    "unbounded": (_unbounded, lambda P: dict(max_iter=300, print_level=0)),
    "infeasible": (_infeasible, lambda P: dict(max_iter=300, print_level=0)),
}


def _compare(got, want):
    assert got.status == want.status
    assert got.iter == want.iter
    if want.status == mq.Status.SOLVE_SUCCEEDED:
        assert got.objective == pytest.approx(want.objective, rel=OBJ_RTOL, abs=1e-12)
        np.testing.assert_allclose(got.solution, want.solution, atol=ITERATE_TOL)
        np.testing.assert_allclose(got.multipliers, want.multipliers, atol=ITERATE_TOL)
        np.testing.assert_allclose(got.multipliers_L, want.multipliers_L, atol=ITERATE_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_solve_host_matches_reference(case):
    make, options = CASES[case]
    want = jax_solve_host(make(mq), **options(mq))
    got = mt.solve_host(make(mt), **options(mt))
    _compare(got, want)
    assert int(got.status) == int(want.status)
    # (backsolves may differ by one: refinement stops at a residual ratio
    # of 1e-14, which rounding can move across)
    assert got.counters.factorizations == want.counters.factorizations
    if got.status == mt.Status.SOLVE_SUCCEEDED:
        assert got.linear_solver_time > 0  # measured, not a placeholder


def test_host_warm_start_matches_reference():
    """set_initial_point_internal from the same internal point in both
    packages: the warm solve's trajectory."""
    def solve(pkg, Host):
        qp = pkg.random_lp(60, 24, seed=2)
        h = Host(qp, print_level=40, tol=1e-8)
        n, m = h.prob.n, h.prob.m
        rng = np.random.default_rng(3)
        h.set_initial_point_internal(rng.uniform(0.1, 1.0, n), rng.standard_normal(m),
                                     np.ones(n), np.ones(n))
        return h.solve()

    want, got = solve(mq, JHost), solve(mt, HostMPCSolver)
    _compare(got, want)


def test_host_kkt_systems_reject_nondiagonal_hessian_as_reference():
    for pkg in (mq, mt):
        with pytest.raises(ValueError, match="NormalKKT"):
            pkg.solve_host(pkg.dense_dummy_qp(10, 4, seed=0), kkt_system="normal",
                           print_level=0)


def test_solve_host_takes_no_device():
    """The host path runs on the CPU by design: no device parameter (a
    `device=` keyword is an unknown option, reported and ignored as in the
    reference)."""
    import inspect

    assert "device" not in inspect.signature(mt.solve_host).parameters
    assert "device" not in inspect.signature(mt.HostMPCSolver).parameters


@pytest.mark.parametrize("name", sorted(PUBLISHED) + ["HS35_gz"])
def test_corpus_through_solve_host(name):
    path = next(DATA.glob(f"{name}.qps*"))
    opts = dict(tol=1e-9, print_level=0, bound_relax_factor=0.0)
    got = mt.solve_host(mt.read_mps(str(path)), **opts)
    want = jax_solve_host(mq.read_mps(str(path)), **opts)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    assert got.objective == pytest.approx(PUBLISHED[name.split("_")[0]], abs=1e-6)
    _compare(got, want)


def test_runner_host_dir_matches_reference_runner(tmp_path):
    """--dir over the corpus with --backend host: the port's records
    against the reference runner's, and the published optima (the
    reference's test_dir_harness_ingests_corpus tolerance)."""
    out = tmp_path / "corpus.json"
    got = {r["name"]: r for r in T.main(["--dir", str(DATA), "--backend", "host",
                                         "--tol", "1e-9", "--out", str(out)])}
    assert json.loads(out.read_text()) == list(got.values())
    opts = dict(T.solve_options(T.parser().parse_args(["--backend", "host", "--tol", "1e-9"])))
    opts.pop("device")
    opts.update(step_rule=mq.AdaptiveStep(0.995),
                regularization=mq.FixedRegularization(1e-8, -1e-8))
    assert set(got) == set(PUBLISHED) | {"HS35_gz"}
    for name, rec in got.items():
        want = run_suite.run_instance(name, mq.read_mps(str(next(DATA.glob(f"{name}.qps*")))),
                                      opts)
        assert rec["status"] == want["status"] == 1, name
        assert rec["status_detail"] == want["status_detail"], name
        assert rec["iter"] == want["iter"], name
        assert rec["objective"] == pytest.approx(want["objective"], rel=OBJ_RTOL), name
        opt = PUBLISHED[name.split("_")[0]]
        assert abs(rec["objective"] - opt) <= max(1e-6, 1e-7 * abs(opt)), name
        assert rec["linear_solver_time"] > 0


def test_runner_host_large_tier_matches_committed_records():
    """The large tier (seed 0, read back from MPS files) through the port
    runner's --backend host against the reference runner's records in
    testdata/jax_reference.json (chip_smoke.py phase 14 holds the card's
    machine to the same records)."""
    want = json.loads((REPO / "madqp_tpu_torch" / "testdata" /
                       "jax_reference.json").read_text())["host_large"]
    options = T.solve_options(T.parser().parse_args(["--backend", "host"]))
    with tempfile.TemporaryDirectory() as d:
        mt.write_suite(d, size="large", seeds=(0,))
        instances = T.read_dir(d)
    assert sorted(nm for nm, _ in instances) == sorted(want)
    for name, qp in instances:
        rec = T.run_instance(name, qp, options)
        w = want[name]
        assert (rec["status"], rec["status_detail"]) == (w["status"], w["status_detail"]), name
        assert rec["iter"] == w["iter"], name
        assert rec["objective"] == pytest.approx(w["objective"], rel=OBJ_RTOL), name
        assert mt.presolve_qp(qp)[0].ncon == w["m"], name


def test_portfolio_xlarge_solves_host():
    from madqp_tpu_torch.models import suite as SU

    qp = SU._MAKERS["portfolio"](*SU._DIMS["portfolio"]["xlarge"], seed=0)
    qp_p, _, ok = mt.presolve_qp(qp)
    assert ok
    qp_s, _ = mt.scale_qp(qp_p)
    st = mt.solve_host(qp_s, tol=1e-8, max_iter=300, max_ncorr=3,
                       step_rule=mt.AdaptiveStep(0.995),
                       regularization=mt.FixedRegularization(1e-8, -1e-8), print_level=0)
    assert st.status == mt.Status.SOLVE_SUCCEEDED
    assert st.iter <= 40
