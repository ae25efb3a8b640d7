"""Shape bucketing (`pad_mode="bucket"`, `pad_standard`) and the routed
entry point `autosolve`, against the JAX package.

  * `pad_standard` gives bit-equal padded standard forms;
  * a bucketed solve with the blocked backend - random_qp(1000, 10,
    ineq=False) pads to W 1024^2, so `panel_chol` and its K8 updates (plain
    version on the CPU) run end to end - and a bucketed warm-started solve
    agree with the JAX package: equal status, iterations within 1 (float32
    factorizations, ROADMAP.md Queue 3), objective to 1e-7 relative;
  * `autosolve` picks the same options as the JAX package (both packages'
    `solve` replaced by a recorder, no solve), solves a small problem the
    same way, and raises naming ROADMAP item 13 where the JAX package takes
    a sparse path;
  * entry points default to the CUDA card.
"""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import madqp_tpu as mq
import madqp_tpu.solver.driver as jax_driver
import madqp_tpu.solver.sparse_qp as jax_sparse_qp
import madqp_tpu_torch as mt
import madqp_tpu_torch.solver.driver as port_driver
from madqp_tpu.models.qp import build_standard_form as jax_standard_form
from madqp_tpu.parallel.batched import pad_standard as jax_pad_standard
from madqp_tpu_torch.models.qp import build_standard_form as port_standard_form
from madqp_tpu_torch.ops import blocked_dense
from madqp_tpu_torch.parallel import pad_standard as port_pad_standard
from madqp_tpu_torch.solver.state import problem_to_device


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run the port's side single-threaded: the suite runs one process per
    core under xdist, and torch's default of a thread per core in every
    process oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _headline(pkg):
    return dict(print_level=40, tol=1e-8, max_ncorr=0,
                step_rule=pkg.AdaptiveStep(0.995),
                regularization=pkg.FixedRegularization(1e-8, -1e-8),
                factorization_dtype="float32", max_refine_steps=1)


@pytest.mark.parametrize("problem,n_tot,m_tot,force_H", [
    (lambda pkg: pkg.random_qp(30, 12, seed=3), 64, 32, True),
    (lambda pkg: pkg.dense_dummy_qp(12, 6, seed=2), 64, 8, True),
    (lambda pkg: pkg.random_lp(20, 8, seed=1), 40, 16, False),
    (lambda pkg: pkg.random_lp(20, 8, seed=1), 40, 8, True),
])
def test_pad_standard_bit_equal(problem, n_tot, m_tot, force_H):
    jstd, _, jx0, jy0 = jax_standard_form(problem(mq))
    tstd, _, tx0, ty0 = port_standard_form(problem(mt))
    want = jax_pad_standard(jstd, jx0, jy0, n_tot, m_tot, force_H=force_H)
    got = port_pad_standard(tstd, tx0, ty0, n_tot, m_tot, force_H=force_H)
    for field in want[0]._fields:
        w, g = getattr(want[0], field), getattr(got[0], field)
        if w is None:
            assert g is None, field
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), field)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("problem", [
    lambda pkg: pkg.random_qp(30, 12, seed=3),
    lambda pkg: pkg.random_qp(40, 40, seed=2, ineq=False),
    lambda pkg: pkg.dense_dummy_qp(12, 6, seed=2),
    lambda pkg: pkg.random_lp(20, 8, seed=1),
])
def test_bucket_shape_matches_reference(problem):
    want = mq.MPCSolver(problem(mq), print_level=40, pad_mode="bucket").prob
    _, info, _, _ = port_standard_form(problem(mt))
    assert port_driver.bucket_shape(info.n, info.m) == (want.n, want.m)


def test_pad_standard_rejects_more_rows_than_variables():
    std, _, x0, y0 = port_standard_form(mt.random_qp(30, 12, seed=3))
    with pytest.raises(ValueError, match="one padding variable per padding row"):
        port_pad_standard(std, x0, y0, std.n + 1, std.m + 2, force_H=True)


def test_bucketed_blocked_solve_matches_reference(monkeypatch):
    opts = dict(_headline(mq), pad_mode="bucket", linear_solver="blocked")
    want = mq.solve(mq.random_qp(1000, 10, seed=1, ineq=False), **opts)

    calls = []
    real = blocked_dense.syrk_update

    def counted(C, B, out=None):
        calls.append((C.shape[0], C.shape[1], B.shape[1]))
        return real(C, B, out=out)

    monkeypatch.setattr(blocked_dense, "syrk_update", counted)
    solver = mt.MPCSolver(mt.random_qp(1000, 10, seed=1, ineq=False),
                          device="cpu", **dict(_headline(mt), pad_mode="bucket",
                                               linear_solver="blocked"))
    assert (solver.prob.n, solver.prob.m) == (1024, 32)
    got = solver.solve()
    assert int(got.status) == int(want.status) == 1
    assert abs(got.iter - want.iter) <= 1
    assert got.objective == pytest.approx(want.objective, rel=1e-7)
    assert got.solution.shape == want.solution.shape == (1000,)
    # W 1024^2 is one stripe of four 256-column panels: three in-stripe
    # updates per factorization, each of the block below and right of its
    # panel: (768, 768, 256), (512, 512, 256), (256, 256, 256).
    shapes = blocked_dense.panel_update_shapes(1024)
    assert shapes == [(768, 768, 256), (512, 512, 256), (256, 256, 256)]
    assert len(calls) == len(shapes) * got.counters.factorizations > 0
    assert calls == shapes * got.counters.factorizations


def test_bucketed_warm_start_matches_reference():
    qp = lambda pkg: pkg.random_qp(40, 12, seed=2, ineq=True)  # noqa: E731
    opts = dict(print_level=40, tol=1e-8, pad_mode="bucket")
    cold = mq.solve(qp(mq), **opts)
    results = []
    for pkg, kw in ((mq, {}), (mt, dict(device="cpu"))):
        solver = pkg.MPCSolver(qp(pkg), **kw, **opts)
        solver.set_initial_point(x=cold.solution, y=cold.multipliers,
                                 zl=cold.multipliers_L, zu=cold.multipliers_U)
        results.append(solver.solve())
    want, got = results
    assert int(got.status) == int(want.status) == 1
    assert got.iter == want.iter < cold.iter
    assert got.objective == pytest.approx(want.objective, rel=1e-9)


def _routes(monkeypatch, problem, **kwargs):
    """The kwargs that each package's autosolve hands to its solve."""
    seen = {}

    def recorder(name):
        def fake_solve(qp, **kw):
            seen[name] = kw
            return "routed"
        return fake_solve

    monkeypatch.setattr(jax_driver, "solve", recorder("jax"))
    monkeypatch.setattr(port_driver, "solve", recorder("port"))
    assert mq.autosolve(problem(mq), **kwargs) == "routed"
    assert mt.autosolve(problem(mt), device="cpu", **kwargs) == "routed"
    return seen["jax"], seen["port"]


@pytest.mark.parametrize("problem,route", [
    (lambda pkg: pkg.dense_dummy_qp(25, 10), {"pad_mode": "bucket"}),
    (lambda pkg: pkg.random_qp(2000, 1000), {"pad_mode": "bucket",
                                             "linear_solver": "blocked"}),
])
def test_autosolve_routes_like_reference(monkeypatch, problem, route):
    want, got = _routes(monkeypatch, problem, tol=1e-7)
    assert got.pop("device") == "cpu"
    assert got == want == dict(route, tol=1e-7)


def test_autosolve_keeps_explicit_options(monkeypatch):
    want, got = _routes(monkeypatch, lambda pkg: pkg.random_qp(2000, 1000),
                        linear_solver="dense", pad_mode="")
    got.pop("device")
    assert got == want == dict(linear_solver="dense", pad_mode="")


def test_autosolve_solves_like_reference():
    want = mq.autosolve(mq.dense_dummy_qp(25, 10), print_level=40)
    got = mt.autosolve(mt.dense_dummy_qp(25, 10), device="cpu", print_level=40)
    assert int(got.status) == int(want.status) == 1
    assert got.iter == want.iter
    assert got.objective == pytest.approx(want.objective, rel=1e-9)


def _sparse_qp(pkg, n=2000, m=100):
    A = sp.diags([np.ones(m), -np.ones(m)], [0, 1], shape=(m, n))
    return pkg.QuadraticProblem(
        c=np.linspace(-1.0, 1.0, n), A=A, lcon=np.zeros(m), ucon=np.zeros(m),
        lvar=np.zeros(n), uvar=np.ones(n), H=sp.eye(n))


def test_autosolve_sparse_route_raises(monkeypatch):
    routed = {}
    monkeypatch.setattr(jax_sparse_qp, "solve_sparse_qp",
                        lambda qp, **kw: routed.setdefault("jax", kw))
    mq.autosolve(_sparse_qp(mq))
    assert routed["jax"]["kkt_system"] == "auto"
    monkeypatch.setattr(port_driver, "solve",
                        lambda *a, **kw: pytest.fail("took the dense route"))
    with pytest.raises(NotImplementedError, match="item 13"):
        mt.autosolve(_sparse_qp(mt), device="cpu")


@pytest.mark.parametrize("entry", [mt.solve, mt.MPCSolver, mt.autosolve,
                                   problem_to_device])
def test_entry_points_default_to_cuda(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"

