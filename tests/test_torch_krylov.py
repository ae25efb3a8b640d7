"""The krylov endgame: `ops/krylov.py::pcg` against the JAX package's
`pcg` (madqp_tpu/ops/krylov.py), and the endgame of the sparse normal
equations and of the condensed path against the reference's, on the CPU.

* pcg on a seeded SPD system with a Jacobi preconditioner and with an
  inexact (float32 Cholesky) one: the same iteration count and the
  iterate within 1e-12 relative; a maxit cap and a zero right-hand side.
* `solve_sparse_lp(endgame="krylov")` (tests/test_mixed_precision_sparse.py
  ::TestKrylovEndgame's LP case, grid_lp(12), on the supernodal path and
  the dense-normal one) and `krylov_solve=True`; the condensed path's
  krylov endgame (test_condensed_krylov's QP): status, the endgame's
  backend, iterations within ITER_BAND (the float32 phase) and the
  objective within 1e-8 of the reference's (1e-10 of the port's own
  float64 endgame on the LP, as the reference's test holds it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.ops import krylov as JK
from madqp_tpu_torch.ops import krylov as TK

ITER_BAND = 8
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, n))
    M = P @ P.T / n + np.diag(rng.uniform(0.01, 10.0, n))
    return M, rng.standard_normal(n)


def _preconds(M):
    """Jacobi, and the inverse of M's float32 Cholesky factor product."""
    d = np.diag(M).copy()
    L32 = np.linalg.cholesky(M.astype(np.float32)).astype(np.float64)
    Minv = np.linalg.inv(L32 @ L32.T)
    return {"jacobi": lambda r, xp: r / xp.asarray(d),
            "f32-cholesky": lambda r, xp: xp.asarray(Minv) @ r}


@pytest.mark.parametrize("precond", ["jacobi", "f32-cholesky"])
@pytest.mark.parametrize("n,tol,maxit", [(60, 1e-12, 64), (200, 1e-10, 200), (60, 1e-14, 5)])
def test_pcg_matches_reference(precond, n, tol, maxit):
    M, b = _spd(n, seed=n)
    pre = _preconds(M)[precond]
    xj, kj = JK.pcg(lambda v: jnp.asarray(M) @ v, lambda r: pre(r, jnp), jnp.asarray(b),
                    tol_rel=tol, maxit=maxit)
    Mt = torch.as_tensor(M)
    xt, kt = TK.pcg(lambda v: Mt @ v, lambda r: pre(r, torch), torch.as_tensor(b),
                    tol_rel=tol, maxit=maxit)
    assert kt == int(kj) and 0 < kt <= maxit
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(xj)).max())
    if kt < maxit:
        assert np.linalg.norm(M @ xt.numpy() - b) <= tol * np.linalg.norm(b) * (1 + 1e-6)


def test_pcg_zero_rhs_takes_no_iteration():
    M, _ = _spd(20, seed=1)
    Mt = torch.as_tensor(M)
    x, k = TK.pcg(lambda v: Mt @ v, lambda r: r, torch.zeros(20, dtype=torch.float64))
    xj, kj = JK.pcg(lambda v: jnp.asarray(M) @ v, lambda r: r, jnp.zeros(20))
    assert k == int(kj) == 0 and not x.any()


KW = dict(print_level=40, factorization_dtype="float32", max_refine_steps=1, tol=1e-8)


@pytest.mark.parametrize("mode", ["auto", "batched"])
def test_lp_krylov_endgame_matches_reference(mode):
    """grid_lp(12) with endgame="krylov": the float32 phase, then float64 CG
    preconditioned by the float32 factor (the dense-normal factor under
    "auto", the supernodal floored LDLᵀ under "batched")."""
    got = mt.solve_sparse_lp(mt.grid_lp(g=12, seed=0), endgame="krylov", mode=mode, **KW, **CPU)
    want = mq.solve_sparse_lp(mq.grid_lp(g=12, seed=0), endgame="krylov", mode=mode, **KW)
    f64 = mt.solve_sparse_lp(mt.grid_lp(g=12, seed=0), endgame="f64", mode=mode, **KW, **CPU)
    assert got.status == want.status == f64.status == mt.Status.SOLVE_SUCCEEDED
    assert got.counters.endgame_backend == want.counters.endgame_backend == "device-krylov"
    assert abs(got.iter - want.iter) <= ITER_BAND
    assert got.objective == pytest.approx(want.objective, rel=1e-8)
    assert got.objective == pytest.approx(f64.objective, rel=1e-10)
    assert got.primal_feas < 1e-8 and got.dual_feas < 1e-8


def test_krylov_solve_from_the_start_matches_reference():
    """krylov_solve=True without the two-phase scheme: float64 CG on the
    normal equations preconditioned by the float64 factor."""
    qp = lambda P: P.banded_sparse_lp(60, 30)  # noqa: E731
    got = mt.solve_sparse_lp(qp(mt), krylov_solve=True, tol=1e-8, print_level=0, **CPU)
    want = mq.solve_sparse_lp(qp(mq), krylov_solve=True, tol=1e-8, print_level=0)
    assert got.status == want.status == mt.Status.SOLVE_SUCCEEDED
    assert got.iter == want.iter
    assert got.objective == pytest.approx(want.objective, rel=1e-9)


def _condensed_qp(pkg):
    """tests/test_mixed_precision_sparse.py::test_condensed_krylov's QP."""
    rng = np.random.default_rng(0)
    n, m = 120, 240
    H = sp.diags([np.full(n - 1, -1.0), np.full(n, 2.5), np.full(n - 1, -1.0)],
                 (-1, 0, 1), format="csr")
    A = sp.random(m, n, density=0.05, random_state=np.random.RandomState(1),
                  data_rvs=lambda k: rng.uniform(0.5, 1.5, k)).tocsr()
    x_f = rng.uniform(0.2, 0.8, n)
    mid = np.asarray(A @ x_f).ravel()
    return pkg.QuadraticProblem(c=rng.standard_normal(n), H=H, A=A, lcon=mid - 1.0,
                                ucon=mid + 1.0, lvar=np.zeros(n), uvar=np.ones(n))


def test_condensed_krylov_matches_reference():
    got = mt.solve_sparse_condensed(_condensed_qp(mt), endgame="krylov", **KW, **CPU)
    want = mq.solve_sparse_condensed(_condensed_qp(mq), endgame="krylov", **KW)
    f64 = mt.solve_sparse_condensed(_condensed_qp(mt), endgame="f64", **KW, **CPU)
    assert got.status == want.status == f64.status == mt.Status.SOLVE_SUCCEEDED
    assert got.counters.endgame_backend == want.counters.endgame_backend
    assert abs(got.iter - want.iter) <= ITER_BAND
    assert got.objective == pytest.approx(want.objective, rel=1e-8)
    assert got.objective == pytest.approx(f64.objective, rel=1e-8)
