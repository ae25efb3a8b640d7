"""The augmented (K2) sparse QP path (madqp_tpu_torch.solver.sparse_qp)
against the JAX package's `solve_sparse_qp`, on the CPU (the signed fronts
take the reference's own `blocked_ldl` there; K2-batched runs only on the
card, tests/test_torch_cuda.py).

* The KKT alone (tests/test_sparse_qp.py's residual case): K's assembled
  value vector (before the scaling) bit-equal to the reference's
  scatter-adds of H, A, Σ and δ_c, the scaled vector within 1e-15 of it
  (the two rsqrt's part in the last bit), `expected_signs` and every index
  list equal; the solution's KKT residual within the reference test's
  1e-7 and within 1e-12 of the reference's solution; the inertia check
  rejecting an indefinite K in both packages.
* Whole solves against the reference on the cases of
  tests/test_sparse_qp.py and the suite's QP families at small sizes
  (random_qp, chain_qp(200), cvxqp_like(200), lasso_qp(200),
  portfolio_qp(60, 6)): in float64 status and iterations equal, objective
  within 1e-8 relative, solution within 1e-6; under the float32 phase
  status, iterations within ITER_BAND (ROADMAP.md Queue 3: which float32
  factorization trials pass differs between the two packages' LDLᵀ
  roundings) and the objective within 1e-8 of the reference's.
* `MPCSolver(kkt_system="sparse-augmented")` (and its warm restart),
  "auto" routing, the host-full reroute under a lowered
  MADQP_MAX_UPDATE_ENTRIES (a small laplqp), and the QP cases of
  tests/test_mixed_precision_sparse.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.solver import sparse_qp as JQ
from madqp_tpu_torch.solver import sparse_lp as TL
from madqp_tpu_torch.solver import sparse_qp as TQ

OBJ_RTOL = 1e-8
SOL_TOL = 1e-6
ITER_BAND = 8   # float32 phases: tests/test_torch_solver.py's RESCUE_ITER_BAND
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per module: six workers with a thread per core
    each oversubscribe the machine (tests/test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _compare(got, want, iter_band=0, obj_rtol=OBJ_RTOL):
    assert got.status == want.status
    assert abs(got.iter - want.iter) <= iter_band, (got.iter, want.iter)
    if want.status == mq.Status.SOLVE_SUCCEEDED:
        assert got.objective == pytest.approx(want.objective, rel=obj_rtol, abs=1e-12)
        if iter_band == 0:
            np.testing.assert_allclose(got.solution, want.solution, atol=SOL_TOL)


# ---------------------------------------------------------------------------
# The KKT alone
# ---------------------------------------------------------------------------


def _kkt_case():
    """tests/test_sparse_qp.py::test_augmented_kkt_residual_qp's data."""
    rng = np.random.default_rng(1)
    m, n = 35, 70
    A = sp.random(m, n, density=0.12, random_state=2, format="csr")
    A = A + sp.hstack([sp.eye(m), sp.csr_matrix((m, n - m))]).tocsr()
    B = sp.random(n, n, density=0.05, random_state=3)
    H = (B @ B.T).tocsc()
    return A, H, rng


def _jax_problem(kkt, n, m, H=None):
    """`_device_problem` of tests/test_sparse_qp.py."""
    if H is not None:
        Hcoo = sp.coo_matrix(H)
        h = (jnp.asarray(Hcoo.row.astype(np.int32)), jnp.asarray(Hcoo.col.astype(np.int32)),
             jnp.asarray(Hcoo.data))
    else:
        h = (jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.int32), jnp.zeros((0,)))
    return JQ.SparseQPProblem(
        c0=jnp.zeros(()), c=jnp.zeros(n), b=jnp.zeros(m), has_lb=jnp.ones(n, bool),
        has_ub=jnp.zeros(n, bool), a_rows=jnp.asarray(kkt.coo_rows),
        a_cols=jnp.asarray(kkt.coo_cols), a_vals=jnp.asarray(kkt.coo_vals),
        h_rows=h[0], h_cols=h[1], h_vals=h[2])


def _port_problem(kkt, n, m, H=None):
    a = TL.coo_fields(kkt.coo_rows, kkt.coo_cols, kkt.coo_vals, m, n, torch.float64, "cpu")
    base = dict(c0=torch.zeros((), dtype=torch.float64), c=torch.zeros(n, dtype=torch.float64),
                b=torch.zeros(m, dtype=torch.float64), has_lb=torch.ones(n, dtype=torch.bool),
                has_ub=torch.zeros(n, dtype=torch.bool), **{f"a_{k}": v for k, v in a.items()})
    if H is None:
        return TL.SparseLPProblem(**base)
    Hcoo = sp.coo_matrix(H)
    h = TL.coo_fields(Hcoo.row, Hcoo.col, Hcoo.data, n, n, torch.float64, "cpu")
    return TQ.SparseQPProblem(**base, **{f"h_{k}": v for k, v in h.items()})


def _jax_kv(jk, jp, pr_diag, del_c):
    """K's values as the reference's factorize assembles them
    (madqp_tpu/solver/sparse_qp.py:222-228), before the scaling."""
    ix = jk.host_idx()
    kv = jnp.zeros(jk.nnz_up, jnp.float64)
    if jk.h_pos.size:
        kv = kv.at[ix["h_pos"]].add(jp.h_vals[ix["h_sel"]])
    kv = kv.at[ix["a_pos"]].add(jp.a_vals)
    kv = kv.at[ix["wdiag_pos"]].add(pr_diag)
    return kv.at[ix["ddiag_pos"]].add(del_c)


@pytest.mark.parametrize("with_h", [True, False], ids=["qp", "lp"])
def test_augmented_kkt_matches_reference(with_h):
    A, H, rng = _kkt_case()
    H = H if with_h else None
    m, n = A.shape
    jk, tk = JQ.DeviceSparseAugmentedKKT(H, A), TQ.DeviceSparseAugmentedKKT(H, A)
    for name in ("h_sel", "h_pos", "a_pos", "wdiag_pos", "ddiag_pos", "alldiag_pos",
                 "entry_row", "entry_col", "value_gather", "coo_rows", "coo_cols"):
        np.testing.assert_array_equal(getattr(tk, name), getattr(jk, name), err_msg=name)
    assert len(tk.expected_signs) == len(jk.expected_signs)
    for a, b in zip(tk.expected_signs, jk.expected_signs):
        np.testing.assert_array_equal(a, b)
    jp, tp = _jax_problem(jk, n, m, jk.H), _port_problem(tk, n, m, tk.H)

    pr_diag = rng.uniform(0.5, 2.0, n)
    del_c = -1e-6
    kv_t = tk.assemble(tp, torch.as_tensor(pr_diag), del_c)
    kv_j = np.asarray(_jax_kv(jk, jp, jnp.asarray(pr_diag), del_c))
    np.testing.assert_array_equal(kv_t.numpy(), kv_j)   # bit-equal

    ft = tk.factorize(tp, torch.as_tensor(pr_diag), del_c)
    fj = jk.factorize(jp, jnp.asarray(pr_diag), del_c)
    np.testing.assert_allclose(ft[1].numpy(), np.asarray(fj[1]), rtol=1e-15, atol=0)
    assert bool(tk.factor_ok(ft)) and bool(jk.factor_ok(fj))

    rx, ry = rng.standard_normal(n), rng.standard_normal(m)
    dx, dy = (v.numpy() for v in tk.solve(ft, torch.as_tensor(rx), torch.as_tensor(ry)))
    wx, wy = (np.asarray(v) for v in jk.solve(fj, jnp.asarray(rx), jnp.asarray(ry)))
    np.testing.assert_allclose(dx, wx, atol=1e-12)
    np.testing.assert_allclose(dy, wy, atol=1e-12)
    W = np.diag(pr_diag) + (H.toarray() if with_h else 0.0)
    Ad = A.toarray()
    assert np.abs(W @ dx + Ad.T @ dy - rx).max() < 1e-7
    assert np.abs(Ad @ dx + del_c * dy - ry).max() < 1e-7


def test_inertia_check_rejects_indefinite():
    """A Hessian so indefinite that W loses positivity: both packages'
    pivot-sign checks reject K."""
    m, n = 10, 20
    A = sp.hstack([sp.eye(m), sp.csr_matrix((m, n - m))]).tocsr()
    H = (-5.0 * sp.eye(n)).tocsc()
    jk, tk = JQ.DeviceSparseAugmentedKKT(H, A), TQ.DeviceSparseAugmentedKKT(H, A)
    fj = jk.factorize(_jax_problem(jk, n, m, jk.H), jnp.full(n, 1e-8), -1e-8)
    ft = tk.factorize(_port_problem(tk, n, m, tk.H), torch.full((n,), 1e-8,
                                                                 dtype=torch.float64), -1e-8)
    assert not bool(jk.factor_ok(fj))
    assert not bool(tk.factor_ok(ft))


# ---------------------------------------------------------------------------
# Whole solves
# ---------------------------------------------------------------------------


def _suite(pkg, family, *args, seed=0):
    from importlib import import_module

    return getattr(import_module(f"{pkg.__name__}.models.suite"), family)(*args, seed=seed)


QP_CASES = {
    "random_qp": lambda P: P.random_qp(n=60, m=30, seed=7),
    "random_qp_ineq": lambda P: P.random_qp(n=40, m=20, seed=3),
    "lp_on_k2": lambda P: P.banded_sparse_lp(n=140, m=70, band=4, seed=9),
    "chain_qp_200": lambda P: _suite(P, "chain_qp", 200),
    "cvxqp_like_200": lambda P: _suite(P, "cvxqp_like", 200),
    "lasso_qp_200": lambda P: _suite(P, "lasso_qp", 200),
    "portfolio_qp_60_6": lambda P: _suite(P, "portfolio_qp", 60, 6),
}


@pytest.mark.parametrize("case", list(QP_CASES))
def test_augmented_solve_matches_reference(case):
    """tests/test_sparse_qp.py's solves (the QP and the LP on K2) and the
    suite's QP families: float64, status and iterations equal."""
    got = mt.solve_sparse_qp(QP_CASES[case](mt), tol=1e-8, print_level=0, **CPU)
    want = mq.solve_sparse_qp(QP_CASES[case](mq), tol=1e-8, print_level=0)
    assert want.status == mq.Status.SOLVE_SUCCEEDED
    _compare(got, want)
    assert got.counters.endgame_backend == ""


@pytest.mark.parametrize("kkt_system", ["k2", "k2.5", "scaled"])
def test_dense_spellings_take_the_augmented_system(kkt_system):
    got = mt.solve_sparse_qp(QP_CASES["random_qp_ineq"](mt), kkt_system=kkt_system,
                             tol=1e-8, print_level=0, **CPU)
    want = mq.solve_sparse_qp(QP_CASES["random_qp_ineq"](mq), kkt_system=kkt_system,
                              tol=1e-8, print_level=0)
    _compare(got, want)


@pytest.mark.parametrize("endgame", ["f64", "host", "krylov"])
def test_augmented_mixed_precision_matches_reference(endgame):
    """tests/test_sparse_qp.py::test_sparse_qp_mixed_precision with each
    endgame: the float32 phase (pivot floor 1e-6) then the float64
    refactorization ("krylov" falls back to it on K2) or the host K2."""
    kw = dict(tol=1e-8, print_level=0, factorization_dtype="float32",
              max_refine_steps=2, endgame=endgame)
    got = mt.solve_sparse_qp(QP_CASES["random_qp"](mt), **kw, **CPU)
    want = mq.solve_sparse_qp(QP_CASES["random_qp"](mq), **kw)
    _compare(got, want, iter_band=ITER_BAND)
    assert got.counters.endgame_backend == want.counters.endgame_backend
    assert got.counters.endgame_backend == ("host" if endgame == "host" else "device-f64")


def test_qp_two_phase_matches_f64():
    """tests/test_mixed_precision_sparse.py's case (a diagonal Hessian: the
    normal equations under "augmented"'s routing, as in the reference)."""
    kw = dict(tol=1e-8, print_level=0)
    mixed = dict(factorization_dtype="float32", max_refine_steps=2)
    got = mt.solve_sparse_qp(_suite(mt, "svm_qp", 200, 30, seed=1), **kw, **mixed, **CPU)
    want = mq.solve_sparse_qp(_suite(mq, "svm_qp", 200, 30, seed=1), **kw, **mixed)
    ref = mq.solve_sparse_qp(_suite(mq, "svm_qp", 200, 30, seed=1), **kw)
    _compare(got, want, iter_band=ITER_BAND)
    assert got.objective == pytest.approx(ref.objective, rel=1e-7)


def test_qp_augmented_host_endgame():
    """tests/test_mixed_precision_sparse.py::TestHostEndgame's QP case:
    chain_qp(120), the float32 phase on K2 then the float64 device endgame
    or the host K2 endgame; each against the reference's."""
    kw = dict(print_level=40, factorization_dtype="float32", max_refine_steps=1, tol=1e-8)
    for endgame in ("auto", "host"):
        got = mt.solve_sparse_qp(_suite(mt, "chain_qp", 120), endgame=endgame, **kw, **CPU)
        want = mq.solve_sparse_qp(_suite(mq, "chain_qp", 120), endgame=endgame, **kw)
        _compare(got, want, iter_band=ITER_BAND)
        assert got.counters.endgame_backend == want.counters.endgame_backend


# ---------------------------------------------------------------------------
# Routing and the driver
# ---------------------------------------------------------------------------


def test_sparse_kkt_via_mpcsolver():
    """MPCSolver(kkt_system="sparse-augmented") against the reference's,
    and a warm restart from its solution (tests/test_sparse_qp.py)."""
    got = mt.MPCSolver(mt.random_qp(n=40, m=20, seed=3), kkt_system="sparse-augmented",
                       tol=1e-8, print_level=0, **CPU)
    st = got.solve()
    want = mq.MPCSolver(mq.random_qp(n=40, m=20, seed=3), kkt_system="sparse-augmented",
                        tol=1e-8, print_level=0).solve()
    _compare(st, want)
    assert "sparse-augmented" in got.kernel.kkt.name
    got.set_initial_point(x=st.solution, y=st.multipliers, zl=st.multipliers_L,
                          zu=st.multipliers_U)
    st2 = got.solve()
    assert st2.status == mt.Status.SOLVE_SUCCEEDED
    assert st2.iter <= 3


@pytest.mark.parametrize("endgame", ["f64", "krylov"])
def test_mpcsolver_sparse_augmented_two_phase(endgame):
    """The driver's two-phase scheme on K2 (the float32 phase, then the
    float64 one: "krylov" refactors in float64 there, as in the
    reference)."""
    kw = dict(kkt_system="sparse-augmented", tol=1e-8, print_level=0,
              factorization_dtype="float32", max_refine_steps=2, endgame=endgame)
    got = mt.MPCSolver(mt.simple_lp(), **kw, **CPU).solve()
    want = mq.MPCSolver(mq.simple_lp(), **kw).solve()
    _compare(got, want, iter_band=ITER_BAND)


def test_sparse_normal_rejects_qp_in_driver():
    with pytest.raises(ValueError):
        mq.MPCSolver(mq.random_qp(n=20, m=10, seed=0), kkt_system="sparse-normal")
    with pytest.raises(ValueError):
        mt.MPCSolver(mt.random_qp(n=20, m=10, seed=0), kkt_system="sparse-normal", **CPU)


@pytest.mark.parametrize("kkt_system", ["normal", "auto"])
def test_sparse_qp_normal_diag_hessian(kkt_system):
    """A diagonal Hessian rides the normal equations under "normal" and
    "auto" (tests/test_sparse_qp.py)."""
    got = mt.solve_sparse_qp(mt.separable_qp(n=120, m=60, band=4, seed=2), tol=1e-8,
                             print_level=0, kkt_system=kkt_system, **CPU)
    want = mq.solve_sparse_qp(mq.separable_qp(n=120, m=60, band=4, seed=2), tol=1e-8,
                              print_level=0, kkt_system=kkt_system)
    _compare(got, want)


def test_sparse_qp_auto_falls_back_to_augmented():
    """"auto" with a non-diagonal Hessian and equality rows takes K2 in
    both packages."""
    qp_t, qp_j = mt.random_qp(n=40, m=20, seed=5), mq.random_qp(n=40, m=20, seed=5)
    assert not TQ._condensed_auto_ok(qp_t) and not JQ._condensed_auto_ok(qp_j)
    got = mt.solve_sparse_qp(qp_t, tol=1e-8, print_level=0, kkt_system="auto", **CPU)
    want = mq.solve_sparse_qp(qp_j, tol=1e-8, print_level=0, kkt_system="auto")
    _compare(got, want)
    _compare(got, mq.solve_sparse_qp(qp_j, tol=1e-8, print_level=0, kkt_system="augmented"))


@pytest.mark.parametrize("case", ["random_qp_eq", "random_qp_ineq", "ineq_qp", "chain_qp",
                                  "cvxqp_like", "lasso_qp", "portfolio_qp", "no_rows"])
def test_condensed_auto_guard_matches_reference(case):
    make = {"random_qp_eq": lambda P: P.random_qp(n=40, m=20, seed=5),
            "random_qp_ineq": lambda P: P.random_qp(n=40, m=20, seed=5, ineq=True),
            "ineq_qp": lambda P: P.ineq_qp(n=120, m_factor=2, band=4, seed=3),
            "chain_qp": lambda P: _suite(P, "chain_qp", 200),
            "cvxqp_like": lambda P: _suite(P, "cvxqp_like", 200),
            "lasso_qp": lambda P: _suite(P, "lasso_qp", 200),
            "portfolio_qp": lambda P: _suite(P, "portfolio_qp", 60, 6),
            "no_rows": lambda P: P.dense_dummy_qp(6, 0)}[case]
    assert TQ._condensed_auto_ok(make(mt)) == JQ._condensed_auto_ok(make(mq))


def test_sparse_qp_normal_rejects_nondiag_hessian():
    for pkg, kw in ((mq, {}), (mt, CPU)):
        with pytest.raises(ValueError, match="diagonal"):
            pkg.solve_sparse_qp(pkg.random_qp(n=20, m=10, seed=0), tol=1e-8, print_level=0,
                                kkt_system="normal", **kw)


def test_driver_sparse_normal_diag_hessian():
    """MPCSolver(kkt_system="sparse-normal") accepts diagonal-H QPs."""
    got = mt.MPCSolver(_suite(mt, "svm_qp", 50, 8, seed=4), kkt_system="sparse-normal",
                       tol=1e-8, print_level=0, **CPU).solve()
    want = mq.MPCSolver(_suite(mq, "svm_qp", 50, 8, seed=4), kkt_system="sparse-normal",
                        tol=1e-8, print_level=0).solve()
    _compare(got, want)


def test_schedule_cap_reroutes_to_host_full(monkeypatch):
    """A small laplqp whose schedule exceeds a lowered
    MADQP_MAX_UPDATE_ENTRIES (both packages read it at analysis time) is
    solved whole on the host path in both, with the reference's record;
    the port's total_time counts from entry (ROADMAP.md Queue 3)."""
    monkeypatch.setenv("MADQP_MAX_UPDATE_ENTRIES", "50")
    got = mt.solve_sparse_qp(_suite(mt, "laplacian_qp", 8), tol=1e-8, print_level=0, **CPU)
    want = mq.solve_sparse_qp(_suite(mq, "laplacian_qp", 8), tol=1e-8, print_level=0)
    assert want.counters.endgame_backend == got.counters.endgame_backend == "host-full"
    _compare(got, want)
    assert got.counters.endgame_time == got.counters.total_time > 0
