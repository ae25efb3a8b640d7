"""The condensed (K1) sparse path (madqp_tpu_torch.solver.sparse_condensed)
against the JAX package's, on the CPU: the cases of
tests/test_sparse_condensed.py.

* The KKT alone: every index list (the contribution pairs over A0's rows,
  H0's upper triangle, the diagonal, the value gather) equal to the
  reference's; C's assembled values within 1e-14 of the reference's
  segment sums (relative to max|C|); the scaled factor and the solution of
  the full augmented system within 1e-12; the residual of that system
  within the reference test's 1e-8.
* `relax_equalities` bit-equal.
* Whole solves: status SOLVE_SUCCEEDED, the objective within 1e-8 relative
  of the reference's condensed solve (both relax the same equality rows)
  and within the reference test's 1e-5 of its augmented solve, the
  solution within 1e-6.  Iterations within COND_ITER_BAND: on these
  problems the condensed path's float64 count moves with the fronts'
  Cholesky rounding (ROADMAP.md Queue 3: the reference's
  own count moves by one under `solve_mode="inverse"`, the port's by two
  between K1's route twin and the library Cholesky), and within ITER_BAND
  under the float32 phase.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.solver import sparse_condensed as JCd
from madqp_tpu.solver import sparse_qp as JQ
from madqp_tpu_torch.solver import sparse_condensed as TCd
from madqp_tpu_torch.solver import sparse_lp as TL
from madqp_tpu_torch.solver import sparse_qp as TQ

COND_ITER_BAND = 2
ITER_BAND = 8
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _internal(A_int, H0, m):
    """Canonical COO of A_int = [A0, -I] and of block_diag(H0, 0)."""
    A = sp.csc_matrix(A_int)
    A.sum_duplicates()
    Acoo = A.sorted_indices().tocoo()
    Hcoo = None
    if H0 is not None:
        H_int = sp.block_diag([H0, sp.csc_matrix((m, m))], format="csc")
        H_int.sum_duplicates()
        Hcoo = H_int.sorted_indices().tocoo()
    return Acoo, Hcoo


def _jax_problem(Acoo, Hcoo, n, m):
    h = ((jnp.asarray(Hcoo.row.astype(np.int32)), jnp.asarray(Hcoo.col.astype(np.int32)),
          jnp.asarray(Hcoo.data)) if Hcoo is not None
         else (jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.int32), jnp.zeros((0,))))
    return JQ.SparseQPProblem(
        c0=jnp.zeros(()), c=jnp.zeros(n), b=jnp.zeros(m), has_lb=jnp.ones(n, bool),
        has_ub=jnp.zeros(n, bool), a_rows=jnp.asarray(Acoo.row.astype(np.int32)),
        a_cols=jnp.asarray(Acoo.col.astype(np.int32)), a_vals=jnp.asarray(Acoo.data),
        h_rows=h[0], h_cols=h[1], h_vals=h[2])


def _port_problem(Acoo, Hcoo, n, m):
    a = TL.coo_fields(Acoo.row, Acoo.col, Acoo.data, m, n, torch.float64, "cpu")
    base = dict(c0=torch.zeros((), dtype=torch.float64), c=torch.zeros(n, dtype=torch.float64),
                b=torch.zeros(m, dtype=torch.float64), has_lb=torch.ones(n, dtype=torch.bool),
                has_ub=torch.zeros(n, dtype=torch.bool), **{f"a_{k}": v for k, v in a.items()})
    if Hcoo is None:
        return TL.SparseLPProblem(**base)
    h = TL.coo_fields(Hcoo.row, Hcoo.col, Hcoo.data, n, n, torch.float64, "cpu")
    return TQ.SparseQPProblem(**base, **{f"h_{k}": v for k, v in h.items()})


def _jax_c(jk, jp, pr_diag, del_c):
    """C's values as the reference's factorize assembles them
    (madqp_tpu/solver/sparse_condensed.py:220-233), before the scaling."""
    import jax

    ix = jk.host_idx()
    n0 = jk.n0
    sig_x, sig_s = pr_diag[:n0], pr_diag[n0:]
    D = sig_s / (1.0 - del_c * sig_s)
    a0 = jp.a_vals[: jk.nnz0]
    contrib = a0[ix["pair_p"]] * D[ix["pair_k"]] * a0[ix["pair_q"]]
    c = jax.ops.segment_sum(contrib, ix["pair_e"], num_segments=jk.nnz_up)
    if jk.h_pos.size:
        c = c.at[ix["h_pos"]].add(jp.h_vals[ix["h_sel"]])
    return c.at[ix["diag_pos"]].add(sig_x)


@pytest.mark.parametrize("with_h", [False, True])
def test_condensed_kkt_solves_k2_system(with_h):
    """tests/test_sparse_condensed.py's case: the port's KKT against the
    reference's on the same inputs, and the full augmented system's
    residual [W Aᵀ; A δ_c I][dx; dy] = [rx; ry] with A = [A0, -I]."""
    rng = np.random.default_rng(0)
    m, n0 = 40, 25
    A0 = sp.random(m, n0, density=0.2, random_state=1, format="csc")
    A0 = A0 + sp.random(m, n0, density=0.05, random_state=7, format="csc")
    H0 = None
    if with_h:
        B = sp.random(n0, n0, density=0.15, random_state=3)
        H0 = (B @ B.T + 0.1 * sp.eye(n0)).tocsc()
    A_int = sp.hstack([A0, -sp.eye(m)], format="csc")
    jk, tk = JCd.DeviceSparseCondensedKKT(H0, A0), TCd.DeviceSparseCondensedKKT(H0, A0)
    for name in ("pair_p", "pair_q", "pair_k", "pair_e", "h_sel", "h_pos", "diag_pos",
                 "entry_row", "entry_col", "value_gather", "a0_rows", "a0_cols"):
        np.testing.assert_array_equal(getattr(tk, name), getattr(jk, name), err_msg=name)
    n = n0 + m
    Acoo, Hcoo = _internal(A_int, H0, m)
    np.testing.assert_array_equal(tk.coo_rows, Acoo.row)
    np.testing.assert_array_equal(tk.coo_cols, Acoo.col)
    jp, tp = _jax_problem(Acoo, Hcoo, n, m), _port_problem(Acoo, Hcoo, n, m)

    pr_diag = rng.uniform(0.1, 10.0, n)
    del_c = -1e-7
    c_t, _ = tk.assemble(tp, torch.as_tensor(pr_diag), del_c)
    c_j = np.asarray(_jax_c(jk, jp, jnp.asarray(pr_diag), del_c))
    assert np.abs(c_t.numpy() - c_j).max() <= 1e-14 * np.abs(c_j).max()

    ft = tk.factorize(tp, torch.as_tensor(pr_diag), del_c)
    fj = jk.factorize(jp, jnp.asarray(pr_diag), del_c)
    assert bool(tk.factor_ok(ft)) and bool(jk.factor_ok(fj))
    for P, Q in zip(ft[0], fj[0]):
        np.testing.assert_allclose(P.numpy(), np.asarray(Q), atol=1e-12)

    rx, ry = rng.standard_normal(n), rng.standard_normal(m)
    dx, dy = (v.numpy() for v in tk.solve(ft, torch.as_tensor(rx), torch.as_tensor(ry)))
    wx, wy = (np.asarray(v) for v in jk.solve(fj, jnp.asarray(rx), jnp.asarray(ry)))
    np.testing.assert_allclose(dx, wx, atol=1e-12)
    np.testing.assert_allclose(dy, wy, atol=1e-12)
    W = np.diag(pr_diag)
    if H0 is not None:
        W[:n0, :n0] += H0.toarray()
    Ad = A_int.toarray()
    assert np.max(np.abs(W @ dx + Ad.T @ dy - rx)) < 1e-8
    assert np.max(np.abs(Ad @ dx + del_c * dy - ry)) < 1e-8


def test_relax_equalities():
    qp_t = mt.random_qp(n=30, m=12, seed=5, ineq=False)   # all equality rows
    qp_j = mq.random_qp(n=30, m=12, seed=5, ineq=False)
    got, want = TCd.relax_equalities(qp_t, 1e-8), JCd.relax_equalities(qp_j, 1e-8)
    np.testing.assert_array_equal(got.lcon, want.lcon)
    np.testing.assert_array_equal(got.ucon, want.ucon)
    assert np.all(got.lcon < got.ucon)
    assert np.all(got.ucon - got.lcon >= 1.9e-8 * np.maximum(1.0, np.abs(qp_t.lcon)))
    ineq = mt.ineq_qp(n=60, m_factor=2, band=4, seed=3)   # no equality rows
    assert TCd.relax_equalities(ineq, 1e-8) is ineq


def _check(got, want, aug=None, iter_band=COND_ITER_BAND):
    assert got.status == want.status == mq.Status.SOLVE_SUCCEEDED
    assert abs(got.iter - want.iter) <= iter_band, (got.iter, want.iter)
    assert got.objective == pytest.approx(want.objective, rel=1e-8, abs=1e-12)
    np.testing.assert_allclose(got.solution, want.solution, atol=1e-6)
    if aug is not None:
        assert got.objective == pytest.approx(aug.objective, abs=1e-5, rel=1e-5)
        assert np.max(np.abs(got.solution - aug.solution)) < 1e-4


CASES = {
    "random_lp": lambda P: P.random_lp(n=60, m=25, seed=2),
    "random_qp_ineq": lambda P: P.random_qp(n=50, m=20, seed=3, ineq=True),
    "random_qp_eq": lambda P: P.random_qp(n=40, m=15, seed=4, ineq=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_condensed_end_to_end_matches_augmented(case):
    got = mt.solve_sparse_condensed(CASES[case](mt), tol=1e-8, print_level=0, **CPU)
    want = mq.solve_sparse_condensed(CASES[case](mq), tol=1e-8, print_level=0)
    aug = mq.solve_sparse_qp(CASES[case](mq), kkt_system="augmented", tol=1e-8,
                             print_level=0)
    _check(got, want, aug)


def test_condensed_via_solve_sparse_qp_routing():
    qp_t, qp_j = mt.random_qp(n=30, m=12, seed=9, ineq=True), mq.random_qp(n=30, m=12, seed=9,
                                                                         ineq=True)
    got = mt.solve_sparse_qp(qp_t, kkt_system="condensed", tol=1e-8, print_level=0, **CPU)
    want = mq.solve_sparse_qp(qp_j, kkt_system="condensed", tol=1e-8, print_level=0)
    _check(got, want, mq.solve(qp_j, tol=1e-8, print_level=0))


@pytest.mark.parametrize("endgame", ["f64", "host"])
def test_condensed_f32_two_phase(endgame):
    """The float32 factorization (the pivot-floored LDLᵀ, all signs +1)
    under a float64 state, then the float64 refactorization or the host K2
    endgame on the relaxed problem."""
    kw = dict(tol=1e-8, factorization_dtype="float32", precision_scheme="two-phase",
              print_level=0, endgame=endgame)
    got = mt.solve_sparse_condensed(mt.random_qp(n=50, m=20, seed=11, ineq=True), **kw, **CPU)
    want = mq.solve_sparse_condensed(mq.random_qp(n=50, m=20, seed=11, ineq=True), **kw)
    _check(got, want, mq.solve(mq.random_qp(n=50, m=20, seed=11, ineq=True), tol=1e-8,
                               print_level=0), iter_band=ITER_BAND)
    assert got.counters.endgame_backend == want.counters.endgame_backend


def test_auto_routes_ineq_dominated_to_condensed():
    """"auto" picks K1 for an inequality-dominated non-diagonal-H QP in
    both packages (the same record as "condensed"), and keeps K2 with
    equality rows."""
    qp_t, qp_j = mt.ineq_qp(n=120, m_factor=2, band=4, seed=3), mq.ineq_qp(n=120, m_factor=2,
                                                                         band=4, seed=3)
    assert TQ._condensed_auto_ok(qp_t) and JQ._condensed_auto_ok(qp_j)
    got = mt.solve_sparse_qp(qp_t, kkt_system="auto", tol=1e-8, print_level=0, **CPU)
    cond = mt.solve_sparse_qp(qp_t, kkt_system="condensed", tol=1e-8, print_level=0, **CPU)
    want = mq.solve_sparse_qp(qp_j, kkt_system="auto", tol=1e-8, print_level=0)
    assert got.iter == cond.iter and got.objective == cond.objective
    _check(got, want)
    assert not TQ._condensed_auto_ok(mt.random_qp(n=40, m=20, seed=5))
