"""The dense-normal sparse LP (madqp_tpu_torch.solver.sparse_lp) against the
JAX package's `solve_sparse_lp(mode="dense")`, on the CPU (K8 runs its
plain version there).

* One factorize + solve of `DeviceSparseNormalKKT` with both assemblies
  ("pairs", and "matmul" forced as the reference's test forces it) against
  the JAX KKT on the same inputs: the contribution lists equal, the
  solution of the reduced system within 1e-10 of the reference's and its
  residual within 1e-10; two assemblies bit-equal.
* Whole solves against the reference on the cases of
  tests/test_sparse_lp.py, tests/test_sparse_cache.py and the LP cases of
  tests/test_mixed_precision_sparse.py (the n = 4000 banded LP cut to
  n = 600): float64 status and iterations equal, objective within 1e-9
  relative and solution within 1e-7; under the float32 phase the status,
  the endgame's backend and the objective within 1e-9 of the float64 one
  (1e-7 for the separable QP, as the reference's test holds it), and
  iterations within ITER_BAND of the reference's (which float32 factor
  trials pass differs between LAPACK builds: ROADMAP.md Queue 3).
* The port's dense-normal solve against its own host path
  (`test_dense_normal_mode_matches_host`), `autosolve`'s sparse route,
  and the routes that once raised naming their ROADMAP.md item (the krylov
  endgame and the augmented and condensed systems among them), each
  against the reference.
* The supernodal modes ("batched", and one front at a time, the
  reference's "unrolled"): the KKT's residual cases of
  tests/test_sparse_lp.py (its value gather equal to the reference's),
  whole float64 solves against the reference on the large tier's
  bandedlp_4000_0 and gridlp_32_0 and the mesh families (status and
  iterations equal, objective within 1e-9 relative, solution within 1e-7),
  the float32 phase (the pivot-floored LDL^T) with each endgame, the
  host-full route under a lowered MADQP_MAX_UPDATE_ENTRIES,
  `MPCSolver(kkt_system="sparse-normal")`, and the runner's --backend
  sparse-device on bandedlp_4000_0 with dense_normal_limit below its m.
"""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.solver import sparse_common as JC
from madqp_tpu.solver import sparse_lp as JL
from madqp_tpu.solver import sparse_qp as JQ
from madqp_tpu_torch.solver import sparse_common as TC
from madqp_tpu_torch.solver import policy as TP
from madqp_tpu_torch.solver import sparse_lp as TL
from madqp_tpu_torch.solver import sparse_qp as TQ

OBJ_RTOL = 1e-9
SOL_TOL = 1e-7
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


def _fixed(pkg):
    return pkg.FixedRegularization(1e-8, -1e-8)


def _common(pkg):
    return dict(tol=1e-8, max_iter=300, max_ncorr=3, print_level=0,
                step_rule=pkg.AdaptiveStep(0.995), regularization=_fixed(pkg))


def _prepared(pkg, family, *args, seed=0):
    from importlib import import_module

    qp = getattr(import_module(f"{pkg.__name__}.models.suite"), family)(*args, seed=seed)
    qp_p, _, ok = pkg.presolve_qp(qp)
    assert ok
    return pkg.scale_qp(qp_p)[0]


def _compare(got, want, iter_band=0):
    assert got.status == want.status
    assert abs(got.iter - want.iter) <= iter_band
    if want.status == mq.Status.SOLVE_SUCCEEDED:
        assert got.objective == pytest.approx(want.objective, rel=OBJ_RTOL, abs=1e-12)
        if iter_band == 0:
            np.testing.assert_allclose(got.solution, want.solution, atol=SOL_TOL)


# ---------------------------------------------------------------------------
# The KKT alone
# ---------------------------------------------------------------------------


def _kkt_inputs():
    rng = np.random.default_rng(0)
    m, n = 40, 90
    A = sp.random(m, n, density=0.1, random_state=1, format="csr")
    A = A + sp.hstack([sp.eye(m), sp.csr_matrix((m, n - m))]).tocsr()
    return A, rng.uniform(0.5, 2.0, n), rng.standard_normal(n), rng.standard_normal(m)


def _port_problem(kkt, m, n):
    """`_make_problem` of tests/test_sparse_lp.py in the port."""
    a = TL.coo_fields(kkt.coo_rows, kkt.coo_cols, kkt.coo_vals, m, n, torch.float64, "cpu")
    return TL.SparseLPProblem(
        c0=torch.zeros((), dtype=torch.float64), c=torch.zeros(n, dtype=torch.float64),
        b=torch.zeros(m, dtype=torch.float64), has_lb=torch.ones(n, dtype=torch.bool),
        has_ub=torch.zeros(n, dtype=torch.bool), **{f"a_{k}": v for k, v in a.items()})


def _force_matmul(kkt):
    kkt.assembly = "matmul"
    return kkt


@pytest.mark.parametrize("assembly", ["pairs", "matmul"])
def test_device_normal_kkt_residual(assembly):
    """tests/test_sparse_lp.py's case with mode="dense": the port's KKT
    against the reference's, a CSR input (the CSC ordering bug's
    regression)."""
    A, pr, rx, ry = _kkt_inputs()
    m, n = A.shape
    del_c = -1e-8
    jk = JL.DeviceSparseNormalKKT(A, mode="dense")
    tk = TL.DeviceSparseNormalKKT(A, mode="dense")
    if assembly == "matmul":
        jk.assembly, jk.symb, jk.value_gather = "matmul", None, None
        _force_matmul(tk)
    else:
        for name in ("pair_p", "pair_q", "pair_k", "pair_e", "entry_row", "entry_col",
                     "diag_pos"):
            np.testing.assert_array_equal(getattr(tk, name), getattr(jk, name), name)
    jp = JL.SparseLPProblem(
        c0=jnp.zeros(()), c=jnp.zeros(n), b=jnp.zeros(m), has_lb=jnp.ones(n, bool),
        has_ub=jnp.zeros(n, bool), a_rows=jnp.asarray(jk.coo_rows),
        a_cols=jnp.asarray(jk.coo_cols), a_vals=jnp.asarray(jk.coo_vals))
    tp = _port_problem(tk, m, n)
    np.testing.assert_array_equal(tp.a_vals.numpy(), jk.coo_vals)
    jf = jk.factorize(jp, jnp.asarray(pr), del_c)
    tf = tk.factorize(tp, torch.as_tensor(pr), torch.tensor(del_c, dtype=torch.float64))
    assert bool(jk.factor_ok(jf)) and bool(tk.factor_ok(tf))
    jdx, jdy = jk.solve(jf, jnp.asarray(rx), jnp.asarray(ry))
    tdx, tdy = tk.solve(tf, torch.as_tensor(rx), torch.as_tensor(ry))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-10)
    np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy), atol=1e-10)
    Ad = A.toarray()
    dx, dy = tdx.numpy(), tdy.numpy()
    assert np.abs(pr * dx + Ad.T @ dy - rx).max() < 1e-10
    assert np.abs(Ad @ dx + del_c * dy - ry).max() < 1e-10
    # a second assembly and factorization: the same bits
    again = tk.factorize(tp, torch.as_tensor(pr), torch.tensor(del_c, dtype=torch.float64))
    assert all(torch.equal(u, v) for u, v in zip(tf[0], again[0]))
    assert torch.equal(tf[2], again[2])


def test_matvecs_match_scipy():
    A, _, rx, ry = _kkt_inputs()
    p = _port_problem(TL.DeviceSparseNormalKKT(A), *A.shape)
    np.testing.assert_allclose(p.jac_mv(torch.as_tensor(rx)).numpy(), A @ rx, atol=1e-13)
    np.testing.assert_allclose(p.jac_rmv(torch.as_tensor(ry)).numpy(), A.T @ ry, atol=1e-13)


def test_pair_lists_match_reference_on_a_structured_member():
    """The NumPy pair lists against the reference's Python loops, on a
    presolved structured LP with unequal column counts."""
    qp = _prepared(mq, "setcover_lp", 60, 30)
    from madqp_tpu.models.qp import build_standard_form_sparse

    A = build_standard_form_sparse(qp)[0].A
    jk, tk = JL.DeviceSparseNormalKKT(A, mode="dense"), TL.DeviceSparseNormalKKT(A)
    assert tk.assembly == jk.assembly == "pairs"
    for name in ("pair_p", "pair_q", "pair_k", "pair_e", "entry_row", "entry_col",
                 "diag_pos"):
        np.testing.assert_array_equal(getattr(tk, name), getattr(jk, name), name)
    assert tk.nnz_up == jk.nnz_up


# ---------------------------------------------------------------------------
# Whole solves, float64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("assembly", ["pairs", "matmul"])
def test_dense_normal_solve_matches_reference_with_each_assembly(assembly, monkeypatch):
    """A whole float64 solve (presolved, scaled staircase_lp(20, 8)) with
    each assembly, "matmul" forced in both packages as the reference's
    dense-columns test forces it."""
    if assembly == "matmul":
        j_init, t_init = JL.DeviceSparseNormalKKT.__init__, TL.DeviceSparseNormalKKT.__init__

        def j_forced(self, A, **kw):
            j_init(self, A, **kw)
            self.assembly, self.symb, self.value_gather = "matmul", None, None

        def t_forced(self, A, **kw):
            t_init(self, A, **kw)
            _force_matmul(self)

        monkeypatch.setattr(JL.DeviceSparseNormalKKT, "__init__", j_forced)
        monkeypatch.setattr(TL.DeviceSparseNormalKKT, "__init__", t_forced)
    JC._KERNEL_CACHE.clear()
    TC._KERNEL_CACHE.clear()
    try:
        got = mt.solve_sparse_lp(_prepared(mt, "staircase_lp", 20, 8), mode="dense",
                                 **_common(mt), **CPU)
        want = mq.solve_sparse_lp(_prepared(mq, "staircase_lp", 20, 8), mode="dense",
                                  **_common(mq))
        kkt = next(reversed(TC._KERNEL_CACHE.values()))[0]
    finally:
        JC._KERNEL_CACHE.clear()
        TC._KERNEL_CACHE.clear()
    assert kkt.assembly == assembly
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    _compare(got, want)


def test_sparse_lp_matches_dense_solver():
    def run(pkg, **kw):
        return pkg.solve_sparse_lp(pkg.banded_sparse_lp(n=160, m=80, band=4, seed=3),
                                   tol=1e-8, print_level=0, **kw)

    got, want = run(mt, **CPU), run(mq)
    _compare(got, want)
    dense = mt.solve(mt.banded_sparse_lp(n=160, m=80, band=4, seed=3), tol=1e-8,
                     print_level=0, **CPU)
    assert got.iter == dense.iter  # the reference's test: iteration-identical
    assert got.primal_feas < 1e-7 and got.dual_feas < 1e-7


@pytest.mark.parametrize("make,arg", [("grid3d_lp", 8), ("netflow_grid_lp", 14)],
                         ids=["grid3d", "netflow"])
def test_mesh_families_match_reference(make, arg):
    got = mt.solve_sparse_lp(getattr(mt, make)(arg), tol=1e-8, print_level=40, **CPU)
    want = mq.solve_sparse_lp(getattr(mq, make)(arg), tol=1e-8, print_level=40)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    assert got.primal_feas < 1e-8 and got.dual_feas < 1e-8
    _compare(got, want)


def _infeasible(pkg):
    return pkg.QuadraticProblem(
        c=np.ones(2), A=sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 1.0]])),
        lcon=np.array([1.0, 2.0]), ucon=np.array([1.0, 2.0]),
        lvar=np.zeros(2), uvar=np.full(2, np.inf))


def _unbounded(pkg):
    return pkg.QuadraticProblem(
        c=np.array([-1.0, -1.0]), A=sp.csr_matrix(np.array([[1.0, -1.0]])),
        lcon=np.zeros(1), ucon=np.zeros(1),
        lvar=np.zeros(2), uvar=np.full(2, np.inf))


@pytest.mark.parametrize("make,status", [(_infeasible, "INFEASIBLE_PROBLEM_DETECTED"),
                                         (_unbounded, "UNBOUNDED_PROBLEM_DETECTED")],
                         ids=["infeasible", "unbounded"])
def test_certified_exits_match_reference(make, status):
    got = mt.solve_sparse_lp(make(mt), max_iter=300, print_level=0, **CPU)
    want = mq.solve_sparse_lp(make(mq), max_iter=300, print_level=0)
    assert got.status.name == want.status.name == status
    # diverging iterates cross the thresholds an iteration apart (ROADMAP.md
    # Queue 3, limits of a comparison)
    assert abs(got.iter - want.iter) <= 1


def test_dense_normal_mode_matches_host():
    """The reference's test: mode="dense" reproduces the host trajectory
    iteration for iteration in float64; here the port's against the JAX
    package's dense-normal solve, and against the port's own host path."""
    common_t, common_j = _common(mt), _common(mq)
    qp_t, qp_j = _prepared(mt, "staircase_lp", 20, 8), _prepared(mq, "staircase_lp", 20, 8)
    got = mt.solve_sparse_lp(qp_t, mode="dense", **common_t, **CPU)
    want = mq.solve_sparse_lp(qp_j, mode="dense", **common_j)
    host = mt.solve_host(qp_t, **common_t)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    _compare(got, want)
    assert got.iter == host.iter
    assert got.objective == pytest.approx(host.objective, rel=OBJ_RTOL)


def test_separable_qp_rides_the_normal_equations():
    """solve_sparse_qp(kkt_system="auto") on a diagonal Hessian takes the
    normal equations in both packages."""
    def run(pkg, **kw):
        return pkg.solve_sparse_qp(pkg.separable_qp(n=300, m=120, band=4, seed=2),
                                   kkt_system="auto", tol=1e-8, print_level=0, **kw)

    _compare(run(mt, **CPU), run(mq))


def test_autosolve_takes_the_sparse_route_as_reference():
    """tests/test_solver.py's autosolve case: banded_sparse_lp(1800, 900)
    is large and sparse, so autosolve runs solve_sparse_qp(kkt="auto")."""
    got = mt.autosolve(mt.banded_sparse_lp(n=1800, m=900, seed=1), print_level=0, **CPU)
    want = mq.autosolve(mq.banded_sparse_lp(n=1800, m=900, seed=1), print_level=0)
    _compare(got, want)
    direct = mt.solve_sparse_lp(mt.banded_sparse_lp(n=1800, m=900, seed=1),
                                print_level=0, **CPU)
    assert got.iter == direct.iter and got.objective == direct.objective


def test_measure_linear_solver_sparse_paths():
    """tests/test_mixed_precision_sparse.py's case: the measured time fills
    the counter; without measurement the host endgame's partial count is
    zeroed."""
    qp = _prepared(mt, "staircase_lp", 40, 8, seed=2)
    common = dict(tol=1e-8, print_level=0, factorization_dtype="float32",
                  max_refine_steps=1, endgame="host", **CPU)
    st = mt.solve_sparse_lp(qp, measure_linear_solver=True, **common)
    assert st.status == mt.Status.SOLVE_SUCCEEDED
    assert 0.0 < st.counters.linear_solver_time < st.counters.total_time
    st0 = mt.solve_sparse_lp(qp, **common)
    assert st0.counters.linear_solver_time == 0.0
    f64 = mt.solve_sparse_lp(qp, tol=1e-8, print_level=0, measure_linear_solver=True, **CPU)
    assert 0.0 < f64.counters.linear_solver_time


# ---------------------------------------------------------------------------
# The float32 phase and the endgames
# ---------------------------------------------------------------------------


def _banded(pkg):
    # tests/test_mixed_precision_sparse.py's banded LP (n = 4000, m = 2000)
    # cut to n = 600 for the CPU
    return pkg.banded_sparse_lp(n=600, m=300, band=5, seed=0)


MIXED = dict(factorization_dtype="float32", max_refine_steps=1)


@pytest.mark.parametrize("endgame", ["host", "f64"])
def test_two_phase_endgames_match_reference(endgame):
    """The float32 phase then the host endgame (HostMPCSolver warm-started)
    or a float64 phase of the device path, against the reference."""
    got = mt.solve_sparse_lp(_banded(mt), tol=1e-8, print_level=0, endgame=endgame,
                             **MIXED, **CPU)
    want = mq.solve_sparse_lp(_banded(mq), tol=1e-8, print_level=0, endgame=endgame,
                              **MIXED)
    ref64 = mt.solve_sparse_lp(_banded(mt), tol=1e-8, print_level=0, **CPU)
    assert got.status == want.status == mt.Status.SOLVE_SUCCEEDED
    assert got.counters.endgame_backend == want.counters.endgame_backend
    assert got.counters.endgame_backend == ("host" if endgame == "host" else "device-f64")
    assert got.counters.endgame_time > 0
    assert abs(got.iter - want.iter) <= ITER_BAND
    assert got.objective == pytest.approx(ref64.objective, rel=OBJ_RTOL)
    assert got.primal_feas < 1e-8 and got.dual_feas < 1e-8


def test_lp_two_phase_reaches_tol_and_auto_endgame_is_host():
    st = mt.solve_sparse_lp(_banded(mt), tol=1e-8, print_level=0,
                            factorization_dtype="float32", max_refine_steps=2, **CPU)
    ref = mt.solve_sparse_lp(_banded(mt), tol=1e-8, print_level=0, **CPU)
    assert st.status == mt.Status.SOLVE_SUCCEEDED
    assert st.counters.endgame_backend in ("host", "host-cold")  # "auto" + native
    assert st.objective == pytest.approx(ref.objective, rel=OBJ_RTOL)
    assert st.iter <= ref.iter + 6


def test_simple_scheme_and_loose_tol_run_one_phase():
    simple = mt.solve_sparse_lp(_banded(mt), tol=1e-8, print_level=0, max_iter=40,
                                precision_scheme="simple", factorization_dtype="float32",
                                max_refine_steps=2, **CPU)
    assert simple.status in (mt.Status.SOLVE_SUCCEEDED,
                             mt.Status.MAXIMUM_ITERATIONS_EXCEEDED)
    assert simple.counters.endgame_backend == ""
    loose = mt.solve_sparse_lp(_banded(mt), tol=1e-3, print_level=0,
                               factorization_dtype="float32", max_refine_steps=2, **CPU)
    assert loose.status == mt.Status.SOLVE_SUCCEEDED
    assert loose.counters.endgame_backend == ""


def test_dense_normal_mode_mixed_precision():
    """The reference's test (assignment_lp(15)): the float32 dense-normal
    phase with the 1e-6 shift, then the host endgame."""
    qp_t, qp_j = _prepared(mt, "assignment_lp", 15), _prepared(mq, "assignment_lp", 15)
    kw = dict(mode="dense", factorization_dtype="float32", max_refine_steps=1,
              endgame="host", tol=1e-8, print_level=0)
    got = mt.solve_sparse_lp(qp_t, regularization=_fixed(mt), **kw, **CPU)
    want = mq.solve_sparse_lp(qp_j, regularization=_fixed(mq), **kw)
    assert got.status == want.status == mt.Status.SOLVE_SUCCEEDED
    assert got.counters.endgame_backend in ("host", "host-cold")
    assert abs(got.iter - want.iter) <= ITER_BAND
    assert got.objective == pytest.approx(want.objective, rel=1e-7)


def test_dense_columns_endgame_rides_k2(monkeypatch):
    """Matmul assembly (forced on svm_qp(300, 40), as the reference's test
    forces it) hands the host endgame the K2 system."""
    qp = _prepared(mt, "svm_qp", 300, 40)
    seen = {}
    # the sparse drivers' shared tail (sparse_qp._solve_phases) calls it
    orig_endgame, orig_init = TQ._host_endgame, TL.DeviceSparseNormalKKT.__init__

    def spy(qp_, opts, final, info, std, t0, kkt_system="k2"):
        seen["kkt"] = kkt_system
        return orig_endgame(qp_, opts, final, info, std, t0, kkt_system=kkt_system)

    def forced(self, A, **kw):
        orig_init(self, A, **kw)
        _force_matmul(self)

    monkeypatch.setattr(TQ, "_host_endgame", spy)
    monkeypatch.setattr(TL.DeviceSparseNormalKKT, "__init__", forced)
    TC._KERNEL_CACHE.clear()
    st = mt.solve_sparse_lp(qp, mode="dense", factorization_dtype="float32",
                            max_refine_steps=1, endgame="host", tol=1e-8, print_level=0,
                            regularization=_fixed(mt), **CPU)
    TC._KERNEL_CACHE.clear()
    assert st.status == mt.Status.SOLVE_SUCCEEDED
    assert seen["kkt"] == "k2"


def test_qp_two_phase_matches_f64():
    """tests/test_mixed_precision_sparse.py: svm_qp(200, 30) (diagonal
    Hessian) under the float32 phase against the float64 solve."""
    from madqp_tpu_torch.models.suite import svm_qp

    qp = svm_qp(200, 30, seed=1)
    st = mt.solve_sparse_qp(qp, kkt_system="auto", tol=1e-8, print_level=0,
                            factorization_dtype="float32", max_refine_steps=2, **CPU)
    ref = mt.solve_sparse_qp(qp, kkt_system="auto", tol=1e-8, print_level=0, **CPU)
    assert st.status == mt.Status.SOLVE_SUCCEEDED
    assert st.objective == pytest.approx(ref.objective, rel=1e-7)


def test_illscaled_iteration_parity_vs_host():
    qp = _prepared(mt, "illscaled_lp", 200)
    common = _common(mt)
    host = mt.solve_host(qp, **common)
    assert host.status == mt.Status.SOLVE_SUCCEEDED
    mixed = mt.solve_sparse_lp(qp, factorization_dtype="float32", max_refine_steps=1,
                               endgame="host", **common, **CPU)
    assert mixed.status == mt.Status.SOLVE_SUCCEEDED
    assert mixed.iter <= 2 * host.iter


def test_two_phase_opts_match_reference():
    from madqp_tpu.utils.options import IPMOptions as JOpts
    from madqp_tpu_torch.utils.options import IPMOptions as TOpts

    for kw in (dict(factorization_dtype="float32", max_iter=300),
               dict(factorization_dtype="float32", max_iter=40, endgame="f64"),
               dict(factorization_dtype="float32", endgame="krylov", stall_exit=3)):
        for typed in (False, True):
            got = TP.two_phase_opts(TOpts(**kw), typed_phase1=typed)
            want = JC.two_phase_opts(JOpts(**kw), typed_phase1=typed)
            for g, w in zip(got, want):
                assert {f: getattr(g, f) for f in ("tol", "stall_exit", "max_iter", "dtype",
                                                   "factorization_dtype", "phase1_tol",
                                                   "krylov_solve", "endgame")} == \
                    {f: getattr(w, f) for f in ("tol", "stall_exit", "max_iter", "dtype",
                                                "factorization_dtype", "phase1_tol",
                                                "krylov_solve", "endgame")}


def test_host_full_solve_matches_reference():
    """The whole solve on the host path (kept for the supernodal schedule's
    cap), with its accounting: all of it endgame time, 'host-full'."""
    import time

    from madqp_tpu.utils import load_options as jopts
    from madqp_tpu_torch.utils import load_options as topts

    qp_t, qp_j = _prepared(mt, "staircase_lp", 20, 8), _prepared(mq, "staircase_lp", 20, 8)
    got = TQ._host_full_solve(qp_t, topts(**_common(mt))[0], time.time(), "normal")
    want = JQ._host_full_solve(qp_j, jopts(**_common(mq))[0], time.time(), "normal")
    _compare(got, want)
    assert got.counters.endgame_backend == "host-full"
    assert got.counters.endgame_time == got.counters.total_time > 0


# ---------------------------------------------------------------------------
# The pattern cache (tests/test_sparse_cache.py)
# ---------------------------------------------------------------------------


def _cache_banded(pkg, seed):
    return pkg.banded_sparse_lp(n=300, m=150, band=3, seed=seed)


def test_fingerprint_pattern_only():
    a, b = _cache_banded(mt, 0), _cache_banded(mt, 1)
    assert not np.allclose(a.A.data, b.A.data)
    assert TC.pattern_fingerprint(a.A) == TC.pattern_fingerprint(b.A)
    c = mt.banded_sparse_lp(n=300, m=150, band=4, seed=0)
    assert TC.pattern_fingerprint(a.A) != TC.pattern_fingerprint(c.A)
    assert TC.pattern_fingerprint(a.A) == JC.pattern_fingerprint(_cache_banded(mq, 0).A)


def test_lp_kernel_reused_values_differ():
    TC._KERNEL_CACHE.clear()
    st0 = mt.solve_sparse_lp(_cache_banded(mt, 0), tol=1e-8, print_level=0, **CPU)
    n_first = len(TC._KERNEL_CACHE)
    kkt = next(reversed(TC._KERNEL_CACHE.values()))[0]
    st1 = mt.solve_sparse_lp(_cache_banded(mt, 1), tol=1e-8, print_level=0, **CPU)
    assert len(TC._KERNEL_CACHE) == n_first
    assert next(reversed(TC._KERNEL_CACHE.values()))[0] is kkt  # no symbolic rebuild
    assert st0.status == st1.status == mt.Status.SOLVE_SUCCEEDED
    assert st0.objective != pytest.approx(st1.objective, rel=1e-3)
    _compare(st1, mq.solve_sparse_lp(_cache_banded(mq, 1), tol=1e-8, print_level=0))


# ---------------------------------------------------------------------------
# Routes and defaults
# ---------------------------------------------------------------------------


def test_rejects_general_qp_as_reference():
    for pkg, kw in ((mq, {}), (mt, CPU)):
        with pytest.raises(ValueError):
            pkg.solve_sparse_lp(pkg.random_qp(n=20, m=10, seed=0), **kw)
        with pytest.raises(ValueError):
            pkg.solve_sparse_qp(pkg.random_qp(n=20, m=10, seed=0), kkt_system="normal", **kw)
        with pytest.raises(ValueError):
            pkg.solve_sparse_qp(pkg.simple_lp(), kkt_system="nope", **kw)


def _supernodal_route(pkg, **kw):
    """A route that raised before the supernodal path was ported: it now
    solves (a 60 x 30 banded LP, m above dense_normal_limit or the mode
    forced); `kw` are the route's options."""
    return pkg.solve_sparse_lp(pkg.banded_sparse_lp(60, 30), tol=1e-8, print_level=0,
                               **kw)


def _sparse_qp_route(pkg, **kw):
    """A route of solve_sparse_qp on random_qp(20, 10) (a general Hessian
    with equality rows); `kw` are the route's options."""
    return pkg.solve_sparse_qp(pkg.random_qp(20, 10, seed=0), tol=1e-8, print_level=0, **kw)


# route -> (solve function, its options, iterations band): the supernodal
# routes, and the krylov endgame and the augmented and condensed systems,
# which raised naming their ROADMAP.md items before they were ported.
ROUTES = {
    "batched": (_supernodal_route, dict(mode="batched"), 0),
    "scan": (_supernodal_route, dict(mode="scan"), 0),
    "above-dense-normal-limit": (_supernodal_route, dict(dense_normal_limit=20), 0),
    "krylov-endgame": (_supernodal_route, dict(endgame="krylov",
                                               factorization_dtype="float32"), ITER_BAND),
    "krylov-solve": (_supernodal_route, dict(krylov_solve=True), 0),
    "augmented": (_sparse_qp_route, {}, 0),
    "k2.5": (_sparse_qp_route, dict(kkt_system="k2.5"), 0),
    # the condensed path's float64 count moves with the fronts' Cholesky
    # rounding (ROADMAP.md Queue 3): within 2
    "condensed": (_sparse_qp_route, dict(kkt_system="condensed"), 2),
    "auto-nondiagonal": (_sparse_qp_route, dict(kkt_system="auto"), 0),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_unported_sparse_routes_raise(route):
    """Every sparse route that once raised naming its ROADMAP.md item now
    solves and matches the reference: the supernodal routes, the krylov
    endgame and the augmented and condensed systems."""
    solve, kw, band = ROUTES[route]
    got, want = solve(mt, **kw, **CPU), solve(mq, **kw)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    _compare(got, want, iter_band=band)
    if route == "krylov-endgame":
        assert got.counters.endgame_backend == want.counters.endgame_backend == "device-krylov"


@pytest.mark.parametrize("entry", [mt.solve_sparse_lp, mt.solve_sparse_qp])
def test_sparse_entry_points_default_to_cuda(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# The supernodal modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order,mode", [("amd", "batched"), ("rcm", "batched"),
                                        ("amd", "unrolled")])
def test_supernodal_kkt_residual(order, mode):
    """tests/test_sparse_lp.py's residual case in the supernodal modes: the
    schedule's value gather equal to the reference's, the reduced system's
    solution within 1e-10 of the reference's, its residuals within 1e-10,
    and two factorizations bit-equal."""
    A, pr, rx, ry = _kkt_inputs()
    m, n = A.shape
    del_c = -1e-8
    jk = JL.DeviceSparseNormalKKT(A, order=order, mode=mode)
    tk = TL.DeviceSparseNormalKKT(A, order=order, mode=mode)
    np.testing.assert_array_equal(tk.value_gather, jk.value_gather)
    np.testing.assert_array_equal(tk.symb.perm, jk.symb.perm)
    jp = JL.SparseLPProblem(
        c0=jnp.zeros(()), c=jnp.zeros(n), b=jnp.zeros(m), has_lb=jnp.ones(n, bool),
        has_ub=jnp.zeros(n, bool), a_rows=jnp.asarray(jk.coo_rows),
        a_cols=jnp.asarray(jk.coo_cols), a_vals=jnp.asarray(jk.coo_vals))
    tp = _port_problem(tk, m, n)
    dc = torch.tensor(del_c, dtype=torch.float64)
    jf = jk.factorize(jp, jnp.asarray(pr), del_c)
    tf = tk.factorize(tp, torch.as_tensor(pr), dc)
    assert bool(jk.factor_ok(jf)) and bool(tk.factor_ok(tf))
    jdx, jdy = jk.solve(jf, jnp.asarray(rx), jnp.asarray(ry))
    tdx, tdy = tk.solve(tf, torch.as_tensor(rx), torch.as_tensor(ry))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-10)
    np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy), atol=1e-10)
    Ad = A.toarray()
    dx, dy = tdx.numpy(), tdy.numpy()
    assert np.abs(pr * dx + Ad.T @ dy - rx).max() < 1e-10
    assert np.abs(Ad @ dx + del_c * dy - ry).max() < 1e-10
    again = tk.factorize(tp, torch.as_tensor(pr), dc)
    assert all(torch.equal(u, v) for u, v in zip(tf[0], again[0]))


def _large_member(pkg, family):
    """A large-tier member (seed 0), presolved and scaled as the runner
    does."""
    from importlib import import_module

    suite = import_module(f"{pkg.__name__}.models.suite")
    (_, qp), = suite.structured_suite("large", seeds=(0,), families=(family,))
    qp_p, _, ok = pkg.presolve_qp(qp)
    assert ok
    return pkg.scale_qp(qp_p)[0]


SUPERNODAL = {
    # bandedlp_4000_0 (m = 2000) with the stored inverse diagonal blocks
    "bandedlp_4000_0": (lambda pkg: _large_member(pkg, "bandedlp"),
                        dict(solve_mode="inverse")),
    "gridlp_32_0": (lambda pkg: _large_member(pkg, "gridlp"), {}),
    "grid3d": (lambda pkg: pkg.grid3d_lp(8), {}),
    "netflow": (lambda pkg: pkg.netflow_grid_lp(14), {}),
}


@pytest.mark.parametrize("case", list(SUPERNODAL))
def test_batched_solve_matches_reference(case):
    make, kw = SUPERNODAL[case]
    got = mt.solve_sparse_lp(make(mt), mode="batched", **_common(mt), **kw, **CPU)
    want = mq.solve_sparse_lp(make(mq), mode="batched", **_common(mq), **kw)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    _compare(got, want)


@pytest.mark.parametrize("endgame", ["host", "f64"])
def test_batched_two_phase_matches_reference(endgame):
    """tests/test_mixed_precision_sparse.py's banded LP (cut to n = 600)
    with mode="batched": the float32 phase on the pivot-floored LDL^T,
    then the host endgame or the float64 supernodal phase; status and the
    endgame's backend equal, iterations within ITER_BAND, the objective
    within 1e-9 of the float64 solve's."""
    kw = dict(mode="batched", tol=1e-8, print_level=0, endgame=endgame, **MIXED)
    got = mt.solve_sparse_lp(_banded(mt), **kw, **CPU)
    want = mq.solve_sparse_lp(_banded(mq), **kw)
    ref64 = mt.solve_sparse_lp(_banded(mt), mode="batched", tol=1e-8, print_level=0, **CPU)
    assert got.status == want.status == mt.Status.SOLVE_SUCCEEDED
    assert got.counters.endgame_backend == want.counters.endgame_backend
    assert abs(got.iter - want.iter) <= ITER_BAND
    assert got.objective == pytest.approx(ref64.objective, rel=OBJ_RTOL)
    assert got.primal_feas < 1e-8 and got.dual_feas < 1e-8
    # the pattern cache also holds other tests' augmented / condensed KKTs
    kkt = next(k for k, _ in TC._KERNEL_CACHE.values()
               if isinstance(k, TL.DeviceSparseNormalKKT)
               and k.mode == "batched" and k.fact_dtype == torch.float32)
    assert kkt.use_ldl and kkt.pivot_floor == 1e-6


def test_batched_simple_scheme_runs_one_phase():
    st = mt.solve_sparse_lp(_banded(mt), mode="batched", tol=1e-8, print_level=0, max_iter=40,
                            precision_scheme="simple", factorization_dtype="float32",
                            max_refine_steps=2, **CPU)
    assert st.status in (mt.Status.SOLVE_SUCCEEDED, mt.Status.MAXIMUM_ITERATIONS_EXCEEDED)
    assert st.counters.endgame_backend == ""


def test_schedule_cap_falls_back_to_host(monkeypatch):
    """tests/test_sparse_lp.py's case: above MADQP_MAX_UPDATE_ENTRIES the
    whole solve runs on the host path ('host-full'), in both packages."""
    monkeypatch.setenv("MADQP_MAX_UPDATE_ENTRIES", "10")
    TC._KERNEL_CACHE.clear()
    JC._KERNEL_CACHE.clear()
    got = mt.solve_sparse_lp(mt.banded_sparse_lp(n=400, m=200, band=5, seed=3),
                             mode="batched", tol=1e-8, print_level=0, **CPU)
    want = mq.solve_sparse_lp(mq.banded_sparse_lp(n=400, m=200, band=5, seed=3),
                              mode="batched", tol=1e-8, print_level=0)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    assert got.counters.endgame_backend == want.counters.endgame_backend == "host-full"
    assert got.counters.endgame_time == got.counters.total_time
    _compare(got, want)


@pytest.mark.parametrize("options", [{}, dict(solve_mode="inverse"), MIXED],
                         ids=["f64", "inverse", "two-phase"])
def test_mpcsolver_sparse_normal_matches_reference(options):
    """MPCSolver(kkt_system="sparse-normal") (the "lp:auto:batched"
    kernel), in float64, with stored inverses, and with the float32
    factorization (its phase 2 always runs); against the reference's."""
    def run(pkg, **kw):
        return pkg.MPCSolver(_banded(pkg), kkt_system="sparse-normal", tol=1e-8,
                             print_level=40, **options, **kw).solve()

    got, want = run(mt, **CPU), run(mq)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    assert got.primal_feas < 1e-8 and got.dual_feas < 1e-8
    if options is MIXED:
        assert got.status == want.status and abs(got.iter - want.iter) <= ITER_BAND
        assert got.objective == pytest.approx(want.objective, rel=OBJ_RTOL)
    else:
        _compare(got, want)


def test_mpcsolver_sparse_normal_rejects_general_qp_as_reference():
    for pkg, kw in ((mq, {}), (mt, CPU)):
        with pytest.raises(ValueError, match="diagonal-Hessian"):
            pkg.MPCSolver(pkg.random_qp(n=20, m=10, seed=0), kkt_system="sparse-normal",
                          print_level=0, **kw)


def test_runner_takes_the_supernodal_path():
    """The slice end to end: bandedlp_4000_0 through the port's runner
    (read -> presolve -> scale -> solve_sparse_lp -> unscale) with
    --backend sparse-device and dense_normal_limit below its m = 2000, so
    "auto" takes the supernodal path, against the reference runner's
    record with the same options."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for sub in ("benchmarks", "tools"):
        if os.path.join(repo, sub) not in sys.path:
            sys.path.insert(0, os.path.join(repo, sub))
    import run_suite as R
    import run_suite_torch as T
    from madqp_tpu.models.suite import structured_suite as jsuite
    from madqp_tpu_torch.models.suite import structured_suite as tsuite

    def options(pkg):
        return dict(print_level=40, tol=1e-8, max_iter=300, max_ncorr=3,
                    kkt_system="condensed", linear_solver="dense",
                    step_rule=pkg.AdaptiveStep(0.995),
                    regularization=pkg.FixedRegularization(1e-8, -1e-8),
                    backend="sparse-device", sparse_kkt="auto", dense_normal_limit=1000)

    (name, jqp), = jsuite("large", seeds=(0,), families=("bandedlp",))
    (_, tqp), = tsuite("large", seeds=(0,), families=("bandedlp",))
    TC._KERNEL_CACHE.clear()
    got = T.run_instance(name, tqp, dict(options(mt), device="cpu"))
    want = R.run_instance(name, jqp, options(mq))
    kkt = next(reversed(TC._KERNEL_CACHE.values()))[0]
    assert kkt.mode == "batched" and kkt.m == 2000 and kkt.symb is not None
    for key in ("status", "status_detail", "iter"):
        assert got[key] == want[key], key
    assert got["status"] == 1
    assert got["objective"] == pytest.approx(want["objective"], rel=OBJ_RTOL)


def test_separable_qp_rides_the_supernodal_normal_equations():
    """A diagonal Hessian in the supernodal mode: W = H + Σ stays diagonal,
    so `solve_sparse_lp(mode="batched")` takes the QP; against the
    reference."""
    def run(pkg, **kw):
        return pkg.solve_sparse_lp(pkg.separable_qp(n=300, m=120, band=4, seed=2),
                                   mode="batched", tol=1e-8, print_level=0, **kw)

    got = run(mt, **CPU)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    _compare(got, run(mq))
