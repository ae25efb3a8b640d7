"""The batched lockstep solver: the port against the JAX package.

* One batched `iteration` from an identical batched state (carried across
  with madqp_tpu_torch.convert) against `jax.vmap(MPCKernel.iteration)`:
  every iterate field to 1e-9 relative (float64), counters and status
  exactly, for the starting-point call and later iterations; with one
  lane already terminal and, under NoRegularization, one lane whose
  factorization fails on its first trial (a zero row of A) and succeeds on
  the escalated second.
* Whole batched solves against the JAX package's `BatchedMPCSolver` on the
  cases of tests/test_parallel.py: status, per-lane iterations and
  objective (1e-8 relative in float64).  Where a float32 phase hands over
  to the float64 rescue: the same lanes rescued in both packages,
  iterations within RESCUE_ITER_BAND, objective within 1e-9 relative and
  solution within 1e-6.
* The port's batched lanes against its own single solves (equal
  iterations in float64), a mesh that is not a DeviceMesh (TypeError) and
  the backends that raised until the batch took them.
* The host rescue (endgame "auto" and "host" with the native library):
  the same lanes rescued as in the reference, each with the port's
  solve_host stats.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.parallel import BatchedMPCSolver as JBatched
from madqp_tpu.solver import state as JS
from madqp_tpu.solver.mpc import MPCKernel as JKernel
from madqp_tpu_torch.convert import ipm_state_from_numpy, problem_arrays_from_numpy
from madqp_tpu_torch.parallel import BatchedMPCSolver, solve_batched
from madqp_tpu_torch.parallel.batched import run_lanes
from madqp_tpu_torch.solver.mpc import BatchedMPCKernel
from madqp_tpu_torch.utils.options import load_options as port_options

ITER_RTOL = 1e-9
# Whether a float32 Cholesky of a near-singular Schur complement passes
# differs between LAPACK builds on bit-equal inputs, so a float32 phase
# can stall (or converge) at another iteration: measured spread 2
# iterations under 1, 2 and 6 torch threads (tests/test_torch_solver.py
# gives the band's reason: one stall window plus a margin).
RESCUE_ITER_BAND = 8
RESIDUALS = ("inf_pr", "inf_du", "inf_compl", "best_worst")


def _config(pkg, name):
    return {
        "headline_f64": dict(step_rule=pkg.AdaptiveStep(0.995),
                             regularization=pkg.FixedRegularization(1e-8, -1e-8),
                             max_refine_steps=1),
        "gondzio_mehrotra": dict(max_ncorr=3,
                                 step_rule=pkg.MehrotraAdaptiveStep(0.99)),
        "conservative_adaptive_reg": dict(
            step_rule=pkg.ConservativeStep(0.99),
            regularization=pkg.AdaptiveRegularization(),
            barrier_gate="one-sided", stall_exit=3, check_residual=True,
            tol_linear_solve=1e-6),
        "noreg_pallas": dict(regularization=pkg.NoRegularization(),
                             max_refine_steps=2, linear_solver="pallas"),
    }[name]


def _numpy_fields(nt):
    return {k: (tuple(np.asarray(a) for a in v) if k == "d"
                else (None if v is None else np.asarray(v)))
            for k, v in nt._asdict().items()}


def _compare_states(got, want):
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if name == "initialized":
            assert g is bool(np.asarray(w).all()), name
            continue
        if name == "d":
            pairs = [(np.asarray(a), b.numpy()) for a, b in zip(w, g)]
        else:
            pairs = [(np.asarray(w), g.numpy())]
        for wv, gv in pairs:
            assert gv.shape == wv.shape, name
            if np.issubdtype(wv.dtype, np.integer):
                np.testing.assert_array_equal(gv, wv, err_msg=name)
                continue
            assert gv.dtype == np.float64, name
            finite = np.isfinite(wv)
            np.testing.assert_array_equal(np.isfinite(gv), finite, err_msg=name)
            scale = np.max(np.abs(wv[finite]), initial=0.0)
            atol = 1e-12 if name in RESIDUALS else ITER_RTOL * scale
            np.testing.assert_allclose(gv[finite], wv[finite], rtol=ITER_RTOL,
                                       atol=atol, err_msg=name)


def _jax_batch(config):
    """JAX batched problem of four equal-shaped QPs.  Under
    NoRegularization lane 2 gets a zero row in A (b = 0 there), so its
    Schur complement is singular until the retry seeds del_c."""
    qps = [mq.dense_dummy_qp(12, 5, seed=i) for i in range(4)]
    jb = JBatched.from_problems(qps, print_level=40, **_config(mq, config))
    prob = {k: (None if v is None else np.array(v))
            for k, v in _numpy_fields(jb.prob).items()}
    if config == "noreg_pallas":
        prob["A"][2, 0] = 0.0
        prob["b"][2, 0] = 0.0
    jprob = JS.ProblemArrays(**{k: (None if v is None else jax.numpy.asarray(v))
                                for k, v in prob.items()})
    return jprob, prob, (jb.x0, jb.y0, jb.lb, jb.ub)


@pytest.mark.parametrize("config", ["headline_f64", "gondzio_mehrotra",
                                    "conservative_adaptive_reg", "noreg_pallas"])
def test_batched_iteration_matches_vmap(config):
    jprob, prob, start = _jax_batch(config)
    jk = JKernel(mq.IPMOptions(print_level=40, **_config(mq, config)))
    step = jax.jit(jax.vmap(jk.iteration))
    states = [jax.jit(jax.vmap(jk.init_state))(jprob, *start)]
    for _ in range(2):
        states.append(step(jprob, states[-1]))
    # Lane 0 already terminal: it must stay frozen while the others work.
    states.append(states[-1]._replace(status=states[-1].status.at[0].set(JS.SUCCESS)))
    topts, _ = port_options(print_level=40, **_config(mt, config))
    tk = BatchedMPCKernel(topts)
    tprob = problem_arrays_from_numpy(prob, device="cpu")
    for i in (0, 1, 3):  # starting-point call, first iteration, a frozen lane
        want = step(jprob, states[i])
        got = tk.iteration(tprob, ipm_state_from_numpy(_numpy_fields(states[i]),
                                                        device="cpu"))
        _compare_states(got, want)
        assert got.status.tolist() == np.asarray(want.status).tolist()
        if i == 3:
            assert int(got.status[0]) == JS.SUCCESS
            assert int(got.k[0]) == int(states[i].k[0])
    if config == "noreg_pallas":
        # the zero-row lane took two trials in the starting-point call and
        # kept its escalated del_c; the others kept their first factor
        first = tk.iteration(tprob, ipm_state_from_numpy(_numpy_fields(states[0]),
                                                         device="cpu"))
        assert first.del_c.tolist() == [0.0, 0.0, -1e-8, 0.0]


def _port_qp(qp):
    """A JAX-package QuadraticProblem handed to the port field by field."""
    return mt.QuadraticProblem(**{f.name: getattr(qp, f.name)
                                  for f in dataclasses.fields(mq.QuadraticProblem)})


def _rescue_problems():
    from madqp_tpu.models import suite as JSuite

    qps = [JSuite.transport_lp(12, 15, seed=0), mq.dense_dummy_qp(30, 12, seed=1)]
    return [mq.scale_qp(mq.presolve_qp(q)[0])[0] for q in qps]


def _structured_problems():
    from madqp_tpu.models.suite import structured_suite

    return [qp for _, qp in structured_suite(
        "medium", seeds=(0,), families=("illscaled", "svm", "redundant", "ranges"))]


def _headline(pkg):
    return dict(tol=1e-8, max_ncorr=0, factorization_dtype="float32",
                max_refine_steps=1, step_rule=pkg.AdaptiveStep(0.995),
                regularization=pkg.FixedRegularization(1e-8, -1e-8), endgame="f64")


# name -> (JAX problems, options for a package, float64 rescue?, name
# prefix of the problems compared by status only).  endgame="f64" is pinned on both sides: the
# JAX package would otherwise rescue on the host with its native library.
SOLVES = {
    "equal_shapes": (lambda: [mq.dense_dummy_qp(10, 4, seed=i) for i in range(4)],
                     lambda pkg: {}, False, None),
    "problems4": (lambda: [mq.dense_dummy_qp(8 + i, 4, seed=i) for i in range(4)],
                  lambda pkg: {}, False, None),
    "heterogeneous_padding": (
        lambda: [mq.dense_dummy_qp(6, 2, seed=1), mq.dense_dummy_qp(12, 7, seed=2),
                 mq.simple_lp()],
        lambda pkg: {}, False, None),
    "f32_rescue": (_rescue_problems,
                   lambda pkg: dict(tol=1e-8, max_iter=300, endgame="f64",
                                    factorization_dtype="float32",
                                    max_refine_steps=1), True, None),
    # The illscaled lane's 1e-8 stopping point depends on reduction order
    # (tests/test_parallel.py::test_batched_lane_shrunk_rescue_matches_full_width
    # pins no objective for it either): status only.
    "lane_shrunk_rescue": (_structured_problems, _headline, True, "illscaled"),
}


def _phase1_rescued(qps, options, pkg):
    """Lanes whose float32 phase, run alone (stall detection armed as the
    two-phase driver arms it, no float64 phase), ends unconverged."""
    kw = dict(options, precision_scheme="simple", stall_exit=5,
              max_iter=min(options.get("max_iter", 3000), 80), print_level=40)
    if pkg is mq:
        stats = JBatched.from_problems(qps, **kw).solve_all()
    else:
        stats = BatchedMPCSolver.from_problems([_port_qp(q) for q in qps],
                                               device="cpu", **kw).solve_all()
    return [s.status.name != "SOLVE_SUCCEEDED" for s in stats]


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_batched_solve_matches_jax(case):
    make, options, rescue, status_only = SOLVES[case]
    qps = make()
    want = JBatched.from_problems(qps, print_level=40, **options(mq)).solve_all()
    solver = BatchedMPCSolver.from_problems([_port_qp(q) for q in qps], device="cpu",
                                            print_level=40, **options(mt))
    got = solver.solve_all()
    assert len(got) == len(want) == len(qps)
    if rescue:
        rescued = _phase1_rescued(qps, options(mt), mt)
        assert any(rescued) and rescued == _phase1_rescued(qps, options(mq), mq)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.status == w.status == mt.Status.SOLVE_SUCCEEDED, (case, i)
        if status_only and qps[i].name.startswith(status_only):
            continue
        if rescue:
            assert abs(g.iter - w.iter) <= RESCUE_ITER_BAND, (case, i, g.iter, w.iter)
            assert g.objective == pytest.approx(w.objective, rel=1e-9)
            np.testing.assert_allclose(g.solution, w.solution, atol=1e-6)
        else:
            assert g.iter == w.iter, (case, i)
            assert g.objective == pytest.approx(w.objective, rel=1e-8, abs=1e-12)
            np.testing.assert_allclose(g.solution, w.solution, atol=1e-6)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_batched_lanes_match_single_solves(backend):
    """Each lane of the port's batch takes the iterations of the port's
    single solve of the same problem (float64), to the same objective."""
    qps = [mt.dense_dummy_qp(10 + 2 * i, 5, seed=20 + i) for i in range(3)]
    qps.append(mt.random_qp(14, 6, seed=3))
    kw = dict(print_level=40, linear_solver=backend, max_ncorr=2)
    got = solve_batched(qps, device="cpu", **kw)
    for qp, g in zip(qps, got):
        want = mt.solve(qp, device="cpu", **kw)
        assert g.status == want.status == mt.Status.SOLVE_SUCCEEDED
        assert g.iter == want.iter
        assert g.objective == pytest.approx(want.objective, rel=1e-9, abs=1e-12)


def test_lane_shrunk_rescue_gathers_only_failed_lanes():
    """With few failed lanes the float64 phase runs on a gathered power-of-
    two batch and scatters back: the lanes that passed phase 1 keep their
    phase-1 state bit for bit, the rescued lanes add both phases' counts."""
    qps = [_port_qp(q) for q in _structured_problems()]
    solver = BatchedMPCSolver.from_problems(qps, device="cpu", print_level=40,
                                            **_headline(mt))
    f1 = run_lanes(solver._kernel, solver.prob, solver._kernel.init_state(
        solver.prob, solver.x0, solver.y0, solver.lb, solver.ub))
    bad = (f1.status != JS.SUCCESS).nonzero()[:, 0].tolist()
    assert 0 < len(bad) <= len(qps) // 2
    final = solver.solve_batch()
    for i in range(len(qps)):
        if i in bad:
            assert final.status[i] == JS.SUCCESS and final.k[i] > f1.k[i]
        else:
            assert torch.equal(final.x[i], f1.x[i]) and final.k[i] == f1.k[i]


def test_run_lanes_freezes_stopped_lanes():
    """A lane that has left RUNNING keeps every field while the others
    iterate (the vmapped while_loop's select)."""
    qps = [mt.dense_dummy_qp(10, 4, seed=i) for i in range(3)]
    solver = BatchedMPCSolver.from_problems(qps, device="cpu", print_level=40)
    kern = solver._kernel
    st = kern.init_state(solver.prob, solver.x0, solver.y0, solver.lb, solver.ub)
    st = kern.iteration(solver.prob, st)
    st = st._replace(status=torch.tensor([JS.RUNNING, JS.MAX_ITER, JS.RUNNING]))
    final = run_lanes(kern, solver.prob, st)
    assert final.status.tolist() == [JS.SUCCESS, JS.MAX_ITER, JS.SUCCESS]
    for name in ("x", "y", "zl", "mu", "obj_val", "k", "n_fact"):
        assert torch.equal(getattr(final, name)[1], getattr(st, name)[1]), name


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "item 17"),
    (dict(linear_solver="blocked"), "item 18"),
    (dict(solve_mode="inverse"), "item 18"),
    (dict(kkt_system="k2"), "item 18"),
    (dict(kkt_system="k2.5"), "item 18"),
])
def test_unported_batched_paths_raise(kwargs, item):
    """The cases keep the ids of the paths that once raised naming their
    ROADMAP.md item.  mesh= (item 17) is ported: a mesh that is not a
    torch.distributed DeviceMesh raises TypeError (tests/test_torch_mesh.py
    runs the sharded batch).  The item-18 cases raised until every dense
    KKT backend had a batched form; now each solves as the reference's
    vmapped solver does (tests/test_torch_batched_backends.py::
    compare_batches, float64: every lane's status, iterations, objective
    and iterates)."""
    if item == "item 17":
        qps = [mt.dense_dummy_qp(6, 3, seed=i) for i in range(2)]
        with pytest.raises(TypeError, match="DeviceMesh"):
            BatchedMPCSolver.from_problems(qps, device="cpu", print_level=40, **kwargs)
        return
    from test_torch_batched_backends import _qps, compare_batches

    compare_batches(_qps(), kwargs)


def test_batched_host_endgame_matches_reference():
    """endgame="host" on test_unported_batched_paths_raise's two problems
    (it raised until the host path was ported): each lane's status,
    iterations and objective (1e-9 relative) as the reference's."""
    opts = dict(print_level=40, endgame="host", factorization_dtype="float32",
                max_refine_steps=1)
    want = JBatched.from_problems([mq.dense_dummy_qp(6, 3, seed=i) for i in range(2)],
                                  **opts).solve_all()
    got = BatchedMPCSolver.from_problems([mt.dense_dummy_qp(6, 3, seed=i) for i in range(2)],
                                         device="cpu", **opts).solve_all()
    for g, w in zip(got, want):
        assert int(g.status) == int(w.status) == 1
        assert g.iter == w.iter
        assert g.objective == pytest.approx(w.objective, rel=1e-9)


def test_batched_host_rescue_default():
    """tests/test_parallel.py::test_batched_host_rescue_default in both
    packages: with endgame="auto" and the native library, the lanes whose
    float32 phase fails are re-solved on the host path: the same lanes in
    both packages, every lane SOLVE_SUCCEEDED, a rescued lane's stats the
    port's own solve_host of it (iterations equal, objective within 1e-8
    relative of the host solve, and of the reference's rescued lane)."""
    opts = lambda pkg: dict(tol=1e-8, max_ncorr=0, factorization_dtype="float32",  # noqa: E731
                            max_refine_steps=1, step_rule=pkg.AdaptiveStep(0.995),
                            regularization=pkg.FixedRegularization(1e-8, -1e-8))
    jqps = _structured_problems()
    jax_solver = JBatched.from_problems(jqps, **opts(mq))
    want = jax_solver.solve_all()
    qps = [_port_qp(q) for q in jqps]
    solver = BatchedMPCSolver.from_problems(qps, device="cpu", **opts(mt))
    got = solver.solve_all()
    rescued = solver._rescue_overrides
    assert rescued and sorted(rescued) == sorted(jax_solver._rescue_overrides)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.status == mt.Status.SOLVE_SUCCEEDED, i
        if i in rescued:
            host = mt.solve_host(qps[i], tol=1e-8, print_level=30, max_ncorr=0,
                                 step_rule=mt.AdaptiveStep(0.995),
                                 regularization=mt.FixedRegularization(1e-8, -1e-8))
            assert g.iter == host.iter
            assert g.objective == pytest.approx(host.objective, rel=1e-8)
            assert g.objective == pytest.approx(w.objective, rel=1e-8)


def test_loop_mode_is_accepted_without_effect():
    qps = [mt.dense_dummy_qp(8, 3, seed=i) for i in range(2)]
    a = solve_batched(qps, device="cpu", print_level=40, loop_mode="python")
    b = solve_batched(qps, device="cpu", print_level=40, loop_mode="jit")
    assert [s.iter for s in a] == [s.iter for s in b]
    assert [s.objective for s in a] == [s.objective for s in b]
