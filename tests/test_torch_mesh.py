"""The port's `mesh=` over torch.distributed against the JAX package's
sharded solves: the batch (`BatchedMPCSolver`), the two-stage Schur
solve (`solve_two_stage`) and the shared-pattern sparse batch
(`solve_sparse_batched`).

The port's side runs in one spawned group of WORLD gloo ranks on the CPU
(`madqp_tpu_torch.parallel.mesh.spawn`, tests/torch_mesh_worker.py; one
more group of 4 ranks for the uneven batch), started by a module fixture
in a thread while this process computes the JAX side on `jax.make_mesh`
over tests/conftest.py's virtual CPU devices; the inputs are the same
NumPy-seeded problems in both packages.

* Batch: 8 x dense_dummy_qp(10, 5) over 2 ranks: every lane's status and
  iterations equal, objective within 1e-9 relative, x within 1e-7; 3
  instances over 4 ranks padded to 4 lanes (tests/test_parallel.py:53),
  3 stats returned, each the port's unsharded lane's; the float32-rescue
  problems of tests/test_torch_batched.py over 2 ranks with endgame
  "auto": no host rescue, the float64 phase 2 on every rank (the
  failed-lane count is global), iterations within RESCUE_ITER_BAND of the
  JAX package's, objective 1e-9, x 1e-6.
* Two-stage: random_two_stage(n0=6, ns=5, ms=3, m0=2, N=8, seed=3), QP and
  LP, over 2 ranks against the JAX sharded solve and the port's single
  solve at tests/test_structured.py:36-39's tolerances (iterations equal,
  objective 1e-8, x 1e-7); the float32 factorization against the port's
  single solve; N = 7 over 2 raises ValueError in both packages.
* Sparse batch: 5 x banded_sparse_lp(100, 50, band=4) over 2 ranks
  (padded to 6 lanes; tests/test_sparse_batched.py:48-58) and the
  augmented QP (3 x random_qp(36, 18), kkt_system="augmented") over 2
  ranks: status and iterations equal, objective within 1e-8 relative of
  the JAX sharded batch.
* Every rank returns the same stats; a mesh of one rank is bit-equal to
  mesh=None; `resolve`'s errors and the four collectives.
"""

import concurrent.futures as cf

import jax
import numpy as np
import pytest

import madqp_tpu as mq
import madqp_tpu_torch as mt
import torch_mesh_worker as worker
from madqp_tpu.parallel import BatchedMPCSolver as JBatched
from madqp_tpu.parallel import random_two_stage as j_two_stage
from madqp_tpu.parallel import solve_sparse_batched as j_sparse_batched
from madqp_tpu.parallel import solve_two_stage as j_solve_two_stage
from madqp_tpu_torch.parallel import mesh
from test_torch_batched import RESCUE_ITER_BAND, _port_qp, _rescue_problems

WORLD = 2
TWO_STAGE = dict(n0=6, ns=5, ms=3, m0=2, N=8, seed=3)
MIXED = dict(factorization_dtype="float32", max_refine_steps=1, max_iter=60)
RESCUE = dict(tol=1e-8, max_iter=300, endgame="auto", factorization_dtype="float32",
              max_refine_steps=1, print_level=40)
QUIET = dict(print_level=40)
SPARSE = dict(tol=1e-8, print_level=0)


def _batch8(pkg):
    return [pkg.dense_dummy_qp(10, 5, seed=i) for i in range(8)]


def _uneven(pkg):
    return [pkg.dense_dummy_qp(8 + i, 4, seed=i) for i in range(3)]


def _banded(pkg):
    return [pkg.banded_sparse_lp(n=100, m=50, band=4, seed=s) for s in range(5)]


def _qps(pkg):
    return [pkg.random_qp(n=36, m=18, seed=s, ineq=True) for s in range(3)]


SPARSE_CASES = {"sparse_lp": (_banded, SPARSE),
                "sparse_augmented": (_qps, dict(SPARSE, kkt_system="augmented"))}


def _cases():
    return [
        ("batched8", "batched", (_batch8(mt), QUIET)),
        ("rescue", "batched", ([_port_qp(q) for q in _rescue_problems()], RESCUE)),
        ("ts_qp", "two_stage", (dict(TWO_STAGE, qp=True), QUIET)),
        ("ts_lp", "two_stage", (dict(TWO_STAGE, qp=False), QUIET)),
        ("ts_mixed", "two_stage", (dict(TWO_STAGE, qp=True), dict(MIXED, **QUIET))),
        ("ts_uneven", "two_stage_uneven", dict(TWO_STAGE, N=7)),
        ("resolve", "resolve_errors", None),
        ("one_rank", "one_rank", [("batched", (_batch8(mt), QUIET)),
                                  ("two_stage", (dict(TWO_STAGE, qp=True), QUIET))]),
    ] + [(name, "sparse", (make(mt), opts)) for name, (make, opts) in SPARSE_CASES.items()]


@pytest.fixture(scope="module")
def port():
    """Each group's per-rank {case: result}, as futures: the groups run in
    threads while the tests compute the JAX side."""
    pool = cf.ThreadPoolExecutor(2)
    groups = {WORLD: pool.submit(mesh.spawn, worker.run_cases, WORLD, _cases()),
              4: pool.submit(mesh.spawn, worker.run_cases, 4,
                             [("uneven", "batched", (_uneven(mt), QUIET))])}
    yield lambda world=WORLD: groups[world].result()
    pool.shutdown()


def _jax_mesh(axis, n=WORLD):
    return jax.make_mesh((n,), (axis,))


def _assert_lanes(got, want, obj_rtol, x_atol, iter_band=0):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert int(g.status) == int(w.status) == 1, i
        assert abs(g.iter - w.iter) <= iter_band, (i, g.iter, w.iter)
        assert g.objective == pytest.approx(w.objective, rel=obj_rtol, abs=1e-12), i
        np.testing.assert_allclose(g.solution, w.solution, rtol=0, atol=x_atol, err_msg=str(i))


def test_batched_matches_jax_sharded(port):
    want = JBatched.from_problems(_batch8(mq), mesh=_jax_mesh("batch"), **QUIET).solve_all()
    ranks = port()
    assert [r["batched8"]["lanes"] for r in ranks] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    _assert_lanes(ranks[0]["batched8"]["stats"], want, 1e-9, 1e-7)


def test_uneven_batch_is_padded_to_the_mesh(port):
    """tests/test_parallel.py:53 over 4 ranks: 3 stats, each the port's
    unsharded batch's lane (tests/test_torch_batched.py holds that one to
    the JAX package's)."""
    want = mt.solve_batched(_uneven(mt), device="cpu", **QUIET)
    ranks = port(4)
    # rounded up to 4 lanes with a copy of the last instance
    assert [r["uneven"]["lanes"] for r in ranks] == [[0], [1], [2], [2]]
    for r in ranks:
        _assert_lanes(r["uneven"]["stats"], want, 1e-9, 1e-7)


def test_rescue_is_global_and_never_on_the_host(port):
    """Under a mesh a failed float32 lane is never re-solved on the host,
    and every rank runs the float64 phase 2 when any lane failed, as the
    reference's sharded batch does."""
    qps = _rescue_problems()
    want = JBatched.from_problems(qps, mesh=_jax_mesh("batch"), **RESCUE).solve_all()
    ranks = port()
    for r in ranks:
        assert r["rescue"]["overrides"] == {}
        assert r["rescue"]["phase2_calls"] > 0, r["rescue"]["lanes"]
    _assert_lanes(ranks[0]["rescue"]["stats"], want, 1e-9, 1e-6, RESCUE_ITER_BAND)


@pytest.mark.parametrize("qp", [True, False], ids=["qp", "lp"])
def test_two_stage_matches_jax_sharded_and_single(port, qp):
    prob, lb, ub = j_two_stage(**TWO_STAGE, qp=qp)
    want = j_solve_two_stage(prob, lb, ub, mesh=_jax_mesh("scen"), **QUIET)
    tp, tlb, tub = mt.random_two_stage(**TWO_STAGE, qp=qp, device="cpu")
    single = mt.solve_two_stage(tp, tlb, tub, device="cpu", **QUIET)
    got = port()[0]["ts_qp" if qp else "ts_lp"]
    for other in (want, single):
        assert int(got.status) == int(other.status) == 1
        assert got.iter == other.iter
        assert got.objective == pytest.approx(other.objective, abs=1e-8)
        np.testing.assert_allclose(got.solution, other.solution, rtol=0, atol=1e-7)


def test_two_stage_float32_factorization(port):
    """tests/test_structured.py::test_mixed_precision_schur over the mesh:
    solved, objective within 1e-6 of the float64 solve, and the port's
    single solve's iterations."""
    tp, tlb, tub = mt.random_two_stage(**TWO_STAGE, device="cpu")
    single = mt.solve_two_stage(tp, tlb, tub, device="cpu", **MIXED, **QUIET)
    f64 = port()[0]["ts_qp"]
    got = port()[0]["ts_mixed"]
    assert int(got.status) == int(single.status) == 1
    assert got.iter == single.iter
    assert got.objective == pytest.approx(f64.objective, abs=1e-6)
    np.testing.assert_allclose(got.solution, single.solution, rtol=0, atol=1e-6)


def test_uneven_scenarios_raise_in_both_packages(port):
    prob, lb, ub = j_two_stage(**dict(TWO_STAGE, N=7))
    with pytest.raises(ValueError):
        j_solve_two_stage(prob, lb, ub, mesh=_jax_mesh("scen"), **QUIET)
    msgs = [r["ts_uneven"] for r in port()]
    assert all(m and "7 scenarios" in m for m in msgs), msgs


@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_batch_matches_jax_sharded(port, case):
    make, opts = SPARSE_CASES[case]
    want = j_sparse_batched(make(mq), mesh=_jax_mesh("batch"), **opts)
    got = port()[0][case]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert int(g.status) == int(w.status) == 1, i
        assert g.iter == w.iter, (i, g.iter, w.iter)
        assert g.objective == pytest.approx(w.objective, rel=1e-8), i


@pytest.mark.parametrize("case", ["batched8", "rescue", "ts_qp", "ts_lp", "ts_mixed",
                                  *sorted(SPARSE_CASES)])
def test_every_rank_returns_the_same_stats(port, case):
    ranks = port()

    def key(res):
        stats = res["stats"] if isinstance(res, dict) else res
        stats = stats if isinstance(stats, list) else [stats]
        return [(int(s.status), s.iter, s.objective, s.solution.tobytes(),
                 s.multipliers.tobytes()) for s in stats]

    assert all(key(r[case]) == key(ranks[0][case]) for r in ranks[1:])


@pytest.mark.parametrize("i", [0, 1], ids=["batched", "two_stage"])
def test_one_rank_mesh_is_bit_equal_to_no_mesh(port, i):
    ranks = port()
    assert all(r["one_rank"] is None for r in ranks[1:])
    sharded, plain = ranks[0]["one_rank"][i]
    sharded, plain = ([v] if not isinstance(v, list) else v for v in (sharded, plain))
    for a, b in zip(sharded, plain):
        assert (a.status, a.iter, a.objective) == (b.status, b.iter, b.objective)
        for field in ("solution", "multipliers", "multipliers_L", "multipliers_U",
                      "constraints"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), field


def test_resolve_and_the_collectives(port):
    with pytest.raises(TypeError, match="DeviceMesh"):
        mesh.resolve(object(), "batch", "cpu")
    for r, res in enumerate(port()):
        res = res["resolve"]
        assert len(res["errors"]) == 2
        assert "no dimension named 'nope'" in res["errors"][0]
        assert "disagrees with the mesh" in res["errors"][1]
        assert (res["rank"], res["world"], res["device"]) == (r, WORLD, "cpu")
        assert res["gather"] == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
        assert res["sum"] == [3.0, 1.0]
        assert res["all_true"] is False
        assert res["objects"] == [0, "r0", 1, "r1"]
