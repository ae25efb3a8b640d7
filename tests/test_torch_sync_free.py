"""The sparse direction without host reads, on the CPU.

* `ops/segment.py::segment_sum` calls `torch.segment_reduce` with
  `unsafe=True`: bit for bit the checked call, over lanes, empty segments
  and a given order.  The check it skips is made once where the index
  lists are built (`lengths_tensor`), and each call compares the values'
  count with the lengths' host-kept total.
* `ops/sparse_chol.py::_forward` / `_backward` clear the sentinel x[..., n]
  with a fill on the device: the solves' bits are those of the scalar
  store they replace.
* `solver/mpc.py::MPCKernel` replays the direction as a CUDA graph only on
  a card: on the CPU every direction is eager, counted and traced as such,
  and the iterates are those of a kernel whose KKT declares no
  capturable direction.  The graph's own checks are card tests
  (`tests/test_torch_cuda.py`).
* The factorization trial likewise: `ops/sparse_chol.py::_work` and
  `factorize_batched_ldl` set their unit slots with fills on the device,
  `MPCKernel._scalar` is a fill, each of the same bits as the scalar
  store or host copy it replaces; the trial graph (`mpc.TrialGraph`)
  engages only on a card with a KKT that declares `capturable_factorize`,
  so on the CPU every trial is eager, counted and traced as such.  The
  escalation between trials runs inside the failed trial's
  `iter.factorize` span, and a graph's replays count the kernels' host
  launches (`mpc._launch_counts`) as its eager launches would.
"""

import collections
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import madqp_tpu_torch as mt
from madqp_tpu_torch.ops import sparse_chol as SC
from madqp_tpu_torch.solver import mpc
from madqp_tpu_torch.ops import segment as C
from madqp_tpu_torch.solver.sparse_qp import DeviceSparseAugmentedKKT
from madqp_tpu_torch.utils import profiling as P

# (lanes, segment sizes, with an order): a single instance and a batch,
# with empty segments at the ends and inside, and values already in
# segment order or gathered by `segments`' order.
SEGMENT_CASES = [((), [2, 0, 3, 1], False), ((), [0, 4, 0, 0, 2, 0], True),
                 ((3,), [1, 0, 2, 5], False), ((2, 3), [0, 3, 0, 1], True),
                 ((), [0, 0, 0], False)]


@pytest.mark.parametrize("lanes,sizes,ordered", SEGMENT_CASES,
                         ids=[f"lanes{len(c[0])}-{'order' if c[2] else 'sorted'}-{i}"
                              for i, c in enumerate(SEGMENT_CASES)])
def test_segment_sum_unchecked_is_bit_equal_to_checked(lanes, sizes, ordered):
    rng = np.random.default_rng(len(sizes))
    index = np.repeat(np.arange(len(sizes)), sizes)
    if ordered:
        index = rng.permutation(index)
    order, lengths = C.segments(index, len(sizes))
    values = torch.as_tensor(rng.standard_normal(lanes + (index.size,)))
    got = C.segment_sum(values, C.lengths_tensor(lengths, index.size, "cpu"),
                        torch.as_tensor(order) if ordered else None)
    lt = torch.as_tensor(lengths)
    v = values[..., torch.as_tensor(order)] if ordered else values
    if index.size:
        want = torch.segment_reduce(v, "sum", lengths=lt.expand(lanes + lt.shape), axis=-1)
    else:
        want = torch.zeros(lanes + lt.shape, dtype=values.dtype)
    assert got.shape == lanes + (len(sizes),)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lengths,total", [([2, -1, 3], 4), ([1, 2, 3], 5), ([], 1)],
                         ids=["negative", "short", "empty"])
def test_bad_lengths_raise_where_built(lengths, total):
    with pytest.raises(ValueError, match="segment lengths"):
        C.lengths_tensor(lengths, total, "cpu")


def test_index_lists_carry_checked_totals():
    """Every lengths tensor the sparse paths build holds its total: the
    schedule's assembly and sweep sums, and the problem's row and column
    sums."""
    K, _ = _quasidefinite()
    bs = SC.analyze_batched(K, order="amd", schedule_mode="level")
    ds = SC.device_schedule(bs, "cpu")
    for steps in ds.items:
        for st in steps:
            assert st.seg_len.segment_total == st.src.numel() == int(st.seg_len.sum())
            assert st.b_len.segment_total == st.b_order.numel() == int(st.b_len.sum())
    qp = mt.random_qp(30, 12, seed=2)
    solver = mt.MPCSolver(qp, device="cpu", kkt_system="sparse-augmented", print_level=40)
    p = solver.prob
    for order, lens in ((p.a_row_order, p.a_row_len), (p.a_col_order, p.a_col_len),
                        (p.h_row_order, p.h_row_len), (p.h_col_order, p.h_col_len)):
        assert lens.segment_total == order.numel() == int(lens.sum())


@pytest.mark.parametrize("case", ["plain", "foreign", "mismatched"])
def test_segment_sum_checks_each_call_on_the_host(case):
    """Lengths without a host-kept total (not built by `lengths_tensor`),
    or values whose count is not that total, raise before any kernel."""
    lengths = C.lengths_tensor([2, 1], 3, "cpu")
    values = torch.ones(3, dtype=torch.float64)
    if case == "plain":
        assert torch.equal(C.segment_sum(values, lengths), torch.tensor([2.0, 1.0],
                                                                       dtype=torch.float64))
        return
    if case == "foreign":
        lengths = torch.tensor([2, 1])
    else:
        values = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="segment_sum"):
        C.segment_sum(values, lengths)


def _quasidefinite(n=240, m=120, seed=1):
    """A quasi-definite K = [W A'; A -1e-4 I] whose level schedule has
    chains beside buckets and scans (tests/test_torch_sparse_chol.py)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 3)
    cols = np.minimum(2 * rows + np.tile(np.arange(3), m), n - 1)
    A = sp.coo_matrix((rng.uniform(0.5, 2.0, rows.size), (rows, cols)), shape=(m, n)).tocsc()
    A.sum_duplicates()
    W = sp.diags(rng.uniform(0.5, 2.0, n))
    K = sp.bmat([[W, A.T], [A, -1e-4 * sp.eye(m)]], format="csc")
    return K, np.concatenate([np.ones(n), -np.ones(m)])


def _forward_stored(x, st, P, n, unit, inverse):
    """`sparse_chol._forward` as it was, the sentinel cleared by a scalar
    store (a host-to-device copy on a card)."""
    w = st.w_pad
    lanes = x.shape[:-1]
    P = P.reshape((-1,) + P.shape[-2:])
    xc = x[..., st.cols].reshape(-1, w)
    if inverse:
        xj = (P[:, :w, :] @ xc[..., None])[..., 0]
    else:
        xj = torch.linalg.solve_triangular(P[:, :w, :], xc[..., None], upper=False,
                                           unitriangular=unit)[..., 0]
    x[..., st.cols.reshape(-1)] = xj.reshape(lanes + (-1,))
    if st.u_pad:
        y = (P[:, w:, :] @ xj[..., None])[..., 0].reshape(lanes + (-1,))
        x[..., st.b_uniq] = x[..., st.b_uniq] - C.segment_sum(y[..., st.b_order], st.b_len)
    x[..., n] = 0.0


def _backward_stored(x, st, P, n, unit, inverse):
    """`sparse_chol._backward` as it was (see `_forward_stored`)."""
    w = st.w_pad
    lanes = x.shape[:-1]
    P = P.reshape((-1,) + P.shape[-2:])
    rhs = x[..., st.cols].reshape(-1, w)
    if st.u_pad:
        below = x[..., st.below].reshape(-1, st.u_pad)
        rhs = rhs - (P[:, w:, :].mT @ below[..., None])[..., 0]
    if inverse:
        xj = (P[:, :w, :].mT @ rhs[..., None])[..., 0]
    else:
        xj = torch.linalg.solve_triangular(P[:, :w, :].mT, rhs[..., None], upper=True,
                                           unitriangular=unit)[..., 0]
    x[..., st.cols.reshape(-1)] = xj.reshape(lanes + (-1,))
    x[..., n] = 0.0


@pytest.mark.parametrize("lanes", [(), (2,)], ids=["single", "lanes"])
@pytest.mark.parametrize("inverse", [False, True], ids=["trsv", "inverse"])
def test_sentinel_fill_keeps_the_solve_bits(lanes, inverse, monkeypatch):
    """Buckets, scans and a level schedule's chains, one instance or two
    lanes: the solves with the fill equal those with the store, bit for
    bit, and solve K x = b."""
    K, sg = _quasidefinite()
    bs = SC.analyze_batched(K, order="amd", schedule_mode="level")
    assert any(isinstance(it, SC._Chain) for it in bs.schedule)
    rng = np.random.default_rng(3)
    vals = torch.as_tensor(bs.permute_values(K))
    vals = vals.expand(lanes + vals.shape).contiguous()
    f = SC.factorize_batched_ldl(bs, vals, signs=SC.bucket_signs(bs, sg), pivot_floor=1e-10,
                                 inverse=inverse)
    b = torch.as_tensor(rng.standard_normal(lanes + (K.shape[0],)))
    got = SC.solve_batched_ldl(bs, f, b, inverse=inverse)
    monkeypatch.setattr(SC, "_forward", _forward_stored)
    monkeypatch.setattr(SC, "_backward", _backward_stored)
    want = SC.solve_batched_ldl(bs, f, b, inverse=inverse)
    assert torch.equal(got, want)
    r = K @ got.reshape(-1, K.shape[0]).numpy().T - b.reshape(-1, K.shape[0]).numpy().T
    assert np.abs(r).max() < 1e-6


def _cpu_solve(qp, step="direction", kkt_system="sparse-augmented"):
    """A traced solve on the CPU: its stats, the kernel's routes of `step`
    ("direction" or "factorize") in this solve, and the values of its
    `iter.<step>` spans."""
    counter = "directions" if step == "direction" else "factorizations"
    P.enable()
    try:
        solver = mt.MPCSolver(qp, device="cpu", kkt_system=kkt_system, print_level=40)
        before = collections.Counter(getattr(solver.kernel, counter))
        stats = solver.solve()
    finally:
        P.disable()
    routes = [s.value for s in P.drain() if s.name == f"iter.{step}"]
    return stats, getattr(solver.kernel, counter) - before, routes


def test_cpu_directions_are_eager_and_iterates_unchanged(monkeypatch):
    """On the CPU the graph never engages: every direction (the starting
    point's and one per iteration) is eager in the counter and in the
    span's value, and the solve is bit for bit that of a KKT that does not
    declare its direction capturable."""
    qp = mt.random_qp(40, 20, seed=3)
    got, counts, routes = _cpu_solve(qp)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    assert counts == collections.Counter(eager=got.iter + 1)
    assert routes == ["eager"] * (got.iter + 1)
    monkeypatch.setattr(DeviceSparseAugmentedKKT, "capturable_direction", False)
    want, _, _ = _cpu_solve(qp)
    assert got.iter == want.iter
    for a, b in [(got.objective, want.objective), (got.solution, want.solution),
                 (got.multipliers, want.multipliers), (got.multipliers_L, want.multipliers_L)]:
        np.testing.assert_array_equal(a, b)


def test_only_the_sparse_augmented_kkt_is_capturable():
    """The class attributes that let `MPCKernel` replay a direction and a
    factorization trial: the sparse augmented KKT's, and no other KKT's."""
    from madqp_tpu_torch.ops import kkt as dense
    from madqp_tpu_torch.parallel.structured import SchurKKT
    from madqp_tpu_torch.solver.sparse_condensed import DeviceSparseCondensedKKT
    from madqp_tpu_torch.solver.sparse_lp import DeviceSparseNormalKKT

    for attr in ("capturable_direction", "capturable_factorize"):
        assert getattr(DeviceSparseAugmentedKKT, attr) is True
        for cls in (DeviceSparseNormalKKT, DeviceSparseCondensedKKT, SchurKKT,
                    dense.DenseCondensedKKT, dense.DenseNormalKKT, dense.DenseK2KKT,
                    dense.DenseK25KKT):
            assert not getattr(cls, attr, False), (cls, attr)


def test_graph_signature_and_slots():
    """What makes a captured direction graph stale (`_signature`): a
    tensor's shape, strides, dtype or segment total, or any other leaf;
    not the values.  A slot is a copy that keeps the segment total."""
    lens = C.lengths_tensor([1, 2], 3, "cpu")
    x = torch.arange(6, dtype=torch.float64)
    tree = (x, [lens, None], 1.5)
    assert mpc._leaves(tree) == [x, lens, None, 1.5]
    base = mpc._signature(mpc._leaves(tree))
    slot = mpc._slot(lens)
    assert slot is not lens and torch.equal(slot, lens) and slot.segment_total == 3
    for same in [(x * 2, [slot, None], 1.5),
                 (x, [C.lengths_tensor([3, 0], 3, "cpu"), None], 1.5)]:
        assert mpc._signature(mpc._leaves(same)) == base
    for other in [(x[:5], [lens, None], 1.5), (x.float(), [lens, None], 1.5),
                  (torch.arange(12, dtype=torch.float64)[::2], [lens, None], 1.5),
                  (x, [C.lengths_tensor([1, 3], 4, "cpu"), None], 1.5),
                  (x, [lens.clone(), None], 1.5), (x, [lens, None], 2.5)]:
        assert mpc._signature(mpc._leaves(other)) != base


def _work_stored(ds, a_values):
    """`sparse_chol._work` as it was, the unit slot set by a scalar store (a
    host-to-device copy on a card)."""
    w = a_values.new_zeros(a_values.shape[:-1] + (ds.size,))
    w[..., :ds.n_a] = a_values
    w[..., ds.one] = 1.0
    return w


def _factorize_ldl_stored(bs, a_values, signs=None, pivot_floor=0.0, inverse=False):
    """`sparse_chol.factorize_batched_ldl` as it was (see `_work_stored`)."""
    panels, dvecs = SC._factorize(bs, a_values, inverse, ldl=True, signs=signs,
                                  pivot_floor=pivot_floor)
    ds = SC.device_schedule(bs, a_values.device)
    lanes = a_values.shape[:-1]
    dglob = a_values.new_ones(lanes + (bs.n + 1,))
    for steps, d in zip(ds.items, dvecs):
        cols = torch.cat([st.cols.reshape(-1) for st in steps])
        dglob[..., cols] = d.reshape(lanes + (-1,))
    dglob[..., bs.n] = 1.0
    return panels, dvecs, dglob


@pytest.mark.parametrize("lanes", [(), (2,)], ids=["single", "lanes"])
@pytest.mark.parametrize("floor", [0.0, 1e-10], ids=["plain", "floored"])
def test_factorization_fills_keep_the_store_bits(lanes, floor, monkeypatch):
    """Buckets, scans and chains, one instance or two lanes: the working
    vector with the fill equals the one with the store, and so do the
    factorization's panels, pivot vectors and global pivots (its unit slot
    a fill too), bit for bit."""
    K, sg = _quasidefinite()
    bs = SC.analyze_batched(K, order="amd", schedule_mode="level")
    ds = SC.device_schedule(bs, "cpu")
    vals = torch.as_tensor(bs.permute_values(K))
    vals = vals.expand(lanes + vals.shape).contiguous() * (1.0 + torch.arange(
        int(np.prod(lanes, dtype=int)), dtype=vals.dtype).reshape(lanes + (1,)))
    work = SC._work(ds, vals)
    assert torch.equal(work, _work_stored(ds, vals))
    assert bool((work[..., ds.one] == 1.0).all())
    signs = SC.bucket_signs(bs, sg)
    got = SC.factorize_batched_ldl(bs, vals, signs=signs, pivot_floor=floor)
    monkeypatch.setattr(SC, "_work", _work_stored)
    want = _factorize_ldl_stored(bs, vals, signs=signs, pivot_floor=floor)
    for g, w in zip(mpc._leaves(got), mpc._leaves(want)):
        assert g.shape == w.shape and torch.equal(g, w)
    assert bool((got[2][..., bs.n] == 1.0).all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_scalar_is_a_fill_of_the_stored_bits(dtype):
    """`MPCKernel._scalar` gives `torch.tensor`'s dtype, shape and bits for
    every value the kernel makes one of (the regularization's, the
    barrier's, 0, 1, inf)."""
    opts, _ = mt.utils.load_options(dtype=dtype)
    kernel = mpc.MPCKernel(opts, kkt=object())
    p = types.SimpleNamespace(c=torch.zeros(3, dtype=getattr(torch, dtype)))
    for value in (0.0, 1.0, -0.0, 1e-8, -1e-9, 0.1, 1e-300, float("inf")):
        got = kernel._scalar(p, value)
        want = torch.tensor(value, dtype=getattr(torch, dtype))
        assert got.dtype == want.dtype and got.shape == want.shape == ()
        assert got.device == p.c.device
        assert torch.equal(got, want) and torch.signbit(got) == torch.signbit(want)


@pytest.mark.parametrize("kkt_system", ["sparse-augmented", "k2"])
def test_cpu_trials_are_eager_and_iterates_unchanged(kkt_system, monkeypatch):
    """On the CPU the trial graph never engages, with a KKT that declares
    its factorization capturable (the sparse augmented one) or not (the
    dense K2): every trial is eager in the counter and in the span's value,
    at least one a call, and the sparse solve is bit for bit that of a KKT
    that does not declare it."""
    qp = mt.random_qp(40, 20, seed=4)
    got, counts, routes = _cpu_solve(qp, "factorize", kkt_system)
    assert got.status == mt.Status.SOLVE_SUCCEEDED
    assert routes == ["eager"] * len(routes) and len(routes) >= got.iter + 1
    assert counts == collections.Counter(eager=len(routes))
    if kkt_system != "sparse-augmented":
        return
    monkeypatch.setattr(DeviceSparseAugmentedKKT, "capturable_factorize", False)
    want, want_counts, _ = _cpu_solve(qp, "factorize", kkt_system)
    assert got.iter == want.iter and counts == want_counts
    for a, b in [(got.objective, want.objective), (got.solution, want.solution),
                 (got.multipliers, want.multipliers), (got.multipliers_L, want.multipliers_L)]:
        np.testing.assert_array_equal(a, b)


def test_trial_graph_engages_on_a_card_with_a_capturable_kkt():
    """`MPCKernel._trial_graph`: one `TrialGraph` per kernel for a tensor on
    a card (an object that says `is_cuda`) and a KKT that declares
    `capturable_factorize`; None for a CPU tensor, or a KKT without it."""
    from madqp_tpu_torch.ops import kkt as dense

    on_card = types.SimpleNamespace(is_cuda=True)
    solver = mt.MPCSolver(mt.random_qp(30, 12, seed=2), device="cpu",
                          kkt_system="sparse-augmented", print_level=40)
    kernel = solver.kernel
    graph = kernel._trial_graph(on_card)
    assert isinstance(graph, mpc.TrialGraph) and kernel._trial_graph(on_card) is graph
    assert kernel._trial_graph(solver.prob.c) is None
    dense_kernel = mpc.MPCKernel(kernel.opts, kkt=dense.DenseK2KKT())
    assert dense_kernel._trial_graph(on_card) is None


def test_trial_graph_signature():
    """What makes a captured trial stale (`TrialGraph.route`): a shape,
    dtype or device of the problem, the iterate or the regularization;
    not their values, and not the escalation between trials."""
    solver = mt.MPCSolver(mt.random_qp(30, 12, seed=2), device="cpu",
                          kkt_system="sparse-augmented", print_level=40)
    kernel, p = solver.kernel, solver.prob
    st = kernel.init_state(p, solver._x0, solver._y0, solver._lb0, solver._ub0)
    dw, dc = st.del_w, st.del_c
    args = (p, st.x, st.lb, st.ub, st.zl, st.zu, dw, dc)
    graph = mpc.TrialGraph(kernel)
    assert graph.route(*args) == "capture"
    graph.signature = mpc._signature(mpc._leaves(graph._inputs(*args)))
    assert graph.route(*args) == "replay"

    def swap(i, v):
        return args[:i] + (v,) + args[i + 1:]

    escalated = torch.where(dc != 0.0, dc * 100.0, -1e-8)
    assert escalated.item() != dc.item()
    for same in [swap(1, st.x * 2), swap(6, dw * 100.0), swap(7, escalated),
                 swap(0, p._replace(a_vals=p.a_vals * 3)), swap(4, st.zl + 1.0)]:
        assert graph.route(*same) == "replay"
    for other in [swap(1, st.x[:-1]), swap(1, st.x.float()), swap(1, st.x.to("meta")),
                  swap(6, dw.float()), swap(7, dc.to("meta")), swap(6, dw[None]),
                  swap(0, p._replace(a_vals=p.a_vals[:-1])),
                  swap(2, torch.stack([st.lb, st.lb], -1)[:, 0])]:
        assert graph.route(*other) == "capture"


def _cpu_trial_args(seed=2):
    solver = mt.MPCSolver(mt.random_qp(30, 12, seed=seed), device="cpu",
                          kkt_system="sparse-augmented", print_level=40)
    kernel, p = solver.kernel, solver.prob
    st = kernel.init_state(p, solver._x0, solver._y0, solver._lb0, solver._ub0)
    return kernel, (p, st.x, st.lb, st.ub, st.zl, st.zu, st.del_w, st.del_c)


@pytest.mark.parametrize("passes_at", [0, 1, 2, None], ids=["first", "second", "third", "none"])
def test_escalation_inside_the_failed_trials_span(passes_at, monkeypatch):
    """`factorize_with_retry` with the KKT's `factor_ok` saying False until
    trial `passes_at` (or always): one `iter.factorize` span and count per trial,
    every escalation inside the span of the trial that failed (none after
    the last), and the returned regularization that of the last trial."""
    kernel, args = _cpu_trial_args()
    trials, escalated_in = [], []

    def fails_until(f):
        trials.append(len(trials))
        return torch.tensor(passes_at is not None and trials[-1] >= passes_at)

    def recorded(dw, dc):
        rec = P._REC
        escalated_in.append((rec.rows[rec.stack[-1]][0], len(trials)) if rec.stack else None)
        return escalate(dw, dc)

    escalate = mpc._escalate
    monkeypatch.setattr(kernel.kkt, "factor_ok", fails_until)
    monkeypatch.setattr(mpc, "_escalate", recorded)
    counted = collections.Counter(kernel.factorizations)   # the kernel is cached
    P.enable()
    try:
        f, dw, dc, ok = kernel.factorize_with_retry(*args)
    finally:
        P.disable()
    spans = [s for s in P.drain() if s.name == "iter.factorize"]
    n = 3 if passes_at is None else passes_at + 1
    assert ok is (passes_at is not None) and len(trials) == len(spans) == n
    assert [s.value for s in spans] == ["eager"] * n
    assert kernel.factorizations - counted == collections.Counter(eager=n)
    assert escalated_in == [("iter.factorize", k + 1) for k in range(n - 1)]
    want_w, want_c = args[-2], args[-1]
    for _ in range(n - 1):
        want_w, want_c = escalate(want_w, want_c)
    assert torch.equal(dw, want_w) and torch.equal(dc, want_c)


def test_launch_counts_taken_back_and_added_in_place(monkeypatch):
    """The helpers behind a graph's launch counts (`mpc._launch_counts`,
    `_launches_since`, `_set_launch_counts`, `_add_launches`): K1's
    launches and launches by route, K2-batched's and K8's launches read,
    differenced, put back in place (the same `routes` dict, which callers
    keep and clear) and added again."""
    k1, k2, k8 = mpc._launch_counters()
    routes = {"cta": 2}
    monkeypatch.setattr(k1, "launches", 5)
    monkeypatch.setattr(k1, "routes", routes)
    monkeypatch.setattr(k2, "launches", 7)
    monkeypatch.setattr(k8, "launches", 0)
    before = mpc._launch_counts()
    assert before == [(5, {"cta": 2}), (7, {}), (0, {})]
    k1.launches, k2.launches = 8, 18
    routes.update(cta=4, warp16=1)
    added = mpc._launches_since(before)
    assert added == [(3, {"cta": 2, "warp16": 1}), (11, {}), (0, {})]
    mpc._set_launch_counts(before)
    assert k1.routes is routes and mpc._launch_counts() == before
    for _ in range(2):
        mpc._add_launches(added)
    assert k1.routes is routes
    assert mpc._launch_counts() == [(11, {"cta": 6, "warp16": 2}), (29, {}), (0, {})]
