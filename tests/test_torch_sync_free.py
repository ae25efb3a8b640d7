"""The sparse direction without host reads, on the CPU.

* `solver/sparse_common.py::segment_sum` calls `torch.segment_reduce` with
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
"""

import collections

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import madqp_tpu_torch as mt
from madqp_tpu_torch.ops import sparse_chol as SC
from madqp_tpu_torch.solver import mpc
from madqp_tpu_torch.solver import sparse_common as C
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


def _cpu_solve(qp):
    P.enable()
    try:
        solver = mt.MPCSolver(qp, device="cpu", kkt_system="sparse-augmented", print_level=40)
        before = collections.Counter(solver.kernel.directions)
        stats = solver.solve()
    finally:
        P.disable()
    routes = [s.value for s in P.drain() if s.name == "iter.direction"]
    return stats, solver.kernel.directions - before, routes


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
    """The class attribute that lets `MPCKernel` replay a direction: the
    sparse augmented KKT's, and no other KKT's."""
    from madqp_tpu_torch.ops import kkt as dense
    from madqp_tpu_torch.solver.sparse_condensed import DeviceSparseCondensedKKT
    from madqp_tpu_torch.solver.sparse_lp import DeviceSparseNormalKKT

    assert DeviceSparseAugmentedKKT.capturable_direction is True
    for cls in (DeviceSparseNormalKKT, DeviceSparseCondensedKKT, dense.DenseCondensedKKT,
                dense.DenseNormalKKT, dense.DenseK2KKT, dense.DenseK25KKT):
        assert not getattr(cls, "capturable_direction", False), cls


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
