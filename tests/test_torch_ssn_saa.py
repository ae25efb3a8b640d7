"""The SSN-shaped SAA deployment of the benchmark cell `ssn_saa.replications`
on the CPU: the generator (`qpbench/generators/ssn_saa.py`), the port's
`solve_two_stage` on its blocks against the benchmark's plain reference
(`qpbench/reference/ssn_saa.py`) and against the JAX package,
`build_two_stage` on tensors, and the Schur path's spans.

Sizes: SSN's own widths (89 links, 86 pairs, 620 routes) with N = 4
scenarios where the port meets the reference, and a small network of the
same form (12 links, 6 pairs, 20 routes) where the JAX package compiles
its solve."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import madqp_tpu_torch as mt
from madqp_tpu.parallel import structured as JS
from madqp_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from qpbench import compare, control, harness  # noqa: E402
from qpbench.generators import ssn_saa as gen  # noqa: E402
from qpbench.reference import ssn_saa as reference  # noqa: E402

CELL = harness.load_json("workloads", "ssn_saa.replications.json")
SEED = 2 ** 31 + 19


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one process per core under xdist,
    and torch's threads spinning against the other workers' slow these
    many small solves a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(small=False, scenarios=4):
    """The cell's configuration with `scenarios` scenarios; `small`: a
    network of 12 links, 6 pairs and 20 routes on 8 nodes, its budget cut
    so that demand still goes unserved."""
    cfg = harness.load_json("configs", "ssn_saa.json")
    cfg["scenarios"] = scenarios
    if small:
        cfg.update(links=12, pairs=6, routes=20)
        cfg["assumed"].update(nodes=8, budget=20)
    return cfg


def numpy_blocks(cfg, seed=SEED):
    """build_two_stage's arguments as NumPy arrays: the fixed blocks
    repeated over the scenarios, one replication's demands."""
    net = gen.network(cfg)
    n = cfg["scenarios"]
    b = gen.blocks(net, n)
    d = gen.draw_demands(net, n, np.random.default_rng(seed))
    b_s = np.concatenate([np.tile(net.capacity, (n, 1)), d], 1)

    def tile(a):
        return np.ascontiguousarray(np.broadcast_to(a, (n,) + a.shape))

    return (b["c0"], b["A0"], b["b0"], b["lb0"], b["ub0"], tile(b["c_s"]), tile(b["T"]),
            tile(b["W"]), b_s, tile(b["lb_s"]), tile(b["ub_s"]))


def test_published_sizes_in_equality_form():
    cfg = config(scenarios=1)
    pool, _ = gen.make_pool(cfg, {"replications": 1}, SEED)
    blocks = pool[0][0].blocks
    _, ms, ns = blocks["W_s"].shape
    m0, n0 = blocks["A0"].shape
    assert {"n0": n0, "m0": m0, "ns": ns, "ms": ms} == cfg["equality_form"]
    published = cfg["published"]
    assert n0 - 1 == published["first_stage"]["columns"] and m0 == published["first_stage"]["rows"]
    assert ns - cfg["links"] == published["second_stage"]["columns"]
    assert ms == published["second_stage"]["rows"] and cfg["reduced"] == []


def test_generator_fixed_recourse_and_complete():
    """A small network at N = 4: W and T the same in every scenario and in
    every replication (one stack on the device), only b differs; the flat
    record is the blocks' matrix; f = 0, u = d, v = cap is feasible in
    every scenario with x = 0 and the budget unspent."""
    cfg = config(small=True)
    pool, start = gen.make_pool(cfg, {"replications": 2}, SEED)
    assert start == SEED % 2
    (a,), (b,) = pool
    W, T = a.blocks["W_s"], a.blocks["T_s"]
    assert W.shape == (4, 18, 38) and T.shape == (4, 18, 13) and a.blocks["A0"].shape == (1, 13)
    assert b.blocks["W_s"] is W and b.blocks["T_s"] is T
    assert all(torch.equal(W[i], W[0]) and torch.equal(T[i], T[0]) for i in range(4))
    assert torch.equal(T[0, :12, :12], -torch.eye(12, dtype=torch.float64))
    assert not np.array_equal(a.b, b.b) and np.array_equal(a.c, b.c) and a.A is b.A

    rng = np.random.default_rng(1)
    x = rng.standard_normal(a.n)
    xs = torch.from_numpy(x[13:].reshape(4, 38))
    ys = T @ torch.from_numpy(x[:13]) + (W @ xs[..., None])[..., 0]
    want = np.concatenate([a.blocks["A0"].numpy() @ x[:13], ys.reshape(-1).numpy()])
    np.testing.assert_allclose(a.A @ x, want, rtol=0, atol=1e-12)

    for inst in (a, b):
        net_cap = inst.blocks["b_s"][:, :12].numpy()
        demand = inst.blocks["b_s"][:, 12:].numpy()
        x0 = np.concatenate([np.zeros(12), inst.blocks["b0"].numpy()])
        xs = np.concatenate([np.zeros((4, 20)), demand, net_cap], 1)
        point = np.concatenate([x0, xs.ravel()])
        np.testing.assert_array_equal(inst.A @ point, inst.b)
        assert np.all(inst.lvar <= point) and np.all(point < inst.uvar)


def test_port_against_the_plain_reference():
    """SSN's widths at N = 4 through the cell's entry and the cell's
    checks: the port converges, the reference converges (`judge` raises
    otherwise), the objectives agree to 1e-7 relative (the reference stops
    on its largest complementarity product under 1e-10 of |f|, which leaves
    its objective ~2e-8 off at this size), every check holds; the
    reference in float32 in the port's place fails one."""
    cfg = config()
    pool, _ = gen.make_pool(cfg, {"replications": 1}, SEED)
    entry = harness.find("entries", CELL["entry"])
    stats, _ = entry.call(entry.prepare(pool[0]), cfg["options"], "cpu")
    (ans,) = entry.answers(stats)
    assert ans.status == "SOLVE_SUCCEEDED"

    check = CELL["check"]
    got = compare.judge(pool, [(0, 0, ans)], check, reference, np.random.default_rng(0))
    assert all(c["value"] <= c["limit"] for c in got.values()), got
    assert got["obj_gap"]["value"] <= 1e-7 and abs(ans.objective) > 1.0

    ctl = control.ControlEntry(reference)
    (low,) = ctl.answers(ctl.call(pool[0], cfg["options"], "cpu")[0])
    got = compare.judge(pool, [(0, 0, low)], check, reference, np.random.default_rng(0))
    assert any(c["value"] > c["limit"] for c in got.values()), got


def test_port_against_jax():
    """The same NumPy blocks through both packages' `build_two_stage` and
    `solve_two_stage` (pallas, float64).  The LP's optimal set is not a
    point (routes of equal cost carry the flow interchangeably), so in the
    last iterations the two packages' roundings reach different points of
    it: the iterates are held to each other over the first 8 iterations,
    and the whole solve by its status, its iterations (within 1) and its
    objective."""
    args = numpy_blocks(config(small=True))
    jp, jlb, jub = JS.build_two_stage(*args)
    tp, tlb, tub = mt.build_two_stage(*args, device="cpu")
    opts = dict(print_level=40, tol=1e-8, linear_solver="pallas")
    for max_iter in (8, None):
        run = opts if max_iter is None else {**opts, "max_iter": max_iter}
        want = JS.solve_two_stage(jp, jlb, jub, **run)
        got = mt.solve_two_stage(tp, tlb, tub, device="cpu", **run)
        assert int(got.status) == int(want.status)
        if max_iter is None:
            assert int(got.status) == int(mt.Status.SOLVE_SUCCEEDED)
            assert abs(got.iter - want.iter) <= 1
            assert got.objective == pytest.approx(want.objective, rel=1e-8)
            continue
        assert got.iter == want.iter == max_iter
        for field in ("solution", "multipliers", "multipliers_L", "multipliers_U",
                      "constraints"):
            w = np.asarray(getattr(want, field))
            np.testing.assert_allclose(getattr(got, field), w, rtol=0,
                                       atol=1e-10 * max(1.0, np.abs(w).max()), err_msg=field)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_build_two_stage_from_tensors_bit_equal(dtype):
    """CPU tensors give the problem the same blocks in NumPy give, bit for
    bit; a tensor already in place is kept, not copied."""
    args = numpy_blocks(config(small=True))
    want = mt.build_two_stage(*args, dtype=dtype, device="cpu")
    tensors = [torch.from_numpy(np.array(a)) for a in args]
    got = mt.build_two_stage(*tensors, dtype=dtype, device="cpu")
    for field in got[0]._fields:
        g, w = getattr(got[0], field), getattr(want[0], field)
        assert (g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w)), field
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if dtype == "float64":
        assert got[0].W_s.data_ptr() == tensors[7].data_ptr()
        assert got[0].T_s.data_ptr() == tensors[6].data_ptr()


def test_schur_spans():
    """With the recorder on, a small two-stage solve records `solve`, a
    `schur.scenarios` span per factorization trial with `schur.factor_S`
    inside it, `schur.first`, `schur.solve` and the final reads
    `sync.finish`; off, nothing."""
    prob, lb, ub = mt.random_two_stage(n0=6, ns=5, ms=3, m0=2, N=8, seed=1, qp=False,
                                       device="cpu")
    profiling.drain()
    profiling.enable()
    try:
        stats = mt.solve_two_stage(prob, lb, ub, device="cpu", print_level=40)
    finally:
        profiling.disable()
    spans = profiling.drain()
    names = [s.name for s in spans]
    assert stats.success and names.count("solve") == 1
    trials = names.count("iter.factorize")
    assert trials >= stats.counters.factorizations > 0
    assert names.count("schur.scenarios") == names.count("schur.factor_S") == trials
    assert names.count("schur.first") == trials and names.count("schur.solve") > 0
    assert names.count("sync.finish") == 9
    for s in spans:
        parent = spans[s.parent].name if s.parent >= 0 else None
        if s.name == "schur.factor_S":
            assert parent == "schur.scenarios"
        if s.name in ("schur.scenarios", "schur.first"):
            assert parent == "iter.factorize"
        if s.name == "sync.finish":
            assert parent == "solve"

    mt.solve_two_stage(prob, lb, ub, device="cpu", print_level=40)
    assert profiling.drain() == []
