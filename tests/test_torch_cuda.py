"""Tests that need a CUDA card: the K1 and K8 kernels against their plain
versions, and the port's solves on the card against the same solves on the
CPU.

They skip without a card.  This file imports no JAX (the card's machine has
none); run it there without the repository's conftest, which imports JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import madqp_tpu_torch as mt
from madqp_tpu_torch.ops import blocked_dense
from madqp_tpu_torch.ops import pallas_chol as K1
from madqp_tpu_torch.ops import syrk as K8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def spd(n, seed):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, n))
    return P @ P.T / n + np.eye(n)


def diag_ok(L):
    d = torch.diagonal(L)
    return bool((torch.isfinite(d) & (d > 0)).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 129, 200, 600, 1000,
                               2500])
def test_kernel_matches_plain(cuda, n, dtype, tol):
    """Factor error relative to max|L| within the smoke's tolerances; zero
    strict upper triangle; one launch counted per call."""
    A = torch.as_tensor(spd(n, seed=n), dtype=dtype, device=cuda)
    before = K1.cholesky_lower.launches
    L = K1.cholesky_lower(A)
    torch.cuda.synchronize()
    assert K1.cholesky_lower.launches == before + 1
    Lp = K1.cholesky_lower_reference(A)
    assert float((L - Lp).abs().max()) <= tol * float(Lp.abs().max())
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 37, 65, 200, 600])
def test_kernel_non_spd_contract(cuda, n, dtype):
    """A negative pivot gives NaN on the diagonal at the same places as the
    plain version (no early exit), so factor_ok fails for both."""
    B = torch.as_tensor(spd(n, seed=n), dtype=dtype, device=cuda)
    B[n // 2, n // 2] = -1.0
    Lb, Lbp = K1.cholesky_lower(B), K1.cholesky_lower_reference(B)
    assert diag_ok(Lb) is diag_ok(Lbp) is False
    assert torch.equal(torch.isnan(torch.diagonal(Lb)),
                       torch.isnan(torch.diagonal(Lbp)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [300, 2500])
def test_kernel_is_deterministic(cuda, n, dtype):
    A = torch.as_tensor(spd(n, seed=3), dtype=dtype, device=cuda)
    assert torch.equal(K1.cholesky_lower(A), K1.cholesky_lower(A))


@pytest.mark.parametrize("dname", ["float64", "float32"])
@pytest.mark.parametrize("batch,n", [
    (0, 16), (0, 65), (0, 128), (0, 600),            # one matrix: "single"
    (64, 8), (64, 16), (64, 31), (64, 33), (64, 64),  # registers, a warp
    (64, 65), (1024, 96), (1024, 48), (8, 20), (8, 12), (16, "max"), (3, "max+1"),
    (1024, 175)])                                     # SSN's S: lane axis in f64
def test_each_route_matches_its_own_plain_version(cuda, batch, n, dname):
    """Each route's factor within ROUTE_TOL (PERF.md §6) of the plain
    version that follows its kernel (ROUTE_REFERENCE), relative to each
    matrix's max|L|; the NaN of a non-SPD matrix at the same
    diagonal places."""
    dtype = getattr(torch, dname)
    n = batched_order(n, dtype)
    if batch:
        A = torch.as_tensor(spd_stack(batch, n, seed=n), dtype=dtype, device=cuda)
        route = K1.batched_route(n, K1.batched_max_n(dtype, cuda))
    else:
        A = torch.as_tensor(spd(n, seed=n), dtype=dtype, device=cuda)
        route = "single"
    before = K1.cholesky_lower.routes.get(route, 0)
    L = K1.cholesky_lower(A)
    assert K1.cholesky_lower.routes[route] == before + 1
    Lp = K1.ROUTE_REFERENCE[route](A)
    err = (L - Lp).abs().amax(dim=(-2, -1)) / Lp.abs().amax(dim=(-2, -1))
    assert float(err.max()) <= K1.ROUTE_TOL[route][dname], (route, float(err.max()))
    B = A.clone()
    B[..., n // 2, n // 2] = -1.0
    assert torch.equal(torch.isnan(torch.diagonal(K1.cholesky_lower(B), dim1=-2, dim2=-1)),
                       torch.isnan(torch.diagonal(K1.ROUTE_REFERENCE[route](B),
                                                  dim1=-2, dim2=-1)))


def test_kernel_rejects_non_contiguous(cuda):
    A = torch.eye(8, dtype=torch.float64, device=cuda)[::2, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        K1.cholesky_lower(A)


def spd_stack(batch, n, seed):
    return np.stack([spd(n, seed=seed + i) for i in range(batch)])


def batched_order(n, dtype):
    """An order, or "max" / "max+1": the largest order the one-CTA kernel
    holds in shared memory on this card, and the first one it does not."""
    if isinstance(n, int):
        return n
    n_max = K1.batched_max_n(dtype, "cuda")
    return n_max + (n == "max+1")


# The edges of every route of batched_route: registers (n <= 8, 16, 32), a
# warp per matrix (n <= 64), a CTA per matrix in 32-column blocks (up to
# n_max), and the persistent kernel with a lane axis above n_max.
BATCHED_EDGES = [(512, 42), (512, 16), (64, 1), (64, 8), (64, 9), (64, 16), (64, 17),
                 (64, 31), (64, 32), (64, 33), (64, 63), (64, 64), (64, 65), (8, 97),
                 (16, "max"), (16, "max+1"), (4, 200), (3, 600), (2, 2500),
                 # a CTA of 4 warps per matrix (fewer waves than 8 warps)
                 (512, 100), (256, 160)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("batch,n", BATCHED_EDGES)
def test_batched_kernel_matches_plain(cuda, batch, n, dtype, tol):
    """Each factor of a stack within the smoke's tolerances of the plain
    version (relative to its max|L|), zero above the diagonal; one launch
    for the whole stack, on the route batched_route names; two runs
    bit-equal."""
    n = batched_order(n, dtype)
    route = K1.batched_route(n, K1.batched_max_n(dtype, cuda))
    A = torch.as_tensor(spd_stack(batch, n, seed=n), dtype=dtype, device=cuda)
    before = K1.cholesky_lower.launches, K1.cholesky_lower.routes.get(route, 0)
    L = K1.cholesky_lower(A)
    torch.cuda.synchronize()
    assert K1.cholesky_lower.launches == before[0] + 1
    assert K1.cholesky_lower.routes[route] == before[1] + 1
    Lp = K1.cholesky_lower_reference(A)
    err = (L - Lp).abs().amax(dim=(1, 2))
    assert bool((err <= tol * Lp.abs().amax(dim=(1, 2))).all())
    assert bool((torch.triu(L, 1) == 0).all())
    assert torch.equal(L, K1.cholesky_lower(A))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batch,n", [(8, 42), (8, 16), (9, 8), (5, 31), (5, 33),
                                     (4, 65), (300, 100), (3, "max+1"), (3, 600)])
def test_batched_kernel_nan_contract_per_lane(cuda, batch, n, dtype):
    """One non-SPD matrix in the stack: NaN on its own diagonal at the
    plain version's places; every other factor equals its factor alone."""
    n = batched_order(n, dtype)
    A = torch.as_tensor(spd_stack(batch, n, seed=1), dtype=dtype, device=cuda)
    bad = batch // 2
    A[bad, n // 2, n // 2] = -1.0
    L, Lp = K1.cholesky_lower(A), K1.cholesky_lower_reference(A)
    for i in range(batch):
        assert diag_ok(L[i]) is (i != bad)
        assert torch.equal(torch.isnan(torch.diagonal(L[i])),
                           torch.isnan(torch.diagonal(Lp[i])))
    good = [i for i in range(batch) if i != bad]
    assert torch.equal(L[good], K1.cholesky_lower(A[good].contiguous()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [65, 600, 2500])
def test_lanes_kernel_one_lane_is_the_single_launch(cuda, n, dtype):
    """The persistent kernel on a stack gives each lane the 2-D call's
    factor of that matrix bit for bit, for a stack of one and of three
    (n_max is below 600; at n = 65 the stack is launched through the
    wrapper's helper directly)."""
    A = torch.as_tensor(spd_stack(3, n, seed=n), dtype=dtype, device=cuda)
    for batch in (1, 3):
        stack = torch.empty((batch, n, n), dtype=dtype, device=cuda)
        with torch.cuda.device(cuda):
            K1._launch_persistent(A[:batch].contiguous(), stack)
        for i in range(batch):
            assert torch.equal(stack[i], K1.cholesky_lower(A[i].contiguous())), (batch, i)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_kernel_ignores_the_upper_triangle(cuda, dtype):
    """NaN planted above the diagonal of every matrix changes no factor,
    on every route."""
    for batch, n in [(6, 8), (6, 16), (6, 31), (6, 32), (6, 42), (4, 97), (2, 300)]:
        A = torch.as_tensor(spd_stack(batch, n, seed=2), dtype=dtype, device=cuda)
        U = A.clone()
        U[:, torch.triu(torch.ones(n, n, dtype=torch.bool, device=cuda), 1)] = float("nan")
        assert torch.equal(K1.cholesky_lower(U), K1.cholesky_lower(A)), (batch, n)


def test_batched_kernel_rejects_non_contiguous(cuda):
    A = torch.eye(8, dtype=torch.float64, device=cuda).expand(4, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        K1.cholesky_lower(A)


@pytest.mark.parametrize("fact", ["", "float32"])
def test_solve_on_card_matches_cpu(cuda, fact):
    """The same solve on the card (K1) and on the CPU (plain version)."""
    kw = dict(print_level=40, linear_solver="pallas", factorization_dtype=fact,
              max_refine_steps=1 if fact else 0)
    qp = mt.random_qp(80, 30, seed=4)
    before = K1.cholesky_lower.launches
    got = mt.solve(qp, device=cuda, **kw)
    launches = K1.cholesky_lower.launches - before
    want = mt.solve(qp, device="cpu", **kw)
    assert got.success and want.success
    assert got.iter == want.iter
    assert got.objective == pytest.approx(want.objective, rel=1e-10 if not fact else 1e-8)
    assert launches >= 2 * got.counters.factorizations


def syrk_inputs(r, c, k, dtype, seed):
    rng = np.random.default_rng(seed)
    C = torch.as_tensor(rng.standard_normal((r, c)), dtype=dtype, device="cuda")
    B = torch.as_tensor(rng.standard_normal((r, k)) / np.sqrt(max(k, 1)),
                        dtype=dtype, device="cuda")
    return C, B


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("r,c,k", [
    (1, 1, 1), (37, 37, 5), (64, 64, 16), (65, 33, 17), (300, 200, 40),
    (96, 96, 0), (1024, 1024, 256), (2304, 2048, 256), (256, 256, 2048),
    # the blocked path's shapes (blocked_dense.panel_update_shapes)
    (3840, 1792, 256), (2304, 256, 256), (2048, 2048, 2048), (1792, 1792, 256),
    (768, 768, 256), (256, 256, 256),
])
def test_syrk_kernel_matches_plain(cuda, r, c, k, dtype, tol):
    """max|out - plain| / max|plain| within the smoke's tolerances; one
    launch counted per call; the inputs are left unchanged."""
    C, B = syrk_inputs(r, c, k, dtype, seed=r + c + k)
    C0, B0 = C.clone(), B.clone()
    before = K8.syrk_update.launches
    out = K8.syrk_update(C, B)
    torch.cuda.synchronize()
    assert K8.syrk_update.launches == before + 1
    plain = K8.syrk_update_reference(C, B)
    assert out.shape == (r, c) and out.dtype == dtype
    assert float((out - plain).abs().max()) <= tol * float(plain.abs().max())
    assert torch.equal(C, C0) and torch.equal(B, B0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r,c,k,row", [(37, 37, 5, 11), (300, 200, 40, 250),
                                       (130, 130, 16, 0)])
def test_syrk_kernel_nan_contract(cuda, r, c, k, row, dtype):
    """A NaN in one row of B reaches that row and (when it is one) that
    column of the output, as in the plain version, and nothing else."""
    C, B = syrk_inputs(r, c, k, dtype, seed=7)
    B[row, k // 2] = float("nan")
    nan = torch.isnan(K8.syrk_update(C, B))
    assert torch.equal(nan, torch.isnan(K8.syrk_update_reference(C, B)))
    assert bool(nan[row].all())
    assert int(nan.sum()) == c + (r - 1 if row < c else 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("n,c0,k,offset", [
    (4096, 256, 256, 0),     # panel_chol's first in-stripe update of W 4096
    (1100, 300, 37, 1),      # ragged, odd row stride and offset: scalar copies
    (600, 129, 64, 0),
])
def test_syrk_kernel_strided_in_place(cuda, n, c0, k, offset, dtype, tol):
    """C a view S[c0:, c0:] of a larger matrix, B a view with another row
    stride, out=C: the block becomes C - B B[:c]^T within the smoke's
    tolerances and the rest of the parent matrix is left bit-equal."""
    rng = np.random.default_rng(n + c0)
    S = torch.as_tensor(rng.standard_normal((n, n + offset)), dtype=dtype,
                        device=cuda)[:, offset:]
    Zp = torch.as_tensor(rng.standard_normal((n, k + 3)) / np.sqrt(k),
                         dtype=dtype, device=cuda)
    C, B = S[c0:, c0:], Zp[c0:, 1:k + 1]
    S0 = S.clone()
    want = K8.syrk_update_reference(C.clone(), B.clone())
    before = K8.syrk_update.launches
    got = K8.syrk_update(C, B, out=C)
    torch.cuda.synchronize()
    assert got.data_ptr() == C.data_ptr() and K8.syrk_update.launches == before + 1
    assert float((C - want).abs().max()) <= tol * float(want.abs().max())
    outside = torch.ones_like(S, dtype=torch.bool)
    outside[c0:, c0:] = False
    assert torch.equal(S[outside], S0[outside])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r,c,k", [(500, 500, 64), (3840, 1792, 256)])
def test_syrk_kernel_is_deterministic(cuda, r, c, k, dtype):
    C, B = syrk_inputs(r, c, k, dtype, seed=3)
    assert torch.equal(K8.syrk_update(C, B), K8.syrk_update(C, B))


def test_syrk_kernel_rejects_non_contiguous(cuda):
    """A column stride other than 1 raises; nothing is copied."""
    C = torch.zeros((8, 8), dtype=torch.float64, device=cuda)
    B = torch.zeros((4, 8), dtype=torch.float64, device=cuda).T
    with pytest.raises(ValueError, match="column stride"):
        K8.syrk_update(C, B)
    with pytest.raises(ValueError, match="column stride"):
        K8.syrk_update(C, torch.zeros((8, 4), dtype=torch.float64, device=cuda),
                       out=torch.zeros((8, 8), dtype=torch.float64, device=cuda).T)


def test_blocked_solve_on_card_matches_cpu(cuda):
    """The bucketed blocked solve (W 1024^2: one stripe of four panels,
    three K8 updates per factorization of W) on the card and on the CPU."""
    kw = dict(print_level=40, linear_solver="blocked", pad_mode="bucket",
              factorization_dtype="float32", max_refine_steps=1)
    qp = mt.random_qp(1000, 10, seed=1, ineq=False)
    before = K8.syrk_update.launches
    got = mt.solve(qp, device=cuda, **kw)
    launches = K8.syrk_update.launches - before
    want = mt.solve(qp, device="cpu", **kw)
    assert got.success and want.success
    assert abs(got.iter - want.iter) <= 1
    assert got.objective == pytest.approx(want.objective, rel=1e-8)
    per_trial = len(blocked_dense.panel_update_shapes(1024))
    assert per_trial == 3
    assert launches == per_trial * got.counters.factorizations > 0


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_batched_solve_on_card_matches_cpu(cuda, backend):
    """A padded batch on the card (batched K1 with pallas: two launches per
    factorization trial of the batch) and on the CPU (plain version)."""
    qps = [mt.dense_dummy_qp(20 + i, 8, seed=i) for i in range(6)]
    kw = dict(print_level=40, linear_solver=backend, factorization_dtype="float32",
              max_refine_steps=1, endgame="f64")
    before = K1.cholesky_lower.launches
    got = mt.solve_batched(qps, device=cuda, **kw)
    launches = K1.cholesky_lower.launches - before
    want = mt.solve_batched(qps, device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.success and w.success
        assert abs(g.iter - w.iter) <= 1
        assert g.objective == pytest.approx(w.objective, rel=1e-8)
    assert (launches > 0 and launches % 2 == 0) if backend == "pallas" else launches == 0


def test_qp_layer_on_card_matches_cpu(cuda):
    """Forward and backward of a batched qp_layer on the card equal the
    same call on CPU tensors (float64)."""
    rng = np.random.default_rng(0)
    n, m, lanes = 10, 3, 5
    M = rng.normal(size=(lanes, n, n))
    H = M @ M.transpose(0, 2, 1) + n * np.eye(n)
    c = rng.normal(size=(lanes, n))
    A = rng.normal(size=(lanes, m, n))
    x0 = rng.normal(size=(lanes, n))
    b = np.einsum("lmn,ln->lm", A, x0)
    lb, ub = x0 - 0.5, x0 + 0.5
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in (H, c, A, b, lb, ub)]
        sol = mt.qp_layer(*ts, tol=1e-10, print_level=40, linear_solver="pallas")
        (sol.x ** 2).sum().backward()
        grads[dev.type] = [t.grad.cpu() for t in ts] + [sol.iters.cpu()]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        if g.dtype == torch.int64:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-8 * float(w.abs().max()))


@pytest.mark.parametrize("fact", ["", "float32"])
def test_two_stage_solve_on_card_matches_cpu(cuda, fact):
    """solve_two_stage with "pallas" on the card (U on the CTA tier, S on
    the warp tier, C00 and S0 on the persistent kernel: four launches per
    factorization trial) and on the CPU (plain versions)."""
    kw = dict(print_level=40, linear_solver="pallas", factorization_dtype=fact,
              max_refine_steps=1 if fact else 0)
    shape = dict(n0=24, ns=80, ms=40, m0=4, N=32, seed=2)
    before = dict(K1.cholesky_lower.routes)
    got = mt.solve_two_stage(*mt.random_two_stage(**shape, device=cuda), device=cuda, **kw)
    routes = {r: c - before.get(r, 0) for r, c in K1.cholesky_lower.routes.items()
              if c != before.get(r, 0)}
    want = mt.solve_two_stage(*mt.random_two_stage(**shape, device="cpu"), device="cpu",
                              **kw)
    assert got.success and want.success
    assert abs(got.iter - want.iter) <= (1 if fact else 0)
    assert got.objective == pytest.approx(want.objective, rel=1e-10 if not fact else 1e-8)
    np.testing.assert_allclose(got.solution, want.solution, rtol=0, atol=1e-7)
    trials = routes.get("cta", 0)
    assert routes == {"cta": trials, "warp64": trials, "single": 2 * trials}
    assert trials >= got.counters.factorizations > 0


def _staircase(seed=0):
    """A presolved, scaled staircase LP whose normal matrix (m = 1200)
    takes the panel Cholesky, so K8 runs."""
    from madqp_tpu_torch.models.suite import staircase_lp

    qp_p, _, ok = mt.presolve_qp(staircase_lp(1200, 4, seed=seed))
    assert ok
    return mt.scale_qp(qp_p)[0]


def test_dense_normal_solve_on_card_matches_cpu(cuda):
    """solve_sparse_lp (the normal equations assembled on the card, the
    panel Cholesky with K8 from m = 1024) against the same solve on the CPU
    (K8's plain version): status, iterations equal, objective 1e-10."""
    kw = dict(tol=1e-8, print_level=40, max_ncorr=3, step_rule=mt.AdaptiveStep(0.995),
              regularization=mt.FixedRegularization(1e-8, -1e-8))
    before = K8.syrk_update.launches
    got = mt.solve_sparse_lp(_staircase(), device=cuda, **kw)
    launches = K8.syrk_update.launches - before
    want = mt.solve_sparse_lp(_staircase(), device="cpu", **kw)
    assert got.success and want.success
    assert got.iter == want.iter
    assert got.objective == pytest.approx(want.objective, rel=1e-10)
    per = len(blocked_dense.panel_update_shapes(1200))
    assert launches >= per * got.iter and launches % per == 0


def test_dense_normal_assembly_is_deterministic_on_card(cuda):
    """The normal matrix assembled (sorted segment sums, a scatter of
    unique entries) and factored twice from one iterate: bit-equal."""
    from madqp_tpu_torch.solver.sparse_lp import DeviceSparseNormalKKT, make_problem

    std = mt.build_standard_form_sparse(_staircase(1))[0]
    kkt = DeviceSparseNormalKKT(std.A, mode="dense")
    prob = make_problem(std, kkt, torch.float64, cuda)
    pr = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 2.0, std.n), device=cuda)
    del_c = torch.tensor(-1e-8, dtype=torch.float64, device=cuda)
    (L1, iL1), _, s1, _, _ = kkt.factorize(prob, pr, del_c)
    (L2, iL2), _, s2, _, _ = kkt.factorize(prob, pr, del_c)
    assert kkt.assembly == "pairs" and kkt.m >= 1024
    assert torch.equal(L1, L2) and torch.equal(iL1, iL2) and torch.equal(s1, s2)
    assert bool(kkt.factor_ok(((L1, iL1), 1.0 / pr, s1, prob, del_c)))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("r,c,k", [(9984, 1792, 256), (8192, 8192, 2048), (2816, 1792, 256)])
def test_syrk_kernel_at_dense_normal_panel_shapes(cuda, r, c, k, dtype, tol):
    """K8 at launch shapes of the dense-normal path's panel Cholesky
    (panel_update_shapes of m = 10000, gridlp_100's S, and m = 3000, svm's)."""
    assert (r, c, k) in (blocked_dense.panel_update_shapes(10000)
                         + blocked_dense.panel_update_shapes(3000))
    C, B = syrk_inputs(r, c, k, dtype, seed=r + c + k)
    out = K8.syrk_update(C, B)
    plain = K8.syrk_update_reference(C, B)
    assert float((out - plain).abs().max()) <= tol * float(plain.abs().max())


def _banded_lp(n=2400):
    return mt.banded_sparse_lp(n=n, m=n // 2, band=5, seed=0)


@pytest.mark.parametrize("options", [{}, dict(solve_mode="inverse"),
                                     dict(factorization_dtype="float32",
                                          max_refine_steps=1, endgame="f64"),
                                     dict(mode="unrolled")],
                         ids=["f64", "inverse", "two-phase", "per-supernode"])
def test_supernodal_solve_on_card_matches_cpu(cuda, options):
    """solve_sparse_lp(mode="batched") on the card (K1's batched form on
    every front stack; one front at a time, K1 on each, with
    mode="unrolled") against the same solve on the CPU (the routes' plain
    versions): status and iterations equal, objective to 1e-9."""
    kw = {"mode": "batched", "tol": 1e-8, "print_level": 0, **options}
    before = K1.cholesky_lower.launches
    got = mt.solve_sparse_lp(_banded_lp(), device=cuda, **kw)
    launched = K1.cholesky_lower.launches - before
    want = mt.solve_sparse_lp(_banded_lp(), device="cpu", **kw)
    assert got.status == want.status == mt.Status.SOLVE_SUCCEEDED
    assert got.iter == want.iter
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert launched > 0


def test_supernodal_factorization_is_deterministic_on_card(cuda):
    """The supernodal normal matrix assembled (sorted segment sums) and
    factored twice from one iterate: every panel bit-equal; the card's
    panels within 1e-12 of the CPU's."""
    from madqp_tpu_torch.solver.sparse_lp import DeviceSparseNormalKKT, make_problem

    std = mt.build_standard_form_sparse(_banded_lp())[0]
    kkt = DeviceSparseNormalKKT(std.A, mode="batched")
    pr = np.random.default_rng(0).uniform(0.5, 2.0, std.n)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        prob = make_problem(std, kkt, torch.float64, dev)
        dc = torch.tensor(-1e-8, dtype=torch.float64, device=dev)
        a = kkt.factorize(prob, torch.as_tensor(pr, device=dev), dc)
        b = kkt.factorize(prob, torch.as_tensor(pr, device=dev), dc)
        assert all(torch.equal(u, v) for u, v in zip(a[0], b[0]))
        assert bool(kkt.factor_ok(a))
        out[dev.type] = a[0]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert float((g.cpu() - w).abs().max()) <= 1e-12 * float(w.abs().max())


# ---------------------------------------------------------------------------
# K2-batched (csrc/ldl_batched.cu) and the sparse QP paths
# ---------------------------------------------------------------------------


def _quasi_definite(batch, n, dtype, seed, device):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((batch, n, n))
    M = M @ M.transpose(0, 2, 1) / n + np.eye(n)
    k = n // 2
    M[:, k:, k:] *= -1.0
    s = np.ones((batch, n))
    s[:, k:] = -1.0
    return (torch.as_tensor(M, dtype=dtype, device=device),
            torch.as_tensor(s, dtype=dtype, device=device))


@pytest.mark.parametrize("dname", ["float64", "float32"])
@pytest.mark.parametrize("batch,n", [(1, 1), (64, 8), (64, 16), (33, 31), (128, 32), (128, 33),
                                     (16, 64), (16, 65), (128, 96), (128, 128)])
@pytest.mark.parametrize("floor", [False, True], ids=["no-floor", "floor"])
def test_ldl_kernel_matches_plain(cuda, batch, n, dname, floor):
    """K2-batched against its plain version on quasi-definite stacks:
    L and d within ldl_batched.TOL of max|L| and max|d| per matrix, one
    launch per call, two runs bit-equal."""
    from madqp_tpu_torch.ops import ldl_batched as K2

    F, s = _quasi_definite(batch, n, getattr(torch, dname), n, cuda)
    sg, fl = (s, 1e-6) if floor else (None, 0.0)
    before = K2.ldl_lower_batched.launches
    L, d = K2.ldl_lower_batched(F, sg, fl)
    torch.cuda.synchronize()
    assert K2.ldl_lower_batched.launches == before + 1
    Lp, dp = K2.ldl_batched_reference(F, sg, fl)
    tol = K2.TOL[dname]
    assert float(((L - Lp).abs().amax(dim=(-2, -1)) / Lp.abs().amax(dim=(-2, -1))).max()) <= tol
    assert float(((d - dp).abs().amax(-1) / dp.abs().amax(-1)).max()) <= tol
    L2, d2 = K2.ldl_lower_batched(F, sg, fl)
    assert torch.equal(L, L2) and torch.equal(d, d2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [16, 65, 128])
def test_ldl_kernel_zero_pivot_stays_in_its_matrix(cuda, n, dtype):
    """A zero row and column in one matrix: inf / NaN in that matrix only,
    the others bit-equal to a stack without it."""
    from madqp_tpu_torch.ops import ldl_batched as K2

    F, _ = _quasi_definite(6, n, dtype, 3, cuda)
    Z = F.clone()
    Z[2, n // 3, :] = 0.0
    Z[2, :, n // 3] = 0.0
    L, d = K2.ldl_lower_batched(Z)
    L0, d0 = K2.ldl_lower_batched(F)
    finite = (torch.isfinite(L).all(dim=(-2, -1)) & torch.isfinite(d).all(-1)).tolist()
    assert finite == [i != 2 for i in range(6)]
    keep = [0, 1, 3, 4, 5]
    assert torch.equal(L[keep], L0[keep]) and torch.equal(d[keep], d0[keep])


def test_ldl_kernel_reads_a_strided_front_view(cuda):
    """The leading (w, w) blocks of a (count, r, r) front stack, read in
    place, give the bits of the same blocks made contiguous."""
    from madqp_tpu_torch.ops import ldl_batched as K2

    F, s = _quasi_definite(32, 136, torch.float64, 9, cuda)
    V = F[:, :128, :128]
    a = K2.ldl_lower_batched(V, s[:, :128], 1e-6)
    b = K2.ldl_lower_batched(V.contiguous(), s[:, :128], 1e-6)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError):
        K2.ldl_lower_batched(F[:, :128, :128].mT)


@pytest.mark.parametrize("dname", ["float64", "float32"])
@pytest.mark.parametrize("batch", [2 * 132 + 1, 4 * 132 + 1])
def test_ldl_kernel_partial_last_wave(cuda, batch, dname):
    """Stacks of 2 * 132 + 1 and 4 * 132 + 1 matrices of order 128 (the
    shared tier holds 2 (float64) or 4 (float32) matrices on each of an
    H100's 132 SMs, so the last wave is partial): L and d within
    ldl_batched.TOL of the plain version, one launch, bit-equal twice."""
    from madqp_tpu_torch.ops import ldl_batched as K2

    F, s = _quasi_definite(batch, 128, getattr(torch, dname), batch, cuda)
    before = K2.ldl_lower_batched.launches
    L, d = K2.ldl_lower_batched(F, s, 1e-6)
    torch.cuda.synchronize()
    assert K2.ldl_lower_batched.launches == before + 1
    Lp, dp = K2.ldl_batched_reference(F, s, 1e-6)
    tol = K2.TOL[dname]
    assert float(((L - Lp).abs().amax(dim=(-2, -1)) / Lp.abs().amax(dim=(-2, -1))).max()) <= tol
    assert float(((d - dp).abs().amax(-1) / dp.abs().amax(-1)).max()) <= tol
    L2, d2 = K2.ldl_lower_batched(F, s, 1e-6)
    assert torch.equal(L, L2) and torch.equal(d, d2)


@pytest.mark.parametrize("dname", ["float64", "float32"])
@pytest.mark.parametrize("n", [128, 97])
def test_ldl_kernel_reads_an_unaligned_row_stride(cuda, n, dname):
    """The leading (n, n) blocks of a (B, 131, 131) stack: a row stride of
    131 elements, which no 16-byte copy fits, so the kernel copies the tiles
    one element at a time: the bits of the same blocks made contiguous,
    within ldl_batched.TOL of the plain version, bit-equal twice."""
    from madqp_tpu_torch.ops import ldl_batched as K2

    F, s = _quasi_definite(40, 131, getattr(torch, dname), 13, cuda)
    V = F[:, :n, :n]
    assert V.stride(1) * V.element_size() % 16 != 0
    a = K2.ldl_lower_batched(V)
    b = K2.ldl_lower_batched(V.contiguous())
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    Lp, dp = K2.ldl_batched_reference(V)
    tol = K2.TOL[dname]
    assert float(((a[0] - Lp).abs().amax(dim=(-2, -1)) / Lp.abs().amax(dim=(-2, -1))).max()) <= tol
    assert float(((a[1] - dp).abs().amax(-1) / dp.abs().amax(-1)).max()) <= tol
    c = K2.ldl_lower_batched(V)
    assert all(torch.equal(u, v) for u, v in zip(a, c))


def test_ldl_kernel_occupancy(cuda):
    """The shared tier at order 128 holds at least 2 matrices (CTAs) per SM
    in float64 and 4 in float32, as its launch bounds ask."""
    from madqp_tpu_torch.ops import ldl_batched as K2

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        assert K2.occupancy(dtype, 128) >= K2.CTAS_PER_SM[dname]


@pytest.mark.parametrize("system,options", [
    ("augmented", {}), ("augmented", dict(factorization_dtype="float32", max_refine_steps=2)),
    ("condensed", {}), ("condensed", dict(factorization_dtype="float32", max_refine_steps=1,
                                          endgame="krylov"))],
    ids=["augmented-f64", "augmented-two-phase", "condensed-f64", "condensed-krylov"])
def test_sparse_qp_on_card_matches_cpu(cuda, system, options):
    """solve_sparse_qp on the card (K2-batched on every signed front stack;
    K1's batched form on the condensed float64 fronts) against the same
    solve on the CPU: status, iterations within 1 (8 under the float32
    phase), objective to 1e-8."""
    from madqp_tpu_torch.ops import ldl_batched as K2
    from madqp_tpu_torch.models.suite import chain_qp

    kw = dict(kkt_system=system, tol=1e-8, print_level=0, **options)
    before = K2.ldl_lower_batched.launches + K1.cholesky_lower.launches
    got = mt.solve_sparse_qp(chain_qp(600), device=cuda, **kw)
    launched = K2.ldl_lower_batched.launches + K1.cholesky_lower.launches - before
    want = mt.solve_sparse_qp(chain_qp(600), device="cpu", **kw)
    assert got.status == want.status == mt.Status.SOLVE_SUCCEEDED
    assert abs(got.iter - want.iter) <= (8 if options else 1)
    assert got.objective == pytest.approx(want.objective, rel=1e-8)
    assert launched > 0


# ---------------------------------------------------------------------------
# The shared-pattern sparse batch (parallel/sparse_batched.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["normal-f64", "normal-mixed", "augmented"])
def test_sparse_batch_on_card_matches_cpu(cuda, case):
    """solve_sparse_batched on the card (every front stack of all lanes in
    one K1-batched or K2-batched launch) against the same batch on the CPU:
    each lane's status and iterations equal (within 8 with the float32
    phase), objective to 1e-9; the kernels launched once per front stack
    and trial, as for one instance."""
    from madqp_tpu_torch.ops import ldl_batched as K2

    if case == "augmented":
        qps = [mt.random_qp(n=36, m=18, seed=s, ineq=True) for s in range(4)]
        kw = dict(kkt_system="augmented")
    else:
        qps = [mt.banded_sparse_lp(n=400, m=200, band=4, seed=s) for s in range(4)]
        kw = dict(factorization_dtype="float32", max_refine_steps=2) if case == "normal-mixed" else {}
    before = K1.cholesky_lower.launches + K2.ldl_lower_batched.launches
    got = mt.solve_sparse_batched(qps, device=cuda, tol=1e-8, print_level=0, **kw)
    launched = K1.cholesky_lower.launches + K2.ldl_lower_batched.launches - before
    want = mt.solve_sparse_batched(qps, device="cpu", tol=1e-8, print_level=0, **kw)
    band = 8 if case == "normal-mixed" else 0
    for g, w in zip(got, want):
        assert g.status == w.status == mt.Status.SOLVE_SUCCEEDED
        assert abs(g.iter - w.iter) <= band
        assert g.objective == pytest.approx(w.objective, rel=1e-9)
    assert launched > 0


def test_sparse_batch_is_deterministic_on_card(cuda):
    """The lane-stacked normal matrices assembled and factored twice from
    one iterate per lane: every panel bit-equal, one flag per lane, each
    lane's panels within 1e-12 of the CPU's single factorization."""
    from madqp_tpu_torch.parallel.sparse_batched import _stack_problem
    from madqp_tpu_torch.solver.sparse_lp import DeviceSparseNormalKKT

    stds = [mt.build_standard_form_sparse(mt.banded_sparse_lp(n=400, m=200, band=4, seed=s))[0]
            for s in range(3)]
    kkt = DeviceSparseNormalKKT(stds[0].A, mode="batched")
    pr = np.random.default_rng(0).uniform(0.5, 2.0, (3, stds[0].n))
    prob = _stack_problem(stds, kkt, torch.float64, cuda)
    dc = torch.full((3,), -1e-8, dtype=torch.float64, device=cuda)
    a = kkt.factorize(prob, torch.as_tensor(pr, device=cuda), dc)
    b = kkt.factorize(prob, torch.as_tensor(pr, device=cuda), dc)
    assert all(torch.equal(u, v) for u, v in zip(a[0], b[0]))
    assert kkt.factor_ok(a).tolist() == [True] * 3
    cpu = _stack_problem(stds, kkt, torch.float64, "cpu")
    for lane in range(3):
        one = cpu._replace(**{f: getattr(cpu, f)[lane] for f in
                              ("c0", "c", "b", "has_lb", "has_ub", "a_vals")})
        w = kkt.factorize(one, torch.as_tensor(pr[lane]), torch.tensor(-1e-8, dtype=torch.float64))
        for g, p in zip(a[0], w[0]):
            assert float((g[lane].cpu() - p).abs().max()) <= 1e-12 * float(p.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("lanes,r,c,k", [(1, 300, 200, 40), (4, 2304, 1792, 256),
                                         (3, 65, 33, 17), (2, 512, 512, 2048)])
def test_syrk_lane_axis_matches_plain(cuda, lanes, r, c, k, dtype, tol):
    """A stack of updates, each lane a view into its own larger matrix (as
    panel_chol's lane path makes them), in place: one launch for the stack,
    every lane within the 2-D tolerance of the plain version, the rest of
    each parent matrix unchanged."""
    rng = np.random.default_rng(lanes + r + c + k)
    S = torch.as_tensor(rng.standard_normal((lanes, r + 7, c + 9)), dtype=dtype, device=cuda)
    Z = torch.as_tensor(rng.standard_normal((lanes, r + 7, k + 3)) / np.sqrt(k),
                        dtype=dtype, device=cuda)
    C, B = S[:, 7:, 9:], Z[:, 7:, 3:]
    plain = K8.syrk_update_reference(C, B)
    S0 = S.clone()
    before = K8.syrk_update.launches
    K8.syrk_update(C, B, out=C)
    torch.cuda.synchronize()
    assert K8.syrk_update.launches == before + 1
    assert float((C - plain).abs().max()) <= tol * float(plain.abs().max())
    S0[:, 7:, 9:] = C
    assert torch.equal(S, S0)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
@pytest.mark.parametrize("lanes,n", [(4, 300), (2, 129), (3, 58)])
def test_ldl_blocks_matches_plain_base(cuda, lanes, n, dtype, tol):
    """The card's blocked_ldl (one K2-batched launch per 128-wide diagonal
    block) against the same route on the CPU, whose base is K2-batched's
    plain version; equal pivot signs."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((lanes, n, n))
    F = M @ M.transpose(0, 2, 1) / n + np.eye(n)
    F[:, n // 2:, n // 2:] *= -1.0
    sgn = np.ones((lanes, n))
    sgn[:, n // 2:] = -1.0
    Fc, sc = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (F, sgn))
    before = mt.ops.ldl_lower_batched.launches
    L, d = blocked_dense.blocked_ldl(Fc, sgn=sc, floor=1e-6, lanes=True)
    torch.cuda.synchronize()
    assert mt.ops.ldl_lower_batched.launches - before == -(-n // 128)
    Lp, dp = blocked_dense.ldl_blocks(Fc.cpu(), sgn=sc.cpu(), floor=1e-6)
    assert float((L.cpu() - Lp).abs().max()) <= tol * float(Lp.abs().max())
    assert float((d.cpu() - dp).abs().max()) <= tol * float(dp.abs().max())
    assert torch.equal(torch.sign(d.cpu()), torch.sign(dp))


# ---------------------------------------------------------------------------
# The sparse augmented direction replayed as one CUDA graph (solver/mpc.py
# `DirectionGraph`): sync-free, bit for bit the eager direction
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_kernels(monkeypatch):
    """An empty pattern cache, so that each test's kernels (and their
    graphs and counters) are its own."""
    from collections import OrderedDict

    from madqp_tpu_torch.solver import sparse_common

    monkeypatch.setattr(sparse_common, "_KERNEL_CACHE", OrderedDict())


def _cvxqp_solver(device, n=1000, seed=0):
    from madqp_tpu_torch.models.suite import cvxqp_like

    return mt.MPCSolver(cvxqp_like(n, seed), device=device, kkt_system="sparse-augmented",
                        tol=1e-8, print_level=40)


def _direction_inputs(solver, iterations=3):
    """The direction's inputs at the iteration after `iterations` calls
    (the starting point first), as `MPCKernel._work` makes them."""
    kernel, p = solver.kernel, solver.prob
    state = kernel.init_state(p, solver._x0, solver._y0, solver._lb0, solver._ub0)
    for _ in range(iterations):
        state = kernel.iteration(p, state)
    state, g, c_res, jacl, _, _ = kernel._residuals(p, state)
    del_w, del_c, _, _ = kernel._work_regularization(p, state)
    factors, del_w, del_c, ok = kernel.factorize_with_retry(
        p, state.x, state.lb, state.ub, state.zl, state.zu, del_w, del_c)
    assert ok and state.initialized
    return kernel, (p, state, factors, g, jacl, c_res, del_w, del_c)


def _flat(out):
    d, mu_new, failed = out
    return [*d, mu_new, failed]


def test_replayed_direction_is_bit_equal_to_eager(cuda, fresh_kernels):
    """On the port's CVXQP generator: the direction captured and replayed,
    then replayed again on the same inputs, equals the eager `_direction`
    bit for bit (direction, barrier, failure flag)."""
    from madqp_tpu_torch.solver.mpc import DirectionGraph

    kernel, args = _direction_inputs(_cvxqp_solver(cuda))
    eager = _flat(kernel._direction(*args))
    graph = DirectionGraph(kernel)
    assert graph.route(*args) == "capture"
    first = _flat(graph(*args))
    assert graph.route(*args) == "replay"
    again = _flat(graph(*args))
    for got in (first, again):
        assert all(torch.equal(a, b) for a, b in zip(got, eager))
    assert not bool(eager[-1])


def test_direction_is_sync_free(cuda, fresh_kernels):
    """`torch.cuda.set_sync_debug_mode("error")` stays silent around an eager
    direction and around a replay (slot copies, launch, output copies):
    the unchecked segment sums and the sentinel fills read nothing back."""
    from madqp_tpu_torch.solver.mpc import DirectionGraph

    kernel, args = _direction_inputs(_cvxqp_solver(cuda))
    graph = DirectionGraph(kernel)
    graph(*args)    # the capture synchronizes by design: outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = _flat(kernel._direction(*args))
        replayed = _flat(graph(*args))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.equal(a, b) for a, b in zip(replayed, eager))


def test_solve_through_the_graph_matches_eager(cuda, fresh_kernels, monkeypatch):
    """A whole solve with its directions replayed takes the eager solve's
    iterations, objective and iterate, bit for bit."""
    from madqp_tpu_torch.solver.sparse_qp import DeviceSparseAugmentedKKT

    solver = _cvxqp_solver(cuda)
    got = solver.solve()
    assert solver.kernel.directions["replay"] == got.iter - 1
    monkeypatch.setattr(DeviceSparseAugmentedKKT, "capturable_direction", False)
    eager = _cvxqp_solver(cuda)
    want = eager.solve()
    assert eager.kernel is solver.kernel
    assert got.status == want.status == mt.Status.SOLVE_SUCCEEDED
    assert got.iter == want.iter
    assert got.objective == want.objective
    np.testing.assert_array_equal(got.solution, want.solution)
    np.testing.assert_array_equal(got.multipliers, want.multipliers)


def test_graph_counters_one_capture_per_pattern(cuda, fresh_kernels):
    """Two patterns, two solves each: one capture per pattern, at its first
    iteration after the starting point; every later direction a replay;
    the starting points eager."""
    for n in (1000, 500):
        solves = [_cvxqp_solver(cuda, n, seed) for seed in (0, 1)]
        iters = [s.solve().iter for s in solves]
        kernel = solves[0].kernel
        assert solves[1].kernel is kernel
        assert dict(kernel.directions) == {"eager": 2, "capture": 1,
                                           "replay": iters[0] - 1 + iters[1]}


# ---------------------------------------------------------------------------
# A factorization trial replayed as one CUDA graph (solver/mpc.py
# `TrialGraph`): sync-free, bit for bit the eager trial
# ---------------------------------------------------------------------------


def _trial_inputs(solver, iterations=3):
    """The first and the last trial of the iteration after `iterations`
    calls (the starting point first), eagerly: the first with the
    iteration's regularization (del_c = 0), which fails on CVXQP, the last
    escalated until it passes."""
    from madqp_tpu_torch.solver.mpc import _escalate

    kernel, p = solver.kernel, solver.prob
    state = kernel.init_state(p, solver._x0, solver._y0, solver._lb0, solver._ub0)
    for _ in range(iterations):
        state = kernel.iteration(p, state)
    dw, dc, _, _ = kernel._work_regularization(p, state)
    assert float(dc) == 0.0
    trials = []
    for _ in range(3):
        trials.append((p, state.x, state.lb, state.ub, state.zl, state.zu, dw, dc))
        if bool(kernel._factorize(*trials[-1])[1]):
            break
        dw, dc = _escalate(dw, dc)
    assert len(trials) > 1 and float(trials[-1][-1]) == -1e-8
    return kernel, trials[0], trials[-1]


def _trial_bits(out):
    """A trial's panels, pivot vectors, global pivots, scale and flag, as
    copies whose floats compare bit for bit (NaN included)."""
    from madqp_tpu_torch.solver.mpc import _leaves

    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return [t.clone().view(ints.get(t.dtype, t.dtype)) for t in _leaves(out)]


def _same(a, b):
    return len(a) == len(b) and all(u.shape == v.shape and torch.equal(u, v)
                                    for u, v in zip(a, b))


@pytest.mark.parametrize("case", ["failing", "passing"])
def test_replayed_trial_is_bit_equal_to_eager(cuda, fresh_kernels, case):
    """On the port's CVXQP generator: a trial captured and replayed, then
    replayed again after a replay on the other trial's regularization,
    equals the eager `_factorize` bit for bit (panels, pivot vectors,
    global pivots, scale, `factor_ok`), for the failing first trial
    (del_c = 0) and the passing one (del_c = -1e-8)."""
    from madqp_tpu_torch.solver.mpc import TrialGraph

    kernel, failing, passing = _trial_inputs(_cvxqp_solver(cuda))
    args, other = (failing, passing) if case == "failing" else (passing, failing)
    eager = _trial_bits(kernel._factorize(*args))
    assert bool(eager[-1]) is (case == "passing")
    graph = TrialGraph(kernel)
    assert graph.route(*args) == "capture"
    first = _trial_bits(graph(*args))
    assert graph.route(*other) == "replay"
    graph(*other)
    again = _trial_bits(graph(*args))
    assert _same(first, eager) and _same(again, eager)


def test_trial_is_sync_free(cuda, fresh_kernels):
    """`torch.cuda.set_sync_debug_mode("error")` stays silent around the
    eager trials (sigma diagonal, factorization, `factor_ok`), the
    escalation between them, `_scalar` and the replays: the unit slots'
    fills and the device fill of `_scalar` read nothing back."""
    from madqp_tpu_torch.solver.mpc import TrialGraph, _escalate

    kernel, failing, passing = _trial_inputs(_cvxqp_solver(cuda))
    graph = TrialGraph(kernel)
    graph(*failing)    # the capture synchronizes by design: outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dw, dc = _escalate(*failing[-2:])
        reg = kernel._scalar(failing[0], 1e-8)
        eager = [_trial_bits(kernel._factorize(*a)) for a in (failing, failing[:6] + (dw, dc))]
        replayed = [_trial_bits(graph(*a)) for a in (failing, failing[:6] + (dw, dc))]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(reg) == 1e-8
    assert all(_same(a, b) for a, b in zip(replayed, eager))


def test_solve_through_both_graphs_matches_eager(cuda, fresh_kernels, monkeypatch):
    """A whole solve with its trials and directions replayed takes the
    eager solve's status, iterations, objective, solution and multipliers,
    bit for bit; its trials are one capture (the starting point's first)
    and replays, as many as the eager solve's trials less that one.  The
    K2-batched launch counter counts every replay's launches: the eager
    solve's, and one trial's more (the capture's warm-up)."""
    from madqp_tpu_torch.ops import ldl_batched as K2
    from madqp_tpu_torch.ops import sparse_chol as SC
    from madqp_tpu_torch.solver.sparse_qp import DeviceSparseAugmentedKKT

    solver = _cvxqp_solver(cuda)
    before = K2.ldl_lower_batched.launches
    got = solver.solve()
    launched = K2.ldl_lower_batched.launches - before
    trials = dict(solver.kernel.factorizations)
    assert trials.get("eager", 0) == 0 and trials["capture"] == 1
    assert trials["replay"] == sum(trials.values()) - trials["capture"] > got.iter
    monkeypatch.setattr(DeviceSparseAugmentedKKT, "capturable_direction", False)
    monkeypatch.setattr(DeviceSparseAugmentedKKT, "capturable_factorize", False)
    eager = _cvxqp_solver(cuda)
    before = K2.ldl_lower_batched.launches
    want = eager.solve()
    launched_eager = K2.ldl_lower_batched.launches - before
    assert eager.kernel is solver.kernel
    assert eager.kernel.factorizations["eager"] == sum(trials.values())
    stacks = sum(it.steps if isinstance(it, SC._BucketScan) else
                 it.count if isinstance(it, SC._Chain) else 1 for it in eager.kernel.kkt.bs.schedule)
    assert launched_eager == stacks * sum(trials.values())
    assert launched == launched_eager + stacks
    assert got.status == want.status == mt.Status.SOLVE_SUCCEEDED
    assert got.iter == want.iter
    assert got.objective == want.objective
    for a, b in [(got.solution, want.solution), (got.multipliers, want.multipliers),
                 (got.multipliers_L, want.multipliers_L),
                 (got.multipliers_U, want.multipliers_U)]:
        np.testing.assert_array_equal(a, b)


def test_trial_counters_one_capture_per_pattern(cuda, fresh_kernels):
    """Two patterns, two solves each: one capture per pattern, the first
    trial of its first starting point; every later trial a replay, in the
    counter and in the `iter.factorize` spans' values."""
    from madqp_tpu_torch.utils import profiling

    for n in (1000, 500):
        profiling.enable()
        try:
            solves = [_cvxqp_solver(cuda, n, seed) for seed in (0, 1)]
            for solver in solves:
                solver.solve()
        finally:
            profiling.disable()
        routes = [sp.value for sp in profiling.drain() if sp.name == "iter.factorize"]
        kernel = solves[0].kernel
        assert solves[1].kernel is kernel
        assert routes == ["capture"] + ["replay"] * (len(routes) - 1)
        assert dict(kernel.factorizations) == {"capture": 1, "replay": len(routes) - 1}
