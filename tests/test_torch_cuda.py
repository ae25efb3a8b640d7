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


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("batch,n", [(512, 42), (512, 16), (64, 1), (64, 63),
                                     (64, 64), (64, 65), (16, "max"),
                                     (16, "max+1"), (4, 600)])
def test_batched_kernel_matches_plain(cuda, batch, n, dtype, tol):
    """Each factor of a stack within the smoke's tolerances of the plain
    version (relative to its max|L|), zero above the diagonal; one launch
    for a stack the one-CTA kernel holds, one per matrix above that."""
    n = batched_order(n, dtype)
    A = torch.as_tensor(spd_stack(batch, n, seed=n), dtype=dtype, device=cuda)
    before = K1.cholesky_lower.launches
    L = K1.cholesky_lower(A)
    torch.cuda.synchronize()
    one_cta = n <= K1.batched_max_n(dtype, cuda)
    assert K1.cholesky_lower.launches == before + (1 if one_cta else batch)
    Lp = K1.cholesky_lower_reference(A)
    err = (L - Lp).abs().amax(dim=(1, 2))
    assert bool((err <= tol * Lp.abs().amax(dim=(1, 2))).all())
    assert bool((torch.triu(L, 1) == 0).all())
    assert torch.equal(L, K1.cholesky_lower(A))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batch,n", [(8, 42), (8, 16), (4, 65), (3, "max+1")])
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
