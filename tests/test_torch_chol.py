"""K1: the port's blocked Cholesky against the Pallas kernel.

On the CPU the plain version (`cholesky_lower_reference`, which
`cholesky_lower` runs for CPU tensors) is held against
`pallas_cholesky(..., interpret=True)`, with the tolerances of
tests/test_pallas.py: 1e-10 in float64, 1e-4 in float32.  The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from madqp_tpu.ops.pallas_chol import pallas_cholesky
from madqp_tpu_torch.ops import pallas_chol as K1

TOL = {np.float64: 1e-10, np.float32: 1e-4}
# Block edges of the 64-column blocking (63, 64, 65, 127, 129) among them.
SIZES = [1, 37, 63, 64, 65, 127, 128, 129, 200, 256]


def spd(n, dtype, seed):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, n))
    return (P @ P.T + n * np.eye(n)).astype(dtype)


def not_spd(n, dtype, seed):
    A = spd(n, dtype, seed)
    A[n // 2, n // 2] = -1.0
    return A


def diag_ok(L):
    d = np.diagonal(np.asarray(L))
    return bool(np.all(np.isfinite(d) & (d > 0)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_pallas_interpret(n, dtype):
    A = spd(n, dtype, seed=n)
    want = np.asarray(pallas_cholesky(A, interpret=True))
    got = K1.cholesky_lower_reference(torch.from_numpy(A)).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    assert np.all(np.triu(got, 1) == 0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 37, 63, 64, 65, 127, 129, 200])
def test_non_spd_verdict_matches_pallas(n, dtype):
    B = not_spd(n, dtype, seed=n)
    want = pallas_cholesky(B, interpret=True)
    got = K1.cholesky_lower_reference(torch.from_numpy(B))
    assert diag_ok(got.numpy()) == diag_ok(want) is False
    # no early exit: the NaN of the negative pivot reaches the last column
    assert np.isnan(got.numpy()[-1, -1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 64, 65, 130])
def test_diagonal_sweep_inverts_the_block(n, dtype):
    """The column sweep of the diagonal block also yields L_D^-1 (lower,
    zero above the diagonal), which the panel solve multiplies by."""
    A = torch.from_numpy(spd(n, np.float64, seed=n)).to(dtype)
    D = torch.tril(A)
    Dinv = K1._factor_diag(D)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(D, torch.linalg.cholesky(A), rtol=tol, atol=tol)
    torch.testing.assert_close(Dinv @ D, torch.eye(n, dtype=dtype),
                               rtol=tol, atol=tol)
    assert bool((torch.triu(Dinv, 1) == 0).all())


def test_block_matches_kernel():
    assert K1.BLOCK == 64


def test_wrapper_uses_plain_version_on_cpu():
    A = torch.from_numpy(spd(70, np.float64, seed=1))
    before = K1.cholesky_lower.launches
    L = K1.cholesky_lower(A)
    assert K1.cholesky_lower.launches == before  # no kernel launch on the CPU
    assert torch.equal(L, K1.cholesky_lower_reference(A))
    np.testing.assert_allclose((L @ L.T).numpy(), A.numpy(), rtol=1e-12)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(3, 4, dtype=torch.float64), ValueError),
    (torch.zeros(3, dtype=torch.float64), ValueError),
    (torch.eye(3, dtype=torch.int64), TypeError),
    (torch.eye(3, dtype=torch.float16), TypeError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        K1.cholesky_lower(bad)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dense_cholesky_nan_contract(dtype):
    """linear_solver='dense' maps the library factor's `info` to a NaN
    diagonal, so factor_ok reads both backends the same way."""
    A = torch.from_numpy(spd(40, np.float64, seed=2)).to(dtype)
    L = K1.dense_cholesky(A)
    assert diag_ok(L.numpy())
    torch.testing.assert_close(L, K1.cholesky_lower_reference(A))
    B = torch.from_numpy(not_spd(40, np.float64, seed=2)).to(dtype)
    assert not diag_ok(K1.dense_cholesky(B).numpy())


def test_select_cholesky():
    assert K1.select_cholesky("pallas") is K1.cholesky_lower
    assert K1.select_cholesky("xla") is K1.dense_cholesky


# ---------------------------------------------------------------------------
# A stack of matrices (the batched solver's factorizations)
# ---------------------------------------------------------------------------


def spd_stack(batch, n, dtype, seed):
    return np.stack([spd(n, dtype, seed + i) for i in range(batch)])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batch,n", [(3, 37), (4, 64), (2, 129), (5, 1)])
def test_plain_stack_matches_vmapped_pallas(batch, n, dtype):
    """The plain version on a (B, n, n) stack against the Pallas kernel
    under jax.vmap (one program per matrix, as the batched solver runs it),
    interpret mode, with the single-matrix tolerances."""
    import jax

    A = spd_stack(batch, n, dtype, seed=n)
    want = np.asarray(jax.vmap(lambda a: pallas_cholesky(a, interpret=True))(A))
    got = K1.cholesky_lower_reference(torch.from_numpy(A)).numpy()
    assert got.dtype == dtype and got.shape == A.shape
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    assert np.all(np.triu(got, 1) == 0)


@pytest.mark.parametrize("factor", ["plain", "dense"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stack_nan_contract_per_lane(factor, dtype):
    """One non-SPD matrix in a stack: NaN (or a non-positive value) on its
    own diagonal only; every other factor equals that matrix's factor
    alone.  The same for the library route (dense_cholesky)."""
    fn = K1.cholesky_lower_reference if factor == "plain" else K1.dense_cholesky
    A = spd_stack(4, 70, dtype, seed=3)
    A[2] = not_spd(70, dtype, seed=5)
    L = fn(torch.from_numpy(A))
    for i in range(4):
        assert diag_ok(L[i].numpy()) is (i != 2)
        if i != 2:
            torch.testing.assert_close(L[i], fn(torch.from_numpy(A[i])),
                                       rtol=0, atol=1e-13 if dtype == np.float64 else 1e-5)
    assert np.isnan(L[2].numpy()[-1, -1]) or factor == "dense"


def test_wrapper_on_a_stack_uses_plain_version_on_cpu():
    A = torch.from_numpy(spd_stack(3, 20, np.float64, seed=1))
    before = K1.cholesky_lower.launches
    L = K1.cholesky_lower(A)
    assert K1.cholesky_lower.launches == before
    assert torch.equal(L, K1.cholesky_lower_reference(A))
