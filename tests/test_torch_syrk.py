"""K8: the plain version of the rank-k update against the TPU kernel.

The TPU kernel `benchmarks/exp_pallas_rl_chol.py::pallas_syrk_update` runs
here in Pallas interpret mode: the file is loaded by path and
`jax.experimental.pallas.pallas_call` is patched to pass `interpret=True`
(the kernel imports `pl` inside its body, so the patch takes; the file is
not edited).  The TPU kernel takes square C with r a multiple of its tile
and rounds every product to float32 (`preferred_element_type`), so it is
the yardstick in float32 only.  Float64, the rectangular (c < r) and the
ragged cases are held against `C - B B[:c]^T` in NumPy.

Tolerances, relative to max|C - B B^T|: 1e-5 in float32 (k = 16 products
summed in another order), 1e-12 in float64.  The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from madqp_tpu_torch.ops import syrk as K8

EXPERIMENT = (Path(__file__).resolve().parent.parent / "benchmarks"
              / "exp_pallas_rl_chol.py")


@pytest.fixture
def tpu_syrk(monkeypatch):
    spec = importlib.util.spec_from_file_location("exp_pallas_rl_chol", EXPERIMENT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return module.pallas_syrk_update


def inputs(r, c, k, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((r, c)).astype(dtype)
    B = (rng.standard_normal((r, k)) / np.sqrt(max(k, 1))).astype(dtype)
    return C, B


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_plain_matches_tpu_kernel_f32(tpu_syrk):
    C, B = inputs(64, 64, 16, seed=0, dtype=np.float32)
    want = np.asarray(tpu_syrk(jnp.asarray(C), jnp.asarray(B), tile=32))
    got = K8.syrk_update(torch.from_numpy(C), torch.from_numpy(B))
    assert got.dtype == torch.float32 and got.shape == (64, 64)
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("r,c,k", [
    (1, 1, 1), (37, 37, 5), (64, 64, 16), (300, 200, 40), (130, 1, 7),
    (96, 96, 0), (256, 256, 300),
])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_plain_matches_numpy(r, c, k, dtype, tol):
    """Square, rectangular and ragged shapes, as the wrapper takes them."""
    C, B = inputs(r, c, k, seed=r + c + k, dtype=dtype)
    want = C.astype(np.float64) - B.astype(np.float64) @ B[:c].astype(np.float64).T
    before = K8.syrk_update.launches
    got = K8.syrk_update(torch.from_numpy(C), torch.from_numpy(B))
    assert K8.syrk_update.launches == before  # the CPU runs no kernel
    assert got.dtype == torch.from_numpy(C).dtype and got.shape == (r, c)
    assert torch.equal(got, K8.syrk_update_reference(torch.from_numpy(C),
                                                     torch.from_numpy(B)))
    assert rel_err(got.numpy(), want) <= tol


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("n,c0,k", [(40, 8, 5), (300, 45, 33), (513, 256, 64)])
def test_plain_strided_views_in_place(n, c0, k, dtype, tol):
    """C = S[c0:, c0:] and B = Z[c0:, 1:k + 1] are views with row strides
    n and k + 3; out=C updates the parent S in that block only."""
    rng = np.random.default_rng(n + k)
    S = rng.standard_normal((n, n)).astype(dtype)
    Z = (rng.standard_normal((n, k + 3)) / np.sqrt(k)).astype(dtype)
    want = S.astype(np.float64).copy()
    Bz = Z[c0:, 1:k + 1].astype(np.float64)
    want[c0:, c0:] -= Bz @ Bz[:n - c0].T
    St, Zt = torch.from_numpy(S.copy()), torch.from_numpy(Z)
    C, B = St[c0:, c0:], Zt[c0:, 1:k + 1]
    assert not C.is_contiguous() and not B.is_contiguous()
    before = K8.syrk_update.launches
    got = K8.syrk_update(C, B, out=C)
    assert K8.syrk_update.launches == before
    assert got.data_ptr() == C.data_ptr()
    assert rel_err(St.numpy(), want) <= tol
    outside = np.ones((n, n), bool)
    outside[c0:, c0:] = False
    np.testing.assert_array_equal(St.numpy()[outside], S[outside])
    # the plain version takes the same arguments and gives the same bits
    St2 = torch.from_numpy(S.copy())
    K8.syrk_update_reference(St2[c0:, c0:], B, out=St2[c0:, c0:])
    assert torch.equal(St2, St)


@pytest.mark.parametrize("make", [
    lambda: (torch.zeros(8, 8), torch.zeros(4, 8).T, None),          # B
    lambda: (torch.zeros(8, 8).T, torch.zeros(8, 2), None),          # C
    lambda: (torch.zeros(8, 8), torch.zeros(8, 2), torch.zeros(8, 8).T),  # out
])
def test_wrapper_rejects_column_strided_operand(make):
    C, B, out = make()
    with pytest.raises(ValueError, match="column stride"):
        K8.syrk_update(C, B, out=out)


def test_wrapper_rejects_bad_out():
    C, B = torch.zeros(8, 8), torch.zeros(8, 2)
    with pytest.raises(ValueError, match="does not match"):
        K8.syrk_update(C, B, out=torch.zeros(8, 7))
    with pytest.raises(ValueError, match="other strides"):
        K8.syrk_update(C[:, :4], B, out=C.as_strided((8, 4), (5, 1)))


@pytest.mark.parametrize("r,c,k", [(3840, 1792, 256), (2048, 2048, 2048),
                                   (300, 200, 40), (1, 1, 1)])
def test_work_counts(r, c, k):
    """The needed work is the lower half of the symmetric top block plus
    the block below it; the kernel launches the lower tiles of the top
    block and every tile below it, which cover that work."""
    assert K8.syrk_ops(r, c, k) == c * (c + 1) * k + 2 * (r - c) * c * k
    t = K8.TILE
    tr, tc = -(-r // t), -(-c // t)
    launched = sum(1 for i in range(tr) for j in range(tc) if j <= i or i >= tc)
    issued = K8.syrk_tile_ops(r, c, k)
    assert issued == 2 * k * t * t * launched
    assert issued >= K8.syrk_ops(r, c, k)
    # (3840, 1792, 256): 28 * 29 / 2 lower tiles of the top block, 32 * 28 below
    assert K8.syrk_tile_ops(3840, 1792, 256) == 1302 * 2 * 256 * 64 ** 2


def test_nan_in_b_reaches_its_row_and_column():
    C, B = inputs(40, 40, 8, seed=3)
    B[11, 5] = np.nan
    out = K8.syrk_update(torch.from_numpy(C), torch.from_numpy(B)).numpy()
    nan = np.isnan(out)
    assert nan[11, :].all() and nan[:, 11].all()
    assert nan.sum() == 2 * 40 - 1


@pytest.mark.parametrize("C_shape,B_shape,dtypes,err", [
    ((4, 5), (4, 2), (torch.float64, torch.float64), ValueError),   # c > r
    ((4, 4), (3, 2), (torch.float64, torch.float64), ValueError),   # rows differ
    ((4,), (4, 2), (torch.float64, torch.float64), ValueError),     # 1-D C
    ((4, 4), (4, 2), (torch.float32, torch.float64), TypeError),    # mixed dtypes
    ((4, 4), (4, 2), (torch.float16, torch.float16), TypeError),    # half
])
def test_wrapper_rejects_bad_arguments(C_shape, B_shape, dtypes, err):
    with pytest.raises(err):
        K8.syrk_update(torch.zeros(C_shape, dtype=dtypes[0]),
                       torch.zeros(B_shape, dtype=dtypes[1]))


def test_tpu_kernel_rounds_float64_products_to_float32(tpu_syrk):
    """The deviation the port does not copy: given float64 inputs the TPU
    kernel still accumulates in float32, the port's plain version in
    float64 (ROADMAP.md Queue 3)."""
    C, B = inputs(64, 64, 16, seed=1)
    want = C - B @ B.T
    with jax.enable_x64(True):
        Cj, Bj = jnp.asarray(C), jnp.asarray(B)
        assert Cj.dtype == Bj.dtype == jnp.float64
        tpu = np.asarray(tpu_syrk(Cj, Bj, tile=32))
    port = K8.syrk_update(torch.from_numpy(C), torch.from_numpy(B)).numpy()
    assert rel_err(port, want) <= 1e-12
    assert rel_err(tpu, want) > 1e-9
