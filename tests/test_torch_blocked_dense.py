"""ops/blocked_dense.py: every ported function against its JAX counterpart.

The same inputs (NumPy, from a seed) go through `madqp_tpu.ops.blocked_dense`
and `madqp_tpu_torch.ops.blocked_dense` at the sizes of
tests/test_blocked_dense.py, the panel regime (n >= 1024: `panel_ldl`,
`panel_chol` with its K8 trailing updates, which run their plain version on
the CPU) included.

Tolerances, relative to the largest magnitude of each output: 1e-10 in
float64 and 1e-4 in float32 (the two packages sum products in other
orders; the test matrices are well conditioned, M M' + w I).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madqp_tpu.ops import blocked_dense as J
from madqp_tpu_torch.ops import blocked_dense as T

TOL = {np.float64: 1e-10, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run the port's side single-threaded: the suite runs one process per
    core under xdist, and torch's default of a thread per core in every
    process oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spd(seed, *shape, dtype=np.float64):
    rng = np.random.default_rng(seed)
    w = shape[-1]
    M = rng.standard_normal(shape)
    return (M @ np.swapaxes(M, -1, -2) + w * np.eye(w)).astype(dtype)


def quasi_definite(seed, w, dtype=np.float64):
    """[D A'; A -D' - A A'] with positive then negative pivots."""
    rng = np.random.default_rng(seed)
    h = w // 2
    Adat = rng.standard_normal((w - h, h))
    K = np.zeros((w, w))
    K[:h, :h] = np.diag(rng.uniform(0.5, 2.0, h))
    K[h:, :h] = Adat
    K[:h, h:] = Adat.T
    K[h:, h:] = -np.diag(rng.uniform(0.5, 2.0, w - h)) - Adat @ Adat.T
    sgn = np.concatenate([np.ones(h), -np.ones(w - h)])
    return K.astype(dtype), sgn.astype(dtype)


def unit_lower(seed, *shape, unit=True):
    rng = np.random.default_rng(seed)
    w = shape[-1]
    L = np.tril(rng.standard_normal(shape) / np.sqrt(w), -1)
    ii = np.arange(w)
    L[..., ii, ii] = 1.0 if unit else rng.uniform(0.5, 2.0, shape[:-1])
    return L


def close(got, want, dtype, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.dtype == np.dtype(dtype), what
    scale = np.max(np.abs(want), initial=0.0)
    err = np.max(np.abs(got.astype(np.float64) - want), initial=0.0)
    assert err <= TOL[dtype] * scale, f"{what}: {err:.3e} vs scale {scale:.3e}"


def jax_fn(fn_name, *static):
    """The JAX function under jit (op-by-op dispatch of its loops is
    several times slower on the CPU); `static` names its non-array
    keywords."""
    return jax.jit(getattr(J, fn_name), static_argnames=static)


def both(fn_name, *arrays, **static):
    """(JAX result, port result) of blocked_dense.<fn_name> on the arrays,
    with the given static keywords."""
    jout = jax_fn(fn_name, *static)(*(jnp.asarray(a) for a in arrays), **static)
    tout = getattr(T, fn_name)(*(torch.tensor(a) for a in arrays), **static)
    return jout, tout


def signed_ldl(K, sgn, floor):
    """(JAX, port) blocked_ldl with expected pivot signs and a floor."""
    jout = jax_fn("blocked_ldl", "floor")(jnp.asarray(K), sgn=jnp.asarray(sgn),
                                          floor=floor)
    tout = T.blocked_ldl(torch.tensor(K), sgn=torch.tensor(sgn), floor=floor)
    return jout, tout


def test_constants_match():
    assert (T.BLK, T.PANEL, T.OUTER, T._PANEL_MIN) == (
        J.BLK, J.PANEL, J.OUTER, J._PANEL_MIN)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [8, 32])
def test_unblocked_ldl(w, dtype):
    A = spd(w, 5, w, w, dtype=dtype)
    (jL, jd), (tL, td) = both("unblocked_ldl", A)
    close(tL, jL, dtype, "L")
    close(td, jd, dtype, "d")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w,batch", [(8, ()), (32, (7,)), (80, ()), (160, ())])
def test_blocked_ldl(w, batch, dtype):
    A = spd(w + len(batch), *batch, w, w, dtype=dtype)
    (jL, jd), (tL, td) = both("blocked_ldl", A)
    close(tL, jL, dtype, "L")
    close(td, jd, dtype, "d")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w", [16, 64, 128])
def test_blocked_ldl_quasi_definite_signed(w, dtype):
    K, sgn = quasi_definite(w, w, dtype=dtype)
    (jL, jd), (tL, td) = signed_ldl(K, sgn, 1e-6)
    close(tL, jL, dtype, "L")
    close(td, jd, dtype, "d")
    assert (np.sign(td.numpy()) == sgn).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_pivot_floor(dtype):
    """A tiny pivot of the right sign is clamped to sgn * floor in both."""
    w = 48
    A = spd(48, w, w)
    A[3, :] = 0.0
    A[:, 3] = 0.0
    A[3, 3] = 1e-12
    A = A.astype(dtype)
    sgn = np.ones(w, dtype)
    (jL, jd), (tL, td) = signed_ldl(A, sgn, 1e-6)
    close(tL, jL, dtype, "L")
    close(td, jd, dtype, "d")
    assert float(td[3]) == pytest.approx(1e-6, rel=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w,batch", [(4, ()), (96, (7,)), (160, ())])
def test_blocked_cholesky(w, batch, dtype):
    A = spd(w + 1, *batch, w, w, dtype=dtype)
    jL, tL = both("blocked_cholesky", A)
    close(tL, jL, dtype)


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("w", [8, 32, 96, 128])
def test_inv_lower(w, unit):
    L = unit_lower(w, 3, w, w, unit=unit)
    jX, tX = both("inv_lower", L, unit=unit)
    close(tX, jX, np.float64)
    jX, tX = both("inv_unit_lower", unit_lower(w + 1, 3, w, w))
    close(tX, jX, np.float64)


@pytest.mark.parametrize("n", [100, 300, 1100])
def test_panel_ldl(n):
    A = spd(n, n, n)
    (jL, jd), (tL, td) = both("panel_ldl", A)
    close(tL, jL, np.float64, "L")
    close(td, jd, np.float64, "d")
    jX, tX = both("panel_inv_unit_lower", np.asarray(jL))
    close(tX, jX, np.float64, "inverse")


def test_panel_ldl_quasi_definite_signed_floor():
    K, sgn = quasi_definite(1500, 1500)
    (jL, jd), (tL, td) = signed_ldl(K, sgn, 1e-10)
    close(tL, jL, np.float64, "L")
    close(td, jd, np.float64, "d")
    assert (np.sign(td.numpy()) == sgn).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [300, 1024, 1100, 2304])
def test_panel_chol_and_inverse(n, dtype):
    """Single-panel, single-stripe, ragged and two-stripe sizes (2304 runs
    one rectangular in-stripe and one cross-stripe K8 update)."""
    A = spd(n, n, n, dtype=dtype)
    jL, tL = both("panel_chol", A)
    close(tL, jL, dtype, "L")
    assert bool((torch.triu(tL, 1) == 0).all())
    jX, tX = both("panel_inv_lower", np.asarray(jL))
    close(tX, jX, dtype, "inverse")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [96, 1100])
def test_factor_inv_chol_and_explicit_inverse(n, dtype):
    """All three routes: float32 library (n < 1024), float64 LDL recursion
    (n < 1024) and the panel path (n >= 1024)."""
    A = spd(n + 7, n, n, dtype=dtype)
    (jL, jiL), (tL, tiL) = both("factor_inv_chol", A)
    close(tL, jL, dtype, "L")
    close(tiL, jiL, dtype, "iL")
    (_, jM), (_, tM) = both("chol_explicit_inverse", A)
    close(tM, jM, dtype, "inverse")


@pytest.mark.parametrize("fn", ["factor_inv_chol", "blocked_cholesky",
                                "panel_chol"])
@pytest.mark.parametrize("n", [96, 1100])
def test_non_spd_gives_bad_diagonal_in_both(fn, n):
    """The factor_ok contract: a non-SPD input gives a non-finite or
    non-positive factor diagonal in both packages."""
    A = spd(n, n, n)
    A[n // 3, n // 3] = -5.0 * n
    jout, tout = both(fn, A)
    jL, tL = (jout[0], tout[0]) if fn == "factor_inv_chol" else (jout, tout)

    def ok(L):
        d = np.diagonal(np.asarray(L))
        return bool(np.all(np.isfinite(d)) and np.all(d > 0))

    assert ok(jL) is False
    assert ok(tL.numpy()) is False


@pytest.mark.parametrize("n", [1024, 2304, 4096])
def test_panel_chol_launches_match_panel_update_shapes(monkeypatch, n):
    """The (r, c, k) that panel_chol hands to K8, in order, are the list
    panel_update_shapes gives (the chip smoke reads the same list).  K8 is
    stubbed to record and return its output untouched, on the identity,
    whose update is zero, so the shapes come without the work."""
    calls = []

    def record(C, B, out=None):
        assert out is not None and out.data_ptr() == C.data_ptr()
        calls.append((C.shape[0], C.shape[1], B.shape[1]))
        return out

    monkeypatch.setattr(T, "syrk_update", record)
    L = T.panel_chol(torch.eye(n, dtype=torch.float32))
    assert calls == T.panel_update_shapes(n)
    assert torch.equal(L, torch.eye(n, dtype=torch.float32))


def test_bucketed_n2000_takes_18_launches_per_trial():
    """random_qp(2000, 1000) through the bucket rule: W 4096^2 (7 + 1
    updates in its first stripe, 7 in its second) and S 1024^2 (3)."""
    import madqp_tpu_torch as mt
    from madqp_tpu_torch.solver.driver import bucket_shape

    info = mt.build_standard_form_sparse(mt.random_qp(2000, 1000, seed=0))[1]
    n_tot, m_tot = bucket_shape(info.n, info.m)
    assert (n_tot, m_tot) == (4096, 1024)
    w, s = T.panel_update_shapes(n_tot), T.panel_update_shapes(m_tot)
    assert len(w) + len(s) == 18
    assert w[0] == (3840, 1792, 256) and w[7] == (2048, 2048, 2048)
    assert s == [(768, 768, 256), (512, 512, 256), (256, 256, 256)]
