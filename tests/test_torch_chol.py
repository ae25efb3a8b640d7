"""K1: the port's blocked Cholesky against the Pallas kernel.

On the CPU the plain version (`cholesky_lower_reference`, which
`cholesky_lower` runs for CPU tensors) is held against
`pallas_cholesky(..., interpret=True)`, with the tolerances of
tests/test_pallas.py: 1e-10 in float64, 1e-4 in float32.  So is the plain
version that follows each route's kernel (`ROUTE_REFERENCE`: the
persistent kernel's sub-blocked rsqrt diagonal, the shared tiers' 32-column
blocks with the panel by substitution, the register tiers' unblocked
sweep), on stacks under `jax.vmap` at the routes' edges.  The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

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
@pytest.mark.parametrize("batch,n", [(3, 37), (4, 64), (2, 129), (5, 1),
                                     # the edges of the batched routes
                                     (7, 16), (5, 31), (5, 32), (5, 33), (3, 42)])
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


# The H100's shared-memory limits of the batched kernels (float32, float64).
H100_N_MAX = {"float32": 235, "float64": 163}


@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("n,want", [
    (1, "warp8"), (8, "warp8"), (9, "warp16"), (16, "warp16"), (17, "warp32"),
    (31, "warp32"), (32, "warp32"), (33, "warp64"), (63, "warp64"), (64, "warp64"),
    (65, "cta"), ("max", "cta"), ("max+1", "persistent"), (600, "persistent"),
    (2500, "persistent"),
])
def test_batched_route_at_every_edge(n, want, dname):
    """Every stack is one launch: the register tiers up to 32, a warp per
    matrix up to 64, a CTA per matrix up to n_max, the persistent kernel
    with a lane axis above it; each route names one kernel of the C side."""
    n_max = H100_N_MAX[dname]
    if not isinstance(n, int):
        n = n_max + (n == "max+1")
    route = K1.batched_route(n, n_max)
    assert route == want
    assert route == "persistent" or route in K1._TIERS


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batch,n", [(5, 8), (5, 33)])
def test_stack_nan_contract_matches_vmapped_pallas(batch, n, dtype):
    """At the route edges: one non-SPD matrix gives the vmapped Pallas
    kernel's per-lane verdict, NaN on its own diagonal only, and the other
    factors match Pallas to the stack tolerances."""
    import jax

    A = spd_stack(batch, n, dtype, seed=n)
    A[1] = not_spd(n, dtype, seed=7)
    want = np.asarray(jax.vmap(lambda a: pallas_cholesky(a, interpret=True))(A))
    got = K1.cholesky_lower_reference(torch.from_numpy(A)).numpy()
    for i in range(batch):
        assert diag_ok(got[i]) is diag_ok(want[i]) is (i != 1)
    assert np.isnan(got[1, -1, -1])
    good = [i for i in range(batch) if i != 1]
    np.testing.assert_allclose(got[good], want[good], rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# The plain version of each route (ROUTE_REFERENCE)
# ---------------------------------------------------------------------------

ROUTE_PLAIN = {"persistent": K1.cholesky_persistent_reference,
               "shared": K1.cholesky_shared_reference,
               "unblocked": K1.cholesky_unblocked_reference}
# The edges of the routes (8, 16, 32 registers; 64 a warp; the 32-column
# blocks; 163 and 235 the H100's n_max in float64 and float32) and of the
# persistent kernel's 64-column steps.
ROUTE_EDGES = (8, 16, 31, 32, 33, 63, 64, 65, 100, 163, 235)
# max|L - L_pallas| / max|L_pallas| per matrix: float64 1e-14, float32
# 4e-6 (measured at most 1.0e-15 and 5.0e-7 at these sizes).
ROUTE_TOL = {np.float64: 1e-14, np.float32: 4e-6}


@functools.lru_cache(maxsize=None)
def vmapped_pallas(batch, n, dtype, bad=None):
    """The stack of `route_stack` and its factors by the Pallas kernel under
    jax.vmap, interpret mode (one program per matrix, as the batched
    solver runs it); cached, since every plain version is held against
    it."""
    import jax

    A = spd_stack(batch, n, dtype, seed=n)
    if bad is not None:
        A[bad] = not_spd(n, dtype, seed=7)
    L = np.asarray(jax.vmap(lambda a: pallas_cholesky(a, interpret=True))(A))
    A.flags.writeable = L.flags.writeable = False
    return A, L


def rel_err(got, want):
    return np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))


def test_every_route_has_its_plain_version():
    routes = {K1.batched_route(n, 163) for n in (1, 9, 17, 33, 65, 164)}
    assert routes | {"single"} == set(K1.ROUTE_REFERENCE)
    assert K1.ROUTE_REFERENCE["single"] is K1.cholesky_persistent_reference
    assert K1.ROUTE_REFERENCE["cta"] is K1.ROUTE_REFERENCE["warp64"] \
        is K1.cholesky_shared_reference
    assert {K1.ROUTE_REFERENCE[f"warp{w}"] for w in (8, 16, 32)} == \
        {K1.cholesky_unblocked_reference}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", ROUTE_EDGES)
@pytest.mark.parametrize("plain", sorted(ROUTE_PLAIN))
def test_route_plain_matches_vmapped_pallas(plain, n, dtype):
    A, want = vmapped_pallas(2, n, dtype)
    got = ROUTE_PLAIN[plain](torch.from_numpy(A.copy())).numpy()
    assert got.dtype == dtype and got.shape == A.shape
    assert rel_err(got, want).max() <= ROUTE_TOL[dtype]
    assert np.all(np.triu(got, 1) == 0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [8, 33, 100])
@pytest.mark.parametrize("plain", sorted(ROUTE_PLAIN))
def test_route_plain_nan_contract(plain, n, dtype):
    """One non-SPD matrix in a stack of three: the vmapped Pallas kernel's
    per-lane verdict, NaN on its own diagonal (the last entry: no early
    exit), and the other lanes bit-equal to the same stack without it."""
    A, want = vmapped_pallas(3, n, dtype, bad=1)
    fn = ROUTE_PLAIN[plain]
    got = fn(torch.from_numpy(A.copy())).numpy()
    for i in range(3):
        assert diag_ok(got[i]) is diag_ok(want[i]) is (i != 1)
    assert np.isnan(got[1, -1, -1])
    clean, _ = vmapped_pallas(3, n, dtype)
    assert np.array_equal(got[[0, 2]], fn(torch.from_numpy(clean.copy())).numpy()[[0, 2]])
    assert rel_err(got[[0, 2]], want[[0, 2]]).max() <= ROUTE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 16, 17, 40, 64])
def test_sub_block_diagonal_factor_inverts_the_block(n, dtype):
    """The persistent kernel's diagonal factor (16-column sub-blocks, rsqrt
    scaling) gives the block's factor in place and its inverse (lower,
    zero above the diagonal)."""
    A = torch.from_numpy(spd(n, np.float64, seed=n)).to(dtype)
    D = torch.tril(A)
    Dinv = K1._factor_diag_sub(D)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(D, torch.linalg.cholesky(A), rtol=tol, atol=tol)
    torch.testing.assert_close(Dinv @ D, torch.eye(n, dtype=dtype), rtol=tol, atol=tol)
    assert bool((torch.triu(Dinv, 1) == 0).all())


# ---------------------------------------------------------------------------
# The library factorization on the CPU: SciPy's LAPACK, bit-equal to the
# JAX package's `jax.scipy.linalg.cholesky` (jaxlib takes its LAPACK from
# SciPy), under one and four torch threads.
# ---------------------------------------------------------------------------


@pytest.fixture(params=[1, 4], ids=["1-thread", "4-threads"])
def torch_threads(request):
    before = torch.get_num_threads()
    torch.set_num_threads(request.param)
    yield request.param
    torch.set_num_threads(before)


def jax_cholesky(A):
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl

    return np.asarray(jsl.cholesky(jnp.asarray(A), lower=True))


def bit_equal(L, want):
    """Equal bits, NaN where the reference has NaN (a failed factor: the
    reference fills the whole matrix, the port its diagonal)."""
    L = np.asarray(L)
    if np.isnan(want).any():
        return bool(np.isnan(np.diagonal(L)).any())
    return np.array_equal(L, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lapack_cholesky_bit_equal_to_jax_on_a_stack(dtype, torch_threads):
    """A seeded SPD stack: each factor bit for bit the reference's, and a
    non-SPD member NaN on its diagonal, the others untouched."""
    A = spd_stack(4, 70, dtype, seed=11)
    L = K1._lapack_cholesky(torch.from_numpy(A)).numpy()
    assert all(np.array_equal(L[i], jax_cholesky(A[i])) for i in range(4))
    A[2] = not_spd(70, dtype, seed=13)
    L = K1._lapack_cholesky(torch.from_numpy(A)).numpy()
    assert not diag_ok(L[2]) and all(diag_ok(L[i]) for i in (0, 1, 3))
    one = K1.dense_cholesky(torch.from_numpy(A[0])).numpy()
    assert np.array_equal(one, jax_cholesky(A[0]))


def test_lapack_cholesky_bit_equal_to_jax_on_transport(torch_threads, monkeypatch):
    """Every matrix the dense path factors while the runner solves the
    medium tier's transport_12x15_0 (tests/test_torch_pipeline.py), the
    δ_w = 1e-8 trials of iterations 11 and 14 among them, where MKL's and
    OpenBLAS's verdicts part (ROADMAP.md Queue 3): the port's factor is
    the reference's, bit for bit."""
    import madqp_tpu_torch as mt
    from madqp_tpu_torch.ops import kkt
    from madqp_tpu_torch.solver.mpc import MPCKernel
    from test_torch_pipeline import T, medium_problems, options

    seen, k = [], [0]
    iteration = MPCKernel.iteration

    def counted(self, p, state):
        k[0] = state.k
        return iteration(self, p, state)

    def recording(backend):
        chol = K1.select_cholesky(backend)

        def factor(M):
            L = chol(M)
            seen.append((k[0], M.numpy().copy(), L.numpy().copy()))
            return L
        return factor

    monkeypatch.setattr(MPCKernel, "iteration", counted)
    monkeypatch.setattr(kkt, "select_cholesky", recording)
    T.run_instance("transport_12x15_0", medium_problems()[1]["transport_12x15_0"],
                   options(mt, "dense", "cpu"))
    assert {11, 14} <= {it for it, _, _ in seen}
    for it, M, L in seen:
        assert bit_equal(L, jax_cholesky(M)), it
