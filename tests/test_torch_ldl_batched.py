"""K2-batched's plain version (`ops/ldl_batched.py::ldl_batched_reference`)
against the JAX package's `unblocked_ldl` and `blocked_ldl`
(`madqp_tpu/ops/blocked_dense.py`), which `dense_ldl` runs for every
signed supernodal front.

The plain version follows the CUDA kernel's own blocking and pivot
arithmetic (the register tier's sweep for n <= 32; above it 32-column
blocks, each diagonal block by the shared tier's sweep, l = z (1 / d), the
panel by forward substitution and L21 = z (1 / d)), so it rounds and sums
the trailing updates in another order than both reference functions: L
and d are held within 16 eps of the largest |L| and |d| per matrix (`TOL`)
on quasi-definite stacks.  `ldl_lower_batched` on a CPU tensor is the plain version.  The kernel itself is held to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py phase 17).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madqp_tpu.ops import blocked_dense as JB
from madqp_tpu.ops import sparse_chol as JSC
from madqp_tpu_torch.ops import ldl_batched as K2
from madqp_tpu_torch.ops import sparse_chol as SC

WIDTHS = (1, 8, 16, 32, 33, 64, 65, 128)
# jitted: op-by-op dispatch of their column loops is several times slower
UNBLOCKED = jax.jit(JB.unblocked_ldl, static_argnames="floor")
BLOCKED = jax.jit(JB.blocked_ldl, static_argnames=("floor", "blk"))
TOL = {d: 16 * float(np.finfo(d).eps) for d in ("float32", "float64")}


def quasi_definite(B, w, dtype, seed):
    """B quasi-definite matrices [P Cᵀ; C -Q] (P, Q SPD, unit scale) and
    their pivot signs, from `seed` with NumPy."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, w, w))
    M = M @ M.transpose(0, 2, 1) / w + np.eye(w)
    k = w // 2
    M[:, k:, k:] *= -1.0
    s = np.ones((B, w))
    s[:, k:] = -1.0
    return M.astype(dtype), s.astype(dtype)


def rel_err(got, want, axes):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=axes)
    return float((np.abs(got - want).max(axis=axes) / scale).max())


@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("floor", [False, True], ids=["no-floor", "floor"])
def test_plain_version_matches_reference_ldl(w, dname, floor):
    """L and d of the plain version against JAX's unblocked_ldl and
    blocked_ldl, within TOL per matrix, with and without the sign-directed
    pivot floor (1e-6)."""
    F, s = quasi_definite(6, w, dname, seed=w)
    fl = 1e-6 if floor else 0.0
    sg = s if floor else None
    L, d = K2.ldl_batched_reference(torch.as_tensor(F), None if sg is None
                                    else torch.as_tensor(sg), fl)
    for ref in (UNBLOCKED, BLOCKED):
        Lj, dj = ref(jnp.asarray(F), sgn=None if sg is None else jnp.asarray(sg), floor=fl)
        assert rel_err(L.numpy(), Lj, (-2, -1)) <= TOL[dname]
        assert rel_err(d.numpy(), dj, (-1,)) <= TOL[dname]
    assert bool((torch.triu(L, 1) == 0).all())
    assert bool((torch.diagonal(L, dim1=-2, dim2=-1) == 1).all())


@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("w", [8, 33, 128])
def test_the_floor_raises_small_pivots_as_reference(w, dname):
    """Pivots inside the floor (a near-singular primal block) are lifted to
    the floor with their expected sign, as in the reference: same d to
    TOL, every pivot's sign the expected one."""
    F, s = quasi_definite(4, w, dname, seed=100 + w)
    F[:, 0, :] = 0.0
    F[:, :, 0] = 0.0
    F[:, 0, 0] = 1e-9   # a pivot far inside the floor (a decoupled column)
    L, d = K2.ldl_batched_reference(torch.as_tensor(F), torch.as_tensor(s), 1e-6)
    Lj, dj = UNBLOCKED(jnp.asarray(F), sgn=jnp.asarray(s), floor=1e-6)
    assert rel_err(d.numpy(), dj, (-1,)) <= TOL[dname]
    assert float(d[0, 0]) == pytest.approx(1e-6, rel=1e-6)
    assert bool((d * torch.as_tensor(s) > 0).all())


def _verdict_port(d, s):
    return bool(SC.factor_ok_batched_ldl((None, [d], None), [torch.as_tensor(s)]))


def _verdict_jax(d, s):
    return bool(JSC.factor_ok_batched_ldl((None, [d], None), [jnp.asarray(s)]))


@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("w", [16, 33, 65, 128])
@pytest.mark.parametrize("case", ["quasi-definite", "zero-pivot", "wrong-sign"])
def test_factor_ok_verdict_matches_reference(w, dname, case):
    """factor_ok_batched_ldl gives the reference's verdict on the plain
    version's pivots: a quasi-definite stack passes; a zero pivot (a zero
    row and column) makes inf / NaN in its own matrix only and fails; a
    pivot of the wrong sign (no floor) is kept and fails."""
    F, s = quasi_definite(5, w, dname, seed=7 * w)
    j = w // 3
    if case == "zero-pivot":
        F[2, j, :] = 0.0
        F[2, :, j] = 0.0
    elif case == "wrong-sign":
        F[2, j, j] = -F[2, j, j] - 10.0
    L, d = K2.ldl_batched_reference(torch.as_tensor(F))
    Lj, dj = BLOCKED(jnp.asarray(F))
    want = _verdict_jax(dj, s)
    assert _verdict_port(d, s) == want == (case == "quasi-definite")
    finite = (torch.isfinite(L).all(dim=(-2, -1)) & torch.isfinite(d).all(-1)).tolist()
    assert finite == [case != "zero-pivot" or i != 2 for i in range(5)]
    if case == "wrong-sign":
        assert float(d[2, j]) * float(s[2, j]) < 0
    if case != "zero-pivot":
        assert rel_err(d.numpy(), dj, (-1,)) <= TOL[dname]


@pytest.mark.parametrize("floor", [False, True], ids=["no-floor", "floor"])
def test_wrapper_on_a_cpu_tensor_is_the_plain_version(floor):
    """ldl_lower_batched on a CPU tensor returns the plain version's bits,
    counts no launch, and reads a strided front view (the leading block of
    a larger stack) as it is."""
    F, s = quasi_definite(3, 80, "float64", seed=5)
    big = torch.zeros((3, 96, 96), dtype=torch.float64)
    big[:, :80, :80] = torch.as_tensor(F)
    V = big[:, :80, :80]
    sg = torch.as_tensor(s) if floor else None
    before = K2.ldl_lower_batched.launches
    L, d = K2.ldl_lower_batched(V, sg, 1e-6 if floor else 0.0)
    Lp, dp = K2.ldl_batched_reference(torch.as_tensor(F), sg, 1e-6 if floor else 0.0)
    assert torch.equal(L, Lp) and torch.equal(d, dp)
    assert K2.ldl_lower_batched.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="above 128"):
        K2.ldl_lower_batched(torch.zeros((2, 129, 129)))
    with pytest.raises(ValueError, match="stack"):
        K2.ldl_lower_batched(torch.zeros((4, 4)))
    with pytest.raises(TypeError):
        K2.ldl_lower_batched(torch.zeros((2, 4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="signs"):
        K2.ldl_lower_batched(torch.zeros((2, 4, 4)), torch.ones(2, 3), 1e-6)


def test_the_kernel_source_matches_the_wrapper():
    """The block width, largest order, warps per CTA and CTAs per SM the
    wrapper states are those of csrc/ldl_batched.cu (read from the source:
    it is built on the card)."""
    src = K2.SOURCE.read_text()
    assert f"constexpr int BLK = {K2.BLOCK};" in src
    assert f"constexpr int MAX_N = {K2.MAX_N};" in src
    for dname, tag in (("float32", "F32"), ("float64", "F64")):
        assert f"constexpr int WARPS_{tag} = {K2.WARPS[dname]};" in src
        assert f"constexpr int CTAS_{tag} = {K2.CTAS_PER_SM[dname]};" in src


@pytest.mark.parametrize("dname", ["float32", "float64"])
@pytest.mark.parametrize("w", [63, 96, 97, 127])
def test_plain_version_at_the_shared_tiers_block_edges(w, dname):
    """At the shared tier's block edges (a last block of 31, 32 or 1
    columns, three or four blocks) L and d of the plain version against
    JAX's unblocked_ldl and blocked_ldl within TOL per matrix, with the
    floor."""
    F, s = quasi_definite(4, w, dname, seed=3 * w)
    L, d = K2.ldl_batched_reference(torch.as_tensor(F), torch.as_tensor(s), 1e-6)
    for ref in (UNBLOCKED, BLOCKED):
        Lj, dj = ref(jnp.asarray(F), sgn=jnp.asarray(s), floor=1e-6)
        assert rel_err(L.numpy(), Lj, (-2, -1)) <= TOL[dname]
        assert rel_err(d.numpy(), dj, (-1,)) <= TOL[dname]


def test_plain_version_of_a_stack_is_each_matrix_alone():
    """A stack larger than one CTA's share (the kernel factors one matrix
    per CTA): every matrix of a (9, 100, 100) stack gets the bits it gets
    alone."""
    F, s = quasi_definite(9, 100, "float64", seed=11)
    Ft, st = torch.as_tensor(F), torch.as_tensor(s)
    L, d = K2.ldl_batched_reference(Ft, st, 1e-6)
    for i in (0, 4, 8):
        Li, di = K2.ldl_batched_reference(Ft[i:i + 1], st[i:i + 1], 1e-6)
        assert torch.equal(L[i], Li[0]) and torch.equal(d[i], di[0])


@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_shared_tier_scales_by_the_pivots_reciprocal(dname):
    """Above 32 the plain version forms the kernel's l = z (1 / d): the
    first column, in the diagonal block and in the panel below it, is
    F's first column times the correctly rounded 1 / d_0, bit for bit."""
    F, _ = quasi_definite(3, 40, dname, seed=2)
    Ft = torch.as_tensor(F)
    L, d = K2.ldl_batched_reference(Ft)
    rinv = 1.0 / Ft[:, 0, 0]
    assert torch.equal(d[:, 0], Ft[:, 0, 0])
    assert torch.equal(L[:, 1:, 0], Ft[:, 1:, 0] * rinv[:, None])
