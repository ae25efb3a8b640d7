"""The batch's linear algebra below the KKT: the lane path of
ops/blocked_dense.py, K8's lane axis and the card's 128-block LDL^T.

* The lane path (`lanes=True`) on a (2, 1100, 1100) seeded stack, where the
  panel forms take over (order >= 1024), against `jax.vmap` of the JAX
  functions, which see one 2-D lane: `factor_inv_chol` (`panel_chol` with
  its K8 updates, `panel_inv_lower`) and `blocked_ldl` (`panel_ldl`) with
  and without signs (the pivot floor).  Relative to each output's largest
  magnitude: 1e-10 (float64, well-conditioned inputs; the packages sum
  products in other orders).  `panel_chol` issues
  `panel_update_shapes(n)` K8 updates per factorization whatever the lane
  count.
* Above the threshold a 3-D call without `lanes` keeps the JAX
  recursion, as a plain 3-D call in the JAX package does (the supernodal
  fronts' route), and with `lanes` takes the panel forms, as under
  `jax.vmap`.
* K8's plain version on a stack against per-lane 2-D calls, out of place
  and in place on lane views of a larger stack.
* `ldl_blocks`, the card's route of `blocked_ldl` (one K2-batched launch
  per 128-wide diagonal block), run on the CPU with K2-batched's plain
  version as its base, against the JAX `blocked_ldl` (blk-32 recursion) on
  a quasi-definite stack of order 300, with and without the pivot floor:
  factor and pivots within 1e-10 of their largest magnitude (float64; the
  two block the columns differently, 128 against 32), equal pivot signs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madqp_tpu.ops import blocked_dense as J
from madqp_tpu_torch.ops import blocked_dense as T
from madqp_tpu_torch.ops import syrk as K8

TOL = 1e-10
LANES, ORDER = 2, 1100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one process per core under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spd_stack(seed, lanes, n):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((lanes, n, n))
    return M @ M.transpose(0, 2, 1) / n + np.eye(n)


def quasi_definite_stack(seed, lanes, n):
    """[D A'; A -D' - A A'] per lane, with its pivot signs."""
    rng = np.random.default_rng(seed)
    h = n // 2
    K = np.zeros((lanes, n, n))
    for i in range(lanes):
        A = rng.standard_normal((n - h, h)) / np.sqrt(h)
        K[i, :h, :h] = np.diag(rng.uniform(0.5, 2.0, h))
        K[i, h:, :h] = A
        K[i, :h, h:] = A.T
        K[i, h:, h:] = -np.diag(rng.uniform(0.5, 2.0, n - h)) - A @ A.T
    sgn = np.broadcast_to(np.concatenate([np.ones(h), -np.ones(n - h)]), (lanes, n))
    return K, np.ascontiguousarray(sgn)


def close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, err


def test_lane_path_factor_inv_chol_matches_vmap(monkeypatch):
    F = spd_stack(0, LANES, ORDER)
    want_L, want_iL = jax.jit(jax.vmap(J.factor_inv_chol))(jnp.asarray(F))
    calls = []
    syrk = T.syrk_update
    monkeypatch.setattr(T, "syrk_update", lambda C, B, out=None: (
        calls.append((C.dim(), tuple(C.shape[-2:]), B.shape[-1])) or syrk(C, B, out=out)))
    L, iL = T.factor_inv_chol(torch.from_numpy(F), lanes=True)
    close(L, want_L)
    close(iL, want_iL)
    # every K8 update once for both lanes, at panel_update_shapes' shapes
    assert calls == [(3, (r, c), k) for r, c, k in T.panel_update_shapes(ORDER)]
    calls.clear()
    T.panel_chol(torch.from_numpy(F[:1]))
    assert len(calls) == len(T.panel_update_shapes(ORDER))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "floored"])
def test_lane_path_blocked_ldl_matches_vmap(signed):
    if signed:
        F, sgn = quasi_definite_stack(1, LANES, ORDER)
        jfn = jax.jit(jax.vmap(lambda f, s: J.blocked_ldl(f, sgn=s, floor=1e-6)))
        want_L, want_d = jfn(jnp.asarray(F), jnp.asarray(sgn))
        L, d = T.blocked_ldl(torch.from_numpy(F), sgn=torch.from_numpy(sgn), floor=1e-6,
                             lanes=True)
        assert np.array_equal(np.sign(d.numpy()), sgn)
    else:
        F = spd_stack(2, LANES, ORDER)
        want_L, want_d = jax.jit(jax.vmap(J.blocked_ldl))(jnp.asarray(F))
        L, d = T.blocked_ldl(torch.from_numpy(F), lanes=True)
    close(L, want_L)
    close(d, want_d)


class _Taken(Exception):
    pass


def test_stack_without_lanes_keeps_the_recursion(monkeypatch):
    """On a (2, 1030, 1030) stack each dispatcher takes the JAX package's
    recursion (or, for float32 `factor_inv_chol`, the library Cholesky)
    without `lanes`, as a plain 3-D call there does, and the panel form
    with `lanes`, as under `jax.vmap`: each route is stopped at its first
    step, so nothing is factored."""
    def stop(name):
        def fn(*args, **kwargs):
            raise _Taken(name)
        return fn

    for name in ("panel_ldl", "panel_chol", "panel_inv_unit_lower", "unblocked_ldl",
                 "_lib_cholesky"):
        monkeypatch.setattr(T, name, stop(name))
    F = torch.zeros((2, 1030, 1030), dtype=torch.float64)
    U = torch.eye(1030, dtype=torch.float64).expand(2, 1030, 1030)
    cases = [(lambda lanes: T.blocked_ldl(F, lanes=lanes), "unblocked_ldl", "panel_ldl"),
             (lambda lanes: T.factor_inv_chol(F, lanes=lanes), "unblocked_ldl", "panel_chol"),
             (lambda lanes: T.factor_inv_chol(F.float(), lanes=lanes), "_lib_cholesky",
              "panel_chol")]
    for call, plain, panel in cases:
        for lanes, route in ((False, plain), (True, panel)):
            with pytest.raises(_Taken, match=route):
                call(lanes)
    inv_unit_lower = T.inv_unit_lower
    monkeypatch.setattr(T, "inv_unit_lower", stop("recursion"))   # its recursive calls
    for lanes, route in ((False, "recursion"), (True, "panel_inv_unit_lower")):
        with pytest.raises(_Taken, match=route):
            inv_unit_lower(U, lanes=lanes)


@pytest.mark.parametrize("r,c,k", [(300, 200, 40), (37, 37, 5), (256, 256, 256)])
def test_k8_lane_axis_plain_matches_2d_calls(r, c, k):
    rng = np.random.default_rng(r + c + k)
    C = torch.from_numpy(rng.standard_normal((3, r, c)))
    B = torch.from_numpy(rng.standard_normal((3, r, k)))
    out = K8.syrk_update(C, B)
    for i in range(3):
        close(out[i], K8.syrk_update(C[i], B[i]), tol=1e-14)
    # in place on lane views of a larger stack, as panel_chol updates S[c1:, c1:]
    S = torch.from_numpy(rng.standard_normal((3, r + 5, c + 9)))
    Z = torch.from_numpy(rng.standard_normal((3, r + 5, k + 2)))
    want = S.clone()
    for i in range(3):
        K8.syrk_update(want[i, 5:, 9:], Z[i, 5:, 2:], out=want[i, 5:, 9:])
    K8.syrk_update(S[:, 5:, 9:], Z[:, 5:, 2:], out=S[:, 5:, 9:])
    close(S, want, tol=1e-14)
    with pytest.raises(ValueError):
        K8.syrk_update(C, B[0])


@pytest.mark.parametrize("floor", [0.0, 1e-6])
def test_ldl_blocks_matches_jax_blocked_ldl(floor):
    F, sgn = quasi_definite_stack(4, 3, 300)
    jfn = jax.jit(lambda f, s: J.blocked_ldl(f, sgn=s, floor=floor))
    want_L, want_d = jfn(jnp.asarray(F), jnp.asarray(sgn))
    L, d = T.ldl_blocks(torch.from_numpy(F), sgn=torch.from_numpy(sgn), floor=floor)
    close(L, want_L)
    close(d, want_d)
    assert np.array_equal(np.sign(d.numpy()), np.sign(np.asarray(want_d)))
    # a 2-D matrix takes the same route
    L0, d0 = T.ldl_blocks(torch.from_numpy(F[0]), sgn=torch.from_numpy(sgn[0]), floor=floor)
    assert torch.equal(L0, L[0]) and torch.equal(d0, d[0])
