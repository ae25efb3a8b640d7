"""The supernodal sparse Cholesky (madqp_tpu_torch.ops.sparse_chol) against
the JAX package's `madqp_tpu/ops/sparse_chol.py`, case by case after
tests/test_sparse_chol.py, on the CPU (the fronts' K1 runs the plain twin
of the route the card takes).

* The host symbolic phase: `analyze` and `analyze_batched` bit-equal to
  the reference's (permutation, supernodes, schedule items and every
  index array) on random, banded, grid and netflow patterns, under the
  orderings amd, rcm, nd and auto and the greedy and level schedulers
  (level gives `_Chain` items).
* The numeric phase: `factorize_batched` panels within 1e-12 of the
  reference's relative to each panel's largest entry (float64, with and
  without stored inverses), `solve_batched` solutions within 1e-10 and
  residuals at float64 rounding; `factor_ok_batched` false on an
  indefinite input in both; the pivot-floored LDL^T (panels, pivots,
  solves) against the reference's; the per-supernode `factorize` / `solve`
  on tests/test_sparse_chol.py's residual cases; the cap
  (`ScheduleTooLargeError`) under a lowered MADQP_MAX_UPDATE_ENTRIES; two
  factorizations bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.ops import sparse_chol as J
from madqp_tpu_torch.ops import sparse_chol as T

PANEL_RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread per module (tests/test_torch_pipeline.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def random_spd(n, density, seed=3):
    M = sp.random(n, n, density=density, random_state=seed)
    return (M @ M.T + 10 * sp.eye(n)).tocsc()


def banded_spd(n, bw=4):
    diags = [np.full(n - k, 1.0 / (1 + k)) for k in range(bw)]
    B = sp.diags(diags, list(range(bw)), shape=(n, n))
    S = B + B.T
    return (S + (abs(S).sum(axis=1).A1.max() + 1) * sp.eye(n)).tocsc()


def normal_matrix(qp):
    """S = A A' + I of a generator's LP (the mesh families' test)."""
    A = sp.csr_matrix(qp.A)
    return (A @ A.T).tocsc() + sp.identity(A.shape[0], format="csc")


PATTERNS = {
    "random": lambda: random_spd(300, 0.02, seed=7),
    "banded": lambda: banded_spd(1500, bw=5),
    "grid": lambda: normal_matrix(mq.grid_lp(12)),
    "netflow": lambda: normal_matrix(mq.netflow_grid_lp(10)),
}


def _same_fields(a, b, where):
    assert type(a).__name__ == type(b).__name__, where
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), (where, f.name)
        elif dataclasses.is_dataclass(x):
            _same_fields(x, y, f"{where}.{f.name}")
        elif isinstance(x, list):
            assert len(x) == len(y), (where, f.name)
            for k, (u, v) in enumerate(zip(x, y)):
                if dataclasses.is_dataclass(u):
                    _same_fields(u, v, f"{where}.{f.name}[{k}]")
                else:
                    assert np.array_equal(u, v), (where, f.name, k)
        else:
            assert x == y, (where, f.name, x, y)


@pytest.mark.parametrize("mode", ["greedy", "level"])
@pytest.mark.parametrize("order", ["amd", "rcm", "nd", "auto"])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_schedule_bit_equal_to_reference(pattern, order, mode):
    A = PATTERNS[pattern]()
    want = J.analyze_batched(A, order=order, schedule_mode=mode)
    got = T.analyze_batched(A, order=order, schedule_mode=mode)
    _same_fields(got, want, f"{pattern}/{order}/{mode}")
    assert T.schedule_cost(got) == J.schedule_cost(want)
    np.testing.assert_array_equal(got.permute_values(A), want.permute_values(A))


@pytest.mark.parametrize("order", ["amd", "rcm", "nd", "auto"])
@pytest.mark.parametrize("pattern", ["random", "banded", "grid"])
def test_analyze_bit_equal_to_reference(pattern, order):
    A = PATTERNS[pattern]()
    want, got = J.analyze(A, order=order), T.analyze(A, order=order)
    _same_fields(got, want, f"{pattern}/{order}")
    cols = np.concatenate([sn.cols for sn in got.supernodes])
    assert sorted(cols.tolist()) == list(range(A.shape[0]))
    for s, sn in enumerate(got.supernodes):
        assert sn.parent == -1 or sn.parent > s
        assert all(c < s for c in sn.child_ids)


def _reference_factor(bs, vals, inverse):
    return jax.jit(lambda v: J.factorize_batched(bs, v, inverse=inverse))(jnp.asarray(vals))


def _close_panels(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=PANEL_RTOL * np.abs(w).max())


# (pattern, order, schedule mode): a greedy schedule with buckets and
# scans, a level one with chains, and nested dissection on a mesh.
NUMERIC = [("random", "amd", "greedy"), ("banded", "rcm", "level"),
           ("grid", "nd", "greedy")]


@pytest.mark.parametrize("inverse", [False, True], ids=["chol", "inverse"])
@pytest.mark.parametrize("pattern,order,mode", NUMERIC,
                         ids=["-".join(c) for c in NUMERIC])
def test_factorize_and_solve_batched_match_reference(pattern, order, mode, inverse):
    A = PATTERNS[pattern]()
    bj = J.analyze_batched(A, order=order, schedule_mode=mode)
    bt = T.analyze_batched(A, order=order, schedule_mode=mode)
    vals = bt.permute_values(A)
    pj = _reference_factor(bj, vals, inverse)
    pt = T.factorize_batched(bt, torch.as_tensor(vals), inverse=inverse)
    _close_panels(pt, pj)
    assert bool(T.factor_ok_batched(pt)) and bool(J.factor_ok_batched(pj))
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    x = T.solve_batched(bt, pt, torch.as_tensor(b), inverse=inverse).numpy()
    xj = np.asarray(J.solve_batched(bj, pj, jnp.asarray(b), inverse=inverse))
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    assert np.abs(A @ x - b).max() < 1e-10
    # a second factorization of the same values: the same bits
    again = T.factorize_batched(bt, torch.as_tensor(vals), inverse=inverse)
    assert all(torch.equal(u, v) for u, v in zip(pt, again))


def test_factor_ok_false_on_an_indefinite_input():
    A = random_spd(300, 0.02, seed=7)
    A = (A - 40 * sp.eye(300)).tocsc()   # some fronts lose positive definiteness
    bj = J.analyze_batched(A, order="amd")
    bt = T.analyze_batched(A, order="amd")
    vals = bt.permute_values(A)
    assert not bool(J.factor_ok_batched(_reference_factor(bj, vals, False)))
    assert not bool(T.factor_ok_batched(T.factorize_batched(bt, torch.as_tensor(vals))))


def _quasidefinite(chain=False, n=600, m=300, seed=1):
    """tests/test_sparse_chol.py's quasi-definite K = [W A'; A -1e-4 I]:
    its greedy case, or (chain) the banded one whose level schedule has
    chains."""
    rng = np.random.default_rng(seed)
    if chain:
        rows = np.repeat(np.arange(m), 3)
        cols = np.minimum(2 * rows + np.tile(np.arange(3), m), n - 1)
        A = sp.coo_matrix((rng.uniform(0.5, 2.0, rows.size), (rows, cols)),
                          shape=(m, n)).tocsc()
        A.sum_duplicates()
    else:
        rows = np.repeat(np.arange(m), 2)
        cols = np.concatenate([np.arange(m) * 2 % n, (np.arange(m) * 2 + 1) % n])
        cols = cols.reshape(2, m).T.reshape(-1)
        A = sp.coo_matrix((rng.uniform(0.5, 2.0, rows.size), (rows, cols)),
                          shape=(m, n)).tocsc()
    W = sp.diags(rng.uniform(0.5, 2.0, n))
    K = sp.bmat([[W, A.T], [A, -1e-4 * sp.eye(m)]], format="csc")
    return K, np.concatenate([np.ones(n), -np.ones(m)])


@pytest.mark.parametrize("mode,floor,inverse", [("greedy", 1e-10, True), ("level", 0.0, False)],
                         ids=["greedy-floored-inverse", "level-chains"])
def test_floored_ldl_matches_reference(mode, floor, inverse):
    K, sg = _quasidefinite(chain=mode == "level")
    bj = J.analyze_batched(K, order="amd", schedule_mode=mode)
    bt = T.analyze_batched(K, order="amd", schedule_mode=mode)
    _same_fields(bt, bj, mode)
    if mode == "level":
        assert any(isinstance(it, T._Chain) for it in bt.schedule)
    vals = bt.permute_values(K)
    signs_j, signs_t = J.bucket_signs(bj, sg), T.bucket_signs(bt, sg)
    assert all(np.array_equal(u, v) for u, v in zip(signs_t, signs_j))
    fj = jax.jit(lambda v: J.factorize_batched_ldl(bj, v, signs=signs_j, pivot_floor=floor,
                                                   inverse=inverse))(jnp.asarray(vals))
    ft = T.factorize_batched_ldl(bt, torch.as_tensor(vals), signs=signs_t, pivot_floor=floor,
                                 inverse=inverse)
    _close_panels(ft[0], fj[0])
    _close_panels(ft[1], fj[1])
    _close_panels([ft[2]], [fj[2]])
    assert bool(T.factor_ok_batched_ldl(ft, signs_t)) and bool(J.factor_ok_batched_ldl(fj, signs_j))
    b = np.random.default_rng(2).standard_normal(K.shape[0])
    x = T.solve_batched_ldl(bt, ft, torch.as_tensor(b), inverse=inverse).numpy()
    xj = np.asarray(J.solve_batched_ldl(bj, fj, jnp.asarray(b), inverse=inverse))
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-9 * np.abs(xj).max())
    assert np.abs(K @ x - b).max() < 1e-6
    # the wrong inertia is reported
    flipped = [-s for s in signs_t]
    assert not bool(T.factor_ok_batched_ldl(ft, flipped))


def test_dense_ldl_matches_reference():
    rng = np.random.default_rng(4)
    F = rng.standard_normal((5, 40, 40))
    F = F @ F.transpose(0, 2, 1) + 40 * np.eye(40)
    sgn = np.ones((5, 40))
    Lj, dj = J.dense_ldl(jnp.asarray(F), sgn=jnp.asarray(sgn), floor=1e-6)
    Lt, dt = T.dense_ldl(torch.as_tensor(F), sgn=torch.as_tensor(sgn), floor=1e-6)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=0, atol=1e-13)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-13)


@pytest.mark.parametrize("make,kw", [
    (random_spd, dict(n=60, density=0.08)),
    (random_spd, dict(n=200, density=0.03)),
    (banded_spd, dict(n=300)),
], ids=["rand60", "rand200", "banded300"])
def test_per_supernode_solve_residual(make, kw):
    """tests/test_sparse_chol.py's TestNumeric cases: one front at a time
    (`DeviceSparseCholesky`), against the reference's solution."""
    A = make(**kw)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    f = T.DeviceSparseCholesky(A, device="cpu").factorize(A)
    x = f.solve(b).numpy()
    assert np.max(np.abs(A @ x - b)) < 1e-10
    if A.shape[0] <= 60 or make is banded_spd:
        # the reference's one-front-at-a-time trace takes ~15 s to compile
        # at rand200 on the CPU: compared on the other two cases
        g = J.DeviceSparseCholesky(A).factorize(A)
        np.testing.assert_allclose(x, np.asarray(g.solve(jnp.asarray(b))), rtol=1e-10,
                                   atol=1e-12)
        _close_panels(f.panels, g.panels)
    else:
        np.testing.assert_allclose(x, np.linalg.solve(A.toarray(), b), rtol=1e-9, atol=1e-10)
    for scale in (3.0, 0.25):   # one symbolic analysis, new values
        A2 = (A * scale).tocsc()
        x = f.factorize(A2).solve(b).numpy()
        assert np.max(np.abs(A2 @ x - b)) < 1e-9


@pytest.mark.parametrize("batched", [True, False], ids=["analyze_batched", "analyze"])
def test_schedule_cap_raises_as_reference(batched, monkeypatch):
    A = PATTERNS["grid"]()
    monkeypatch.setenv("MADQP_MAX_UPDATE_ENTRIES", "500")
    for pkg in (J, T):
        with pytest.raises(pkg.ScheduleTooLargeError, match="MADQP_MAX_UPDATE_ENTRIES"):
            if batched:
                pkg.analyze_batched(A, order="amd")
            else:
                pkg.analyze(A, order="amd")


def test_device_schedule_drops_scratch_and_sorts():
    """The rearranged index arrays: every front position assembled once,
    its sources in ascending position order, none to a scratch slot."""
    A = PATTERNS["random"]()
    bs = T.analyze_batched(A, order="amd")
    ds = T.device_schedule(bs, "cpu")
    assert T.device_schedule(bs, "cpu") is ds
    for item, steps in zip(bs.schedule, ds.items):
        for st in steps:
            r = st.w_pad + st.u_pad
            u = st.udst.numpy()
            assert (np.diff(u) > 0).all() and u.max() < st.count * r * r
            assert int(st.seg_len.sum()) == st.src.numel()
            assert (st.src.numpy() < ds.size).all()


def test_entry_points_default_to_cuda():
    import inspect

    assert inspect.signature(T.DeviceSparseCholesky).parameters["device"].default == "cuda"
    assert mt.ops.pallas_chol.H100_BATCHED_MAX_N[torch.float64] == 163


def _lane_values(v0, lanes=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([v0 * (1.0 + 0.1 * rng.random(v0.shape)) for _ in range(lanes)])


# (pattern, order, schedule mode, signed): buckets and scans, a level
# schedule's chains, and the signed LDL^T with chains.
LANES = [("random", "amd", "greedy", False), ("banded", "rcm", "level", False),
         ("chain-kkt", "amd", "level", True)]


@pytest.mark.parametrize("inverse", [False, True], ids=["chol", "inverse"])
@pytest.mark.parametrize("pattern,order,mode,signed", LANES,
                         ids=["-".join(c[:3]) for c in LANES])
def test_lane_axis_matches_vmapped_reference(pattern, order, mode, signed, inverse):
    """Values (B, n_a) of one pattern: every front stack holds all lanes'
    fronts, and the factors, the per-lane factor_ok flags and the solves of
    (B, n) right-hand sides equal `jax.vmap` of the reference's; each lane's
    factor is the single instance's, bit for bit (the chains' carried
    update kept per lane)."""
    if signed:
        A, sg = _quasidefinite(chain=True)
    else:
        A = PATTERNS[pattern]()
    bj = J.analyze_batched(A, order=order, schedule_mode=mode)
    bt = T.analyze_batched(A, order=order, schedule_mode=mode)
    vals = _lane_values(bt.permute_values(A))
    b = np.random.default_rng(4).standard_normal(vals.shape[:1] + A.shape[:1])
    if signed:
        sj, st = J.bucket_signs(bj, sg), T.bucket_signs(bt, sg)

        def jfac(v):
            return J.factorize_batched_ldl(bj, v, signs=sj, pivot_floor=1e-10, inverse=inverse)

        def tfac(v):
            return T.factorize_batched_ldl(bt, v, signs=st, pivot_floor=1e-10, inverse=inverse)
        jsolve, tsolve = J.solve_batched_ldl, T.solve_batched_ldl
        jok, tok = (lambda f: J.factor_ok_batched_ldl(f, sj)), (lambda f: T.factor_ok_batched_ldl(f, st))
    else:
        def jfac(v):
            return J.factorize_batched(bj, v, inverse=inverse)

        def tfac(v):
            return T.factorize_batched(bt, v, inverse=inverse)
        jsolve, tsolve = J.solve_batched, T.solve_batched
        jok, tok = J.factor_ok_batched, (lambda f: T.factor_ok_batched(f, lanes=(3,)))
    fj = jax.jit(jax.vmap(jfac))(jnp.asarray(vals))
    ft = tfac(torch.as_tensor(vals))
    panels_t, panels_j = (ft[0], fj[0]) if signed else (ft, fj)
    _close_panels(panels_t, panels_j)
    assert tok(ft).tolist() == np.asarray(jax.vmap(jok)(fj)).tolist() == [True] * 3
    x = tsolve(bt, ft, torch.as_tensor(b), inverse=inverse).numpy()
    xj = np.asarray(jax.vmap(lambda f, r: jsolve(bj, f, r, inverse=inverse))(fj, jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-9 * np.abs(xj).max())
    for i in range(3):
        one = tfac(torch.as_tensor(vals[i]))
        one = one[0] if signed else one
        assert all(torch.equal(p[i], q) for p, q in zip(panels_t, one))
    # one lane's failed factorization is flagged in that lane only (a NaN
    # value: the floored pivots keep their signs whatever the values)
    bad = vals.copy()
    bad[1, :] = np.nan
    assert tok(tfac(torch.as_tensor(bad))).tolist() == [True, False, True]
