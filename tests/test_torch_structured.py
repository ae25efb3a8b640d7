"""The two-stage Schur-complement solver: the port
(`madqp_tpu_torch.parallel.structured`) against the JAX package
(`madqp_tpu.parallel.structured`) on the same NumPy-made problems, on the
CPU.

* `random_two_stage` gives bit-equal arrays in both packages, and
  `two_stage_from_numpy` carries the JAX problem across bit for bit.
* `hess_mv` / `jac_mv` / `jac_rmv` agree to 1e-14.
* One `SchurKKT.factorize` + `solve` from identical (pr_diag, del_c, rx,
  ry) agrees to 1e-10 (relative to the largest entry of the step), for a
  QP, an LP and m0 = 0, with `dense` and `pallas` (K1's plain version on
  the CPU); `factor_ok` agrees, also on a factor that fails.
* The cases of tests/test_structured.py run through both `solve_two_stage`s
  with both backends: same status; iterations equal in float64 and within
  1 under the float32 factorization; objective within 1e-8 relative;
  solution within 1e-7.  The flat oracle cases also hold the port against
  its own flat `solve` of `two_stage_to_flat_qp(...)` with the tolerances
  of tests/test_structured.py.
"""

import functools

import numpy as np
import pytest
import torch

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.parallel import structured as JS
from madqp_tpu_torch.ops import pallas_chol as K1
from madqp_tpu_torch.ops.kkt import make_kkt
from madqp_tpu_torch.parallel import structured as TS

# random_two_stage arguments of tests/test_structured.py's cases
PROBLEMS = {
    "qp": dict(n0=6, ns=5, ms=3, m0=2, N=8, seed=1, qp=True),
    "lp": dict(n0=6, ns=5, ms=3, m0=2, N=8, seed=1, qp=False),
    "mixed": dict(n0=6, ns=5, ms=3, m0=2, N=8, seed=5),
    "m0_zero": dict(n0=5, ns=4, ms=3, m0=0, N=4, seed=7),
}
MIXED = dict(factorization_dtype="float32", max_refine_steps=1, max_iter=60)
BACKENDS = ("dense", "pallas")


def jax_problem(name):
    return JS.random_two_stage(**PROBLEMS[name])


def torch_problem(name):
    return TS.random_two_stage(**PROBLEMS[name], device="cpu")


def host(v):
    return None if v is None else np.asarray(v)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_random_two_stage_bit_equal(name):
    jp, jlb, jub = jax_problem(name)
    tp, tlb, tub = torch_problem(name)
    for field in JS.TwoStageProblem._fields:
        want, got = host(getattr(jp, field)), getattr(tp, field)
        if want is None:
            assert got is None, field
            continue
        assert got.device.type == "cpu", field
        assert np.array_equal(got.numpy(), want), field
    assert np.array_equal(tlb.numpy(), np.asarray(jlb))
    assert np.array_equal(tub.numpy(), np.asarray(jub))
    carried = mt.two_stage_from_numpy({f: host(getattr(jp, f)) for f in jp._fields},
                                      device="cpu")
    for got, want in zip(carried, tp):
        assert (got is None and want is None) or torch.equal(got, want)
    for attr in ("n0", "m0", "N", "ns", "ms", "n", "m", "is_lp"):
        assert getattr(tp, attr) == getattr(jp, attr), attr


@pytest.mark.parametrize("name", ["qp", "lp", "m0_zero"])
def test_matvecs_match(name):
    jp, _, _ = jax_problem(name)
    tp, _, _ = torch_problem(name)
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(tp.n), rng.standard_normal(tp.m)
    for method, v in (("hess_mv", x), ("jac_mv", x), ("jac_rmv", y)):
        want = np.asarray(getattr(jp, method)(v))
        got = getattr(tp, method)(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14 * np.abs(want).max(),
                                   err_msg=method)


def kkt_inputs(prob, seed, bad=False):
    """pr_diag (positive; one scenario entry negative with `bad`), del_c,
    rx and ry as NumPy arrays."""
    rng = np.random.default_rng(seed)
    pr_diag = rng.uniform(0.5, 2.0, prob.n)
    if bad:
        pr_diag[prob.n0 + 1] = -50.0
    return pr_diag, -1e-8, rng.standard_normal(prob.n), rng.standard_normal(prob.m)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["qp", "lp", "m0_zero"])
def test_schur_factorize_solve_matches(name, backend):
    jp, _, _ = jax_problem(name)
    tp, _, _ = torch_problem(name)
    pr_diag, del_c, rx, ry = kkt_inputs(tp, seed=len(name))
    jk = JS.SchurKKT()
    jf = jk.factorize(jp, pr_diag, del_c)
    want = jk.solve(jf, rx, ry)
    tk = make_kkt("schur", chol_backend=backend)
    tf = tk.factorize(tp, torch.from_numpy(pr_diag), torch.tensor(del_c, dtype=torch.float64))
    got = tk.solve(tf, torch.from_numpy(rx), torch.from_numpy(ry))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10 * np.abs(w).max())
    ok = tk.factor_ok(tf)
    assert ok.dim() == 0 and ok.dtype == torch.bool
    assert bool(ok) is bool(jk.factor_ok(jf)) is True


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["qp", "lp"])
def test_schur_factor_ok_on_a_failed_factor(name, backend):
    """A negative scenario entry of pr_diag: U (or the LP's diagonal) is
    not positive definite; both packages' factor_ok say so."""
    jp, _, _ = jax_problem(name)
    tp, _, _ = torch_problem(name)
    pr_diag, del_c, _, _ = kkt_inputs(tp, seed=2, bad=True)
    want = JS.SchurKKT().factor_ok(JS.SchurKKT().factorize(jp, pr_diag, del_c))
    tk = make_kkt("schur", chol_backend=backend)
    got = tk.factor_ok(tk.factorize(tp, torch.from_numpy(pr_diag),
                                    torch.tensor(del_c, dtype=torch.float64)))
    assert bool(got) is bool(want) is False


def test_schur_backend_reaches_every_factor():
    """Under "pallas" the scenario stacks and the first stage take K1
    (`cholesky_lower`); under any other backend the library Cholesky."""
    pallas = make_kkt("schur", chol_backend="pallas")
    assert pallas._chol is pallas._dense._chol is K1.cholesky_lower
    for backend in ("xla", "blocked"):
        other = make_kkt("schur", chol_backend=backend)
        assert other._chol is other._dense._chol is K1.dense_cholesky
    assert make_kkt("schur", fact_dtype="float32")._dense.fact_dtype == torch.float32


@functools.lru_cache(maxsize=None)
def jax_solve(name):
    jp, jlb, jub = jax_problem(name)
    opts = MIXED if name == "mixed" else {}
    return JS.solve_two_stage(jp, jlb, jub, print_level=40, **opts)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_two_stage_matches_jax(name, backend):
    want = jax_solve(name)
    tp, tlb, tub = torch_problem(name)
    opts = MIXED if name == "mixed" else {}
    got = mt.solve_two_stage(tp, tlb, tub, device="cpu", print_level=40,
                             linear_solver=backend, **opts)
    assert int(got.status) == int(want.status) == int(mq.Status.SOLVE_SUCCEEDED)
    assert abs(got.iter - want.iter) <= (1 if name == "mixed" else 0)
    assert got.objective == pytest.approx(want.objective, rel=1e-8)
    np.testing.assert_allclose(got.solution, np.asarray(want.solution), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.constraints, np.asarray(want.constraints),
                               rtol=0, atol=1e-7)
    assert got.counters.k == got.iter and got.counters.total_time > 0
    assert got.options.kkt_system == "schur"


@pytest.mark.parametrize("name", ["qp", "lp", "m0_zero"])
def test_matches_flat_dense_oracle(name):
    """tests/test_structured.py's oracle in the port: the flat QP of
    `two_stage_to_flat_qp` (the same matrices as the JAX package's)
    through the port's own dense `solve`."""
    jp, jlb, jub = jax_problem(name)
    tp, tlb, tub = torch_problem(name)
    flat = TS.two_stage_to_flat_qp(tp, tlb, tub)
    jflat = JS.two_stage_to_flat_qp(jp, jlb, jub)
    for field in ("c", "lcon", "ucon", "lvar", "uvar"):
        assert np.array_equal(getattr(flat, field), getattr(jflat, field)), field
    assert (flat.A != jflat.A).nnz == 0
    assert (flat.H is None) is (jflat.H is None)
    assert flat.H is None or (flat.H != jflat.H).nnz == 0

    stats = mt.solve_two_stage(tp, tlb, tub, device="cpu", print_level=40)
    ref = mt.solve(flat, device="cpu", print_level=40, scaling=False)
    assert stats.success and ref.success
    assert stats.objective == pytest.approx(ref.objective, abs=1e-6)
    if name != "m0_zero":  # tests/test_structured.py compares these two only
        assert stats.iter == ref.iter
        np.testing.assert_allclose(stats.solution, ref.solution, atol=1e-5)


def test_mesh_raises_naming_the_roadmap_item():
    """mesh= is ported (tests/test_torch_mesh.py runs it over ranks); a mesh
    that is not a torch.distributed DeviceMesh raises TypeError."""
    tp, tlb, tub = torch_problem("qp")
    with pytest.raises(TypeError, match="DeviceMesh"):
        mt.solve_two_stage(tp, tlb, tub, mesh=object(), device="cpu")

