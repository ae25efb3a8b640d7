"""The rest of the dense KKT layer against the JAX package: the condensed
system with the blocked backend (inverse Cholesky factors) and with
solve_mode="inverse" (explicit inverses), and the augmented K2 / K2.5
systems with the LU and the signed blocked LDL^T backends.

Identical inputs (NumPy, from a seed) reach both packages through
`convert.py`; factors and solves are compared at 1e-10 relative in float64
and 1e-4 in float32 (see tests/test_torch_kkt.py), and `factor_ok` must
agree on SPD / quasi-definite and on indefinite or singular inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madqp_tpu.ops import kkt as JKKT
from madqp_tpu.solver.state import ProblemArrays as JProb
from madqp_tpu_torch.convert import problem_arrays_from_numpy
from madqp_tpu_torch.ops import kkt as TKKT

TOL = {None: 1e-10, "float32": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run the port's side single-threaded: the suite runs one process per
    core under xdist, and torch's default of a thread per core in every
    process oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_system(seed, n=30, m=12, lp=False):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, n)) / np.sqrt(n)
    fields = dict(
        c0=np.asarray(0.0), c=rng.standard_normal(n),
        H=None if lp else P @ P.T,
        A=rng.standard_normal((m, n)) / np.sqrt(n),
        b=rng.standard_normal(m),
        has_lb=rng.random(n) < 0.7, has_ub=rng.random(n) < 0.5,
    )
    pr_diag = 10.0 ** rng.uniform(-3, 3, size=n)  # barrier-like spread
    rx, ry = rng.standard_normal(n), rng.standard_normal(m)
    return fields, pr_diag, rx, ry


def close(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    scale = np.max(np.abs(want), initial=0.0)
    err = np.max(np.abs(got.astype(np.float64) - want), initial=0.0)
    assert err <= tol * scale, f"{what}: {err:.3e} vs scale {scale:.3e}"


def run_both(kind, fields, pr_diag, del_c, jit=False, **kw):
    """(JAX kkt, JAX factors, port kkt, port factors)."""
    jk = JKKT.make_kkt(kind, **kw)
    tk = TKKT.make_kkt(kind, **kw)
    jprob = JProb(**{k: (None if v is None else jnp.asarray(v))
                     for k, v in fields.items()})
    factorize = jax.jit(jk.factorize) if jit else jk.factorize
    jf = factorize(jprob, jnp.asarray(pr_diag), jnp.asarray(del_c))
    tf = tk.factorize(problem_arrays_from_numpy(fields, device="cpu"),
                      torch.from_numpy(pr_diag),
                      torch.tensor(del_c, dtype=torch.float64))
    return jk, jf, tk, tf


def check_solve(jk, jf, tk, tf, rx, ry, tol):
    assert bool(jk.factor_ok(jf)) and bool(tk.factor_ok(tf))
    jdx, jdy = jk.solve(jf, jnp.asarray(rx), jnp.asarray(ry))
    tdx, tdy = tk.solve(tf, torch.from_numpy(rx), torch.from_numpy(ry))
    assert tdx.dtype == tdy.dtype == torch.float64
    close(tdx, jdx, tol, "dx")
    close(tdy, jdy, tol, "dy")


def check_fields(jf, tf, names, fact_dtype):
    for name in names:
        j, t = getattr(jf, name), getattr(tf, name)
        if j is None:
            assert t is None, name
            continue
        assert t is not None, name
        close(t, j, TOL[fact_dtype], name)


@pytest.mark.parametrize("lp", [False, True])
@pytest.mark.parametrize("fact_dtype", [None, "float32"])
@pytest.mark.parametrize("mode", ["blocked", "inverse"])
def test_condensed_matches_reference(mode, fact_dtype, lp):
    fields, pr_diag, rx, ry = make_system(seed=11 if lp else 12, lp=lp)
    kw = (dict(chol_backend="blocked") if mode == "blocked"
          else dict(solve_mode="inverse"))
    jk, jf, tk, tf = run_both("condensed", fields, pr_diag, -1e-8,
                              fact_dtype=fact_dtype, **kw)
    check_fields(jf, tf, ("chol_W", "w_scale", "chol_S", "s_scale", "W_iL",
                          "S_iL", "W_inv", "S_inv"), fact_dtype)
    check_solve(jk, jf, tk, tf, rx, ry, TOL[fact_dtype])


def test_condensed_blocked_panel_regime():
    """W of order 1100 takes panel_chol (its K8 updates run the plain
    version here) and panel_inv_lower; S of order 40 the library route."""
    fields, pr_diag, rx, ry = make_system(seed=13, n=1100, m=40)
    jk, jf, tk, tf = run_both("condensed", fields, pr_diag, -1e-8, jit=True,
                              fact_dtype="float32", chol_backend="blocked")
    check_fields(jf, tf, ("chol_W", "W_iL", "chol_S", "S_iL"), "float32")
    check_solve(jk, jf, tk, tf, rx, ry, TOL["float32"])


@pytest.mark.parametrize("fact_dtype", [None, "float32"])
@pytest.mark.parametrize("backend", ["xla", "blocked"])
@pytest.mark.parametrize("kind", ["k2", "k2.5"])
def test_augmented_matches_reference(kind, backend, fact_dtype):
    fields, pr_diag, rx, ry = make_system(seed=14)
    jk, jf, tk, tf = run_both(kind, fields, pr_diag, -1e-8,
                              fact_dtype=fact_dtype, chol_backend=backend)
    assert type(tf).__name__ == type(jf).__name__
    if backend == "blocked":
        check_fields(jf, tf, ("iLu", "d", "sgn", "scale"), fact_dtype)
    else:
        check_fields(jf, tf, ("lu",) + (("scale",) if kind == "k2.5" else ()),
                     fact_dtype)
    check_solve(jk, jf, tk, tf, rx, ry, TOL[fact_dtype])


@pytest.mark.parametrize("case", [
    "condensed-blocked/W_indefinite", "condensed-blocked/S_indefinite",
    "k2-blocked/wrong_inertia", "k2.5-blocked/wrong_inertia",
    "k2/singular", "k2.5/singular",
])
def test_factor_ok_false_on_bad_systems(case):
    kind, what = case.split("/")
    fields, pr_diag, _, _ = make_system(seed=15)
    del_c = -1e-8
    if what == "W_indefinite":
        fields["H"] = -2.0 * np.eye(len(pr_diag))
        pr_diag = np.ones_like(pr_diag)
    elif what == "S_indefinite":
        del_c = 1e6
    elif what == "wrong_inertia":
        del_c = 1e6  # the constraint pivots come out positive
    else:  # an LP whose augmented matrix has a zero row and column
        fields["H"] = None
        fields["A"][:, 0] = 0.0
        pr_diag[0] = 0.0
    base, _, blocked = kind.partition("-")
    kw = dict(chol_backend="blocked") if blocked else {}
    jk, jf, tk, tf = run_both(base, fields, pr_diag, del_c, **kw)
    got = tk.factor_ok(tf)
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) is bool(jk.factor_ok(jf)) is False
