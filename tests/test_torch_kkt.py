"""Dense condensed / normal KKT: the port against the JAX package.

Factorize and solve on random SPD systems (QP and LP), for both factor
backends (library Cholesky, and K1 — interpret-mode Pallas on the JAX side,
the plain version on the port's CPU side) and both factorization dtypes.

Tolerances, relative to the largest magnitude of each output: 1e-10 for a
float64 factorization; 1e-4 for float32 factors and solves (two float32
factorizations agree to a few units of 6e-8 times the growth of the
scaled, well-conditioned test matrices).
"""

import numpy as np
import pytest
import torch

from madqp_tpu.ops import kkt as JKKT
from madqp_tpu.ops.kernels import KKTVec as JVec
from madqp_tpu.solver.state import ProblemArrays as JProb
from madqp_tpu_torch.convert import problem_arrays_from_numpy
from madqp_tpu_torch.ops import kkt as TKKT
from madqp_tpu_torch.ops.kernels import KKTVec as TVec

N, M = 30, 12
TOL = {None: 1e-10, "float32": 1e-4}


def make_system(seed, lp=False, n=N, m=M):
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


def jax_prob(fields):
    import jax.numpy as jnp

    return JProb(**{k: (None if v is None else jnp.asarray(v))
                    for k, v in fields.items()})


def close(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.max(np.abs(want), initial=0.0)
    assert np.max(np.abs(got.astype(np.float64) - want), initial=0.0) <= tol * scale, what


@pytest.mark.parametrize("lp", [False, True])
@pytest.mark.parametrize("fact_dtype", [None, "float32"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_factorize_and_solve_match_reference(backend, fact_dtype, lp):
    fields, pr_diag, rx, ry = make_system(seed=3 if lp else 4, lp=lp)
    del_c = -1e-8
    jk = JKKT.DenseCondensedKKT(fact_dtype=fact_dtype, chol_backend=backend)
    tk = TKKT.DenseCondensedKKT(fact_dtype=fact_dtype, chol_backend=backend)
    jf = jk.factorize(jax_prob(fields), pr_diag, del_c)
    tf = tk.factorize(problem_arrays_from_numpy(fields, device="cpu"), torch.from_numpy(pr_diag),
                      torch.tensor(del_c, dtype=torch.float64))
    tol = TOL[fact_dtype]
    for name in ("chol_W", "w_scale", "chol_S", "s_scale", "w_diag"):
        j, t = getattr(jf, name), getattr(tf, name)
        if j is None:
            assert t is None, name
            continue
        assert t.dtype == (torch.float32 if fact_dtype and name.startswith("chol")
                           else torch.float64), name
        close(t, j, tol, name)
    assert bool(jk.factor_ok(jf)) and bool(tk.factor_ok(tf))
    jdx, jdy = jk.solve(jf, rx, ry)
    tdx, tdy = tk.solve(tf, torch.from_numpy(rx), torch.from_numpy(ry))
    assert tdx.dtype == tdy.dtype == torch.float64
    close(tdx, jdx, tol, "dx")
    close(tdy, jdy, tol, "dy")


@pytest.mark.parametrize("case", ["W_indefinite", "S_indefinite", "lp_negative_diag"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_non_spd_gives_factor_ok_false(backend, case):
    fields, pr_diag, _, _ = make_system(seed=5, lp=case == "lp_negative_diag")
    del_c = -1e-8
    if case == "W_indefinite":
        fields["H"] = -2.0 * np.eye(N)
        pr_diag = np.ones(N)
    elif case == "S_indefinite":
        del_c = 1e6
    else:
        pr_diag[3] = -1.0
    jk = JKKT.DenseCondensedKKT(chol_backend=backend)
    tk = TKKT.DenseCondensedKKT(chol_backend=backend)
    want = bool(jk.factor_ok(jk.factorize(jax_prob(fields), pr_diag, del_c)))
    got = tk.factor_ok(tk.factorize(problem_arrays_from_numpy(fields, device="cpu"),
                                    torch.from_numpy(pr_diag),
                                    torch.tensor(del_c, dtype=torch.float64)))
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == want is False


def test_normal_kkt_rejects_qp_and_matches_on_lp():
    fields, pr_diag, rx, ry = make_system(seed=6)
    with pytest.raises(ValueError, match="linear programs"):
        TKKT.DenseNormalKKT().factorize(problem_arrays_from_numpy(fields, device="cpu"),
                                        torch.from_numpy(pr_diag), 0.0)
    fields["H"] = None
    jk, tk = JKKT.DenseNormalKKT(), TKKT.make_kkt("normal")
    assert isinstance(tk, TKKT.DenseNormalKKT)
    jf = jk.factorize(jax_prob(fields), pr_diag, -1e-8)
    tf = tk.factorize(problem_arrays_from_numpy(fields, device="cpu"), torch.from_numpy(pr_diag),
                      torch.tensor(-1e-8, dtype=torch.float64))
    close(tf.chol_S, jf.chol_S, 1e-10, "chol_S")
    for got, want in zip(tk.solve(tf, torch.from_numpy(rx), torch.from_numpy(ry)),
                         jk.solve(jf, rx, ry)):
        close(got, want, 1e-10, "solve")


def test_kkt_mul_matches_reference():
    fields, _, _, _ = make_system(seed=7)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, N)
    lb, ub = x - rng.uniform(0.1, 1, N), x + rng.uniform(0.1, 1, N)
    zl = np.where(fields["has_lb"], rng.uniform(0.1, 1, N), 0.0)
    zu = np.where(fields["has_ub"], rng.uniform(0.1, 1, N), 0.0)
    v = [rng.standard_normal(N), rng.standard_normal(M),
         rng.standard_normal(N), rng.standard_normal(N)]
    args = (1e-8, -1e-8, x, lb, ub, fields["has_lb"], fields["has_ub"], zl, zu)
    want = JKKT.kkt_mul(jax_prob(fields), *args, JVec(*v))
    t_args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    got = TKKT.kkt_mul(problem_arrays_from_numpy(fields, device="cpu"), *t_args,
                       TVec(*(torch.from_numpy(a) for a in v)))
    for g, w in zip(got, want):
        close(g, w, 1e-13, "kkt_mul")


def test_make_kkt_names():
    assert TKKT.make_kkt("condensed").name == "condensed"
    assert TKKT.make_kkt("k2").name == "k2"
    assert TKKT.make_kkt("k2.5").name == "k2.5"
    with pytest.raises(ValueError, match="unknown kkt_system") as got:
        TKKT.make_kkt("nope")
    with pytest.raises(ValueError, match="unknown kkt_system") as want:
        JKKT.make_kkt("nope")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="item 11"):
        TKKT.make_kkt("schur")
