"""Every dense KKT backend on a batch: the port's BatchedMPCSolver against
the JAX package's (a `jax.vmap` of its MPCKernel) on the same problems.

* Each backend that a single solve takes, on three dense_dummy_qp(10, 4)
  lanes (and the normal equations on a batch of LPs): every lane's status,
  iterations, objective (1e-9 relative) and iterates (1e-7: x, y, zl, zu
  in user coordinates).  In float64 the iterations are equal; with the
  float32 factorization they are held within 1, or within
  RESCUE_ITER_BAND where a float32 phase hands over to the float64 one
  (tests/test_torch_batched.py gives the band's reason).  The float64
  cases of the blocked condensed system, `solve_mode="inverse"` under
  `dense`, K2 and K2.5 with LU are tests/test_torch_batched.py's
  test_unported_batched_paths_raise, which raised on them until the batch
  took them.
* Batched `qp_layer` with kkt_system="k2" and with
  linear_solver="blocked": forward and the gradients of all six inputs
  against the JAX `qp_layer` under `jax.vmap`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madqp_tpu as mq
import madqp_tpu_torch as mt
from madqp_tpu.parallel import BatchedMPCSolver as JBatched
from madqp_tpu_torch.parallel import BatchedMPCSolver

OBJ_RTOL = 1e-9
ITERATE_ATOL = 1e-7
RESCUE_ITER_BAND = 8   # tests/test_torch_batched.py::RESCUE_ITER_BAND
F32 = dict(factorization_dtype="float32", max_refine_steps=1, endgame="f64")


def _port_qp(qp):
    """A JAX-package QuadraticProblem handed to the port field by field."""
    return mt.QuadraticProblem(**{f.name: getattr(qp, f.name)
                                  for f in dataclasses.fields(mq.QuadraticProblem)})


def _qps():
    return [mq.dense_dummy_qp(10, 4, seed=i) for i in range(3)]


def _lps():
    return [mq.random_lp(12, 5, seed=i) for i in range(3)]


def compare_batches(qps, options, float32=False):
    """Solve `qps` as one batch in both packages with `options` (plus the
    float32 factorization if asked) and hold the port's lanes to the
    reference's."""
    extra = dict(options, **(F32 if float32 else {}))
    want = JBatched.from_problems(qps, print_level=40, **extra).solve_all()
    got = BatchedMPCSolver.from_problems([_port_qp(q) for q in qps], device="cpu",
                                         print_level=40, **extra).solve_all()
    assert len(got) == len(want) == len(qps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert int(g.status) == int(w.status) == 1, (options, i, g.status)
        band = 0 if not float32 else 1 if max(g.iter, w.iter) < 30 else RESCUE_ITER_BAND
        assert abs(g.iter - w.iter) <= band, (options, i, g.iter, w.iter)
        assert g.objective == pytest.approx(w.objective, rel=OBJ_RTOL, abs=1e-12), (options, i)
        for name in ("solution", "multipliers", "multipliers_L", "multipliers_U"):
            np.testing.assert_allclose(getattr(g, name), np.asarray(getattr(w, name)),
                                       rtol=0, atol=ITERATE_ATOL, err_msg=f"{options} {i} {name}")
    return got


# name -> (problems, options).  The float64 cases not listed here are
# tests/test_torch_batched.py's item-18 cases.
BACKENDS = {
    "condensed-blocked": (_qps, dict(linear_solver="blocked")),
    "inverse-dense": (_qps, dict(solve_mode="inverse")),
    "inverse-pallas": (_qps, dict(solve_mode="inverse", linear_solver="pallas")),
    "k2": (_qps, dict(kkt_system="k2")),
    "k2.5": (_qps, dict(kkt_system="k2.5")),
    "k2-blocked": (_qps, dict(kkt_system="k2", linear_solver="blocked")),
    "k2.5-blocked": (_qps, dict(kkt_system="k2.5", linear_solver="blocked")),
    "normal-blocked": (_lps, dict(kkt_system="normal", linear_solver="blocked")),
}
F64_HERE = ("inverse-pallas", "k2-blocked", "k2.5-blocked", "normal-blocked")
# With the float32 factorization "inverse-pallas" differs from
# "inverse-dense" only in the Cholesky routine, which the float64 case
# already holds (the reference's interpret-mode Pallas makes it the
# costliest case).
F32_HERE = tuple(b for b in sorted(BACKENDS) if b != "inverse-pallas")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one process per core under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("backend", F64_HERE)
def test_batched_backend_float64_matches_jax(backend):
    make, options = BACKENDS[backend]
    compare_batches(make(), options)


@pytest.mark.parametrize("backend", F32_HERE)
def test_batched_backend_float32_matches_jax(backend):
    make, options = BACKENDS[backend]
    compare_batches(make(), options, float32=True)


def _layer_data(lanes=3, n=6, m=2):
    rng = np.random.default_rng(7)
    M = rng.standard_normal((lanes, n, n))
    H = M @ M.transpose(0, 2, 1) + n * np.eye(n)
    c = rng.standard_normal((lanes, n))
    A = rng.standard_normal((lanes, m, n))
    x0 = rng.standard_normal((lanes, n))
    b = np.einsum("lmn,ln->lm", A, x0)
    lb = x0 - rng.uniform(0.1, 1.0, (lanes, n))
    ub = x0 + rng.uniform(0.1, 1.0, (lanes, n))
    return H, c, A, b, lb, ub


@pytest.mark.parametrize("options", [dict(kkt_system="k2"), dict(linear_solver="blocked")],
                         ids=["k2", "blocked"])
def test_batched_qp_layer_matches_jax(options):
    """Forward (x, y) and the gradients of the loss sum(w x^2) + 0.1 sum(y)
    with respect to all six inputs: iterations equal, values to 1e-7
    relative to each output's largest magnitude."""
    data = _layer_data()
    w = np.linspace(0.5, 1.5, data[0].shape[-1])

    def jloss(*args):
        sol = mq.qp_layer(*args, print_level=40, **options)
        return jnp.sum(w * sol.x ** 2) + 0.1 * jnp.sum(sol.y), sol

    jgrad = jax.vmap(jax.grad(jloss, argnums=tuple(range(6)), has_aux=True))
    jgrads, jsol = jgrad(*(jnp.asarray(a) for a in data))
    args = [torch.tensor(a, requires_grad=True) for a in data]
    sol = mt.qp_layer(*args, print_level=40, **options)
    loss = (torch.as_tensor(w) * sol.x ** 2).sum() + 0.1 * sol.y.sum()
    grads = torch.autograd.grad(loss, args)
    assert sol.iters.tolist() == np.asarray(jsol.iters).tolist()
    for got, want in [(sol.x, jsol.x), (sol.y, jsol.y), *zip(grads, jgrads)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-7 * np.abs(want).max())
