"""The differentiable QP layer: the port's autograd gradients against the
JAX package's custom VJP, on the cases of tests/test_diff.py.

Same NumPy inputs through `madqp_tpu.qp_layer` (jax.grad) and
`madqp_tpu_torch.qp_layer` (torch.autograd), float64.  Tolerance: 1e-8
relative to each gradient's largest magnitude (both solve the same
iterations; the adjoint K2 solve is LAPACK on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madqp_tpu as mq
import madqp_tpu_torch as mt

TOL = dict(tol=1e-10, print_level=40)
GRAD_RTOL = 1e-8
NAMES = ("H", "c", "A", "b", "lb", "ub")


def _rand_qp(n=6, m=2, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    H = M @ M.T + n * np.eye(n)
    c = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    x_feas = rng.normal(size=n)
    b = A @ x_feas
    lb = x_feas - rng.uniform(0.05, 2.0, size=n)   # some bounds end up active
    ub = x_feas + rng.uniform(0.05, 2.0, size=n)
    return H, c, A, b, lb, ub


def _assert_grad(got, want, name):
    want = np.asarray(want)
    scale = max(np.max(np.abs(want)), 1e-300)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale,
                               err_msg=f"grad wrt {name}")


def _leaves(arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("seed", [0, 3])
def test_gradients_match_jax_vjp(seed, backend):
    data = _rand_qp(seed=seed)
    w = np.linspace(0.5, 1.5, 6)
    opts = dict(TOL, linear_solver=backend)

    def jloss(*args):
        sol = mq.qp_layer(*args, **opts)
        return jnp.sum(w * sol.x ** 2) + jnp.sum(sol.y) * 0.1

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, data))
    ts = _leaves(data)
    sol = mt.qp_layer(*ts, **opts)
    assert int(sol.status) == 1 and sol.status.dtype == torch.int64
    jsol = mq.qp_layer(*map(jnp.asarray, data), **opts)
    assert int(sol.iters) == int(jsol.iters)
    np.testing.assert_allclose(sol.x.detach().numpy(), np.asarray(jsol.x), rtol=1e-9)
    loss = (torch.from_numpy(w) * sol.x ** 2).sum() + 0.1 * sol.y.sum()
    loss.backward()
    for t, g, name in zip(ts, want, NAMES):
        _assert_grad(t.grad.numpy(), g, name)
    assert not sol.status.requires_grad and not sol.iters.requires_grad


def test_general_form_gradients_match_jax_on_lcon():
    rng = np.random.default_rng(5)
    n, m = 5, 3
    M = rng.normal(size=(n, n))
    H = M @ M.T + n * np.eye(n)
    c = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    lcon = rng.normal(size=m) - 2.0
    ucon = lcon + rng.uniform(0.01, 0.5, size=m)

    def jloss(lcon, ucon):
        return jnp.sum(mq.qp_layer_general(H, c, A, lcon, ucon, **TOL).x ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(lcon), jnp.asarray(ucon))
    tl, tu = _leaves((lcon, ucon))
    sol = mt.qp_layer_general(torch.from_numpy(H), torch.from_numpy(c),
                              torch.from_numpy(A), tl, tu, **TOL)
    assert int(sol.status) == 1 and sol.x.shape == (n,) and sol.y.shape == (m,)
    # the constraint activity bites, else the gradients would be zero
    r = A @ sol.x.detach().numpy()
    assert ((r < ucon - 1e-6) | (r > lcon + 1e-6)).any()
    (sol.x ** 2).sum().backward()
    _assert_grad(tl.grad.numpy(), want[0], "lcon")
    _assert_grad(tu.grad.numpy(), want[1], "ucon")
    assert np.abs(np.asarray(want[0])).max() > 1e-3


def test_unbounded_closed_form_and_lp():
    """No bounds: the layer equals the equality-QP closed form, and the
    gradient of sum(x) with respect to c is -[I 0] K^-1 [I; 0], as in the
    JAX package; an LP's gradients vanish (vertex solution), in both."""
    rng = np.random.default_rng(2)
    n, m = 4, 2
    M = rng.normal(size=(n, n))
    H = M @ M.T + n * np.eye(n)
    c = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    K = np.block([[H, A.T], [A, np.zeros((m, m))]])
    ref = np.linalg.solve(K, np.concatenate([-c, b]))
    tc = torch.tensor(c, requires_grad=True)
    sol = mt.qp_layer(torch.from_numpy(H), tc, torch.from_numpy(A),
                      torch.from_numpy(b), **TOL)
    np.testing.assert_allclose(sol.x.detach().numpy(), ref[:n], atol=1e-8)
    sol.x.sum().backward()
    want = jax.grad(lambda ci: jnp.sum(mq.qp_layer(H, ci, A, b, **TOL).x))(jnp.asarray(c))
    _assert_grad(tc.grad.numpy(), want, "c")
    np.testing.assert_allclose(tc.grad.numpy(), -np.linalg.inv(K)[:n, :n].T.sum(axis=1),
                               atol=1e-7)

    nl, ml = 6, 2
    Al = rng.normal(size=(ml, nl))
    bl = Al @ rng.uniform(0.2, 0.8, size=nl)
    cl = rng.normal(size=nl)
    lo, hi = np.zeros(nl), np.ones(nl)
    tcl = torch.tensor(cl, requires_grad=True)
    sol = mt.qp_layer(None, tcl, torch.from_numpy(Al), torch.from_numpy(bl),
                      torch.from_numpy(lo), torch.from_numpy(hi), **TOL)
    assert int(sol.status) == 1
    sol.x.sum().backward()
    want = jax.grad(lambda ci: jnp.sum(
        mq.qp_layer(None, ci, Al, bl, lo, hi, **TOL).x))(jnp.asarray(cl))
    assert np.max(np.abs(tcl.grad.numpy())) < 1e-5
    np.testing.assert_allclose(tcl.grad.numpy(), np.asarray(want), atol=1e-9)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_batched_gradients_equal_per_instance(backend):
    """A batch along c (the other inputs shared) solves every lane in
    lockstep: each lane's gradient equals the port's single call and the
    JAX package's vmap(grad)."""
    H, c, A, b, lb, ub = _rand_qp(seed=1)
    cs = np.stack([c, c + 0.3, c - 0.2])
    opts = dict(TOL, linear_solver=backend)
    shared = [torch.from_numpy(a) for a in (A, b, lb, ub)]

    tcs = torch.tensor(cs, requires_grad=True)
    sol = mt.qp_layer(torch.from_numpy(H), tcs, *shared, **opts)
    assert sol.x.shape == cs.shape and sol.iters.shape == (3,)
    (sol.x ** 2).sum().backward()

    def jloss(ci):
        return jnp.sum(mq.qp_layer(H, ci, A, b, lb, ub, **opts).x ** 2)

    want = jax.vmap(jax.grad(jloss))(jnp.asarray(cs))
    for i in range(3):
        ci = torch.tensor(cs[i], requires_grad=True)
        one = mt.qp_layer(torch.from_numpy(H), ci, *shared, **opts)
        (one.x ** 2).sum().backward()
        assert int(one.iters) == int(sol.iters[i])
        np.testing.assert_allclose(tcs.grad[i].numpy(), ci.grad.numpy(),
                                   rtol=1e-9, atol=1e-12)
        _assert_grad(tcs.grad[i].numpy(), want[i], f"c[{i}]")
    assert not np.allclose(tcs.grad[0].numpy(), tcs.grad[1].numpy())


def test_batched_all_inputs_and_general_form():
    """Every input batched: per-lane gradients of all six equal the single
    calls'; qp_layer_general broadcasts a batched lcon the same way."""
    lanes = [_rand_qp(seed=10 + i) for i in range(3)]
    stacked = _leaves([np.stack([d[j] for d in lanes]) for j in range(6)])
    sol = mt.qp_layer(*stacked, **TOL)
    (sol.x ** 2).sum().backward()
    for i, data in enumerate(lanes):
        ts = _leaves(data)
        (mt.qp_layer(*ts, **TOL).x ** 2).sum().backward()
        for s, t, name in zip(stacked, ts, NAMES):
            _assert_grad(s.grad[i].numpy(), t.grad.numpy(), name)

    H, c, A = (torch.from_numpy(a) for a in lanes[0][:3])
    lcon = torch.tensor(np.stack([np.full(2, -1.0), np.full(2, -0.5)]))
    sol = mt.qp_layer_general(H, c, A, lcon, lcon + 0.2, **TOL)
    assert sol.x.shape == (2, 6) and sol.y.shape == (2, 2)
    for i in range(2):
        one = mt.qp_layer_general(H, c, A, lcon[i], lcon[i] + 0.2, **TOL)
        np.testing.assert_allclose(sol.x[i].numpy(), one.x.numpy(), rtol=1e-9, atol=1e-12)


def test_layer_runs_where_its_inputs_are():
    """Tensors on the CPU solve on the CPU; arrays with no tensor among
    them go to the CUDA card unless a device is named."""
    from madqp_tpu_torch.diff import _device

    H, c, A, b, lb, ub = _rand_qp(seed=4)
    sol = mt.qp_layer(H, c, A, b, lb, ub, device="cpu", **TOL)
    assert sol.x.device.type == "cpu" and int(sol.status) == 1
    assert _device((H, c), None) == torch.device("cuda")
    assert _device((H, torch.from_numpy(c)), None) == torch.device("cpu")
