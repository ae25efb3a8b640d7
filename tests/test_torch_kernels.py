"""Every function of ops/kernels.py: the same NumPy inputs through the JAX
function and the port's, compared in float64.

Tolerance: 1e-12 relative to each output's largest magnitude (elementwise
results agree to the last bit; reductions may sum in another order).
Integer outputs (blocking indices) must be equal.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madqp_tpu.ops import kernels as JK
from madqp_tpu_torch.ops import kernels as TK

RTOL = 1e-12
N, M = 24, 7
DTYPE = object()  # stands for the float64 dtype argument of each package


def _setup(seed):
    """x strictly inside a random masked box, positive duals, a direction."""
    rng = np.random.default_rng(seed)
    has_lb = rng.random(N) < 0.6
    has_ub = rng.random(N) < 0.6
    lb_raw = rng.normal(size=N) - 2.0
    ub_raw = lb_raw + 1.0 + rng.random(N) * 3.0
    lb = np.where(has_lb, lb_raw, 0.0)
    ub = np.where(has_ub, ub_raw, 0.0)
    lo = np.where(has_lb, lb_raw, -5.0)
    hi = np.where(has_ub, ub_raw, 5.0)
    x = lo + rng.uniform(0.2, 0.8, size=N) * (hi - lo)
    zl = np.where(has_lb, rng.uniform(0.1, 2.0, size=N), 0.0)
    zu = np.where(has_ub, rng.uniform(0.1, 2.0, size=N), 0.0)
    # A direction long enough that some ratio tests block (alpha < 1).
    d = (3.0 * rng.normal(size=N), rng.normal(size=M),
         np.where(has_lb, 3.0 * rng.normal(size=N), 0.0),
         np.where(has_ub, 3.0 * rng.normal(size=N), 0.0))
    s = dict(x=x, lb=lb, ub=ub, has_lb=has_lb, has_ub=has_ub, zl=zl, zu=zu,
             d=d, g=rng.normal(size=N), jacl=rng.normal(size=N),
             c_res=rng.normal(size=M), y=rng.normal(size=M),
             b=rng.normal(size=M), r=rng.normal(size=N),
             corr_lb=np.where(has_lb, 0.1 * rng.normal(size=N), 0.0),
             corr_ub=np.where(has_ub, 0.1 * rng.normal(size=N), 0.0),
             mu=np.asarray(0.37), mu_aff=np.asarray(0.05),
             a_p=np.asarray(0.6), a_d=np.asarray(0.8),
             ones=np.ones(N))
    return s


def _bounds(s):
    return (s["x"], s["lb"], s["ub"], s["has_lb"], s["has_ub"], s["zl"], s["zu"])


# name -> function of the setup returning the positional arguments.  A
# 4-tuple under key "d" becomes each package's KKTVec.
CASES = {
    "KKTVec.flat_inf_norm": lambda s: (("KKTVEC", s["d"]),),
    "_inf_norm": lambda s: (s["g"],),
    "slacks": lambda s: (s["x"], s["lb"], s["ub"], s["has_lb"], s["has_ub"]),
    "sigma_diagonal": lambda s: (*_bounds(s), np.asarray(1e-8)),
    "initial_primal_rhs": lambda s: (s["c_res"], N, DTYPE),
    "initial_dual_rhs": lambda s: (s["g"], M, DTYPE),
    "predictor_rhs": lambda s: (s["g"], s["jacl"], s["c_res"], *_bounds(s)),
    "correction_rhs": lambda s: (s["g"], s["jacl"], s["c_res"], *_bounds(s),
                                 s["mu"], s["corr_lb"], s["corr_ub"]),
    "mehrotra_correction": lambda s: (("KKTVEC", s["d"]), s["has_lb"], s["has_ub"]),
    "gondzio_extra_correction": lambda s: (
        ("KKTVEC", s["d"]), *_bounds(s), s["corr_lb"], s["corr_ub"],
        s["a_p"], s["a_d"], 0.1, 10.0, s["mu"]),
    "reduce_rhs": lambda s: (("KKTVEC", s["d"]), s["x"], s["lb"], s["ub"],
                             s["has_lb"], s["has_ub"]),
    "recover_bound_duals": lambda s: (("KKTVEC", s["d"]), s["r"], *_bounds(s)),
    "complementarity_measure": lambda s: _bounds(s),
    "affine_complementarity_measure": lambda s: (
        ("KKTVEC", s["d"]), *_bounds(s), s["a_p"], s["a_d"]),
    "optimality_gap": lambda s: _bounds(s),
    "alpha_max_primal": lambda s: (s["x"], s["lb"], s["ub"], s["has_lb"],
                                   s["has_ub"], s["d"][0], 0.9),
    "alpha_max_dual": lambda s: (s["zl"], s["zu"], s["has_lb"], s["has_ub"],
                                 s["d"][2], s["d"][3], 0.95),
    "fraction_to_boundary": lambda s: (("KKTVEC", s["d"]), *_bounds(s), 0.99),
    "step_conservative": lambda s: (("KKTVEC", s["d"]), *_bounds(s), s["mu"], 0.995),
    "step_adaptive": lambda s: (("KKTVEC", s["d"]), *_bounds(s), s["mu"], 0.99),
    "step_mehrotra_adaptive": lambda s: (("KKTVEC", s["d"]), *_bounds(s),
                                         s["mu"], 0.99),
    "mehrotra_barrier": lambda s: (s["mu"], s["mu_aff"], np.asarray(5), 1e-11,
                                   1e-6, 10.0),
    "dual_objective": lambda s: (s["y"], s["b"], s["lb"], s["ub"], s["has_lb"],
                                 s["has_ub"], s["zl"], s["zu"]),
    "dual_infeasibility": lambda s: (s["g"], s["jacl"], s["zl"], s["zu"]),
    "primal_infeasibility": lambda s: (s["c_res"],),
    "relax_bounds": lambda s: (s["lb"], s["ub"], s["has_lb"], s["has_ub"], 1e-8),
    "push_inside_bounds": lambda s: (s["x"] + 50.0 * s["d"][0], s["lb"], s["ub"],
                                     s["has_lb"], s["has_ub"], 1e-2, 1e-2),
    "project_bound_fac": lambda s: (s["x"] + 50.0 * s["d"][0], s["lb"], s["ub"],
                                    s["has_lb"], s["has_ub"], 1e-2),
    "init_bound_duals": lambda s: (s["r"], s["has_lb"], s["has_ub"], s["ones"],
                                   s["ones"]),
    "mehrotra_positivity_shift": lambda s: (
        s["x"] + s["d"][0], s["lb"], s["ub"], s["has_lb"], s["has_ub"],
        s["d"][2], s["d"][3]),
    "adjust_boundary": lambda s: (s["lb"] + np.where(s["has_lb"], 1e-14, 0.5),
                                  s["lb"], s["ub"], s["has_lb"], s["has_ub"],
                                  s["mu"], float(np.finfo(np.float64).eps)),
}


def _function(module, name):
    if name == "KKTVec.flat_inf_norm":
        return lambda v: v.flat_inf_norm()
    return getattr(module, name)


def _jax_arg(a):
    if a is DTYPE:
        return jnp.float64
    if isinstance(a, tuple) and a[0] == "KKTVEC":
        return JK.KKTVec(*(jnp.asarray(v) for v in a[1]))
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _torch_arg(a):
    if a is DTYPE:
        return torch.float64
    if isinstance(a, tuple) and a[0] == "KKTVEC":
        return TK.KKTVec(*(torch.as_tensor(v) for v in a[1]))
    return torch.as_tensor(a) if isinstance(a, np.ndarray) else a


def _leaves(out):
    if isinstance(out, tuple):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, torch.Tensor):
        return [out.numpy()]
    return [np.asarray(out)]


def test_cases_cover_every_reference_function():
    public = {name for name, obj in vars(JK).items()
              if inspect.isfunction(obj) and obj.__module__ == JK.__name__}
    assert public <= set(CASES), sorted(public - set(CASES))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_reference(name, seed):
    s = _setup(seed)
    args = CASES[name](s)
    want = _leaves(_function(JK, name)(*(_jax_arg(a) for a in args)))
    got = _leaves(_function(TK, name)(*(_torch_arg(a) for a in args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g, w)
            continue
        assert g.dtype == np.float64
        finite = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), finite)
        scale = np.max(np.abs(w[finite]), initial=0.0)
        np.testing.assert_allclose(g[finite], w[finite], rtol=RTOL,
                                   atol=RTOL * scale)
        np.testing.assert_array_equal(g[~finite], w[~finite])


# ---------------------------------------------------------------------------
# A batch of problems: vectors (B, n), per-lane scalars (B,)
# ---------------------------------------------------------------------------

LANES = 3
LANE_RTOL = 1e-15


def _stack(setups):
    """One setup per lane, stacked on a leading lane axis (the direction
    `d` part by part)."""
    out = {}
    for key, v in setups[0].items():
        if key == "d":
            out[key] = tuple(np.stack([s["d"][i] for s in setups]) for i in range(4))
        else:
            out[key] = np.stack([s[key] for s in setups])
    return out


def _lane_arg(a, i):
    """Lane i of an argument: arrays with a lane axis are sliced; 0-d
    arrays, Python numbers and the static sizes are shared."""
    if isinstance(a, tuple) and a[0] == "KKTVEC":
        return ("KKTVEC", tuple(v[i] for v in a[1]))
    return np.asarray(a[i]) if isinstance(a, np.ndarray) and a.ndim else a


def _in_axis(a):
    if isinstance(a, tuple) and a[0] == "KKTVEC":
        return JK.KKTVec(0, 0, 0, 0)
    return 0 if isinstance(a, np.ndarray) and a.ndim else None


def _assert_close(g, w, rtol):
    assert g.shape == w.shape
    if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
        np.testing.assert_array_equal(g, w)
        return
    assert g.dtype == np.float64
    finite = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), finite)
    scale = np.max(np.abs(w[finite]), initial=0.0)
    np.testing.assert_allclose(g[finite], w[finite], rtol=rtol, atol=rtol * scale)
    np.testing.assert_array_equal(g[~finite], w[~finite])


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_on_a_batch(name):
    """Each function on a (B, n) stack with per-lane scalars (B,): every
    lane equals the port's function on that lane alone (1e-15 relative),
    and the whole equals jax.vmap of the JAX function (1e-12): each
    reduction runs per lane, over the last axis."""
    import jax

    args = CASES[name](_stack([_setup(10 + i) for i in range(LANES)]))
    fn = _function(TK, name)
    got = _leaves(fn(*(_torch_arg(a) for a in args)))
    for i in range(LANES):
        alone = _leaves(fn(*(_torch_arg(_lane_arg(a, i)) for a in args)))
        assert len(alone) == len(got)
        for g, w in zip(got, alone):
            _assert_close(g[i], w, LANE_RTOL)
    static = {j: a for j, a in enumerate(args) if _in_axis(a) is None}
    mapped = [j for j in range(len(args)) if j not in static]

    def jfn(*lanes):
        full = dict(static)
        full.update(zip(mapped, lanes))
        return _function(JK, name)(*(_jax_arg(full[j]) for j in range(len(args))))

    want = _leaves(jax.vmap(jfn)(*(_jax_arg(args[j]) for j in mapped)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_close(g, w, RTOL)
