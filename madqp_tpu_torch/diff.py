"""Differentiable QP solves: implicit differentiation through the KKT system
(port of `madqp_tpu/diff.py`).

`qp_layer` returns the optimal primal-dual point of a convex QP and, under
`torch.autograd`, its gradient with respect to all six data arrays by the
implicit function theorem on the KKT conditions (the OptNet pattern).

Math.  At a solution w* = (x, y, zl, zu) of

    min ½ xᵀHx + cᵀx   s.t.  Ax = b,   lb ≤ x ≤ ub

the KKT residual F(w; θ) = 0 with θ = (H, c, A, b, lb, ub) is

    F1 = Hx + c + Aᵀy − zl + zu        F2 = Ax − b
    F3 = zl ∘ (x − lb)                 F4 = zu ∘ (ub − x)

(rows without a lower/upper bound read zl_i = 0 / zu_i = 0).  Eliminating
(dzl, dzu), as the forward solver does every iteration, reduces the
adjoint system J_wᵀ u = w̄ to the symmetric K2 matrix at the solution:

    [[H + Σ, Aᵀ],        ux = K2⁻¹ [x̄ − zl∘z̄l/sl + zu∘z̄u/su]
     [A,     0 ]]        uy        [ȳ]

with sl = x − lb, su = ub − x, Σ = zl/sl + zu/su, and then

    ul = (z̄l + ux)/sl,   uu = (z̄u − ux)/su
    c̄  = −ux             b̄  = uy
    H̄  = −(ux xᵀ + x uxᵀ)/2          (symmetrized: H is symmetric data)
    Ā  = −(y uxᵀ + uy xᵀ)
    lb̄ = zl ∘ ul         ub̄ = −zu ∘ uu

Gradients are exact where the solution is differentiable (strict
complementarity + LICQ); at degenerate points they are a particular
subgradient.  For LPs (H = 0) the solution is piecewise constant in θ, so
gradients are zero almost everywhere.

Here the layer is a `torch.autograd.Function`.  The forward pass solves
from zeros, with the `_BIG` sentinel for ±inf bounds; the backward pass
solves the K2 system above with `torch.linalg.solve` (a library call: no
Pallas kernel computes it in the reference either), with `diff_reg`, a
Tikhonov term for degenerate solutions.  Inputs with a leading batch axis
solve every lane in lockstep with the lane-masked `BatchedMPCKernel`, the
counterpart of the reference's `vmap(grad(...))`; the factorizations then
run K1 in its one-CTA-per-matrix form under `linear_solver="pallas"`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .parallel.batched import run_lanes
from .solver import state as S
from .solver.mpc import BatchedMPCKernel, MPCKernel
from .solver.state import ProblemArrays
from .utils.options import load_options


class QPLayerSolution(NamedTuple):
    """Primal-dual solution returned by qp_layer.  x, y, zl, zu are
    differentiable; status/iters are integer diagnostics (no gradient)."""

    x: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    status: torch.Tensor   # in-loop code: 1 = success (solver/state.py)
    iters: torch.Tensor


_BIG = 1e20  # sentinel for missing bounds (finite: 0*inf would give NaN)


@functools.lru_cache(maxsize=32)
def _kernel(opts_key, batched: bool):
    """(MPC kernel, diff_reg) for one option set; options are static."""
    opts = dict(opts_key)
    diff_reg = float(opts.pop("diff_reg", 0.0))
    ipm_opts, _ = load_options(**opts)
    return (BatchedMPCKernel if batched else MPCKernel)(ipm_opts), diff_reg


def _solve(kernel: MPCKernel, H, c, A, b, lb, ub):
    """The QP solved from zeros; returns (final state, has_lb, has_ub)."""
    dt = kernel.dtype
    has_lb = torch.isfinite(lb)
    has_ub = torch.isfinite(ub)
    lb = torch.where(has_lb, lb, -_BIG).to(dt)
    ub = torch.where(has_ub, ub, _BIG).to(dt)
    p = ProblemArrays(
        c0=torch.zeros(c.shape[:-1], dtype=dt, device=c.device),
        c=c.to(dt), H=H.to(dt).contiguous(), A=A.to(dt).contiguous(),
        b=b.to(dt), has_lb=has_lb, has_ub=has_ub,
    )
    state = kernel.init_state(p, torch.zeros_like(p.c), torch.zeros_like(p.b), lb, ub)
    if isinstance(kernel, BatchedMPCKernel):
        return run_lanes(kernel, p, state), has_lb, has_ub
    while state.status == S.RUNNING:
        state = kernel.iteration(p, state)
    return state, has_lb, has_ub


class _QPLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, c, A, b, lb, ub, opts_key):
        kernel, diff_reg = _kernel(opts_key, c.dim() > 1)
        final, has_lb, has_ub = _solve(kernel, H, c, A, b, lb, ub)
        # The state's (possibly relaxed) bounds keep sl, su > 0.
        ctx.save_for_backward(H.to(kernel.dtype), A.to(kernel.dtype), final.x,
                              final.y, final.zl, final.zu, final.lb, final.ub,
                              has_lb, has_ub)
        ctx.diff_reg = diff_reg
        ctx.dtypes = tuple(t.dtype for t in (H, c, A, b, lb, ub))
        status = torch.as_tensor(final.status, device=c.device)
        iters = torch.as_tensor(final.k, device=c.device)
        ctx.mark_non_differentiable(status, iters)
        return final.x, final.y, final.zl, final.zu, status, iters

    @staticmethod
    def backward(ctx, xb, yb, zlb, zub, _status, _iters):
        H, A, x, y, zl, zu, lb, ub, has_lb, has_ub = ctx.saved_tensors
        reg = ctx.diff_reg
        one = torch.ones_like(x)
        sl = torch.where(has_lb, x - lb, one)
        su = torch.where(has_ub, ub - x, one)
        sigma = zl / sl + zu / su

        n, m = x.shape[-1], y.shape[-1]
        corner = -reg * torch.eye(m, dtype=x.dtype, device=x.device)
        K2 = torch.cat([
            torch.cat([H + torch.diag_embed(sigma + reg), A.mT], -1),
            torch.cat([A, corner.expand(A.shape[:-2] + (m, m))], -1),
        ], -2)
        rhs = torch.cat([xb - zl * zlb / sl + zu * zub / su, yb], -1)
        u = torch.linalg.solve(K2, rhs)
        ux, uy = u[..., :n], u[..., n:]

        def outer(a, b):
            return a[..., :, None] * b[..., None, :]

        ul = (zlb + ux) / sl
        uu = (zub - ux) / su
        grads = (
            -0.5 * (outer(ux, x) + outer(x, ux)),        # H
            -ux,                                          # c
            -(outer(y, ux) + outer(uy, x)),               # A
            uy,                                           # b
            torch.where(has_lb, zl * ul, 0.0),            # lb
            torch.where(has_ub, -zu * uu, 0.0),           # ub
        )
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None)


def _opts_key(options):
    return tuple(sorted(options.items()))


def _device(arrays, device):
    """`device`, else the device of the first tensor among `arrays`, else
    the CUDA card."""
    if device is not None:
        return torch.device(device)
    first = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    return first.device if first is not None else torch.device("cuda")


def _lanes(arrays, core_dims, device):
    """Tensors of `arrays` on `device`, broadcast to a common leading batch
    axis when any of them has one (core_dims: each array's own rank).
    Returns (tensors, batch shape)."""
    ts = [torch.as_tensor(a, device=device) for a in arrays]
    leads = {tuple(t.shape[: t.dim() - k]) for t, k in zip(ts, core_dims)} - {()}
    if len(leads) > 1 or any(len(lead) > 1 for lead in leads):
        raise ValueError(f"qp_layer takes one leading batch axis, got {sorted(leads)}")
    lead = leads.pop() if leads else ()
    if lead:
        ts = [t.expand(lead + t.shape[t.dim() - k:]) for t, k in zip(ts, core_dims)]
    return ts, lead


def qp_layer(H, c, A, b, lb=None, ub=None, *, device=None,
             **options) -> QPLayerSolution:
    """Differentiable solve of  min ½xᵀHx + cᵀx  s.t. Ax = b, lb ≤ x ≤ ub.

    All six array arguments are differentiable (H=None means an LP — a
    zero Hessian is substituted; LP solutions are piecewise constant in
    the data, so their gradients vanish almost everywhere).  Missing
    bounds may be ±inf entries or None.  Any argument may carry one
    leading batch axis (B, ...); the others are broadcast to it, and every
    lane is solved in lockstep.  The solve runs on the device of the first
    tensor argument, or on `device` (the CUDA card when no argument is a
    tensor and no device is given).  Extra kwargs are solver options (tol,
    max_iter, linear_solver, ... — utils/options.py) plus `diff_reg`, a
    Tikhonov term added to the adjoint K2 system for degenerate solutions.

    No presolve or scaling runs here: the map θ → x* must stay pure in the
    inputs.
    """
    device = _device((H, c, A, b, lb, ub), device)
    c = torch.as_tensor(c, device=device)
    n, dt = c.shape[-1], c.dtype
    if H is None:
        H = torch.zeros((n, n), dtype=dt, device=device)
    lb = torch.full((n,), -torch.inf, dtype=dt, device=device) if lb is None else lb
    ub = torch.full((n,), torch.inf, dtype=dt, device=device) if ub is None else ub
    args, _ = _lanes((H, c, A, b, lb, ub), (2, 1, 2, 1, 1, 1), device)
    return QPLayerSolution(*_QPLayer.apply(*args, _opts_key(options)))


def qp_layer_general(H, c, A, lcon, ucon, lb=None, ub=None, *, device=None,
                     **options) -> QPLayerSolution:
    """Differentiable solve of the general box form
    min ½xᵀHx + cᵀx  s.t. lcon ≤ Ax ≤ ucon, lb ≤ x ≤ ub.

    Reformulated with slack variables s (Ax − s = 0, lcon ≤ s ≤ ucon) —
    the standard-form transform done in differentiable tensor ops, so
    gradients with respect to lcon/ucon flow through the slack bounds.
    Returns the solution restricted to the original variables; `y` are the
    multipliers of Ax − s = 0 (the constraint duals).  Batching and
    devices as in `qp_layer`.
    """
    dev = _device((H, c, A, lcon, ucon, lb, ub), device)
    c, A = torch.as_tensor(c, device=dev), torch.as_tensor(A, device=dev)
    m, n = A.shape[-2:]
    dt = c.dtype
    lb = torch.full((n,), -torch.inf, dtype=dt, device=dev) if lb is None else lb
    ub = torch.full((n,), torch.inf, dtype=dt, device=dev) if ub is None else ub
    if H is None:
        H = torch.zeros((n, n), dtype=dt, device=dev)
    (H, c, A, lcon, ucon, lb, ub), lead = _lanes(
        (H, c, A, lcon, ucon, lb, ub), (2, 1, 2, 1, 1, 1, 1), dev)

    Hs = torch.zeros(lead + (n + m, n + m), dtype=dt, device=dev)
    Hs[..., :n, :n] = H
    zeros_m = torch.zeros(lead + (m,), dtype=dt, device=dev)
    cs = torch.cat([c, zeros_m], -1)
    As = torch.cat([A, -torch.eye(m, dtype=dt, device=dev).expand(lead + (m, m))], -1)
    sol = qp_layer(Hs, cs, As, zeros_m, torch.cat([lb, lcon], -1),
                   torch.cat([ub, ucon], -1), **options)
    return QPLayerSolution(sol.x[..., :n], sol.y, sol.zl[..., :n], sol.zu[..., :n],
                           sol.status, sol.iters)
