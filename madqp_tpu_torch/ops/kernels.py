"""Masked IPM math on tensors (port of `madqp_tpu/ops/kernels.py`).

Every function of the reference module, with the same signature and the
same masked full-length semantics:
  * bound index sets are boolean masks `has_lb`/`has_ub` over full-length
    tensors; bound-dual vectors `zl`/`zu` are full-length with zeros
    off-mask;
  * `lb`/`ub` hold finite placeholders off-mask, so no 0*inf NaNs appear;
  * scalar results (ratio tests, barrier, measures) stay 0-d tensors on the
    problem's device; the caller decides when to read one on the host;
  * every function also takes a batch of problems, vectors (B, n) with a
    leading lane axis: reductions run over the last axis and give one
    value per lane (B,), and a per-lane scalar (B,) scales its lane's
    vector (`per_lane`).  That is what `jax.vmap` makes of the reference's
    functions; here it is written out.  A 1-D input gives the 0-d result
    it gives alone, bit for bit.

These are plain PyTorch: none of them is a hand kernel (the reference left
them to XLA's fusion).  A Python float is accepted wherever the reference
accepts a static scalar (tau, beta, eps, ...).

Sign conventions for the unreduced KKT system (rows for masked entries only):

    [x ]  (H + dw I) dx + A' dy - dzl + dzu        = px
    [y ]  A dx + dc dy                             = py
    [zl]  zl.dx + sl.dzl                           = pzl     sl = x - lb > 0
    [zu]  -zu.dx + su.dzu                          = pzu     su = ub - x > 0

The upper-bound row is the negation of the reference's, so both slack
diagonals are positive.  Affine RHS: pzl = -sl.zl, pzu = -su.zu.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class KKTVec(NamedTuple):
    """Unreduced KKT vector: (x, y, zl, zu) blocks, zl/zu masked full-length.

    Replaces MadNLP.UnreducedKKTVector (reference src/structure.jl:130-133).
    """

    x: torch.Tensor   # (n,) or (B, n)
    y: torch.Tensor   # (m,) or (B, m)
    zl: torch.Tensor  # (n,) or (B, n)
    zu: torch.Tensor  # (n,) or (B, n)

    def flat_inf_norm(self) -> torch.Tensor:
        return torch.maximum(
            torch.maximum(_inf_norm(self.x), _inf_norm(self.y)),
            torch.maximum(_inf_norm(self.zl), _inf_norm(self.zu)),
        )

    def add(self, other: "KKTVec") -> "KKTVec":
        return KKTVec(*(a + b for a, b in zip(self, other)))

    def sub(self, other: "KKTVec") -> "KKTVec":
        return KKTVec(*(a - b for a, b in zip(self, other)))


def per_lane(s):
    """A per-lane scalar (B,) as (B, 1), to scale its lane's vector of a
    (B, n) stack; a 0-d tensor or a Python number is returned as it is."""
    return s[..., None] if isinstance(s, torch.Tensor) and s.dim() else s


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M @ v for one matrix (m, n) and vector (n,), or lane by lane for a
    stack (B, m, n) and (B, n)."""
    return M @ v if v.dim() == 1 else (M @ v[..., None])[..., 0]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis (torch.dot for 1-D vectors)."""
    return torch.dot(a, b) if a.dim() == 1 else (a * b).sum(-1)


def _inf_norm(v: torch.Tensor) -> torch.Tensor:
    return v.abs().amax(-1) if v.shape[-1] else v.new_zeros(v.shape[:-1])


def _min_or_inf(v: torch.Tensor) -> torch.Tensor:
    """min over the last axis with an empty axis giving +inf
    (jnp.min(..., initial=inf))."""
    return v.amin(-1) if v.shape[-1] else v.new_full(v.shape[:-1], math.inf)


def slacks(x, lb, ub, has_lb, has_ub):
    """Positive bound slacks, 1.0 off-mask (never used off-mask)."""
    sl = torch.where(has_lb, x - lb, 1.0)
    su = torch.where(has_ub, ub - x, 1.0)
    return sl, su


# ---------------------------------------------------------------------------
# Diagonal / Sigma (reference set_aug_diagonal_reg!, src/kernels.jl:128-146)
# ---------------------------------------------------------------------------


def sigma_diagonal(x, lb, ub, has_lb, has_ub, zl, zu, del_w):
    """pr_diag = del_w + zl/(x-lb) + zu/(ub-x), masked."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    return (
        per_lane(del_w)
        + torch.where(has_lb, zl / sl, 0.0)
        + torch.where(has_ub, zu / su, 0.0)
    )


# ---------------------------------------------------------------------------
# RHS builders (reference src/kernels.jl:1-61)
# ---------------------------------------------------------------------------


def initial_primal_rhs(c_res, n, dtype):
    """rhs = (0, -c_res, 0, 0): primal least-squares (src/kernels.jl:1-9)."""
    z = torch.zeros(c_res.shape[:-1] + (n,), dtype=dtype, device=c_res.device)
    return KKTVec(x=z, y=-c_res, zl=z, zu=z)


def initial_dual_rhs(g, m, dtype):
    """rhs = (-g, 0, 0, 0): dual least-squares (src/kernels.jl:11-19)."""
    z = torch.zeros(g.shape, dtype=dtype, device=g.device)
    return KKTVec(x=-g, y=torch.zeros(g.shape[:-1] + (m,), dtype=dtype,
                                      device=g.device),
                  zl=z, zu=z)


def predictor_rhs(g, jacl, c_res, x, lb, ub, has_lb, has_ub, zl, zu):
    """Affine-scaling RHS (reference set_predictive_rhs!)."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    return KKTVec(
        x=-g + zl - zu - jacl,
        y=-c_res,
        zl=torch.where(has_lb, -sl * zl, 0.0),
        zu=torch.where(has_ub, -su * zu, 0.0),
    )


def correction_rhs(g, jacl, c_res, x, lb, ub, has_lb, has_ub, zl, zu, mu,
                   correction_lb, correction_ub):
    """Corrector RHS (reference set_correction_rhs!, src/kernels.jl:43-61).

    pzl = -sl.zl + mu - corr_lb ; pzu = -su.zu + mu + corr_ub.
    """
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    mu = per_lane(mu)
    return KKTVec(
        x=-g + zl - zu - jacl,
        y=-c_res,
        zl=torch.where(has_lb, -sl * zl + mu - correction_lb, 0.0),
        zu=torch.where(has_ub, -su * zu + mu + correction_ub, 0.0),
    )


def mehrotra_correction(d: KKTVec, has_lb, has_ub):
    """corr = dx .* dz from the affine direction (src/kernels.jl:63-75)."""
    corr_lb = torch.where(has_lb, d.x * d.zl, 0.0)
    corr_ub = torch.where(has_ub, d.x * d.zu, 0.0)
    return corr_lb, corr_ub


def _clamp_excess(v, tmin, tmax):
    """tmin - v below the box, tmax - v above it, 0 inside."""
    return torch.where(v < tmin, tmin - v,
                       torch.where(v > tmax, tmax - v, 0.0))


def gondzio_extra_correction(
    d: KKTVec, x, lb, ub, has_lb, has_ub, zl, zu,
    correction_lb, correction_ub,
    alpha_p, alpha_d, beta_min, beta_max, mu,
):
    """Gondzio's multi-centrality correction (src/kernels.jl:78-126).

    Clamp the trial complementarity products into [beta_min*mu, beta_max*mu];
    the excess delta is folded into the corrections.
    """
    tmin, tmax = beta_min * per_lane(mu), beta_max * per_lane(mu)
    alpha_p, alpha_d = per_lane(alpha_p), per_lane(alpha_d)
    sl, su = slacks(x, lb, ub, has_lb, has_ub)

    v_l = (sl + alpha_p * d.x) * (zl + alpha_d * d.zl)
    delta_l = _clamp_excess(v_l, tmin, tmax)
    new_corr_lb = torch.where(has_lb, correction_lb - delta_l, 0.0)

    v_u = (su - alpha_p * d.x) * (zu + alpha_d * d.zu)
    delta_u = _clamp_excess(v_u, tmin, tmax)
    new_corr_ub = torch.where(has_ub, correction_ub + delta_u, 0.0)

    return new_corr_lb, new_corr_ub


# ---------------------------------------------------------------------------
# Bound-dual elimination / recovery (MadNLP reduce_rhs!/finish_aug_solve!)
# ---------------------------------------------------------------------------


def reduce_rhs(p: KKTVec, x, lb, ub, has_lb, has_ub):
    """Condense the bound-dual rows into the primal RHS:
    px~ = px + pzl/sl - pzu/su."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    px = (p.x + torch.where(has_lb, p.zl / sl, 0.0)
          - torch.where(has_ub, p.zu / su, 0.0))
    return px, p.y


def recover_bound_duals(p: KKTVec, dx, x, lb, ub, has_lb, has_ub, zl, zu):
    """dzl = (pzl - zl.dx)/sl ; dzu = (pzu + zu.dx)/su (masked)."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    dzl = torch.where(has_lb, (p.zl - zl * dx) / sl, 0.0)
    dzu = torch.where(has_ub, (p.zu + zu * dx) / su, 0.0)
    return dzl, dzu


# ---------------------------------------------------------------------------
# Complementarity measures (src/kernels.jl:171-224)
# ---------------------------------------------------------------------------


def _bound_mean(num, has_lb, has_ub):
    """num / (nlb + nub), 0 when there are no bounds."""
    cnt = has_lb.sum(-1) + has_ub.sum(-1)
    return torch.where(cnt > 0, num / torch.clamp(cnt, min=1), 0.0)


def complementarity_measure(x, lb, ub, has_lb, has_ub, zl, zu):
    """mu = (sum (x-lb).zl + sum (ub-x).zu) / (nlb + nub); 0 if no bounds."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    num = (torch.where(has_lb, sl * zl, 0.0).sum(-1)
           + torch.where(has_ub, su * zu, 0.0).sum(-1))
    return _bound_mean(num, has_lb, has_ub)


def affine_complementarity_measure(
    d: KKTVec, x, lb, ub, has_lb, has_ub, zl, zu, alpha_p, alpha_d
):
    """Trial complementarity at (x + a_p dx, z + a_d dz) (src/kernels.jl:192-224)."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    alpha_p, alpha_d = per_lane(alpha_p), per_lane(alpha_d)
    num = torch.where(
        has_lb, (sl + alpha_p * d.x) * (zl + alpha_d * d.zl), 0.0
    ).sum(-1) + torch.where(
        has_ub, (su - alpha_p * d.x) * (zu + alpha_d * d.zu), 0.0
    ).sum(-1)
    return _bound_mean(num, has_lb, has_ub)


def optimality_gap(x, lb, ub, has_lb, has_ub, zl, zu):
    """inf-norm of the complementarity products (get_optimality_gap)."""
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    gl = torch.where(has_lb, torch.abs(sl * zl), 0.0)
    gu = torch.where(has_ub, torch.abs(su * zu), 0.0)
    return torch.maximum(_inf_norm(gl), _inf_norm(gu))


# ---------------------------------------------------------------------------
# Fraction-to-boundary ratio tests (src/kernels.jl:242-305)
# ---------------------------------------------------------------------------


def _ratio_min(vals):
    """(min(1, min(vals)), argmin(vals)) of a ratio-test vector, over its
    last axis."""
    alpha = torch.clamp(_min_or_inf(vals), max=1.0)
    idx = (torch.argmin(vals, -1) if vals.shape[-1]
           else vals.new_zeros(vals.shape[:-1], dtype=torch.int64))
    return alpha, idx


def alpha_max_primal(x, lb, ub, has_lb, has_ub, dx, tau):
    """Largest alpha <= 1 keeping x + alpha dx inside tau-shrunk bounds.

    Returns (alpha_xl, alpha_xu, iblock_l, iblock_u) like the reference's
    argmin-carrying mapreduce (get_alpha_max_primal).
    """
    tau = per_lane(tau)
    cond_l = has_lb & (dx < 0)
    vals_l = torch.where(cond_l, tau * (lb - x) / torch.where(cond_l, dx, -1.0),
                         math.inf)
    cond_u = has_ub & (dx > 0)
    vals_u = torch.where(cond_u, tau * (ub - x) / torch.where(cond_u, dx, 1.0),
                         math.inf)
    alpha_l, i_l = _ratio_min(vals_l)
    alpha_u, i_u = _ratio_min(vals_u)
    return alpha_l, alpha_u, i_l, i_u


def alpha_max_dual(zl, zu, has_lb, has_ub, dzl, dzu, tau):
    """Largest alpha <= 1 keeping z + alpha dz > 0 (tau-shrunk).

    The upper-dual test replicates the reference's extra guard
    `(dzu < 0) && (zu + dzu < 0)` (src/kernels.jl:279).
    """
    tau = per_lane(tau)
    cond_l = has_lb & (dzl < 0)
    vals_l = torch.where(cond_l, -tau * zl / torch.where(cond_l, dzl, -1.0),
                         math.inf)
    cond_u = has_ub & (dzu < 0) & (zu + dzu < 0)
    vals_u = torch.where(cond_u, -tau * zu / torch.where(cond_u, dzu, -1.0),
                         math.inf)
    alpha_l, i_l = _ratio_min(vals_l)
    alpha_u, i_u = _ratio_min(vals_u)
    return alpha_l, alpha_u, i_l, i_u


def fraction_to_boundary(d: KKTVec, x, lb, ub, has_lb, has_ub, zl, zu, tau):
    """(alpha_p, alpha_d) (reference get_fraction_to_boundary_step)."""
    axl, axu, _, _ = alpha_max_primal(x, lb, ub, has_lb, has_ub, d.x, tau)
    azl, azu, _, _ = alpha_max_dual(zl, zu, has_lb, has_ub, d.zl, d.zu, tau)
    return torch.minimum(axl, axu), torch.minimum(azl, azu)


# ---------------------------------------------------------------------------
# Step rules (src/kernels.jl:307-374)
# ---------------------------------------------------------------------------


def step_conservative(d, x, lb, ub, has_lb, has_ub, zl, zu, mu, tau):
    return fraction_to_boundary(d, x, lb, ub, has_lb, has_ub, zl, zu, tau)


def step_adaptive(d, x, lb, ub, has_lb, has_ub, zl, zu, mu, tau_min):
    tau = torch.clamp(1.0 - mu, min=tau_min)
    return fraction_to_boundary(d, x, lb, ub, has_lb, has_ub, zl, zu, tau)


def step_mehrotra_adaptive(d, x, lb, ub, has_lb, has_ub, zl, zu, mu, gamma_f):
    """Mehrotra's GTSF heuristic (src/kernels.jl:325-374).

    The blocking-index reads are tensor-indexed (no host sync); both
    rescue candidates are computed and one is selected, as in the
    reference.
    """
    gamma_a = 1.0 / (1.0 - gamma_f)

    axl, axu, i_xl, i_xu = alpha_max_primal(x, lb, ub, has_lb, has_ub, d.x, 1.0)
    azl, azu, i_zl, i_zu = alpha_max_dual(zl, zu, has_lb, has_ub, d.zl, d.zu, 1.0)

    max_alpha_p = torch.minimum(axl, axu)
    max_alpha_d = torch.minimum(azl, azu)

    mu_full = affine_complementarity_measure(
        d, x, lb, ub, has_lb, has_ub, zl, zu, max_alpha_p, max_alpha_d
    ) / gamma_a

    sl, su = slacks(x, lb, ub, has_lb, has_ub)

    def at(v, i):  # v[i] in each lane
        return torch.take_along_dim(v, i[..., None], -1)[..., 0]

    # Primal rescue at the blocking index.
    tmp = mu_full / (at(zl, i_xl) + max_alpha_d * at(d.zl, i_xl))
    resc_p_l = (at(sl, i_xl) - tmp) / (-at(d.x, i_xl))  # (x - lb - tmp)/(-dx)
    tmp = mu_full / (at(zu, i_xu) + max_alpha_d * at(d.zu, i_xu))
    resc_p_u = (at(su, i_xu) - tmp) / at(d.x, i_xu)
    alpha_p_resc = torch.where(axl <= axu, resc_p_l, resc_p_u)
    alpha_p = torch.where(max_alpha_p < 1.0, alpha_p_resc, 1.0)

    tmp = mu_full / (at(sl, i_zl) + max_alpha_p * at(d.x, i_zl))
    resc_d_l = -(at(zl, i_zl) - tmp) / at(d.zl, i_zl)
    tmp = mu_full / (at(su, i_zu) - max_alpha_p * at(d.x, i_zu))
    resc_d_u = -(at(zu, i_zu) - tmp) / at(d.zu, i_zu)
    alpha_d_resc = torch.where(azl <= azu, resc_d_l, resc_d_u)
    alpha_d = torch.where(max_alpha_d < 1.0, alpha_d_resc, 1.0)

    alpha_p = torch.maximum(alpha_p, gamma_f * max_alpha_p)
    alpha_d = torch.maximum(alpha_d, gamma_f * max_alpha_d)
    # Never exceed the strict fraction-to-boundary maximum.
    alpha_p = torch.minimum(alpha_p, max_alpha_p)
    alpha_d = torch.minimum(alpha_d, max_alpha_d)
    return alpha_p, alpha_d


# ---------------------------------------------------------------------------
# Barrier (src/kernels.jl:226-236)
# ---------------------------------------------------------------------------


def mehrotra_barrier(
    mu_curr, mu_affine, n_onesided, mu_min, sigma_min=1e-6, sigma_max=10.0
):
    """sigma = clamp((mu_aff/mu)^3, smin, smax) when bounds exist, else
    sigma = 1 (reference update_barrier!).  `mu_curr` and `mu_affine` are
    0-d tensors; `n_onesided` is an int or a 0-d integer tensor."""
    ratio = torch.where(mu_curr > 0,
                        mu_affine / torch.clamp(mu_curr, min=1e-300), 0.0)
    sigma = torch.clamp(ratio ** 3, sigma_min, sigma_max)
    has_bounds = torch.as_tensor(n_onesided, device=sigma.device) > 0
    sigma = torch.where(has_bounds, sigma, 1.0)
    return torch.clamp(sigma * mu_curr, min=mu_min)


# ---------------------------------------------------------------------------
# Dual objective / residual norms (src/kernels.jl:424-446)
# ---------------------------------------------------------------------------


def dual_objective(y, b, lb, ub, has_lb, has_ub, zl, zu):
    """-y'b + zl'lb - zu'ub over finite bounds (reference dual_objective)."""
    out = -dot(y, b) if y.shape[-1] else lb.new_zeros(lb.shape[:-1])
    out = out + torch.where(has_lb, zl * lb, 0.0).sum(-1)
    out = out - torch.where(has_ub, zu * ub, 0.0).sum(-1)
    return out


def dual_infeasibility(g, jacl, zl, zu):
    """||g + A'y - zl + zu||_inf (MadNLP get_inf_du with sd=1)."""
    return _inf_norm(g + jacl - zl + zu)


def primal_infeasibility(c_res):
    """||A x - b||_inf (MadNLP get_inf_pr)."""
    return _inf_norm(c_res)


# ---------------------------------------------------------------------------
# Initialization helpers (reference src/solver.jl:6-124 + MadNLP initialize!)
# ---------------------------------------------------------------------------


def relax_bounds(lb, ub, has_lb, has_ub, tol):
    """MadNLP bound_relax_factor semantics: relax each finite bound by
    tol * max(1, |bound|)."""
    lb2 = torch.where(has_lb, lb - tol * torch.clamp(lb.abs(), min=1.0), lb)
    ub2 = torch.where(has_ub, ub + tol * torch.clamp(ub.abs(), min=1.0), ub)
    return lb2, ub2


def push_inside_bounds(x, lb, ub, has_lb, has_ub, bound_push, bound_fac):
    """Ipopt-style initial push of x strictly inside its bounds."""
    width = torch.where(has_lb & has_ub, ub - lb, math.inf)
    pl = torch.minimum(bound_push * torch.clamp(lb.abs(), min=1.0),
                       bound_fac * width)
    pu = torch.minimum(bound_push * torch.clamp(ub.abs(), min=1.0),
                       bound_fac * width)
    x = torch.where(has_lb, torch.maximum(x, lb + pl), x)
    x = torch.where(has_ub, torch.minimum(x, ub - pu), x)
    return x


def project_bound_fac(x, lb, ub, has_lb, has_ub, kappa):
    """Ipopt projection used by the Mehrotra starting point
    (reference src/solver.jl:101-118): note max(1, l) — not abs — faithfully
    reproduced."""
    lb_inf = torch.where(has_lb, lb, -math.inf)
    ub_inf = torch.where(has_ub, ub, math.inf)
    width = ub_inf - lb_inf
    pl = torch.minimum(kappa * torch.clamp(lb_inf, min=1.0), kappa * width)
    pu = torch.minimum(kappa * torch.clamp(ub_inf, min=1.0), kappa * width)
    x = torch.where(has_lb & (x < lb_inf), lb_inf + pl, x)
    x = torch.where(has_ub & (ub_inf < x), ub_inf - pu, x)
    return x


def init_bound_duals(r, has_lb, has_ub, zl_prev, zu_prev):
    """Mehrotra dual init from the dual residual r = g + A'y
    (reference src/solver.jl:37-66): two-sided bounds split r in half."""
    both = has_lb & has_ub
    zl = torch.where(both, 0.5 * r, torch.where(has_lb, r, zl_prev))
    zu = torch.where(both, -0.5 * r, torch.where(has_ub, -r, zu_prev))
    return torch.where(has_lb, zl, 0.0), torch.where(has_ub, zu, 0.0)


def _finite_or_zero(v):
    return torch.where(torch.isfinite(v), v, 0.0)


def mehrotra_positivity_shift(x, lb, ub, has_lb, has_ub, zl, zu):
    """Positivity shifts delta_x/delta_s + second-order shifts
    (reference src/solver.jl:68-99).  Two-sided x entries receive +delta then
    -delta (net zero), matching the reference's aliased views."""
    sl = torch.where(has_lb, x - lb, math.inf)
    su = torch.where(has_ub, ub - x, math.inf)
    min_sl = _finite_or_zero(_min_or_inf(sl))
    min_su = _finite_or_zero(_min_or_inf(su))
    delta_x = per_lane(
        torch.clamp(torch.maximum(-1.5 * min_sl, -1.5 * min_su), min=0.0))

    zl_min = _finite_or_zero(_min_or_inf(torch.where(has_lb, zl, math.inf)))
    zu_min = _finite_or_zero(_min_or_inf(torch.where(has_ub, zu, math.inf)))
    delta_s = per_lane(
        torch.clamp(torch.maximum(-1.5 * zl_min, -1.5 * zu_min), min=0.0))

    # x shift: +delta on lb-only side, -delta on ub-only side, 0 two-sided.
    side = has_lb.to(x.dtype) - has_ub.to(x.dtype)
    x = x + delta_x * side
    zl = torch.where(has_lb, zl + 1.0 + delta_s, 0.0)
    zu = torch.where(has_ub, zu + 1.0 + delta_s, 0.0)

    # Second-order shifts.
    sl2 = torch.where(has_lb, x - lb, 0.0)
    su2 = torch.where(has_ub, ub - x, 0.0)
    mu0 = (torch.where(has_lb, sl2 * zl, 0.0).sum(-1)
           + torch.where(has_ub, su2 * zu, 0.0).sum(-1))
    sum_z = (torch.where(has_lb, zl, 0.0).sum(-1)
             + torch.where(has_ub, zu, 0.0).sum(-1))
    sum_s = sl2.sum(-1) + su2.sum(-1)
    delta_x2 = per_lane(torch.where(
        sum_z > 0, mu0 / (2.0 * torch.clamp(sum_z, min=1e-300)), 0.0))
    delta_s2 = per_lane(torch.where(
        sum_s > 0, mu0 / (2.0 * torch.clamp(sum_s, min=1e-300)), 0.0))

    x = x + delta_x2 * side
    zl = torch.where(has_lb, zl + delta_s2, 0.0)
    zu = torch.where(has_ub, zu + delta_s2, 0.0)
    return x, zl, zu


def adjust_boundary(x, lb, ub, has_lb, has_ub, mu, eps):
    """Relax bounds whose slack collapsed below eps*mu
    (MadNLP.adjust_boundary! called at reference src/solver.jl:342)."""
    c1 = eps * per_lane(mu)
    c2 = eps ** 0.75
    lb2 = torch.where(
        has_lb & (x - lb < c1), lb - c2 * torch.clamp(x.abs(), min=1.0), lb
    )
    ub2 = torch.where(
        has_ub & (ub - x < c1), ub + c2 * torch.clamp(x.abs(), min=1.0), ub
    )
    return lb2, ub2
