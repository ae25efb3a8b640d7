"""The Mehrotra predictor-corrector core (port of `madqp_tpu/solver/mpc.py`).

One `iteration(prob, state) -> state` holds the factorization (with the
regularization retry loop), predictor, barrier update, corrector, optional
Gondzio multi-corrections, step rule and iterate update, as in the
reference's mpc! loop (src/solver.jl:188-345).  The reference traces this
into one XLA program (`lax.while_loop`, `lax.scan`, `lax.switch`,
`lax.cond`); here it runs eagerly and the control flow is Python:

  * the retry loop, the phase sequence, the work/finish branch and the
    MPC loop itself are host loops and branches;
  * each host decision reads its scalars with one device sync: the
    termination/stall flags once per iteration, `factor_ok` once per
    factorization trial, the direction's failure flag once per iteration;
  * everything else (ratio tests, Gondzio acceptance, step lengths) stays
    in 0-d tensors on the device, selected with `torch.where`.

`BatchedMPCKernel` runs the same iteration over a batch of problems
(leading lane axis), lane-masked: it reproduces what `jax.vmap` makes of
the reference's `iteration`, with the device-side math of `MPCKernel`
(residuals, solve_system, direction, step rule, regularization, the
starting point) shared by both.

The numerics are the reference's: refinement starts from d = 0 and runs
1 + max_refine_steps correction steps (step 0 is the plain backsolve), the
phase lists are predictor/corrector/Gondzio and, on the first call, the two
starting-point least-squares solves, and a failed step keeps the previous
iterate with status STEP_ERROR.
"""

from __future__ import annotations

import torch

from ..ops import kernels as K
from ..ops.kkt import DenseCondensedKKT, kkt_mul, make_kkt, torch_dtype
from ..utils.options import (
    IPMOptions,
    AdaptiveRegularization,
    AdaptiveStep,
    ConservativeStep,
    FixedRegularization,
    MehrotraAdaptiveStep,
    NoRegularization,
)
from .state import (
    DIVERGED,
    IPMState,
    MAX_ITER,
    ProblemArrays,
    RUNNING,
    STALLED,
    STEP_ERROR,
    SUCCESS,
)

_MAX_FACT_TRIALS = 3      # reference src/linear_solver.jl:7
_REG_ESCALATION = 100.0   # reference src/linear_solver.jl:14-15
_GONDZIO_DELTA = 0.1      # reference src/solver.jl:201-205
_GONDZIO_BETA_MIN = 0.1
_GONDZIO_BETA_MAX = 10.0
_GONDZIO_TAU = 0.995
_GONDZIO_ACCEPT = 1.005   # reference src/solver.jl:241
# The ROADMAP.md item that brings the remaining KKT backends to a batch.
BATCH_ITEM = "Queue 1, item 18"


def _select(pred, a: K.KKTVec, b: K.KKTVec) -> K.KKTVec:
    """Field-wise torch.where(pred, a, b) for a device-side pred: 0-d, or
    one per lane (B,) for a batch."""
    pred = K.per_lane(pred)
    return K.KKTVec(*(torch.where(pred, u, v) for u, v in zip(a, b)))


def tree_map(fn, tree, *rest):
    """`fn` over the matching tensor fields of NamedTuples of one type
    (states, problems, factors; a KKTVec field field by field).  A field
    that is not a tensor (None, a host flag) is taken from `tree`: it must
    be the same in all."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, *fields) for fields in zip(tree, *rest)))
    return fn(tree, *rest) if isinstance(tree, torch.Tensor) else tree


def select_lanes(pred: torch.Tensor, a, b):
    """Lane by lane, `a` where pred (B,) holds and `b` elsewhere."""
    return tree_map(lambda u, v: u if u is v else torch.where(
        pred.view(pred.shape + (1,) * (u.dim() - pred.dim())), u, v), a, b)


class MPCKernel:
    """MPC solver core: static options + methods over problem tensors."""

    def __init__(self, opts: IPMOptions, kkt=None):
        self.opts = opts
        fact_dtype = opts.factorization_dtype or None
        self.kkt = kkt if kkt is not None else make_kkt(
            opts.kkt_system, fact_dtype=fact_dtype,
            chol_backend=(opts.linear_solver
                          if opts.linear_solver in ("pallas", "blocked")
                          else "xla"),
            solve_mode=opts.solve_mode,
        )
        self.dtype = torch_dtype(opts.dtype)
        self.eps = torch.finfo(self.dtype).eps

    def _scalar(self, p: ProblemArrays, value) -> torch.Tensor:
        return torch.tensor(value, dtype=self.dtype, device=p.c.device)

    # -- model callbacks (dense; reference L3 eval wrappers) ----------------

    def objective(self, p, x):
        val = p.c0 + K.dot(p.c, x)
        if not p.is_lp:
            val = val + 0.5 * K.dot(x, p.hess_mv(x))
        return val

    def gradient(self, p, x):
        return p.c if p.is_lp else p.c + p.hess_mv(x)

    def cons_residual(self, p, x):
        return p.jac_mv(x) - p.b

    def jtprod(self, p, y):
        return p.jac_rmv(y)

    # -- linear algebra -----------------------------------------------------

    def _factorize(self, p, x, lb, ub, zl, zu, del_w, del_c):
        pr_diag = K.sigma_diagonal(x, lb, ub, p.has_lb, p.has_ub, zl, zu, del_w)
        f = self.kkt.factorize(p, pr_diag, del_c)
        return f, self.kkt.factor_ok(f)

    def factorize_with_retry(self, p, x, lb, ub, zl, zu, del_w, del_c):
        """Factorize; on failure escalate both regularizations by 100x, up
        to 3 trials (reference factorize_regularized_system!).  Zero
        regularization is seeded with a small nonzero so singular KKT
        systems (e.g. rank-deficient A) still factor.

        Returns (factors, del_w, del_c, ok) with `ok` a host bool."""
        dw, dc = del_w, del_c
        for trial in range(_MAX_FACT_TRIALS):
            if trial > 0:
                dw = torch.where(dw != 0.0, dw * _REG_ESCALATION, 1e-8)
                dc = torch.where(dc != 0.0, dc * _REG_ESCALATION, -1e-8)
            f, ok = self._factorize(p, x, lb, ub, zl, zu, dw, dc)
            if ok.item():
                return f, dw, dc, True
        return f, dw, dc, False

    def solve_system(self, p, factors, p_rhs, x, lb, ub, zl, zu, del_w, del_c):
        """Unreduced KKT solve + residual check
        (reference solve_system!, src/linear_solver.jl:19-45).

        Returns (d, ok): ok (0-d bool tensor) is False when the residual
        ratio is NaN, or — with check_residual — exceeds tol_linear_solve.
        """
        masks = (p.has_lb, p.has_ub)

        def backsolve(rhs):
            rx, ry = K.reduce_rhs(rhs, x, lb, ub, *masks)
            dx, dy = self.kkt.solve(factors, rx, ry)
            dzl, dzu = K.recover_bound_duals(rhs, dx, x, lb, ub, *masks, zl, zu)
            return K.KKTVec(x=dx, y=dy, zl=dzl, zu=dzu)

        def residual(d):
            return p_rhs.sub(
                kkt_mul(p, del_w, del_c, x, lb, ub, *masks, zl, zu, d))

        # Refinement from d = 0: residual(0) == p_rhs, so step 0 is the
        # plain backsolve; then max_refine_steps correction steps.
        d = backsolve(p_rhs)
        for _ in range(self.opts.max_refine_steps):
            d = d.add(backsolve(residual(d)))

        w = residual(d)
        ratio = w.flat_inf_norm() / torch.clamp(p_rhs.flat_inf_norm(), min=1.0)
        ok = ~torch.isnan(ratio)
        if self.opts.check_residual:
            ok = ok & (ratio <= self.opts.tol_linear_solve)
        return d, ok

    # -- regularization policy (src/kernels.jl:380-417) ---------------------

    def _init_regularization(self, p):
        reg = self.opts.regularization
        one = self._scalar(p, 1.0)
        zero = self._scalar(p, 0.0)
        if isinstance(reg, NoRegularization):
            return one, zero, zero, zero
        dd = self._scalar(p, reg.delta_d)
        dp = self._scalar(p, reg.delta_p)
        return one, dd, dp, dd

    def _update_regularization(self, p, state: IPMState):
        reg = self.opts.regularization
        if isinstance(reg, NoRegularization):
            zero = self._scalar(p, 0.0)
            return zero, zero, state.reg_p, state.reg_d
        if isinstance(reg, FixedRegularization):
            return (self._scalar(p, reg.delta_p), self._scalar(p, reg.delta_d),
                    state.reg_p, state.reg_d)
        assert isinstance(reg, AdaptiveRegularization)
        new_p = torch.clamp(state.reg_p / 10.0, min=reg.delta_min)
        new_d = torch.clamp(state.reg_d / 10.0, max=-reg.delta_min)
        return new_p, new_d, new_p, new_d

    # -- step rule (src/kernels.jl:307-374) ----------------------------------

    def _step_rule(self, p, d, x, lb, ub, zl, zu, mu):
        rule = self.opts.step_rule
        args = (d, x, lb, ub, p.has_lb, p.has_ub, zl, zu)
        if isinstance(rule, ConservativeStep):
            return K.fraction_to_boundary(*args, rule.tau)
        if isinstance(rule, AdaptiveStep):
            tau = torch.clamp(1.0 - mu, min=rule.tau_min)
            return K.fraction_to_boundary(*args, tau)
        assert isinstance(rule, MehrotraAdaptiveStep)
        return K.step_mehrotra_adaptive(
            d, x, lb, ub, p.has_lb, p.has_ub, zl, zu, mu, rule.gamma_f
        )

    # -- direction: predictor + corrector + Gondzio ---------------------------

    def _n_bounded(self, p):
        """Barrier-gate count: bounded entries, or with
        barrier_gate="one-sided" the reference's one-sided gate
        (src/kernels.jl:227-233)."""
        if self.opts.barrier_gate == "one-sided":
            return ((p.has_lb & ~p.has_ub).sum(-1)
                    + (~p.has_lb & p.has_ub).sum(-1))
        return p.has_lb.sum(-1) + p.has_ub.sum(-1)

    def _direction(self, p, state: IPMState, factors, g, jacl, c_res,
                   del_w, del_c):
        """Returns (d, mu_new, failed): the search direction after predictor
        + corrector + max_ncorr Gondzio corrections (reference
        src/solver.jl:200-251,294-324), the updated barrier, and the
        accumulated hard-failure flag (a bool tensor, one per lane in a
        batch).  Before the starting point (state.initialized False) it
        instead runs the two starting-point least-squares solves (reference
        src/solver.jl:6-33): with zl = zu = 0 the unreduced KKT degenerates
        exactly to the del_w-regularized least-squares system."""
        x, zl, zu, lb, ub = state.x, state.zl, state.zu, state.lb, state.ub
        masks = (p.has_lb, p.has_ub)
        bounds = (x, lb, ub, *masks, zl, zu)
        opt = self.opts
        mu_curr = K.complementarity_measure(*bounds)
        lanes = x.shape[:-1]

        def solve(rhs):
            return self.solve_system(p, factors, rhs, x, lb, ub, zl, zu,
                                     del_w, del_c)

        if not state.initialized:
            d_p, _ = solve(K.initial_primal_rhs(c_res, p.n, self.dtype))
            d_d, _ = solve(K.initial_dual_rhs(g, p.m, self.dtype))
            zero_n = torch.zeros_like(x)
            d = K.KKTVec(x=d_p.x, y=d_d.y, zl=zero_n, zu=zero_n)
            return d, mu_curr, torch.zeros(lanes, dtype=torch.bool, device=x.device)

        # Predictor.
        d, ok = solve(K.predictor_rhs(g, jacl, c_res, *bounds))
        failed = ~ok

        # Mehrotra corrector.
        a_aff_p, a_aff_d = K.fraction_to_boundary(d, *bounds, 1.0)
        mu_aff = K.affine_complementarity_measure(d, *bounds, a_aff_p, a_aff_d)
        corr_lb, corr_ub = K.mehrotra_correction(d, *masks)
        bar = opt.barrier_update
        mu_new = K.mehrotra_barrier(mu_curr, mu_aff, self._n_bounded(p),
                                    opt.mu_min, bar.sigma_min, bar.sigma_max)
        d, ok = solve(K.correction_rhs(g, jacl, c_res, *bounds, mu_new,
                                       corr_lb, corr_ub))
        failed = failed | ~ok
        # Seed the Gondzio loop's running step lengths.
        a_p, a_d = K.fraction_to_boundary(d, *bounds, _GONDZIO_TAU)

        # Gondzio multi-centrality corrections; a correction is kept only
        # when it lengthens both steps, and the loop goes inactive after
        # the first rejection (device-side selects, no host sync).
        active = torch.ones(lanes, dtype=torch.bool, device=x.device)
        for _ in range(opt.max_ncorr):
            tilde_p = torch.clamp(a_p + _GONDZIO_DELTA, max=1.0)
            tilde_d = torch.clamp(a_d + _GONDZIO_DELTA, max=1.0)
            ga = K.affine_complementarity_measure(d, *bounds, tilde_p, tilde_d)
            mu_g = (ga / torch.clamp(mu_curr, min=1e-300)) ** 2 * ga  # Eq. (12)
            cand_lb, cand_ub = K.gondzio_extra_correction(
                d, *bounds, corr_lb, corr_ub, tilde_p, tilde_d,
                _GONDZIO_BETA_MIN, _GONDZIO_BETA_MAX, mu_g,
            )
            d_new, ok = solve(K.correction_rhs(g, jacl, c_res, *bounds, mu_g,
                                               cand_lb, cand_ub))
            hat_p, hat_d = K.fraction_to_boundary(d_new, *bounds, _GONDZIO_TAU)
            accept = ((hat_p >= _GONDZIO_ACCEPT * a_p)
                      & (hat_d >= _GONDZIO_ACCEPT * a_d) & active)
            failed = failed | (active & ~ok)
            d = _select(accept, d_new, d)
            corr_lb = torch.where(K.per_lane(accept), cand_lb, corr_lb)
            corr_ub = torch.where(K.per_lane(accept), cand_ub, corr_ub)
            a_p = torch.where(accept, hat_p, a_p)
            a_d = torch.where(accept, hat_d, a_d)
            active = accept
        return d, mu_new, failed

    # -- one MPC iteration (src/solver.jl:254-344) ---------------------------

    def _residuals(self, p: ProblemArrays, state: IPMState):
        """Objective and scaled residual norms at the current iterate, stored
        in the state.  Returns (state, g, c_res, jacl, worst, diverged):
        worst is the largest scaled residual, diverged the infeasibility
        signature (a detection the reference lacks): dual side converged +
        primal infeasibility stuck + diverging multipliers => primal
        infeasible; the mirrored conditions with a diverging primal iterate
        => dual infeasible (unbounded)."""
        masks = (p.has_lb, p.has_ub)
        x, y, zl, zu, lb, ub = state.x, state.y, state.zl, state.zu, state.lb, state.ub

        g = self.gradient(p, x)
        c_res = self.cons_residual(p, x)
        jacl = self.jtprod(p, y)

        obj = self.objective(p, x)
        inf_pr = K.primal_infeasibility(c_res) / torch.clamp(state.norm_b, min=1.0)
        inf_du = K.dual_infeasibility(g, jacl, zl, zu) / torch.clamp(
            state.norm_c, min=1.0)
        inf_compl = K.optimality_gap(x, lb, ub, *masks, zl, zu) / torch.clamp(
            state.norm_c, min=1.0)
        state = state._replace(
            obj_val=obj, inf_pr=inf_pr, inf_du=inf_du, inf_compl=inf_compl
        )

        worst = torch.maximum(torch.maximum(inf_pr, inf_du), inf_compl)
        tol = self.opts.tol
        stuck = 1e3 * tol
        dual_mag = torch.maximum(
            K._inf_norm(y), torch.maximum(K._inf_norm(zl), K._inf_norm(zu))
        )
        primal_infeas = (
            (inf_du <= tol) & (inf_compl <= tol) & (inf_pr > stuck)
            & (dual_mag > self.opts.diverge_tol)
        )
        dual_infeas = (
            (inf_pr <= tol) & (inf_compl <= tol) & (inf_du > stuck)
            & (K._inf_norm(x) > self.opts.diverge_tol)
        )
        return state, g, c_res, jacl, worst, primal_infeas | dual_infeas

    def iteration(self, p: ProblemArrays, state: IPMState) -> IPMState:
        state, g, c_res, jacl, worst, diverged = self._residuals(p, state)
        initialized = state.initialized
        improved = worst < 0.9 * state.best_worst
        # One device sync for every termination decision of this iteration.
        converged, diverged, improved = torch.stack(
            [worst <= self.opts.tol, diverged, improved]).tolist()
        if converged:
            new_status = SUCCESS
        elif diverged:
            new_status = DIVERGED
        elif state.k >= self.opts.max_iter:
            new_status = MAX_ITER
        else:
            new_status = RUNNING
        # Before the starting point is computed the residuals above are
        # measured at the raw pushed x0 — never a termination verdict.
        if not initialized:
            new_status = RUNNING

        # Stall detection (opts.stall_exit > 0): a low-precision phase that
        # has hit its precision floor burns iterations without progress —
        # exit after stall_exit consecutive iterations without a 10%
        # improvement of the best max-infeasibility seen.
        if self.opts.stall_exit > 0:
            stall_k = 0 if (improved or not initialized) else state.stall_k + 1
            if new_status == RUNNING and stall_k >= self.opts.stall_exit:
                new_status = STALLED
            state = state._replace(
                best_worst=(torch.minimum(worst, state.best_worst)
                            if initialized else state.best_worst),
                stall_k=stall_k,
            )

        if new_status != RUNNING or state.status != RUNNING:
            # Finish: a terminal state stays frozen when dispatched again.
            return state._replace(status=(new_status if state.status == RUNNING
                                          else state.status))
        return self._work(p, state, g, c_res, jacl)

    def _work_regularization(self, p, state: IPMState):
        """(del_w, del_c, reg_p, reg_d) of this iteration's factorization.
        The first call (starting point) keeps the init-regularization seeds
        stored by init_state (reference src/solver.jl:16-18)."""
        if state.initialized:
            return self._update_regularization(p, state)
        return state.del_w, state.del_c, state.reg_p, state.reg_d

    def _work(self, p, state: IPMState, g, c_res, jacl) -> IPMState:
        del_w, del_c, reg_p, reg_d = self._work_regularization(p, state)
        factors, del_w, del_c, fact_ok = self.factorize_with_retry(
            p, state.x, state.lb, state.ub, state.zl, state.zu, del_w, del_c
        )
        d, mu_new, dir_failed = self._direction(
            p, state, factors, g, jacl, c_res, del_w, del_c)
        regs = (del_w, del_c, reg_p, reg_d)
        if not state.initialized:
            return self._starting_point(p, state, g, d, *regs)
        if not fact_ok or dir_failed.item():
            return state._replace(status=STEP_ERROR)
        return self._advance(p, state, d, mu_new, *regs)

    def _starting_point(self, p, state: IPMState, g, d, del_w, del_c,
                        reg_p, reg_d) -> IPMState:
        """First call: finish the Mehrotra starting point (reference
        src/solver.jl:37-123 — bound-dual init from the dual residual,
        positivity + second-order shifts, Ipopt projection).  Solve
        failures are not fatal here, matching the reference."""
        masks = (p.has_lb, p.has_ub)
        xi = state.x + d.x
        yi = d.y
        r = g + self.jtprod(p, yi)
        ones_n = torch.ones_like(state.x)
        zli, zui = K.init_bound_duals(r, *masks, ones_n, ones_n)
        xi, zli, zui = K.mehrotra_positivity_shift(
            xi, state.lb, state.ub, *masks, zli, zui
        )
        xi = K.project_bound_fac(xi, state.lb, state.ub, *masks, self.opts.bound_fac)
        return state._replace(
            x=xi, y=yi, zl=zli, zu=zui,
            mu=self._scalar(p, self.opts.mu_init),
            del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
            obj_val=self.objective(p, xi),
            n_fact=state.n_fact + 1,
            n_solve=state.n_solve + 2,
            initialized=True,
        )

    def _advance(self, p, state: IPMState, d, mu_new, del_w, del_c,
                 reg_p, reg_d) -> IPMState:
        """Step computation + iterate update."""
        masks = (p.has_lb, p.has_ub)
        x, y, zl, zu, lb, ub = state.x, state.y, state.zl, state.zu, state.lb, state.ub
        alpha_p, alpha_d = self._step_rule(p, d, x, lb, ub, zl, zu, mu_new)
        a_p, a_d = K.per_lane(alpha_p), K.per_lane(alpha_d)
        x_new = x + a_p * d.x
        lb_new, ub_new = K.adjust_boundary(
            x_new, lb, ub, *masks, mu_new, self.eps
        )
        return state._replace(
            x=x_new,
            y=y + a_d * d.y,
            zl=torch.where(p.has_lb, zl + a_d * d.zl, 0.0),
            zu=torch.where(p.has_ub, zu + a_d * d.zu, 0.0),
            lb=lb_new, ub=ub_new,
            d=d, mu=mu_new,
            del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
            alpha_p=alpha_p, alpha_d=alpha_d,
            d_norm=K._inf_norm(d.x),
            k=state.k + 1,
            n_fact=state.n_fact + 1,
            n_solve=state.n_solve + 2 + self.opts.max_ncorr,
        )

    # -- starting point (src/solver.jl:6-182) --------------------------------

    def _initial_state(self, p, x, y, zl, zu, lb, ub, mu, norm_c,
                       initialized) -> IPMState:
        del_w, del_c, reg_p, reg_d = self._init_regularization(p)
        zero = self._scalar(p, 0.0)
        zero_n = torch.zeros_like(x)
        return IPMState(
            x=x, y=y, zl=zl, zu=zu, lb=lb, ub=ub,
            d=K.KKTVec(x=zero_n, y=torch.zeros_like(y), zl=zero_n, zu=zero_n),
            mu=mu,
            del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
            alpha_p=self._scalar(p, 1.0), alpha_d=self._scalar(p, 1.0),
            obj_val=self.objective(p, x),
            inf_pr=zero, inf_du=zero, inf_compl=zero,
            d_norm=zero, norm_b=K._inf_norm(p.b), norm_c=norm_c,
            k=0, n_fact=0, n_solve=0, status=RUNNING,
            best_worst=self._scalar(p, float("inf")), stall_k=0,
            initialized=initialized,
        )

    def init_state_warm(self, p, x0, y0, zl0, zu0, lb0, ub0) -> IPMState:
        """Warm start (beyond the reference): push the supplied primal-dual
        point strictly inside bounds/positivity and start iterating, skipping
        the starting-point least-squares solves."""
        masks = (p.has_lb, p.has_ub)
        opt = self.opts
        lb, ub = K.relax_bounds(lb0, ub0, *masks, opt.bound_relax_factor)
        x = K.push_inside_bounds(
            x0, lb, ub, *masks, opt.bound_push, opt.bound_fac
        )
        zl = torch.where(p.has_lb, torch.clamp(zl0, min=1e-8), 0.0)
        zu = torch.where(p.has_ub, torch.clamp(zu0, min=1e-8), 0.0)
        # Barrier consistent with the supplied point.
        mu0 = K.complementarity_measure(x, lb, ub, *masks, zl, zu)
        mu0 = torch.clamp(mu0, opt.mu_min, opt.mu_init)
        return self._initial_state(p, x, y0, zl, zu, lb, ub, mu0,
                                   K._inf_norm(self.gradient(p, x)), True)

    def init_state(self, p: ProblemArrays, x0, y0, lb0, ub0) -> IPMState:
        """Cheap pre-loop state: bound relaxation + interior push only.

        The Mehrotra starting point itself (del_w-seeded factorization, two
        least-squares KKT solves, bound-dual init, shifts, projection —
        reference src/solver.jl:6-123) runs inside the FIRST `iteration`
        call, gated on `initialized`, as in the reference.  With zl = zu = 0
        the in-loop sigma diagonal is exactly del_w, so the first call's
        factorization IS the reference's starting-point system."""
        masks = (p.has_lb, p.has_ub)
        opt = self.opts
        lb, ub = K.relax_bounds(lb0, ub0, *masks, opt.bound_relax_factor)
        x = K.push_inside_bounds(
            x0, lb, ub, *masks, opt.bound_push, opt.bound_fac
        )
        zero_n = torch.zeros_like(x)
        return self._initial_state(p, x, y0, zero_n, zero_n, lb, ub,
                                   self._scalar(p, opt.mu_init),
                                   K._inf_norm(self.gradient(p, x)), False)


class BatchedMPCKernel(MPCKernel):
    """The MPC iteration over a batch of problems (a leading lane axis on
    every tensor), lane-masked: what `jax.vmap` makes of the reference's
    `MPCKernel.iteration` (madqp_tpu/solver/mpc.py:406-590).

    * The finish/work `lax.cond` is a per-lane select: a lane whose status
      has left RUNNING keeps its iterate, and its `k` stops.
    * The retry `while_loop` is per lane: a lane that factors on trial 0
      keeps its factor and its `del_w`/`del_c`; only the lanes that failed
      escalate.  The loop runs while a working lane has failed and has
      trials left: one host sync per trial.
    * Stall detection and the termination flags are per lane; one host
      sync per iteration skips the work when no lane works any more.
    The scalars of the state are (B,) tensors, the counters and the status
    int64 (B,); `initialized` stays one host bool, since all lanes start
    and warm-restart together.  The host loop that steps it
    (`parallel/batched.py::run_lanes`) freezes the lanes that had stopped
    before the call, as the vmapped `while_loop` does.

    The KKT backends with a batched form are the condensed and normal
    systems on `dense` and `pallas` (K1 in its one-CTA-per-matrix form);
    the others raise `NotImplementedError` naming ROADMAP.md's item."""

    def __init__(self, opts: IPMOptions, kkt=None):
        super().__init__(opts, kkt)
        unported = (f"kkt_system={opts.kkt_system!r}"
                    if not isinstance(self.kkt, DenseCondensedKKT)
                    else "linear_solver='blocked'" if opts.linear_solver == "blocked"
                    else "solve_mode='inverse'" if opts.solve_mode == "inverse"
                    else None)
        if unported:
            raise NotImplementedError(
                f"{unported} on a batch of problems is not ported yet "
                f"(ROADMAP.md {BATCH_ITEM})")

    def _scalar(self, p, value) -> torch.Tensor:
        return torch.full(p.c.shape[:-1], value, dtype=self.dtype,
                          device=p.c.device)

    def _counter(self, p, value=0) -> torch.Tensor:
        return torch.full(p.c.shape[:-1], value, dtype=torch.int64,
                          device=p.c.device)

    def _initial_state(self, p, *args) -> IPMState:
        zero = self._counter(p)
        return super()._initial_state(p, *args)._replace(
            k=zero, n_fact=zero, n_solve=zero,
            status=self._counter(p, RUNNING), stall_k=zero)

    def factorize_with_retry(self, p, x, lb, ub, zl, zu, del_w, del_c, active):
        """Per-lane retry over the lanes in `active` (B,): a lane whose
        factor fails escalates both regularizations by 100x (zero seeded
        with a small nonzero), up to 3 trials.  Each trial factors the
        whole batch and keeps the new factor only in the retried lanes.
        Returns (factors, del_w, del_c, ok) with ok (B,) on the device."""
        dw, dc = del_w, del_c
        f, ok = self._factorize(p, x, lb, ub, zl, zu, dw, dc)
        for _ in range(1, _MAX_FACT_TRIALS):
            retry = active & ~ok
            if not bool(retry.any()):
                break
            dw = torch.where(retry, torch.where(dw != 0.0, dw * _REG_ESCALATION, 1e-8), dw)
            dc = torch.where(retry, torch.where(dc != 0.0, dc * _REG_ESCALATION, -1e-8), dc)
            f_new, ok_new = self._factorize(p, x, lb, ub, zl, zu, dw, dc)
            f = select_lanes(retry, f_new, f)
            ok = torch.where(retry, ok_new, ok)
        return f, dw, dc, ok

    def iteration(self, p: ProblemArrays, state: IPMState) -> IPMState:
        state, g, c_res, jacl, worst, diverged = self._residuals(p, state)
        opt = self.opts
        if state.initialized:
            new_status = torch.where(
                worst <= opt.tol, SUCCESS,
                torch.where(diverged, DIVERGED,
                            torch.where(state.k >= opt.max_iter, MAX_ITER, RUNNING)))
        else:
            new_status = self._counter(p, RUNNING)
        if opt.stall_exit > 0:
            if state.initialized:
                stall_k = torch.where(worst < 0.9 * state.best_worst, 0,
                                      state.stall_k + 1)
                best = torch.minimum(worst, state.best_worst)
            else:
                stall_k, best = self._counter(p), state.best_worst
            new_status = torch.where(
                (new_status == RUNNING) & (stall_k >= opt.stall_exit),
                STALLED, new_status)
            state = state._replace(best_worst=best, stall_k=stall_k)

        running = state.status == RUNNING
        finished = state._replace(status=torch.where(running, new_status, state.status))
        work = running & (new_status == RUNNING)
        if not bool(work.any()):  # one sync: the last call factors nothing
            return finished
        return select_lanes(work, self._work(p, state, g, c_res, jacl, work),
                            finished)

    def _work(self, p, state: IPMState, g, c_res, jacl, active) -> IPMState:
        del_w, del_c, reg_p, reg_d = self._work_regularization(p, state)
        factors, del_w, del_c, fact_ok = self.factorize_with_retry(
            p, state.x, state.lb, state.ub, state.zl, state.zu, del_w, del_c,
            active)
        d, mu_new, dir_failed = self._direction(
            p, state, factors, g, jacl, c_res, del_w, del_c)
        regs = (del_w, del_c, reg_p, reg_d)
        if not state.initialized:
            return self._starting_point(p, state, g, d, *regs)
        return select_lanes(~fact_ok | dir_failed,
                            state._replace(status=self._counter(p, STEP_ERROR)),
                            self._advance(p, state, d, mu_new, *regs))
