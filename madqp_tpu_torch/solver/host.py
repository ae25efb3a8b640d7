"""Host sparse MPC solver: the CPU path (port of `madqp_tpu/solver/host.py`).

The reference's CPU configuration (scripts/benchmarks_cpu.jl: LDLSolver +
NormalKKTSystem): the IPM math runs the package's masked kernels
(`ops/kernels.py`, `ops/kkt.py::kkt_mul`) on CPU float64 tensors, the
matvecs are SciPy's, and the per-iteration KKT factorization is the native
C++ sparse LDL^T (`madqp_tpu_torch.native.SparseLDL`) with a fixed
symbolic pattern: the reference's build-once / refactor-every-iteration
split (normalkkt.jl:94-97 vs :166-180).

This is the host path by design, not a fallback of a device path: it takes
no `device=`, and nothing sends a device solve here except where the JAX
package does (the sparse drivers' `endgame="host"` and their whole-solve
host route, the batched solver's host rescue).  It measures a true
`linear_solver_time` (the reference's 9-column schema,
scripts/benchmarks_cpu.jl:55).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..models.qp import QuadraticProblem, SparseStandardQP, build_standard_form_sparse
from ..native import SparseLDL
from ..ops import kernels as K
from ..ops.kkt import kkt_mul
from ..utils import (
    Counters,
    ExecutionStats,
    MadLogger,
    Status,
    get_status_output,
    load_options,
)
from ..utils.logger import INFO
from ..utils.options import (
    AdaptiveRegularization,
    AdaptiveStep,
    ConservativeStep,
    FixedRegularization,
    MehrotraAdaptiveStep,
    NoRegularization,
)
from .certificates import farkas_certificate, unbounded_certificate
from .policy import user_stats

_MAX_FACT_TRIALS = 3
_REG_ESCALATION = 100.0
_GONDZIO = dict(delta=0.1, beta_min=0.1, beta_max=10.0, tau=0.995, accept=1.005)
_F64 = torch.float64


def _t(v) -> torch.Tensor:
    """A CPU float64 tensor of `v` (a NumPy array, a number or a tensor)."""
    return torch.as_tensor(v, dtype=_F64)


def _np(v) -> np.ndarray:
    """A float64 NumPy array of `v` (a CPU tensor or an array)."""
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float64)


class HostProblem:
    """Problem adapter with SciPy matvecs on CPU tensors (the protocol of
    `solver/state.py::ProblemArrays`)."""

    def __init__(self, std: SparseStandardQP):
        self.std = std
        self.c0 = float(std.c0)
        self.c = _t(std.c)
        self.b = _t(std.b)
        self.has_lb = torch.as_tensor(std.has_lb, dtype=torch.bool)
        self.has_ub = torch.as_tensor(std.has_ub, dtype=torch.bool)
        self.n = std.n
        self.m = std.m
        self.is_lp = std.is_lp
        self._H = std.H
        self._A = std.A.tocsr()
        self._AT = std.A.T.tocsr()

    def hess_mv(self, x):
        if self._H is None:
            return torch.zeros_like(_t(x))
        return _t(np.asarray(self._H @ _np(x)).ravel())

    def jac_mv(self, x):
        return _t(np.asarray(self._A @ _np(x)).ravel())

    def jac_rmv(self, y):
        return _t(np.asarray(self._AT @ _np(y)).ravel())


class HostK2KKT:
    """Sparse augmented (K2) system factored by the native LDL.

    Quasi-definite thanks to the always-on primal/dual regularization:
    signed LDL without pivoting, as the reference's FixedRegularization
    defaults justify."""

    name = "k2(host-ldl)"

    def __init__(self, prob: HostProblem):
        self.prob = prob
        n, m = prob.n, prob.m
        H = prob._H if prob._H is not None else sp.csc_matrix((n, n))
        K0 = sp.bmat(
            [[H + sp.eye(n), prob._A.T], [prob._A, sp.eye(m)]], format="csc"
        )
        self.ldl = SparseLDL(K0)
        self._H = H

    # Strictly negative dual-regularization floor: LDL without pivoting
    # requires strict quasi-definiteness (W > 0 AND -del_c > 0).  The
    # reference's LDL configurations always pass delta_d < 0 for the same
    # reason (test/runtests.jl:117-127); its del_c = 0 default relies on a
    # pivoting solver not used here.
    _DEL_C_FLOOR = -1e-12

    def factorize(self, pr_diag, del_c) -> bool:
        m = self.prob.m
        del_c = min(float(del_c), self._DEL_C_FLOOR)
        W = self._H + sp.diags(_np(pr_diag))
        Kmat = sp.bmat(
            [[W, self.prob._A.T],
             [self.prob._A, sp.eye(m) * del_c]],
            format="csc",
        )
        return self.ldl.factorize(Kmat)

    def factor_ok(self) -> bool:
        return self.ldl.is_factorized

    def solve(self, rx, ry):
        n = self.prob.n
        d = self.ldl.solve(np.concatenate([_np(rx), _np(ry)]))
        return _t(d[:n]), _t(d[n:])


class HostNormalKKT:
    """Sparse normal equations A W⁻¹ A' - dc I with W = Σ (+ diag(H)),
    native LDL-factored (reference NormalKKTSystem, normalkkt.jl:166-205).

    Extends the reference's LP-only system (normalkkt.jl:45-48) to
    separable (diagonal-Hessian) QPs, as the device path does: W stays
    diagonal, so the same SPD reduction is exact.  Non-diagonal Hessians
    are rejected."""

    name = "normal(host-ldl)"

    def __init__(self, prob: HostProblem):
        self._h_diag = None
        if not prob.is_lp:
            H = prob._H
            Hc = sp.coo_matrix(H) if H is not None else None
            if Hc is not None and Hc.nnz and not (Hc.row == Hc.col).all():
                raise ValueError(
                    "NormalKKT supports only linear programs "
                    "(reference normalkkt.jl:45-48) and diagonal-Hessian "
                    "QPs (device-path extension)."
                )
            if Hc is not None and Hc.nnz:
                hd = np.zeros(prob.n)
                np.add.at(hd, Hc.row, Hc.data)
                self._h_diag = hd
        self.prob = prob
        A = prob._A
        S0 = (A @ A.T + sp.eye(prob.m)).tocsc()
        self._pattern_eps = S0.copy()
        self._pattern_eps.data = np.zeros_like(self._pattern_eps.data)
        self.ldl = SparseLDL(S0)
        self._pr_diag: Optional[np.ndarray] = None

    def factorize(self, pr_diag, del_c) -> bool:
        self._pr_diag = _np(pr_diag)
        if self._h_diag is not None:
            self._pr_diag = self._pr_diag + self._h_diag
        A = self.prob._A
        D = 1.0 / self._pr_diag
        S = (A.multiply(D[None, :]) @ A.T - float(del_c) * sp.eye(self.prob.m))
        # Force the fixed symbolic pattern (union with an explicit-zero copy).
        S = (S + self._pattern_eps).tocsc()
        return self.ldl.factorize(S)

    def factor_ok(self) -> bool:
        return self.ldl.is_factorized

    def solve(self, rx, ry):
        D = 1.0 / self._pr_diag
        r1 = _np(rx) * D
        r2 = np.asarray(self.prob._A @ r1).ravel() - _np(ry)
        dy = self.ldl.solve(r2)
        dx = (_np(rx) - np.asarray(self.prob._AT @ dy).ravel()) * D
        return _t(dx), _t(dy)


class HostMPCSolver:
    """Mehrotra predictor-corrector on the host with the native sparse LDL."""

    def __init__(self, qp: QuadraticProblem, **kwargs):
        opts, ignored = load_options(**kwargs)
        self.opts = opts
        self.logger = MadLogger(
            print_level=opts.print_level,
            file_print_level=opts.file_print_level,
            output_file=opts.output_file,
        )
        if ignored:
            self.logger.print_ignored_options(ignored)
        self.qp = qp
        t0 = time.time()
        self.std, self.info, self._x0, self._y0 = build_standard_form_sparse(
            qp, scaling=opts.scaling, max_gradient=opts.max_gradient
        )
        self.prob = HostProblem(self.std)
        if opts.kkt_system == "normal":
            self.kkt = HostNormalKKT(self.prob)
        else:
            self.kkt = HostK2KKT(self.prob)
        self.cnt = Counters(start_time=t0, init_time=time.time() - t0)
        self.eps = float(np.finfo(np.float64).eps)
        self._warm = None

    @classmethod
    def from_device_options(cls, qp: QuadraticProblem, opts, kkt_system: Optional[str] = None,
                            print_level: int = 25) -> "HostMPCSolver":
        """The host solver of a device solve's fallback (the sparse drivers'
        host endgame and whole-solve route, the batch's host rescue), with
        the device solve's options `opts` (its tolerance, iteration cap,
        correctors, step rule, regularization, scaling, barrier gate and
        starting-point fields), printing at `print_level` or less, and the
        host's `kkt_system` ("normal", or the K2 system; None: the options'
        default)."""
        kw = {} if kkt_system is None else dict(kkt_system=kkt_system)
        return cls(
            qp, tol=opts.tol, max_iter=opts.max_iter, max_ncorr=opts.max_ncorr,
            step_rule=opts.step_rule, regularization=opts.regularization,
            print_level=max(opts.print_level, print_level),
            scaling=opts.scaling, max_gradient=opts.max_gradient,
            barrier_gate=opts.barrier_gate, mu_min=opts.mu_min,
            bound_push=opts.bound_push, bound_fac=opts.bound_fac,
            bound_relax_factor=opts.bound_relax_factor, **kw)

    def set_initial_point_internal(self, x, y, zl, zu):
        """Warm start from an INTERNAL-space primal-dual point (the same
        standard form this solver builds, e.g. a device float32 iterate
        handed to the host endgame, options.endgame='host').  Skips the
        three least-squares starting solves; the point is pushed strictly
        inside bounds and dual positivity is floored, as
        MPCKernel.init_state_warm does."""
        self._warm = tuple(_t(np.asarray(v, np.float64)) for v in (x, y, zl, zu))
        return self

    def _masks(self):
        return self.prob.has_lb, self.prob.has_ub

    @staticmethod
    def _escalate(del_w, del_c):
        """100x regularization escalation (reference linear_solver.jl:14-15).
        The no-pivot LDL needs *strict* quasi-definiteness, so a zero
        regularization is seeded with a small nonzero value on failure."""
        del_w = del_w * _REG_ESCALATION if del_w != 0.0 else 1e-8
        del_c = del_c * _REG_ESCALATION if del_c != 0.0 else -1e-8
        return del_w, del_c

    def _timed_factorize(self, x, lb, ub, zl, zu, del_w, del_c):
        cnt = self.cnt
        for _ in range(_MAX_FACT_TRIALS):
            pr_diag = K.sigma_diagonal(x, lb, ub, *self._masks(), zl, zu, del_w)
            t0 = time.time()
            self.kkt.factorize(pr_diag, del_c)
            cnt.linear_solver_time += time.time() - t0
            cnt.factorizations += 1
            if self.kkt.factor_ok():
                break
            del_w, del_c = self._escalate(del_w, del_c)
        return del_w, del_c, self.kkt.factor_ok()

    _HOST_REFINE_STEPS = 2  # backsolves are cheap next to the factorization

    def _solve_system(self, p_rhs, x, lb, ub, zl, zu, del_w, del_c):
        cnt = self.cnt
        masks = self._masks()

        def backsolve(rhs):
            rx, ry = K.reduce_rhs(rhs, x, lb, ub, *masks)
            t0 = time.time()
            dx, dy = self.kkt.solve(rx, ry)
            cnt.linear_solver_time += time.time() - t0
            cnt.backsolves += 1
            dzl, dzu = K.recover_bound_duals(rhs, dx, x, lb, ub, *masks, zl, zu)
            return K.KKTVec(x=dx, y=dy, zl=dzl, zu=dzu)

        def residual(d):
            return p_rhs.sub(
                kkt_mul(self.prob, del_w, del_c, x, lb, ub, *masks, zl, zu, d))

        d = backsolve(p_rhs)
        refine = max(self._HOST_REFINE_STEPS, self.opts.max_refine_steps)
        for _ in range(refine):
            w = residual(d)
            ratio = float(w.flat_inf_norm()) / max(1.0, float(p_rhs.flat_inf_norm()))
            if not np.isfinite(ratio) or ratio <= 1e-14:
                break
            d = d.add(backsolve(w))

        w = residual(d)
        ratio = float(w.flat_inf_norm()) / max(1.0, float(p_rhs.flat_inf_norm()))
        ok = not np.isnan(ratio)
        if self.opts.check_residual:
            ok = ok and ratio <= self.opts.tol_linear_solve
        return d, ok

    def _step_rule(self, d, x, lb, ub, zl, zu, mu):
        rule = self.opts.step_rule
        args = (d, x, lb, ub, *self._masks(), zl, zu)
        if isinstance(rule, ConservativeStep):
            a = K.fraction_to_boundary(*args, rule.tau)
        elif isinstance(rule, AdaptiveStep):
            a = K.fraction_to_boundary(*args, max(1.0 - mu, rule.tau_min))
        else:
            assert isinstance(rule, MehrotraAdaptiveStep)
            a = K.step_mehrotra_adaptive(
                d, x, lb, ub, *self._masks(), zl, zu, mu, rule.gamma_f
            )
        return float(a[0]), float(a[1])

    # -- main loop ----------------------------------------------------------

    def solve(self) -> ExecutionStats:
        opts, p, cnt = self.opts, self.prob, self.cnt
        masks = self._masks()
        log = self.logger
        cnt.start_time = time.time()
        log.notice(
            f"This is MadQP (PyTorch, host sparse path), running with "
            f"{self.kkt.name}\n"
        )
        verbose = opts.print_level <= INFO

        # Initialization (reference initialize!, src/solver.jl:127-182).
        lb, ub = K.relax_bounds(_t(self.std.lb), _t(self.std.ub), *masks,
                                opts.bound_relax_factor)
        x = K.push_inside_bounds(_t(self._x0), lb, ub, *masks, opts.bound_push,
                                 opts.bound_fac)
        y = _t(self._y0)
        reg = opts.regularization
        if isinstance(reg, NoRegularization):
            del_w, del_c = 1.0, 0.0
            reg_p = reg_d = 0.0
        else:
            del_w, del_c = 1.0, reg.delta_d
            reg_p, reg_d = reg.delta_p, reg.delta_d

        g = p.c + p.hess_mv(x)
        c_res = p.jac_mv(x) - p.b
        norm_b = float(K._inf_norm(p.b))
        norm_c = float(K._inf_norm(g))

        # Starting point (3 KKT solves; reference init_starting_point!).
        # The initial system uses pr_diag = del_w exactly (src/solver.jl:16-18);
        # retry with escalation if the no-pivot LDL breaks down.
        if self._warm is not None:
            # Warm start (set_initial_point_internal): skip the three
            # least-squares starting solves.
            xw, yw, zlw, zuw = self._warm
            x = K.push_inside_bounds(xw, lb, ub, *masks, opts.bound_push,
                                     opts.bound_fac)
            y = yw
            floor = 1e-8
            zl = torch.where(p.has_lb, torch.clamp(zlw, min=floor), 0.0)
            zu = torch.where(p.has_ub, torch.clamp(zuw, min=floor), 0.0)
            mu = float(np.clip(
                float(K.complementarity_measure(x, lb, ub, *masks, zl, zu)),
                opts.mu_min, opts.mu_init))
        else:
            dw0, dc0 = del_w, del_c
            for _ in range(_MAX_FACT_TRIALS):
                t0 = time.time()
                self.kkt.factorize(np.full(p.n, dw0), dc0)
                cnt.linear_solver_time += time.time() - t0
                if self.kkt.factor_ok():
                    break
                dw0, dc0 = self._escalate(dw0, dc0)
            dx, _ = self.kkt.solve(np.zeros(p.n), -c_res)
            x = x + dx
            _, y = self.kkt.solve(-g, np.zeros(p.m))
            r = g + p.jac_rmv(y)
            ones = torch.ones(p.n, dtype=_F64)
            zl, zu = K.init_bound_duals(r, *masks, ones, ones)
            x, zl, zu = K.mehrotra_positivity_shift(x, lb, ub, *masks, zl, zu)
            x = K.project_bound_fac(x, lb, ub, *masks, opts.bound_fac)
            mu = opts.mu_init
        alpha_p = alpha_d = 1.0
        d_norm = 0.0
        if opts.barrier_gate == "one-sided":  # reference gate (kernels.jl:227)
            n_bounded = int((p.has_lb & ~p.has_ub).sum() + (~p.has_lb & p.has_ub).sum())
        else:
            n_bounded = int(p.has_lb.sum() + p.has_ub.sum())
        status = Status.MAXIMUM_ITERATIONS_EXCEEDED
        d = K.KKTVec(x=torch.zeros(p.n, dtype=_F64), y=torch.zeros(p.m, dtype=_F64),
                     zl=torch.zeros(p.n, dtype=_F64), zu=torch.zeros(p.n, dtype=_F64))
        k = 0

        # Main MPC loop (reference mpc!, src/solver.jl:254-344).
        while True:
            g = p.c + p.hess_mv(x)
            c_res = p.jac_mv(x) - p.b
            jacl = p.jac_rmv(y)
            obj_val = float(p.c0 + torch.dot(p.c, x) + 0.5 * torch.dot(x, p.hess_mv(x)))
            inf_pr = float(K._inf_norm(c_res)) / max(1.0, norm_b)
            inf_du = float(K.dual_infeasibility(g, jacl, zl, zu)) / max(1.0, norm_c)
            inf_compl = float(K.optimality_gap(x, lb, ub, *masks, zl, zu)) / max(1.0, norm_c)

            if verbose:
                log.print_iter(
                    k, obj_val / self.info.obj_scale, inf_pr, inf_du,
                    mu, d_norm, del_w, alpha_d, alpha_p,
                )

            if max(inf_pr, inf_du, inf_compl) <= opts.tol:
                status = Status.SOLVE_SUCCEEDED
                break
            # Infeasibility signature (same predicate as the device path).
            stuck = 1e3 * opts.tol
            dual_mag = max(float(K._inf_norm(y)), float(K._inf_norm(zl)),
                           float(K._inf_norm(zu)))
            if (inf_du <= opts.tol and inf_compl <= opts.tol
                    and inf_pr > stuck and dual_mag > opts.diverge_tol):
                status = Status.DIVERGING_ITERATES
                break
            if (inf_pr <= opts.tol and inf_compl <= opts.tol
                    and inf_du > stuck
                    and float(K._inf_norm(x)) > opts.diverge_tol):
                status = Status.DIVERGING_ITERATES
                break
            # Early certified exit: once the iterates have clearly diverged,
            # try the Farkas / descent-ray certificate in the loop (one
            # transpose matvec) instead of spending the remaining iteration
            # budget before the exit-time check.
            if k % 5 == 0 and dual_mag > opts.diverge_tol:
                if farkas_certificate(self.std, _np(y)):
                    status = Status.INFEASIBLE_PROBLEM_DETECTED
                    break
            if k % 5 == 0 and float(K._inf_norm(x)) > opts.diverge_tol:
                if unbounded_certificate(self.std, _np(x)):
                    status = Status.UNBOUNDED_PROBLEM_DETECTED
                    break
            if k >= opts.max_iter:
                status = Status.MAXIMUM_ITERATIONS_EXCEEDED
                break

            # Regularization policy update.
            if isinstance(reg, NoRegularization):
                del_w, del_c = 0.0, 0.0
            elif isinstance(reg, FixedRegularization):
                del_w, del_c = reg.delta_p, reg.delta_d
            else:
                assert isinstance(reg, AdaptiveRegularization)
                reg_p = max(reg_p / 10.0, reg.delta_min)
                reg_d = min(reg_d / 10.0, -reg.delta_min)
                del_w, del_c = reg_p, reg_d

            del_w, del_c, fact_ok = self._timed_factorize(
                x, lb, ub, zl, zu, del_w, del_c)

            # Predictor.
            p_aff = K.predictor_rhs(g, jacl, c_res, x, lb, ub, *masks, zl, zu)
            d_aff, ok1 = self._solve_system(p_aff, x, lb, ub, zl, zu, del_w, del_c)
            a_p, a_d = K.fraction_to_boundary(d_aff, x, lb, ub, *masks, zl, zu, 1.0)
            mu_aff = K.affine_complementarity_measure(
                d_aff, x, lb, ub, *masks, zl, zu, a_p, a_d)
            corr_lb, corr_ub = K.mehrotra_correction(d_aff, *masks)

            # Barrier.
            mu_curr = float(K.complementarity_measure(x, lb, ub, *masks, zl, zu))
            bar = opts.barrier_update
            mu = float(K.mehrotra_barrier(
                _t(mu_curr), mu_aff, n_bounded, opts.mu_min,
                bar.sigma_min, bar.sigma_max))

            # Corrector.
            p_corr = K.correction_rhs(
                g, jacl, c_res, x, lb, ub, *masks, zl, zu, mu, corr_lb, corr_ub)
            d, ok2 = self._solve_system(p_corr, x, lb, ub, zl, zu, del_w, del_c)
            failed = (not fact_ok) or (not ok1) or (not ok2)

            # Gondzio multi-corrections (reference src/solver.jl:200-251).
            if opts.max_ncorr > 0 and not failed:
                gz = _GONDZIO
                a_p2, a_d2 = K.fraction_to_boundary(
                    d, x, lb, ub, *masks, zl, zu, gz["tau"])
                a_p2, a_d2 = float(a_p2), float(a_d2)
                for _ in range(opts.max_ncorr):
                    t_p = min(a_p2 + gz["delta"], 1.0)
                    t_d = min(a_d2 + gz["delta"], 1.0)
                    ga = float(K.affine_complementarity_measure(
                        d, x, lb, ub, *masks, zl, zu, t_p, t_d))
                    mu_g = (ga / max(mu_curr, 1e-300)) ** 2 * ga
                    new_lb, new_ub = K.gondzio_extra_correction(
                        d, x, lb, ub, *masks, zl, zu, corr_lb, corr_ub,
                        t_p, t_d, gz["beta_min"], gz["beta_max"], mu_g,
                    )
                    p_rhs = K.correction_rhs(
                        g, jacl, c_res, x, lb, ub, *masks, zl, zu,
                        mu_g, new_lb, new_ub,
                    )
                    d_new, okg = self._solve_system(
                        p_rhs, x, lb, ub, zl, zu, del_w, del_c)
                    if not okg:
                        failed = True
                        break
                    h_p, h_d = K.fraction_to_boundary(
                        d_new, x, lb, ub, *masks, zl, zu, gz["tau"])
                    h_p, h_d = float(h_p), float(h_d)
                    if h_p < gz["accept"] * a_p2 or h_d < gz["accept"] * a_d2:
                        break
                    d, corr_lb, corr_ub = d_new, new_lb, new_ub
                    a_p2, a_d2 = h_p, h_d

            if failed:
                status = Status.ERROR_IN_STEP_COMPUTATION
                break

            # Step + update.
            alpha_p, alpha_d = self._step_rule(d, x, lb, ub, zl, zu, mu)
            x = x + alpha_p * d.x
            y = y + alpha_d * d.y
            zl = torch.where(p.has_lb, zl + alpha_d * d.zl, 0.0)
            zu = torch.where(p.has_ub, zu + alpha_d * d.zu, 0.0)
            lb, ub = K.adjust_boundary(x, lb, ub, *masks, mu, self.eps)
            d_norm = float(K._inf_norm(d.x))
            k += 1
            cnt.k = k

        cnt.total_time = time.time() - cnt.start_time
        # Exit-time certification (`std`), as in the device driver.
        stats = user_stats(self.qp, self.info, opts, [_np(v) for v in (x, y, zl, zu)], status,
                           k, cnt, (inf_pr, inf_du, inf_compl), std=self.std)
        log.notice(f"EXIT: {get_status_output(stats.status)}")
        return stats


def solve_host(qp: QuadraticProblem, **kwargs) -> ExecutionStats:
    """One-shot host sparse solve: the CPU path, with the native LDL.  It
    takes no `device=`; the device entry points (`solve`,
    `solve_sparse_lp`, ...) never send their solve here unless asked to."""
    return HostMPCSolver(qp, **kwargs).solve()
