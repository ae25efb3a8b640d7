"""User-facing solver driver: MPCSolver + solve()
(port of the dense part of `madqp_tpu/solver/driver.py`).

Equivalent of the reference's `MPCSolver(nlp; kwargs...)` constructor
(src/structure.jl:77-176) and `solve!` driver (src/solver.jl:347-403):
banner, initialization, MPC loop, exception -> status taxonomy, timing,
summary print and stats object.

The MPC loop is always stepped on the host (the reference's
`use_python_loop` path); `print_level <= INFO` prints the 9-column
iteration table.  Mixed precision (`factorization_dtype` below `dtype`
with the default `precision_scheme="two-phase"`) is the reference's dense
rescue: the low-precision kernel runs with stall detection and at most
`phase1_max_iter` iterations, and a warm-started full-precision phase
follows only when it exits unconverged.

`pad_mode="bucket"` pads the standard form to power-of-two shape buckets
(`parallel.pad_standard`); `autosolve` routes a problem by its shape to the
dense path, with the blocked backend for large dense problems.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models.qp import QuadraticProblem, build_standard_form
from ..ops.kkt import torch_dtype
from ..parallel.batched import pad_standard
from ..utils import (
    ExecutionStats,
    Counters,
    MadLogger,
    MadQPError,
    Status,
    get_status_output,
    load_options,
)
from ..utils.logger import INFO
from ..utils.options import IPMOptions, KKTSystem
from . import state as S
from .certificates import certify_exit_status
from .mpc import MPCKernel

_STATUS_MAP = {
    S.SUCCESS: Status.SOLVE_SUCCEEDED,
    S.MAX_ITER: Status.MAXIMUM_ITERATIONS_EXCEEDED,
    S.STEP_ERROR: Status.ERROR_IN_STEP_COMPUTATION,
    S.DIVERGED: Status.DIVERGING_ITERATES,
    S.STALLED: Status.SOLVED_TO_ACCEPTABLE_LEVEL,
    S.RUNNING: Status.REGULAR,
}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bucket_shape(n: int, m: int, lo: int = 32) -> tuple[int, int]:
    """(n_tot, m_tot) of `pad_mode="bucket"` for a standard form with n
    variables and m rows: m rounded up to a power of two (at least `lo`,
    0 stays 0), then n plus one padding variable per added row, rounded
    the same way."""
    def bucket(v):
        b = lo
        while b < v:
            b *= 2
        return b

    m_tot = bucket(m) if m else 0
    return bucket(n + (m_tot - m)), m_tot


class MPCSolver:
    """Mehrotra predictor-corrector interior-point solver for LP/QP.

    `device` places the problem and the iterates: the CUDA card unless the
    caller asks for "cpu" (without a card the default raises torch's own
    error; nothing falls back to the host).  Every other keyword is a
    solver option (utils.options.IPMOptions)."""

    def __init__(self, qp: QuadraticProblem, *, device="cuda", **kwargs):
        self.qp = qp
        self.device = torch.device(device)
        opts, ignored = load_options(**kwargs)
        self.opts = opts
        self.logger = MadLogger(
            print_level=opts.print_level,
            file_print_level=opts.file_print_level,
            output_file=opts.output_file,
        )
        if ignored:
            self.logger.print_ignored_options(ignored)

        if opts.kkt_system == KKTSystem.NORMAL and not qp.is_lp:
            raise ValueError(
                "NormalKKT supports only linear programs "
                "(reference normalkkt.jl:45-48)."
            )
        if opts.kkt_system == "schur":
            raise ValueError(
                "kkt_system='schur' requires a block-angular TwoStageProblem"
                " (the two-stage solver is not ported yet: ROADMAP.md"
                " Queue 1, item 11)."
            )
        if self.device.type == "cuda":
            # The float32 factorization path's accuracy rests on full-f32
            # products followed by float64 refinement: keep TF32 off for
            # matmuls and cuDNN (process-wide switches, set explicitly).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        # Construction-time numeric errors (e.g. too few degrees of
        # freedom) surface as a terminal status from solve(), matching the
        # reference's exception -> status taxonomy (src/solver.jl:379-380)
        # rather than escaping the constructor.
        self._construct_error = None
        t0 = time.time()
        try:
            self.std, self.info, x0_int, y0_int = build_standard_form(
                qp, scaling=opts.scaling, max_gradient=opts.max_gradient,
                fixed_variable_treatment=opts.fixed_variable_treatment,
                bound_relax_factor=opts.bound_relax_factor,
            )
        except MadQPError as e:
            self._construct_error = e
            self.cnt = Counters(start_time=t0, init_time=time.time() - t0)
            if opts.rethrow_error:
                raise
            return
        if opts.pad_mode == "bucket":
            # Pad to power-of-two shape buckets (stats recovery slices back
            # via info).
            n_tot, m_tot = bucket_shape(self.std.n, self.std.m)
            self.std, x0_int, y0_int = pad_standard(
                self.std, x0_int, y0_int, n_tot, m_tot,
                force_H=self.std.H is not None,
            )
        dtype = torch_dtype(opts.dtype)
        self.prob, lb, ub = S.problem_to_device(self.std, dtype, self.device)
        self._lb0, self._ub0 = lb, ub
        self._x0 = torch.as_tensor(x0_int, dtype=dtype, device=self.device)
        self._y0 = torch.as_tensor(y0_int, dtype=dtype, device=self.device)

        self._bind_kernel(opts)
        self._warm_point = None
        self.cnt = Counters(start_time=t0, init_time=time.time() - t0)

    def _bind_kernel(self, opts: IPMOptions):
        """The MPC kernel for `opts` and, for the mixed-precision rescue,
        the full-precision kernel of phase 2."""
        rescue = (opts.factorization_dtype
                  and opts.factorization_dtype != opts.dtype
                  and opts.precision_scheme == "two-phase")
        if not rescue:
            self.kernel = MPCKernel(opts)
            self._phase2 = None
            return
        opts1 = dataclasses.replace(
            opts, stall_exit=opts.stall_exit if opts.stall_exit > 0 else 5,
            max_iter=min(opts.max_iter, opts.phase1_max_iter))
        opts2 = dataclasses.replace(opts, factorization_dtype="")
        self.kernel = MPCKernel(opts1)
        self._phase2 = MPCKernel(opts2)

    # ------------------------------------------------------------------

    def solve(self, **kwargs) -> ExecutionStats:
        """Run the solve (reference solve!, src/solver.jl:347-403)."""
        if self._construct_error is not None:
            status = self._construct_error.status
            self.logger.notice(f"EXIT: {get_status_output(status)}")
            nan = float("nan")
            empty = np.full(self.qp.nvar, nan)
            return ExecutionStats(
                status=status, objective=nan, solution=empty,
                constraints=np.full(self.qp.ncon, nan),
                multipliers=np.full(self.qp.ncon, nan),
                multipliers_L=empty, multipliers_U=empty,
                iter=0, counters=self.cnt, options=self.opts,
            )
        if kwargs:
            opts, ignored = load_options(
                **{**_opts_dict(self.opts), **kwargs}
            )
            if ignored:
                self.logger.print_ignored_options(ignored)
            self.opts = opts
            self._bind_kernel(opts)

        cnt = self.cnt
        cnt.start_time = time.time()
        cnt.linear_solver_time = 0.0
        fact = self.opts.factorization_dtype or self.opts.dtype
        self.logger.notice(
            f"This is MadQP (PyTorch), running with {self.kernel.kkt.name} "
            f"KKT ({self.opts.linear_solver} backend, device={self.device}, "
            f"dtype={self.opts.dtype}, factorization={fact})\n"
        )
        # Problem-statistics banner (reference print_init analog).
        info = self.info
        nlb = int(np.sum(self.std.has_lb))
        nub = int(np.sum(self.std.has_ub))
        self.logger.notice(
            f"Number of variables ............................: {info.nvar}\n"
            f"Number of constraints ..........................: {info.ncon}\n"
            f"Number of nonzeros in constraint Jacobian ......: {self.qp.nnzj}\n"
            f"Number of nonzeros in Lagrangian Hessian .......: {self.qp.nnzh}\n"
            f"Internal variables (incl. slacks / padding) ....: {self.std.n}\n"
            f"Variables with lower / upper bounds ............: {nlb} / {nub}\n"
        )
        status = Status.INTERNAL_ERROR
        final = None
        self._walltime_exceeded = False
        try:
            final = self._run_loop()
            if self._walltime_exceeded:
                status = Status.MAXIMUM_WALLTIME_EXCEEDED
            else:
                status = _STATUS_MAP.get(final.status, Status.INTERNAL_ERROR)
                # Non-convergence with diverging duals is how an IPM
                # manifests an empty feasible set, and diverging primals
                # an unbounded objective; upgrade to a *certified* status
                # when the terminal direction is a Farkas certificate /
                # descent ray.
                status = certify_exit_status(
                    self.std, _to_numpy(final.x), _to_numpy(final.y), status)
        except MadQPError as e:
            status = e.status
            if self.opts.rethrow_error:
                raise
        finally:
            cnt.total_time = time.time() - cnt.start_time
            if final is not None:
                # Reference print_summary (src/solver.jl:394), before EXIT.
                sign = 1.0 if self.info.minimize else -1.0
                self.logger.print_summary(
                    iter=final.k,
                    objective=sign * float(final.obj_val) / self.info.obj_scale,
                    objective_scaled=float(final.obj_val),
                    inf_pr=float(final.inf_pr),
                    inf_du=float(final.inf_du),
                    inf_compl=float(final.inf_compl),
                    total_time=cnt.total_time,
                    init_time=cnt.init_time,
                    linear_solver_time=(
                        cnt.linear_solver_time
                        if self.opts.measure_linear_solver else -1.0),
                    factorizations=final.n_fact,
                    backsolves=final.n_solve,
                )
            self.logger.notice(f"EXIT: {get_status_output(status)}")

        return self._build_stats(final, status)

    def _measure_at(self, kernel: MPCKernel, st: S.IPMState, reps: int = 2):
        """Measured wall seconds of (one factorization, one backsolve) at
        iterate `st`, best of `reps`, synchronized with the device."""
        p = self.prob

        def best_of(fn):
            best, out = float("inf"), None
            for _ in range(reps):
                _sync(self.device)
                t0 = time.perf_counter()
                out = fn()
                _sync(self.device)
                best = min(best, time.perf_counter() - t0)
            return best, out

        t_fact, (factors, _) = best_of(lambda: kernel._factorize(
            p, st.x, st.lb, st.ub, st.zl, st.zu, st.del_w, st.del_c))
        t_solve, _ = best_of(lambda: kernel.kkt.solve(factors, st.x, st.y))
        return t_fact, t_solve

    def set_initial_point(self, x=None, y=None, zl=None, zu=None):
        """Supply a user-space warm-start point for the next solve().

        Maps user coordinates into the internal (scaled, slack-augmented)
        space — the inverse of the stats recovery.  Missing pieces default
        to the cold-start values / ones; slack bound duals derive from y.
        Call clear_initial_point() to return to cold starts.
        """
        info = self.info
        dtype = torch_dtype(self.opts.dtype)
        n, m = info.n, info.m
        sign = 1.0 if info.minimize else -1.0
        s_rows = info.ineq_rows
        ns = len(s_rows)

        if x is not None:
            x = np.asarray(x, dtype=np.float64)
            x_kept = x[info.keep_idx]
            # Slack = con_scale * (A_kept @ x_kept): the fixed-variable
            # columns are eliminated from the internal rows (their shift
            # moved into b), so they must NOT contribute here.
            A_keep = self.qp.A[s_rows][:, info.keep_idx] if ns else None
            s0 = (
                info.con_scale[s_rows] * np.asarray(A_keep @ x_kept).ravel()
                if ns else np.zeros(0)
            )
            x_int = np.concatenate([x_kept, s0])
        else:
            x_int = _to_numpy(self._x0)[:n]
        if y is not None:
            y = np.asarray(y, dtype=np.float64)
            y_int = sign * y * info.obj_scale / np.maximum(info.con_scale, 1e-300)
        else:
            y_int = _to_numpy(self._y0)[:m]

        def z_int(z_user):
            # Inverse of recover_z (models/qp.py): z_int = sign*obj_scale*z.
            out = np.ones(n)
            if z_user is not None:
                z_user = np.asarray(z_user, dtype=np.float64)
                out[: info.n_kept] = sign * info.obj_scale * z_user[info.keep_idx]
            return out

        zl_int = z_int(zl)
        zu_int = z_int(zu)
        if ns:
            # Slack bound duals from dual feasibility of the slack column
            # (-y_i - zl_s + zu_s = 0): zl_s = max(-y, 0), zu_s = max(y, 0).
            ys = y_int[s_rows]
            zl_int[info.n_kept:] = np.maximum(-ys, 0.0)
            zu_int[info.n_kept:] = np.maximum(ys, 0.0)

        # Under pad_mode="bucket" the internal problem is larger than
        # (info.n, info.m): padding variables start at 0 with unit bound
        # duals, padding rows with zero multipliers.
        n_tot, m_tot = self.prob.n, self.prob.m

        def pad(v, size, fill):
            return np.concatenate([v, np.full(size - len(v), fill)])

        self._warm_point = tuple(
            torch.as_tensor(v, dtype=dtype, device=self.device)
            for v in (pad(x_int, n_tot, 0.0), pad(y_int, m_tot, 0.0),
                      pad(zl_int, n_tot, 1.0), pad(zu_int, n_tot, 1.0)))
        return self

    def clear_initial_point(self):
        self._warm_point = None
        return self

    def _run_loop(self) -> S.IPMState:
        """Host-driven stepping with the reference's 9-column iteration line
        (src/structure.jl:178-195).  The line for iterate k mixes the freshly
        computed residuals (stored by the iteration) with the *previous*
        step's mu, ||d||, regularization and step sizes — the reference's
        print-before-step ordering."""
        verbose = self.opts.print_level <= INFO
        measure = self.opts.measure_linear_solver
        scale = self.info.obj_scale
        deadline = time.time() + self.opts.max_wall_time
        if self._warm_point is not None:
            x0, y0, zl0, zu0 = self._warm_point
            state = self.kernel.init_state_warm(
                self.prob, x0, y0, zl0, zu0, self._lb0, self._ub0)
        else:
            state = self.kernel.init_state(
                self.prob, self._x0, self._y0, self._lb0, self._ub0)

        def run(kernel, state, k_off):
            while state.status == S.RUNNING:
                if time.time() > deadline:
                    self._walltime_exceeded = True
                    return state
                prev = state
                state = kernel.iteration(self.prob, prev)
                if measure:
                    # one factorize and one backsolve timed at THIS
                    # iterate, scaled by this iteration's counts
                    t_fact, t_solve = self._measure_at(kernel, prev)
                    self.cnt.linear_solver_time += (
                        t_fact * (state.n_fact - prev.n_fact)
                        + t_solve * (state.n_solve - prev.n_solve))
                if verbose and prev.initialized:
                    # the first call computes the starting point; the
                    # reference prints its first line at iter 0 AFTER
                    # initialize! (src/solver.jl:274)
                    self.logger.print_iter(
                        k_off + prev.k,
                        float(state.obj_val) / scale,
                        float(state.inf_pr),
                        float(state.inf_du),
                        float(prev.mu),
                        float(prev.d_norm),
                        float(prev.del_w),
                        float(prev.alpha_d),
                        float(prev.alpha_p),
                    )
            return state

        state = run(self.kernel, state, 0)
        if (self._phase2 is None or state.status == S.SUCCESS
                or self._walltime_exceeded):
            return state
        # Mixed-precision rescue: warm-start the full-precision phase from
        # the low-precision phase's last iterate.
        k1 = state.k
        if verbose:
            self.logger.notice(
                f"Phase 1 ({self.opts.factorization_dtype}) done at iter "
                f"{k1}; switching to {self.opts.dtype} endgame\n")
        state2 = self._phase2.init_state_warm(
            self.prob, state.x, state.y, state.zl, state.zu,
            self._lb0, self._ub0)
        state2 = run(self._phase2, state2, k1)
        return state2._replace(k=state.k + state2.k)

    # ------------------------------------------------------------------

    def _build_stats(self, final, status: Status) -> ExecutionStats:
        info = self.info
        cnt = self.cnt
        if final is None:
            nan = float("nan")
            empty = np.full(info.nvar, nan)
            return ExecutionStats(
                status=status, objective=nan, solution=empty,
                constraints=np.full(info.ncon, nan), multipliers=np.full(info.ncon, nan),
                multipliers_L=empty, multipliers_U=empty,
                iter=0, counters=cnt, options=self.opts,
            )
        cnt.k = final.k
        cnt.factorizations = final.n_fact
        cnt.backsolves = final.n_solve

        x_int = _to_numpy(final.x)[: info.n]
        y_int = _to_numpy(final.y)[: info.m]
        zl_int = _to_numpy(final.zl)[: info.n]
        zu_int = _to_numpy(final.zu)[: info.n]

        x_user = info.recover_x(x_int)
        y_user = info.recover_y(y_int)
        # Fixed variables report their reduced cost as bound multipliers.
        g_user = self.qp.grad(x_user)
        r_fix = g_user + self.qp.jtprod(y_user)
        zl_fill = np.maximum(r_fix, 0.0)
        zu_fill = np.maximum(-r_fix, 0.0)
        zl_user = info.recover_z(zl_int, zl_fill)
        zu_user = info.recover_z(zu_int, zu_fill)

        objective = self.qp.obj(x_user)
        constraints = self.qp.cons(x_user)

        return ExecutionStats(
            status=status,
            objective=float(objective),
            solution=x_user,
            constraints=constraints,
            multipliers=y_user,
            multipliers_L=zl_user,
            multipliers_U=zu_user,
            iter=final.k,
            counters=cnt,
            primal_feas=float(final.inf_pr),
            dual_feas=float(final.inf_du),
            complementarity=float(final.inf_compl),
            options=self.opts,
        )


def _opts_dict(opts: IPMOptions) -> dict:
    return {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}


def solve(qp: QuadraticProblem, *, device="cuda", **kwargs) -> ExecutionStats:
    """One-shot convenience: build an MPCSolver on `device` and run it."""
    return MPCSolver(qp, device=device, **kwargs).solve()


def autosolve(qp: QuadraticProblem, *, device="cuda", dense_limit: int = 1500,
              **kwargs) -> ExecutionStats:
    """Route to a device path by problem shape (the JAX package's routing;
    its `dense_limit` and blocked switch were tuned on a TPU and are not
    re-measured here: ROADMAP.md Queue 1, item 16).

    - small (internal dim n + m <= dense_limit) or dense data -> the
      bucket-padded dense path (`solve`), with the blocked backend (panel
      Cholesky with K8 trailing updates, inverse factors, matvec
      backsolves) once the internal dimension reaches 2048;
    - large + sparse -> the sparse device paths, which are not ported yet
      (ROADMAP.md Queue 1, item 13): this raises rather than sending the
      problem down the dense route.
    """
    m, n = qp.A.shape
    # internal dimension after slacking every range/inequality row
    internal = n + m
    density = qp.A.nnz / max(1, m * n)
    nnz_h = qp.H.nnz if qp.H is not None else 0
    dense_h = qp.H is not None and nnz_h > 0.25 * n * n
    if internal <= dense_limit or density > 0.25 or dense_h:
        kwargs.setdefault("pad_mode", "bucket")
        if internal >= 2048:
            kwargs.setdefault("linear_solver", "blocked")
        return solve(qp, device=device, **kwargs)
    raise NotImplementedError(
        f"autosolve routes this large sparse problem (n={n}, m={m}, "
        f"A density {density:.2g}) to the sparse device paths, which are not "
        "ported yet (ROADMAP.md Queue 1, item 13); call solve() to run it "
        "on the dense path")
