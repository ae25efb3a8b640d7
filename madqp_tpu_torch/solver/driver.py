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
dense path, with the blocked backend for large dense problems, or to the
sparse device paths.

`kkt_system="sparse-normal"` runs the same loop on the sparse device
path of an LP or a diagonal-Hessian QP: COO problem arrays and the
supernodal normal equations (`solver/sparse_lp.py`, mode "batched"), the
KKT taken from the pattern cache (`sparse_common.get_sparse_kernel`, kind
"lp:auto:batched"); `kkt_system="sparse-augmented"` runs it on the
augmented K2 system of any QP (`solver/sparse_qp.py`, kind "qp:auto").
Their mixed-precision scheme is the sparse one: the float32 phase to
phase1_tol, then always the warm-started float64 phase, which refactors
in float64 or, with endgame="krylov" on the normal equations, runs float64
CG preconditioned by the float32 factor (the augmented system has no SPD
reduction: there "krylov" refactors in float64).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..models.qp import QuadraticProblem, build_standard_form, build_standard_form_sparse
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
from ..utils.profiling import span, to_host
from . import state as S
from .certificates import certify_exit_status
from .mpc import MPCKernel
from .policy import (best_time, dense_phases, full_f32_products, make_sparse_kkt, nan_stats,
                     sparse_phases, status_of, user_stats)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


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
    solver option (utils.options.IPMOptions).

    The construction is the span `construct` and each `solve()` the span
    `solve` of `utils.profiling`; the reads of the final state after the
    loop are its host reads at site `finish`."""

    def __init__(self, qp: QuadraticProblem, *, device="cuda", **kwargs):
        with span("construct"):
            self._construct(qp, device, kwargs)

    def _construct(self, qp: QuadraticProblem, device, kwargs: dict):
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
                "kkt_system='schur' requires a block-angular TwoStageProblem:"
                " solve it with madqp_tpu_torch.parallel.solve_two_stage."
            )
        if opts.kkt_system == "sparse-normal" and not qp.is_lp:
            # Beyond the reference (normalkkt.jl:45-48 rejects all QPs): a
            # diagonal Hessian keeps W = H + Σ diagonal, so the normal
            # equations still apply (see DeviceSparseNormalKKT).
            Hcoo = sp.coo_matrix(qp.H)
            if not (Hcoo.row == Hcoo.col).all():
                raise ValueError(
                    "sparse-normal KKT supports linear programs and "
                    "diagonal-Hessian QPs; use sparse-augmented.")
        full_f32_products(self.device)

        # Construction-time numeric errors (e.g. too few degrees of
        # freedom) surface as a terminal status from solve(), matching the
        # reference's exception -> status taxonomy (src/solver.jl:379-380)
        # rather than escaping the constructor.
        self._construct_error = None
        self._sparse = opts.kkt_system in ("sparse-normal", "sparse-augmented")
        if self._sparse:
            t0 = time.time()
            try:
                self._init_sparse(qp, opts)
            except MadQPError as e:
                self._construct_error = e
                self.cnt = Counters(start_time=t0, init_time=time.time() - t0)
                if opts.rethrow_error:
                    raise
            return
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

    def _init_sparse(self, qp, opts: IPMOptions):
        """The sparse device path: the sparse standard form, COO problem
        arrays on the device and the supernodal normal-equations or
        augmented KKT (its symbolic schedule per pattern, from the pattern
        cache)."""
        from .sparse_common import pattern_fingerprint
        from .sparse_lp import make_problem

        t0 = time.time()
        self.std, self.info, x0_int, y0_int = build_standard_form_sparse(
            qp, scaling=opts.scaling, max_gradient=opts.max_gradient,
            fixed_variable_treatment=opts.fixed_variable_treatment,
            bound_relax_factor=opts.bound_relax_factor,
        )
        self._sparse_fp = pattern_fingerprint(self.std.A, self.std.H)
        self._sparse_system = "normal" if opts.kkt_system == "sparse-normal" else "augmented"
        self._sparse_kind = "lp:auto:batched" if self._sparse_system == "normal" else "qp:auto"
        self._sparse_cfg = (opts.factorization_dtype, opts.solve_mode)
        self._bind_kernel(opts)
        dtype = torch_dtype(opts.dtype)
        self.prob = make_problem(self.std, self.kernel.kkt, dtype, self.device)
        self._lb0, self._ub0, self._x0, self._y0 = (
            torch.as_tensor(v, dtype=dtype, device=self.device)
            for v in (self.std.lb, self.std.ub, x0_int, y0_int))
        self._warm_point = None
        self.cnt = Counters(start_time=t0, init_time=time.time() - t0)

    def _bind_sparse_kernel(self, opts: IPMOptions):
        """The sparse path's kernels (`self._sparse_kind`): one, or the
        float32 phase's and the float64 phase's under the two-phase scheme
        (`policy.sparse_phases`)."""
        from .sparse_common import get_sparse_kernel

        if (opts.factorization_dtype, opts.solve_mode) != self._sparse_cfg:
            # a precision or backsolve override changes the KKT's numeric
            # plan: rebuild it on the same pattern
            self._init_sparse(self.qp, opts)
            return

        def kernel(o):
            # The greedy schedule whatever sparse_schedule says, as the JAX
            # package builds it (ROADMAP.md Queue 3, item 31).
            return get_sparse_kernel(self._sparse_kind, self._sparse_fp, o, lambda: (
                make_sparse_kkt(self._sparse_system, self.std, o, schedule_mode="greedy")))[1]

        opts1, opts2 = sparse_phases(opts, cg=self._sparse_system == "normal")
        self.kernel = kernel(opts1)
        self._phase2 = kernel(opts2) if opts2 is not None else None

    def _bind_kernel(self, opts: IPMOptions):
        """The MPC kernel for `opts` and, for the mixed-precision rescue,
        the full-precision kernel of phase 2 (`policy.dense_phases`)."""
        if self._sparse:
            self._bind_sparse_kernel(opts)
            return
        opts1, opts2 = dense_phases(opts)
        self.kernel = MPCKernel(opts1)
        self._phase2 = MPCKernel(opts2) if opts2 is not None else None

    # ------------------------------------------------------------------

    def solve(self, **kwargs) -> ExecutionStats:
        """Run the solve (reference solve!, src/solver.jl:347-403)."""
        with span("solve"):
            return self._solve(kwargs)

    def _solve(self, kwargs: dict) -> ExecutionStats:
        if self._construct_error is not None:
            status = self._construct_error.status
            self.logger.notice(f"EXIT: {get_status_output(status)}")
            return nan_stats(self.qp, self.opts, status, self.cnt)
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
        final = point = None
        self._walltime_exceeded = False
        try:
            final = self._run_loop()
            # the final internal (x, y, zl, zu), read once
            point = [to_host(v, "finish", numpy=True) for v in (final.x, final.y,
                                                                 final.zl, final.zu)]
            if self._walltime_exceeded:
                status = Status.MAXIMUM_WALLTIME_EXCEEDED
            else:
                # Non-convergence with diverging duals is how an IPM
                # manifests an empty feasible set, and diverging primals
                # an unbounded objective; upgrade to a *certified* status
                # when the terminal direction is a Farkas certificate /
                # descent ray.
                status = certify_exit_status(self.std, point[0], point[1],
                                             status_of(final.status))
        except MadQPError as e:
            status = e.status
            if self.opts.rethrow_error:
                raise
        finally:
            cnt.total_time = time.time() - cnt.start_time
            if final is not None:
                # Reference print_summary (src/solver.jl:394), before EXIT.
                sign = 1.0 if self.info.minimize else -1.0
                obj, *residuals = (to_host(v, "finish") for v in (
                    final.obj_val, final.inf_pr, final.inf_du, final.inf_compl))
                self.logger.print_summary(
                    iter=final.k,
                    objective=sign * obj / self.info.obj_scale,
                    objective_scaled=obj,
                    inf_pr=residuals[0],
                    inf_du=residuals[1],
                    inf_compl=residuals[2],
                    total_time=cnt.total_time,
                    init_time=cnt.init_time,
                    linear_solver_time=(
                        cnt.linear_solver_time
                        if self.opts.measure_linear_solver else -1.0),
                    factorizations=final.n_fact,
                    backsolves=final.n_solve,
                )
            self.logger.notice(f"EXIT: {get_status_output(status)}")

        if final is None:
            return nan_stats(self.qp, self.opts, status, cnt)
        cnt.k, cnt.factorizations, cnt.backsolves = final.k, final.n_fact, final.n_solve
        return user_stats(self.qp, self.info, self.opts, point, status, final.k, cnt, residuals)

    def _measure_at(self, kernel: MPCKernel, st: S.IPMState, reps: int = 2):
        """Measured wall seconds of (one factorization, one backsolve) at
        iterate `st`, best of `reps`, synchronized with the device."""
        p = self.prob
        t_fact, (factors, _) = best_time(lambda _i: kernel._factorize(
            p, st.x, st.lb, st.ub, st.zl, st.zu, st.del_w, st.del_c), self.device, reps)
        t_solve, _ = best_time(lambda _i: kernel.kkt.solve(factors, st.x, st.y),
                               self.device, reps)
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
        # The dense rescue runs phase 2 only when phase 1 failed; the sparse
        # scheme's phase 1 stops at phase1_tol, so its phase 2 always runs.
        if (self._phase2 is None or self._walltime_exceeded
                or (state.status == S.SUCCESS and not self._sparse)):
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
    - large + sparse -> the sparse device paths with `kkt_system="auto"`
      (`solve_sparse_qp`): an LP or a diagonal-Hessian QP takes the normal
      equations; a general Hessian the condensed K1 system where
      `_condensed_auto_ok` allows it (an inequality-only QP with a sparse
      A'A), else the augmented K2 system.
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
    from .sparse_qp import solve_sparse_qp

    kwargs.pop("pad_mode", None)
    return solve_sparse_qp(qp, kkt_system="auto", device=device, **kwargs)
