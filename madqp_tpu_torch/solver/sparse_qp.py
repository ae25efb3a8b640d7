"""The sparse QP entry point and what the sparse drivers share (port of
the parts of `madqp_tpu/solver/sparse_qp.py` that the normal-equations
path uses).

`solve_sparse_qp` takes the JAX package's spellings and routing: an LP or
a diagonal-Hessian QP goes to the normal equations (`solve_sparse_lp`);
the augmented (K2, supernodal signed LDL^T) and condensed (K1) systems are
not ported yet and raise `NotImplementedError` naming ROADMAP.md Queue 1
item 13 steps 3 and 4.  `finish_stats` maps a terminal state to user
coordinates; `_host_endgame` finishes a two-phase solve on the host path
(`HostMPCSolver` warm-started from the float32 iterate, with its cold
retry); `_host_full_solve` runs a whole solve there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..models.qp import QuadraticProblem
from ..utils import Counters, ExecutionStats, Status
from .certificates import certify_exit_status
from .driver import _STATUS_MAP
from .sparse_common import segment_sum

K2_ITEM = "Queue 1, item 13 step 3"          # augmented K2, signed LDL^T
CONDENSED_ITEM = "Queue 1, item 13 step 4"   # condensed K1
K2_STEPS = "Queue 1, item 13 steps 3-4"


class SparseQPProblem(NamedTuple):
    """QP data with COO Jacobian and Hessian on the device (the protocol of
    `solver/state.py::ProblemArrays`).  `h_*` hold the FULL symmetric
    Hessian (both triangles), so `hess_mv` is one segment sum; the
    `*_order` / `*_len` fields are `sparse_common.segments`' for the row
    and column sums."""

    c0: torch.Tensor
    c: torch.Tensor
    b: torch.Tensor
    has_lb: torch.Tensor
    has_ub: torch.Tensor
    a_rows: torch.Tensor
    a_cols: torch.Tensor
    a_vals: torch.Tensor
    a_row_order: torch.Tensor
    a_row_len: torch.Tensor
    a_col_order: torch.Tensor
    a_col_len: torch.Tensor
    h_rows: torch.Tensor
    h_cols: torch.Tensor
    h_vals: torch.Tensor
    h_row_order: torch.Tensor
    h_row_len: torch.Tensor
    h_col_order: torch.Tensor
    h_col_len: torch.Tensor

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return self.b.shape[0]

    @property
    def is_lp(self) -> bool:
        return self.h_vals.shape[0] == 0

    @property
    def H(self):
        return None if self.is_lp else self

    def hess_mv(self, x):
        if self.is_lp:
            return torch.zeros_like(x)
        return segment_sum(self.h_vals * x[self.h_cols], self.h_row_len,
                           self.h_row_order)

    def jac_mv(self, x):
        return segment_sum(self.a_vals * x[self.a_cols], self.a_row_len,
                           self.a_row_order)

    def jac_rmv(self, y):
        return segment_sum(self.a_vals * y[self.a_rows], self.a_col_len,
                           self.a_col_order)


def _host_array(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def finish_stats(qp: QuadraticProblem, info, opts, final, wall,
                 extra_iters: int = 0, std=None, ls_time=None,
                 endgame_time: float = 0.0, endgame_backend: str = ""):
    """Map the internal terminal IPM state back to user coordinates and
    package ExecutionStats (shared by the sparse device drivers).
    extra_iters: iterations of an earlier phase (two-phase mixed
    precision) to include in the count.  std: the internal standard form;
    when given, non-convergent exits are upgraded to certified
    infeasible / unbounded statuses (as the dense driver does).  ls_time:
    measured factorize + backsolve seconds (measure_sparse_ls); None
    leaves the counter at its 'not measured' default."""
    status = _STATUS_MAP.get(int(final.status), Status.INTERNAL_ERROR)
    x = _host_array(final.x)[: info.n]
    y = _host_array(final.y)[: info.m]
    if std is not None:
        status = certify_exit_status(std, x, y, status)
    x_user = info.recover_x(x)
    y_user = info.recover_y(y)
    g_user = qp.grad(x_user)
    r_fix = g_user + qp.jtprod(y_user)
    zl_user = info.recover_z(_host_array(final.zl)[: info.n], np.maximum(r_fix, 0.0))
    zu_user = info.recover_z(_host_array(final.zu)[: info.n], np.maximum(-r_fix, 0.0))
    k = int(final.k) + extra_iters
    return ExecutionStats(
        status=status,
        objective=float(qp.obj(x_user)),
        solution=x_user,
        constraints=qp.cons(x_user),
        multipliers=y_user,
        multipliers_L=zl_user,
        multipliers_U=zu_user,
        iter=k,
        counters=Counters(total_time=wall, k=k,
                          linear_solver_time=ls_time if ls_time is not None else 0.0,
                          endgame_time=endgame_time,
                          endgame_backend=endgame_backend),
        primal_feas=float(final.inf_pr),
        dual_feas=float(final.inf_du),
        complementarity=float(final.inf_compl),
        options=opts,
    )


def _host_solver(qp, opts, kkt_system):
    """The host solver with the device solve's options."""
    from .host import HostMPCSolver

    return HostMPCSolver(
        qp, tol=opts.tol, max_iter=opts.max_iter, max_ncorr=opts.max_ncorr,
        step_rule=opts.step_rule, regularization=opts.regularization,
        kkt_system=kkt_system, print_level=max(opts.print_level, 25),
        scaling=opts.scaling, max_gradient=opts.max_gradient,
        barrier_gate=opts.barrier_gate, mu_min=opts.mu_min,
        bound_push=opts.bound_push, bound_fac=opts.bound_fac,
        bound_relax_factor=opts.bound_relax_factor,
    )


def _host_full_solve(qp, opts, t0, kkt_system="k2"):
    """The whole solve on the host path, for a pattern the device schedule
    cannot hold.  The entire wall is endgame_time, with
    endgame_backend='host-full', so no record reads it as device time;
    `t0` is the caller's entry time, so total_time covers the
    standard-form build and the failed symbolic phase too."""
    stats = _host_solver(qp, opts, kkt_system).solve()
    stats.counters.total_time = time.time() - t0
    stats.counters.endgame_time = stats.counters.total_time
    stats.counters.endgame_backend = "host-full"
    return stats


def _host_endgame(qp, opts, final, info, std, t0, kkt_system="k2"):
    """Finish a two-phase solve on the HOST sparse path (endgame="host"):
    warm-start HostMPCSolver (native C++ LDL) from the device float32
    phase's terminal iterate.  Coordinates match because HostMPCSolver
    builds the identical standard form."""
    host = _host_solver(qp, opts, kkt_system)
    n, m = host.prob.n, host.prob.m
    assert n == std.A.shape[1] and m == std.A.shape[0], (
        "host endgame standard form mismatch")
    warm = [_host_array(v) for v in (final.x[:n], final.y[:m], final.zl[:n], final.zu[:n])]
    warm_used = all(bool(np.isfinite(v).all()) for v in warm)
    extra = int(final.k) if warm_used else 0
    if warm_used:
        host.set_initial_point_internal(*warm)
    eg_t0 = time.time()
    stats = host.solve()
    eg_backend = "host"
    if warm_used and stats.status not in (
            Status.SOLVE_SUCCEEDED,
            Status.INFEASIBLE_PROBLEM_DETECTED,
            Status.UNBOUNDED_PROBLEM_DETECTED):
        # A stalled float32 phase can hand over a finite but poorly
        # centred iterate from which the host's step computation fails,
        # though the same host solves the instance cold: retry from the
        # host's own Mehrotra starting point (the reference's retry
        # philosophy, src/linear_solver.jl:6-17); the float32 phase's
        # iterations are not counted then.
        stats = _host_solver(qp, opts, kkt_system).solve()
        extra = 0
        eg_backend = "host-cold"
    stats.counters.endgame_time = time.time() - eg_t0
    stats.counters.endgame_backend = eg_backend
    stats.counters.total_time = time.time() - t0
    if not opts.measure_linear_solver:
        # The host counts factorize + solve seconds of ITS phase only;
        # without a measurement of the device phase, report "not
        # measured" rather than a partial share.
        stats.counters.linear_solver_time = 0.0
    return dataclasses.replace(stats, iter=stats.iter + extra)


def solve_sparse_qp(qp: QuadraticProblem, order: str = "auto",
                    kkt_system: str = "augmented", *, device="cuda", **options):
    """Solve a (large sparse) LP or QP on `device` (the CUDA card unless
    the caller asks for the CPU).

    kkt_system: "normal" (LP or diagonal Hessian: the normal equations,
    `solve_sparse_lp`), "auto" (normal when the Hessian is absent or
    diagonal), "augmented" (K2) or "condensed" (K1); "k2", "k2.5" and
    "scaled" spell "augmented".  The augmented and condensed systems, and
    "auto" on a non-diagonal Hessian (which the JAX package sends to one of
    them), are not ported yet: they raise naming ROADMAP.md's item.
    Returns ExecutionStats like `solve`."""
    kkt_system = {"k2": "augmented", "k2.5": "augmented",
                  "scaled": "augmented"}.get(kkt_system, kkt_system)
    if kkt_system not in ("auto", "augmented", "normal", "condensed"):
        raise ValueError(f"kkt_system={kkt_system!r}: "
                         "expected auto|augmented|normal|condensed")
    if kkt_system == "condensed":
        raise NotImplementedError(
            "solve_sparse_qp kkt_system='condensed' (K1 on the device) is not "
            f"ported yet (ROADMAP.md {CONDENSED_ITEM})")
    if kkt_system != "augmented":
        diag_h = qp.H is None or bool((lambda c: (c.row == c.col).all())(
            sp.coo_matrix(qp.H)))
        if kkt_system == "normal" and not diag_h:
            raise ValueError("kkt_system='normal' needs an LP or diagonal Hessian.")
        if diag_h:
            from .sparse_lp import solve_sparse_lp

            return solve_sparse_lp(qp, order=order, device=device, **options)
        raise NotImplementedError(
            "solve_sparse_qp kkt_system='auto' on a non-diagonal Hessian takes the "
            "condensed or the augmented system, which are not ported yet "
            f"(ROADMAP.md {K2_STEPS})")
    raise NotImplementedError(
        "solve_sparse_qp kkt_system='augmented' (K2, supernodal signed LDL^T) is "
        f"not ported yet (ROADMAP.md {K2_ITEM})")
