"""The decisions that turn options and a problem into a solve, and a solve
into a result, written once for every entry point of the driver layer
(`MPCSolver`, `solve_sparse_{lp,qp,condensed}`, `BatchedMPCSolver`,
`solve_sparse_batched`, `HostMPCSolver`):

- the precision phases: `sparse_phases` (the sparse two-phase scheme,
  `two_phase_opts`) and `dense_phases` (the dense mixed-precision rescue),
  each the options of phase 1 and of phase 2 (None: one phase);
- `make_sparse_kkt`: the sparse device KKT of a system, built from the
  options;
- `user_stats` / `nan_stats`: a solve's ExecutionStats in user
  coordinates, `status_of` the `Status` of an internal status code;
- `full_f32_products`, `sync` and `best_time`: TF32 off on a card, the
  device sync and the linear-solver timing of `measure_linear_solver`.

The host fallback's options are `host.HostMPCSolver.from_device_options`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..utils import ExecutionStats, Status
from . import state as S
from .certificates import certify_exit_status

STATUS_MAP = {
    S.SUCCESS: Status.SOLVE_SUCCEEDED,
    S.MAX_ITER: Status.MAXIMUM_ITERATIONS_EXCEEDED,
    S.STEP_ERROR: Status.ERROR_IN_STEP_COMPUTATION,
    S.DIVERGED: Status.DIVERGING_ITERATES,
    S.STALLED: Status.SOLVED_TO_ACCEPTABLE_LEVEL,
    S.RUNNING: Status.REGULAR,
}


def status_of(code) -> Status:
    """The `Status` of an internal status code (`solver/state.py`)."""
    return STATUS_MAP.get(int(code), Status.INTERNAL_ERROR)


# -- precision phases ------------------------------------------------------


def _phase1(opts, **changes):
    """Phase 1's options: stall detection armed (5 unless set) and at most
    phase1_max_iter iterations (a low-precision kernel at its precision
    floor burns iterations and degrades the point it hands over)."""
    return dataclasses.replace(
        opts, stall_exit=opts.stall_exit if opts.stall_exit > 0 else 5,
        max_iter=min(opts.max_iter, opts.phase1_max_iter), **changes)


def two_phase_opts(opts, typed_phase1=False):
    """Split options for the two-phase mixed-precision scheme.

    typed_phase1: honor options.phase1_dtype for the phase-1 state (the
    caller then builds the problem arrays per phase and casts the warm
    start on handoff, as solver/sparse_lp.py does).

    Phase 1 (float32): solve to phase1_tol (`_phase1`).  Phase 2
    (float64): the phase-1-only fields are normalized away."""
    opts1 = _phase1(opts, tol=opts.phase1_tol,
                    dtype=(opts.phase1_dtype or opts.dtype) if typed_phase1 else opts.dtype)
    if opts.endgame == "krylov":
        opts2 = dataclasses.replace(opts, phase1_tol=0.0, krylov_solve=True)
    else:
        opts2 = dataclasses.replace(opts, factorization_dtype="",
                                    phase1_tol=0.0)
    return opts1, opts2


def sparse_phases(opts, typed_phase1=False, cg=True):
    """(phase 1's options, phase 2's or None) of a sparse device solve.  A
    float32 factorization under precision_scheme="two-phase" with tol below
    phase1_tol runs two phases (`two_phase_opts`): float32 to phase1_tol,
    then always the warm-started float64 phase.  `cg` False: the KKT has no
    SPD reduction for CG (the augmented system), so endgame="krylov"
    refactors in float64 there."""
    if not (opts.factorization_dtype == "float32"
            and opts.precision_scheme == "two-phase"
            and opts.tol < opts.phase1_tol):
        return opts, None
    opts1, opts2 = two_phase_opts(opts, typed_phase1)
    if opts2.krylov_solve and not cg:
        opts2 = dataclasses.replace(opts2, krylov_solve=False, factorization_dtype="")
    return opts1, opts2


def dense_phases(opts):
    """(phase 1's options, phase 2's or None) of a dense solve.  A
    factorization dtype below `dtype` under precision_scheme="two-phase" is
    the reference's rescue: the low-precision phase (`_phase1`, to `tol`),
    then, only where it ends unconverged, the full-precision phase
    warm-started from it."""
    if not (opts.factorization_dtype
            and opts.factorization_dtype != opts.dtype
            and opts.precision_scheme == "two-phase"):
        return opts, None
    return _phase1(opts), dataclasses.replace(opts, factorization_dtype="")


# -- the sparse KKT ----------------------------------------------------------


def make_sparse_kkt(system: str, std, opts, order: str = "auto", mode: str = "batched", *,
                    schedule_mode=None, krylov: bool = True):
    """The sparse device KKT of `system` for the standard form `std`, built
    from `opts`: the factorization dtype, the backsolve mode, the
    supernodal schedule (`schedule_mode` overrides opts.sparse_schedule) and,
    on the systems with an SPD reduction, the krylov endgame's CG
    (krylov_solve, krylov_tol, krylov_maxit; `krylov` False builds none).

    system: "normal" (`DeviceSparseNormalKKT` of std.A, in `mode`),
    "augmented" (`DeviceSparseAugmentedKKT` of std.H and std.A) or
    "condensed" (`DeviceSparseCondensedKKT` of the structural blocks of a
    standard form that slacks every row)."""
    common = dict(order=order, fact_dtype=opts.factorization_dtype or None,
                  inverse=opts.solve_mode == "inverse",
                  schedule_mode=schedule_mode or opts.sparse_schedule)
    if system == "augmented":
        from .sparse_qp import DeviceSparseAugmentedKKT

        return DeviceSparseAugmentedKKT(std.H, std.A, **common)
    if krylov:
        common.update(krylov=opts.krylov_solve, krylov_tol=opts.krylov_tol,
                      krylov_maxit=opts.krylov_maxit)
    if system == "normal":
        from .sparse_lp import DeviceSparseNormalKKT

        return DeviceSparseNormalKKT(std.A, mode=mode, **common)
    if system == "condensed":
        from .sparse_condensed import DeviceSparseCondensedKKT

        n0 = std.A.shape[1] - std.A.shape[0]
        H0 = None if std.H is None else std.H[:n0, :n0].tocsc()
        return DeviceSparseCondensedKKT(H0, std.A[:, :n0].tocsc(), **common)
    raise ValueError(f"system={system!r}: expected normal|augmented|condensed")


# -- the result ----------------------------------------------------------------


def user_stats(qp, info, opts, point, status: Status, k, counters, residuals,
               std=None) -> ExecutionStats:
    """The ExecutionStats of a solve of `qp` in user coordinates.  `point`
    is the final internal (x, y, zl, zu) on the host, a padded standard
    form's included; `residuals` the final (inf_pr, inf_du, inf_compl).
    x, y and the bound multipliers are recovered through `info`, a fixed
    variable's multipliers filled from its reduced cost.  With `std`, the
    internal standard form, a non-convergent `status` is first upgraded to
    a certified infeasible / unbounded one."""
    x, y, zl, zu = (np.asarray(v, np.float64) for v in point)
    if std is not None:
        status = certify_exit_status(std, x, y, status)
    x_user = info.recover_x(x[: info.n])
    y_user = info.recover_y(y[: info.m])
    r_fix = qp.grad(x_user) + qp.jtprod(y_user)
    inf_pr, inf_du, inf_compl = residuals
    return ExecutionStats(
        status=status,
        objective=float(qp.obj(x_user)),
        solution=x_user,
        constraints=qp.cons(x_user),
        multipliers=y_user,
        multipliers_L=info.recover_z(zl[: info.n], np.maximum(r_fix, 0.0)),
        multipliers_U=info.recover_z(zu[: info.n], np.maximum(-r_fix, 0.0)),
        iter=k,
        counters=counters,
        primal_feas=float(inf_pr),
        dual_feas=float(inf_du),
        complementarity=float(inf_compl),
        options=opts,
    )


def nan_stats(qp, opts, status: Status, counters) -> ExecutionStats:
    """The ExecutionStats of a solve that produced no iterate (a failed
    construction, an error in the loop): NaN in every user-space field."""
    nan = float("nan")
    empty = np.full(qp.nvar, nan)
    return ExecutionStats(
        status=status, objective=nan, solution=empty,
        constraints=np.full(qp.ncon, nan), multipliers=np.full(qp.ncon, nan),
        multipliers_L=empty, multipliers_U=empty,
        iter=0, counters=counters, options=opts,
    )


# -- the device ------------------------------------------------------------------


def full_f32_products(device) -> None:
    """Keep TF32 off on a card: a float32 factorization's accuracy rests on
    full-f32 products followed by float64 refinement (process-wide switches
    for matmuls and cuDNN, set explicitly)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def sync(device) -> None:
    """Wait for the work queued on `device` (a card; no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_time(fn, device, reps: int, warmup: int = 0):
    """(the best wall seconds of fn(i) over i = warmup .. warmup + reps - 1,
    the last call's result), each call synchronized with `device` before
    and after; the calls i < warmup run the same way, untimed."""
    best, out = float("inf"), None
    for i in range(warmup + reps):
        sync(device)
        t0 = time.perf_counter()
        out = fn(i)
        sync(device)
        if i >= warmup:
            best = min(best, time.perf_counter() - t0)
    return best, out
