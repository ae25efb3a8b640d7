"""The sparse QP path on the device: the augmented (K2) KKT system and the
entry point of the sparse drivers (port of `madqp_tpu/solver/sparse_qp.py`).

The quasi-definite augmented system

    K = [ H + Σ   Aᵀ   ]      (Σ = pr_diag > 0, δ_c < 0)
        [ A       δ_c I ]

is assembled on the device from index lists made once per pattern on the
host (H's and A's values, then the two diagonals, summed by a sorted
segment reduction: no atomics, two assemblies give the same bits),
Jacobi-scaled to unit |diagonal| (K2.5) and factored by the supernodal
signed LDLᵀ (`ops/sparse_chol.py::factorize_batched_ldl`), whose fronts are
factored by K2-batched (`ops/ldl_batched.py`, `csrc/ldl_batched.cu`) on the
card.  No pivoting: quasi-definiteness under the IPM's regularization
keeps the pivots' signs, which `factor_ok` checks (+1 on the primal block,
−1 on the dual one; the reference's is_inertia_correct).  This is the JAX
package's default sparse formulation, MadIPM's SparseKKTSystem with a
pivot-free LDLᵀ.

`solve_sparse_qp` takes the JAX package's spellings and routing: an LP or
a diagonal-Hessian QP goes to the normal equations (`solve_sparse_lp`),
"condensed" (and "auto" on an inequality-only QP whose AᵀA stays sparse,
`_condensed_auto_ok`) to `solve_sparse_condensed`, the rest to the
augmented system.  `_solve_phases` is the sparse drivers' shared tail;
`_host_endgame` finishes a two-phase solve on the host path
(`HostMPCSolver` warm-started from the float32 iterate, with its cold
retry); `_host_full_solve` runs a whole solve there (a schedule above
MADQP_MAX_UPDATE_ENTRIES).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..models.qp import QuadraticProblem, build_standard_form_sparse
from ..ops import sparse_chol as SC
from ..ops.kkt import torch_dtype
from ..ops.segment import lengths_tensor, segment_sum, segments
from ..utils import Counters, Status, load_options
from .policy import full_f32_products, make_sparse_kkt, sparse_phases, status_of, sync, user_stats
from .sparse_common import (canonical_csc, get_sparse_kernel, measure_sparse_ls,
                            pattern_fingerprint, resolve_endgame, stepped_solve, upper_lookup,
                            value_gather)


class SparseQPProblem(NamedTuple):
    """QP data with COO Jacobian and Hessian on the device (the protocol of
    `solver/state.py::ProblemArrays`).  `h_*` hold the FULL symmetric
    Hessian (both triangles), so `hess_mv` is one segment sum; the
    `*_order` / `*_len` fields are `ops/segment.py::segments`' for the row
    and column sums.  A batch of same-pattern instances
    (`parallel/sparse_batched.py`) puts a leading lane axis on the value
    fields (c0, c, b, has_lb, has_ub, a_vals, h_vals) and shares the index
    lists."""

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
        return self.c.shape[-1]

    @property
    def m(self) -> int:
        return self.b.shape[-1]

    @property
    def is_lp(self) -> bool:
        return self.h_vals.shape[-1] == 0

    @property
    def H(self):
        return None if self.is_lp else self

    def hess_mv(self, x):
        if self.is_lp:
            return torch.zeros_like(x)
        return segment_sum(self.h_vals * x[..., self.h_cols], self.h_row_len,
                           self.h_row_order)

    def jac_mv(self, x):
        return segment_sum(self.a_vals * x[..., self.a_cols], self.a_row_len,
                           self.a_row_order)

    def jac_rmv(self, y):
        return segment_sum(self.a_vals * y[..., self.a_rows], self.a_col_len,
                           self.a_col_order)


class DeviceSparseAugmentedKKT:
    """Augmented (K2) KKT with assembly on the device and the supernodal
    signed LDLᵀ (see the module docstring).  Handles LP and QP.  The K
    pattern, the positions of H's and A's values and of the diagonals in
    its upper-CSC value array, the Jacobi scaling's entry rows and columns,
    the gather into the schedule's permuted order and the expected pivot
    signs are made once, on the host; the values come from the problem's
    arrays at every factorization.  A batch of instances of the pattern
    (`parallel/sparse_batched.py`: pr_diag (B, n), del_c (B,), the
    problem's values with a leading lane axis) is factored in the same
    calls, every front stack holding all lanes' fronts, and `factor_ok`
    gives one flag per lane."""

    name = "sparse-augmented(device)"
    lane_axis = True   # BatchedMPCKernel admits it
    # the direction (solves, kkt_mul, the residual check) reads nothing back
    # to the host: MPCKernel replays it as one CUDA graph on a card
    capturable_direction = True
    # so does a factorization trial (assembly, scaling, fronts, factor_ok):
    # MPCKernel replays each trial as one CUDA graph on a card
    capturable_factorize = True

    def __init__(self, H: Optional[sp.spmatrix], A: sp.spmatrix, order: str = "auto",
                 max_supernode: int = 128, fact_dtype=None,
                 pivot_floor: Optional[float] = None, inverse: bool = False,
                 schedule_mode: str = "greedy"):
        self.fact_dtype = torch_dtype(fact_dtype) if fact_dtype else None
        self.inverse = inverse
        if pivot_floor is None:
            # After K2.5 scaling |diag| ~ 1: an absolute floor near the
            # factorization dtype's sqrt(eps) (cuDSS-style; refinement
            # absorbs it).
            pivot_floor = 1e-6 if self.fact_dtype == torch.float32 else 0.0
        self.pivot_floor = float(pivot_floor)
        A = canonical_csc(A)
        m, n = A.shape
        self.m, self.n = m, n
        Acoo = A.tocoo()
        self.coo_rows = Acoo.row.astype(np.int64)
        self.coo_cols = Acoo.col.astype(np.int64)
        self.coo_vals = Acoo.data.copy()
        if H is not None:
            H = canonical_csc(H)
            if H.nnz == 0:
                H = None
        self.H = H

        # The K pattern (symmetric), and its upper triangle in CSC: the
        # value array of the assembly.
        W_pat = sp.eye(n, format="csc")
        if H is not None:
            Hb = H.copy()
            Hb.data = np.ones_like(Hb.data)
            W_pat = (W_pat + Hb).tocsc()
        K_pat = sp.bmat([[W_pat, A.T], [A, sp.eye(m, format="csc")]], format="csc")
        K_pat.sum_duplicates()
        U = sp.triu(K_pat.tocsr(), k=0, format="csc").sorted_indices()
        pos = upper_lookup(U)
        self.nnz_up = int(U.nnz)
        # H's upper triangle (row <= col once each) out of the full
        # symmetric H in its canonical COO order (the problem's h_vals);
        # A's entry (r, c) sits at the upper entry (c, n + r).
        if H is not None:
            Hcoo = H.tocoo()
            sel = Hcoo.row <= Hcoo.col
            self.h_sel = np.flatnonzero(sel)
            self.h_pos = pos(Hcoo.row[sel], Hcoo.col[sel])
        else:
            self.h_sel = np.zeros(0, np.int64)
            self.h_pos = np.zeros(0, np.int64)
        self.a_pos = pos(self.coo_cols, n + self.coo_rows)
        self.wdiag_pos = pos(np.arange(n), np.arange(n))
        self.ddiag_pos = pos(n + np.arange(m), n + np.arange(m))
        self.alldiag_pos = np.concatenate([self.wdiag_pos, self.ddiag_pos])
        self.entry_row = U.indices.astype(np.int64)
        self.entry_col = np.repeat(np.arange(n + m, dtype=np.int64), np.diff(U.indptr))

        self.bs = SC.analyze_batched(K_pat, order=order, max_supernode=max_supernode,
                                     schedule_mode=schedule_mode)
        self.value_gather = value_gather(self.bs, U)
        self.expected_signs = SC.bucket_signs(
            self.bs, np.concatenate([np.ones(n), -np.ones(m)]))
        self._device_idx: dict = {}

    def device_idx(self, device) -> dict:
        """The index lists as tensors on `device`, made once per device:
        the assembly's sources in the order of their target entry (the
        segment sum's order and lengths; at a shared entry H's value comes
        before Σ's, as the reference adds them), the diagonal positions,
        the entry rows and columns, the value gather and the expected pivot
        signs in the factorization's dtype."""
        device = torch.device(device)
        ix = self._device_idx.get(device)
        if ix is None:
            order, lengths = segments(np.concatenate(
                [self.h_pos, self.a_pos, self.wdiag_pos, self.ddiag_pos]), self.nnz_up)

            def t(v):
                return torch.as_tensor(np.asarray(v, np.int64), device=device)

            dt = self.fact_dtype or torch.float64
            ix = dict(order=t(order), lengths=lengths_tensor(lengths, len(order), device),
                      h_sel=t(self.h_sel),
                      alldiag_pos=t(self.alldiag_pos), entry_row=t(self.entry_row),
                      entry_col=t(self.entry_col), value_gather=t(self.value_gather),
                      signs=[torch.as_tensor(v, dtype=dt, device=device)
                             for v in self.expected_signs])
            self._device_idx[device] = ix
        return ix

    def assemble(self, prob, pr_diag, del_c):
        """K's values in its upper-CSC order (before the scaling): H's and
        A's values, then Σ and δ_c on the diagonals, summed by entry."""
        ix = self.device_idx(pr_diag.device)
        lanes = pr_diag.shape[:-1]
        h = (prob.h_vals[..., ix["h_sel"]] if self.H is not None
             else pr_diag.new_zeros(lanes + (0,)))
        del_c = torch.as_tensor(del_c, dtype=pr_diag.dtype, device=pr_diag.device)
        dc = del_c[..., None].expand(lanes + (self.m,))
        return segment_sum(torch.cat([h, prob.a_vals, pr_diag, dc], dim=-1),
                           ix["lengths"], ix["order"])

    def factorize(self, prob, pr_diag, del_c):
        ix = self.device_idx(pr_diag.device)
        kv = self.assemble(prob, pr_diag, del_c)
        # K2.5 symmetric scaling: Ks = Ds K Ds with Ds = |diag(K)|^-1/2;
        # quasi-definiteness and the pivot signs are preserved.
        kdiag = kv[..., ix["alldiag_pos"]].abs()
        scale = torch.rsqrt(torch.clamp(kdiag, min=torch.finfo(kv.dtype).tiny))
        kv = (kv * scale[..., ix["entry_row"]]
              * scale[..., ix["entry_col"]])[..., ix["value_gather"]]
        if self.fact_dtype is not None and kv.dtype != self.fact_dtype:
            # Mixed precision: the MPC kernel's iterative refinement against
            # the float64 kkt_mul recovers the accuracy
            # (src/linear_solver.jl:28-43).
            kv = kv.to(self.fact_dtype)
        ldl = SC.factorize_batched_ldl(self.bs, kv, signs=ix["signs"],
                                       pivot_floor=self.pivot_floor, inverse=self.inverse)
        return ldl, scale

    def solve(self, factors, rx, ry):
        ldl, scale = factors
        rhs = torch.cat([rx, ry], dim=-1) * scale
        out_dtype = rhs.dtype
        if self.fact_dtype is not None and rhs.dtype != self.fact_dtype:
            rhs = rhs.to(self.fact_dtype)
        sol = SC.solve_batched_ldl(self.bs, ldl, rhs, inverse=self.inverse).to(out_dtype)
        sol = sol * scale
        return sol[..., : self.n], sol[..., self.n:]

    def factor_ok(self, factors):
        """The pivots' inertia: a 0-d bool tensor, or one flag per lane."""
        ldl, scale = factors
        return SC.factor_ok_batched_ldl(ldl, self.device_idx(scale.device)["signs"])


def _host_array(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _host_full_solve(qp, opts, t0, kkt_system="k2"):
    """The whole solve on the host path, for a pattern the device schedule
    cannot hold.  The entire wall is endgame_time, with
    endgame_backend='host-full', so no record reads it as device time;
    `t0` is the caller's entry time, so total_time covers the
    standard-form build and the failed symbolic phase too."""
    from .host import HostMPCSolver

    stats = HostMPCSolver.from_device_options(qp, opts, kkt_system).solve()
    stats.counters.total_time = time.time() - t0
    stats.counters.endgame_time = stats.counters.total_time
    stats.counters.endgame_backend = "host-full"
    return stats


def _host_endgame(qp, opts, final, info, std, t0, kkt_system="k2"):
    """Finish a two-phase solve on the HOST sparse path (endgame="host"):
    warm-start HostMPCSolver (native C++ LDL) from the device float32
    phase's terminal iterate.  Coordinates match because HostMPCSolver
    builds the identical standard form."""
    from .host import HostMPCSolver

    host = HostMPCSolver.from_device_options(qp, opts, kkt_system)
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
        stats = HostMPCSolver.from_device_options(qp, opts, kkt_system).solve()
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


def _solve_phases(qp, info, std, opts, t0, device, phase1, phase2=None, host_qp=None,
                  host_kkt="k2", eg_backend="device-f64"):
    """The sparse drivers' stepped solve and two-phase tail.  `phase1` is
    (kkt, kernel, (prob, lb, ub, x0, y0)); `phase2`, under the two-phase
    scheme, returns the float64 phase's (kkt, kernel, (prob, lb, ub)).
    With endgame="host" the float32 phase's iterate warm-starts the host
    path on `host_qp` (default `qp`) with its `host_kkt` system; otherwise
    the device phase 2 runs from it.  Returns the ExecutionStats of `qp`;
    `total_time` counts from `t0`."""
    kkt, kernel, (prob, lb, ub, x0, y0) = phase1
    final = stepped_solve(kernel, prob, x0, y0, lb, ub)
    ls_time = measure_sparse_ls(kkt, prob, final, lb, ub) if opts.measure_linear_solver else None
    if phase2 is not None and opts.endgame == "host":
        stats = _host_endgame(host_qp if host_qp is not None else qp, opts, final, info, std,
                              t0, kkt_system=host_kkt)
        if ls_time is not None:
            stats.counters.linear_solver_time += ls_time
        return stats
    extra, eg_time, backend = 0, 0.0, ""
    if phase2 is not None:
        eg_t0 = time.time()
        backend, extra = eg_backend, final.k
        kkt2, kernel2, (prob2, lb2, ub2) = phase2()
        dt2 = prob2.c.dtype
        final = stepped_solve(kernel2, prob2, final.x.to(dt2), final.y.to(dt2), lb2, ub2,
                              warm=(final.zl.to(dt2), final.zu.to(dt2)))
        eg_time = time.time() - eg_t0
        if ls_time is not None:
            ls_time += measure_sparse_ls(kkt2, prob2, final, lb2, ub2)
    sync(device)
    k = int(final.k) + extra
    counters = Counters(total_time=time.time() - t0, k=k,
                        linear_solver_time=ls_time if ls_time is not None else 0.0,
                        endgame_time=eg_time, endgame_backend=backend)
    point = [_host_array(v) for v in (final.x, final.y, final.zl, final.zu)]
    residuals = [float(v) for v in (final.inf_pr, final.inf_du, final.inf_compl)]
    return user_stats(qp, info, opts, point, status_of(final.status), k, counters, residuals,
                      std=std)


def _condensed_auto_ok(qp: QuadraticProblem, fill_cap: float = 4.0) -> bool:
    """Whether "auto" takes the condensed (K1) system for a QP with a
    non-diagonal Hessian (the JAX package's guard): no equality rows (the
    condensed driver relaxes them, which perturbs the solution), every row
    with a finite bound (a free row has no barrier on its slack), and
    sum_k nnz(A[k, :])^2 (a bound on nnz(AᵀA)) plus nnz(H) within
    `fill_cap` times the K2 triangle's entries."""
    m = qp.A.shape[0]
    if m == 0:
        return False
    lcon, ucon = np.asarray(qp.lcon), np.asarray(qp.ucon)
    lf, uf = np.isfinite(lcon), np.isfinite(ucon)
    if np.any(lf & uf & (lcon == ucon)) or np.any(~lf & ~uf):
        return False
    A = qp.A.tocsr()
    ata_bound = float(np.square(np.diff(A.indptr), dtype=np.float64).sum())
    nnz_h = qp.H.nnz if qp.H is not None else 0
    k2_nnz = float(nnz_h + A.nnz + A.shape[1] + 2 * m)
    return ata_bound + nnz_h <= fill_cap * k2_nnz


def solve_sparse_qp(qp: QuadraticProblem, order: str = "auto",
                    kkt_system: str = "augmented", *, device="cuda", **options):
    """Solve a (large sparse) LP or QP on `device` (the CUDA card unless
    the caller asks for the CPU).

    kkt_system: "augmented" (default: K2, the supernodal signed LDLᵀ, any
    QP; "k2", "k2.5" and "scaled" spell it), "normal" (LP or diagonal
    Hessian: the normal equations, `solve_sparse_lp`), "condensed" (K1:
    the slack and dual elimination, SPD of the structural order, equality
    rows relaxed; `solve_sparse_condensed`) or "auto" (normal when the
    Hessian is absent or diagonal, condensed when `_condensed_auto_ok`,
    augmented otherwise).

    Mixed precision (factorization_dtype="float32", the two-phase scheme):
    a float32 phase to phase1_tol with the pivot floor, then the host
    endgame (endgame="host", or "auto" with the native library: the host
    K2 system warm-started from the float32 iterate) or a float64 phase of
    this path warm-started the same way ("f64"; "krylov" too: the
    augmented system has no SPD reduction for CG).  A pattern whose
    schedule exceeds MADQP_MAX_UPDATE_ENTRIES is solved whole on the host
    path (`endgame_backend="host-full"`).

    Returns ExecutionStats like `solve`; `total_time` counts from entry."""
    t0 = time.time()
    kkt_system = {"k2": "augmented", "k2.5": "augmented",
                  "scaled": "augmented"}.get(kkt_system, kkt_system)
    if kkt_system not in ("auto", "augmented", "normal", "condensed"):
        raise ValueError(f"kkt_system={kkt_system!r}: "
                         "expected auto|augmented|normal|condensed")
    if kkt_system == "condensed":
        from .sparse_condensed import solve_sparse_condensed

        return solve_sparse_condensed(qp, order=order, device=device, **options)
    if kkt_system != "augmented":
        diag_h = qp.H is None or bool((lambda c: (c.row == c.col).all())(
            sp.coo_matrix(qp.H)))
        if kkt_system == "normal" and not diag_h:
            raise ValueError("kkt_system='normal' needs an LP or diagonal Hessian.")
        if diag_h:
            from .sparse_lp import solve_sparse_lp

            return solve_sparse_lp(qp, order=order, device=device, **options)
        if _condensed_auto_ok(qp):
            from .sparse_condensed import solve_sparse_condensed

            return solve_sparse_condensed(qp, order=order, device=device, **options)
    from .sparse_lp import problem_arrays

    device = torch.device(device)
    opts, _ = load_options(**options)
    opts = resolve_endgame(opts)
    std, info, x0, y0 = build_standard_form_sparse(
        qp, scaling=opts.scaling, max_gradient=opts.max_gradient)
    full_f32_products(device)
    fp = pattern_fingerprint(std.A, std.H)

    def kernel_for(o):
        # Pattern-keyed reuse: same sparsity and options => no symbolic
        # re-analysis (values are the problem arrays').
        return get_sparse_kernel(f"qp:{order}", fp, o,
                                 lambda: make_sparse_kkt("augmented", std, o, order))

    opts1, opts2 = sparse_phases(opts, typed_phase1=True, cg=False)
    try:
        kkt, kernel = kernel_for(opts1)
    except SC.ScheduleTooLargeError:
        # A high-fill pattern whose flat scatter-map schedule would exceed
        # the update-traffic cap: the whole solve runs on the host path.
        return _host_full_solve(qp, opts, t0)

    def phase2():
        kkt2, kernel2 = kernel_for(opts2)
        return kkt2, kernel2, problem_arrays(std, kkt, x0, y0, opts2.dtype, device)[:3]

    return _solve_phases(qp, info, std, opts, t0, device,
                         (kkt, kernel, problem_arrays(std, kkt, x0, y0, opts1.dtype, device)),
                         phase2 if opts2 is not None else None)
