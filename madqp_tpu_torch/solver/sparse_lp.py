"""The sparse LP path on the device: COO matvecs and the normal equations
(port of `madqp_tpu/solver/sparse_lp.py`).

The LP's Jacobian stays sparse on the device (COO, segment-sum matvecs);
the normal matrix S = A D A' − δ_c I is assembled there every iteration
and factored in one of two ways (`mode`):

  * "dense" (m <= dense_normal_limit under "auto"): one dense (m, m)
    matrix by `ops/blocked_dense.py::factor_inv_chol`: for m >= 1024 the
    panel Cholesky, whose trailing updates are the hand-written K8
    (`ops/syrk.py`, `csrc/syrk.cu`), and the inverse factor, so each
    backsolve is two matvecs;
  * "batched" (above the limit) and the one-front-at-a-time mode (any
    other name; the reference's tests call it "unrolled"): the supernodal
    multifrontal Cholesky of `ops/sparse_chol.py`, the symbolic schedule
    built once per pattern on the host; K1 factors the fronts' leading
    blocks, a stack per launch in "batched" (the route of
    `ops/pallas_chol.py::batched_route`), one front per launch otherwise.  S's values go
    to the schedule's permuted order by one gather (`value_gather`).  The
    float32 phase of "batched" takes the pivot-floored LDL^T (all signs
    +1, floor 1e-6); a pattern whose schedule exceeds
    MADQP_MAX_UPDATE_ENTRIES is solved whole on the host path
    (`endgame_backend="host-full"`).

Two assemblies of S, chosen once per pattern as in the JAX package:

  * "pairs": host-precomputed contribution lists (every pair of rows
    sharing a column of A), a segment sum into S's upper pattern, the
    −δ_c diagonal, symmetric Jacobi scaling to unit diagonal, and a
    scatter into the dense matrix;
  * "matmul" (dense mode only): for A with dense columns, whose pair
    lists would explode, A scattered into a dense (m, n) matrix and
    S = (A D) A' as one product.

Every sum is deterministic on the card: the pair lists are sorted by
their target entry once, at symbolic time, and reduced with a sorted
segment reduction; the scatters write unique entries.

The krylov endgame (`endgame="krylov"`, `krylov_solve`): the float32
factorization kept as the preconditioner of float64 CG on the scaled
normal matrix (`ops/krylov.py::pcg`), only matvecs in float64.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..models.qp import QuadraticProblem, build_standard_form_sparse
from ..ops import kernels as K
from ..ops import sparse_chol as SC
from ..ops.blocked_dense import factor_inv_chol
from ..ops.kkt import torch_dtype
from ..ops.krylov import pcg
from ..ops.segment import lengths_tensor, segment_sum, segments
from ..utils import load_options
from .policy import full_f32_products, make_sparse_kkt, sparse_phases
from .sparse_common import (canonical_coo_vals, canonical_csc, get_sparse_kernel,
                            pattern_fingerprint, resolve_endgame, upper_lookup, value_gather)
from .sparse_qp import SparseQPProblem, _host_full_solve, _solve_phases


class SparseLPProblem(NamedTuple):
    """LP data with a COO Jacobian on the device (the protocol of
    `solver/state.py::ProblemArrays`; `H` is absent).

    `a_row_order` / `a_row_len` and `a_col_order` / `a_col_len` are the
    (order, lengths) of `ops/segment.py::segments` for the row and column
    sums of the matvecs.  A batch of same-pattern instances
    (`parallel/sparse_batched.py`) puts a leading lane axis on the value
    fields (c0, c, b, has_lb, has_ub, a_vals) and shares the index lists."""

    c0: torch.Tensor
    c: torch.Tensor
    b: torch.Tensor
    has_lb: torch.Tensor
    has_ub: torch.Tensor
    a_rows: torch.Tensor   # (nnz,) int64
    a_cols: torch.Tensor   # (nnz,) int64
    a_vals: torch.Tensor   # (nnz,)
    a_row_order: torch.Tensor
    a_row_len: torch.Tensor
    a_col_order: torch.Tensor
    a_col_len: torch.Tensor

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def m(self) -> int:
        return self.b.shape[-1]

    @property
    def is_lp(self) -> bool:
        return True

    @property
    def H(self):
        return None

    def hess_mv(self, x):
        return torch.zeros_like(x)

    def jac_mv(self, x):
        return segment_sum(self.a_vals * x[..., self.a_cols], self.a_row_len,
                           self.a_row_order)

    def jac_rmv(self, y):
        return segment_sum(self.a_vals * y[..., self.a_rows], self.a_col_len,
                           self.a_col_order)


def coo_fields(rows, cols, vals, m, n, dtype, device) -> dict:
    """The COO fields of an (m, n) matrix of a sparse problem (A's or H's:
    the caller prefixes the names) with the segment orders of its row and
    column sums."""
    def idx(v):
        return torch.as_tensor(np.asarray(v, np.int64), device=device)

    row_order, row_len = segments(rows, m)
    col_order, col_len = segments(cols, n)
    return dict(rows=idx(rows), cols=idx(cols),
                vals=torch.as_tensor(vals, dtype=dtype, device=device),
                row_order=idx(row_order), row_len=lengths_tensor(row_len, len(rows), device),
                col_order=idx(col_order), col_len=lengths_tensor(col_len, len(cols), device))


def _pair_lists(A: sp.csc_matrix, S_up: sp.csc_matrix, payload=None):
    """Contribution lists of S = A D A' (lower triangle): for column k of A
    with rows R_k, every pair (i, j) in R_k x R_k with i >= j adds
    A_ik D_k A_jk to S_ij, stored at the upper entry (j, i) of S_up's CSC
    value array.  Returns (pair_p, pair_q, pair_k, pair_e) in the JAX
    package's order (column k, then entry a, then entry bq <= a), built
    with NumPy instead of its Python loops; pair_p and pair_q address A's
    value array, or `payload[...]` of it when given (the condensed system
    passes A0^T with A0's CSC positions as payload)."""
    indptr, indices = A.indptr.astype(np.int64), A.indices.astype(np.int64)
    nnz = indices.shape[0]
    col = np.repeat(np.arange(A.shape[1], dtype=np.int64), np.diff(indptr))
    lo = indptr[col]                       # first entry of each entry's column
    reps = np.arange(nnz, dtype=np.int64) - lo + 1   # partners bq in lo..a
    pair_p = np.repeat(np.arange(nnz, dtype=np.int64), reps)
    start = np.repeat(np.cumsum(reps) - reps, reps)
    pair_q = np.repeat(lo, reps) + (np.arange(pair_p.shape[0], dtype=np.int64) - start)
    pair_k = col[pair_p]
    # the upper entry (row jb, column ia) of S_up
    pair_e = upper_lookup(S_up)(indices[pair_q], indices[pair_p])
    if payload is not None:
        pair_p, pair_q = payload[pair_p], payload[pair_q]
    return pair_p, pair_q, pair_k, pair_e


class DeviceSparseNormalKKT:
    """Normal-equations KKT with assembly on the device and a dense
    (`mode="dense"`), supernodal batched (`"batched"`) or one-front-at-a-
    time (any other mode) factorization, as in the JAX package.

    Beyond the reference's NormalKKTSystem (LP only, normalkkt.jl:45-48),
    separable QPs (diagonal Hessian) keep W = H + Σ diagonal, so the same
    SPD reduction S = A W⁻¹ Aᵀ − δ_c I applies; the diagonal Hessian comes
    in through the problem arrays (`prob.h_vals` with h_rows == h_cols).

    The supernodal "batched" mode also takes a batch of instances of the
    pattern (`parallel/sparse_batched.py`): pr_diag (B, n), del_c (B,) and
    the problem's values with a leading lane axis; every front stack then
    holds all lanes' fronts (one kernel launch) and `factor_ok` gives one
    flag per lane."""

    name = "sparse-normal(device)"
    lane_axis = True   # BatchedMPCKernel admits it (the "batched" mode)

    def __init__(self, A: sp.spmatrix, order: str = "auto", max_supernode: int = 128,
                 mode: str = "batched", fact_dtype=None, inverse: bool = False,
                 krylov: bool = False, krylov_tol: float = 1e-12, krylov_maxit: int = 64,
                 schedule_mode: str = "greedy"):
        # krylov: the (float32) factorization as the preconditioner of
        # float64 CG on the scaled normal matrix (options.endgame="krylov")
        self.krylov = krylov
        self.krylov_tol = float(krylov_tol)
        self.krylov_maxit = int(krylov_maxit)
        self.fact_dtype = torch_dtype(fact_dtype) if fact_dtype else None
        self.inverse = inverse
        self.mode = mode
        A = sp.csc_matrix(A)
        A.sum_duplicates()
        A = A.sorted_indices()
        m, n = A.shape
        self.m, self.n = m, n
        # Canonical nonzero ordering: the pair indices below address A's
        # CSC data array, so the problem's (a_rows, a_cols, a_vals) must be
        # built from these arrays (std.A is CSR: its COO order is
        # row-major).
        Acoo = A.tocoo()
        self.coo_rows = Acoo.row.astype(np.int64)
        self.coo_cols = Acoo.col.astype(np.int64)
        self.coo_vals = Acoo.data.copy()
        self._device_idx: dict = {}
        self.symb = None
        self.use_ldl = False

        # Assembly route: the pair lists cost sum_k nnz(col_k)^2 host work
        # and memory; an A with dense columns (the svm family: 200 columns
        # x 3000 rows) explodes them, and in dense mode the dense (m, n)
        # product is cheaper whenever it is affordable and the pair count
        # dwarfs it.
        col_nnz = np.diff(A.indptr)
        npairs = int(np.sum(col_nnz.astype(np.int64) ** 2 + col_nnz) // 2)
        self.npairs = npairs
        if mode == "dense" and m * n <= int(2e8) and (
                npairs > int(2e7) or npairs > 4 * m * n):
            self.assembly = "matmul"
            return
        self.assembly = "pairs"

        # Pattern of S = A A' (+ the diagonal for the -del_c term), and its
        # upper triangle in CSC: the value array the lists address.
        Abool = A.copy()
        Abool.data = np.ones_like(Abool.data)
        S_pat = (Abool @ Abool.T + sp.eye(m)).tocsc().sorted_indices()
        S_up = sp.triu(S_pat.tocsr(), k=0, format="csc").sorted_indices()
        self.pair_p, self.pair_q, self.pair_k, self.pair_e = _pair_lists(A, S_up)
        self.nnz_up = int(S_up.nnz)
        # (row, col) of every upper entry, for the Jacobi scaling and the
        # scatter into the dense matrix; the diagonal's positions.
        self.entry_row = S_up.indices.astype(np.int64)
        self.entry_col = np.repeat(np.arange(m, dtype=np.int64), np.diff(S_up.indptr))
        self.diag_pos = np.flatnonzero(self.entry_row == self.entry_col)
        if mode == "dense":
            return

        # The supernodal symbolic phase over S's pattern; S's values reach
        # the schedule's permuted upper-CSC order through one gather.
        if mode == "batched":
            self.symb = SC.analyze_batched(S_pat, order=order, max_supernode=max_supernode,
                                           schedule_mode=schedule_mode)
        else:
            self.symb = SC.analyze(S_pat, order=order, max_supernode=max_supernode)
        self.value_gather = value_gather(self.symb, S_up)
        # A float32 factorization of the (SPD, but cond ~1e8 near
        # convergence) normal matrix drives trailing pivots negative: the
        # batched mode's float32 phase takes the pivot-floored LDL^T (signs
        # all +1), refinement absorbing the perturbation.
        self.use_ldl = self.fact_dtype == torch.float32 and mode == "batched"
        if self.use_ldl:
            self.expected_signs = SC.bucket_signs(self.symb, np.ones(m))
            self.pivot_floor = 1e-6

    def device_idx(self, device) -> dict:
        """The symbolic index lists as tensors on `device`, made once per
        device: the pair lists in the order of their target entry (the
        segment sum's order and lengths), the entry rows and columns, the
        diagonal positions, and for the supernodal modes the value gather
        and the expected pivot signs."""
        device = torch.device(device)
        ix = self._device_idx.get(device)
        if ix is None:
            order, lengths = segments(self.pair_e, self.nnz_up)

            def t(v):
                return torch.as_tensor(np.asarray(v, np.int64), device=device)

            ix = dict(pair_p=t(self.pair_p[order]), pair_q=t(self.pair_q[order]),
                      pair_k=t(self.pair_k[order]),
                      pair_len=lengths_tensor(lengths, len(order), device),
                      diag_pos=t(self.diag_pos), entry_row=t(self.entry_row),
                      entry_col=t(self.entry_col))
            if self.symb is not None:
                ix["value_gather"] = t(self.value_gather)
            if self.use_ldl:
                ix["signs"] = [torch.as_tensor(v, dtype=self.fact_dtype, device=device)
                               for v in self.expected_signs]
            self._device_idx[device] = ix
        return ix

    def factorize(self, prob, pr_diag, del_c):
        # W = Σ (+ diag(H) for separable QPs): stays diagonal, so the
        # normal-equations reduction is exact.
        h_vals = getattr(prob, "h_vals", None)
        if h_vals is not None and h_vals.shape[-1]:
            pr_diag = pr_diag + segment_sum(h_vals, prob.h_row_len, prob.h_row_order)
        D = 1.0 / pr_diag
        if D.dim() > 1 and self.mode != "batched":
            raise ValueError(f"a batch of instances needs mode='batched' (got {self.mode!r})")
        if self.assembly == "matmul":
            return self._factorize_matmul(prob, D, del_c)
        ix = self.device_idx(prob.a_vals.device)
        a = prob.a_vals
        contrib = a[..., ix["pair_p"]] * D[..., ix["pair_k"]] * a[..., ix["pair_q"]]
        s_vals = segment_sum(contrib, ix["pair_len"])
        s_vals[..., ix["diag_pos"]] -= K.per_lane(del_c)
        # Symmetric Jacobi scaling to unit diagonal: Ms = Ds S Ds, solved
        # through S^-1 = Ds Ms^-1 Ds; keeps a float32 factorization usable
        # when the barrier diagonal spans ~1e+-8.
        s_diag = s_vals[..., ix["diag_pos"]]
        scale = torch.rsqrt(torch.clamp(s_diag, min=torch.finfo(s_diag.dtype).tiny))
        s_vals = s_vals * scale[..., ix["entry_row"]] * scale[..., ix["entry_col"]]
        if self.mode != "dense":
            s_vals = s_vals[..., ix["value_gather"]]
        if self.fact_dtype is not None and s_vals.dtype != self.fact_dtype:
            s_vals = s_vals.to(self.fact_dtype)
        if self.use_ldl:
            panels = SC.factorize_batched_ldl(self.symb, s_vals, signs=ix["signs"],
                                              pivot_floor=self.pivot_floor,
                                              inverse=self.inverse)
        elif self.mode == "batched":
            panels = SC.factorize_batched(self.symb, s_vals, inverse=self.inverse)
        elif self.mode != "dense":
            panels = SC.factorize(self.symb, s_vals)
        else:
            panels = self._factorize_dense(s_vals, ix)
        return (panels, D, scale, prob, del_c)

    def _factorize_dense(self, s_vals, ix):
        m = self.m
        Su = s_vals.new_zeros((m, m))
        Su[ix["entry_row"], ix["entry_col"]] = s_vals
        Sd = Su + Su.T - torch.diag(torch.diagonal(Su))
        if self.fact_dtype == torch.float32:
            # Static pivoting for float32: on the unit-diagonal matrix a
            # 1e-6 diagonal shift bounds the pivots (the JAX package's
            # fixed shift, kept as it is: ROADMAP.md Queue 3); refinement
            # absorbs it.
            Sd = Sd + 1e-6 * torch.eye(m, dtype=Sd.dtype, device=Sd.device)
        return factor_inv_chol(Sd)

    def _factorize_matmul(self, prob, D, del_c):
        """Assembly without pair lists: A scattered into a dense (m, n)
        matrix and S = (A D) A' as one product, in the factorization's
        dtype (the JAX package computes this product outside any Pallas
        kernel; here it is torch.matmul)."""
        dt = self.fact_dtype if self.fact_dtype is not None else prob.a_vals.dtype
        m, n = self.m, self.n
        Ad = prob.a_vals.new_zeros((m, n), dtype=dt)
        Ad[prob.a_rows, prob.a_cols] = prob.a_vals.to(dt)
        Sd = (Ad * D.to(dt)[None, :]) @ Ad.T
        Sd = Sd - del_c * torch.eye(m, dtype=dt, device=Sd.device)
        scale = torch.rsqrt(torch.clamp(torch.diagonal(Sd), min=torch.finfo(dt).tiny))
        Sd = Sd * scale[:, None] * scale[None, :]
        if self.fact_dtype == torch.float32:
            # the diagonal shift as static pivoting (see _factorize_dense)
            Sd = Sd + 1e-6 * torch.eye(m, dtype=dt, device=Sd.device)
        return (factor_inv_chol(Sd), D, scale.to(D.dtype), prob, del_c)

    def _apply_factor(self, panels, r2):
        """One backsolve against the stored factorization (in its dtype)."""
        out_dtype = r2.dtype
        if self.fact_dtype is not None and r2.dtype != self.fact_dtype:
            r2 = r2.to(self.fact_dtype)
        if self.mode == "dense":
            _L, iL = panels
            dy = iL.T @ (iL @ r2)
        elif self.use_ldl:
            dy = SC.solve_batched_ldl(self.symb, panels, r2, inverse=self.inverse)
        elif self.mode == "batched":
            dy = SC.solve_batched(self.symb, panels, r2, inverse=self.inverse)
        else:
            dy = SC.solve(self.symb, panels, r2)
        return dy.to(out_dtype)

    def solve(self, factors, rx, ry):
        panels, D, scale, prob, del_c = factors
        r1 = rx * D
        r2 = (prob.jac_mv(r1) - ry) * scale
        if self.krylov:
            # float64 PCG on Ms = Ds (A D A' - del_c I) Ds, the factor as M^-1
            def matvec(v):
                u = scale * v
                return scale * prob.jac_mv(D * prob.jac_rmv(u)) - del_c * scale * u

            dy, _k = pcg(matvec, lambda r: self._apply_factor(panels, r), r2,
                         tol_rel=self.krylov_tol, maxit=self.krylov_maxit)
        else:
            dy = self._apply_factor(panels, r2)
        dy = dy * scale
        dx = (rx - prob.jac_rmv(dy)) * D
        return dx, dy

    def factor_ok(self, factors):
        """Whether the factorization succeeded: a 0-d bool tensor, or one
        flag per lane (B,) for a batch."""
        panels, D, _scale, _prob, _del_c = factors
        ok = (D > 0).all(-1)
        if self.mode == "dense":
            dP = torch.diagonal(panels[0])
            return ok & torch.isfinite(dP).all() & (dP > 0).all()
        if self.use_ldl:
            ix = self.device_idx(D.device)
            return ok & SC.factor_ok_batched_ldl(panels, ix["signs"])
        if self.mode == "batched":
            return ok & SC.factor_ok_batched(panels, lanes=D.shape[:-1])
        for P in panels:
            dP = torch.diagonal(P[: P.shape[1], :])
            ok = ok & torch.isfinite(dP).all() & (dP > 0).all()
        return ok


def make_problem(std, kkt, dtype, device):
    """The sparse problem of the standard form `std` at `dtype` on
    `device`, its Jacobian in the KKT's canonical COO order (a
    `SparseQPProblem` when std has a diagonal Hessian)."""
    def vec(v, dt=dtype):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=device)

    a = coo_fields(kkt.coo_rows, kkt.coo_cols, canonical_coo_vals(std.A),
                   std.m, std.n, dtype, device)
    base = dict(c0=vec(std.c0), c=vec(std.c), b=vec(std.b),
                has_lb=vec(std.has_lb, torch.bool), has_ub=vec(std.has_ub, torch.bool),
                **{f"a_{k}": v for k, v in a.items()})
    if std.H is not None and std.H.nnz:
        Hcoo = canonical_csc(std.H).tocoo()
        h = coo_fields(Hcoo.row, Hcoo.col, Hcoo.data, std.n, std.n, dtype, device)
        return SparseQPProblem(**base, **{f"h_{k}": v for k, v in h.items()})
    return SparseLPProblem(**base)


def problem_arrays(std, kkt, x0, y0, dtype_name, device):
    """(problem, lb, ub, x0, y0) of the standard form `std` and its starting
    point at the dtype named `dtype_name` on `device` (`make_problem`)."""
    dt = torch_dtype(dtype_name)
    return (make_problem(std, kkt, dt, device),
            *(torch.as_tensor(v, dtype=dt, device=device) for v in (std.lb, std.ub, x0, y0)))


def solve_sparse_lp(qp: QuadraticProblem, order: str = "auto",
                    mode: str = "auto", *, device="cuda", **options):
    """Solve a (large sparse) LP, or separable (diagonal-Hessian) QP, on
    `device` (the CUDA card unless the caller asks for the CPU): sparse
    matvecs, the normal matrix assembled there and factored as one dense
    matrix or by the supernodal Cholesky.

    mode: "auto" takes "dense" for m <= dense_normal_limit (options) and
    "batched" (the supernodal schedule, K1's batched form on the fronts)
    above it; "dense", "batched" or any other name (one front at a time,
    the reference's "unrolled" / "scan") force a mode.  `order` chooses
    the supernodal ordering ("auto": the cheaper schedule of AMD and
    nested dissection) and has no effect on the dense mode.  A pattern
    whose schedule exceeds MADQP_MAX_UPDATE_ENTRIES is solved whole on the
    host path (`endgame_backend="host-full"`).

    Mixed precision (factorization_dtype="float32", the two-phase scheme):
    a float32 phase to phase1_tol, then either the host endgame
    (endgame="host", or "auto" with the native library: `HostMPCSolver`
    warm-started from the float32 iterate, on the host normal equations,
    or on the host K2 system when the assembly is "matmul") or a float64
    phase of this path warm-started the same way: refactoring in float64
    ("f64") or float64 CG preconditioned by the float32 factor ("krylov").

    Returns ExecutionStats like `solve`; `total_time` counts from entry."""
    t0 = time.time()
    device = torch.device(device)
    opts, _ = load_options(**options)
    opts = resolve_endgame(opts)
    std, info, x0, y0 = build_standard_form_sparse(
        qp, scaling=opts.scaling, max_gradient=opts.max_gradient)
    if std.H is not None and std.H.nnz:
        Hcoo = sp.coo_matrix(std.H)
        if not (Hcoo.row == Hcoo.col).all():
            raise ValueError(
                "solve_sparse_lp handles LPs and diagonal-Hessian QPs only "
                "(use solve_sparse_qp for general sparse QPs).")
    if mode == "auto":
        mode = "dense" if std.A.shape[0] <= opts.dense_normal_limit else "batched"
    full_f32_products(device)
    fp = pattern_fingerprint(std.A, std.H)

    def kernel_for(o):
        # Pattern-keyed reuse: same sparsity and options => no symbolic
        # re-analysis (values are the problem arrays').
        return get_sparse_kernel(f"lp:{order}:{mode}", fp, o,
                                 lambda: make_sparse_kkt("normal", std, o, order, mode))

    opts1, opts2 = sparse_phases(opts, typed_phase1=True)
    try:
        kkt, kernel = kernel_for(opts1)
    except SC.ScheduleTooLargeError:
        # A high-fill pattern whose flat scatter-map schedule would exceed
        # the update-traffic cap: the whole solve runs on the host path.
        return _host_full_solve(qp, opts, t0, kkt_system="normal")

    def phase2():
        kkt2, kernel2 = kernel_for(opts2)
        return kkt2, kernel2, problem_arrays(std, kkt, x0, y0, opts2.dtype, device)[:3]

    # The host endgame: dense-column patterns (matmul assembly) make S
    # dense, where the host's sparse LDL pays O(m^3) in CSC: those hand over
    # to the host K2 system, whose fill follows nnz(A).
    return _solve_phases(qp, info, std, opts, t0, device,
                         (kkt, kernel, problem_arrays(std, kkt, x0, y0, opts1.dtype, device)),
                         phase2 if opts2 is not None else None,
                         host_kkt="k2" if kkt.assembly == "matmul" else "normal",
                         eg_backend="device-" + opts.endgame)
