"""The sparse condensed (K1) KKT path on the device (port of
`madqp_tpu/solver/sparse_condensed.py`).

After relaxing the equality rows (RelaxEquality semantics,
`relax_equalities`) every constraint row has a bounded slack, so the
standard form is A x_int = 0 with A = [A0, -I].  Eliminating the slack
block and the constraint duals from the augmented (K2) system

    [ H0+Σx   0     A0ᵀ  ] [Δx]   [rx]
    [ 0       Σs    -I   ] [Δs] = [rs]        (Σ > 0, δ_c ≤ 0)
    [ A0      -I    δ_c I] [Δy]   [ry]

gives the SPD n0 × n0 condensed system

    C Δx = rx + A0ᵀ D (ry + Σs⁻¹ rs),   C = H0 + Σx + A0ᵀ D A0,
    D = (Σs⁻¹ − δ_c)⁻¹ > 0,
    Δy = D (A0 Δx − ry − Σs⁻¹ rs),      Δs = Σs⁻¹ (rs + Δy).

C's pattern H0 + A0ᵀA0 is fixed at construction.  Its values are summed on
the device from contribution pairs over the ROWS of A0 (the normal path's
lists, transposed), H0's upper triangle and Σx, by a sorted segment
reduction (no atomics), Jacobi-scaled to unit diagonal and gathered into
the supernodal schedule's order.  The float64 fronts are factored by K1's
batched form (`ops/sparse_chol.py::factorize_batched`), the float32 ones
by the pivot-floored LDLᵀ with all signs +1 on K2-batched
(`factorize_batched_ldl`, `ops/ldl_batched.py`).  With `krylov` the
(float32) factor preconditions float64 CG on the scaled C
(`ops/krylov.py::pcg`, endgame="krylov").
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..models.qp import QuadraticProblem, build_standard_form_sparse
from ..ops import sparse_chol as SC
from ..ops.kkt import torch_dtype
from ..ops.krylov import pcg
from ..ops.segment import lengths_tensor, segment_sum, segments
from ..utils import load_options
from .policy import full_f32_products, make_sparse_kkt, sparse_phases
from .sparse_common import (canonical_csc, get_sparse_kernel, pattern_fingerprint,
                            resolve_endgame, upper_lookup, value_gather)
from .sparse_lp import _pair_lists, problem_arrays
from .sparse_qp import _host_full_solve, _solve_phases


class DeviceSparseCondensedKKT:
    """Condensed (K1) KKT over the structural variables only.

    Needs the internal standard form in which EVERY row has a slack
    (A_int = [A0, -I], slack j <-> row j): `solve_sparse_condensed`
    relaxes the equality rows first.  The factorize / solve / factor_ok
    protocol of the other sparse device KKTs; `rx` spans the whole internal
    primal (structural and slack) block."""

    name = "sparse-condensed(device)"

    def __init__(self, H0: Optional[sp.spmatrix], A0: sp.spmatrix, order: str = "auto",
                 max_supernode: int = 128, fact_dtype=None,
                 pivot_floor: Optional[float] = None, inverse: bool = False,
                 krylov: bool = False, krylov_tol: float = 1e-12, krylov_maxit: int = 64,
                 schedule_mode: str = "greedy"):
        self.fact_dtype = torch_dtype(fact_dtype) if fact_dtype else None
        self.inverse = inverse
        # the krylov endgame: the factor as the preconditioner of float64 CG
        self.krylov = krylov
        self.krylov_tol = float(krylov_tol)
        self.krylov_maxit = int(krylov_maxit)
        A0 = canonical_csc(A0)
        m, n0 = A0.shape
        self.m, self.n0 = m, n0
        self.nnz0 = int(A0.nnz)
        A0coo = A0.tocoo()   # canonical CSC order: the problem's a_vals[:nnz0]
        self.a0_rows = A0coo.row.astype(np.int64)
        self.a0_cols = A0coo.col.astype(np.int64)
        # The problem's COO of the whole A_int = [A0, -I] (`make_problem`).
        A_int = canonical_csc(sp.hstack([A0, -sp.eye(m)], format="csc"))
        Acoo = A_int.tocoo()
        self.coo_rows = Acoo.row.astype(np.int64)
        self.coo_cols = Acoo.col.astype(np.int64)
        if H0 is not None:
            H0 = canonical_csc(H0)
            if H0.nnz == 0:
                H0 = None
        self.H0 = H0

        # The pattern of C = H0 + I + A0ᵀA0, its upper-triangle CSC (the
        # value array of the assembly) and the position lookup in it.
        Abool = A0.copy()
        Abool.data = np.ones_like(Abool.data)
        C_pat = (Abool.T @ Abool + sp.eye(n0)).tocsc()
        if H0 is not None:
            Hb = H0.copy()
            Hb.data = np.ones_like(Hb.data)
            C_pat = (C_pat + Hb).tocsc()
        C_pat.sum_duplicates()
        U = sp.triu(C_pat.tocsr(), k=0, format="csc").sorted_indices()
        pos = upper_lookup(U)
        self.nnz_up = int(U.nnz)
        # Contribution pairs over ROWS of A0 (the columns of A0ᵀ): row k
        # with columns J_k adds A0[k,i] D_k A0[k,j] to C_ij, i >= j in
        # J_k x J_k; p and q address A0's canonical-CSC value array (the
        # CSR sweep carries the CSC positions as payload).
        Apos = sp.csc_matrix((np.arange(self.nnz0, dtype=np.int64), A0.indices, A0.indptr),
                             shape=A0.shape).tocsr()
        At = sp.csc_matrix((Apos.data, Apos.indices, Apos.indptr), shape=(n0, m))
        self.pair_p, self.pair_q, self.pair_k, self.pair_e = _pair_lists(
            At, U, payload=Apos.data.astype(np.int64))
        # H0's upper triangle out of the problem's full symmetric h_vals
        # (block_diag(H0, 0) canonicalizes to H0's CSC order).
        if H0 is not None:
            Hcoo = H0.tocoo()
            sel = Hcoo.row <= Hcoo.col
            self.h_sel = np.flatnonzero(sel)
            self.h_pos = pos(Hcoo.row[sel], Hcoo.col[sel])
        else:
            self.h_sel = np.zeros(0, np.int64)
            self.h_pos = np.zeros(0, np.int64)
        self.diag_pos = pos(np.arange(n0), np.arange(n0))
        self.entry_row = U.indices.astype(np.int64)
        self.entry_col = np.repeat(np.arange(n0, dtype=np.int64), np.diff(U.indptr))

        self.symb = SC.analyze_batched(C_pat, order=order, max_supernode=max_supernode,
                                       schedule_mode=schedule_mode)
        self.value_gather = value_gather(self.symb, U)
        # float32: the pivot-floored LDL^T with all signs +1 (a float32
        # Cholesky of the cond ~1e8 SPD matrix breaks, as on the normal path)
        self.use_ldl = self.fact_dtype == torch.float32
        if self.use_ldl:
            self.expected_signs = SC.bucket_signs(self.symb, np.ones(n0))
            self.pivot_floor = 1e-6 if pivot_floor is None else float(pivot_floor)
        self._device_idx: dict = {}

    def device_idx(self, device) -> dict:
        """The index lists as tensors on `device`, made once per device:
        the assembly's sources (the pairs, H0's entries, Σx) in the order of
        their target entry with the segment lengths, the diagonal's
        positions, the entry rows and columns, the value gather, A0's COO
        with its row and column sums' orders, and the pivot signs."""
        device = torch.device(device)
        ix = self._device_idx.get(device)
        if ix is None:
            order, lengths = segments(np.concatenate(
                [self.pair_e, self.h_pos, self.diag_pos]), self.nnz_up)
            r_order, r_len = segments(self.a0_rows, self.m)
            c_order, c_len = segments(self.a0_cols, self.n0)

            def t(v):
                return torch.as_tensor(np.asarray(v, np.int64), device=device)

            ix = dict(pair_p=t(self.pair_p), pair_q=t(self.pair_q), pair_k=t(self.pair_k),
                      order=t(order), lengths=lengths_tensor(lengths, len(order), device),
                      h_sel=t(self.h_sel),
                      diag_pos=t(self.diag_pos), entry_row=t(self.entry_row),
                      entry_col=t(self.entry_col), value_gather=t(self.value_gather),
                      a0_rows=t(self.a0_rows), a0_cols=t(self.a0_cols),
                      r_order=t(r_order), r_len=lengths_tensor(r_len, len(r_order), device),
                      c_order=t(c_order), c_len=lengths_tensor(c_len, len(c_order), device))
            if self.use_ldl:
                ix["signs"] = [torch.as_tensor(v, dtype=self.fact_dtype, device=device)
                               for v in self.expected_signs]
            self._device_idx[device] = ix
        return ix

    def assemble(self, prob, pr_diag, del_c):
        """(C's values in its upper-CSC order before the scaling, D): the
        pairs' A0[k,i] D_k A0[k,j], then H0's values and Σx, summed by
        entry."""
        ix = self.device_idx(pr_diag.device)
        n0 = self.n0
        sig_x, sig_s = pr_diag[:n0], pr_diag[n0:]
        # D = (Σs⁻¹ − δ_c)⁻¹ = Σs / (1 − δ_c Σs); δ_c ≤ 0 keeps it positive.
        D = sig_s / (1.0 - del_c * sig_s)
        a0 = prob.a_vals[: self.nnz0]
        contrib = a0[ix["pair_p"]] * D[ix["pair_k"]] * a0[ix["pair_q"]]
        h = prob.h_vals[ix["h_sel"]] if self.H0 is not None else contrib.new_zeros(0)
        return segment_sum(torch.cat([contrib, h, sig_x]), ix["lengths"], ix["order"]), D

    def factorize(self, prob, pr_diag, del_c):
        ix = self.device_idx(pr_diag.device)
        n0 = self.n0
        sig_x, sig_s = pr_diag[:n0], pr_diag[n0:]
        c_vals, D = self.assemble(prob, pr_diag, del_c)
        # Symmetric Jacobi scaling to unit diagonal (the K2.5 analogue).
        c_diag = c_vals[ix["diag_pos"]]
        scale = torch.rsqrt(torch.clamp(c_diag, min=torch.finfo(c_diag.dtype).tiny))
        c_vals = (c_vals * scale[ix["entry_row"]] * scale[ix["entry_col"]])[ix["value_gather"]]
        if self.fact_dtype is not None and c_vals.dtype != self.fact_dtype:
            # Mixed precision: the MPC kernel's iterative refinement against
            # the float64 kkt_mul recovers the accuracy.
            c_vals = c_vals.to(self.fact_dtype)
        if self.use_ldl:
            panels = SC.factorize_batched_ldl(self.symb, c_vals, signs=ix["signs"],
                                              pivot_floor=self.pivot_floor,
                                              inverse=self.inverse)
        else:
            panels = SC.factorize_batched(self.symb, c_vals, inverse=self.inverse)
        return (panels, D, sig_s, sig_x, scale, prob)

    def _a0_mv(self, prob, ix, x):
        a0 = prob.a_vals[: self.nnz0]
        return segment_sum(a0 * x[ix["a0_cols"]], ix["r_len"], ix["r_order"])

    def _a0_rmv(self, prob, ix, y):
        a0 = prob.a_vals[: self.nnz0]
        return segment_sum(a0 * y[ix["a0_rows"]], ix["c_len"], ix["c_order"])

    def _apply_factor(self, panels, rhs):
        out_dtype = rhs.dtype
        if self.fact_dtype is not None and rhs.dtype != self.fact_dtype:
            rhs = rhs.to(self.fact_dtype)
        if self.use_ldl:
            dx0 = SC.solve_batched_ldl(self.symb, panels, rhs, inverse=self.inverse)
        else:
            dx0 = SC.solve_batched(self.symb, panels, rhs, inverse=self.inverse)
        return dx0.to(out_dtype)

    def solve(self, factors, rx, ry):
        panels, D, sig_s, sig_x, scale, prob = factors
        ix = self.device_idx(rx.device)
        n0 = self.n0
        rx0, rs = rx[:n0], rx[n0:]
        w = D * (ry + rs / sig_s)
        rhs = (rx0 + self._a0_rmv(prob, ix, w)) * scale
        if self.krylov:
            # float64 PCG on Cs = Ds (H0 + Σx + A0ᵀ D A0) Ds, the factor as M^-1
            def matvec(v):
                u = scale * v
                h = prob.hess_mv(torch.cat([u, u.new_zeros(self.m)]))[:n0]
                return scale * (h + sig_x * u
                                + self._a0_rmv(prob, ix, D * self._a0_mv(prob, ix, u)))

            dx0, _k = pcg(matvec, lambda r: self._apply_factor(panels, r), rhs,
                          tol_rel=self.krylov_tol, maxit=self.krylov_maxit)
        else:
            dx0 = self._apply_factor(panels, rhs)
        dx0 = dx0 * scale
        dy = D * (self._a0_mv(prob, ix, dx0) - ry - rs / sig_s)
        ds = (rs + dy) / sig_s
        return torch.cat([dx0, ds]), dy

    def factor_ok(self, factors):
        panels, D = factors[0], factors[1]
        ok = (D > 0).all()
        if self.use_ldl:
            return ok & SC.factor_ok_batched_ldl(panels, self.device_idx(D.device)["signs"])
        return ok & SC.factor_ok_batched(panels)


def relax_equalities(qp: QuadraticProblem, eps: float) -> QuadraticProblem:
    """RelaxEquality semantics (MadNLP, which the reference's condensed
    path needs, src/utils.jl:81-82): every equality row lcon == ucon
    becomes the range lcon − ε̂ ≤ Ax ≤ ucon + ε̂ with ε̂ = ε max(1, |b|)."""
    eq = qp.lcon == qp.ucon
    if not eq.any():
        return qp
    bump = eps * np.maximum(1.0, np.abs(qp.lcon))
    lcon = np.where(eq, qp.lcon - bump, qp.lcon)
    ucon = np.where(eq, qp.ucon + bump, qp.ucon)
    return dataclasses.replace(qp, lcon=lcon, ucon=ucon)


def solve_sparse_condensed(qp: QuadraticProblem, order: str = "auto",
                           eq_relax: Optional[float] = None, *, device="cuda", **options):
    """Solve a sparse LP or QP on `device` (the CUDA card unless the caller
    asks for the CPU) through the condensed (K1) KKT.

    Equality rows are relaxed by `eq_relax` (default: the solve
    tolerance), so every row has a slack: the elimination needs Σs on each
    row.  Mixed precision (factorization_dtype="float32", the two-phase
    scheme): the float32 factorization under a float64 state (a float32
    state breaks the elimination's D arithmetic), then the host K2 endgame
    on the relaxed problem ("host"), a float64 refactorization ("f64"), or
    float64 CG preconditioned by the float32 factor ("krylov").  Returns
    ExecutionStats like `solve`; `total_time` counts from entry."""
    t0 = time.time()
    device = torch.device(device)
    opts, _ = load_options(**options)
    opts = resolve_endgame(opts)
    if eq_relax is None:
        eq_relax = opts.tol
    qp_rel = relax_equalities(qp, float(eq_relax))
    std, info, x0, y0 = build_standard_form_sparse(
        qp_rel, scaling=opts.scaling, max_gradient=opts.max_gradient)
    m = std.A.shape[0]
    n0 = std.A.shape[1] - m
    if n0 < 0 or len(info.ineq_rows) != m:
        raise AssertionError("condensed path requires every row slacked")
    full_f32_products(device)
    fp = pattern_fingerprint(std.A, std.H)

    def kernel_for(o):
        return get_sparse_kernel(f"cond:{order}", fp, o,
                                 lambda: make_sparse_kkt("condensed", std, o, order))

    # typed_phase1 stays off: the elimination's D = (Σs⁻¹ − δ_c)⁻¹ breaks
    # down with a float32 state; the float64-state / float32-factorization
    # scheme is kept instead (the JAX package's choice).
    opts1, opts2 = sparse_phases(opts)
    try:
        kkt, kernel = kernel_for(opts1)
    except SC.ScheduleTooLargeError:
        return _host_full_solve(qp_rel, opts, t0)

    prob, lb, ub, x0d, y0d = problem_arrays(std, kkt, x0, y0, opts.dtype, device)

    def phase2():
        kkt2, kernel2 = kernel_for(opts2)
        return kkt2, kernel2, (prob, lb, ub)

    # the host endgame on the RELAXED problem, which this standard form was
    # built from
    return _solve_phases(qp, info, std, opts, t0, device, (kkt, kernel, (prob, lb, ub, x0d, y0d)),
                         phase2 if opts2 is not None else None, host_qp=qp_rel)
