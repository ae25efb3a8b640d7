"""Presolve: iterated conservative reductions with exact primal AND dual
postsolve.

Equivalent of the reference's `presolve_qp` (scripts/common.jl:102-126, which
delegates to QuadraticModels.presolve).  Implemented reductions, iterated to a
fixpoint (each pass works in the ORIGINAL index space with alive masks, so the
postsolve operations stack can be replayed exactly):

  * bound/row-range sanity (lvar > uvar or lcon > ucon -> infeasible);
  * fixed variables (lvar == uvar) -- substituted out, with Hessian cross
    terms folded into c and the constant into c0;
  * empty constraint rows -- dropped (infeasible if 0 not in [lcon, ucon]);
  * singleton equality rows -- the variable is fixed at b/a (infeasible if
    that violates its bounds); the dropped row's multiplier is recovered in
    postsolve from the stationarity residual;
  * singleton inequality rows -- converted into (possibly tighter) bounds on
    the variable; postsolve moves the bound multiplier back onto the row
    when the implied bound is the binding one;
  * free column singletons on equality rows (LP columns) -- variable and row
    substituted out (the classic Netlib reduction); x_j and y_i recovered in
    closed form in postsolve;
  * empty columns -- fixed at the bound implied by the gradient sign (or at
    the 1-d minimizer -c_j/H_jj for a diagonal-only Hessian column), or
    declared unbounded;
  * detection of trivially solved problems (no rows and no cols left).

Returns (presolved_qp, info, flag): flag=False means the problem was solved,
declared infeasible or unbounded during presolve (matching the reference's
convention of returning the original problem with flag=false).

Dual reconstruction follows the solver's stationarity convention
(ops/kernels.py::dual_infeasibility):  g + A'y - zl + zu = 0,  zl, zu >= 0.
`PresolveInfo.postsolve_stats` maps a reduced-problem ExecutionStats back to
the original space with that identity holding exactly.

Carried over unchanged from `madqp_tpu/models/presolve.py` (NumPy and SciPy only), so both
packages give bit-identical results.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from .qp import QuadraticProblem


class PresolveStatus(enum.Enum):
    REDUCED = "reduced"
    UNCHANGED = "unchanged"
    SOLVED = "solved"
    INFEASIBLE = "infeasible"
    UNBOUNDED = "unbounded"


# ---------------------------------------------------------------------------
# Postsolve operations (recorded during presolve, replayed in reverse)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FixGroup:
    """Columns fixed at values (substituted out).  z_j recovered at the end
    from the original stationarity residual."""

    cols: np.ndarray
    vals: np.ndarray


@dataclasses.dataclass
class _DropEqSingletonRow:
    """Equality row i with single alive entry a at column j; x_j was fixed at
    b/a by a _FixGroup recorded AFTER this op.  Postsolve puts the whole
    stationarity residual of column j on y_i (z_j = 0)."""

    row: int
    col: int
    coef: float


@dataclasses.dataclass
class _DropIneqSingletonRow:
    """Inequality row i (single alive entry a at column j) turned into bounds
    on x_j.  Stores the variable bounds before/after tightening so postsolve
    can attribute the binding multiplier to the row iff the implied bound is
    the strictly tighter one."""

    row: int
    col: int
    coef: float
    old_lvar: float
    old_uvar: float
    new_lvar: float
    new_uvar: float


@dataclasses.dataclass
class _FreeColSingleton:
    """Free column j with a single alive entry a in EQUALITY row i (and no
    Hessian entries): x_j = (b - sum_k A_ik x_k)/a substituted out together
    with the row.  c_j is the objective coefficient at elimination time."""

    row: int
    col: int
    coef: float
    b: float
    cj: float
    row_cols: np.ndarray  # other alive columns on row i (original ids)
    row_vals: np.ndarray


@dataclasses.dataclass
class _ForcingRow:
    """Row i whose activity bound Lmin (resp. Umax) equals its ucon (resp.
    lcon): every entry's variable is forced to the bound achieving the
    extreme and the row is dropped.  Postsolve recovers y_i as the smallest
    sign-safe multiplier making all the forced columns' reduced costs
    complementarity-consistent (Andersen & Andersen's forcing-row dual
    recovery): with residual r_j and coefficient a_ij, every forced column
    requires t >= -r_j/a_ij (low case) / t <= -r_j/a_ij (high case)."""

    row: int
    cols: np.ndarray
    coefs: np.ndarray
    low: bool  # True: activity pinned at its MINIMUM == ucon


@dataclasses.dataclass
class _MergeDupCol:
    """Column drop == alpha * column keep (alpha > 0) with c_drop == alpha *
    c_keep and no Hessian coupling: merged into keep with summed bounds
    w = x_keep + alpha * x_drop.  Postsolve splits greedily (x_drop at its
    lower bound first) which is complementarity-consistent; bound duals of
    the dropped column come from the phase-3 stationarity residual."""

    drop: int
    keep: int
    alpha: float
    l_drop: float
    u_drop: float
    l_keep: float   # keep's bounds at merge time (pre-merge)
    u_keep: float


@dataclasses.dataclass
class _MergeDupRow:
    """Row `drop` == alpha * row `keep` (in the live submatrix at merge
    time) merged into `keep` by intersecting transformed bounds.  Postsolve
    transfers the multiplier to the dropped row (y_drop = y_keep / alpha)
    iff the dropped row is the binding one, judged by original-space row
    slacks — the rows agree on every column alive at merge time, so the
    transfer preserves A'y there, and earlier-eliminated columns absorb
    any difference through the phase-3 residual."""

    drop: int
    keep: int
    alpha: float


@dataclasses.dataclass
class PresolveInfo:
    status: PresolveStatus
    keep_rows: np.ndarray
    keep_cols: np.ndarray
    fixed_cols: np.ndarray
    fixed_vals: np.ndarray
    nvar: int
    ncon: int
    ops: List[Any] = dataclasses.field(default_factory=list)
    original: Optional[QuadraticProblem] = None

    # -- primal ------------------------------------------------------------

    def postsolve_x(self, x_red: np.ndarray) -> np.ndarray:
        x = np.zeros(self.nvar)
        x[self.keep_cols] = x_red
        for op in reversed(self.ops):
            if isinstance(op, _FixGroup):
                x[op.cols] = op.vals
            elif isinstance(op, _FreeColSingleton):
                x[op.col] = (op.b - op.row_vals @ x[op.row_cols]) / op.coef
            elif isinstance(op, _MergeDupCol):
                # split w = x_keep + alpha x_drop: anchor x_drop at a finite
                # bound and let x_keep absorb the rest (clipped), which is
                # complementarity-consistent with the phase-3 residual
                # duals; a doubly-free drop column takes the remainder.
                w = x[op.keep]
                if np.isfinite(op.l_drop):
                    xk = np.clip(w - op.alpha * op.l_drop,
                                 op.l_keep, op.u_keep)
                elif np.isfinite(op.u_drop):
                    xk = np.clip(w - op.alpha * op.u_drop,
                                 op.l_keep, op.u_keep)
                else:
                    xk = np.clip(w, op.l_keep, op.u_keep)
                x[op.keep] = xk
                x[op.drop] = (w - xk) / op.alpha
        return x

    # -- duals ---------------------------------------------------------------

    def postsolve_y(self, y_red: np.ndarray) -> np.ndarray:
        """Scatter-only dual map (dropped rows get 0).  Exact whenever no
        dropped row carries an active multiplier; `postsolve_stats` is the
        exact version (it needs x, zl, zu as well)."""
        y = np.zeros(self.ncon)
        y[self.keep_rows] = y_red
        return y

    def postsolve(
        self,
        x_red: np.ndarray,
        y_red: np.ndarray,
        zl_red: Optional[np.ndarray] = None,
        zu_red: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Exact KKT postsolve: returns (x, y, zl, zu) on the original
        problem satisfying g + A'y - zl + zu = 0 wherever the reduced
        solution did."""
        qp = self.original
        assert qp is not None, "postsolve requires info.original"
        nr = len(self.keep_cols)
        if zl_red is None:
            zl_red = np.zeros(nr)
        if zu_red is None:
            zu_red = np.zeros(nr)

        sign = 1.0 if qp.minimize else -1.0
        # internal computation is in MIN convention; reduced multipliers
        # arrive in the user's sense (solver/qp.py recover_y/recover_z)
        x = self.postsolve_x(np.asarray(x_red))
        y = np.zeros(self.ncon)
        y[self.keep_rows] = sign * np.asarray(y_red)
        zl = np.zeros(self.nvar)
        zu = np.zeros(self.nvar)
        zl[self.keep_cols] = np.maximum(sign * np.asarray(zl_red), 0.0)
        zu[self.keep_cols] = np.maximum(sign * np.asarray(zu_red), 0.0)

        A = qp.A.tocsc()
        H = qp.H.tocsc() if qp.H is not None else None
        c = sign * qp.c
        Hx = sign * np.asarray(qp.H @ x).ravel() if H is not None else np.zeros(self.nvar)

        def residual(j: int) -> float:
            # g_j + (A'y)_j - zl_j + zu_j with the CURRENT y (column dot)
            aty = float(np.asarray(A[:, j].T @ y).ravel()[0])
            return float(c[j] + Hx[j] + aty - zl[j] + zu[j])

        Ar = qp.A.tocsr()

        def _row_slack(i: int, act: float) -> float:
            lo = qp.lcon[i] if np.isfinite(qp.lcon[i]) else -np.inf
            hi = qp.ucon[i] if np.isfinite(qp.ucon[i]) else np.inf
            return float(min(act - lo, hi - act))

        def _assign_from_residual(j: int) -> None:
            if zl[j] == 0.0 and zu[j] == 0.0:
                r = residual(j)
                if r >= 0.0:
                    zl[j] = r
                else:
                    zu[j] = -r

        # Single REVERSE-chronological pass: every op recovers its own
        # duals from residuals computed with all LATER-eliminated rows' /
        # columns' duals already final (eliminations only reference
        # structure that was alive at their time, so reverse order is the
        # triangular order).  A phase-batched recovery breaks once ops
        # interact — e.g. a forcing row whose multiplier depends on an
        # inequality-singleton transfer of a column fixed two passes later.
        for op in reversed(self.ops):
            if isinstance(op, _FixGroup):
                for j in op.cols:
                    _assign_from_residual(j)
            elif isinstance(op, _MergeDupCol):
                _assign_from_residual(op.drop)
            elif isinstance(op, _FreeColSingleton):
                y[op.row] = -op.cj / op.coef
            elif isinstance(op, _DropIneqSingletonRow):
                j, a = op.col, op.coef
                # the column's dual (from the reduced solution, or assigned
                # by a later-recovered fix) moves onto the row iff the
                # implied bound is the strictly tighter one
                if op.new_lvar > op.old_lvar and zl[j] > 0.0:
                    y[op.row] = -zl[j] / a
                    zl[j] = 0.0
                elif op.new_uvar < op.old_uvar and zu[j] > 0.0:
                    y[op.row] = zu[j] / a
                    zu[j] = 0.0
            elif isinstance(op, _DropEqSingletonRow):
                zl[op.col] = zu[op.col] = 0.0
                y[op.row] = -residual(op.col) / op.coef
            elif isinstance(op, _MergeDupRow):
                # transfer iff the dropped row is the (strictly) tighter
                # one at the solution, measured against ORIGINAL bounds
                yk = y[op.keep]
                if yk == 0.0:
                    continue
                act_k = float(np.asarray(Ar[op.keep] @ x).ravel()[0])
                act_d = float(np.asarray(Ar[op.drop] @ x).ravel()[0])
                tol_s = 1e-12 * max(1.0, abs(act_k), abs(act_d))
                if _row_slack(op.drop, act_d) < _row_slack(op.keep, act_k) - tol_s:
                    # rows agree on all columns alive at merge time:
                    # y_drop * (alpha * a_keep'x) == y_keep * a_keep'x
                    y[op.drop] = yk / op.alpha
                    y[op.keep] = 0.0
            elif isinstance(op, _ForcingRow):
                # smallest sign-safe multiplier satisfying every forced
                # column's complementarity constraint, then reassign the
                # columns' bound duals from the updated residuals
                for j in op.cols:
                    zl[int(j)] = zu[int(j)] = 0.0
                ratios = [-residual(int(j)) / a
                          for j, a in zip(op.cols, op.coefs)]
                t = max(0.0, max(ratios)) if op.low \
                    else min(0.0, min(ratios))
                if t != 0.0:
                    y[op.row] = t
                for j in op.cols:
                    _assign_from_residual(int(j))
        if not qp.minimize:
            y, zl, zu = -y, -zl, -zu
        return x, y, zl, zu

    def postsolve_stats(self, stats):
        """Map a reduced-problem ExecutionStats onto the original problem."""
        qp = self.original
        x, y, zl, zu = self.postsolve(
            np.asarray(stats.solution),
            np.asarray(stats.multipliers),
            np.asarray(stats.multipliers_L),
            np.asarray(stats.multipliers_U),
        )
        return dataclasses.replace(
            stats,
            solution=x,
            multipliers=y,
            multipliers_L=zl,
            multipliers_U=zu,
            constraints=np.asarray(qp.A @ x).ravel(),
        )


# ---------------------------------------------------------------------------
# The presolve driver
# ---------------------------------------------------------------------------


def _fail(qp, status: PresolveStatus):
    m, n = qp.ncon, qp.nvar
    info = PresolveInfo(
        status, np.arange(m), np.arange(n), np.array([], dtype=int),
        np.array([]), n, m, [], qp,
    )
    return qp, info, False


def presolve_qp(
    qp: QuadraticProblem, tol: float = 1e-10, max_passes: int = 10
) -> tuple[QuadraticProblem, PresolveInfo, bool]:
    m, n = qp.ncon, qp.nvar
    sign = 1.0 if qp.minimize else -1.0

    # working copies in the ORIGINAL index space (minimization convention)
    c = sign * qp.c.copy()
    c0 = sign * qp.c0
    lcon, ucon = qp.lcon.copy(), qp.ucon.copy()
    lvar, uvar = qp.lvar.copy(), qp.uvar.copy()
    A = qp.A.tocsc(copy=True)
    A_rows = qp.A.tocsr(copy=True)
    H = (sign * qp.H).tocsc() if qp.H is not None else None
    h_col_nnz = np.diff(H.indptr) if H is not None else np.zeros(n, dtype=int)
    if H is not None:
        hc = H.tocoo()
        off = (hc.row != hc.col) & (hc.data != 0.0)
        h_offdiag = np.bincount(hc.col[off], minlength=n)
        h_diag_only = h_offdiag == 0
    else:
        h_diag_only = np.ones(n, dtype=bool)

    alive_col = np.ones(n, dtype=bool)
    alive_row = np.ones(m, dtype=bool)
    ops: List[Any] = []

    if np.any(lvar > uvar + tol) or np.any(lcon > ucon + tol):
        return _fail(qp, PresolveStatus.INFEASIBLE)

    def sub(mat):
        return mat[alive_row][:, alive_col]

    def eliminate_fixed(cols: np.ndarray, vals: np.ndarray):
        nonlocal c0
        if cols.size == 0:
            return
        v = sp.csc_matrix(
            (vals, (cols, np.zeros_like(cols))), shape=(n, 1))
        c0 += float(c[cols] @ vals)
        if H is not None:
            Hv = np.asarray((H @ v).todense()).ravel()
            c0 += 0.5 * float(vals @ Hv[cols])
            c[:] += Hv
            c[cols] -= Hv[cols]  # keep eliminated entries' c untouched-ish
        Av = np.asarray((A @ v).todense()).ravel()
        lcon[:] = lcon - Av
        ucon[:] = ucon - Av
        alive_col[cols] = False
        ops.append(_FixGroup(cols.copy(), np.asarray(vals, dtype=float).copy()))

    for _ in range(max_passes):
        changed = False

        live_r = np.where(alive_row)[0]
        live_c = np.where(alive_col)[0]
        Asub = sub(A_rows).tocsr()
        row_nnz = np.diff(Asub.indptr)

        # ---- empty rows ---------------------------------------------------
        empty = row_nnz == 0
        if empty.any():
            er = live_r[empty]
            if np.any(lcon[er] > tol) or np.any(ucon[er] < -tol):
                return _fail(qp, PresolveStatus.INFEASIBLE)
            alive_row[er] = False
            changed = True
            live_r = np.where(alive_row)[0]
            Asub = sub(A_rows).tocsr()
            row_nnz = np.diff(Asub.indptr)

        # ---- row activity bounds: proven infeasible / redundant rows ------
        # L_i = sum_j min(a_ij l_j, a_ij u_j) and U_i = max-side: the range
        # of a_i'x over the variable box.  L > ucon or U < lcon proves
        # infeasibility; [L, U] inside [lcon, ucon] proves the row implied
        # by the bounds — dropping it is dual-exact with y_i = 0 (the
        # postsolve default for dropped rows).
        if row_nnz.sum() > 0:
            lv, uv = lvar[live_c], uvar[live_c]
            dat, idx = Asub.data, Asub.indices
            lo_t = np.where(dat > 0, dat * lv[idx], dat * uv[idx])
            hi_t = np.where(dat > 0, dat * uv[idx], dat * lv[idx])
            zero = dat == 0.0
            lo_t[zero] = 0.0  # guard 0 * inf
            hi_t[zero] = 0.0
            rows_exp = np.repeat(np.arange(live_r.size), row_nnz)
            Lmin = np.bincount(rows_exp, weights=lo_t,
                               minlength=live_r.size)
            Umax = np.bincount(rows_exp, weights=hi_t,
                               minlength=live_r.size)
            lc, uc = lcon[live_r], ucon[live_r]
            ttol_u = np.maximum(tol, tol * np.abs(uc))
            ttol_l = np.maximum(tol, tol * np.abs(lc))
            if np.any(np.isfinite(uc) & (Lmin > uc + ttol_u)) or np.any(
                    np.isfinite(lc) & (Umax < lc - ttol_l)):
                return _fail(qp, PresolveStatus.INFEASIBLE)

            # ---- forcing rows: activity bound EQUALS a constraint bound --
            # Lmin == ucon pins the row at its minimum activity: every
            # entry's variable sits at the bound achieving the minimum
            # (a>0 -> lower, a<0 -> upper); mirrored for Umax == lcon.
            with np.errstate(invalid="ignore"):  # inf - inf in masked lanes
                forced_low = np.isfinite(uc) & (Lmin >= uc - ttol_u)
                forced_high = np.isfinite(lc) & (Umax <= lc + ttol_l)
            f_fix_cols: List[int] = []
            f_fix_vals: List[float] = []
            f_claimed: set = set()
            for rloc in np.where((forced_low | forced_high)
                                 & (row_nnz > 0))[0]:
                i = live_r[rloc]
                s, e = Asub.indptr[rloc], Asub.indptr[rloc + 1]
                jlocs = Asub.indices[s:e]
                coefs = Asub.data[s:e]
                cols_g = live_c[jlocs]
                if any(j in f_claimed for j in cols_g):
                    continue  # overlapping forcing rows: one per pass
                low = bool(forced_low[rloc])
                at_min = (coefs > 0) == low  # variable sits at LOWER bound
                vals_g = np.where(at_min, lvar[cols_g], uvar[cols_g])
                if not np.all(np.isfinite(vals_g)):
                    continue  # infinite activity bound can't equal finite rhs
                ops.append(_ForcingRow(i, cols_g.copy(), coefs.copy(), low))
                alive_row[i] = False
                f_fix_cols.extend(int(j) for j in cols_g)
                f_fix_vals.extend(float(v) for v in vals_g)
                f_claimed.update(int(j) for j in cols_g)
                changed = True
            if f_fix_cols:
                eliminate_fixed(np.asarray(f_fix_cols, dtype=int),
                                np.asarray(f_fix_vals))
                live_r = np.where(alive_row)[0]
                live_c = np.where(alive_col)[0]
                Asub = sub(A_rows).tocsr()
                row_nnz = np.diff(Asub.indptr)
                lv, uv = lvar[live_c], uvar[live_c]
                lc, uc = lcon[live_r], ucon[live_r]
                if row_nnz.sum() > 0:
                    dat, idx = Asub.data, Asub.indices
                    lo_t = np.where(dat > 0, dat * lv[idx], dat * uv[idx])
                    hi_t = np.where(dat > 0, dat * uv[idx], dat * lv[idx])
                    zero = dat == 0.0
                    lo_t[zero] = 0.0
                    hi_t[zero] = 0.0
                    rows_exp = np.repeat(np.arange(live_r.size), row_nnz)
                    Lmin = np.bincount(rows_exp, weights=lo_t,
                                       minlength=live_r.size)
                    Umax = np.bincount(rows_exp, weights=hi_t,
                                       minlength=live_r.size)
                else:
                    Lmin = np.zeros(live_r.size)
                    Umax = np.zeros(live_r.size)

            redundant = ((~np.isfinite(lc) | (Lmin >= lc))
                         & (~np.isfinite(uc) | (Umax <= uc))
                         & (row_nnz > 0))
            if redundant.any():
                alive_row[live_r[redundant]] = False
                changed = True
                live_r = np.where(alive_row)[0]
                Asub = sub(A_rows).tocsr()
                row_nnz = np.diff(Asub.indptr)

        # ---- duplicate (parallel) rows -------------------------------------
        # rows i with row_i == alpha * row_keep merge into keep by
        # intersecting (transformed) bounds; postsolve transfers the
        # binding multiplier back when the tight side came from a dropped
        # row (_MergeDupRow).
        if live_r.size > 1 and row_nnz.size and row_nnz.max() > 0:
            Asub.sort_indices()
            groups: dict = {}
            for rloc in range(live_r.size):
                s, e = Asub.indptr[rloc], Asub.indptr[rloc + 1]
                if e == s:
                    continue
                vals_r = Asub.data[s:e]
                pivot = vals_r[np.argmax(np.abs(vals_r))]
                if abs(pivot) < 1e-14:
                    continue
                key = (Asub.indices[s:e].tobytes(),
                       np.round(vals_r / pivot, 12).tobytes())
                groups.setdefault(key, []).append(rloc)
            merged = False
            for rlocs in groups.values():
                if len(rlocs) < 2:
                    continue
                kloc = rlocs[0]
                k = live_r[kloc]
                sk, ek = Asub.indptr[kloc], Asub.indptr[kloc + 1]
                vk = Asub.data[sk:ek]
                pk = vk[np.argmax(np.abs(vk))]
                lo0, hi0 = lcon[k], ucon[k]
                entries = []
                for rloc in rlocs[1:]:
                    i = live_r[rloc]
                    si, ei = Asub.indptr[rloc], Asub.indptr[rloc + 1]
                    vi = Asub.data[si:ei]
                    alpha = vi[np.argmax(np.abs(vi))] / pk
                    if np.max(np.abs(vi - alpha * vk)) > 1e-12 * np.max(
                            np.abs(vi)):
                        continue  # hash collision, not truly parallel
                    if alpha > 0:
                        lo_i, hi_i = lcon[i] / alpha, ucon[i] / alpha
                    else:
                        lo_i, hi_i = ucon[i] / alpha, lcon[i] / alpha
                    entries.append((i, float(alpha), lo_i, hi_i))
                if not entries:
                    continue
                lo_fin = max([lo0] + [t[2] for t in entries])
                hi_fin = min([hi0] + [t[3] for t in entries])
                if lo_fin > hi_fin + max(tol, tol * abs(hi_fin)):
                    return _fail(qp, PresolveStatus.INFEASIBLE)
                # ranges inverted within tolerance collapse to a point
                # (the singleton-row path clamps the same way)
                lo_fin = min(lo_fin, hi_fin)
                for i, alpha, lo_i, hi_i in entries:
                    ops.append(_MergeDupRow(i, k, alpha))
                    alive_row[i] = False
                lcon[k], ucon[k] = lo_fin, hi_fin
                merged = True
            if merged:
                changed = True
                live_r = np.where(alive_row)[0]
                Asub = sub(A_rows).tocsr()
                row_nnz = np.diff(Asub.indptr)

        # ---- singleton rows -----------------------------------------------
        singles = np.where(row_nnz == 1)[0]
        to_fix_cols: List[int] = []
        to_fix_vals: List[float] = []
        claimed: set = set()
        for rloc in singles:
            i = live_r[rloc]
            jloc = Asub.indices[Asub.indptr[rloc]]
            j = live_c[jloc]
            if j in claimed:
                continue  # another singleton row already fixed/tightened j this pass
            a = Asub.data[Asub.indptr[rloc]]
            if abs(a) < 1e-14:
                continue
            lo, hi = lcon[i] / a, ucon[i] / a
            if a < 0:
                lo, hi = hi, lo
            if lcon[i] == ucon[i]:  # equality: fix the variable
                v = lo
                if v < lvar[j] - max(tol, tol * abs(v)) or v > uvar[j] + max(tol, tol * abs(v)):
                    return _fail(qp, PresolveStatus.INFEASIBLE)
                ops.append(_DropEqSingletonRow(i, j, float(a)))
                alive_row[i] = False
                to_fix_cols.append(j)
                to_fix_vals.append(float(np.clip(v, lvar[j], uvar[j])))
                claimed.add(j)
            else:  # inequality: convert to bounds
                new_l = max(lvar[j], lo) if np.isfinite(lo) else lvar[j]
                new_u = min(uvar[j], hi) if np.isfinite(hi) else uvar[j]
                if new_l > new_u + tol:
                    return _fail(qp, PresolveStatus.INFEASIBLE)
                ops.append(_DropIneqSingletonRow(
                    i, j, float(a), float(lvar[j]), float(uvar[j]),
                    float(new_l), float(new_u)))
                lvar[j], uvar[j] = min(new_l, new_u), new_u
                alive_row[i] = False
                claimed.add(j)
            changed = True
        if to_fix_cols:
            eliminate_fixed(np.asarray(to_fix_cols, dtype=int),
                            np.asarray(to_fix_vals))
            live_c = np.where(alive_col)[0]

        # ---- fixed variables ----------------------------------------------
        fixed = alive_col & (uvar - lvar <= tol) & np.isfinite(lvar)
        if fixed.any():
            cols = np.where(fixed)[0]
            eliminate_fixed(cols, 0.5 * (lvar[cols] + uvar[cols]))
            changed = True
            live_c = np.where(alive_col)[0]

        # refresh column views after any row/col changes
        live_r = np.where(alive_row)[0]
        Acsc = sub(A).tocsc()
        col_nnz = np.diff(Acsc.indptr)

        # ---- free column singletons on equality rows (LP columns) ---------
        ff_rows: set = set()
        for jloc in np.where(col_nnz == 1)[0]:
            j = live_c[jloc]
            if h_col_nnz[j] != 0:
                continue
            if np.isfinite(lvar[j]) or np.isfinite(uvar[j]):
                continue
            rloc = Acsc.indices[Acsc.indptr[jloc]]
            i = live_r[rloc]
            if i in ff_rows:
                continue
            if lcon[i] != ucon[i] or not np.isfinite(lcon[i]):
                continue
            a = Acsc.data[Acsc.indptr[jloc]]
            if abs(a) < 1e-14:
                continue
            # row i's other alive entries
            ri = A_rows[i].tocoo()
            msk = alive_col[ri.col] & (ri.col != j)
            rc, rv = ri.col[msk], ri.data[msk]
            b = float(lcon[i])
            ops.append(_FreeColSingleton(i, j, float(a), b, float(c[j]),
                                         rc.copy(), rv.copy()))
            # objective substitution: c_k -= (c_j/a) A_ik, c0 += c_j b / a
            c0 += c[j] * b / a
            c[rc] -= (c[j] / a) * rv
            alive_col[j] = False
            alive_row[i] = False
            ff_rows.add(i)
            changed = True
        if ff_rows:
            live_r = np.where(alive_row)[0]
            live_c = np.where(alive_col)[0]
            Acsc = sub(A).tocsc()
            col_nnz = np.diff(Acsc.indptr)

        # ---- empty columns -------------------------------------------------
        empty_cols = np.zeros(n, dtype=bool)
        empty_cols[live_c] = col_nnz == 0
        ec_fix: List[int] = []
        ec_val: List[float] = []
        for j in np.where(empty_cols)[0]:
            if h_col_nnz[j] > 0 and not h_diag_only[j]:
                continue  # coupled through H: leave it to the solver
            hjj = H[j, j] if H is not None else 0.0
            if hjj > 0.0:
                v = float(np.clip(-c[j] / hjj, lvar[j], uvar[j]))
            elif c[j] > 0:
                v = lvar[j]
            elif c[j] < 0:
                v = uvar[j]
            else:
                v = float(np.clip(0.0, lvar[j], uvar[j]))
            if not np.isfinite(v):
                return _fail(qp, PresolveStatus.UNBOUNDED)
            ec_fix.append(j)
            ec_val.append(float(v))
        if ec_fix:
            eliminate_fixed(np.asarray(ec_fix, dtype=int), np.asarray(ec_val))
            changed = True

        # ---- parallel (duplicate / dominated) columns ----------------------
        # For LP-pure columns (no Hessian entries) with A[:,j] == alpha *
        # A[:,k], alpha != 0: shifting (x_j += d, x_k -= alpha d) keeps Ax
        # fixed and changes the objective by (c_j - alpha c_k) d, so
        #   c_j > alpha c_k  and x_k unbounded in the compensating
        #     direction  =>  x_j is DOMINATED: fix at lvar (or UNBOUNDED if
        #     lvar = -inf); mirrored for c_j < alpha c_k;
        #   c_j == alpha c_k (alpha > 0)  =>  DUPLICATE: merge into x_k
        #     with summed bounds (QuadraticModels-presolve parity).
        live_c = np.where(alive_col)[0]
        live_r = np.where(alive_row)[0]
        Acsc = sub(A).tocsc()
        Acsc.sort_indices()
        col_nnz = np.diff(Acsc.indptr)
        groups_c: dict = {}
        for jloc in np.where(col_nnz > 0)[0]:
            j = live_c[jloc]
            if h_col_nnz[j] != 0:
                continue
            s, e = Acsc.indptr[jloc], Acsc.indptr[jloc + 1]
            vals_c = Acsc.data[s:e]
            pivot = vals_c[np.argmax(np.abs(vals_c))]
            if abs(pivot) < 1e-14:
                continue
            key = (Acsc.indices[s:e].tobytes(),
                   np.round(vals_c / pivot, 12).tobytes())
            groups_c.setdefault(key, []).append(jloc)
        dom_fix_cols: List[int] = []
        dom_fix_vals: List[float] = []
        for jlocs in groups_c.values():
            if len(jlocs) < 2:
                continue
            kloc = jlocs[0]
            k = live_c[kloc]
            sk, ek = Acsc.indptr[kloc], Acsc.indptr[kloc + 1]
            vk = Acsc.data[sk:ek]
            pk = vk[np.argmax(np.abs(vk))]
            for jloc in jlocs[1:]:
                j = live_c[jloc]
                if not alive_col[k] or not alive_col[j]:
                    continue
                sj, ej = Acsc.indptr[jloc], Acsc.indptr[jloc + 1]
                vj = Acsc.data[sj:ej]
                alpha = vj[np.argmax(np.abs(vj))] / pk
                if np.max(np.abs(vj - alpha * vk)) > 1e-12 * np.max(np.abs(vj)):
                    continue  # hash collision
                dc_ = c[j] - alpha * c[k]
                ctol = tol * max(1.0, abs(c[j]), abs(alpha * c[k]))
                if abs(dc_) <= ctol and alpha > 0:
                    # duplicate: merge j into k with summed bounds
                    ops.append(_MergeDupCol(
                        j, k, float(alpha), float(lvar[j]), float(uvar[j]),
                        float(lvar[k]), float(uvar[k])))
                    lvar[k] = lvar[k] + alpha * lvar[j]
                    uvar[k] = uvar[k] + alpha * uvar[j]
                    alive_col[j] = False
                    changed = True
                elif dc_ > ctol and (
                        (alpha > 0 and not np.isfinite(uvar[k]))
                        or (alpha < 0 and not np.isfinite(lvar[k]))):
                    # decreasing x_j (compensated through x_k) always
                    # improves: x_j -> lvar[j]
                    if not np.isfinite(lvar[j]):
                        return _fail(qp, PresolveStatus.UNBOUNDED)
                    dom_fix_cols.append(j)
                    dom_fix_vals.append(float(lvar[j]))
                    alive_col[j] = False  # guard against re-matching below
                elif dc_ < -ctol and (
                        (alpha > 0 and not np.isfinite(lvar[k]))
                        or (alpha < 0 and not np.isfinite(uvar[k]))):
                    if not np.isfinite(uvar[j]):
                        return _fail(qp, PresolveStatus.UNBOUNDED)
                    dom_fix_cols.append(j)
                    dom_fix_vals.append(float(uvar[j]))
                    alive_col[j] = False
        if dom_fix_cols:
            cols_a = np.asarray(dom_fix_cols, dtype=int)
            alive_col[cols_a] = True  # eliminate_fixed flips it itself
            eliminate_fixed(cols_a, np.asarray(dom_fix_vals))
            changed = True

        if not changed:
            break

    keep_rows = np.where(alive_row)[0]
    keep_cols = np.where(alive_col)[0]
    fixed_cols = np.concatenate(
        [op.cols for op in ops if isinstance(op, _FixGroup)]
    ) if any(isinstance(op, _FixGroup) for op in ops) else np.array([], dtype=int)
    fixed_vals = np.concatenate(
        [op.vals for op in ops if isinstance(op, _FixGroup)]
    ) if fixed_cols.size else np.array([])

    info = PresolveInfo(
        PresolveStatus.REDUCED,
        keep_rows, keep_cols, fixed_cols, fixed_vals, n, m, ops, qp,
    )

    if len(keep_cols) == 0:
        info.status = PresolveStatus.SOLVED
        return qp, info, False
    if len(keep_rows) == m and len(keep_cols) == n and not ops:
        info.status = PresolveStatus.UNCHANGED
        return qp, info, True

    A_red = A_rows[keep_rows][:, keep_cols]
    H_red = None
    if qp.H is not None:
        H_red = qp.H.tocsr()[keep_cols][:, keep_cols]
        if H_red.nnz == 0:
            H_red = None

    reduced = QuadraticProblem(
        c=sign * c[keep_cols],
        A=A_red,
        H=H_red,
        c0=sign * c0,
        lcon=lcon[keep_rows],
        ucon=ucon[keep_rows],
        lvar=lvar[keep_cols],
        uvar=uvar[keep_cols],
        x0=np.clip(qp.x0[keep_cols], lvar[keep_cols], uvar[keep_cols]),
        y0=qp.y0[keep_rows],
        minimize=qp.minimize,
        name=qp.name,
    )
    return reduced, info, True
