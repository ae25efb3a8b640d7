"""Dense condensed / normal KKT systems (port of `madqp_tpu/ops/kkt.py`).

Protocol (functional equivalent of MadNLP's AbstractKKTSystem as implemented
by the reference at src/KKT/normalkkt.jl:128-219):

  * `factorize(prob, pr_diag, del_c) -> factors`  — per-iteration numeric
    factorization (the reference's build_kkt! + factorize_wrapper!).
  * `solve(factors, rx, ry) -> (dx, dy)`          — solve the *reduced* 2x2
    system [W A'; A dc I] [dx; dy] = [rx; ry], W = H + diag(pr_diag).
  * `factor_ok(factors) -> bool 0-d tensor`       — success probe, the
    equivalent of `is_factorized` (src/utils.jl:54-62); feeds the
    retry-with-100x-regularization loop (src/linear_solver.jl:6-17).

Bound-dual elimination/recovery around this reduced system is formulation-
independent and lives in ops.kernels (reduce_rhs / recover_bound_duals).

All formulations produce the same Newton step in exact arithmetic; they
differ in conditioning and cost:

  * CONDENSED — block elimination: Cholesky of W (SPD: H PSD + pr_diag > 0),
    then Cholesky of the SPD Schur complement S = A W^-1 A' - dc I.
    `chol_backend="blocked"` factors both through
    `blocked_dense.factor_inv_chol` (the two-level panel Cholesky with K8
    trailing updates from order 1024 up) and keeps the inverse Cholesky
    factors, so each solve is two matvecs; `solve_mode="inverse"` keeps
    explicit inverses of the scaled blocks.
  * NORMAL    — LP specialization (W diagonal): S = A D A' - dc I with
    D = 1/pr_diag.  Rejects QPs like the reference (normalkkt.jl:45-48).
  * K2        — full (n+m) symmetric-indefinite augmented matrix, dense LU
    (`torch.linalg.lu_factor_ex`), or with `chol_backend="blocked"` the
    signed no-pivot `blocked_ldl` and its inverse unit factor.
  * K2_5      — K2 with symmetric Jacobi scaling.
  * SCHUR     — the two-stage block-angular system
    (`parallel/structured.py::SchurKKT`, with `TwoStageProblem` only).
The sparse device formulations are not classes of this registry:
`MPCSolver(kkt_system="sparse-normal")` runs the normal equations of
`solver/sparse_lp.py` (dense-normal or supernodal) and `"sparse-augmented"`
the augmented K2 system of `solver/sparse_qp.py` on the signed supernodal
LDLᵀ; `make_kkt` lists them among the valid names.

A batch of problems (leading lane axis on every tensor: `prob.A` (B, m, n),
`pr_diag` (B, n), `del_c` (B,)) factors through every dense system and
backend, one factor per lane and a per-lane `factor_ok`, as `jax.vmap` of
the JAX package's does: a blocked factor of order >= 1024 takes the lane
path of `ops/blocked_dense.py` (the panel forms, K8 once for all lanes),
which `jax.vmap` reaches because it sees one 2-D lane.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .blocked_dense import blocked_ldl, factor_inv_chol, inv_unit_lower
from .kernels import KKTVec, matvec, per_lane, slacks
from .pallas_chol import select_cholesky

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(name) -> torch.dtype:
    """torch dtype from an options string ("float32"/"float64") or dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; use 'float32' or 'float64'")


# ---------------------------------------------------------------------------
# Condensed / normal-equations formulation
# ---------------------------------------------------------------------------


class CondensedFactors(NamedTuple):
    # (a batch has a leading lane axis on each)
    chol_W: Optional[torch.Tensor]   # (n, n) lower Cholesky of scaled W; None for LP
    w_scale: Optional[torch.Tensor]  # (n,) Jacobi scale of W (None for LP)
    w_diag: torch.Tensor             # (n,) pr_diag (used directly when LP)
    chol_S: torch.Tensor             # (m, m) lower Cholesky of scaled Schur compl.
    s_scale: torch.Tensor            # (m,) Jacobi scale of S
    A: torch.Tensor                  # (m, n) kept for the solve
    W_inv: Optional[torch.Tensor] = None  # explicit scaled inverses (solve_mode
    S_inv: Optional[torch.Tensor] = None  # 'inverse': backsolves become matvecs)
    W_iL: Optional[torch.Tensor] = None   # blocked path: inverse CHOLESKY factors
    S_iL: Optional[torch.Tensor] = None   # (M^-1 r = D iL' iL D r, two matvecs;
    #                                       iL'iL itself is never formed)


class DenseCondensedKKT:
    """Block-elimination (condensed) dense KKT.

    Covers both the QP condensed form and the LP normal equations
    (reference NormalKKTSystem build_kkt!/solve!, normalkkt.jl:166-205):
    with H = None, W is the diagonal pr_diag and S = A D A' - dc I.

    Mixed precision (`fact_dtype` float32): both SPD blocks are symmetrically
    Jacobi-scaled to unit diagonal in the working dtype, cast to fact_dtype
    and factorized there; solves cast the right-hand side to the factor's
    dtype and back.  Callers recover full accuracy by iterative refinement
    on the unreduced system.
    """

    name = "condensed"

    def __init__(self, fact_dtype=None, chol_backend: str = "xla",
                 solve_mode: str = "chol"):
        self.fact_dtype = torch_dtype(fact_dtype) if fact_dtype else None
        self.solve_mode = solve_mode
        self.blocked = chol_backend == "blocked"
        self._chol = select_cholesky("pallas" if chol_backend == "pallas"
                                     else "xla")

    def _scaled(self, M):
        """Jacobi-scale M to unit diagonal and cast it to fact_dtype.
        Returns (Ms, scale)."""
        d = torch.diagonal(M, dim1=-2, dim2=-1)
        scale = 1.0 / torch.sqrt(torch.clamp(d.abs(), min=1e-300))
        Ms = scale[..., :, None] * M * scale[..., None, :]
        if self.fact_dtype is not None and Ms.dtype != self.fact_dtype:
            Ms = Ms.to(self.fact_dtype)
        return Ms, scale

    def _blocked_inv(self, M):
        """GEMM-rich factor + INVERSE CHOLESKY FACTOR (ops/blocked_dense):
        the explicit inverse factor iL = L_chol^-1 turns every later
        backsolve into two matvecs (M^-1 r = D iL' iL D r); the full
        inverse iL'iL is never formed.  A non-SPD input leaves NaN or a
        non-positive value on the factor's diagonal, which factor_ok reads.
        Returns (chol_like_factor_for_factor_ok, iL, scale)."""
        Ms, scale = self._scaled(M)
        Lc, iL = factor_inv_chol(Ms, lanes=True)
        return Lc, iL, scale

    @staticmethod
    def _iL_apply(iL, scale, r, out_dtype):
        """M^-1 r = D (iL' (iL (D r))) with D = diag(scale); works for a
        vector or a matrix r (columns are independent solves), each with a
        leading lane axis in a batch."""
        if r.dim() > scale.dim():   # columns
            rs = (scale[..., :, None] * r).to(iL.dtype)
            return scale[..., :, None] * (iL.mT @ (iL @ rs)).to(out_dtype)
        rs = (scale * r).to(iL.dtype)
        return scale * matvec(iL.mT, matvec(iL, rs)).to(out_dtype)

    def _factorize_blocked(self, prob, pr_diag, del_c):
        H, A = prob.H, prob.A
        m = A.shape[-2]
        if H is None:
            chol_W, W_iL, w_scale = None, None, None
            Winv_AT = A.mT / pr_diag[..., :, None]
        else:
            chol_W, W_iL, w_scale = self._blocked_inv(H + torch.diag_embed(pr_diag))
            Winv_AT = self._iL_apply(W_iL, w_scale, A.mT, A.dtype)
        S = A @ Winv_AT - del_c[..., None, None] * torch.eye(m, dtype=A.dtype,
                                                              device=A.device)
        chol_S, S_iL, s_scale = self._blocked_inv(S)
        return CondensedFactors(
            chol_W=chol_W, w_scale=w_scale, w_diag=pr_diag,
            chol_S=chol_S, s_scale=s_scale, A=A,
            W_iL=W_iL, S_iL=S_iL,
        )

    @staticmethod
    def _explicit_inverse(chol, scale):
        """Unscaled explicit inverse through the scaled factorization:
        M^-1 = D Ms^-1 D with D = diag(scale).  The triangular solves
        against the identity run once per factorization; every backsolve
        after them is one matvec."""
        eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
        Ms_inv = torch.cholesky_solve(eye.expand(chol.shape), chol)
        return (scale[..., :, None] * Ms_inv.to(scale.dtype)) * scale[..., None, :]

    def _chol_scaled(self, M):
        """Jacobi-scale M to unit diagonal, factorize (optionally in
        fact_dtype).  Returns (chol, scale)."""
        Ms, scale = self._scaled(M)
        return self._chol(Ms), scale

    @staticmethod
    def _cho_solve(chol, rhs):
        """L L' x = rhs for a vector or a matrix of columns (each with a
        leading lane axis in a batch)."""
        if rhs.dim() < chol.dim():
            return torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        return torch.cholesky_solve(rhs, chol)

    def _chol_apply(self, chol, scale, r, out_dtype):
        """Solve M x = r through the scaled factorization."""
        rs = (scale * r).to(chol.dtype)
        xs = self._cho_solve(chol, rs)
        return scale * xs.to(out_dtype)

    def factorize(self, prob, pr_diag, del_c):
        if self.blocked:
            return self._factorize_blocked(prob, pr_diag, del_c)
        H, A = prob.H, prob.A
        m = A.shape[-2]
        if H is None:
            chol_W, w_scale = None, None
            Winv_AT = A.mT / pr_diag[..., :, None]  # (n, m)
        else:
            W = H + torch.diag_embed(pr_diag)
            chol_W, w_scale = self._chol_scaled(W)
            rhs = (w_scale[..., :, None] * A.mT).to(chol_W.dtype)
            Winv_AT = w_scale[..., :, None] * self._cho_solve(chol_W, rhs).to(A.dtype)
        S = A @ Winv_AT
        S = S - del_c[..., None, None] * torch.eye(m, dtype=A.dtype, device=A.device)
        chol_S, s_scale = self._chol_scaled(S)
        W_inv = S_inv = None
        if self.solve_mode == "inverse":
            if chol_W is not None:
                W_inv = self._explicit_inverse(chol_W, w_scale)
            if m > 0:
                S_inv = self._explicit_inverse(chol_S, s_scale)
        return CondensedFactors(
            chol_W=chol_W, w_scale=w_scale, w_diag=pr_diag,
            chol_S=chol_S, s_scale=s_scale, A=A,
            W_inv=W_inv, S_inv=S_inv,
        )

    def _W_solve(self, f: CondensedFactors, r):
        if f.chol_W is None:
            return r / f.w_diag
        if f.W_iL is not None:
            return self._iL_apply(f.W_iL, f.w_scale, r, r.dtype)
        if f.W_inv is not None:
            return matvec(f.W_inv, r)
        return self._chol_apply(f.chol_W, f.w_scale, r, r.dtype)

    def _S_solve(self, f: CondensedFactors, r):
        if f.S_iL is not None:
            return self._iL_apply(f.S_iL, f.s_scale, r, r.dtype)
        if f.S_inv is not None:
            return matvec(f.S_inv, r)
        return self._chol_apply(f.chol_S, f.s_scale, r, r.dtype)

    def solve(self, f: CondensedFactors, rx, ry):
        m = f.A.shape[-2]
        if m == 0:
            return self._W_solve(f, rx), ry
        # (A W^-1 A' - dc I) dy = A W^-1 rx - ry
        rhs_y = matvec(f.A, self._W_solve(f, rx)) - ry
        dy = self._S_solve(f, rhs_y)
        dx = self._W_solve(f, rx - matvec(f.A.mT, dy))
        return dx, dy

    def factor_ok(self, f: CondensedFactors) -> torch.Tensor:
        """All factor diagonals finite and positive: a 0-d bool tensor, or
        one per lane (B,) for a batch."""
        def diag_ok(L):
            d = torch.diagonal(L, dim1=-2, dim2=-1)
            return (torch.isfinite(d) & (d > 0)).all(-1)

        ok = diag_ok(f.chol_S)  # all() of an empty diagonal is True
        if f.chol_W is not None:
            return ok & diag_ok(f.chol_W)
        return ok & (f.w_diag > 0).all(-1)


class DenseNormalKKT(DenseCondensedKKT):
    """Normal-equations KKT, LP only (reference NormalKKTSystem).

    Inertia correctness = SPD Schur complement (normalkkt.jl:132-134), which
    is exactly `factor_ok`.
    """

    name = "normal"

    def factorize(self, prob, pr_diag, del_c):
        if prob.H is not None:
            raise ValueError(
                "NormalKKT supports only linear programs "
                "(reference normalkkt.jl:45-48): Hessian must be empty."
            )
        return super().factorize(prob, pr_diag, del_c)


# ---------------------------------------------------------------------------
# K2 augmented formulation (dense LU or signed blocked LDL^T)
# ---------------------------------------------------------------------------


class K2Factors(NamedTuple):
    lu: torch.Tensor
    piv: torch.Tensor


class K2BlockedFactors(NamedTuple):
    # (a batch has a leading lane axis on each)
    iLu: torch.Tensor    # inverse UNIT-LDL factor: K^-1 r = S iLu' D^-1 iLu S r
    d: torch.Tensor      # LDL pivots (inertia check + the D^-1 in solves)
    sgn: torch.Tensor    # expected pivot signs (+1 x n, -1 x m)
    scale: Optional[torch.Tensor] = None  # K2.5 Jacobi scale S (None = unscaled)


class K25Factors(NamedTuple):
    lu: torch.Tensor
    piv: torch.Tensor
    scale: torch.Tensor


class DenseK2KKT:
    """Full augmented symmetric-indefinite system [W A'; A dc I].

    MadNLP SparseKKTSystem analog (the reference default, src/utils.jl:108).
    Backends: dense LU (default) or, with chol_backend='blocked', the
    GEMM-rich signed LDL^T (no pivoting: the IPM's regularization keeps the
    matrix quasi-definite) with the inverse unit factor, so backsolves are
    matvecs.  `solve_mode` has no effect here (as in the JAX package).
    A batch (leading lane axis) factors every lane in one batched LU, or in
    `blocked_ldl`'s lane path with signs per lane.
    """

    name = "k2"

    def __init__(self, fact_dtype=None, chol_backend: str = "xla",
                 solve_mode: str = "chol"):
        self.fact_dtype = torch_dtype(fact_dtype) if fact_dtype else None
        self.blocked = chol_backend == "blocked"

    def _to_fact(self, K):
        if self.fact_dtype is not None and K.dtype != self.fact_dtype:
            return K.to(self.fact_dtype)
        return K

    def _factorize_blocked(self, K, m, scale=None):
        nm = K.shape[-1]
        Kf = self._to_fact(K)
        sgn = torch.cat([
            torch.ones(nm - m, dtype=Kf.dtype, device=Kf.device),
            -torch.ones(m, dtype=Kf.dtype, device=Kf.device)]).expand(Kf.shape[:-1])
        # Static pivot floor in float32 (refinement absorbs it); meaningful
        # only on a ~unit-diagonal matrix, i.e. under K2.5.
        floor = 1e-6 if (self.fact_dtype == torch.float32
                         and scale is not None) else 0.0
        Lu, d = blocked_ldl(Kf, sgn=sgn, floor=floor, lanes=True)
        # Keep the inverse unit factor, not the full K^-1: solves are two
        # matvecs and a diagonal scale.
        return K2BlockedFactors(iLu=inv_unit_lower(Lu, lanes=True), d=d, sgn=sgn,
                                scale=scale)

    @staticmethod
    def _assemble(H, A, pr_diag, del_c):
        """[W A'; A dc I] of one problem, or of each lane of a batch."""
        m = A.shape[-2]
        W = torch.diag_embed(pr_diag) if H is None else H + torch.diag_embed(pr_diag)
        C = del_c[..., None, None] * torch.eye(m, dtype=pr_diag.dtype,
                                               device=pr_diag.device)
        return torch.cat([torch.cat([W, A.mT], dim=-1),
                          torch.cat([A, C], dim=-1)], dim=-2)

    @staticmethod
    def _lu(K):
        """LU with partial pivoting; an exactly singular matrix leaves a
        zero on U's diagonal (read by factor_ok) rather than raising."""
        lu, piv, _ = torch.linalg.lu_factor_ex(K)
        return lu, piv

    def factorize(self, prob, pr_diag, del_c):
        K = self._assemble(prob.H, prob.A, pr_diag, del_c)
        if self.blocked:
            return self._factorize_blocked(K, prob.A.shape[-2])
        lu, piv = self._lu(self._to_fact(K))
        return K2Factors(lu=lu, piv=piv)

    @staticmethod
    def _lu_solve(f, rhs):
        return torch.linalg.lu_solve(f.lu, f.piv, rhs.to(f.lu.dtype)[..., None])[..., 0]

    def solve(self, f, rx, ry):
        n = rx.shape[-1]
        rhs = torch.cat([rx, ry], dim=-1)
        if isinstance(f, K2BlockedFactors):
            rs = rhs * f.scale if f.scale is not None else rhs
            y = matvec(f.iLu, rs.to(f.iLu.dtype))
            y = matvec(f.iLu.mT, y / f.d)
            d = y.to(rx.dtype)
            if f.scale is not None:
                d = d * f.scale
            return d[..., :n], d[..., n:]
        d = self._lu_solve(f, rhs).to(rx.dtype)
        return d[..., :n], d[..., n:]

    def factor_ok(self, f):
        """A 0-d bool tensor, or one per lane (B,) for a batch."""
        if isinstance(f, K2BlockedFactors):
            # pivot-sign inertia check (quasi-definite: +1 x n, -1 x m)
            return torch.isfinite(f.d).all(-1) & (f.d * f.sgn > 0.0).all(-1)
        dU = torch.diagonal(f.lu, dim1=-2, dim2=-1)
        return torch.isfinite(dU).all(-1) & (dU.abs() > 0.0).all(-1)


class DenseK25KKT(DenseK2KKT):
    """K2.5: augmented system with symmetric Jacobi (sqrt-diagonal) scaling.

    MadNLP ScaledSparseKKTSystem analog: K -> D K D with
    D = 1/sqrt(max(|diag K|, 1e-8)), and the solution unscaled.
    """

    name = "k2.5"

    def factorize(self, prob, pr_diag, del_c):
        K = self._assemble(prob.H, prob.A, pr_diag, del_c)
        dK = torch.diagonal(K, dim1=-2, dim2=-1).abs()
        scale = 1.0 / torch.sqrt(torch.clamp(dK, min=1e-8))
        Ks = scale[..., :, None] * K * scale[..., None, :]
        if self.blocked:
            return self._factorize_blocked(Ks, prob.A.shape[-2], scale=scale)
        lu, piv = self._lu(self._to_fact(Ks))
        return K25Factors(lu=lu, piv=piv, scale=scale)

    def solve(self, f, rx, ry):
        if isinstance(f, K2BlockedFactors):
            return DenseK2KKT.solve(self, f, rx, ry)
        n = rx.shape[-1]
        d = self._lu_solve(f, torch.cat([rx, ry], dim=-1) * f.scale)
        d = d.to(rx.dtype) * f.scale
        return d[..., :n], d[..., n:]


# ---------------------------------------------------------------------------
# Unreduced KKT operator (for residual checks; MadNLP mul! analog)
# ---------------------------------------------------------------------------


def kkt_mul(prob, del_w, del_c, x, lb, ub, has_lb, has_ub, zl, zu, v):
    """w = K v for the *unreduced* KKT operator (reference normalkkt.jl:207-219
    plus MadNLP._kktmul!), using this module's sign conventions:

        wx  = (H + dw I) vx + A' vy - vzl + vzu
        wy  = A vx + dc vy
        wzl = zl.vx + sl.vzl          (masked; 0 off-mask)
        wzu = -zu.vx + su.vzu         (masked)

    `prob` is any problem object exposing hess_mv/jac_mv/jac_rmv; on a
    batch del_w and del_c are per lane (B,).
    """
    sl, su = slacks(x, lb, ub, has_lb, has_ub)
    wx = (per_lane(del_w) * v.x + prob.jac_rmv(v.y) - v.zl + v.zu
          + prob.hess_mv(v.x))
    wy = prob.jac_mv(v.x) + per_lane(del_c) * v.y
    wzl = torch.where(has_lb, zl * v.x + sl * v.zl, 0.0)
    wzu = torch.where(has_ub, -zu * v.x + su * v.zu, 0.0)
    return KKTVec(x=wx, y=wy, zl=wzl, zu=wzu)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_KKT_REGISTRY = {
    "condensed": DenseCondensedKKT,
    "normal": DenseNormalKKT,
    "k2": DenseK2KKT,
    "k2.5": DenseK25KKT,
}

def make_kkt(name: str, fact_dtype=None, chol_backend: str = "xla",
             solve_mode: str = "chol"):
    if name == "schur":
        # Imported here: parallel.structured imports this module.  Unlike
        # the reference, which drops it, the backend reaches SchurKKT.
        from ..parallel.structured import SchurKKT

        return SchurKKT(fact_dtype=fact_dtype, chol_backend=chol_backend)
    try:
        cls = _KKT_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kkt_system '{name}'; options: "
            f"{sorted(_KKT_REGISTRY) + ['schur', 'sparse-normal', 'sparse-augmented']}"
        )
    return cls(fact_dtype=fact_dtype, chol_backend=chol_backend,
               solve_mode=solve_mode)
