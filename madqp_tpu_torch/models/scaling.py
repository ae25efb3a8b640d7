"""Ruiz equilibration scaling.

Pure-NumPy replacement of the reference's HSL mc77-based `scale_qp`
(scripts/common.jl:38-100): iterative sqrt row/col inf-norm equilibration
with no license wall (SURVEY §2.4).  The scaled model follows the reference
convention exactly:

    As = Dr^-1 A Dc^-1,  Hs = Dc^-1 H Dc^-1,  cs = c / Dc,
    lvar*Dc, uvar*Dc, lcon/Dr, ucon/Dr, x0*Dc, y0/Dr.

`unscale_stats` maps a solution of the scaled problem back to user space.

Carried over unchanged from `madqp_tpu/models/scaling.py` (NumPy and SciPy only), so both
packages give bit-identical results.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .qp import QuadraticProblem


@dataclasses.dataclass
class RuizScaling:
    Dr: np.ndarray  # (m,) row scalings
    Dc: np.ndarray  # (n,) column scalings


def ruiz_scaling_factors(
    A: sp.spmatrix, max_iter: int = 20, tol: float = 1e-4
) -> RuizScaling:
    """Iterative Ruiz equilibration: after convergence the scaled matrix
    Dr^-1 A Dc^-1 has rows and columns with inf-norm ~ 1."""
    m, n = A.shape
    Dr = np.ones(m)
    Dc = np.ones(n)
    if A.nnz == 0:
        return RuizScaling(Dr, Dc)
    B = A.tocsr(copy=True).astype(np.float64)
    for _ in range(max_iter):
        Babs = abs(B)
        r = np.sqrt(Babs.max(axis=1).toarray().ravel())
        c = np.sqrt(Babs.max(axis=0).toarray().ravel())
        r[r == 0] = 1.0
        c[c == 0] = 1.0
        if max(np.abs(1.0 - r * r).max(), np.abs(1.0 - c * c).max()) < tol:
            break
        B = sp.diags(1.0 / r) @ B @ sp.diags(1.0 / c)
        Dr *= r
        Dc *= c
    return RuizScaling(Dr, Dc)


def scale_qp(
    qp: QuadraticProblem, max_iter: int = 20, tol: float = 1e-4
) -> tuple[QuadraticProblem, RuizScaling]:
    """Ruiz-equilibrate a QP (reference scale_qp semantics)."""
    s = ruiz_scaling_factors(qp.A, max_iter=max_iter, tol=tol)
    Dr, Dc = s.Dr, s.Dc
    m, n = qp.A.shape

    A_s = sp.diags(1.0 / Dr) @ qp.A @ sp.diags(1.0 / Dc)
    H_s = None
    if qp.H is not None:
        H_s = sp.diags(1.0 / Dc) @ qp.H @ sp.diags(1.0 / Dc)

    scaled = QuadraticProblem(
        c=qp.c / Dc,
        A=A_s.tocsr(),
        H=None if H_s is None else H_s.tocsr(),
        c0=qp.c0,
        lcon=qp.lcon / Dr,
        ucon=qp.ucon / Dr,
        lvar=qp.lvar * Dc,
        uvar=qp.uvar * Dc,
        x0=qp.x0 * Dc,
        y0=qp.y0 / Dr,
        minimize=qp.minimize,
        name=qp.name,
    )
    return scaled, s


def unscale_solution(s: RuizScaling, x_scaled: np.ndarray) -> np.ndarray:
    """x = x_s / Dc (the scaled variable is x_s = Dc x)."""
    return x_scaled / s.Dc


def unscale_multipliers(s: RuizScaling, y_scaled: np.ndarray) -> np.ndarray:
    """Constraint rows were scaled by Dr^-1, so y = y_s / Dr."""
    return y_scaled / s.Dr


def unscale_stats(s: RuizScaling, stats):
    """Rewrite an ExecutionStats of the scaled problem into user space.

    The objective is invariant under Ruiz scaling; solution and multipliers
    transform by Dc / Dr."""
    stats.solution = unscale_solution(s, stats.solution)
    stats.multipliers = unscale_multipliers(s, stats.multipliers)
    stats.multipliers_L = stats.multipliers_L * s.Dc
    stats.multipliers_U = stats.multipliers_U * s.Dc
    stats.constraints = stats.constraints * s.Dr
    return stats
