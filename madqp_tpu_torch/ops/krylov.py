"""Preconditioned conjugate gradients for the sparse krylov endgame (port of
`madqp_tpu/ops/krylov.py`).

The two-phase scheme's `endgame="krylov"` keeps the float32 factorization
as a PRECONDITIONER of float64 CG on the SPD reduced system (the normal
equations of `solver/sparse_lp.py`, the condensed system of
`solver/sparse_condensed.py`) instead of refactoring in float64: CG needs
the preconditioned spectrum clustered, not the contraction
|I - M^-1 K| < 1 that stationary refinement needs.  Reference hook: the
residual-check / refinement seam of src/linear_solver.jl:28-43.

The loop is stepped on the host: the stopping test (the reference's
`lax.while_loop` condition) is read once per CG iteration, one sync each
(`utils.profiling.to_host`, site `pcg`).
A fixed `maxit`-iteration loop that froze the converged state would give
the same result without syncs, but would run the preconditioner (a whole
supernodal backsolve, hundreds of launches) `maxit` times whatever the
convergence; CG converges here in a few iterations.
"""

from __future__ import annotations

import torch

from ..utils.profiling import to_host


def pcg(matvec, precond, b: torch.Tensor, tol_rel: float = 1e-12, maxit: int = 64):
    """Preconditioned conjugate gradients for SPD systems.

    Stops when ||r||_2 <= tol_rel * ||b||_2 or at maxit.  Returns (x, k),
    k the iterations taken (a Python int).  matvec / precond must be linear
    and SPD; b and all iterates are in b's dtype (float64 in the endgame)."""
    r0n = torch.dot(b, b)
    z = precond(b)
    x, r, p = torch.zeros_like(b), b, z
    rz = torch.dot(b, z)
    k = 0
    while k < maxit and to_host(torch.dot(r, r) > (tol_rel * tol_rel) * r0n, "pcg"):
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        alpha = rz / torch.where(pAp != 0.0, pAp, torch.ones_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz != 0.0, rz, torch.ones_like(rz))
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k
