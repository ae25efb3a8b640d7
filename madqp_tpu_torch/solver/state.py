"""Problem data and solver state (port of `madqp_tpu/solver/state.py`).

`ProblemArrays` and `IPMState` are NamedTuples.  Vectors and floating
scalars are tensors on the problem's device (scalars as 0-d tensors of the
working dtype).  The loop is stepped on the host, so the integer counters
(`k`, `n_fact`, `n_solve`, `stall_k`), the in-loop `status` code and the
`initialized` flag are plain Python ints and bools: every branch on them is
a host decision with no device sync.

A batch of problems (the batched solver, `parallel/batched.py`) uses the
same two types with a leading lane axis on every tensor: vectors (B, n),
matrices (B, m, n), scalars (B,).  There the counters and the status are
per-lane int64 tensors (B,), since lanes stop at different iterations;
`initialized` stays one host bool, because all lanes start together.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.qp import StandardQP
from ..ops.kernels import KKTVec, matvec

# In-loop status codes (mapped to utils.Status by the driver).
RUNNING = 0
SUCCESS = 1
MAX_ITER = 2
STEP_ERROR = 3
DIVERGED = 4
STALLED = 5  # stall_exit iterations without progress (mixed-precision floor)


class ProblemArrays(NamedTuple):
    """Device-resident problem data (dense path).

    The methods are the model-callback protocol consumed by MPCKernel and
    the KKT layer (reference SparseCallback analog): any problem
    representation exposing c0/c/b/has_lb/has_ub plus
    hess_mv/jac_mv/jac_rmv plugs into the same solver.
    """

    c0: torch.Tensor
    c: torch.Tensor
    H: Optional[torch.Tensor]
    A: torch.Tensor
    b: torch.Tensor
    has_lb: torch.Tensor
    has_ub: torch.Tensor

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def m(self) -> int:
        return self.b.shape[-1]

    @property
    def is_lp(self) -> bool:
        return self.H is None

    def hess_mv(self, x):
        """H @ x (zero for LPs)."""
        return torch.zeros_like(x) if self.H is None else matvec(self.H, x)

    def jac_mv(self, x):
        """A @ x."""
        return matvec(self.A, x)

    def jac_rmv(self, y):
        """A' @ y."""
        return matvec(self.A.mT, y)


class IPMState(NamedTuple):
    # Primal-dual iterate.
    x: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor   # masked full-length (0 off-mask)
    zu: torch.Tensor
    # Bounds (mutable: adjust_boundary / bound relaxation).
    lb: torch.Tensor
    ub: torch.Tensor
    # Current direction (for logging ||d|| and warm buffers).
    d: KKTVec
    # Barrier and regularization scalars (0-d tensors).
    mu: torch.Tensor
    del_w: torch.Tensor
    del_c: torch.Tensor
    reg_p: torch.Tensor    # AdaptiveRegularization's evolving deltas
    reg_d: torch.Tensor
    # Step sizes.
    alpha_p: torch.Tensor
    alpha_d: torch.Tensor
    # Residual norms / objective (for convergence + logging).
    obj_val: torch.Tensor
    inf_pr: torch.Tensor
    inf_du: torch.Tensor
    inf_compl: torch.Tensor
    d_norm: torch.Tensor
    norm_b: torch.Tensor
    norm_c: torch.Tensor
    # Host-side counters / status (per-lane int64 tensors in a batch).
    k: int        # iteration counter
    n_fact: int   # factorization count
    n_solve: int  # backsolve count
    status: int   # RUNNING while iterating
    # Stall detection (options.stall_exit): best max-infeasibility seen and
    # the count of consecutive iterations without meaningful improvement.
    best_worst: torch.Tensor
    stall_k: int
    # False until the Mehrotra starting point (reference src/solver.jl:6-125)
    # has been computed; the starting-point work runs inside the first
    # `iteration` call, as in the reference.
    initialized: bool


def problem_to_device(std: StandardQP, dtype: torch.dtype,
                      device="cuda") -> tuple[ProblemArrays, torch.Tensor, torch.Tensor]:
    """Move a StandardQP to tensors of `dtype` on `device` (the CUDA card
    unless the caller asks for the CPU).

    Returns (prob, lb, ub) — bounds separately since they are state.
    """
    def as_dev(v):
        # H comes from a CSC matrix as a column-major array: make every
        # matrix row-major (the K1 kernel takes contiguous matrices only).
        return torch.as_tensor(v, dtype=dtype, device=device).contiguous()

    prob = ProblemArrays(
        c0=as_dev(std.c0),
        c=as_dev(std.c),
        H=None if std.H is None else as_dev(std.H),
        A=as_dev(std.A),
        b=as_dev(std.b),
        has_lb=torch.as_tensor(std.has_lb, dtype=torch.bool, device=device),
        has_ub=torch.as_tensor(std.has_ub, dtype=torch.bool, device=device),
    )
    return prob, as_dev(std.lb), as_dev(std.ub)


def count_onesided(std: StandardQP) -> int:
    """Static count of bounded entries — gates the Mehrotra sigma branch
    (reference update_barrier!, src/kernels.jl:226-236: sigma = 1 without
    'inequalities').  We gate on *any* finite bound existing: with no bounds
    the complementarity measure is identically zero and sigma is irrelevant,
    while with only two-sided bounds the cube rule is still required for the
    barrier to decrease."""
    return int(std.has_lb.sum() + std.has_ub.sum())
