"""K1: the blocked Cholesky kernel, its plain PyTorch version, and the
factor selection used by the KKT layer.

Port of `madqp_tpu/ops/pallas_chol.py`.  The TPU kernel
(`pallas_cholesky`) keeps the whole padded matrix in VMEM; on Hopper the
matrix stays in device memory and the right-looking blocked algorithm runs
over 64-column blocks in one persistent cooperative launch (see
`csrc/cholesky.cu` for the design and what bounds it).

* `cholesky_lower(A)` is the wrapper.  A CUDA tensor always launches the
  hand-written kernel or raises; a CPU tensor goes to the plain version.
  `cholesky_lower.launches` counts the kernel's factorizations.
* `cholesky_lower_reference(A)` is the plain version: the same blocking,
  the same per-column sweep of the diagonal block (which also inverts it)
  and the same panel solve by the inverse, in PyTorch ops, on any device.
* `select_cholesky(backend)` returns the factor function the KKT layer
  uses: `"pallas"` -> `cholesky_lower`; anything else -> `dense_cholesky`
  (the library factorization with the same NaN contract).

Contract shared by all three: the result is the lower factor with a zero
strict upper triangle, and a matrix that is not SPD gives NaN or a
non-positive value on the diagonal (never an exception), which is what the
solver's `factor_ok` test and its retry loop read.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _build

BLOCK = 64  # block-column width; must equal NB in csrc/cholesky.cu

SOURCE = _build.CSRC_DIR / "cholesky.cu"
# (A, L, Dinv, n, stream) -> cudaError_t; Dinv is BLOCK x BLOCK scratch
_SIGNATURE = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p], ctypes.c_int)
_SIGNATURES = {
    "madqp_cholesky_lower_f32": _SIGNATURE,
    "madqp_cholesky_lower_f64": _SIGNATURE,
    "madqp_cholesky_block_size": ([], ctypes.c_int),
}


def _check_matrix(A: torch.Tensor) -> int:
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"cholesky_lower needs a square matrix, got {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cholesky_lower supports float32/float64, got {A.dtype}")
    return A.shape[0]


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _factor_diag(D: torch.Tensor) -> torch.Tensor:
    """Factor the (jb, jb) diagonal block D in place by the column sweep
    (sqrt pivot, scale the column, rank-1 update of the later columns) and
    apply the same sweep to the identity: returns D's lower factor's
    inverse, zero above the diagonal."""
    jb = D.shape[0]
    X = torch.eye(jb, dtype=D.dtype, device=D.device)
    for k in range(jb):
        D[k, k] = torch.sqrt(D[k, k])
        D[k + 1:, k] /= D[k, k]
        X[k, :k + 1] /= D[k, k]
        col = D[k + 1:, k]
        D[k + 1:, k + 1:] -= torch.tril(torch.outer(col, col))
        X[k + 1:, :k + 1] -= torch.outer(col, X[k, :k + 1])
    return X


def cholesky_lower_reference(A: torch.Tensor) -> torch.Tensor:
    """Right-looking blocked Cholesky in plain PyTorch ops.

    For each BLOCK-column block: the column sweep of the diagonal block,
    which also yields its inverse L_D^-1; the panel solve as the product
    X = P L_D^-T; and the trailing update C -= X X^T on the lower
    triangle.  No early exit: a negative pivot's NaN propagates to the
    rest of the factor, as in the TPU kernel and the CUDA kernel."""
    n = _check_matrix(A)
    L = torch.tril(A)
    for j0 in range(0, n, BLOCK):
        j1 = min(j0 + BLOCK, n)
        Dinv = _factor_diag(L[j0:j1, j0:j1])
        if j1 == n:
            break
        X = L[j1:, j0:j1]
        X.copy_(X @ Dinv.T)
        L[j1:, j1:] -= torch.tril(X @ X.T)
    return L


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def build_library() -> Path:
    """Compile csrc/cholesky.cu into the build directory (skipped when the
    library for this source already exists); see `_build`."""
    return _build.build(SOURCE)


def _check_block(lib) -> None:
    if lib.madqp_cholesky_block_size() != BLOCK:
        raise RuntimeError("csrc/cholesky.cu NB differs from BLOCK")


def _library():
    return _build.load(SOURCE, _SIGNATURES, check=_check_block)


def cholesky_lower(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD `A` (see the module contract).

    CUDA tensor: launches the hand-written kernel on the current stream
    (raises if it cannot be built or launched).  CPU tensor: the plain
    version.  Any other device raises."""
    n = _check_matrix(A)
    if A.device.type == "cpu":
        return cholesky_lower_reference(A)
    if A.device.type != "cuda":
        raise ValueError(f"cholesky_lower: unsupported device {A.device}")
    if not A.is_contiguous():
        raise ValueError("cholesky_lower needs a contiguous matrix")
    lib = _library()
    fn = (lib.madqp_cholesky_lower_f32 if A.dtype == torch.float32
          else lib.madqp_cholesky_lower_f64)
    out = torch.empty_like(A)
    scratch = torch.empty((BLOCK, BLOCK), dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"K1 Cholesky kernel launch failed: CUDA error {err}")
    cholesky_lower.launches += 1
    return out


cholesky_lower.launches = 0


# ---------------------------------------------------------------------------
# Factor selection
# ---------------------------------------------------------------------------


def dense_cholesky(M: torch.Tensor) -> torch.Tensor:
    """Library Cholesky (`linear_solver="dense"`) with the K1 contract.

    `torch.linalg.cholesky` raises on a matrix that is not SPD and
    `cholesky_ex` leaves a partial factor without a NaN, so the failure
    reported in `info` is written into the diagonal as NaN (no host sync)."""
    L, info = torch.linalg.cholesky_ex(M)
    L.diagonal().masked_fill_(info > 0, float("nan"))
    return L


def select_cholesky(backend: str):
    """Cholesky implementation by backend name: 'pallas' is the K1 kernel,
    anything else the library factorization."""
    return cholesky_lower if backend == "pallas" else dense_cholesky
