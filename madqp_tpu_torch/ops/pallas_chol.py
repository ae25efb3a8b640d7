"""K1: the blocked Cholesky kernel, its plain PyTorch version, and the
factor selection used by the KKT layer.

Port of `madqp_tpu/ops/pallas_chol.py`.  The TPU kernel
(`pallas_cholesky`) keeps the whole padded matrix in VMEM, one program
per matrix (under `jax.vmap` one per matrix of the batch).  On Hopper:

* one matrix: the matrix stays in device memory and the right-looking
  blocked algorithm runs over 64-column blocks in one persistent
  cooperative launch (`csrc/cholesky.cu`);
* a stack (B, n, n): one launch, whatever n (`batched_route`): for
  n <= 32 each matrix in the registers of a group of 8, 16 or 32 lanes;
  for 32 < n <= 64 one warp per matrix, and above that one CTA per
  matrix, the matrix in shared memory and factored in 32-column blocks
  (`csrc/cholesky_batched.cu`), up to the largest n whose square fits a
  CTA's shared memory (`batched_max_n`, read from the device); above it
  the persistent kernel of one matrix, whose lane axis takes all lanes
  in one cooperative launch (`csrc/cholesky.cu`).

* `cholesky_lower(A)` is the wrapper, for (n, n) or (B, n, n).  A CUDA
  tensor always launches a hand-written kernel or raises; a CPU tensor
  goes to the plain version.  `cholesky_lower.launches` counts every
  kernel launch (one per call), and `cholesky_lower.routes` counts them
  by route (`"single"` or a `batched_route` name).
* `cholesky_lower_reference(A)` is the plain version: the same blocking,
  the same per-column sweep of the diagonal block (which also inverts it)
  and the same panel solve by the inverse, in PyTorch ops, on any device,
  for one matrix or a stack.  The kernels for small stacks compute the
  same function in another rounding order (32-column blocks, the panel
  by substitution), which the tests' tolerances absorb.
* `select_cholesky(backend)` returns the factor function the KKT layer
  uses: `"pallas"` -> `cholesky_lower`; anything else -> `dense_cholesky`
  (the library factorization with the same NaN contract).

Contract shared by all three: the result is the lower factor with a zero
strict upper triangle, and a matrix that is not SPD gives NaN or a
non-positive value on its diagonal (never an exception), which is what the
solver's `factor_ok` test and its retry loop read.  In a stack that holds
for each matrix alone: no other matrix is touched.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

BLOCK = 64  # block-column width; must equal NB in csrc/cholesky.cu

SOURCE = _build.CSRC_DIR / "cholesky.cu"
SOURCE_BATCHED = _build.CSRC_DIR / "cholesky_batched.cu"
# (A, L, Dinv, batch, n, stream) -> cudaError_t; Dinv is (batch, BLOCK, BLOCK)
_SIGNATURE = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
_SIGNATURES = {
    "madqp_cholesky_lower_f32": _SIGNATURE,
    "madqp_cholesky_lower_f64": _SIGNATURE,
    "madqp_cholesky_block_size": ([], ctypes.c_int),
}
# (A, L, batch, n, tier, stream) -> cudaError_t
_BATCHED_SIGNATURE = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
_BATCHED_SIGNATURES = {
    "madqp_cholesky_lower_batched_f32": _BATCHED_SIGNATURE,
    "madqp_cholesky_lower_batched_f64": _BATCHED_SIGNATURE,
    "madqp_cholesky_batched_max_n": ([ctypes.c_int], ctypes.c_int),
}
# batched_route name -> the tier code of madqp_cholesky_lower_batched_*
_TIERS = {"warp8": 8, "warp16": 16, "warp32": 32, "warp64": 64, "cta": 0}


def _check_matrix(A: torch.Tensor) -> int:
    if A.dim() not in (2, 3) or A.shape[-1] != A.shape[-2]:
        raise ValueError("cholesky_lower needs a square matrix or a stack "
                         f"(B, n, n) of them, got {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cholesky_lower supports float32/float64, got {A.dtype}")
    return A.shape[-1]


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _factor_diag(D: torch.Tensor) -> torch.Tensor:
    """Factor the (..., jb, jb) diagonal block D in place by the column
    sweep (sqrt pivot, scale the column, rank-1 update of the later
    columns) and apply the same sweep to the identity: returns D's lower
    factor's inverse, zero above the diagonal."""
    jb = D.shape[-1]
    X = torch.eye(jb, dtype=D.dtype, device=D.device).expand(D.shape).clone()
    for k in range(jb):
        D[..., k, k] = torch.sqrt(D[..., k, k])
        piv = D[..., k, k, None]
        D[..., k + 1:, k] /= piv
        X[..., k, :k + 1] /= piv
        col = D[..., k + 1:, k]
        D[..., k + 1:, k + 1:] -= torch.tril(col[..., :, None] * col[..., None, :])
        X[..., k + 1:, :k + 1] -= col[..., :, None] * X[..., k, None, :k + 1]
    return X


def cholesky_lower_reference(A: torch.Tensor) -> torch.Tensor:
    """Right-looking blocked Cholesky in plain PyTorch ops, of one matrix
    or of each matrix of a (B, n, n) stack.

    For each BLOCK-column block: the column sweep of the diagonal block,
    which also yields its inverse L_D^-1; the panel solve as the product
    X = P L_D^-T; and the trailing update C -= X X^T on the lower
    triangle.  No early exit: a negative pivot's NaN propagates to the
    rest of its factor, as in the TPU kernel and the CUDA kernels."""
    n = _check_matrix(A)
    L = torch.tril(A)
    for j0 in range(0, n, BLOCK):
        j1 = min(j0 + BLOCK, n)
        Dinv = _factor_diag(L[..., j0:j1, j0:j1])
        if j1 == n:
            break
        X = L[..., j1:, j0:j1]
        X.copy_(X @ Dinv.mT)
        L[..., j1:, j1:] -= torch.tril(X @ X.mT)
    return L


# ---------------------------------------------------------------------------
# CUDA kernels: build, load, launch
# ---------------------------------------------------------------------------


def _check_block(lib) -> None:
    if lib.madqp_cholesky_block_size() != BLOCK:
        raise RuntimeError("csrc/cholesky.cu NB differs from BLOCK")


def _library():
    return _build.load(SOURCE, _SIGNATURES, check=_check_block)


def _batched_library():
    return _build.load(SOURCE_BATCHED, _BATCHED_SIGNATURES)


_max_n: dict = {}  # (device index, dtype) -> batched_max_n


def batched_max_n(dtype: torch.dtype, device) -> int:
    """Largest order whose square the batched kernel holds in one CTA's
    shared memory on `device` (the device's opt-in limit per block, read
    once per process and dtype)."""
    device = torch.device(device)
    key = (device.index, dtype)
    if key not in _max_n:
        lib = _batched_library()
        size = torch.empty((), dtype=dtype).element_size()
        with torch.cuda.device(device):
            n = lib.madqp_cholesky_batched_max_n(size)
        if n < 0:
            raise RuntimeError(f"batched K1: reading the shared-memory limit "
                               f"failed: CUDA error {-n}")
        _max_n[key] = n
    return _max_n[key]


def batched_route(n: int, n_max: int) -> str:
    """The kernel that factors a stack of order-n matrices, where n_max is
    `batched_max_n` for its dtype on its card.  Every route is one launch
    for the whole stack:

    * "warp8", "warp16", "warp32" (n <= 8, 16, 32): each matrix in the
      registers of a group of that many lanes, 32 / N matrices per warp;
    * "warp64" (n <= 64): one warp per matrix, in shared memory;
    * "cta" (n <= n_max): one CTA per matrix, in shared memory (the C
      side picks 8 or 4 warps, whichever takes fewer waves);
    * "persistent" (n > n_max): the persistent kernel, its lane axis
      over the stack.
    """
    if n > n_max:
        return "persistent"
    for width in (8, 16, 32, 64):
        if n <= width:
            return f"warp{width}"
    return "cta"


def _count(route: str) -> None:
    cholesky_lower.launches += 1
    cholesky_lower.routes[route] = cholesky_lower.routes.get(route, 0) + 1


def _launch_persistent(A: torch.Tensor, out: torch.Tensor) -> None:
    """The persistent kernel on one matrix (2-D, a stack of one) or on
    every lane of a stack (3-D), one cooperative launch either way."""
    lib = _library()
    fn = (lib.madqp_cholesky_lower_f32 if A.dtype == torch.float32
          else lib.madqp_cholesky_lower_f64)
    batch = 1 if A.dim() == 2 else A.shape[0]
    # per call: two stacks in flight on two streams never share it
    scratch = torch.empty((batch, BLOCK, BLOCK), dtype=A.dtype, device=A.device)
    err = fn(A.data_ptr(), out.data_ptr(), scratch.data_ptr(), batch, A.shape[-1],
             torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 Cholesky kernel launch failed: CUDA error {err}")
    _count("single" if A.dim() == 2 else "persistent")


def _launch_batched(A: torch.Tensor, out: torch.Tensor, route: str) -> None:
    lib = _batched_library()
    fn = (lib.madqp_cholesky_lower_batched_f32 if A.dtype == torch.float32
          else lib.madqp_cholesky_lower_batched_f64)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = fn(A.data_ptr(), out.data_ptr(), A.shape[0], A.shape[-1], _TIERS[route], stream)
    if err != 0:
        raise RuntimeError(f"batched K1 kernel ({route}) launch failed: CUDA error {err}")
    _count(route)


def cholesky_lower(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD `A`, or of each matrix of a (B, n, n)
    stack (see the module contract).

    CUDA tensor (contiguous): launches a hand-written kernel on the
    current stream (raises if it cannot be built or launched): the
    persistent kernel for one matrix; for a stack the kernel
    `batched_route` names, one launch for the whole stack.  CPU tensor:
    the plain version.  Any other device raises."""
    n = _check_matrix(A)
    if A.device.type == "cpu":
        return cholesky_lower_reference(A)
    if A.device.type != "cuda":
        raise ValueError(f"cholesky_lower: unsupported device {A.device}")
    if not A.is_contiguous():
        raise ValueError("cholesky_lower needs a contiguous matrix")
    out = torch.empty_like(A)
    if A.numel() == 0:
        return out
    with torch.cuda.device(A.device):
        if A.dim() == 2:
            _launch_persistent(A, out)
            return out
        route = batched_route(n, batched_max_n(A.dtype, A.device))
        if route == "persistent":
            _launch_persistent(A, out)
        else:
            _launch_batched(A, out, route)
    return out


cholesky_lower.launches = 0
cholesky_lower.routes = {}


# ---------------------------------------------------------------------------
# Factor selection
# ---------------------------------------------------------------------------


def dense_cholesky(M: torch.Tensor) -> torch.Tensor:
    """Library Cholesky (`linear_solver="dense"`) with the K1 contract, for
    one matrix or a stack.

    `torch.linalg.cholesky` raises on a matrix that is not SPD and
    `cholesky_ex` leaves a partial factor without a NaN, so the failure
    reported in `info` (one per matrix) is written into that matrix's
    diagonal as NaN (no host sync)."""
    L, info = torch.linalg.cholesky_ex(M)
    L.diagonal(dim1=-2, dim2=-1).masked_fill_(info[..., None] > 0, float("nan"))
    return L


def select_cholesky(backend: str):
    """Cholesky implementation by backend name: 'pallas' is the K1 kernel,
    anything else the library factorization."""
    return cholesky_lower if backend == "pallas" else dense_cholesky
