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
* The plain versions, in PyTorch ops, on any device, for one matrix or a
  stack: `ROUTE_REFERENCE[route]` follows that route's kernel (its
  blocking and pivot arithmetic): `cholesky_persistent_reference` (64-column
  steps, the diagonal block in 16-column sub-blocks scaled by rsqrt, the
  panel by the block's inverse), `cholesky_shared_reference` (32-column
  blocks, the panel by forward substitution) and
  `cholesky_unblocked_reference` (the register tiers' column sweep).
  `cholesky_lower_reference(A)`, what `cholesky_lower` runs on the CPU,
  takes 64-column blocks, sweeps each whole diagonal block with divisions
  (which also inverts it) and solves the panel by the inverse.
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

import numpy as np
import torch

from . import _build

BLOCK = 64  # block-column width; must equal NB in csrc/cholesky.cu
SUB = 16  # sub-block of its diagonal factor (SB in csrc/cholesky.cu)
SHARED_BLOCK = 32  # block-column width of the shared tiers (BLK in cholesky_batched.cu)

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
# Plain versions
# ---------------------------------------------------------------------------


def _sweep(D: torch.Tensor, X=None) -> None:
    """Factor the (..., jb, jb) lower block D in place by the column sweep:
    the pivot is sqrt(d), the column below it is divided by the pivot, and
    the later columns lose the column's rank-1 product (lower triangle).
    With X (an identity of D's shape) the same sweep is applied to it,
    which leaves D's lower factor's inverse there."""
    for k in range(D.shape[-1]):
        D[..., k, k] = torch.sqrt(D[..., k, k])
        piv = D[..., k, k, None]
        D[..., k + 1:, k] /= piv
        col = D[..., k + 1:, k]
        D[..., k + 1:, k + 1:] -= torch.tril(col[..., :, None] * col[..., None, :])
        if X is not None:
            X[..., k, :k + 1] /= piv
            X[..., k + 1:, :k + 1] -= col[..., :, None] * X[..., k, None, :k + 1]


def _factor_diag(D: torch.Tensor) -> torch.Tensor:
    """Factor the diagonal block D in place by the column sweep, which also
    inverts it: returns D's lower factor's inverse, zero above the
    diagonal."""
    X = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device).expand(D.shape).clone()
    _sweep(D, X)
    return X


def _factor_sub_block(s: torch.Tensor, x: torch.Tensor, c0: int) -> None:
    """`csrc/cholesky.cu::factor_sub_block` (:102-150) on the SUB x SUB
    block at (c0, c0) of s, in place: the column sweep with the pivot
    sqrt(d), the column below it and row k of the inverse scaled by
    rsqrt(d), a multiply where `_sweep` divides.  Writes the inverse into
    x's block."""
    D = s[..., c0:c0 + SUB, c0:c0 + SUB]
    W = torch.eye(SUB, dtype=s.dtype, device=s.device).expand(D.shape).clone()
    for k in range(SUB):
        d = D[..., k, k].clone()
        rp = torch.rsqrt(d)[..., None]
        D[..., k + 1:, k] *= rp
        D[..., k, k] = torch.sqrt(d)
        W[..., k, :k + 1] *= rp
        col = D[..., k + 1:, k]
        D[..., k + 1:, k + 1:] -= torch.tril(col[..., :, None] * col[..., None, :])
        W[..., k + 1:, :k + 1] -= col[..., :, None] * W[..., k, None, :k + 1]
    x[..., c0:c0 + SUB, c0:c0 + SUB] = W


def _factor_diag_sub(D: torch.Tensor) -> torch.Tensor:
    """`csrc/cholesky.cu::factor_diag` (:152-262): the jb x jb diagonal
    block D, padded to BLOCK x BLOCK with an identity tail, factored in
    place right-looking over SUB-column sub-blocks (each by
    `_factor_sub_block`, then the panel below it times the sub-block's
    inverse transposed and the trailing lower triangle's update); then the
    inverse's off-diagonal blocks by block forward substitution,
    X_IJ = -X_II (sum_{J <= Q < I} L_IQ X_QJ).  Returns D's inverse."""
    jb = D.shape[-1]
    s = torch.eye(BLOCK, dtype=D.dtype, device=D.device).expand(
        D.shape[:-2] + (BLOCK, BLOCK)).clone()
    s[..., :jb, :jb] = torch.tril(D)
    x = torch.zeros_like(s)
    for c0 in range(0, BLOCK, SUB):
        c1 = c0 + SUB
        _factor_sub_block(s, x, c0)
        P = s[..., c1:, c0:c1]
        P.copy_(P @ x[..., c0:c1, c0:c1].mT)
        s[..., c1:, c1:] -= torch.tril(P @ P.mT)
    for r0 in range(SUB, BLOCK, SUB):
        r1 = r0 + SUB
        T = s[..., r0:r1, :r0] @ x[..., :r0, :r0]
        x[..., r0:r1, :r0] = -(x[..., r0:r1, r0:r1] @ T)
    D.copy_(s[..., :jb, :jb])
    return x[..., :jb, :jb]


def _panel_by_inverse(X: torch.Tensor, D: torch.Tensor, Dinv: torch.Tensor) -> None:
    X.copy_(X @ Dinv.mT)


def _panel_by_substitution(X: torch.Tensor, D: torch.Tensor, _) -> None:
    """Solve x L_D^T = p for every row of X in place, by forward
    substitution over the columns: x_j /= L_D[j, j], then
    x_c -= x_j L_D[c, j] for c > j."""
    for j in range(D.shape[-1]):
        X[..., j] /= D[..., j, j, None]
        X[..., j + 1:] -= X[..., j, None] * D[..., None, j + 1:, j]


def _right_looking(A: torch.Tensor, width: int, factor, panel) -> torch.Tensor:
    """Right-looking blocked Cholesky over `width`-column blocks of one
    matrix or of each matrix of a (B, n, n) stack: `factor(D)` factors the
    diagonal block D in place (and returns what `panel` needs), then
    `panel(X, D, aux)` turns the panel below it into X = P L_D^-T in
    place, and the trailing lower triangle loses X X^T.  No early exit: a
    negative pivot's NaN propagates to the rest of its factor, as in the
    TPU kernel and the CUDA kernels."""
    n = _check_matrix(A)
    L = torch.tril(A)
    for j0 in range(0, n, max(width, 1)):
        j1 = min(j0 + width, n)
        D = L[..., j0:j1, j0:j1]
        aux = factor(D)
        if j1 == n:
            break
        X = L[..., j1:, j0:j1]
        panel(X, D, aux)
        L[..., j1:, j1:] -= torch.tril(X @ X.mT)
    return L


def cholesky_lower_reference(A: torch.Tensor) -> torch.Tensor:
    """The plain version `cholesky_lower` runs on the CPU: BLOCK-column
    blocks, each diagonal block by the column sweep (`_sweep`: sqrt pivot,
    division), which also yields its inverse, and the panel as the product
    X = P L_D^-T."""
    return _right_looking(A, BLOCK, _factor_diag, _panel_by_inverse)


def cholesky_persistent_reference(A: torch.Tensor) -> torch.Tensor:
    """The plain version of the persistent kernel (`csrc/cholesky.cu`,
    routes "single" and "persistent"): BLOCK-column steps, the diagonal
    block factored and inverted in SUB-column sub-blocks with rsqrt
    scaling (`_factor_diag_sub`, cholesky.cu:102-262), the panel as the
    product X = P L_D^-T (phase 1, :306-319) and the trailing update
    (phase 2, :321-344)."""
    return _right_looking(A, BLOCK, _factor_diag_sub, _panel_by_inverse)


def cholesky_shared_reference(A: torch.Tensor) -> torch.Tensor:
    """The plain version of the shared-memory tiers (routes "warp64" and
    "cta", `csrc/cholesky_batched.cu::madqp_cholesky_batched_shared_kernel`):
    SHARED_BLOCK-column blocks, each diagonal block by the column sweep
    with the IEEE square root and a division (`factor_rows`, step a), the
    panel by forward substitution dividing by the pivots (step b), then
    the trailing update (step c)."""
    return _right_looking(A, SHARED_BLOCK, _sweep, _panel_by_substitution)


def cholesky_unblocked_reference(A: torch.Tensor) -> torch.Tensor:
    """The plain version of the register tiers (routes "warp8", "warp16",
    "warp32", `madqp_cholesky_batched_regs_kernel`): the unblocked column
    sweep of the whole matrix (`factor_rows`), the IEEE square root and a
    division per pivot."""
    return _right_looking(A, A.shape[-1], _sweep, None)


# The plain version that follows each route's kernel (its blocking and its
# pivot arithmetic, as far as PyTorch ops can: the kernels contract
# a - b c into one FMA and sum the tile products in their own order).
ROUTE_REFERENCE = {
    "single": cholesky_persistent_reference,
    "persistent": cholesky_persistent_reference,
    "cta": cholesky_shared_reference,
    "warp64": cholesky_shared_reference,
    "warp32": cholesky_unblocked_reference,
    "warp16": cholesky_unblocked_reference,
    "warp8": cholesky_unblocked_reference,
}

# max|L - P| / max|P| per matrix, L a route's kernel factor and P its
# route's plain version, by route and dtype: 1.5 to 3 times the largest
# error measured on an H100 (chip_smoke.py phases 3 and 9: persistent
# 1.66e-7 / 3.06e-16, on lane-axis stacks of 256-1024 matrices of order
# 175-1259; shared tiers 1.63e-7 / 3.05e-16; register tiers 1.66e-7 /
# 3.99e-16; PERF.md §6).  What remains is the kernels' FMA contraction of
# a - b c and their order of the trailing sums, which no PyTorch op
# follows.
ROUTE_TOL = {
    **dict.fromkeys(("single", "persistent"), {"float32": 2.5e-7, "float64": 5e-16}),
    **dict.fromkeys(("cta", "warp64", "warp32", "warp16", "warp8"),
                    {"float32": 5e-7, "float64": 1e-15}),
}


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

# `batched_max_n` as an H100 reads it (227 KB of opt-in shared memory per
# CTA): the route a stack takes there, which the CPU form below follows.
H100_BATCHED_MAX_N = {torch.float32: 235, torch.float64: 163}


def cholesky_lower_routed(A: torch.Tensor) -> torch.Tensor:
    """`cholesky_lower` whose CPU form is the plain twin of the route the
    card takes (`ROUTE_REFERENCE`; a stack's route at the H100's n_max),
    where `cholesky_lower` on the CPU runs the 64-column version.  The
    supernodal fronts (`ops/sparse_chol.py`) factor through it, so the CPU
    tests follow the card's algorithm.  A CUDA tensor launches the kernel
    (and counts) exactly as `cholesky_lower` does."""
    n = _check_matrix(A)
    if A.device.type != "cpu":
        return cholesky_lower(A)
    route = "single" if A.dim() == 2 else batched_route(n, H100_BATCHED_MAX_N[A.dtype])
    return ROUTE_REFERENCE[route](A)


# ---------------------------------------------------------------------------
# Factor selection
# ---------------------------------------------------------------------------


def _lapack_cholesky(M: torch.Tensor) -> torch.Tensor:
    """The CPU form of `dense_cholesky`: LAPACK's `dpotrf` / `spotrf` from
    `scipy.linalg.lapack`, one matrix at a time, on the column-major copy
    with uplo "L".  That is the call the JAX package's CPU Cholesky makes
    (jaxlib takes its LAPACK kernels from SciPy), so the factors are
    bit-equal to `jax.scipy.linalg.cholesky`'s, where torch's
    `cholesky_ex` takes the LAPACK its wheel links (MKL in the x86 wheels),
    whose rounding follows the host CPU's instruction-set dispatch.  A
    matrix that is not SPD gets NaN on its diagonal."""
    from scipy.linalg import lapack

    potrf = {torch.float64: lapack.dpotrf, torch.float32: lapack.spotrf}[M.dtype]
    A = M.detach().numpy()
    if A.size == 0:
        return torch.zeros_like(M)
    flat = A.reshape((-1,) + A.shape[-2:])
    out = np.empty_like(flat)
    for i, a in enumerate(flat):
        c, info = potrf(np.asfortranarray(a), lower=1, clean=1)
        out[i] = c
        if info > 0:
            np.fill_diagonal(out[i], np.nan)
    return torch.from_numpy(out.reshape(A.shape))


def dense_cholesky(M: torch.Tensor) -> torch.Tensor:
    """Library Cholesky (`linear_solver="dense"`) with the K1 contract, for
    one matrix or a stack.

    One matrix on the CPU takes SciPy's LAPACK (`_lapack_cholesky`,
    bit-equal to the JAX package's CPU Cholesky); a stack on the CPU and
    every CUDA tensor `cholesky_ex` (MKL on the CPU, cuSOLVER on the card).
    A stack stays there because the dense batch's CPU comparisons sit at
    their rounding floor (ROADMAP.md Queue 3).  `torch.linalg.cholesky`
    raises on a matrix that is not SPD and `cholesky_ex` leaves a partial
    factor without a NaN, so the failure reported in `info` (one per
    matrix) is written into that matrix's diagonal as NaN (no host
    sync)."""
    if M.device.type == "cpu" and M.dim() == 2:
        return _lapack_cholesky(M)
    L, info = torch.linalg.cholesky_ex(M)
    L.diagonal(dim1=-2, dim2=-1).masked_fill_(info[..., None] > 0, float("nan"))
    return L


def select_cholesky(backend: str):
    """Cholesky implementation by backend name: 'pallas' is the K1 kernel,
    anything else the library factorization."""
    return cholesky_lower if backend == "pallas" else dense_cholesky
