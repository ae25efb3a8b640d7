"""K2-batched: the no-pivot signed LDL^T of a stack of small symmetric
matrices, its hand-written Hopper kernel and its plain PyTorch version.

The JAX package builds this function from XLA ops
(`madqp_tpu/ops/blocked_dense.py::unblocked_ldl` / `blocked_ldl`, reached
through `madqp_tpu/ops/sparse_chol.py::dense_ldl`); no Pallas kernel
computed it.  Its users here are the fronts of the signed supernodal
factorization (`ops/sparse_chol.py::_ldl_front`): the augmented K2 system of
`solve_sparse_qp`, and the float32 phases of the normal-equations and
condensed paths.  `torch.linalg.ldl_factor` pivots (Bunch-Kaufman), which
breaks the pivot-sign inertia check of `factor_ok_batched_ldl`, so no
library call stands in for it.

* `ldl_lower_batched(F, sgn=None, floor=0.0) -> (L, d)`: F (B, n, n),
  float32 or float64, n <= 128, only its lower triangle read (a view whose
  columns are contiguous is taken as it is); L unit lower with a zero
  strict upper triangle, d (B, n) the pivots.  With `sgn` (B, n) of +-1 and
  floor > 0 each pivot becomes s max(s d, floor) before it is used.  A CUDA
  tensor launches `csrc/ldl_batched.cu` (one launch per stack, counted in
  `ldl_lower_batched.launches`) or raises; a CPU tensor takes the plain
  version.  Any other device raises.
* `ldl_batched_reference(F, sgn=None, floor=0.0)`: the plain version, in
  PyTorch ops on any device, following the kernel's blocking, pivot
  arithmetic and scaling: for n <= 32 the register tier's column sweep of
  the whole matrix (l = a / d, then a -= (d l) l^T); above it 32-column
  blocks, each diagonal block by the shared tier's sweep (l = z (1 / d),
  then a -= l z^T), the panel by forward substitution (z L_D^T = p),
  L21 = z (1 / d), the trailing update by L21 z^T (the products summed,
  then subtracted).
* `occupancy(dtype, n)`: CTAs (one matrix each) of the kernel's shared
  tier that one SM of the current card holds at once at order n.

Contract shared by both: no pivoting and no early exit; a pivot of the
wrong sign is kept, a zero pivot gives inf or NaN in its own matrix only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCE = _build.CSRC_DIR / "ldl_batched.cu"
BLOCK = 32      # block-column width of the shared tier (BLK in ldl_batched.cu)
MAX_N = 128     # the largest order (MAX_N in ldl_batched.cu)
# The shared tier (32 < n <= 128): warps of a CTA, which factors one matrix,
# and the CTAs per SM its launch bounds ask for (WARPS_F32 / WARPS_F64 and
# CTAS_F32 / CTAS_F64 in ldl_batched.cu).
WARPS = {"float32": 4, "float64": 7}
CTAS_PER_SM = {"float32": 4, "float64": 2}
# (F, L, D, sgn, floor, batch, n, batch stride, row stride, stream) -> cudaError_t
_SIGNATURE = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int)
_SIGNATURES = {
    "madqp_ldl_batched_f32": _SIGNATURE,
    "madqp_ldl_batched_f64": _SIGNATURE,
    "madqp_ldl_batched_max_n": ([], ctypes.c_int),
    "madqp_ldl_batched_occupancy": ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
}

# max|L - P| / max|P| and max|d - d_P| / max|d_P| per matrix, kernel against
# its plain version, on well-conditioned (quasi-definite) stacks: the
# kernels contract a - b c into one FMA and sum the trailing products in
# their own order, which no PyTorch op follows (K1's batched tiers meet the
# same bounds, pallas_chol.ROUTE_TOL).
TOL = {"float32": 5e-7, "float64": 1e-15}


def _check(F: torch.Tensor, sgn) -> int:
    if F.dim() != 3 or F.shape[-1] != F.shape[-2]:
        raise ValueError(f"ldl_lower_batched needs a stack (B, n, n), got {tuple(F.shape)}")
    if F.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ldl_lower_batched supports float32/float64, got {F.dtype}")
    n = F.shape[-1]
    if n > MAX_N:
        raise ValueError(f"ldl_lower_batched: order {n} above {MAX_N}")
    if sgn is not None and tuple(sgn.shape) != tuple(F.shape[:-1]):
        raise ValueError(f"ldl_lower_batched: signs {tuple(sgn.shape)} for a stack "
                         f"{tuple(F.shape)}")
    return n


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _sweep(A: torch.Tensor, sgn, floor: float) -> None:
    """The column sweep of the register tier (`ldl_rows`) on the (..., m, m)
    lower block A, in place: the pivot (floored with `sgn`), the column
    below it divided by it, the later columns' lower triangle less
    (d l_r) l_j.  Leaves the pivots on A's diagonal and L's strict lower
    triangle below it."""
    floor_t = torch.tensor(floor, dtype=A.dtype, device=A.device)
    for k in range(A.shape[-1]):
        d = A[..., k, k].clone()
        if sgn is not None:
            s = sgn[..., k]
            d = s * torch.maximum(s * d, floor_t)
        l = A[..., k + 1:, k] / d[..., None]
        A[..., k, k] = d
        A[..., k + 1:, k] = l
        dl = d[..., None] * l
        A[..., k + 1:, k + 1:] -= torch.tril(dl[..., :, None] * l[..., None, :])


def _sweep_tile(A: torch.Tensor, sgn, floor: float) -> None:
    """The shared tier's sweep of a (..., m, m) diagonal block A, in place
    (`sweep_tile`): the pivot d (floored with `sgn`), its reciprocal
    1 / d, the column below it l = z (1 / d), the later columns' lower
    triangle less l_r z_j.  Leaves the pivots on A's diagonal and L's
    strict lower triangle below it."""
    floor_t = torch.tensor(floor, dtype=A.dtype, device=A.device)
    for k in range(A.shape[-1]):
        d = A[..., k, k].clone()
        if sgn is not None:
            s = sgn[..., k]
            d = s * torch.maximum(s * d, floor_t)
        z = A[..., k + 1:, k].clone()
        l = z * (1.0 / d)[..., None]
        A[..., k, k] = d
        A[..., k + 1:, k] = l
        A[..., k + 1:, k + 1:] -= torch.tril(l[..., :, None] * z[..., None, :])


def ldl_batched_reference(F: torch.Tensor, sgn=None, floor: float = 0.0):
    """The plain version of `csrc/ldl_batched.cu` (see the module
    docstring): returns (L, d)."""
    n = _check(F, sgn)
    if sgn is None or floor <= 0.0:
        sgn = None
    else:
        sgn = sgn.to(F.dtype)
    A = torch.tril(F).clone()
    if n <= BLOCK:   # the register tier
        _sweep(A, sgn, floor)
    for c0 in range(0, n if n > BLOCK else 0, BLOCK):
        c1 = min(c0 + BLOCK, n)
        D = A[..., c0:c1, c0:c1]
        _sweep_tile(D, None if sgn is None else sgn[..., c0:c1], floor)
        if c1 == n:
            break
        X = A[..., c1:, c0:c1]
        for j in range(c1 - c0):   # z L_D^T = p: z_c -= z_j L_D[c, j]
            X[..., j + 1:] -= X[..., j, None] * D[..., None, j + 1:, j]
        Z = X.clone()
        X *= 1.0 / torch.diagonal(D, dim1=-2, dim2=-1)[..., None, :]   # L21 = z (1 / d)
        A[..., c1:, c1:] -= torch.tril(X @ Z.mT)
    d = torch.diagonal(A, dim1=-2, dim2=-1).clone()
    L = torch.tril(A, -1) + torch.eye(n, dtype=A.dtype, device=A.device)
    return L, d


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------


def _check_max_n(lib) -> None:
    if lib.madqp_ldl_batched_max_n() != MAX_N:
        raise RuntimeError("csrc/ldl_batched.cu MAX_N differs from MAX_N")


def _library():
    return _build.load(SOURCE, _SIGNATURES, check=_check_max_n)


def occupancy(dtype: torch.dtype, n: int = MAX_N) -> int:
    """CTAs of the shared tier (one matrix each) that one SM of the current
    CUDA card holds at once at order n (32 < n <= 128), from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; raises if the query
    fails."""
    blocks = _library().madqp_ldl_batched_occupancy(torch.tensor([], dtype=dtype).element_size(),
                                                      int(n))
    if blocks < 0:
        raise RuntimeError(f"K2-batched occupancy query failed: CUDA error {-blocks}")
    return blocks


def ldl_lower_batched(F: torch.Tensor, sgn=None, floor: float = 0.0):
    """No-pivot LDL^T of each matrix of the stack F (see the module
    contract): (L, d).  CUDA: one kernel launch on the current stream
    (raises if it cannot be built or launched); CPU: the plain version."""
    n = _check(F, sgn)
    if F.device.type == "cpu":
        return ldl_batched_reference(F, sgn, floor)
    if F.device.type != "cuda":
        raise ValueError(f"ldl_lower_batched: unsupported device {F.device}")
    if F.stride(-1) != 1:
        raise ValueError("ldl_lower_batched needs contiguous columns (stride 1)")
    B = F.shape[0]
    L = torch.empty((B, n, n), dtype=F.dtype, device=F.device)
    d = torch.empty((B, n), dtype=F.dtype, device=F.device)
    if B == 0 or n == 0:
        return L, d
    use_floor = sgn is not None and floor > 0.0
    s = sgn.to(F.dtype).contiguous() if use_floor else None
    lib = _library()
    fn = lib.madqp_ldl_batched_f32 if F.dtype == torch.float32 else lib.madqp_ldl_batched_f64
    with torch.cuda.device(F.device):
        err = fn(F.data_ptr(), L.data_ptr(), d.data_ptr(), s.data_ptr() if use_floor else None,
                 float(floor), B, n, F.stride(0), F.stride(1),
                 torch.cuda.current_stream(F.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2-batched LDL^T kernel launch failed: CUDA error {err}")
    ldl_lower_batched.launches += 1
    return L, d


ldl_lower_batched.launches = 0
