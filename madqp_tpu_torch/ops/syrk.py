"""K8: the rank-k update `C - B B[:c]^T`, its plain PyTorch version, its
launch counter, and the counts of the work it needs and computes.

Port of `benchmarks/exp_pallas_rl_chol.py::pallas_syrk_update`, the TPU
kernel that tiles the square update `C - B B^T` over a 2-D grid of output
tiles with the strips of B in VMEM.  Here it is the trailing update of the
two-level right-looking Cholesky `blocked_dense.panel_chol`: the in-stripe
update of every 256-column panel and the cross-stripe update of the
trailing square, each on the block that changes, in place (see
`csrc/syrk.cu` for the design and what bounds it).

* `syrk_update(C, B, out=None)` is the wrapper.  A CUDA tensor always
  launches the hand-written kernel or raises; a CPU tensor goes to the
  plain version.  `syrk_update.launches` counts the kernel's launches.
* `syrk_update_reference(C, B, out=None)` is the plain version, in torch
  ops.

Both take C (r, c) with c <= r and B (r, k), float32 or float64, each with
unit column stride and any row stride (views of a larger matrix), and
return `C - B @ B[:c].T`: in `out` if given (which may be C itself, for an
update in place), else in a new (r, c) tensor.  Products accumulate in the
input dtype: unlike the TPU kernel, which rounds every product to float32
(`preferred_element_type=jnp.float32`) even for float64 inputs, a float64
update here stays float64 (it serves the float64 rescue).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

SOURCE = _build.CSRC_DIR / "syrk.cu"
# Output tile edge of the kernel in both dtypes; must equal madqp_syrk_tile().
TILE = 64
# (C, ldc, B, ldb, out, ldo, r, c, k, stream) -> cudaError_t
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = ([_P, _I, _P, _I, _P, _I, _I, _I, _I, _P], _I)
_SIGNATURES = {"madqp_syrk_update_f32": _SIGNATURE,
               "madqp_syrk_update_f64": _SIGNATURE,
               "madqp_syrk_tile": ([], _I)}


def _check_strides(name: str, t: torch.Tensor) -> None:
    rows, cols = t.shape
    if t.numel() == 0:
        return
    if cols > 1 and t.stride(1) != 1:
        raise ValueError(f"syrk_update needs unit column stride, got {name} "
                         f"with strides {t.stride()}")
    if rows > 1 and t.stride(0) < max(cols, 1):
        raise ValueError(f"syrk_update needs row stride >= columns, got "
                         f"{name} {tuple(t.shape)} with strides {t.stride()}")


def _check(C: torch.Tensor, B: torch.Tensor, out=None) -> None:
    if C.dim() != 2 or B.dim() != 2:
        raise ValueError(f"syrk_update needs 2-D C and B, got {tuple(C.shape)} "
                         f"and {tuple(B.shape)}")
    r, c = C.shape
    if B.shape[0] != r or c > r:
        raise ValueError(f"syrk_update needs C (r, c) with c <= r and B (r, k), "
                         f"got {tuple(C.shape)} and {tuple(B.shape)}")
    if C.dtype not in (torch.float32, torch.float64) or B.dtype != C.dtype:
        raise TypeError(f"syrk_update supports float32/float64 of one dtype, "
                        f"got {C.dtype} and {B.dtype}")
    if C.device != B.device:
        raise ValueError(f"syrk_update: C on {C.device}, B on {B.device}")
    _check_strides("C", C)
    _check_strides("B", B)
    if out is not None:
        if out.shape != C.shape or out.dtype != C.dtype or out.device != C.device:
            raise ValueError(f"syrk_update: out {tuple(out.shape)} {out.dtype} "
                             f"on {out.device} does not match C")
        _check_strides("out", out)
        if out.data_ptr() == C.data_ptr() and out.stride() != C.stride():
            raise ValueError("syrk_update: out starts where C does but has "
                             "other strides")


def syrk_update_reference(C: torch.Tensor, B: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: C - B @ B[:c].T in torch ops, on any device."""
    _check(C, B, out)
    res = C - B @ B[:C.shape[1]].T
    if out is None:
        return res
    return out.copy_(res)


def syrk_ops(r: int, c: int, k: int) -> float:
    """Operations C - B B[:c]^T needs: the top (c, c) block of the product
    is symmetric, so only its lower triangle (c (c + 1) k) and the (r - c,
    c) block below it (2 (r - c) c k) have to be computed."""
    return float(c * (c + 1) * k + 2 * (r - c) * c * k)


def syrk_tile_ops(r: int, c: int, k: int) -> float:
    """Operations the kernel issues: 2 k per element of every launched
    TILE x TILE tile (the lower tiles of the top c x c block, all tiles
    below it), padding included."""
    tc, tr = math.ceil(c / TILE), math.ceil(r / TILE)
    return float(2 * k * TILE * TILE * (tc * (tc + 1) // 2 + (tr - tc) * tc))


def _check_tile(lib) -> None:
    if lib.madqp_syrk_tile() != TILE:
        raise RuntimeError("csrc/syrk.cu tile size differs from TILE")


def _library():
    return _build.load(SOURCE, _SIGNATURES, check=_check_tile)


def syrk_update(C: torch.Tensor, B: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """C - B @ B[:c].T for C (r, c), c <= r, and B (r, k), into `out` (C
    itself for an update in place) or a new tensor.

    CUDA tensors: launches the hand-written kernel on the current stream
    (raises if it cannot be built or launched, or if an argument has a
    column stride other than 1; nothing is copied).  `out` must be C or
    overlap neither C nor B.  CPU tensors: the plain version.  Any other
    device raises."""
    _check(C, B, out)
    if C.device.type == "cpu":
        return syrk_update_reference(C, B, out)
    if C.device.type != "cuda":
        raise ValueError(f"syrk_update: unsupported device {C.device}")
    if out is None:
        out = torch.empty(C.shape, dtype=C.dtype, device=C.device)
    if out.numel() == 0:
        return out
    lib = _library()
    fn = (lib.madqp_syrk_update_f32 if C.dtype == torch.float32
          else lib.madqp_syrk_update_f64)
    r, c = C.shape
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        err = fn(C.data_ptr(), C.stride(0), B.data_ptr(), B.stride(0),
                 out.data_ptr(), out.stride(0), r, c, B.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"K8 syrk_update kernel launch failed: CUDA error {err}")
    syrk_update.launches += 1
    return out


syrk_update.launches = 0
