"""K8: the rank-k update `C - B B[:c]^T`, its plain PyTorch version, and
its launch counter.

Port of `benchmarks/exp_pallas_rl_chol.py::pallas_syrk_update`, the TPU
kernel that tiles the square update `C - B B^T` over a 2-D grid of output
tiles with the strips of B in VMEM.  Here it is the trailing update of the
two-level right-looking Cholesky `blocked_dense.panel_chol`: the in-stripe
update of every 256-column panel and the cross-stripe update of the
trailing square (see `csrc/syrk.cu` for the design and what bounds it).

* `syrk_update(C, B)` is the wrapper.  A CUDA tensor always launches the
  hand-written kernel or raises; a CPU tensor goes to the plain version.
  `syrk_update.launches` counts the kernel's launches.
* `syrk_update_reference(C, B)` is the plain version, in torch ops.

Both take C (r, c) with c <= r and B (r, k), float32 or float64, and return
a new (r, c) tensor `C - B @ B[:c].T`.  Products accumulate in the input
dtype: unlike the TPU kernel, which rounds every product to float32
(`preferred_element_type=jnp.float32`) even for float64 inputs, a float64
update here stays float64 (it serves the float64 rescue).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import _build

SOURCE = _build.CSRC_DIR / "syrk.cu"
# (C, B, out, r, c, k, stream) -> cudaError_t
_SIGNATURE = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
_SIGNATURES = {"madqp_syrk_update_f32": _SIGNATURE,
               "madqp_syrk_update_f64": _SIGNATURE}


def _check(C: torch.Tensor, B: torch.Tensor) -> None:
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


def syrk_update_reference(C: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version: C - B @ B[:c].T in torch ops, on any device."""
    _check(C, B)
    return C - B @ B[:C.shape[1]].T


def build_library() -> Path:
    """Compile csrc/syrk.cu into the build directory (skipped when the
    library for this source already exists); see `_build`."""
    return _build.build(SOURCE)


def _library():
    return _build.load(SOURCE, _SIGNATURES)


def syrk_update(C: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C - B @ B[:c].T for C (r, c), c <= r, and B (r, k).

    CUDA tensors: launches the hand-written kernel on the current stream
    (raises if it cannot be built or launched, or if an argument is not
    contiguous).  CPU tensors: the plain version.  Any other device
    raises."""
    _check(C, B)
    if C.device.type == "cpu":
        return syrk_update_reference(C, B)
    if C.device.type != "cuda":
        raise ValueError(f"syrk_update: unsupported device {C.device}")
    if not (C.is_contiguous() and B.is_contiguous()):
        raise ValueError("syrk_update needs contiguous (row-major) C and B")
    out = torch.empty_like(C)
    if out.numel() == 0:
        return out
    lib = _library()
    fn = (lib.madqp_syrk_update_f32 if C.dtype == torch.float32
          else lib.madqp_syrk_update_f64)
    r, c = C.shape
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        err = fn(C.data_ptr(), B.data_ptr(), out.data_ptr(), r, c, B.shape[1],
                 stream)
    if err != 0:
        raise RuntimeError(f"K8 syrk_update kernel launch failed: CUDA error {err}")
    syrk_update.launches += 1
    return out


syrk_update.launches = 0
