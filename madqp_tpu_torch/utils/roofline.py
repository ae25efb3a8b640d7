"""Roofline accounting for the factorization kernels (port of
`madqp_tpu/utils/roofline.py`).

The card's peaks, operation and byte models of the dense and supernodal
factorizations, and a measured -> fraction-of-peak report.  Peaks are
published data-sheet numbers of the card (dense rates); they bound what a
kernel can reach, they are not measured here.

* `ChipPeaks`, `chip_peaks`: the peaks of the current CUDA card (read from
  `torch.cuda.get_device_name`); an unknown device, or none, gives NaN
  peaks, as the reference's unknown chips do.
* `dense_ldl_flops`, `dense_ldl_bytes`, `schedule_flops`, `schedule_bytes`,
  `roofline_report`: the reference's formulas.  Note its flop count of a
  dense factorization, 2 n^3 / 3, counts n^3 / 3 multiply-adds twice; the
  bounds below count the n^3 / 3 operations a Cholesky or LDL^T needs.
* `bound_ms` and the per-kernel counts (`factor_ops`, `cholesky_bytes`,
  `ldl_bytes`, `syrk_ops`, `syrk_bytes`): the least time a kernel's work
  takes on a card, the larger of its operations over the peak of their type
  and its bytes (each input read once, each output written once) over the
  memory rate; `chip_smoke.py` and the tools report each kernel against it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    name: str
    bf16_tflops: float       # tensor-core peak, dense matmul
    f32_tflops: float        # float32 without TF32 (the CUDA cores)
    hbm_gbps: float          # device-memory bandwidth
    f64_tflops: float = float("nan")   # float64 (the FP64 tensor cores)

    def tflops(self, dtype: str) -> float:
        """The peak of operations in `dtype` ("bfloat16", "float32",
        "float64")."""
        return {"bfloat16": self.bf16_tflops, "float64": self.f64_tflops}.get(
            dtype, self.f32_tflops)


# One H100 SXM, NVIDIA's data sheet (dense rates): 989 TFLOP/s bf16 on the
# tensor cores; 67 TFLOP/s float32 on the CUDA cores (TF32 would lose the
# accuracy the float32 factorization needs) and float64 on the FP64 tensor
# cores, which cuBLAS uses (the 34 TFLOP/s of the FP64 CUDA cores is no
# lower bound: torch.addmm beats it); 3.35 TB/s of HBM3.
H100 = ChipPeaks("NVIDIA H100", 989.0, 67.0, 3350.0, 67.0)

_PEAKS = {"h100": H100}


def chip_peaks(device=None) -> ChipPeaks:
    """The peaks of `device` (default: the current CUDA card), matched on
    `torch.cuda.get_device_name`; NaN peaks for a device that is not in
    the table or when there is no card."""
    import torch

    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        kind = torch.cuda.get_device_name(device)
    else:
        kind = str(device if device is not None else "cpu")
    for key, peaks in _PEAKS.items():
        if key in kind.lower():
            return peaks
    nan = float("nan")
    return ChipPeaks(f"unknown({kind})", nan, nan, nan, nan)


def dense_ldl_flops(n: int) -> float:
    """n^3/3 multiply-adds * 2 flops for an n x n LDL/Cholesky."""
    return 2.0 * n ** 3 / 3.0


def dense_ldl_bytes(n: int, dtype_bytes: int) -> float:
    """Memory-traffic lower bound: read + write the n^2 triangle once each."""
    return 2.0 * n * n * dtype_bytes


def schedule_flops(bs) -> float:
    """Padded factorization flops of a supernodal schedule (the flops the
    card EXECUTES, padding included)."""
    total = 0.0
    for it in bs.schedule:
        w, u = it.w_pad, it.u_pad
        fronts = it.count * getattr(it, "steps", 1)
        total += 2.0 * fronts * (w ** 3 / 3.0 + w * w * u + w * u * u)
    return total


def schedule_bytes(bs, dtype_bytes: int) -> float:
    """Memory-traffic lower bound of a supernodal schedule: each bucketed
    front reads+writes its (w+u) x w panel and reads+writes its u x u
    extend-add update block once."""
    total = 0.0
    for it in bs.schedule:
        w, u = it.w_pad, it.u_pad
        fronts = it.count * getattr(it, "steps", 1)
        total += fronts * dtype_bytes * (2.0 * (w + u) * w + 2.0 * u * u)
    return total


def roofline_report(flops: float, bytes_moved: float, seconds: float,
                    dtype: str = "float32", device=None) -> dict:
    """Achieved GFLOP/s + GB/s and their fractions of the card's peaks."""
    peaks = chip_peaks(device)
    peak_tf = peaks.tflops(dtype)
    gflops = flops / seconds / 1e9
    gbps = bytes_moved / seconds / 1e9
    return {
        "chip": peaks.name,
        "seconds": round(seconds, 6),
        "gflops": round(gflops, 2),
        "mfu": round(gflops / (peak_tf * 1e3), 4)
        if peak_tf == peak_tf else None,
        "gbps": round(gbps, 2),
        "hbm_frac": round(gbps / peaks.hbm_gbps, 4)
        if peaks.hbm_gbps == peaks.hbm_gbps else None,
    }


# ---------------------------------------------------------------------------
# Bounds of single kernels
# ---------------------------------------------------------------------------


def bound_ms(ops: float, nbytes: float, dtype: str, peaks: ChipPeaks = H100):
    """(least milliseconds for the work on a card with `peaks`, "operations"
    or "bytes": what sets it)."""
    t_ops = ops / (peaks.tflops(dtype) * 1e12) * 1e3
    t_bytes = nbytes / (peaks.hbm_gbps * 1e9) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def factor_ops(batch: int, n: int) -> float:
    """Operations of `batch` Cholesky or LDL^T factors of order n."""
    return batch * n ** 3 / 3


def cholesky_bytes(batch: int, n: int, element_size: int) -> float:
    """Each lower triangle read once (all a symmetric input needs) and each
    factor, its zero upper triangle included, written once."""
    return batch * (n * (n + 1) // 2 + n * n) * element_size


def ldl_bytes(batch: int, n: int, element_size: int) -> float:
    """`cholesky_bytes` and the pivot vector d written once."""
    return batch * (n * (n + 1) // 2 + n * n + n) * element_size


def syrk_ops(r: int, c: int, k: int) -> float:
    """Operations C - B B[:c]^T needs: the top (c, c) block of the product
    is symmetric, so only its lower triangle (c (c + 1) k) and the (r - c,
    c) block below it (2 (r - c) c k) have to be computed."""
    return float(c * (c + 1) * k + 2 * (r - c) * c * k)


def syrk_bytes(r: int, c: int, k: int, element_size: int) -> float:
    """C (r, c) read and written once, B (r, k) read once."""
    return float((2 * r * c + r * k) * element_size)
