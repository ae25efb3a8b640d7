#!/usr/bin/env python3
"""K2-batched's shared tier taken apart on one CUDA card: the clock cycles
of each part of a block step on one warp, and the timeline of warp 0 (the
critical path) and warp 1 (the team) inside the kernel itself.

Run from the root of a checkout:

    python3 tools/ldl_parts_torch.py [--out parts.json]

Writes PARTS_SOURCE to madqp_tpu_torch/_build/ldl_parts.cu and builds it
with the kernels' nvcc flags (ops/_build.py); it includes
madqp_tpu_torch/csrc/ldl_batched.cu, so it times the code the kernel runs,
and defines the source's LDL_STAMP hooks to record clock64() (warp 0 and
warp 1, lane 0) into a buffer.  Two records:
  * parts: one warp per CTA, one CTA per SM (132 CTAs), clock64() around
    one call: the diagonal tile's sweep (sweep_tile, without and with the
    floor), the whole diagonal step (factor_diag), one panel row per lane
    (panel_row), a 16 x 16 quarter of the next diagonal tile and a full
    tile's block (warp_update); median cycles over the CTAs;
  * timeline: the kernel on quasi-definite (B, 128, 128) stacks, float32
    and float64, B = 128 (one wave) and 1024; per block step the cycles of
    warp 0's diagonal factor (a), its wait on the helpers before it, and
    its panel (b, with the barrier before it: a clock read just after a
    barrier may be taken before the barrier completes), and of warp 1's
    quarter of the next diagonal tile, its panel rows and its tiles of the
    trailing update; medians over the CTAs.  tools/ldl_times_torch.py
    gives the kernel's time.
Prints the card's name and power limit first and the JSON record last.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SLOTS = 64  # stamps per CTA

PARTS_SOURCE = r"""
// Generated by tools/ldl_parts_torch.py: K2-batched's parts and timeline.
#include <cstdint>
namespace {
__device__ long long* g_stamps;
}
#define LDL_STAMP(cond, slot)                                              \
  do {                                                                     \
    if ((cond) && (threadIdx.x & 31) == 0 && g_stamps != nullptr)          \
      g_stamps[(long long)blockIdx.x * 64 + (slot)] = clock64();           \
  } while (0)
#include "../csrc/ldl_batched.cu"

namespace {

// One warp: part `part` on the tiles in shared memory, cycles to cyc.
template <typename T, int PART>
__global__ void __launch_bounds__(32) part_kernel(const T* in, T* out, long long* cyc) {
  __shared__ __align__(16) T sm[3 * BLK * TP + 2 * BLK];
  const int lane = threadIdx.x;
  T row[BLK];
#pragma unroll
  for (int c = 0; c < BLK; ++c) row[c] = in[lane * BLK + c];
  for (int e = lane; e < 3 * BLK * TP; e += 32)
    sm[e] = in[(e / TP % BLK) * BLK + e % TP % BLK];
  for (int e = lane; e < 2 * BLK; e += 32) sm[3 * BLK * TP + e] = T(1);
  __syncwarp();
  T dr = T(1), rr = T(1);
  T* o = out + (size_t)blockIdx.x * BLK * BLK;
  const long long t0 = clock64();
  if (PART == 0) sweep_tile<T, false>(row, lane, T(1), T(0), dr, rr);
  if (PART == 1) sweep_tile<T, true>(row, lane, T(1), T(1e-9), dr, rr);
  if (PART == 2)
    factor_diag<T, false>(sm, sm + 3 * BLK * TP, sm + 3 * BLK * TP + BLK, o, o, BLK, 0,
                          T(0), true, lane);
  if (PART == 3)
    panel_row<T>(sm + BLK * TP + lane * TP, sm, sm + 3 * BLK * TP, o + lane * BLK, true);
  if (PART == 4)
    warp_update<1, 2>(sm + 2 * BLK * TP, sm + BLK * TP, sm + BLK * TP, sm + 3 * BLK * TP,
                      16, 0, lane);
  if (PART == 5)
    warp_update<Team<T>::FULL_MF, 4>(sm + 2 * BLK * TP, sm, sm + BLK * TP,
                                     sm + 3 * BLK * TP, 0, 0, lane);
  __syncwarp();
  const T keep = row[lane] + dr + rr + sm[2 * BLK * TP + lane] + sm[BLK * TP + lane];
  const long long t1 = clock64();
  o[BLK * BLK - 1 - lane] = keep;
  if (lane == 0) cyc[blockIdx.x] = t1 - t0;
}

template <typename T>
int parts(int part, const T* in, T* out, long long* cyc, int grid) {
  switch (part) {
    case 0: part_kernel<T, 0><<<grid, 32>>>(in, out, cyc); break;
    case 1: part_kernel<T, 1><<<grid, 32>>>(in, out, cyc); break;
    case 2: part_kernel<T, 2><<<grid, 32>>>(in, out, cyc); break;
    case 3: part_kernel<T, 3><<<grid, 32>>>(in, out, cyc); break;
    case 4: part_kernel<T, 4><<<grid, 32>>>(in, out, cyc); break;
    case 5: part_kernel<T, 5><<<grid, 32>>>(in, out, cyc); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ldl_parts(int dbl, int part, const void* in, void* out, long long* cyc,
                         int grid) {
  return dbl ? parts<double>(part, (const double*)in, (double*)out, cyc, grid)
             : parts<float>(part, (const float*)in, (float*)out, cyc, grid);
}

// The kernel with its stamps going to `stamps` (null: none).
extern "C" int ldl_stamped(int dbl, const void* F, void* L, void* D, int batch, int n,
                           long long* stamps) {
  cudaError_t err = cudaMemcpyToSymbol(g_stamps, &stamps, sizeof(stamps));
  if (err != cudaSuccess) return (int)err;
  const long long sb = (long long)n * n;
  return dbl ? ldl_batched<double>((const double*)F, (double*)L, (double*)D, nullptr, 0.0,
                                   batch, n, sb, n, 0)
             : ldl_batched<float>((const float*)F, (float*)L, (float*)D, nullptr, 0.0, batch,
                                  n, sb, n, 0);
}
"""

PARTS = ("sweep", "sweep with floor", "diagonal step (factor_diag)", "panel row",
         "quarter update", "full-tile block update")


def timeline(st, nb):
    """Per-phase cycles from one CTA's stamps (see the kernel's LDL_STAMP
    slots): warp 0 in slots 0-17, warp 1 (a helper) in slots 20-35."""
    out = {"tile 0 loaded": st[1] - st[0]}
    for k in range(nb):
        if k > 0:
            out[f"wait diagonal {k}"] = st[2 + 4 * k] - st[5 + 4 * (k - 1)]
        out[f"factor {k}"] = st[3 + 4 * k] - st[2 + 4 * k]
        if k + 1 < nb:
            out[f"barrier + panel {k}"] = st[5 + 4 * k] - st[3 + 4 * k]
            out[f"helper quarter {k}"] = st[23 + 5 * k] - st[22 + 5 * k]
            if k + 2 < nb:
                out[f"panel rows + team barrier {k}"] = st[24 + 5 * k] - st[23 + 5 * k]
                out[f"helper tiles {k}"] = st[25 + 5 * k] - st[24 + 5 * k]
    out["total"] = st[3 + 4 * (nb - 1)] - st[0]
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="JSON file to write")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ldl_parts_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from madqp_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    source = _build.BUILD_DIR / "ldl_parts.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source.write_text(PARTS_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = _build.load(source, {"ldl_parts": ([I, I, P, P, P, I], I),
                               "ldl_stamped": ([I, P, P, P, I, I, P], I)})
    record = {"card": card, "parts": {}, "timeline": {}}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        rng = np.random.default_rng(0)
        M = rng.standard_normal((32, 32))
        A = torch.as_tensor(M @ M.T / 32 + 2 * np.eye(32), dtype=dtype, device="cuda")
        grid = torch.cuda.get_device_properties(0).multi_processor_count
        for part, name in enumerate(PARTS):
            out = torch.empty(grid * 32 * 32, dtype=dtype, device="cuda")
            cyc = torch.zeros(grid, dtype=torch.int64, device="cuda")
            for _ in range(3):  # the last call's clocks, warm
                err = lib.ldl_parts(int(dtype == torch.float64), part, A.data_ptr(),
                                    out.data_ptr(), cyc.data_ptr(), grid)
                if err != 0:
                    raise RuntimeError(f"ldl_parts {name}: CUDA error {err}")
            torch.cuda.synchronize()
            c = int(cyc.double().median())
            record["parts"][f"{dname} {name}"] = c
            print(f"  part {dname} {name}: {c} cycles (one warp)", flush=True)
        n = 128
        for batch in (128, 1024):
            M = rng.standard_normal((batch, n, n))
            M = M @ M.transpose(0, 2, 1) / n + np.eye(n)
            M[:, n // 2:, n // 2:] *= -1.0
            F = torch.as_tensor(M, dtype=dtype, device="cuda")
            L = torch.empty_like(F)
            D = torch.empty((batch, n), dtype=dtype, device="cuda")
            st = torch.zeros((batch, SLOTS), dtype=torch.int64, device="cuda")

            def launch(stamps):
                err = lib.ldl_stamped(int(dtype == torch.float64), F.data_ptr(), L.data_ptr(),
                                      D.data_ptr(), batch, n, stamps)
                if err != 0:
                    raise RuntimeError(f"ldl_stamped: CUDA error {err}")
            for _ in range(3):
                launch(st.data_ptr())
            torch.cuda.synchronize()
            rows = [timeline(s, n // 32) for s in st.tolist()]
            med = {key: float(np.median([r[key] for r in rows])) for key in rows[0]}
            record["timeline"][f"{dname} ({batch}, {n}, {n})"] = med
            print(f"  timeline {dname} ({batch}, {n}, {n}), median cycles: "
                  + ", ".join(f"{k} {v:.0f}" for k, v in med.items()), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
