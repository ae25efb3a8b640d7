// K8: the rank-k update out = C - B B[:c]^T, hand-written for Hopper.
//
// Replaces the TPU kernel benchmarks/exp_pallas_rl_chol.py::pallas_syrk_update
// (the pl.pallas_call at exp_pallas_rl_chol.py:120, body _syrk_update_kernel
// at :104-108), which tiles the square C over a 2-D grid of 512 x 512 output
// tiles and keeps the (512, k) strips of B resident in VMEM.  Here it is the
// trailing update of the two-level right-looking Cholesky panel_chol
// (ops/blocked_dense.py): C (r, c) with c <= r, B (r, k), all row-major and
// contiguous, float32 or float64.  The square case c = r is the TPU kernel's
// function and the cross-stripe update; the rectangular case c < r is the
// in-stripe update of a stripe narrower than the trailing matrix.
//
// What bounds it: the function needs c (c + 1) k + 2 (r - c) c k operations
// (the top c x c block of B B[:c]^T is symmetric) against (2 r c + r k)
// elements of traffic.  At r = c = 2048, k = 256 that is 1.07 GFLOP against
// 36 MB in float32, about 16 us at the card's 67 TFLOP/s on CUDA cores and
// 11 us at 3.35 TB/s: it is bound by operations.  This simple kernel does
// all 2 r c k of the full tiles, both halves of the symmetric block
// included, and the zero rows of a masked B as well.  The design
// keeps every B element that a CTA reads in shared memory for TILE uses and
// every partial sum in registers:
//
//   * one CTA per TILE x TILE output tile (64 x 64 in float32, 32 x 32 in
//     float64), (TILE / TM)^2 threads, each with a TM x TM register block of
//     sums (TM = 4) on rows ty + p * TILE/TM and columns tx + q * TILE/TM, so
//     neighbouring threads read neighbouring shared-memory words and write
//     neighbouring output columns;
//   * k is walked in chunks of KC = 16 columns of B; the two (TILE, KC)
//     strips of B (rows of the tile's i and j ranges) are staged k-major
//     through shared memory;
//   * every product is an explicit fused multiply-add in the input dtype
//     (__fmaf_rn / __fma_rn): no TF32, no tensor cores, no fast-math, so a
//     NaN in B or C reaches every output it touches (the factor_ok contract
//     of the Cholesky that calls it);
//   * ragged edges in r, c and k are masked on load (a select, never a
//     multiply by a mask) and on store: no padding requirement;
//   * out = C - acc is written once; no atomics, so results are the same
//     from run to run.
//
// Plain TF32 on the tensor cores keeps about three decimal digits and cannot
// serve the float32 factorization.  A faster version (wgmma with a
// split-TF32 scheme that keeps float32 accuracy, TMA or cp.async double
// buffering, skipping the all-zero row tiles of the masked in-stripe update)
// is later work.
//
// Interface: plain C functions, one per dtype, that launch on the given
// stream and return cudaGetLastError() (0 on success).  Built by
// madqp_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
struct Config;
template <>
struct Config<float> {
  static constexpr int TILE = 64;  // output tile is TILE x TILE
  static constexpr int TM = 4;     // register block is TM x TM per thread
  static constexpr int KC = 16;    // columns of B staged per step
  static constexpr int NT = (TILE / TM) * (TILE / TM);  // threads per CTA
};
template <>
struct Config<double> {
  static constexpr int TILE = 32;
  static constexpr int TM = 4;
  static constexpr int KC = 16;
  static constexpr int NT = (TILE / TM) * (TILE / TM);
};

// Grid (ceil(c / TILE), ceil(r / TILE)); blockDim Config<T>::NT.
template <typename T>
__global__ void __launch_bounds__(Config<T>::NT)
syrk_update_kernel(const T* __restrict__ C, const T* __restrict__ B,
                   T* __restrict__ out, int r, int c, int k) {
  constexpr int TILE = Config<T>::TILE;
  constexpr int TM = Config<T>::TM;
  constexpr int KC = Config<T>::KC;
  constexpr int TD = TILE / TM;  // threads along each tile dimension
  constexpr int NT = Config<T>::NT;
  // k-major strips: bi[kk][row] = B[i0 + row, l0 + kk]; the +1 keeps the
  // transposing stores off a single bank.
  __shared__ T bi[KC][TILE + 1];
  __shared__ T bj[KC][TILE + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TD;
  const int ty = tid / TD;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;

  T acc[TM][TM];
#pragma unroll
  for (int p = 0; p < TM; ++p)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[p][q] = T(0);

  for (int l0 = 0; l0 < k; l0 += KC) {
    for (int e = tid; e < TILE * KC; e += NT) {
      const int row = e / KC;
      const int kk = e - row * KC;
      const int l = l0 + kk;
      const int gi = i0 + row;
      const int gj = j0 + row;
      bi[kk][row] = (gi < r && l < k) ? B[(size_t)gi * k + l] : T(0);
      bj[kk][row] = (gj < c && l < k) ? B[(size_t)gj * k + l] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      T a[TM], b[TM];
#pragma unroll
      for (int p = 0; p < TM; ++p) a[p] = bi[kk][ty + p * TD];
#pragma unroll
      for (int q = 0; q < TM; ++q) b[q] = bj[kk][tx + q * TD];
#pragma unroll
      for (int p = 0; p < TM; ++p)
#pragma unroll
        for (int q = 0; q < TM; ++q) acc[p][q] = fma_rn(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < TM; ++p) {
    const int gi = i0 + ty + p * TD;
    if (gi >= r) continue;
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int gj = j0 + tx + q * TD;
      if (gj < c) {
        const size_t idx = (size_t)gi * c + gj;
        out[idx] = C[idx] - acc[p][q];
      }
    }
  }
}

template <typename T>
int syrk_update(const T* C, const T* B, T* out, int r, int c, int k,
                cudaStream_t stream) {
  if (r <= 0 || c <= 0) return 0;
  constexpr int TILE = Config<T>::TILE;
  const dim3 grid((c + TILE - 1) / TILE, (r + TILE - 1) / TILE);
  syrk_update_kernel<T><<<grid, Config<T>::NT, 0, stream>>>(C, B, out, r, c, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int madqp_syrk_update_f32(const void* C, const void* B, void* out,
                                     int r, int c, int k, void* stream) {
  return syrk_update<float>(static_cast<const float*>(C),
                            static_cast<const float*>(B),
                            static_cast<float*>(out), r, c, k,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int madqp_syrk_update_f64(const void* C, const void* B, void* out,
                                     int r, int c, int k, void* stream) {
  return syrk_update<double>(static_cast<const double*>(C),
                             static_cast<const double*>(B),
                             static_cast<double*>(out), r, c, k,
                             static_cast<cudaStream_t>(stream));
}
