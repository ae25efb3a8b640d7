// K1: lower Cholesky factor of a dense SPD matrix, hand-written for Hopper.
//
// Replaces the TPU kernel madqp_tpu/ops/pallas_chol.py::pallas_cholesky
// (the pl.pallas_call at pallas_chol.py:158), which keeps the whole padded
// matrix resident in VMEM and runs a fused right-looking blocked
// factorization with 128-column blocks.  An SM's 227 KB of shared memory
// cannot hold the solver's matrices (W is 600 x 600 on the headline
// problem, 2500 x 2500 on the large one), so the matrix stays in device
// memory and the same right-looking algorithm runs over NB = 64-column
// blocks inside ONE cooperative launch: a persistent grid of at most two
// CTAs per SM, with grid-wide barriers between the phases of a step.
//
//   0. L = tril(A) by every CTA (grid-stride), except the first diagonal
//      block, which CTA 0 factors straight from A;                 barrier
//   per block column j0 with rows below it (j1 = j0 + NB):
//   1. panel solve as a product: X = P L_D^-T, P = L[j1:, j0:j1], one
//      row tile of the tile routine (syrk_tile.cuh) per CTA in turn,
//      written back over P;                                        barrier
//   2. trailing update L[j1:, j1:] -= X X^T over its lower tiles, assigned
//      round-robin (tile t to CTA t mod grid), diagonal tiles written on
//      and below the diagonal only.  CTA 0, which owns tile 0, then
//      factors the next diagonal block, which lies inside that tile, and
//      inverts it (factor_diag: 16-column sub-blocks, each factored by
//      one warp with shuffles), writing L_D and L_D^-1 (to a scratch
//      buffer the wrapper allocates);                              barrier
//
// That is 2 ceil(n / 64) - 1 grid barriers and one launch per
// factorization.
//
// What bounds it: at n = 600 the factorization is 7.2e7 operations, a
// microsecond of the card's rate; at n = 2500 5.2e9, 78 us.  The time goes
// to the serial chain of n / 64 steps, each a panel tile, the tile that
// holds the next diagonal block, that block's factor and two grid
// barriers.  The diagonal factor is the longest link: 64 pivots in a row,
// each a shuffle, a square root and a multiply on one warp, with CTA
// barriers between its four sub-blocks (tools/kernel_parts.py times each
// part).  The panel solve is one tile product against the explicit
// L_D^-1, not a substitution along the block's columns, so every product
// runs in the tile routine at the CUDA cores' (float32) or the FP64
// tensor cores' (float64) rate.
//
// Contract (the solver's factor_ok test depends on it, ops/kkt.py):
//   * the output is the lower factor with a zero strict upper triangle;
//   * a non-SPD input gives NaN (sqrt of a negative pivot) or a
//     non-positive value on the diagonal: there is no early exit; the
//     pivot is the IEEE round-to-nearest sqrt and the column is scaled by
//     the reciprocal square root (intrinsics that no fast-math flag
//     changes); a NaN reaches every later block;
//   * no atomics: every output element is written by one thread in a
//     fixed order, so results are the same from run to run.
//
// Interface: plain C functions, one per dtype, that launch on the given
// stream and return the CUDA error (0 on success).  Built by
// madqp_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "syrk_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NB = 64;  // block-column width (diagonal block size)
constexpr int MAX_CTAS_PER_SM = 2;

// K1's tiles: those of K8, NB x NB, at two CTAs per SM (the grid has at
// most two per SM, and the diagonal factor needs the registers).
template <typename T>
struct K1Tile;
template <>
struct K1Tile<float> : madqp::F32Tile<2> {};
template <>
struct K1Tile<double> : madqp::F64Tile<2> {};

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float rsqrt_of(float x) { return __frsqrt_rn(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }

constexpr int SB = 16;     // sub-block of the diagonal factor, one warp's
constexpr int P = NB + 1;  // shared-memory row pitch of the diagonal block

template <typename T>
constexpr int smem_bytes() {
  constexpr int diag = 2 * NB * P * (int)sizeof(T);
  constexpr int ring = madqp::ring_bytes<K1Tile<T>>();
  return ring > diag ? ring : diag;
}

// Factor and invert one SB x SB diagonal sub-block at (c0, c0) of s, in
// one warp: lane r (and its twin r + 16) holds row r in registers, v of
// the factor and w of the inverse.  Column sweep k = 0 .. SB - 1 of the
// reference: pivot p = sqrt(d), d = v[k] of lane k; v[k] and row k of w
// times rsqrt(d) = 1 / p (a multiply where the reference divides: one
// rounding more, and no division on the serial chain of pivots); then
// v[j] -= l_rk l_jk (r >= j > k) and w[c] -= l_rk w_k[c] (r > k, c <= k),
// the other lanes' values by shuffle.  Writes the factor over s and the
// inverse into x (lower triangles).
template <typename T>
__device__ void factor_sub_block(T* s, T* x, int c0) {
  const int lane = threadIdx.x & 31;
  const int r = lane & (SB - 1);
  constexpr unsigned FULL = 0xffffffffu;
  T v[SB], w[SB];
#pragma unroll
  for (int c = 0; c < SB; ++c) {
    v[c] = (c <= r) ? s[(c0 + r) * P + c0 + c] : T(0);
    w[c] = (c == r) ? T(1) : T(0);
  }
#pragma unroll
  for (int k = 0; k < SB; ++k) {
    const T d = __shfl_sync(FULL, v[k], k);
    const T rp = rsqrt_of(d);  // 1 / p, off the chain of a division
    const T lk = (r > k) ? v[k] * rp : (r == k ? sqrt_rn(d) : v[k]);
    v[k] = lk;
#pragma unroll
    for (int c = 0; c <= k; ++c) w[c] = (r == k) ? w[c] * rp : w[c];
#pragma unroll
    for (int j = k + 1; j < SB; ++j) {
      const T ljk = __shfl_sync(FULL, lk, j);
      v[j] = (r >= j) ? v[j] - lk * ljk : v[j];
    }
#pragma unroll
    for (int c = 0; c <= k; ++c) {
      const T xkc = __shfl_sync(FULL, w[c], k);
      w[c] = (r > k) ? w[c] - lk * xkc : w[c];
    }
  }
  if (lane < SB) {
#pragma unroll
    for (int c = 0; c < SB; ++c) {
      if (c <= r) {
        s[(c0 + r) * P + c0 + c] = v[c];
        x[(c0 + r) * P + c0 + c] = w[c];
      }
    }
  }
}

// Factor the jb x jb diagonal block at (j0, j0) of src (row stride n; its
// lower triangle is read) into L, and write its inverse to Dinv (NB x NB,
// zero outside the lower jb x jb triangle).  Rows and columns past jb are
// the identity while it runs, so they stay out of the arithmetic.
// Right-looking over SB-column sub-blocks, in shared memory (s the factor
// in place, x the inverse):
//   a. one warp factors and inverts the sub-block (factor_sub_block);
//   b. the panel below it becomes P D^-T, every thread one element;
//   c. the trailing block loses the panel's product, lower half only;
// then the off-diagonal blocks of the inverse by block forward
// substitution, X_IJ = -X_II sum_{J <= Q < I} L_IQ X_QJ, block row by
// block row.  Products are taken in a fixed order and every output is
// written by one thread.  Every thread of one CTA calls it; smem holds
// 2 NB (NB + 1) elements.
template <typename T>
__device__ void factor_diag(const T* src, T* L, T* Dinv, int n, int j0,
                            int jb, T* smem) {
  constexpr int THREADS = K1Tile<T>::THREADS;
  constexpr int ITEMS = (NB - SB) * SB / THREADS;  // panel elements per thread
  static_assert(ITEMS * THREADS == (NB - SB) * SB, "whole items");
  T* s = smem;
  T* x = smem + NB * P;
  for (int e = threadIdx.x; e < NB * NB; e += THREADS) {
    const int i = e / NB, j = e % NB;
    s[i * P + j] = (i < jb && j <= i) ? src[(size_t)(j0 + i) * n + j0 + j]
                                      : (i == j ? T(1) : T(0));
    x[i * P + j] = T(0);
  }
  __syncthreads();
  for (int c0 = 0; c0 < NB; c0 += SB) {
    const int c1 = c0 + SB;
    const int below = NB - c1;
    if (threadIdx.x < 32) factor_sub_block<T>(s, x, c0);
    __syncthreads();
    // b. s[i][c0 + j] = sum_{l <= j} s[i][c0 + l] x[c0 + j][c0 + l], i >= c1
    T pv[ITEMS];
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int e = threadIdx.x + t * THREADS;
      const int i = c1 + e / SB, j = e % SB;
      T acc = T(0);
      if (e < below * SB) {
#pragma unroll
        for (int l = 0; l < SB; ++l)
          if (l <= j) acc += s[i * P + c0 + l] * x[(c0 + j) * P + c0 + l];
      }
      pv[t] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int e = threadIdx.x + t * THREADS;
      if (e < below * SB) s[(c1 + e / SB) * P + c0 + e % SB] = pv[t];
    }
    __syncthreads();
    // c. s[i][j] -= sum_l s[i][c0 + l] s[j][c0 + l], c1 <= j <= i
    for (int e = threadIdx.x; e < below * below; e += THREADS) {
      const int i = c1 + e / below, j = c1 + e % below;
      if (j > i) continue;
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < SB; ++l) acc += s[i * P + c0 + l] * s[j * P + c0 + l];
      s[i * P + j] -= acc;
    }
    __syncthreads();
  }
  // Off-diagonal blocks of the inverse, block row I = 1 .. NB / SB - 1:
  // first T_J = sum_{J <= Q < I} L_IQ X_QJ into x's block (I, J), then
  // X_IJ = -X_II T_J.
  for (int I = 1; I < NB / SB; ++I) {
    const int r0 = I * SB;
    // element e: row r0 + e % SB, column e / SB (of block J = e / SB^2)
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int e = threadIdx.x + t * THREADS;
      const int i = r0 + e % SB, c = e / SB;
      if (e < r0 * SB) {
        T acc = T(0);
        for (int q0 = (c / SB) * SB; q0 < r0; q0 += SB) {
#pragma unroll
          for (int q = q0; q < q0 + SB; ++q) acc += s[i * P + q] * x[q * P + c];
        }
        x[i * P + c] = acc;
      }
    }
    __syncthreads();
    T pv[ITEMS];
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int e = threadIdx.x + t * THREADS;
      const int i = r0 + e % SB, c = e / SB;
      T acc = T(0);
      if (e < r0 * SB) {
#pragma unroll
        for (int q = 0; q < SB; ++q)
          if (r0 + q <= i) acc += x[i * P + r0 + q] * x[(r0 + q) * P + c];
      }
      pv[t] = -acc;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int e = threadIdx.x + t * THREADS;
      if (e < r0 * SB) x[(r0 + e % SB) * P + e / SB] = pv[t];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < NB * NB; e += THREADS) {
    const int i = e / NB, j = e % NB;
    const bool low = i < jb && j <= i;
    if (i < jb && j < jb) L[(size_t)(j0 + i) * n + j0 + j] = low ? s[i * P + j] : T(0);
    Dinv[e] = low ? x[i * P + j] : T(0);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(K1Tile<T>::THREADS, K1Tile<T>::MIN_CTAS)
madqp_cholesky_kernel(const T* __restrict__ A, T* L, T* Dinv, int n) {
  using TC = K1Tile<T>;
  constexpr int BM = TC::BM;
  static_assert(BM == NB, "trailing tile 0 holds the next diagonal block");
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  // 0. L = tril(A) outside the first diagonal block; CTA 0 factors that.
  const int jb0 = n < NB ? n : NB;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const size_t row = (size_t)i * n;
    for (int j = (i < jb0 ? jb0 : 0) + threadIdx.x; j < n; j += TC::THREADS)
      L[row + j] = (j <= i) ? A[row + j] : T(0);
  }
  if (blockIdx.x == 0) factor_diag<T>(A, L, Dinv, n, 0, jb0, smem);
  grid.sync();

  for (int j0 = 0; j0 + NB < n; j0 += NB) {
    const int j1 = j0 + NB;
    const int rem = n - j1;
    const int tiles = (rem + BM - 1) / BM;
    T* X = L + (size_t)j1 * n + j0;  // rem x NB, row stride n

    // 1. X = P L_D^-T in place: X[i][j] = sum_l P[i][l] Dinv[j][l].
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      typename TC::Acc acc;
      madqp::zero(acc);
      T* Pt = X + (size_t)t * BM * n;
      madqp::tile_product<K1Tile<T>>(acc, smem, Pt, n, rem - t * BM, Dinv, NB, NB, NB);
      madqp::for_each(acc, [&](int i, int j, T v) {
        if (t * BM + i < rem && j < NB) Pt[(size_t)i * n + j] = v;
      });
    }
    grid.sync();

    // 2. L[j1:, j1:] -= X X^T on and below the diagonal; then CTA 0
    //    factors the next diagonal block, inside its tile 0.
    const int ntri = tiles * (tiles + 1) / 2;
    for (int t = blockIdx.x; t < ntri; t += gridDim.x) {
      int I, J;
      madqp::lower_tile(t, I, J);
      typename TC::Acc acc;
      madqp::zero(acc);
      madqp::tile_product<K1Tile<T>>(acc, smem, X + (size_t)I * BM * n, n, rem - I * BM,
                             X + (size_t)J * BM * n, n, rem - J * BM, NB);
      T* Ct = L + (size_t)(j1 + I * BM) * n + j1 + J * BM;
      madqp::for_each(acc, [&](int i, int j, T v) {
        const int gi = I * BM + i, gj = J * BM + j;
        if (gi < rem && gj <= gi) Ct[(size_t)i * n + j] -= v;
      });
      if (t == 0) {
        __syncthreads();  // the tile's stores are visible to the whole CTA
        factor_diag<T>(L, L, Dinv, n, j1, rem < NB ? rem : NB, smem);
      }
    }
    grid.sync();
  }
}

template <typename T>
int cholesky_lower(const T* A, T* L, T* Dinv, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int BM = K1Tile<T>::BM;
  constexpr int THREADS = K1Tile<T>::THREADS;
  constexpr int smem = smem_bytes<T>();
  auto kernel = madqp_cholesky_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > MAX_CTAS_PER_SM) per_sm = MAX_CTAS_PER_SM;
  // No more CTAs than the largest phase has tiles (the first trailing
  // update): a smaller grid reaches its barriers sooner.
  const long long t0 = (n > NB ? n - NB + BM - 1 : 0) / BM;
  long long grid = t0 * (t0 + 1) / 2;
  if (grid < 1) grid = 1;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  void* args[] = {(void*)&A, (void*)&L, (void*)&Dinv, (void*)&n};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3((unsigned)grid),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Dinv: NB x NB scratch of the same dtype (madqp_cholesky_block_size()).
extern "C" int madqp_cholesky_lower_f32(const void* A, void* L, void* Dinv,
                                        int n, void* stream) {
  return cholesky_lower<float>(static_cast<const float*>(A),
                               static_cast<float*>(L),
                               static_cast<float*>(Dinv), n,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int madqp_cholesky_lower_f64(const void* A, void* L, void* Dinv,
                                        int n, void* stream) {
  return cholesky_lower<double>(static_cast<const double*>(A),
                                static_cast<double*>(L),
                                static_cast<double*>(Dinv), n,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int madqp_cholesky_block_size() { return NB; }
