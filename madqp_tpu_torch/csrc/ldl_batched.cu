// K2-batched: the no-pivot signed LDL^T of every matrix of a stack of small
// symmetric matrices, hand-written for Hopper.
//
// Replaces the XLA-built madqp_tpu/ops/blocked_dense.py::unblocked_ldl /
// blocked_ldl (:37, :342), which the JAX package reaches through
// madqp_tpu/ops/sparse_chol.py::dense_ldl (:1306) for every front of the
// signed supernodal factorization (factorize_batched_ldl: the augmented K2
// system of solve_sparse_qp, the float32 phases of the normal-equations and
// condensed paths).  No Pallas kernel computed it.  Every stack is one
// launch.
//
// Function: F = L D L^T for each (n, n) matrix of the stack, only F's lower
// triangle read; L unit lower with a zero strict upper triangle, d the
// pivots.  With signs s (one per column) and floor > 0 each pivot becomes
// d_j <- s_j max(s_j d_j, floor) before it is used (a NaN pivot stays NaN),
// the rule of unblocked_ldl.  Without them a pivot is used as it comes: a
// pivot of the wrong sign is kept, and a zero pivot makes inf or NaN in its
// own matrix only (the caller's factor_ok_batched_ldl reads both from d).
//
// What bounds it: a 128^2 float64 matrix is 128 KB of input and 128 KB of
// output and n^3 / 3 operations, ~0.06 ms of bytes for a stack of 1024 on
// the H100; what a matrix takes alone is the dependent chain of its n
// pivots, each a shuffle, a reciprocal and a multiply-add.  So the design
// keeps that chain on one warp with as little else in its way as it can,
// gives the rest of the work to the other warps, and fits several matrices
// on each SM so that their chains overlap.  Two tiers, one launch per stack:
//
//   * n <= 32, registers (madqp_ldl_batched_regs_kernel<T, N>, N = 8, 16 or
//     32 the least that holds n): one group of N lanes per matrix, 32 / N
//     matrices per warp.  Lane r holds row r in N registers (rows past n
//     are the identity).  Step k: every lane reads the pivot a_kk from lane
//     k by __shfl_sync (and the sign s_k, and applies the floor), the lanes
//     below divide their own a_rk by it, and a_rj -= (d_k l_rk) l_jk for
//     k < j <= r, l_jk by shuffle from lane j.  Lane r keeps d_r in row[r].
//   * 32 < n <= 128, shared memory (madqp_ldl_batched_shared_kernel<T,
//     FLOOR>): one CTA per matrix, of 7 warps in float64 and 4 in float32,
//     the launch bounds asking for 2 (float64) or 4 (float32) CTAs on each
//     SM (at most 146 or 128 registers a thread).  Only the lower triangle
//     is kept, as the nb (nb + 1) / 2 tiles of 32 x 32 of the lower block
//     triangle (nb = ceil(n / 32)), row pitch 36: 92 KB in float64 and
//     46 KB in float32 at n = 128, with the pivots' reciprocals and the
//     signs.  The tiles are filled by cp.async, 16 bytes a copy where the
//     row stride and the address allow it (else one element), the strict
//     upper triangle and the rows past n zero-filled by the copy itself;
//     warp 0 copies the first diagonal tile and starts on it while the
//     other warps ("the team") copy the rest and write L's zero upper
//     triangle.  The panel's z = L21 D is kept in place of L21: where the
//     trailing update needs L21 it scales z by 1 / d as it reads it, and
//     L21 = z (1 / d) goes to L as soon as z is known.  Block step k
//     (c0 = 32 k), named barriers between warp 0 and the team:
//       a. warp 0 loads the diagonal tile (k, k) into registers, a row per
//          lane (the identity past n), and sweeps it: every lane forms
//          1 / d_k (IEEE division) and l_rk = z_rk (1 / d_k), then
//          a_rj -= l_rk z_jk, z_jk by shuffle (sweep_tile: no per-lane
//          test and no branch between the 32 steps, so the compiler
//          overlaps them); it writes L_D's rows and d to L and D, L_D^T
//          into the tile and the reciprocals beside it;   bar FACTOR (all
//          threads: the team's step k - 1 is also done);
//       b. warp 0 solves z L_D^T = p for the 32 rows of tile k + 1 (the
//          next diagonal tile's) by forward substitution, a row per lane in
//          registers, L_D^T read 16 bytes at a time (broadcast), writes z
//          over p and L21 = z (1 / d) to L;   bar PANEL (warp 0 arrives,
//          the team waits);
//       c. warps 1-3 update the three lower 16 x 16 quarters of the next
//          diagonal tile and arrive at bar DIAG, which warp 0 waits on
//          before step a of block k + 1: the look-ahead, the next diagonal
//          factor runs while the team finishes block k.  The team then
//          solves the panel rows below tile k + 1 (a row a thread, the
//          helpers' threads last), meets at bar TEAM, and deals the other
//          tiles of the trailing update A_IJ -= L21_I z_J^T round its
//          warps.  Each warp owns a block of the tile in registers and
//          reads every operand fragment once per block: float64 on the
//          FP64 tensor cores (DMMA m16n8k8, csrc/syrk_tile.cuh::dmma),
//          16 x 16 or 16 x 32 blocks; float32 on FFMA register blocks
//          (2 x 4 or 4 x 8 a lane, 16-byte operand reads), no TF32.  The
//          sum over the 32 columns is formed first and then subtracted, as
//          the plain version does.
//     No CTA-wide __syncthreads; the team's work of block k ends inside
//     warp 0's factor of block k + 1, so bar FACTOR rarely waits
//     (tools/ldl_parts_torch.py times each part and the kernel's timeline
//     through the LDL_STAMP hooks).
//
// Above 128 the wrapper raises.  No atomics: every output element is written
// by one thread in a fixed order, so two runs give the same bits.  The
// scalar products contract a - b c into one FMA; the plain version
// (ops/ldl_batched.py::ldl_batched_reference) follows the same blocking,
// pivot arithmetic and scaling in torch ops.
//
// Interface: plain C functions that launch on the given stream and return
// the CUDA error (0 on success).  F is read through a batch stride and a row
// stride (its columns contiguous), so a front stack's leading blocks need no
// copy; L (batch, n, n), d and the signs (batch, n) are contiguous.
// madqp_ldl_batched_occupancy reports the shared tier's CTAs per SM.  Built
// by madqp_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v

#include <cstdint>
#include <cuda_runtime.h>

#include "syrk_tile.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_THREADS = 64;  // register tier: two warps per CTA
constexpr int BLK = 32;          // block-column width (tile order) of the shared tier
constexpr int MAX_N = 128;       // largest order (the supernodal fronts' w_pad)
constexpr int MAX_NB = MAX_N / BLK;
constexpr int TP = BLK + 4;      // a tile's row pitch, elements
constexpr int WARPS_F64 = 7;     // shared tier: warps of a CTA (one matrix each)
constexpr int WARPS_F32 = 4;
constexpr int CTAS_F64 = 2;      // shared tier: CTAs per SM of the launch bounds
constexpr int CTAS_F32 = 4;
constexpr int HELPERS = 3;       // warps 1-3 update the next diagonal tile
// Timeline hooks of the shared kernel: tools/ldl_parts_torch.py's source
// defines LDL_STAMP(cond, slot) to record the clock of warp 0 and warp 1 at
// these points; here they compile to nothing.
#ifndef LDL_STAMP
#define LDL_STAMP(cond, slot)
#endif
// Named barriers (0 is __syncthreads').
constexpr int BAR_FACTOR = 1;    // all threads: a diagonal tile is factored
constexpr int BAR_PANEL = 2;     // all threads: the panel's z is in place
constexpr int BAR_DIAG = 3;      // warp 0 and the helpers: the next diagonal tile
constexpr int BAR_LOAD = 4;      // all threads: the first diagonal tile has landed
constexpr int BAR_TEAM = 5;      // the team: its panel rows are in place

// The pivot with the sign-directed floor: s max(s d, floor), a NaN kept.
template <typename T>
__device__ __forceinline__ T floored(T d, T s, T floor) {
  const T v = s * d;
  return s * ((v < floor) ? floor : v);
}

// LDL^T of the order-m matrix (m <= N, the same in every group of the warp)
// whose row r lane r of a group of N lanes holds in `row`; rows past m are
// the identity, and steps past m are skipped.  `sg` is lane r's column sign
// (used with use_floor).  On return row[j] = l_rj for j < r and row[r] = d_r.
// All 32 lanes of the warp call it (groups of N lanes shuffle among
// themselves).
template <typename T, int N>
__device__ __forceinline__ void ldl_rows(T (&row)[N], int r, int m, T sg, T floor,
                                         bool use_floor) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k >= m) break;
    T d = __shfl_sync(FULL, row[k], k, N);
    if (use_floor) d = floored(d, __shfl_sync(FULL, sg, k, N), floor);
    const T l = row[k] / d;
    row[k] = (r > k) ? l : (r == k ? d : row[k]);
    const T dl = d * l;
#pragma unroll
    for (int j = k + 1; j < N; ++j) {
      const T lj = __shfl_sync(FULL, l, j, N);
      row[j] = (r >= j) ? row[j] - dl * lj : row[j];
    }
  }
}

// The shared tier's sweep of a diagonal tile (lane r holds row r, the
// identity past the matrix's order): every lane forms 1 / d_k (IEEE
// division) and l_rk = z_rk (1 / d_k), then a_rj -= l_rk z_jk for every
// j > k, z_jk = a_jk by shuffle from lane j, which needs no result of step
// k, so the shuffles run beside the division.  Lanes update their strict
// upper part too, and a partial last tile takes all 32 steps (its rows
// past the order are the identity): neither reaches a lower element of a
// real row, and a select per element, or a test per step, cost more than
// the multiply-add (a branch between steps stops the compiler from
// overlapping them).  The loop unrolls, so `row` stays in registers.  On
// return row[j] = l_rj for j < r, and dr, rr hold lane r's pivot and its
// reciprocal.
template <typename T, bool FLOOR>
__device__ __forceinline__ void sweep_tile(T (&row)[BLK], int r, T sg, T floor, T& dr, T& rr) {
#pragma unroll
  for (int k = 0; k < BLK; ++k) {
    const T z = row[k];
    T d = __shfl_sync(FULL, z, k);
    if (FLOOR) d = floored(d, __shfl_sync(FULL, sg, k), floor);
    const T ri = T(1) / d;
    const T l = z * ri;
    dr = r == k ? d : dr;
    rr = r == k ? ri : rr;
    row[k] = l;
#pragma unroll
    for (int j = k + 1; j < BLK; ++j) row[j] -= l * __shfl_sync(FULL, z, j);
  }
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using V = float4;
  static constexpr int W = 4;
  __device__ static void put(float* d, const float4& v) {
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  __device__ static float4 get(const float* s) { return make_float4(s[0], s[1], s[2], s[3]); }
};
template <>
struct Vec<double> {
  using V = double2;
  static constexpr int W = 2;
  __device__ static void put(double* d, const double2& v) { d[0] = v.x; d[1] = v.y; }
  __device__ static double2 get(const double* s) { return make_double2(s[0], s[1]); }
};

template <typename T, int N>
__global__ void __launch_bounds__(REG_THREADS)
madqp_ldl_batched_regs_kernel(const T* __restrict__ F, T* __restrict__ L, T* __restrict__ D,
                              const T* __restrict__ sgn, T floor, int batch, int n,
                              long long sb, long long sr) {
  constexpr int G = 32 / N;  // matrices per warp
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (REG_THREADS / 32) + (threadIdx.x >> 5);
  if (warp * G >= batch) return;  // the whole warp has no matrix
  const int r = lane & (N - 1);
  const long long m = warp * G + lane / N;
  const bool live = m < batch && r < n;
  const long long mm = m < batch ? m : 0;
  const T* a = F + mm * sb + (long long)r * sr;

  T row[N];
#pragma unroll
  for (int c = 0; c < N; ++c)
    row[c] = live ? ((c <= r) ? a[c] : T(0)) : (c == r ? T(1) : T(0));
  const bool use_floor = sgn != nullptr;
  const T sg = (use_floor && live) ? sgn[mm * n + r] : T(1);

  ldl_rows<T, N>(row, r, n, sg, floor, use_floor);

  if (!live) return;
  T* l = L + (size_t)mm * n * n + (size_t)r * n;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (c < n) l[c] = (c < r) ? row[c] : (c == r ? T(1) : T(0));
  D[mm * n + r] = row[r];
}

// --- the shared tier -------------------------------------------------------

template <typename T>
struct Team;
template <>
struct Team<double> {
  static constexpr int WARPS = WARPS_F64;
  static constexpr int CTAS = CTAS_F64;
  static constexpr int FULL_MF = 1;  // a full tile is two 16 x 32 blocks
};
template <>
struct Team<float> {
  static constexpr int WARPS = WARPS_F32;
  static constexpr int CTAS = CTAS_F32;
  static constexpr int FULL_MF = 2;  // a full tile is one 32 x 32 block
};

__host__ __device__ constexpr int tiles_of(int nb) { return nb * (nb + 1) / 2; }
// Tile (I, J), J <= I, of the lower block triangle, row by row.
__host__ __device__ constexpr int tile_at(int I, int J) { return I * (I + 1) / 2 + J; }

// The tiles, then the pivots' reciprocals and the signs (nb * BLK each).
template <typename T>
__host__ __device__ constexpr size_t shared_bytes(int nb) {
  return ((size_t)tiles_of(nb) * BLK * TP + 2 * (size_t)nb * BLK) * sizeof(T);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrive without waiting; the fence makes this thread's shared-memory
// writes visible to the threads that wait on the barrier.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  __threadfence_block();
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Copy tiles t_begin .. t_end - 1 of the lower triangle of the matrix at `a`
// (row stride sr) into shared memory with cp.async (thread tid of
// `threads`), 16-byte copies when `a` and the row stride allow; the strict
// upper triangle and the rows past n are zero-filled.
template <typename T>
__device__ __forceinline__ void load_lower(T* tiles, const T* a, long long sr, int n,
                                           int t_begin, int t_end, int tid, int threads) {
  constexpr int W = Vec<T>::W;
  constexpr int CPR = BLK / W;  // 16-byte chunks per tile row
  const bool vec = (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
                   (sr * (long long)sizeof(T)) % 16 == 0;
  for (int e = t_begin * BLK * CPR + tid; e < t_end * BLK * CPR; e += threads) {
    const int t = e / (BLK * CPR);
    const int rem = e - t * (BLK * CPR);
    const int rr = rem / CPR;
    const int ch = rem - rr * CPR;
    int I = 0;
    while (tile_at(I + 1, 0) <= t) ++I;
    const int i = I * BLK + rr;
    const int j0 = (t - tile_at(I, 0)) * BLK + ch * W;
    const int hi = i < n ? (i + 1 < n ? i + 1 : n) : 0;  // the row's columns j < hi
    const int valid = hi - j0 < 0 ? 0 : (hi - j0 > W ? W : hi - j0);
    T* dst = tiles + ((size_t)t * BLK + rr) * TP + ch * W;
    const T* src = a + (long long)i * sr + j0;
    if (vec) {
      madqp::cp_async_16(dst, valid > 0 ? src : a, valid * (int)sizeof(T));
    } else {
#pragma unroll
      for (int u = 0; u < W; ++u)
        madqp::cp_async_1<(int)sizeof(T)>(dst + u, u < valid ? src + u : a,
                                          u < valid ? (int)sizeof(T) : 0);
    }
  }
}

// L's strict upper block triangle (tiles (I, J), J > I) is zero (thread tid
// of `threads`).
template <typename T>
__device__ __forceinline__ void zero_upper(T* l, int n, bool vst, int tid, int threads) {
  using V = typename Vec<T>::V;
  constexpr int W = Vec<T>::W;
  if (vst) {
    const int cpr = n / W;
    for (int e = tid; e < n * cpr; e += threads) {
      const int i = e / cpr;
      const int j = (e - i * cpr) * W;
      if (j >= (i / BLK + 1) * BLK) {
        T z[W] = {};
        *reinterpret_cast<V*>(l + (size_t)i * n + j) = Vec<T>::get(z);
      }
    }
  } else {
    for (int e = tid; e < n * n; e += threads) {
      const int i = e / n;
      if (e - i * n >= (i / BLK + 1) * BLK) l[e] = T(0);
    }
  }
}

// Step a: warp 0 factors the diagonal tile (k, k); writes L_D's rows and d
// to L and D, L_D^T into the tile, 1 / d into rinv.
template <typename T, bool FLOOR>
__device__ __forceinline__ void factor_diag(T* tiles, T* rinv, const T* sg, T* l, T* dout,
                                            int n, int k, T floor, bool vst, int lane) {
  using VT = Vec<T>;
  using V = typename VT::V;
  constexpr int W = VT::W;
  const int c0 = k * BLK;
  const int jb = n - c0 < BLK ? n - c0 : BLK;
  T* tk = tiles + (size_t)tile_at(k, k) * BLK * TP;
  T row[BLK];
#pragma unroll
  for (int c = 0; c < BLK / W; ++c) {
    T v[W];
    VT::put(v, *reinterpret_cast<const V*>(tk + lane * TP + c * W));
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const int j = c * W + t;
      row[j] = lane < jb ? (j <= lane ? v[t] : T(0)) : (j == lane ? T(1) : T(0));
    }
  }
  const T sgr = (FLOOR && lane < jb) ? sg[c0 + lane] : T(1);
  T dr = T(1), rr = T(1);
  sweep_tile<T, FLOOR>(row, lane, sgr, floor, dr, rr);
  rinv[c0 + lane] = rr;
#pragma unroll
  for (int j = 0; j < BLK - 1; ++j)
    if (j < lane) tk[j * TP + lane] = row[j];
  if (lane < jb) {
    T* lr = l + (size_t)(c0 + lane) * n + c0;
    if (vst) {
#pragma unroll
      for (int c = 0; c < BLK / W; ++c) {
        if (c * W < jb) {
          T v[W];
#pragma unroll
          for (int t = 0; t < W; ++t) {
            const int j = c * W + t;
            v[t] = j < lane ? row[j] : (j == lane ? T(1) : T(0));
          }
          *reinterpret_cast<V*>(lr + c * W) = VT::get(v);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BLK; ++j)
        if (j < jb) lr[j] = j < lane ? row[j] : (j == lane ? T(1) : T(0));
    }
    dout[c0 + lane] = dr;
  }
}

// Step b for one row: p (the row of tile (I, k) at `prow`) becomes z with
// z L_D^T = p (lt: tile (k, k), holding L_D^T); the row of L21 = z (1 / d)
// goes to `lrow` (L's row at column c0; null for a row past n).
template <typename T>
__device__ __forceinline__ void panel_row(T* prow, const T* lt, const T* rk, T* lrow,
                                          bool vst) {
  using VT = Vec<T>;
  using V = typename VT::V;
  constexpr int W = VT::W;
  T x[BLK];
#pragma unroll
  for (int c = 0; c < BLK / W; ++c)
    VT::put(x + c * W, *reinterpret_cast<const V*>(prow + c * W));
#pragma unroll
  for (int j = 0; j < BLK - 1; ++j) {
#pragma unroll
    for (int c = (j + 1) / W; c < BLK / W; ++c) {
      T u[W];
      VT::put(u, *reinterpret_cast<const V*>(lt + j * TP + c * W));
#pragma unroll
      for (int t = 0; t < W; ++t)
        if (c * W + t > j) x[c * W + t] -= x[j] * u[t];
    }
  }
#pragma unroll
  for (int c = 0; c < BLK / W; ++c)
    *reinterpret_cast<V*>(prow + c * W) = VT::get(x + c * W);
  if (lrow == nullptr) return;
#pragma unroll
  for (int c = 0; c < BLK / W; ++c) {
    T s[W], v[W];
    VT::put(s, *reinterpret_cast<const V*>(rk + c * W));
#pragma unroll
    for (int t = 0; t < W; ++t) v[t] = x[c * W + t] * s[t];
    if (vst) {
      *reinterpret_cast<V*>(lrow + c * W) = VT::get(v);
    } else {
#pragma unroll
      for (int t = 0; t < W; ++t) lrow[c * W + t] = v[t];
    }
  }
}

// Step c for one warp: C -= (A diag(rk)) B^T on the (16 MF) x (8 NF) block at
// row r0 and column c0 of the tiles C, A (rows r0..) and B (rows c0..), the
// sum over the BLK columns of A and B formed first.  float64: DMMA
// m16n8k8 fragments, lane (g, t) = (lane / 4, lane % 4).
template <int MF, int NF>
__device__ __forceinline__ void warp_update(double* C, const double* A, const double* B,
                                            const double* rk, int r0, int c0, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  double acc[MF][NF][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][nf][i] = 0.0;
#pragma unroll
  for (int k8 = 0; k8 < BLK; k8 += 8) {
    const double s[2] = {rk[k8 + t], rk[k8 + t + 4]};
    double a[MF][4], b[NF][2];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[mf][i] = A[(r0 + 16 * mf + g + 8 * (i & 1)) * TP + k8 + t + 4 * (i >> 1)] *
                   s[i >> 1];
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 2; ++i) b[nf][i] = B[(c0 + 8 * nf + g) * TP + k8 + t + 4 * i];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) madqp::dmma(acc[mf][nf], a[mf], b[nf]);
  }
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        C[(r0 + 16 * mf + g + 8 * (i >> 1)) * TP + c0 + 8 * nf + 2 * t + (i & 1)] -=
            acc[mf][nf][i];
}

// float32: lane (g, t) holds rows r0 + g + 8 p (p < 2 MF) and columns
// c0 + t + 4 q (q < 2 NF); operands read 16 bytes at a time; every sum an
// FMA chain over the columns in order.
template <int MF, int NF>
__device__ __forceinline__ void warp_update(float* C, const float* A, const float* B,
                                            const float* rk, int r0, int c0, int lane) {
  constexpr int PR = 2 * MF;
  constexpr int PC = 2 * NF;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[PR][PC];
#pragma unroll
  for (int p = 0; p < PR; ++p)
#pragma unroll
    for (int q = 0; q < PC; ++q) acc[p][q] = 0.0f;
#pragma unroll
  for (int k4 = 0; k4 < BLK; k4 += 4) {
    const float4 s = *reinterpret_cast<const float4*>(rk + k4);
    float4 a[PR];
#pragma unroll
    for (int p = 0; p < PR; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(A + (r0 + g + 8 * p) * TP + k4);
      a[p] = make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
    }
#pragma unroll
    for (int q = 0; q < PC; ++q) {
      const float4 b = *reinterpret_cast<const float4*>(B + (c0 + t + 4 * q) * TP + k4);
#pragma unroll
      for (int p = 0; p < PR; ++p) {
        acc[p][q] = __fmaf_rn(a[p].x, b.x, acc[p][q]);
        acc[p][q] = __fmaf_rn(a[p].y, b.y, acc[p][q]);
        acc[p][q] = __fmaf_rn(a[p].z, b.z, acc[p][q]);
        acc[p][q] = __fmaf_rn(a[p].w, b.w, acc[p][q]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PR; ++p)
#pragma unroll
    for (int q = 0; q < PC; ++q) C[(r0 + g + 8 * p) * TP + c0 + t + 4 * q] -= acc[p][q];
}

// Step c for team warp tw, after the next diagonal tile's quarters: the
// tiles (I, J), k + 1 <= J <= I, I > k + 1, dealt round the team in blocks
// of 16 (float64) or 32 (float32) rows, the helpers' share after theirs.
template <typename T>
__device__ __forceinline__ void team_update(T* tiles, const T* rk, int nb, int k, int tw,
                                            int lane) {
  constexpr int TEAM = Team<T>::WARPS - 1;
  constexpr int FMF = Team<T>::FULL_MF;
  constexpr int TILE = BLK * TP;
  int e = HELPERS;
  for (int I = k + 2; I < nb; ++I)
    for (int J = k + 1; J <= I; ++J)
      for (int r0 = 0; r0 < BLK; r0 += 16 * FMF, ++e)
        if (e % TEAM == tw)
          warp_update<FMF, 4>(tiles + (size_t)tile_at(I, J) * TILE,
                              tiles + (size_t)tile_at(I, k) * TILE,
                              tiles + (size_t)tile_at(J, k) * TILE, rk, r0, 0, lane);
}

template <typename T, bool FLOOR>
__global__ void __launch_bounds__(Team<T>::WARPS * 32, Team<T>::CTAS)
madqp_ldl_batched_shared_kernel(const T* __restrict__ F, T* __restrict__ L, T* __restrict__ D,
                                const T* __restrict__ sgn, T floor, int batch, int n,
                                long long sb, long long sr) {
  constexpr int THREADS = Team<T>::WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long m = blockIdx.x;
  if (m >= batch) return;
  const int nb = (n + BLK - 1) / BLK;
  T* tiles = reinterpret_cast<T*>(smem_raw);
  T* rinv = tiles + (size_t)tiles_of(nb) * BLK * TP;
  T* sg = rinv + nb * BLK;
  T* l = L + (size_t)m * n * n;
  T* dout = D + (size_t)m * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool vst = (reinterpret_cast<uintptr_t>(L) & 15) == 0 && (n * sizeof(T)) % 16 == 0;

  // Warp 0 copies the first diagonal tile and starts on it when it lands;
  // the team copies the other tiles while it factors.
  const T* a = F + m * sb;
  LDL_STAMP(warp == 0, 0);
  for (int i = threadIdx.x; i < nb * BLK; i += THREADS)  // sg[0 .. 31]: warp 0's
    sg[i] = (FLOOR && i < n) ? sgn[m * n + i] : T(1);
  if (warp == 0) {
    load_lower<T>(tiles, a, sr, n, 0, 1, lane, 32);
    madqp::cp_async_commit();
    madqp::cp_async_wait<0>();
    __syncwarp();
    bar_arrive(BAR_LOAD, THREADS);
    LDL_STAMP(true, 1);
    for (int k = 0;; ++k) {
      if (k > 0) bar_sync(BAR_DIAG, 32 * (HELPERS + 1));
      LDL_STAMP(true, 2 + 4 * k);
      factor_diag<T, FLOOR>(tiles, rinv, sg, l, dout, n, k, floor, vst, lane);
      LDL_STAMP(true, 3 + 4 * k);
      if (k + 1 == nb) break;
      bar_sync(BAR_FACTOR, THREADS);
      LDL_STAMP(true, 4 + 4 * k);
      const int i = (k + 1) * BLK + lane;
      panel_row<T>(tiles + ((size_t)tile_at(k + 1, k) * BLK + lane) * TP,
                   tiles + (size_t)tile_at(k, k) * BLK * TP, rinv + k * BLK,
                   i < n ? l + (size_t)i * n + k * BLK : nullptr, vst);
      LDL_STAMP(true, 5 + 4 * k);
      bar_arrive(BAR_PANEL, THREADS);
    }
  } else {
    constexpr int TEAM_THREADS = THREADS - 32;
    const int tw = warp - 1;
    const int tt = threadIdx.x - 32;
    bar_sync(BAR_LOAD, THREADS);
    load_lower<T>(tiles, a, sr, n, 1, tiles_of(nb), tt, TEAM_THREADS);
    madqp::cp_async_commit();
    zero_upper<T>(l, n, vst, tt, TEAM_THREADS);
    madqp::cp_async_wait<0>();
    LDL_STAMP(warp == 1, 20);
    for (int k = 0; k + 1 < nb; ++k) {
      bar_sync(BAR_FACTOR, THREADS);
      LDL_STAMP(warp == 1, 21 + 5 * k);
      bar_sync(BAR_PANEL, THREADS);
      LDL_STAMP(warp == 1, 22 + 5 * k);
      const T* rk = rinv + k * BLK;
      if (tw < HELPERS) {  // the next diagonal tile first: warp 0 waits on it
        const T* Z = tiles + (size_t)tile_at(k + 1, k) * BLK * TP;
        warp_update<1, 2>(tiles + (size_t)tile_at(k + 1, k + 1) * BLK * TP, Z, Z, rk,
                          tw == 0 ? 0 : 16, tw == 2 ? 16 : 0, lane);
        bar_arrive(BAR_DIAG, 32 * (HELPERS + 1));
      }
      LDL_STAMP(warp == 1, 23 + 5 * k);
      if (k + 2 < nb) {
        // the rows below tile k + 1, one a thread, the helpers' threads last
        const int pr = (tt + TEAM_THREADS - 32 * HELPERS) % TEAM_THREADS;
        if (pr < (nb - k - 2) * BLK) {
          const int I = k + 2 + pr / BLK;
          const int rr = pr % BLK;
          const int i = I * BLK + rr;
          panel_row<T>(tiles + ((size_t)tile_at(I, k) * BLK + rr) * TP,
                       tiles + (size_t)tile_at(k, k) * BLK * TP, rk,
                       i < n ? l + (size_t)i * n + k * BLK : nullptr, vst);
        }
        LDL_STAMP(warp == 1, 24 + 5 * k);
        bar_sync(BAR_TEAM, TEAM_THREADS);
        team_update<T>(tiles, rk, nb, k, tw, lane);
      }
      LDL_STAMP(warp == 1, 25 + 5 * k);
    }
  }
}

template <typename T, int N>
int launch_regs(const T* F, T* L, T* D, const T* sgn, T floor, int batch, int n,
                long long sb, long long sr, cudaStream_t stream) {
  constexpr int per_cta = (REG_THREADS / 32) * (32 / N);
  const int grid = (int)(((long long)batch + per_cta - 1) / per_cta);
  madqp_ldl_batched_regs_kernel<T, N><<<grid, REG_THREADS, 0, stream>>>(
      F, L, D, sgn, floor, batch, n, sb, sr);
  return (int)cudaGetLastError();
}

// The shared tier's attributes: opt-in shared memory for the largest order,
// and the carveout that leaves the most of it (several CTAs per SM).
template <typename T, bool FLOOR>
cudaError_t shared_attributes() {
  auto kernel = madqp_ldl_batched_shared_kernel<T, FLOOR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared_bytes<T>(MAX_NB));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, bool FLOOR>
int launch_shared(const T* F, T* L, T* D, const T* sgn, T floor, int batch, int n,
                  long long sb, long long sr, cudaStream_t stream) {
  const cudaError_t err = shared_attributes<T, FLOOR>();
  if (err != cudaSuccess) return (int)err;
  const int nb = (n + BLK - 1) / BLK;
  madqp_ldl_batched_shared_kernel<T, FLOOR><<<batch, Team<T>::WARPS * 32, shared_bytes<T>(nb),
                                              stream>>>(F, L, D, sgn, floor, batch, n, sb, sr);
  return (int)cudaGetLastError();
}

template <typename T>
int ldl_batched(const T* F, T* L, T* D, const T* sgn, double floor, int batch, int n,
                long long sb, long long sr, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > MAX_N) return (int)cudaErrorInvalidValue;
  const T fl = (T)floor;
  if (n <= 8) return launch_regs<T, 8>(F, L, D, sgn, fl, batch, n, sb, sr, stream);
  if (n <= 16) return launch_regs<T, 16>(F, L, D, sgn, fl, batch, n, sb, sr, stream);
  if (n <= 32) return launch_regs<T, 32>(F, L, D, sgn, fl, batch, n, sb, sr, stream);
  if (sgn != nullptr) return launch_shared<T, true>(F, L, D, sgn, fl, batch, n, sb, sr, stream);
  return launch_shared<T, false>(F, L, D, sgn, fl, batch, n, sb, sr, stream);
}

template <typename T>
int occupancy(int n) {
  const cudaError_t err = shared_attributes<T, true>();
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  const cudaError_t e2 = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, madqp_ldl_batched_shared_kernel<T, true>, Team<T>::WARPS * 32,
      shared_bytes<T>((n + BLK - 1) / BLK));
  return e2 == cudaSuccess ? blocks : -(int)e2;
}

}  // namespace

// F: (batch, n, n) read at F + b sb + i sr + j (lower triangle only);
// L: contiguous (batch, n, n); D: contiguous (batch, n); sgn: contiguous
// (batch, n) signs, or null for no floor.  n <= 128.
extern "C" int madqp_ldl_batched_f32(const void* F, void* L, void* D, const void* sgn,
                                     double floor, int batch, int n, long long sb,
                                     long long sr, void* stream) {
  return ldl_batched<float>(static_cast<const float*>(F), static_cast<float*>(L),
                            static_cast<float*>(D), static_cast<const float*>(sgn), floor,
                            batch, n, sb, sr, static_cast<cudaStream_t>(stream));
}

extern "C" int madqp_ldl_batched_f64(const void* F, void* L, void* D, const void* sgn,
                                     double floor, int batch, int n, long long sb,
                                     long long sr, void* stream) {
  return ldl_batched<double>(static_cast<const double*>(F), static_cast<double*>(L),
                             static_cast<double*>(D), static_cast<const double*>(sgn),
                             floor, batch, n, sb, sr, static_cast<cudaStream_t>(stream));
}

extern "C" int madqp_ldl_batched_max_n() { return MAX_N; }

// CTAs (one matrix each) of the shared tier that one SM holds at once at
// order n (32 < n <= 128), for elements of element_size bytes (4 or 8); a
// negative CUDA error if the query fails.
extern "C" int madqp_ldl_batched_occupancy(int element_size, int n) {
  return element_size == 8 ? occupancy<double>(n) : occupancy<float>(n);
}
