// The block product acc += B_I B_J^T of one output tile, shared by K8
// (csrc/syrk.cu, the rank-k update) and K1 (csrc/cholesky.cu, whose panel
// solve and trailing update are both such products).
//
// B_I and B_J are strips of rows of row-major matrices with unit column
// stride and any row stride: rows_i (rows_j) valid rows from the strip's
// first row, k valid columns.  The routine walks k in steps of KC columns
// through a STAGES-deep ring of shared memory filled with cp.async: while
// step s is multiplied, steps s + 1 .. s + STAGES - 1 are in flight.  A copy
// is 16 bytes where the strip's address and row stride allow it (VEC
// elements), else one element; lanes outside the valid rows or columns are
// zero-filled by the copy itself (cp.async's src-size operand), a select,
// never a multiply, so a NaN outside the valid block never enters a sum and
// a NaN inside it reaches every sum it belongs to.
//
// float32: the CUDA cores, no TF32 (the float32 factorization's single
// refinement step needs full-f32 products).  A 64 x 64 tile over 256
// threads, each with a 4 x 4 register block on rows ty + 16 p and columns
// tx + 16 q, so a warp's shared-memory reads are broadcasts (rows) or hit
// 8 distinct bank groups per 128-bit phase (columns; the row pitch LD = 20
// words makes that so).  Accumulation order: every sum is one __fmaf_rn
// chain over l = 0, 1, ..., k - 1.
//
// float64: the FP64 tensor cores through mma.sync.aligned.m16n8k8.row.col
// .f64 (DMMA, sm_90; the m8n8k4 shape of sm_80 was slower on the H100
// in this kernel).  A 64 x 64 tile over 4 warps, each warp a 32 x 32
// quarter of 2 x 4 fragments of 16 x 8.  Accumulation order: l in chunks
// of eight, in order, each chunk added to the running sum by one DMMA (the
// tensor core's own order inside the chunk).  The row pitch LD = 20
// doubles makes each half-warp's fragment loads hit 16 distinct bank
// pairs.
//
// Both orders are fixed, so results are the same from run to run, and
// there are no atomics.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace madqp {

// float32: 64 x 64 tiles over 16 x 16 threads, each with a 4 x 4
// register block.  MIN_CTAS_ CTAs per SM bound the registers.
struct AccF32 {
  float v[4][4];
};

template <int MIN_CTAS_>
struct F32Tile {
  using T = float;
  static constexpr int BM = 64;        // output tile BM x BM
  static constexpr int KC = 16;        // columns of B per ring stage
  static constexpr int LD = KC + 4;    // shared-memory row pitch, elements
  static constexpr int STAGES = 3;
  static constexpr int THREADS = 256;
  static constexpr int MIN_CTAS = MIN_CTAS_;
  static constexpr int VEC = 4;        // elements per 16-byte copy
  using Acc = AccF32;
};

struct AccF64 {
  double v[2][4][4];  // per warp: 2 x 4 fragments of 16 x 8
};

template <int MIN_CTAS_>
struct F64Tile {
  using T = double;
  static constexpr int BM = 64;
  static constexpr int KC = 16;
  static constexpr int LD = KC + 4;
  static constexpr int STAGES = 3;
  static constexpr int THREADS = 128;
  static constexpr int MIN_CTAS = MIN_CTAS_;
  static constexpr int VEC = 2;
  static constexpr int WM = 32;        // each warp owns a WM x WM quarter
  using Acc = AccF64;
};

// K8's tiles: three CTAs per SM (80 registers in float32, 170 at most in
// float64); 128 x 128 float32 tiles with 8 x 8 register blocks, at one or
// two CTAs per SM, ran slower on the H100.
template <typename T>
struct Tile;
template <>
struct Tile<float> : F32Tile<3> {};
template <>
struct Tile<double> : F64Tile<3> {};

// Shared memory of the ring: STAGES x (two BM x LD strips).
template <typename Cfg>
constexpr int ring_bytes() {
  return Cfg::STAGES * 2 * Cfg::BM * Cfg::LD * (int)sizeof(typename Cfg::T);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy `bytes` (0..16) of src to dst and zero-fill the rest of 16 bytes.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Copy one element of N bytes (bytes = N) or zero-fill it (bytes = 0).
template <int N>
__device__ __forceinline__ void cp_async_1(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(N), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage columns l0 .. l0 + KC of a strip into dst (BM x LD).  `src` is
// the strip's first row, which is valid whenever the tile exists, so it
// stands in as the address of a zero-filled lane.
template <typename TC, typename T>
__device__ __forceinline__ void load_strip(T* dst, const T* src, int ld,
                                           int rows, int l0, int k,
                                           bool vec) {
  if (vec) {
    constexpr int CPR = TC::KC / TC::VEC;  // 16-byte chunks per row
    for (int e = threadIdx.x; e < TC::BM * CPR; e += TC::THREADS) {
      const int row = e / CPR;
      const int ch = e - row * CPR;
      const int l = l0 + ch * TC::VEC;
      const int valid = (row < rows) ? min(max(k - l, 0), TC::VEC) : 0;
      const T* g = valid > 0 ? src + (size_t)row * ld + l : src;
      cp_async_16(dst + row * TC::LD + ch * TC::VEC, g,
                  valid * (int)sizeof(T));
    }
  } else {
    for (int e = threadIdx.x; e < TC::BM * TC::KC; e += TC::THREADS) {
      const int row = e / TC::KC;
      const int kk = e - row * TC::KC;
      const int l = l0 + kk;
      const bool ok = row < rows && l < k;
      cp_async_1<(int)sizeof(T)>(dst + row * TC::LD + kk,
                                 ok ? src + (size_t)row * ld + l : src,
                                 ok ? (int)sizeof(T) : 0);
    }
  }
}

// --- float32: FFMA on 4 x 4 register blocks ------------------------------

constexpr int F32_TD = 16;  // threads along each tile dimension
constexpr int F32_TM = 4;   // register block F32_TM x F32_TM per thread
constexpr int F32_KC = 16;  // F32Tile::KC
constexpr int F32_LD = F32_KC + 4;

__device__ __forceinline__ void zero(AccF32& acc) {
#pragma unroll
  for (int p = 0; p < F32_TM; ++p)
#pragma unroll
    for (int q = 0; q < F32_TM; ++q) acc.v[p][q] = 0.0f;
}

__device__ __forceinline__ void stage_product(AccF32& acc, const float* As,
                                              const float* Bs) {
  const int tx = threadIdx.x % F32_TD;
  const int ty = threadIdx.x / F32_TD;
#pragma unroll
  for (int k4 = 0; k4 < F32_KC; k4 += 4) {
    float4 b[F32_TM];
#pragma unroll
    for (int q = 0; q < F32_TM; ++q)
      b[q] = *reinterpret_cast<const float4*>(Bs + (tx + F32_TD * q) * F32_LD + k4);
    // One row of the register block at a time (its A values are a
    // broadcast read); the sums of the row advance together, l in order,
    // so consecutive FMAs never depend on each other.
#pragma unroll
    for (int p = 0; p < F32_TM; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(As + (ty + F32_TD * p) * F32_LD + k4);
#pragma unroll
      for (int q = 0; q < F32_TM; ++q) acc.v[p][q] = __fmaf_rn(a.x, b[q].x, acc.v[p][q]);
#pragma unroll
      for (int q = 0; q < F32_TM; ++q) acc.v[p][q] = __fmaf_rn(a.y, b[q].y, acc.v[p][q]);
#pragma unroll
      for (int q = 0; q < F32_TM; ++q) acc.v[p][q] = __fmaf_rn(a.z, b[q].z, acc.v[p][q]);
#pragma unroll
      for (int q = 0; q < F32_TM; ++q) acc.v[p][q] = __fmaf_rn(a.w, b[q].w, acc.v[p][q]);
    }
  }
}

// f(i, j, value) for every element of the tile this thread holds (i, j
// relative to the tile's first row and column).
template <typename F>
__device__ __forceinline__ void for_each(const AccF32& acc, F&& f) {
  const int tx = threadIdx.x % F32_TD;
  const int ty = threadIdx.x / F32_TD;
#pragma unroll
  for (int p = 0; p < F32_TM; ++p)
#pragma unroll
    for (int q = 0; q < F32_TM; ++q) f(ty + F32_TD * p, tx + F32_TD * q, acc.v[p][q]);
}

// --- float64: DMMA m16n8k8 fragments --------------------------------------

__device__ __forceinline__ void zero(AccF64& acc) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc.v[m][n][i] = 0.0;
}

// d += a b for one 16 x 8 x 8 fragment: lane (g, t) = (lane / 4, lane % 4)
// holds A[g + 8 (i % 2)][t + 4 (i / 2)] in a[i], B[t + 4 i][g] in b[i] and
// D[g + 8 (i / 2)][2 t + i % 2] in d[i].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void stage_product(AccF64& acc, const double* As,
                                              const double* Bs) {
  using TC = F64Tile<1>;  // the layout; MIN_CTAS does not enter it
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp >> 1) * TC::WM + (lane >> 2);
  const int col0 = (warp & 1) * TC::WM + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int k8 = 0; k8 < TC::KC; k8 += 8) {
    double a[2][4], b[4][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[m][i] = As[(row0 + 16 * m + 8 * (i & 1)) * TC::LD + k8 + t + 4 * (i >> 1)];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) b[n][i] = Bs[(col0 + 8 * n) * TC::LD + k8 + t + 4 * i];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) dmma(acc.v[m][n], a[m], b[n]);
  }
}

template <typename F>
__device__ __forceinline__ void for_each(const AccF64& acc, F&& f) {
  using TC = F64Tile<1>;  // the layout; MIN_CTAS does not enter it
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp >> 1) * TC::WM + (lane >> 2);
  const int col0 = (warp & 1) * TC::WM + 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f(row0 + 16 * m + 8 * (i >> 1), col0 + 8 * n + (i & 1), acc.v[m][n][i]);
}

// --- the routine ----------------------------------------------------------

template <typename TC, typename T>
__device__ __forceinline__ bool vec_ok(const T* p, int ld) {
  return ((reinterpret_cast<uintptr_t>(p) & 15) == 0) && (ld % TC::VEC == 0);
}

// acc += B_I B_J^T over k columns with the tile configuration TC.  smem:
// ring_bytes<TC>() of dynamic shared memory; free again when this returns
// (it ends with a barrier).  Every thread of the CTA calls it.
template <typename TC>
__device__ void tile_product(typename TC::Acc& acc, typename TC::T* smem,
                             const typename TC::T* Bi, int ldi, int rows_i,
                             const typename TC::T* Bj, int ldj, int rows_j,
                             int k) {
  using T = typename TC::T;
  constexpr int STRIP = TC::BM * TC::LD;
  constexpr int STAGE = 2 * STRIP;
  const bool vi = vec_ok<TC>(Bi, ldi);
  const bool vj = vec_ok<TC>(Bj, ldj);
  const int steps = (k + TC::KC - 1) / TC::KC;
#pragma unroll
  for (int s = 0; s < TC::STAGES - 1; ++s) {
    if (s < steps) {
      load_strip<TC>(smem + s * STAGE, Bi, ldi, rows_i, s * TC::KC, k, vi);
      load_strip<TC>(smem + s * STAGE + STRIP, Bj, ldj, rows_j, s * TC::KC, k, vj);
    }
    cp_async_commit();  // one group per stage, empty or not
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<TC::STAGES - 2>();  // this thread's copies of step s
    __syncthreads();  // everyone's copies of step s; step s - 1 is consumed
    const int nxt = s + TC::STAGES - 1;
    if (nxt < steps) {
      T* slot = smem + (nxt % TC::STAGES) * STAGE;
      load_strip<TC>(slot, Bi, ldi, rows_i, nxt * TC::KC, k, vi);
      load_strip<TC>(slot + STRIP, Bj, ldj, rows_j, nxt * TC::KC, k, vj);
    }
    cp_async_commit();
    const T* cur = smem + (s % TC::STAGES) * STAGE;
    stage_product(acc, cur, cur + STRIP);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Tile (I, J), J <= I, of the idx-th lower tile in row-major order.
__device__ __forceinline__ void lower_tile(int idx, int& I, int& J) {
  int i = (int)((sqrt(8.0 * idx + 1.0) - 1.0) * 0.5);
  while (i * (i + 1) / 2 > idx) --i;
  while ((i + 1) * (i + 2) / 2 <= idx) ++i;
  I = i;
  J = idx - i * (i + 1) / 2;
}

}  // namespace madqp
