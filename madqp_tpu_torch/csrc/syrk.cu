// K8: the rank-k update out = C - B B[:c]^T, hand-written for Hopper.
//
// Replaces the TPU kernel benchmarks/exp_pallas_rl_chol.py::pallas_syrk_update
// (the pl.pallas_call at exp_pallas_rl_chol.py:120, body _syrk_update_kernel
// at :104-108), which tiles the square C over a 2-D grid of 512 x 512 output
// tiles and keeps the (512, k) strips of B resident in VMEM.  Here it is the
// trailing update of the two-level right-looking Cholesky panel_chol
// (ops/blocked_dense.py): C (r, c) with c <= r, B (r, k), float32 or
// float64, each with unit column stride and any row stride (ldc, ldb, ldo),
// and out either C itself (in place) or memory that overlaps neither C nor
// B.  panel_chol passes only the block that changes: the in-stripe update
// S[c1:, c1:] -= Z Z[:w - c1]^T and the cross-stripe update of the trailing
// square, both as views of the matrix being factored, in place.
//
// A lane axis: a stack of `lanes` such updates of one shape, lane l's C, B
// and out starting l * sc, l * sb, l * so elements after lane 0's (64-bit
// strides: one lane of a 2560^2 float64 stripe is 52 MB), is one launch
// with blockIdx.y the lane.  Each lane runs the tiles, their order and the
// mirror of a 2-D update; a 2-D update is the stack of one (strides 0).
// The batched KKT's panel_chol (the lane path of ops/blocked_dense.py)
// issues each trailing update once for all lanes this way, what the TPU
// kernel under jax.vmap does with a batch grid dimension.
//
// What bounds it: the function needs c (c + 1) k + 2 (r - c) c k operations
// (the top c x c block of B B[:c]^T is symmetric) against (2 r c + r k)
// elements of traffic.  At (3840, 1792, 256) that is 2.70 GFLOP against
// 57 MB in float32, 40 us at the card's 67 TFLOP/s on the CUDA cores and
// 17 us at 3.35 TB/s: it is bound by operations, and the design is about
// issuing them at the CUDA cores' (float32) or the FP64 tensor cores'
// (float64) rate and computing no more of them than the function needs:
//
//   * each CTA computes one output tile with the tile routine of
//     syrk_tile.cuh (64 x 64 tiles: 4 x 4 FFMA register blocks in float32,
//     DMMA m16n8k8 fragments in float64, B staged through a 3-deep
//     cp.async ring so the next strip is in flight while the current one is
//     multiplied; the accumulation orders are written down there);
//   * over the top c x c block only the lower tiles (J <= I) are launched.
//     A strictly lower tile writes C[I, J] - acc and, through a transpose
//     in shared memory so both stores are row-coalesced, the mirrored tile
//     C[J, I] - acc^T: half the products, the full output.  Tiles in rows
//     >= c are all launched;
//   * masks are selects (the copies zero-fill out-of-range lanes; stores
//     are guarded), never multiplies, so a NaN in B reaches its row and
//     column of the output and nothing else;
//   * every output element is written once by one thread: no atomics, and
//     the same result from run to run.
//
// Plain TF32 on the tensor cores keeps about three decimal digits and cannot
// serve the float32 factorization; a split-TF32 wgmma version that keeps
// float32 accuracy is later work (ROADMAP.md, Queue 2).
//
// Interface: plain C functions, one per dtype, that launch on the given
// stream and return cudaGetLastError() (0 on success).  Built by
// madqp_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v

#include <cuda_runtime.h>

#include "syrk_tile.cuh"

namespace {

using madqp::Tile;

template <typename T>
constexpr int transpose_bytes() {
  return Tile<T>::BM * (Tile<T>::BM + 1) * (int)sizeof(T);
}

template <typename T>
constexpr int smem_bytes() {
  return madqp::ring_bytes<Tile<T>>() > transpose_bytes<T>() ? madqp::ring_bytes<Tile<T>>()
                                                      : transpose_bytes<T>();
}

// One CTA per launched tile: the tc (tc + 1) / 2 lower tiles of the top
// block in row-major order, then the full tile rows below it.
template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS, Tile<T>::MIN_CTAS)
madqp_syrk_kernel(const T* C, int ldc, long long sc, const T* __restrict__ B, int ldb,
                  long long sb, T* out, int ldo, long long so, int r, int c, int k) {
  using TC = Tile<T>;
  constexpr int BM = TC::BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  C += (size_t)blockIdx.y * sc;
  B += (size_t)blockIdx.y * sb;
  out += (size_t)blockIdx.y * so;

  const int tc = (c + BM - 1) / BM;
  const int ntri = tc * (tc + 1) / 2;
  int I, J;
  if ((int)blockIdx.x < ntri) {
    madqp::lower_tile(blockIdx.x, I, J);
  } else {
    const int idx = blockIdx.x - ntri;
    I = tc + idx / tc;
    J = idx - (I - tc) * tc;
  }
  const int i0 = I * BM;
  const int j0 = J * BM;

  typename TC::Acc acc;
  madqp::zero(acc);
  madqp::tile_product<Tile<T>>(acc, smem, B + (size_t)i0 * ldb, ldb, r - i0,
                         B + (size_t)j0 * ldb, ldb, c - j0, k);

  madqp::for_each(acc, [&](int i, int j, T v) {
    const int gi = i0 + i, gj = j0 + j;
    if (gi < r && gj < c) out[(size_t)gi * ldo + gj] = C[(size_t)gi * ldc + gj] - v;
  });

  if (I < tc && J < I) {
    // Mirror: out[j0 + jj, i0 + ii] = C[...] - acc[ii][jj].  Rows j0 + jj
    // lie above row i0 <= c - 1, so only the column needs a guard.
    constexpr int P = BM + 1;
    T* sT = smem;
    madqp::for_each(acc, [&](int i, int j, T v) { sT[j * P + i] = v; });
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BM; e += TC::THREADS) {
      const int jj = e / BM, ii = e - jj * BM;
      const int gr = j0 + jj, gc = i0 + ii;
      if (gc < c) out[(size_t)gr * ldo + gc] = C[(size_t)gr * ldc + gc] - sT[jj * P + ii];
    }
  }
}

template <typename T>
int syrk_update(const T* C, int ldc, long long sc, const T* B, int ldb, long long sb,
                T* out, int ldo, long long so, int r, int c, int k, int lanes,
                cudaStream_t stream) {
  if (r <= 0 || c <= 0 || lanes <= 0) return 0;
  if (lanes > 65535) return (int)cudaErrorInvalidConfiguration;
  constexpr int BM = Tile<T>::BM;
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      madqp_syrk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tc = (c + BM - 1) / BM;
  const long long tr = (r + BM - 1) / BM;
  const long long tiles = tc * (tc + 1) / 2 + (tr - tc) * tc;
  madqp_syrk_kernel<T><<<dim3((unsigned)tiles, (unsigned)lanes), Tile<T>::THREADS, smem,
                         stream>>>(C, ldc, sc, B, ldb, sb, out, ldo, so, r, c, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int madqp_syrk_update_f32(const void* C, int ldc, long long sc, const void* B,
                                     int ldb, long long sb, void* out, int ldo,
                                     long long so, int r, int c, int k, int lanes,
                                     void* stream) {
  return syrk_update<float>(static_cast<const float*>(C), ldc, sc,
                            static_cast<const float*>(B), ldb, sb,
                            static_cast<float*>(out), ldo, so, r, c, k, lanes,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int madqp_syrk_update_f64(const void* C, int ldc, long long sc, const void* B,
                                     int ldb, long long sb, void* out, int ldo,
                                     long long so, int r, int c, int k, int lanes,
                                     void* stream) {
  return syrk_update<double>(static_cast<const double*>(C), ldc, sc,
                             static_cast<const double*>(B), ldb, sb,
                             static_cast<double*>(out), ldo, so, r, c, k, lanes,
                             static_cast<cudaStream_t>(stream));
}

// Output tile edge, so the wrapper can count the work the kernel computes.
static_assert(Tile<float>::BM == Tile<double>::BM, "one tile edge");
extern "C" int madqp_syrk_tile() { return Tile<float>::BM; }
