// K1, batched form: the lower Cholesky factor of every matrix of a stack,
// one CTA per matrix, hand-written for Hopper.
//
// Replaces the TPU kernel madqp_tpu/ops/pallas_chol.py::pallas_cholesky
// (the pl.pallas_call at pallas_chol.py:158) as the batched solver runs it:
// under jax.vmap (madqp_tpu/parallel/batched.py) Pallas adds the batch to
// the grid, and each program factors one whole matrix resident in VMEM.
// Here each CTA copies the lower triangle of its matrix into shared memory,
// runs the right-looking column sweep there and writes the factor back
// once:
//
//   for k = 0 .. n - 1:
//     a. column scale: s[i][k] /= sqrt(s[k][k]) for i > k, one row per
//        thread; every thread reads the pivot, none writes it;  __syncthreads
//     b. thread 0 stores the pivot sqrt(s[k][k]); the trailing block loses
//        the column's outer product, s[i][j] -= s[i][k] s[j][k] for
//        k < j <= i, one warp per row, its lanes over the columns;
//                                                               __syncthreads
//
// The shared row pitch is odd, so the column reads of step a and the
// s[j][k] reads of step b, consecutive threads on consecutive rows, fall in
// distinct banks.  A square of n x pitch(n) elements must fit one CTA's
// opt-in shared memory (227 KB on the H100: n <= 241 in float32, n <= 169
// in float64); madqp_cholesky_batched_max_n reads the limit from the
// device, and the wrapper (ops/pallas_chol.py::cholesky_lower) sends a
// larger stack to the persistent single-matrix kernel (cholesky.cu), one
// launch per matrix.
//
// What bounds it: the work is tiny (the batched solver's matrices are
// 16 x 16 to 42 x 42: B n^3 / 3 = 1.3e7 operations and 7.2 MB moved for
// 512 matrices of order 42, a few microseconds of the card's rates).  Each
// CTA walks a dependent chain of n pivots, two CTA barriers apiece, with
// all of its data in shared memory; the card runs the CTAs side by side
// (512 of them at 256 threads are about four per SM, one wave).  The chain
// sets the time, and nothing of it touches device memory but the one read
// and the one write.  Register blocking and a warp per column are later
// work (ROADMAP Queue 2).
//
// Contract (the solver's per-lane factor_ok test depends on it, ops/kkt.py):
//   * the output is the lower factor with a zero strict upper triangle; the
//     strict upper triangle of the input is not read;
//   * a non-SPD matrix gives NaN (sqrt of a negative pivot) or a
//     non-positive value on its own diagonal: no early exit, and no other
//     matrix of the stack is touched (each CTA reads and writes only its
//     own); the pivot is the IEEE round-to-nearest sqrt and the column is
//     divided by it, as in the plain version;
//   * no atomics: every output element is written by one thread in a fixed
//     order, so results are the same from run to run.
//
// Interface: plain C functions that launch on the given stream and return
// the CUDA error (0 on success).  Built by madqp_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }

// Shared-memory row pitch: odd, so a column is spread over the banks.
__host__ __device__ constexpr int pitch(int n) { return n | 1; }

template <typename T>
size_t smem_bytes(int n) {
  return (size_t)n * pitch(n) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
madqp_cholesky_batched_kernel(const T* __restrict__ A, T* __restrict__ L, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int P = pitch(n);
  const size_t base = (size_t)blockIdx.x * n * n;
  const T* a = A + base;
  T* l = L + base;

  for (int e = threadIdx.x; e < n * n; e += THREADS) {
    const int i = e / n, j = e - i * n;
    if (j <= i) s[i * P + j] = a[e];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = 0; k < n; ++k) {
    const T p = sqrt_rn(s[k * P + k]);
    for (int i = k + 1 + threadIdx.x; i < n; i += THREADS) s[i * P + k] /= p;
    __syncthreads();
    if (threadIdx.x == 0) s[k * P + k] = p;
    for (int i = k + 1 + warp; i < n; i += WARPS) {
      const T lik = s[i * P + k];
      for (int j = k + 1 + lane; j <= i; j += 32) s[i * P + j] -= lik * s[j * P + k];
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < n * n; e += THREADS) {
    const int i = e / n, j = e - i * n;
    l[e] = (j <= i) ? s[i * P + j] : T(0);
  }
}

template <typename T>
int cholesky_batched(const T* A, T* L, int batch, int n, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = smem_bytes<T>(n);
  auto kernel = madqp_cholesky_batched_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<batch, THREADS, smem, stream>>>(A, L, n);
  return (int)cudaGetLastError();
}

}  // namespace

// A, L: contiguous (batch, n, n) stacks of the same dtype.
extern "C" int madqp_cholesky_lower_batched_f32(const void* A, void* L, int batch,
                                                int n, void* stream) {
  return cholesky_batched<float>(static_cast<const float*>(A), static_cast<float*>(L),
                                 batch, n, static_cast<cudaStream_t>(stream));
}

extern "C" int madqp_cholesky_lower_batched_f64(const void* A, void* L, int batch,
                                                int n, void* stream) {
  return cholesky_batched<double>(static_cast<const double*>(A), static_cast<double*>(L),
                                  batch, n, static_cast<cudaStream_t>(stream));
}

// The largest order n whose n x pitch(n) square of elem_size-byte elements
// fits the current device's opt-in shared memory per block; a negative
// value is a CUDA error, negated.
extern "C" int madqp_cholesky_batched_max_n(int elem_size) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  while ((size_t)(n + 1) * pitch(n + 1) * (size_t)elem_size <= (size_t)optin) ++n;
  return n;
}
