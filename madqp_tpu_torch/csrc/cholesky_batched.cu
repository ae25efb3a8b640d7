// K1, batched form: the lower Cholesky factor of every matrix of a stack of
// small matrices, hand-written for Hopper.
//
// Replaces the TPU kernel madqp_tpu/ops/pallas_chol.py::pallas_cholesky
// (the pl.pallas_call at pallas_chol.py:158) as the batched solver runs it:
// under jax.vmap (madqp_tpu/parallel/batched.py) Pallas adds the batch to
// the grid, and each program factors one whole matrix resident in VMEM.
// The batched solver's matrices are small (16 x 16 to 42 x 42 on the
// batched cell, 8 x 8 and 32 x 32 in the layer, 200 x 200 on the n = 500
// batch), so the time is the dependent chain of n pivots per matrix, not
// bytes or operations.  Three tiers, one launch per stack whatever the
// order (the wrapper, ops/pallas_chol.py::batched_route, picks the tier;
// a stack above the shared-memory limit runs the persistent kernel of
// cholesky.cu with a lane axis, also one launch):
//
//   * n <= 32, registers (madqp_cholesky_batched_regs_kernel<T, N>, N = 8,
//     16 or 32 the least that holds n): one group of N lanes per matrix,
//     32 / N matrices per warp.  Lane r holds row r of its matrix in N
//     registers (rows past n are the identity).  Step k: every lane reads
//     the pivot a_kk from lane k by __shfl_sync, lane k keeps
//     sqrt_rn(a_kk), the lanes below divide their own a_rk by it, and
//     a_rj -= a_rk a_jk for k < j <= r, a_jk by shuffle from lane j.  No
//     shared memory, no barrier: the shuffles order the lanes.
//   * 32 < n <= n_max, shared memory (madqp_cholesky_batched_shared_kernel):
//     the lower triangle in shared memory at an odd row pitch, factored in
//     32-column blocks by a team, one warp per matrix (two matrices per CTA)
//     for n <= 64 with __syncwarp, else one CTA per matrix, of 8 warps, or
//     of 4 where these take the stack through in fewer waves (the
//     occupancy API counts the CTAs the card holds at once: at 150-255
//     registers a thread, 8 warps fit one CTA per SM, 4 warps two or
//     three) and hold a thread for each panel row (n <= 160):
//       a. warp 0 factors the 32 x 32 diagonal block in registers (the
//          routine above, N = 32) and keeps its transpose in a scratch
//          square with 16-byte rows;                                 sync
//       b. panel solve: each thread takes a row below the block and solves
//          x L_D^T = p by forward substitution in registers, dividing by
//          the pivots, L_D's columns read 16 bytes at a time (broadcast);
//          the rows of the next diagonal block also go to a second
//          scratch square;                                            sync
//       c. warp 0 takes the next diagonal block's trailing update, each
//          lane its own panel row (still in registers) against the others
//          read 16 bytes at a time, and factors it at once (step a of the
//          next block); the other warps update the rows below it, each
//          warp a row, its lanes over the columns;                    sync
//     so 2 ceil(n / 32) team barriers in all (2n CTA barriers before).
//     The matrix and the two scratch squares must fit one CTA's opt-in
//     shared memory (227 KB on the H100: n <= 235 in float32, n <= 163 in
//     float64); madqp_cholesky_batched_max_n reads the limit from the
//     device.
//
// Loads and stores: in the register tier lane r reads and writes row r,
// 16 bytes at a time when n == N and the stack is 16-byte aligned (the
// rows are then too); in the shared tier one element per lane, lanes over
// consecutive columns of a row, so a warp's accesses are coalesced, and
// each warp keeps 16 rows' loads in flight at once (one row at a time,
// each load waiting for the last, made the shared tier's load take most
// of its time).
//
// Contract (the solver's per-lane factor_ok test depends on it, ops/kkt.py):
//   * the output is the lower factor with a zero strict upper triangle;
//     values in the input's strict upper triangle never enter the result;
//   * a non-SPD matrix gives NaN (sqrt of a negative pivot) or a
//     non-positive value on its own diagonal: no early exit, and no other
//     matrix of the stack is touched (a shuffle group, warp or CTA reads
//     and writes only its own); the pivot is the IEEE round-to-nearest
//     sqrt and the column is divided by it, as in the plain version;
//   * no atomics: every output element is written by one thread in a fixed
//     order, so results are the same from run to run.
//
// Interface: plain C functions that launch on the given stream and return
// the CUDA error (0 on success).  Built by madqp_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_THREADS = 64;   // register tier: two warps per CTA
constexpr int WARP_MATRICES = 2;  // shared tier, n <= 64: matrices (warps) per CTA
constexpr int WIDE = 8;           // shared tier, n > 64: warps of a CTA per matrix,
constexpr int NARROW = 4;         //   or these where they take fewer waves
constexpr int BLK = 32;           // block-column width of the shared tier
constexpr int LOAD_ROWS = 16;     // rows a warp loads at once in the shared tier

// Tier codes of madqp_cholesky_lower_batched_*: the register tier's N, or
// one of these.
constexpr int TIER_WARP_SHARED = 64;
constexpr int TIER_CTA_SHARED = 0;

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }

// Shared-memory row pitch: odd, so a column is spread over the banks.
__host__ __device__ constexpr int pitch(int n) { return n | 1; }

// Factor the order-m matrix (m <= N, the same in every group of the warp)
// whose row r lane r of a group of N lanes holds in `row`; rows past m are
// the identity, and steps past m are skipped.  Right-looking column sweep
// in registers, as described above.  All 32 lanes of the warp call it
// (groups of N lanes shuffle among themselves).
template <typename T, int N>
__device__ __forceinline__ void factor_rows(T (&row)[N], int r, int m) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k >= m) break;
    const T d = __shfl_sync(FULL, row[k], k, N);
    const T p = sqrt_rn(d);
    row[k] = (r > k) ? row[k] / p : (r == k ? p : row[k]);
#pragma unroll
    for (int j = k + 1; j < N; ++j) {
      const T ljk = __shfl_sync(FULL, row[k], j, N);
      row[j] = (r >= j) ? row[j] - row[k] * ljk : row[j];
    }
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
madqp_cholesky_batched_regs_kernel(const T* __restrict__ A, T* __restrict__ L,
                                   int batch, int n, int vec) {
  constexpr int G = 32 / N;  // matrices per warp
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (REG_THREADS / 32) + (threadIdx.x >> 5);
  if (warp * G >= batch) return;  // the whole warp has no matrix
  const int r = lane & (N - 1);
  const long long m = warp * G + lane / N;
  const bool live = m < batch && r < n;
  const size_t base = (size_t)(m < batch ? m : 0) * n * n;
  const T* a = A + base + (size_t)r * n;

  T row[N];
  if (vec && live) {  // n == N, 16-byte aligned rows
    using VT = Vec<T>;
#pragma unroll
    for (int c = 0; c < N; c += VT::W)
      VT::put(row + c, *reinterpret_cast<const typename VT::V*>(a + c));
#pragma unroll
    for (int c = 0; c < N; ++c) row[c] = (c <= r) ? row[c] : T(0);
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c)
      row[c] = live ? ((c <= r) ? a[c] : T(0)) : (c == r ? T(1) : T(0));
  }

  factor_rows<T, N>(row, r, n);

  if (!live) return;
  T* l = L + base + (size_t)r * n;
  if (vec) {
    using VT = Vec<T>;
#pragma unroll
    for (int c = 0; c < N; ++c) row[c] = (c <= r) ? row[c] : T(0);
#pragma unroll
    for (int c = 0; c < N; c += VT::W)
      *reinterpret_cast<typename VT::V*>(l + c) = VT::get(row + c);
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c < n) l[c] = (c <= r) ? row[c] : T(0);
  }
}

// The team of the shared tier, TW warps: one warp (WARP), one of
// WARP_MATRICES in its CTA, or the whole CTA.
template <int TW>
struct Team {
  static constexpr bool WARP = TW == 1;
  static constexpr int THREADS = 32 * (WARP ? WARP_MATRICES : TW);  // of the CTA
  __device__ static void sync() {
    if (WARP) __syncwarp(); else __syncthreads();
  }
  __device__ static int tid() { return WARP ? (threadIdx.x & 31) : threadIdx.x; }
  __device__ static int size() { return 32 * TW; }
  __device__ static int warp() { return WARP ? 0 : (threadIdx.x >> 5); }
  __device__ static int warps() { return TW; }
};

// A team's shared memory: two BLK x UP scratch squares with 16-byte rows,
// then the matrix at pitch(n):
//   U  the current diagonal block's factor transposed, U[j][q] = L_D[q][j],
//      so the panel solve reads column j of L_D 16 bytes at a time;
//   X  the panel rows of the next diagonal block, so its trailing update
//      reads them 16 bytes at a time.
// UP = BLK + 16 bytes keeps a warp's 16-byte row stores free of bank
// conflicts (36 floats, 34 doubles).
template <typename T>
__host__ __device__ constexpr int up() { return BLK + 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ constexpr size_t team_elems(int n) {
  constexpr int W = 16 / (int)sizeof(T);
  return (size_t)2 * BLK * up<T>() + ((size_t)n * pitch(n) + W - 1) / W * W;
}

// Factor the jb x jb diagonal block at (c, c) of s whose rows lane r holds
// in `row` (identity past jb), write the lower factor back, and its
// transpose into U.  Warp 0.
template <typename T>
__device__ __forceinline__ void factor_block(T (&row)[BLK], T* s, T* U, int P, int c,
                                             int jb, int r) {
  factor_rows<T, BLK>(row, r, jb);
  if (r < jb) {
#pragma unroll
    for (int j = 0; j < BLK; ++j) {
      if (j <= r) {
        s[(c + r) * P + c + j] = row[j];
        U[j * up<T>() + r] = row[j];
      }
    }
  }
}

template <typename T, int TW>
__global__ void __launch_bounds__(Team<TW>::THREADS)
madqp_cholesky_batched_shared_kernel(const T* __restrict__ A, T* __restrict__ L,
                                     int batch, int n) {
  using TM = Team<TW>;
  constexpr bool WARP = TM::WARP;
  using VT = Vec<T>;
  using V = typename VT::V;
  constexpr int W = VT::W;
  constexpr int UP = up<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = pitch(n);
  const long long m = WARP ? (long long)blockIdx.x * WARP_MATRICES + (threadIdx.x >> 5)
                           : (long long)blockIdx.x;
  if (m >= batch) return;  // a whole warp (WARP) or CTA
  T* U = reinterpret_cast<T*>(smem_raw) + (WARP ? (threadIdx.x >> 5) * team_elems<T>(n) : 0);
  T* X = U + BLK * UP;
  T* s = X + BLK * UP;
  const size_t base = (size_t)m * n * n;
  const T* a = A + base;
  T* l = L + base;
  const int lane = threadIdx.x & 31;
  const int tw = TM::warp(), nw = TM::warps();

  // The lower triangle into s: LOAD_ROWS rows of a 32-column strip per
  // warp at a time, all their loads in flight before the first store.
  for (int j = lane; j - lane < n; j += 32) {
    for (int i0 = tw; i0 < n; i0 += LOAD_ROWS * nw) {
      T v[LOAD_ROWS];
#pragma unroll
      for (int u = 0; u < LOAD_ROWS; ++u) {
        const int i = i0 + u * nw;
        v[u] = (i < n && j <= i) ? a[(size_t)i * n + j] : T(0);
      }
#pragma unroll
      for (int u = 0; u < LOAD_ROWS; ++u) {
        const int i = i0 + u * nw;
        if (i < n && j <= i) s[i * P + j] = v[u];
      }
    }
  }
  TM::sync();

  if (tw == 0) {  // a. the first diagonal block
    const int jb = n < BLK ? n : BLK;
    T row[BLK];
#pragma unroll
    for (int j = 0; j < BLK; ++j)
      row[j] = (lane < jb) ? ((j <= lane) ? s[lane * P + j] : T(0)) : (j == lane ? T(1) : T(0));
    factor_block<T>(row, s, U, P, 0, jb, lane);
  }
  TM::sync();

  for (int c0 = 0; c0 + BLK < n; c0 += BLK) {
    const int c1 = c0 + BLK;
    // b. rows below the block, one per thread (n - BLK <= the team's
    //    threads): x L_D^T = p, in place; the rows of the next diagonal
    //    block, which warp 0 holds, also into X.
    const int i = c1 + TM::tid();
    T x[BLK];
    if (i < n) {
#pragma unroll
      for (int j = 0; j < BLK; ++j) x[j] = s[i * P + c0 + j];
#pragma unroll
      for (int j = 0; j < BLK; ++j) {
        x[j] = x[j] / U[j * UP + j];
#pragma unroll
        for (int c = (j + 1) / W; c < BLK / W; ++c) {
          T u[W];
          VT::put(u, *reinterpret_cast<const V*>(U + j * UP + c * W));
#pragma unroll
          for (int t = 0; t < W; ++t)
            if (c * W + t > j) x[c * W + t] -= x[j] * u[t];
        }
      }
#pragma unroll
      for (int j = 0; j < BLK; ++j) s[i * P + c0 + j] = x[j];
      if (i < c1 + BLK) {
#pragma unroll
        for (int c = 0; c < BLK / W; ++c)
          *reinterpret_cast<V*>(X + (i - c1) * UP + c * W) = VT::get(x + c * W);
      }
    }
    TM::sync();

    // c. trailing update: s[i][j] -= sum_l s[i][c0 + l] s[j][c0 + l],
    //    c1 <= j <= i.
    const int jb = n - c1 < BLK ? n - c1 : BLK;
    if (tw == 0) {  // the next diagonal block (lane r's panel row is x), then its factor
      const int r = lane;
      T row[BLK];
#pragma unroll
      for (int j = 0; j < BLK; ++j) {
        T acc = T(0);
        if (j < jb) {
#pragma unroll
          for (int c = 0; c < BLK / W; ++c) {
            T v[W];
            VT::put(v, *reinterpret_cast<const V*>(X + j * UP + c * W));
#pragma unroll
            for (int t = 0; t < W; ++t) acc += x[c * W + t] * v[t];
          }
        }
        row[j] = (r < jb && j < jb) ? ((j <= r) ? s[(c1 + r) * P + c1 + j] - acc : T(0))
                                    : (j == r ? T(1) : T(0));
      }
      factor_block<T>(row, s, U, P, c1, jb, r);
    } else {  // the rows below it, a warp each
      for (int i = c1 + BLK + tw - 1; i < n; i += nw - 1) {
        T x[BLK];
#pragma unroll
        for (int q = 0; q < BLK; ++q) x[q] = s[i * P + c0 + q];
        for (int j = c1 + lane; j <= i; j += 32) {
          T acc = T(0);
#pragma unroll
          for (int q = 0; q < BLK; ++q) acc += x[q] * s[j * P + c0 + q];
          s[i * P + j] -= acc;
        }
      }
    }
    TM::sync();
  }

  for (int i = tw; i < n; i += nw)
    for (int j = lane; j < n; j += 32) l[(size_t)i * n + j] = (j <= i) ? s[i * P + j] : T(0);
}


template <typename T, int N>
int launch_regs(const T* A, T* L, int batch, int n, cudaStream_t stream) {
  constexpr int per_cta = (REG_THREADS / 32) * (32 / N);
  const int vec = (n == N && (reinterpret_cast<uintptr_t>(A) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(L) & 15) == 0);
  const int grid = (int)(((long long)batch + per_cta - 1) / per_cta);
  madqp_cholesky_batched_regs_kernel<T, N><<<grid, REG_THREADS, 0, stream>>>(A, L, batch, n, vec);
  return (int)cudaGetLastError();
}

template <typename T, int TW>
size_t shared_bytes(int n) {
  return team_elems<T>(n) * sizeof(T) * (Team<TW>::WARP ? WARP_MATRICES : 1);
}

template <typename T, int TW>
int launch_shared(const T* A, T* L, int batch, int n, cudaStream_t stream) {
  if (n - BLK > 32 * TW) return (int)cudaErrorInvalidValue;  // a panel row each
  const size_t smem = shared_bytes<T, TW>(n);
  auto kernel = madqp_cholesky_batched_shared_kernel<T, TW>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = Team<TW>::WARP ? (batch + WARP_MATRICES - 1) / WARP_MATRICES : batch;
  kernel<<<grid, Team<TW>::THREADS, smem, stream>>>(A, L, batch, n);
  return (int)cudaGetLastError();
}

// The CTAs of TW warps, one per matrix of order n, that the device holds
// at once (a negative value is a CUDA error, negated).
template <typename T, int TW>
long long resident(int n) {
  const size_t smem = shared_bytes<T, TW>(n);
  auto kernel = madqp_cholesky_batched_shared_kernel<T, TW>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Team<TW>::THREADS, smem);
  return err == cudaSuccess ? (long long)per_sm * sms : -(long long)err;
}

// A CTA per matrix: WIDE warps, or NARROW where these have a thread for
// each panel row and take the stack through in fewer waves of resident
// CTAs; WIDE on a tie, since more warps share each trailing update.
template <typename T>
int launch_cta(const T* A, T* L, int batch, int n, cudaStream_t stream) {
  const long long wide = resident<T, WIDE>(n), narrow = resident<T, NARROW>(n);
  if (wide < 0) return (int)-wide;
  if (narrow < 0) return (int)-narrow;
  const auto waves = [batch](long long r) { return r > 0 ? (batch + r - 1) / r : batch + 1LL; };
  if (n - BLK <= 32 * NARROW && waves(narrow) < waves(wide))
    return launch_shared<T, NARROW>(A, L, batch, n, stream);
  return launch_shared<T, WIDE>(A, L, batch, n, stream);
}

template <typename T>
int cholesky_batched(const T* A, T* L, int batch, int n, int tier, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  switch (tier) {
    case 8:
      if (n > 8) break;
      return launch_regs<T, 8>(A, L, batch, n, stream);
    case 16:
      if (n > 16) break;
      return launch_regs<T, 16>(A, L, batch, n, stream);
    case 32:
      if (n > 32) break;
      return launch_regs<T, 32>(A, L, batch, n, stream);
    case TIER_WARP_SHARED:
      if (n > 64) break;
      return launch_shared<T, 1>(A, L, batch, n, stream);
    case TIER_CTA_SHARED:
      return launch_cta<T>(A, L, batch, n, stream);
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A, L: contiguous (batch, n, n) stacks of the same dtype.  tier: 8, 16 or
// 32 (registers, n <= tier), 64 (a warp per matrix in shared memory,
// n <= 64) or 0 (a CTA per matrix in shared memory, n <= the limit).
extern "C" int madqp_cholesky_lower_batched_f32(const void* A, void* L, int batch,
                                                int n, int tier, void* stream) {
  return cholesky_batched<float>(static_cast<const float*>(A), static_cast<float*>(L),
                                 batch, n, tier, static_cast<cudaStream_t>(stream));
}

extern "C" int madqp_cholesky_lower_batched_f64(const void* A, void* L, int batch,
                                                int n, int tier, void* stream) {
  return cholesky_batched<double>(static_cast<const double*>(A), static_cast<double*>(L),
                                  batch, n, tier, static_cast<cudaStream_t>(stream));
}

// The largest order n whose team memory (the matrix at pitch(n) and the
// two scratch squares) of elem_size-byte elements fits the current
// device's opt-in shared memory per block, and whose panel rows below the
// first block a CTA of WIDE warps covers; a negative value is a CUDA
// error, negated.
extern "C" int madqp_cholesky_batched_max_n(int elem_size) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  auto bytes = [&](int n) {
    return elem_size == 4 ? team_elems<float>(n) * 4 : team_elems<double>(n) * 8;
  };
  int n = 0;
  while (n + 1 - BLK <= 32 * WIDE && bytes(n + 1) <= (size_t)optin) ++n;
  return n;
}
