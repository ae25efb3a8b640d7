// K2-batched: the no-pivot signed LDL^T of every matrix of a stack of small
// symmetric matrices, hand-written for Hopper.
//
// Replaces the XLA-built madqp_tpu/ops/blocked_dense.py::unblocked_ldl /
// blocked_ldl (:37, :342), which the JAX package reaches through
// madqp_tpu/ops/sparse_chol.py::dense_ldl (:1306) for every front of the
// signed supernodal factorization (factorize_batched_ldl: the augmented K2
// system of solve_sparse_qp, the float32 phases of the normal-equations and
// condensed paths).  No Pallas kernel computed it; as torch ops each front
// stack of order 128 took ~1,500 launches (a ~10-op column sweep per
// column, plus the inverse's recursion).  Here every stack is one launch.
//
// Function: F = L D L^T for each (n, n) matrix of the stack, only F's lower
// triangle read; L unit lower with a zero strict upper triangle, d the
// pivots.  With signs s (one per column) and floor > 0 each pivot becomes
// d_j <- s_j max(s_j d_j, floor) before it is used (a NaN pivot stays NaN),
// the rule of unblocked_ldl.  Without them a pivot is used as it comes: a
// pivot of the wrong sign is kept, and a zero pivot makes inf or NaN in its
// own matrix only (the caller's factor_ok_batched_ldl reads both from d).
//
// The time of the supernodal fronts (n <= 128, hundreds of matrices per
// stack) is the dependent chain of n pivots per matrix, as for K1's batched
// tiers, not bytes (a 128^2 float64 matrix is 128 KB, read once) or
// operations (n^3 / 3 per matrix).  Two tiers, one launch per stack:
//
//   * n <= 32, registers (madqp_ldl_batched_regs_kernel<T, N>, N = 8, 16 or
//     32 the least that holds n): one group of N lanes per matrix, 32 / N
//     matrices per warp.  Lane r holds row r in N registers (rows past n
//     are the identity).  Step k: every lane reads the pivot a_kk from lane
//     k by __shfl_sync (and the sign s_k, and applies the floor), the lanes
//     below divide their own a_rk by it, and a_rj -= (d_k l_rk) l_jk for
//     k < j <= r, l_jk by shuffle from lane j.  Lane r keeps d_r in row[r].
//     The sweep of csrc/cholesky_batched.cu's register tier with a division
//     by the pivot in place of the square root.
//   * 32 < n <= 128, shared memory (madqp_ldl_batched_shared_kernel): one CTA
//     of 4 warps per matrix (a thread for each of the at most 96 rows below
//     the first block), the lower triangle in shared memory at an odd row
//     pitch, factored in 32-column blocks as cholesky_batched.cu's shared
//     tier does:
//       a. warp 0 factors the 32 x 32 diagonal block in registers (the
//          sweep above, floor included), writes L_D and d_D, and keeps L_D
//          transposed in a scratch square with 16-byte rows;         sync
//       b. panel: each thread takes a row below the block and solves
//          z L_D^T = p by forward substitution in registers, L_D's columns
//          read 16 bytes at a time; the row's L21 = z / d_D goes to the
//          matrix, its z to a panel buffer, and the L21 rows of the next
//          diagonal block also to a second scratch square;            sync
//       c. warp 0 takes the next diagonal block's trailing update
//          (a_rj -= z_r . l_j, lane r's z still in registers) and factors
//          it at once (step a of the next block); the other warps update
//          the rows below it, each warp a row (its z from the panel
//          buffer), its lanes over the columns;                       sync
//     A 128^2 float64 matrix with the scratch is 185 KB of the H100's 227 KB
//     of opt-in shared memory per CTA.
//
// Above 128 the wrapper raises.  No atomics: every output element is written
// by one thread in a fixed order, so two runs give the same bits.  The
// products contract a - b c into one FMA; the plain version
// (ops/ldl_batched.py::ldl_batched_reference) follows the same blocking and
// pivot arithmetic in torch ops.
//
// Interface: plain C functions that launch on the given stream and return
// the CUDA error (0 on success).  F is read through a batch stride and a row
// stride (its columns contiguous), so a front stack's leading blocks need no
// copy; L (batch, n, n), d and the signs (batch, n) are contiguous.  Built
// by madqp_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_THREADS = 64;  // register tier: two warps per CTA
constexpr int TEAM_WARPS = 4;    // shared tier: warps per matrix
constexpr int TEAM_THREADS = 32 * TEAM_WARPS;
constexpr int BLK = 32;          // block-column width of the shared tier
constexpr int MAX_N = 128;       // largest order (the supernodal fronts' w_pad)
constexpr int LOAD_ROWS = 16;    // rows a warp loads at once in the shared tier

// Shared-memory row pitch: odd, so a column is spread over the banks.
__host__ __device__ constexpr int pitch(int n) { return n | 1; }
constexpr int ZP = BLK + 1;      // the panel buffer's pitch

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

// The shared tier's memory: two BLK x UP scratch squares with 16-byte rows,
// the matrix at pitch(n), the panel buffer at ZP, the pivots and the signs:
//   U  the current diagonal block's L_D transposed, U[j][q] = L_D[q][j], so
//      the panel solve reads column j of L_D 16 bytes at a time;
//   X  the L21 rows of the next diagonal block, so its trailing update reads
//      them 16 bytes at a time;
//   Z  the panel's z = L21 d rows (the trailing update's left factor).
// UP = BLK + 16 bytes keeps a warp's 16-byte row stores free of bank
// conflicts (36 floats, 34 doubles).
template <typename T>
__host__ __device__ constexpr int up() { return BLK + 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ constexpr size_t shared_elems(int n) {
  return (size_t)2 * BLK * up<T>() + (size_t)n * pitch(n) + (size_t)n * ZP + 2 * (size_t)n;
}

// Factor the jb x jb diagonal block at (c, c) of s whose rows lane r holds
// in `row` (identity past jb): write L_D's strict lower triangle back, its
// transpose into U and the pivots into dv.  Warp 0.
template <typename T>
__device__ __forceinline__ void factor_block(T (&row)[BLK], T* s, T* U, T* dv, const T* sv,
                                             int P, int c, int jb, int r, T floor,
                                             bool use_floor) {
  const T sg = (use_floor && r < jb) ? sv[c + r] : T(1);
  ldl_rows<T, BLK>(row, r, jb, sg, floor, use_floor);
  if (r < jb) {
#pragma unroll
    for (int j = 0; j < BLK; ++j) {
      if (j < r) {
        s[(c + r) * P + c + j] = row[j];
        U[j * up<T>() + r] = row[j];
      }
    }
    dv[c + r] = row[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(TEAM_THREADS)
madqp_ldl_batched_shared_kernel(const T* __restrict__ F, T* __restrict__ L, T* __restrict__ D,
                                const T* __restrict__ sgn, T floor, int batch, int n,
                                long long sb, long long sr) {
  using VT = Vec<T>;
  using V = typename VT::V;
  constexpr int W = VT::W;
  constexpr int UP = up<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = pitch(n);
  const long long m = blockIdx.x;
  if (m >= batch) return;
  T* U = reinterpret_cast<T*>(smem_raw);
  T* X = U + BLK * UP;
  T* s = X + BLK * UP;
  T* Z = s + (size_t)n * P;
  T* dv = Z + (size_t)n * ZP;
  T* sv = dv + n;
  const T* a = F + m * sb;
  const int lane = threadIdx.x & 31;
  const int tw = threadIdx.x >> 5;
  const bool use_floor = sgn != nullptr;

  // The lower triangle into s: LOAD_ROWS rows of a 32-column strip per warp
  // at a time, all their loads in flight before the first store.
  for (int j = lane; j - lane < n; j += 32) {
    for (int i0 = tw; i0 < n; i0 += LOAD_ROWS * TEAM_WARPS) {
      T v[LOAD_ROWS];
#pragma unroll
      for (int u = 0; u < LOAD_ROWS; ++u) {
        const int i = i0 + u * TEAM_WARPS;
        v[u] = (i < n && j <= i) ? a[(long long)i * sr + j] : T(0);
      }
#pragma unroll
      for (int u = 0; u < LOAD_ROWS; ++u) {
        const int i = i0 + u * TEAM_WARPS;
        if (i < n && j <= i) s[i * P + j] = v[u];
      }
    }
  }
  for (int i = threadIdx.x; i < n; i += TEAM_THREADS)
    sv[i] = use_floor ? sgn[m * n + i] : T(1);
  __syncthreads();

  if (tw == 0) {  // a. the first diagonal block
    const int jb = n < BLK ? n : BLK;
    T row[BLK];
#pragma unroll
    for (int j = 0; j < BLK; ++j)
      row[j] = (lane < jb) ? ((j <= lane) ? s[lane * P + j] : T(0)) : (j == lane ? T(1) : T(0));
    factor_block<T>(row, s, U, dv, sv, P, 0, jb, lane, floor, use_floor);
  }
  __syncthreads();

  for (int c0 = 0; c0 + BLK < n; c0 += BLK) {
    const int c1 = c0 + BLK;
    // b. rows below the block, one per thread (n - BLK <= TEAM_THREADS):
    //    z L_D^T = p by forward substitution in registers; L21 = z / d_D into
    //    s, z into Z, and the next diagonal block's L21 rows also into X.
    const int i = c1 + threadIdx.x;
    T x[BLK];
#pragma unroll
    for (int j = 0; j < BLK; ++j) x[j] = T(0);
    if (i < n) {
#pragma unroll
      for (int j = 0; j < BLK; ++j) x[j] = s[i * P + c0 + j];
#pragma unroll
      for (int j = 0; j < BLK; ++j) {
#pragma unroll
        for (int c = (j + 1) / W; c < BLK / W; ++c) {
          T u[W];
          VT::put(u, *reinterpret_cast<const V*>(U + j * UP + c * W));
#pragma unroll
          for (int t = 0; t < W; ++t)
            if (c * W + t > j) x[c * W + t] -= x[j] * u[t];
        }
      }
      T l[BLK];
#pragma unroll
      for (int j = 0; j < BLK; ++j) {
        l[j] = x[j] / dv[c0 + j];
        s[i * P + c0 + j] = l[j];
        Z[i * ZP + j] = x[j];
      }
      if (i < c1 + BLK) {
#pragma unroll
        for (int c = 0; c < BLK / W; ++c)
          *reinterpret_cast<V*>(X + (i - c1) * UP + c * W) = VT::get(l + c * W);
      }
    }
    __syncthreads();

    // c. trailing update: s[i][j] -= sum_q z[i][q] l[j][q], c1 <= j <= i.
    const int jb = n - c1 < BLK ? n - c1 : BLK;
    if (tw == 0) {  // the next diagonal block (lane r's z is x), then its factor
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
      factor_block<T>(row, s, U, dv, sv, P, c1, jb, r, floor, use_floor);
    } else {  // the rows below it, a warp each
      for (int i = c1 + BLK + tw - 1; i < n; i += TEAM_WARPS - 1) {
        T z[BLK];
#pragma unroll
        for (int q = 0; q < BLK; ++q) z[q] = Z[i * ZP + q];
        for (int j = c1 + lane; j <= i; j += 32) {
          T acc = T(0);
#pragma unroll
          for (int q = 0; q < BLK; ++q) acc += z[q] * s[j * P + c0 + q];
          s[i * P + j] -= acc;
        }
      }
    }
    __syncthreads();
  }

  T* l = L + (size_t)m * n * n;
  for (int i = tw; i < n; i += TEAM_WARPS)
    for (int j = lane; j < n; j += 32)
      l[(size_t)i * n + j] = (j < i) ? s[i * P + j] : (j == i ? T(1) : T(0));
  for (int i = threadIdx.x; i < n; i += TEAM_THREADS) D[m * n + i] = dv[i];
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

template <typename T>
int launch_shared(const T* F, T* L, T* D, const T* sgn, T floor, int batch, int n,
                  long long sb, long long sr, cudaStream_t stream) {
  const size_t smem = shared_elems<T>(n) * sizeof(T);
  auto kernel = madqp_ldl_batched_shared_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<batch, TEAM_THREADS, smem, stream>>>(F, L, D, sgn, floor, batch, n, sb, sr);
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
  return launch_shared<T>(F, L, D, sgn, fl, batch, n, sb, sr, stream);
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
