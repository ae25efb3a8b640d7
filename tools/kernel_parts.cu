// The parts of K1's step, each timed alone on one CUDA card by
// tools/kernel_parts.py: the diagonal factor (factor_diag) on one CTA, one
// tile product of each tile configuration on 1 or many CTAs, and the grid
// barrier.  It includes the kernels' own source, so it times the code the
// kernels run.  Built with the kernels' flags (madqp_tpu_torch/ops/_build.py).

#include "../madqp_tpu_torch/csrc/cholesky.cu"

namespace {

template <typename T>
__global__ void __launch_bounds__(K1Tile<T>::THREADS, K1Tile<T>::MIN_CTAS)
diag_kernel(const T* A, T* L, T* Dinv, int n, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  for (int r = 0; r < reps; ++r) factor_diag<T>(A, L, Dinv, n, 0, NB, smem);
}

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_CTAS)
tile_kernel(const typename Cfg::T* X, int ld, int k, typename Cfg::T* out,
            int reps) {
  using T = typename Cfg::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  typename Cfg::Acc acc;
  madqp::zero(acc);
  const T* Bi = X + (size_t)blockIdx.x * Cfg::BM * ld;
  for (int r = 0; r < reps; ++r)
    madqp::tile_product<Cfg>(acc, smem, Bi, ld, Cfg::BM, X, ld, Cfg::BM, k);
  T* o = out + (size_t)blockIdx.x * Cfg::BM * Cfg::BM;
  madqp::for_each(acc, [&](int i, int j, T v) { o[i * Cfg::BM + j] = v; });
}

__global__ void sync_kernel(int reps) {
  cg::grid_group grid = cg::this_grid();
  for (int r = 0; r < reps; ++r) grid.sync();
}

template <typename T>
int diag(const void* A, void* L, void* Dinv, int n, int reps, cudaStream_t s) {
  auto k = diag_kernel<T>;
  constexpr int smem = smem_bytes<T>();
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<1, K1Tile<T>::THREADS, smem, s>>>((const T*)A, (T*)L, (T*)Dinv, n, reps);
  return (int)cudaGetLastError();
}

template <typename Cfg>
int tile(const void* X, int ld, int k, void* out, int ctas, int reps,
         cudaStream_t s) {
  using T = typename Cfg::T;
  auto kk = tile_kernel<Cfg>;
  constexpr int smem = madqp::ring_bytes<Cfg>();
  cudaFuncSetAttribute(kk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kk<<<ctas, Cfg::THREADS, smem, s>>>((const T*)X, ld, k, (T*)out, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// A: n x n SPD (n >= NB); its first NB x NB block is factored reps times.
extern "C" int parts_diag(int f64, const void* A, void* L, void* Dinv, int n,
                          int reps, void* s) {
  return f64 ? diag<double>(A, L, Dinv, n, reps, (cudaStream_t)s)
             : diag<float>(A, L, Dinv, n, reps, (cudaStream_t)s);
}

// which: 0 = K8 float32, 1 = K1 float32, 2 = K8 float64, 3 = K1 float64.
// X: at least ctas * 64 rows of k columns, row stride ld.
extern "C" int parts_tile(int which, const void* X, int ld, int k, void* out,
                          int ctas, int reps, void* s) {
  const cudaStream_t st = (cudaStream_t)s;
  switch (which) {
    case 0: return tile<madqp::Tile<float>>(X, ld, k, out, ctas, reps, st);
    case 1: return tile<K1Tile<float>>(X, ld, k, out, ctas, reps, st);
    case 2: return tile<madqp::Tile<double>>(X, ld, k, out, ctas, reps, st);
    default: return tile<K1Tile<double>>(X, ld, k, out, ctas, reps, st);
  }
}

extern "C" int parts_sync(int ctas, int threads, int reps, void* s) {
  void* args[] = {&reps};
  return (int)cudaLaunchCooperativeKernel((void*)sync_kernel, dim3(ctas),
                                          dim3(threads), args, 0,
                                          (cudaStream_t)s);
}

extern "C" int parts_tile_edge() { return NB; }
