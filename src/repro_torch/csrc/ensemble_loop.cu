// Per-feature-loop IIsy tree-ensemble lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/ensemble_lookup.py:
//   _loop_kernel  (:249, reached from ensemble_lookup_pallas_loop :289)
// the pre-fusion formulation that the tile autotune keeps as a candidate
// (TileConfig(impl='loop')). For each row n of x (N, F) and tree t:
//   range match  bins[f] = #{u : x[n,f] > edges[f,u]}             (range_match.cuh)
//   key          k = 0; for f = 0..F-1: k = k + ftable[f, bins[f], t] * strides[t, f]
//                (f32, in that order, then cast to int32)
//   leaf         dtable[t, k] for k in [0, S), else 0.0             (compare-select)
//   out[n, c]  = #{t : leaf == c}  (vote, c < Co)   or   sum_t leaf  (sum, Co == 1)
//
// The TPU ran each feature's lookup as a small one-hot matmul and the leaf
// select as a masked sum over S. Here one thread owns one row: F*U
// compares, then per tree F table reads and one decision-table read. Trees
// are the outer loop and features the inner one, so each key is summed in
// the reference's order; __fmul_rn/__fadd_rn keep nvcc from contracting the
// step into an FMA, so the key rounds as the plain version's does even
// past 2^24. The unflattened tables (int32 codes and strides, the unpadded
// (T, S) decision table) are read as the reference's kernel reads them.
//
// Bound: memory. At the serving shape (N=2048, F=5, U~39, T=10, S<=136)
// the call must move ~72 KB (x, tables, out): ~21 ns at 3.35 TB/s, far
// below a launch, so one launch per classify. Tables are staged once per
// block in dynamic shared memory when they fit (STAGED), else read through
// the read-only cache (__ldg). PERF.md holds the measured time.
//
// Exactness: codes, strides and payloads are integers carried in f32; keys
// below 2^24 and the sums (votes, or at most T 16-bit payloads) are exact,
// so the output is bit-identical to ensemble_lookup_loop_ref.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "range_match.cuh"

#define LP_MAX_CO 32   // per-row output columns kept in registers

template <bool STAGED, typename T>
__device__ __forceinline__ T lp_load(const T* p) {
  if (STAGED) return *p;
  return __ldg(p);
}

template <bool STAGED>
__global__ void ensemble_loop_kernel(
    const float* __restrict__ x, const float* __restrict__ edges,
    const int* __restrict__ ftab, const int* __restrict__ strides,
    const float* __restrict__ dtab, float* __restrict__ out, int n, int f_dim,
    int u_dim, int t_dim, int s_dim, int co, int vote) {
  extern __shared__ float lp_smem[];
  // per-thread feature-table offsets (f, bin) -> row of T codes,
  // feature-major so a warp's accesses for one feature fall on
  // consecutive banks
  int* binoff = reinterpret_cast<int*>(lp_smem);
  const float* e_tab = edges;
  const int* f_tab = ftab;
  const int* st_tab = strides;
  const float* d_tab = dtab;
  if (STAGED) {
    float* s = lp_smem + (size_t)f_dim * blockDim.x;
    const int ne = f_dim * u_dim;
    const int nf = f_dim * (u_dim + 1) * t_dim;
    const int ns = t_dim * f_dim;
    const int nd = t_dim * s_dim;
    int* si = reinterpret_cast<int*>(s);
    for (int i = threadIdx.x; i < ne; i += blockDim.x) s[i] = edges[i];
    for (int i = threadIdx.x; i < nf; i += blockDim.x) si[ne + i] = ftab[i];
    for (int i = threadIdx.x; i < ns; i += blockDim.x)
      si[ne + nf + i] = strides[i];
    for (int i = threadIdx.x; i < nd; i += blockDim.x)
      s[ne + nf + ns + i] = dtab[i];
    __syncthreads();
    e_tab = s;
    f_tab = si + ne;
    st_tab = si + ne + nf;
    d_tab = s + ne + nf + ns;
  }
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;   // ragged last block: no barrier follows

  const float* xr = x + (size_t)row * f_dim;
  for (int f = 0; f < f_dim; ++f) {
    const int b = range_match<STAGED>(__ldg(xr + f), e_tab + (size_t)f * u_dim,
                                      u_dim);
    binoff[f * blockDim.x + threadIdx.x] = (f * (u_dim + 1) + b) * t_dim;
  }

  float acc[LP_MAX_CO];
#pragma unroll
  for (int c = 0; c < LP_MAX_CO; ++c) acc[c] = 0.f;

  for (int t = 0; t < t_dim; ++t) {
    float kf = 0.f;
    for (int f = 0; f < f_dim; ++f) {
      const float code =
          (float)lp_load<STAGED>(f_tab + binoff[f * blockDim.x + threadIdx.x] + t);
      const float stride = (float)lp_load<STAGED>(st_tab + t * f_dim + f);
      kf = __fadd_rn(kf, __fmul_rn(code, stride));
    }
    const int key = (int)kf;
    const float leaf = (key >= 0 && key < s_dim)
                           ? lp_load<STAGED>(d_tab + (size_t)t * s_dim + key)
                           : 0.f;
    if (vote) {
#pragma unroll
      for (int c = 0; c < LP_MAX_CO; ++c)
        if (c < co) acc[c] += (leaf == (float)c) ? 1.f : 0.f;
    } else {
      acc[0] += leaf;
    }
  }
  float* o = out + (size_t)row * co;
#pragma unroll
  for (int c = 0; c < LP_MAX_CO; ++c)
    if (c < co) o[c] = acc[c];
}

// Bytes of dynamic shared memory a launch asks for (mirrored by
// loop_smem_bytes in kernels/ensemble_lookup.py, which the fit check uses).
static size_t lp_smem_bytes(int f_dim, int u_dim, int t_dim, int s_dim,
                            int staged, int block) {
  size_t bytes = (size_t)f_dim * block * sizeof(int);
  if (staged)
    bytes += ((size_t)f_dim * u_dim + (size_t)f_dim * (u_dim + 1) * t_dim +
              (size_t)t_dim * f_dim + (size_t)t_dim * s_dim) * 4;
  return bytes;
}

template <bool STAGED>
static int lp_launch(const float* x, const float* edges, const int* ftab,
                     const int* strides, const float* dtab, float* out, int n,
                     int f_dim, int u_dim, int t_dim, int s_dim, int co,
                     int vote, int block, size_t smem, cudaStream_t stream) {
  auto kern = ensemble_loop_kernel<STAGED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + block - 1) / block;
  kern<<<grid, block, smem, stream>>>(x, edges, ftab, strides, dtab, out, n,
                                      f_dim, u_dim, t_dim, s_dim, co, vote);
  return (int)cudaGetLastError();
}

extern "C" {

int ensemble_loop_launch(const void* x, const void* edges, const void* ftab,
                         const void* strides, const void* dtab, void* out,
                         int n, int f_dim, int u_dim, int t_dim, int s_dim,
                         int co, int vote, int staged, int block,
                         void* stream) {
  if (n <= 0) return 0;
  if (co < 1 || co > LP_MAX_CO || (!vote && co != 1) || block < 1 ||
      block > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lp_smem_bytes(f_dim, u_dim, t_dim, s_dim, staged, block);
  const float* xf = (const float*)x;
  const float* ef = (const float*)edges;
  const int* fi = (const int*)ftab;
  const int* si = (const int*)strides;
  const float* df = (const float*)dtab;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (staged)
    return lp_launch<true>(xf, ef, fi, si, df, of, n, f_dim, u_dim, t_dim,
                           s_dim, co, vote, block, smem, s);
  return lp_launch<false>(xf, ef, fi, si, df, of, n, f_dim, u_dim, t_dim,
                          s_dim, co, vote, block, smem, s);
}

const char* ensemble_loop_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
