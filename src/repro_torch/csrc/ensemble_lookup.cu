// Fused IIsy tree-ensemble lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/ensemble_lookup.py:
//   _fused_kernel          (:112, select='matmul')
//   _fused_compare_kernel  (:132, select='compare')
// Both compute, for each row n of x (N, F):
//   range match   bins[f] = #{u : x[n,f] > edges[f,u]}            (range_match.cuh)
//   decision key  key[t]  = sum_f ftab[(f*Bp + bins[f]) * Tp + t]  (stride-premultiplied)
//   matmul select out[n,c] = sum_t dtab[(c*T + t) * Sp + key[t]]    (dtable_flat (Co,T,Sp))
//   compare select leaf[t] = dtab[t * Sp + key[t]], then
//                  out[n,c] = #{t : leaf[t] == c} (Co > 1)  or  sum_t leaf[t] (Co == 1)
//
// The TPU wrote each lookup as a one-hot matmul because Pallas has no gather.
// Hopper gathers from shared memory directly, so here one thread owns one
// row: F*U compares, F*T table reads for the keys, T (or T*Co) decision-table
// reads. Both selects are gathers on this card; 'select' only picks which of
// the two equivalent decision tables is read.
//
// Bound: memory. At the serving shape (N=2048, F=5, U~40, T=10, Sp~136, Co=2)
// the call must move ~75 KB (x, tables, out): ~22 ns at 3.35 TB/s, far below
// a launch, so the design keeps to one launch per classify and no host work
// between launches. Tables are staged once per block in dynamic shared
// memory when they fit (STAGED), else read through the read-only cache
// (__ldg) — the large mapped-XGB decision table (60 x 5712) takes that path.
// Measured (PERF.md): ~16 us of device time per launch at that shape — the
// per-thread chain of compares and dependent reads on 16 blocks, not bytes.
//
// Exactness: keys and payloads are integers carried in f32 below 2^24, so
// every sum is exact in any order and the output is bit-identical to the
// plain PyTorch version. No matmul, so TF32 cannot enter.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "range_match.cuh"

#define EL_MAX_CO 32   // per-row output columns kept in registers

template <bool COMPARE, bool STAGED>
__global__ void ensemble_lookup_kernel(
    const float* __restrict__ x, const float* __restrict__ edges,
    const float* __restrict__ ftab, const float* __restrict__ dtab,
    float* __restrict__ out, int n, int f_dim, int u_dim, int b_pad,
    int t_pad, int t_dim, int s_pad, int co) {
  extern __shared__ float el_smem[];
  // per-thread feature-table row offsets, feature-major so a warp's
  // accesses for one feature fall on consecutive banks
  int* rowoff = reinterpret_cast<int*>(el_smem);
  const float* e_tab = edges;
  const float* f_tab = ftab;
  const float* d_tab = dtab;
  if (STAGED) {
    float* s = el_smem + (size_t)f_dim * blockDim.x;
    const int ne = f_dim * u_dim;
    const int nf = f_dim * b_pad * t_pad;
    const int nd = (COMPARE ? 1 : co) * t_dim * s_pad;
    for (int i = threadIdx.x; i < ne; i += blockDim.x) s[i] = edges[i];
    for (int i = threadIdx.x; i < nf; i += blockDim.x) s[ne + i] = ftab[i];
    for (int i = threadIdx.x; i < nd; i += blockDim.x) s[ne + nf + i] = dtab[i];
    __syncthreads();
    e_tab = s;
    f_tab = s + ne;
    d_tab = s + ne + nf;
  }
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;   // ragged last block: no barrier follows

  const float* xr = x + (size_t)row * f_dim;
  for (int f = 0; f < f_dim; ++f) {
    const int b = range_match<STAGED>(__ldg(xr + f), e_tab + (size_t)f * u_dim,
                                      u_dim);
    rowoff[f * blockDim.x + threadIdx.x] = (f * b_pad + b) * t_pad;
  }

  float acc[EL_MAX_CO];
#pragma unroll
  for (int c = 0; c < EL_MAX_CO; ++c) acc[c] = 0.f;

  for (int t = 0; t < t_dim; ++t) {
    float kf = 0.f;
    for (int f = 0; f < f_dim; ++f)
      kf += rm_load<STAGED>(f_tab + rowoff[f * blockDim.x + threadIdx.x] + t);
    const int key = (int)kf;                  // exact: integer below 2^24
    if (COMPARE) {
      const float leaf = rm_load<STAGED>(d_tab + (size_t)t * s_pad + key);
      if (co == 1) {
        acc[0] += leaf;
      } else {
#pragma unroll
        for (int c = 0; c < EL_MAX_CO; ++c)
          if (c < co) acc[c] += (leaf == (float)c) ? 1.f : 0.f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < EL_MAX_CO; ++c)
        if (c < co)
          acc[c] += rm_load<STAGED>(d_tab + ((size_t)c * t_dim + t) * s_pad + key);
    }
  }
  float* o = out + (size_t)row * co;
#pragma unroll
  for (int c = 0; c < EL_MAX_CO; ++c)
    if (c < co) o[c] = acc[c];
}

template <bool COMPARE, bool STAGED>
static int el_launch(const float* x, const float* edges, const float* ftab,
                     const float* dtab, float* out, int n, int f_dim, int u_dim,
                     int b_pad, int t_pad, int t_dim, int s_pad, int co,
                     int block, size_t smem, cudaStream_t stream) {
  auto kern = ensemble_lookup_kernel<COMPARE, STAGED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + block - 1) / block;
  kern<<<grid, block, smem, stream>>>(x, edges, ftab, dtab, out, n, f_dim,
                                      u_dim, b_pad, t_pad, t_dim, s_pad, co);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory a launch asks for (mirrored by
// smem_bytes in kernels/ensemble_lookup.py, which the fit check uses).
static size_t el_smem_bytes(int f_dim, int u_dim, int b_pad, int t_pad,
                            int t_dim, int s_pad, int co, int compare,
                            int staged, int block) {
  size_t bytes = (size_t)f_dim * block * sizeof(int);
  if (staged)
    bytes += ((size_t)f_dim * u_dim + (size_t)f_dim * b_pad * t_pad +
              (size_t)(compare ? 1 : co) * t_dim * s_pad) * sizeof(float);
  return bytes;
}

extern "C" {

int ensemble_lookup_launch(const void* x, const void* edges, const void* ftab,
                           const void* dtab, void* out, int n, int f_dim,
                           int u_dim, int b_pad, int t_pad, int t_dim,
                           int s_pad, int co, int compare, int staged,
                           int block, void* stream) {
  if (n <= 0) return 0;
  if (co < 1 || co > EL_MAX_CO || block < 1 || block > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = el_smem_bytes(
      f_dim, u_dim, b_pad, t_pad, t_dim, s_pad, co, compare, staged, block);
  const float* xf = (const float*)x;
  const float* ef = (const float*)edges;
  const float* ff = (const float*)ftab;
  const float* df = (const float*)dtab;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (compare) {
    if (staged)
      return el_launch<true, true>(xf, ef, ff, df, of, n, f_dim, u_dim, b_pad,
                                   t_pad, t_dim, s_pad, co, block, smem, s);
    return el_launch<true, false>(xf, ef, ff, df, of, n, f_dim, u_dim, b_pad,
                                  t_pad, t_dim, s_pad, co, block, smem, s);
  }
  if (staged)
    return el_launch<false, true>(xf, ef, ff, df, of, n, f_dim, u_dim, b_pad,
                                  t_pad, t_dim, s_pad, co, block, smem, s);
  return el_launch<false, false>(xf, ef, ff, df, of, n, f_dim, u_dim, b_pad,
                                 t_pad, t_dim, s_pad, co, block, smem, s);
}

const char* ensemble_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
