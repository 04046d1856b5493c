// Fused IIsy classical-model lookup (SVM / naive Bayes / K-Means) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/classical_lookup.py:36
// _fused_classical_kernel (pallas_call at :64), reached from
// classical_lookup_fused and the compat entry classical_lookup_pallas. For
// each row n of x (N, F):
//
//   range match  bins[f]  = #{u : x[n,f] > edges[f,u]}               (range_match.cuh)
//   value sum    out[n,m] = sum_f vtab[(f*Bp + bins[f]) * Mp + m],  m < M
//
// vtab is vtable_flat (F*Bp, Mp): feature f owns rows [f*Bp, (f+1)*Bp), and
// each row holds the quantized partial terms of one bin (SVM plane terms,
// NB log-likelihoods, K-Means squared distances). The output is (N, M): the
// lane-padding columns M..Mp are never written.
//
// The TPU wrote the lookup as one blocked one-hot matmul because Pallas has
// no gather. Here one thread owns one row: F*U compares, then F gathers of
// M values each. The tables are staged once per block in dynamic shared
// memory when they fit (STAGED; above 48 KB through the opt-in), else read
// through the read-only cache. The sums are kept in registers, CL_CHUNK
// columns at a time; a model with more columns walks the range match again
// for each chunk (M is 1-2 on the served models, 10 for a 5-class SVM).
//
// Bound: memory. The call must move x, the edges, vtable_flat and out once:
// at the served shape (N=2048, F=5, U=63, Bp=64, Mp=8, M<=2) about 69 KB,
// ~20 ns at 3.35 TB/s, far below one launch; so the design keeps to one
// launch per classify.
//
// Exactness envelope: vtable entries are integers |q| <= 2^(bits-1) - 1.
// While F * (2^(bits-1) - 1) <= 2^24 every partial sum is an integer that
// f32 holds exactly, so the sum is exact in any order and the output equals
// the plain PyTorch version bit for bit. At action_bits=16 that covers
// F <= 512 (the served models have F=5). No matmul, so TF32 cannot enter.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "range_match.cuh"

#define CL_CHUNK 16   // output columns summed in registers per pass

template <bool STAGED>
__global__ void classical_lookup_kernel(
    const float* __restrict__ x, const float* __restrict__ edges,
    const float* __restrict__ vtab, float* __restrict__ out, int n,
    int f_dim, int u_dim, int b_pad, int m_pad, int m_dim) {
  extern __shared__ float cl_smem[];
  const float* e_tab = edges;
  const float* v_tab = vtab;
  if (STAGED) {
    const int ne = f_dim * u_dim;
    const int nv = f_dim * b_pad * m_pad;
    for (int i = threadIdx.x; i < ne; i += blockDim.x) cl_smem[i] = edges[i];
    for (int i = threadIdx.x; i < nv; i += blockDim.x) cl_smem[ne + i] = vtab[i];
    __syncthreads();
    e_tab = cl_smem;
    v_tab = cl_smem + ne;
  }
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;   // ragged last block: no barrier follows

  const float* xr = x + (size_t)row * f_dim;
  float* o = out + (size_t)row * m_dim;
  for (int m0 = 0; m0 < m_dim; m0 += CL_CHUNK) {
    float acc[CL_CHUNK];
#pragma unroll
    for (int c = 0; c < CL_CHUNK; ++c) acc[c] = 0.f;
    for (int f = 0; f < f_dim; ++f) {
      const int b = range_match<STAGED>(__ldg(xr + f),
                                        e_tab + (size_t)f * u_dim, u_dim);
      const float* v = v_tab + ((size_t)f * b_pad + b) * m_pad + m0;
#pragma unroll
      for (int c = 0; c < CL_CHUNK; ++c)
        if (m0 + c < m_dim) acc[c] += rm_load<STAGED>(v + c);
    }
#pragma unroll
    for (int c = 0; c < CL_CHUNK; ++c)
      if (m0 + c < m_dim) o[m0 + c] = acc[c];
  }
}

// Bytes of dynamic shared memory a launch asks for (mirrored by
// smem_bytes in kernels/classical_lookup.py, which the fit check uses).
static size_t cl_smem_bytes(int f_dim, int u_dim, int b_pad, int m_pad,
                            int staged) {
  if (!staged) return 0;
  return ((size_t)f_dim * u_dim + (size_t)f_dim * b_pad * m_pad) *
         sizeof(float);
}

template <bool STAGED>
static int cl_launch(const float* x, const float* edges, const float* vtab,
                     float* out, int n, int f_dim, int u_dim, int b_pad,
                     int m_pad, int m_dim, int block, size_t smem,
                     cudaStream_t stream) {
  auto kern = classical_lookup_kernel<STAGED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + block - 1) / block;
  kern<<<grid, block, smem, stream>>>(x, edges, vtab, out, n, f_dim, u_dim,
                                      b_pad, m_pad, m_dim);
  return (int)cudaGetLastError();
}

extern "C" {

int classical_lookup_launch(const void* x, const void* edges, const void* vtab,
                            void* out, int n, int f_dim, int u_dim, int b_pad,
                            int m_pad, int m_dim, int staged, int block,
                            void* stream) {
  if (n <= 0) return 0;
  if (f_dim < 1 || u_dim < 0 || b_pad < u_dim + 1 || m_dim < 1 ||
      m_dim > m_pad || block < 1 || block > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cl_smem_bytes(f_dim, u_dim, b_pad, m_pad, staged);
  const float* xf = (const float*)x;
  const float* ef = (const float*)edges;
  const float* vf = (const float*)vtab;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (staged)
    return cl_launch<true>(xf, ef, vf, of, n, f_dim, u_dim, b_pad, m_pad,
                           m_dim, block, smem, s);
  return cl_launch<false>(xf, ef, vf, of, n, f_dim, u_dim, b_pad, m_pad,
                          m_dim, block, smem, s);
}

const char* classical_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
