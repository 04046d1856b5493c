// Standalone range match ("bucketize") for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bucketize.py:32
// _bucketize_kernel (pallas_call at :58), reached from bucketize_pallas and
// ops.bucketize. For x (N, F) f32 and edges (F, U) f32 (+inf padded):
//
//   out[n, f] = #{u : x[n, f] > edges[f, u]}          (range_match.cuh)
//
// as int32. The TPU padded N to a multiple of its 256-row tile and swept
// each tile against the whole edge table in VMEM. Here one thread owns one
// element (n, f): N*F threads, consecutive threads on consecutive elements,
// so x is read and out written coalesced, and the ragged last block is
// masked instead of padded. Each thread walks its feature's edge row
// through the read-only cache; the table is small (5 x 63 f32 = 1.3 KB on
// the served path) and every thread of a feature reads all of it, so after
// the first warp it comes from L1.
//
// Bound: memory. The call must move x, the edges and out once: at N=2048,
// F=5, U=63 about 83 KB, ~25 ns at 3.35 TB/s, far below one launch; its
// N*F*U compares take ~10 ns at the card's f32 rate.
//
// Exactness: integer counts, equal to the plain version bit for bit.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "range_match.cuh"

__global__ void bucketize_kernel(const float* __restrict__ x,
                                 const float* __restrict__ edges,
                                 int* __restrict__ out, long long total,
                                 int f_dim, int u_dim) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;   // ragged last block
  const int f = (int)(i % f_dim);
  out[i] = range_match<false>(__ldg(x + i), edges + (size_t)f * u_dim, u_dim);
}

extern "C" {

int bucketize_launch(const void* x, const void* edges, void* out, int n,
                     int f_dim, int u_dim, int block, void* stream) {
  if (n <= 0 || f_dim <= 0) return 0;
  if (u_dim < 0 || block < 1 || block > 1024)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * f_dim;
  const long long grid = (total + block - 1) / block;
  bucketize_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)edges, (int*)out, total, f_dim, u_dim);
  return (int)cudaGetLastError();
}

const char* bucketize_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
