// Masked register reset (the eviction sweep's scatter) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/evict.py:27
// _evict_fill_kernel (pallas_call at :47), reached from evict_fill_pallas
// and ops.evict_fill, which age_out and approx_lru_sweep call. For the
// stacked register file regs (R, N) f32, mask (N,) u8 and fills (R,) f32:
//
//   out[r, n] = mask[n] ? fills[r] : regs[r, n]
//
// The TPU swept (R, 1024) VMEM tiles with the mask row broadcast inside the
// tile. Here one thread owns one column: it reads the mask once, then
// writes the R registers of its column, each from the fill or from regs.
// Consecutive threads hold consecutive columns, so every register row is
// read and written coalesced; the ragged last block is masked instead of
// padded.
//
// Bound: memory. The function reads regs and the mask once and writes out
// once: R*N*4*2 + N bytes, 532 KB at R=8, N=8192, 0.16 us at 3.35 TB/s.
// There is no arithmetic. A column that is evicted skips its reads.
//
// Exactness: a select, bit for bit the plain version (torch.where).
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <stddef.h>

__global__ void evict_fill_kernel(const float* __restrict__ regs,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ fills,
                                  float* __restrict__ out, int r_dim, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;   // ragged last block
  const size_t nn = (size_t)n;
  if (mask[i]) {
    for (int r = 0; r < r_dim; ++r) out[r * nn + i] = __ldg(fills + r);
  } else {
    for (int r = 0; r < r_dim; ++r) out[r * nn + i] = __ldg(regs + r * nn + i);
  }
}

extern "C" {

int evict_launch(const void* regs, const void* mask, const void* fills,
                 void* out, int r_dim, int n, int block, void* stream) {
  if (n <= 0 || r_dim <= 0) return 0;
  if (block < 1 || block > 1024) return (int)cudaErrorInvalidValue;
  evict_fill_kernel<<<(n + block - 1) / block, block, 0,
                      (cudaStream_t)stream>>>(
      (const float*)regs, (const unsigned char*)mask, (const float*)fills,
      (float*)out, r_dim, n);
  return (int)cudaGetLastError();
}

const char* evict_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
