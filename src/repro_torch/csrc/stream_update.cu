// Streaming register scatter, clamp and touched-row gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/stream_update.py:61
// _stream_update_kernel (pallas_call at :130), reached from
// stream_update_pallas and ops.stream_update. For the stacked register file
// regs (8, N) f32 (REGISTER_FIELDS order: pkt_count, byte_count, t_min,
// t_max, fwd_pkts, rev_pkts, fwd_bytes, rev_bytes) and one packet window
// (W lanes: bucket i32, ts, length, is_fwd f32, valid u8) it folds every
// valid lane into its bucket's registers, clamps the six count registers at
// `limit` (the 2^24 f32 exactness envelope) when asked, and gathers each
// lane's updated register row into rows (8, W). regs is updated IN PLACE.
//
// The TPU kernel is a one-hot MXU contraction per bucket tile whose rows
// block is revisited by every step of a grid that runs in order, and set
// up at step 0. On the card blocks run in no order, so that pattern would
// race. Here it is two launches on one stream:
//   1. scatter: one thread per lane. A valid lane whose bucket lies in
//      [0, N) atomicAdds its six integer-valued contributions to the count
//      registers and folds ts into t_min / t_max. CUDA has no float atomic
//      min/max: a value with the sign bit clear takes atomicMin/Max on its
//      int bits, one with the sign bit set atomicMax/Min on its unsigned
//      bits, which orders every float (including +-inf, the identities of
//      an untouched bucket, and the negative timestamps an explicit epoch
//      can give). Invalid lanes touch nothing.
//   2. finish: thread i adds +0.0 to column i's count registers and clamps
//      them (i < N), and gathers lane i's row (i < W), applying the same
//      +0.0 and clamp to what it reads. A read may race column b's clamp;
//      both orders give the same bits, because the map is idempotent.
//
// Exactness against the plain version (kernels/ref.py stream_update_ref,
// regs + per-bucket sums, then the clamp): integer-valued f32 adds are
// exact in any order below 2^24; with the clamp on, a sum that crosses
// 2^24 still rounds to at least 2^24 in any order and clamps to exactly
// 2^24; min/max are exact in any order. The +0.0 makes an untouched
// column's count registers what regs + 0.0 gives in the plain version
// (-0.0 becomes +0.0). Products use __fmul_rn/__fsub_rn so the compiler
// cannot contract them differently from the plain version.
//
// Bound: memory. In place, the function must read the six count rows whole
// (the clamp sees every column), t_min/t_max only at the columns the lanes
// name, and the window (17 B a lane), and write the register words that
// change and the rows (8*W*4 bytes); its adds and compares take less at the
// card's f32 rate. This design moves more: kernel 2 reads and writes the
// six count rows whole, and the pair pays two launches.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

namespace {

constexpr int kRegisters = 8;
constexpr int kTMin = 2;
constexpr int kTMax = 3;

// k-th count register (pkt, byte, fwd/rev pkts, fwd/rev bytes): 0 1 4 5 6 7
__device__ __forceinline__ int count_row(int k) { return k < 2 ? k : k + 2; }

__device__ __forceinline__ bool sign_set(float v) {
  return (__float_as_uint(v) >> 31) != 0u;
}

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (!sign_set(v))
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (!sign_set(v))
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// regs + 0.0, then the clamp: what the plain version leaves in a count
// register. Idempotent, so applying it twice changes nothing.
__device__ __forceinline__ float settle(float v, bool has_limit, float limit) {
  v = __fadd_rn(v, 0.0f);
  return (has_limit && v > limit) ? limit : v;
}

__global__ void su_scatter_kernel(float* __restrict__ regs,
                                  const int* __restrict__ bucket,
                                  const float* __restrict__ ts,
                                  const float* __restrict__ length,
                                  const float* __restrict__ is_fwd,
                                  const unsigned char* __restrict__ valid,
                                  int n, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w || !valid[i]) return;
  const int b = bucket[i];
  if (b < 0 || b >= n) return;          // dropped, as the segment ops drop it
  const float ln = length[i];
  const float fw = is_fwd[i];
  const float rv = __fsub_rn(1.0f, fw);
  const size_t col = (size_t)b;
  const size_t nn = (size_t)n;
  atomicAdd(regs + 0 * nn + col, 1.0f);
  atomicAdd(regs + 1 * nn + col, ln);
  atomicAdd(regs + 4 * nn + col, fw);
  atomicAdd(regs + 5 * nn + col, rv);
  atomicAdd(regs + 6 * nn + col, __fmul_rn(ln, fw));
  atomicAdd(regs + 7 * nn + col, __fmul_rn(ln, rv));
  const float t = ts[i];
  atomic_min_f32(regs + kTMin * nn + col, t);
  atomic_max_f32(regs + kTMax * nn + col, t);
}

__global__ void su_finish_kernel(float* regs, const int* __restrict__ bucket,
                                 float* __restrict__ rows, int n, int w,
                                 int has_limit, float limit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nn = (size_t)n;
  const bool lim = has_limit != 0;
  if (i < n) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float* r = regs + count_row(k) * nn + i;
      *r = settle(*r, lim, limit);
    }
  }
  if (i < w) {
    int b = bucket[i];
    if (b < 0) b += n;                  // the reference's gather semantics
    b = b < 0 ? 0 : (b >= n ? n - 1 : b);
    const volatile float* src = regs + (size_t)b;
#pragma unroll
    for (int r = 0; r < kRegisters; ++r) {
      float v = src[r * nn];
      if (r != kTMin && r != kTMax) v = settle(v, lim, limit);
      rows[(size_t)r * w + i] = v;
    }
  }
}

}  // namespace

extern "C" {

int stream_update_launch(void* regs, const void* bucket, const void* ts,
                         const void* length, const void* is_fwd,
                         const void* valid, void* rows, int n, int w,
                         int has_limit, int limit_bits, int block,
                         void* stream) {
  if (n <= 0 || w < 0 || block < 1 || block > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float limit;
  memcpy(&limit, &limit_bits, sizeof(float));
  if (w > 0) {
    su_scatter_kernel<<<(w + block - 1) / block, block, 0, s>>>(
        (float*)regs, (const int*)bucket, (const float*)ts,
        (const float*)length, (const float*)is_fwd,
        (const unsigned char*)valid, n, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = n > w ? n : w;
  su_finish_kernel<<<(threads + block - 1) / block, block, 0, s>>>(
      (float*)regs, (const int*)bucket, (float*)rows, n, w, has_limit, limit);
  return (int)cudaGetLastError();
}

const char* stream_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
