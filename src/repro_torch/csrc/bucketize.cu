// Standalone range match ("bucketize") for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bucketize.py:32
// _bucketize_kernel (pallas_call at :58), reached from bucketize_pallas and
// ops.bucketize. For x (N, F) f32 and edges (F, U) f32 (+inf padded):
//
//   out[n, f] = #{u : x[n, f] > edges[f, u]}
//
// as int32. A count, not a search: the reference counts on any edge row,
// sorted or not, so no binary search stands in for it. A strict '>': a
// value equal to an edge stays below it, NaN lands in bin 0, the +inf pads
// never match, +-inf inputs compare as any other value.
//
// Bound: memory. The call must move x, the edges and out once: at the fit's
// shape (N=16000, F=5, U=63) 641 KB, 0.19 us at 3.35 TB/s; its N*F*U
// compares take ~0.08 us at the card's f32 rate. Both sit far below one
// launch (~2 us a graph node on an H100), so the kernel is a single launch
// whose own work must stay short next to that floor.
//
// Design. The TPU padded N to its 256-row tile and swept each tile against
// the whole table in VMEM with vectorised compares. A thread that walks
// its edge row one compare after another waits on a 63-long chain of
// dependent loads and adds, far longer than the launch itself; so:
//   - a block takes one feature (blockIdx.y) and `block` rows of x; each
//     warp stages its own copy of that edge row in shared memory, padded
//     with +inf to a multiple of 8 (never matched), loads issued before
//     stores, so the row costs one round trip overlapped with the element
//     loads, and a warp waits on no other warp (__syncwarp, no block
//     barrier);
//   - the warp summarises each group of 8 edges by its (min, max). An
//     element above a group's max counts all 8 of its edges, one at or
//     below its min none: exact for any row, since every edge of the
//     group lies in [min, max] (a group holding a NaN gets (-inf, +inf)
//     and is never summed whole). Only an element that falls inside
//     exactly one group compares that group's 8 edges; one inside several
//     (a row out of order, a NaN element) compares the whole row. On a
//     sorted row, as the fit's quantile edges are, an element lies inside
//     at most one group: 8 summary tests and 8 compares in place of 63;
//   - the compares are independent: `set.gt` gives an all-ones mask per
//     edge and one three-operand subtract adds two of them, into two
//     partial counts; the staged words are read 16 bytes at a time by
//     every lane of the warp at once (a broadcast).
// Many small blocks (N / 128 x F) spread the work over every SM. On an
// H100, a block-wide copy of the row behind a barrier, fewer and larger
// blocks, several elements or several lanes to an element, or a block
// staging all F rows each took longer. A row past the shared-memory
// budget (the block's copies beyond 48 KB: U beyond 2,456 at 128 rows),
// or F beyond the grid's 65,535, takes the serial walk of range_match.cuh
// through the read-only cache, one element per thread.
//
// Exactness: integer counts, equal to the plain version bit for bit.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "range_match.cuh"

namespace {

constexpr int kSmemFloats = 12288;  // 48 KB, the default cap
constexpr int kGlobalBlock = 256;

// 0xffffffff where v > e (strict, false for NaN), else 0
__device__ __forceinline__ unsigned gt_mask(float v, float e) {
  unsigned r;
  asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(r) : "f"(v), "f"(e));
  return r;
}

// floats of one warp's staging: the row padded to a multiple of 8 (+inf),
// then a (min, max) pair per group of 8, rounded up to a 16-byte multiple
__host__ __device__ __forceinline__ int warp_floats(int u_dim) {
  const int up = (u_dim + 7) & ~7;
  return (up + up / 4 + 3) & ~3;
}

__global__ void __launch_bounds__(1024)
bucketize_staged(const float* __restrict__ x, const float* __restrict__ edges,
                 int* __restrict__ out, long long n, int f_dim, int u_dim) {
  extern __shared__ float4 rows4[];
  const int up = (u_dim + 7) & ~7;
  const int groups = up / 8;
  const int lane = threadIdx.x % 32;
  // this warp's own copy of the row and of its group summaries
  float* row = reinterpret_cast<float*>(rows4) +
               (threadIdx.x / 32) * warp_floats(u_dim);
  const float4* row4 = reinterpret_cast<const float4*>(row);
  float2* sums = reinterpret_cast<float2*>(row + up);
  const int f = blockIdx.y;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float v = r < n ? __ldg(x + r * f_dim + f) : 0.f;
  // the row in one round trip: a pass issues all its loads, then stores
  for (int k0 = 0; k0 < up; k0 += 128) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + i * 32 + lane;
      e[i] = k < u_dim ? __ldg(edges + (size_t)f * u_dim + k) : INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + i * 32 + lane;
      if (k < up) row[k] = e[i];
    }
  }
  __syncwarp();
  // a group holding a NaN edge gets (-inf, +inf): it is never counted
  // whole, so its edges are compared one by one
  for (int k = lane; k < groups; k += 32) {
    float lo = INFINITY, hi = -INFINITY;
    bool nan = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = row[8 * k + i];
      nan |= e != e;
      lo = fminf(lo, e);
      hi = fmaxf(hi, e);
    }
    sums[k] = nan ? make_float2(-INFINITY, INFINITY) : make_float2(lo, hi);
  }
  __syncwarp();
  // v above a group's max counts all 8 of its edges, v at or below its min
  // none; a group in between is "open"
  unsigned whole = 0u;
  int open = 0, which = 0;
#pragma unroll 4
  for (int k = 0; k < groups; ++k) {
    const float2 g = sums[k];
    const bool above = v > g.y;
    const bool inside = !above && !(v <= g.x);
    whole += above ? 8u : 0u;
    open += inside;
    which = inside ? k : which;
  }
  // two partial counts, each subtracting a pair of masks per step
  unsigned c0 = 0u, c1 = 0u;
  if (open == 1) {
    const float4 e0 = row4[2 * which], e1 = row4[2 * which + 1];
    c0 = whole - gt_mask(v, e0.x) - gt_mask(v, e0.y) - gt_mask(v, e1.x) -
         gt_mask(v, e1.y);
    c1 = 0u - gt_mask(v, e0.z) - gt_mask(v, e0.w) - gt_mask(v, e1.z) -
         gt_mask(v, e1.w);
  } else if (open > 1) {
#pragma unroll 4
    for (int w = 0; w < up / 4; ++w) {
      const float4 e = row4[w];
      c0 = c0 - gt_mask(v, e.x) - gt_mask(v, e.y);
      c1 = c1 - gt_mask(v, e.z) - gt_mask(v, e.w);
    }
  } else {
    c0 = whole;
  }
  if (r < n) out[r * f_dim + f] = (int)(c0 + c1);
}

// a row over the shared-memory budget: one element per thread, the shared
// serial walk through the read-only cache
__global__ void bucketize_global(const float* __restrict__ x,
                                 const float* __restrict__ edges,
                                 int* __restrict__ out, long long total,
                                 int f_dim, int u_dim) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;   // ragged last block
  const int f = (int)(i % f_dim);
  out[i] = range_match<false>(__ldg(x + i), edges + (size_t)f * u_dim, u_dim);
}

}  // namespace

extern "C" {

// block: rows of x a staged block takes (a multiple of 32, up to 1024)
int bucketize_launch(const void* x, const void* edges, void* out, int n,
                     int f_dim, int u_dim, int block, void* stream) {
  if (n <= 0 || f_dim <= 0) return 0;
  if (u_dim < 0 || block < 32 || block > 1024 || block % 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* ef = (const float*)edges;
  int* o = (int*)out;
  // the grid's y dimension holds at most 65535 features
  if ((long long)warp_floats(u_dim) * (block / 32) > kSmemFloats ||
      f_dim > 65535) {
    const long long total = (long long)n * f_dim;
    const long long grid = (total + kGlobalBlock - 1) / kGlobalBlock;
    bucketize_global<<<(unsigned)grid, kGlobalBlock, 0, st>>>(
        xf, ef, o, total, f_dim, u_dim);
    return (int)cudaGetLastError();
  }
  const unsigned gx = (unsigned)(((long long)n + block - 1) / block);
  const size_t smem = sizeof(float) * (size_t)warp_floats(u_dim) * (block / 32);
  bucketize_staged<<<dim3(gx, f_dim), block, smem, st>>>(
      xf, ef, o, (long long)n, f_dim, u_dim);
  return (int)cudaGetLastError();
}

const char* bucketize_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
