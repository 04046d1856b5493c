// Masked register reset and the timeout sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/evict.py:27
// _evict_fill_kernel (pallas_call at :47), reached from evict_fill_pallas
// and ops.evict_fill, which age_out and approx_lru_sweep call. Two entries,
// one template each over the register count R (8, REGISTER_FIELDS):
//
//   evict_fill (the TPU kernel's counterpart, out of place): for regs
//   (R, N) f32, mask (N,) u8 and fills (R,) f32
//       out[r, n] = mask[n] ? fills[r] : regs[r, n]
//
//   evict_sweep (the whole timeout sweep of a window, in place): for the
//   window's ts (W,) f32 and valid (W,) u8, evict_age and fills,
//       now    = max(ts[valid]),  w_min = min(ts[valid])
//       cutoff = min(now - evict_age, w_min)          (netsim evict_cutoff)
//       evict  = regs[0, n] > 0 && regs[3, n] < cutoff
//       regs[:, n] = fills where evict;  n_evicted = #evict (i32 scalar)
//   A NaN timestamp on a valid lane makes the cutoff NaN, as torch.max /
//   torch.min / torch.minimum propagate it (fmaxf and fminf would drop
//   it), and nothing is evicted; a window with no valid lane gives -inf.
//
// The TPU swept (R, 1024) VMEM tiles with the mask row broadcast inside the
// tile, and under jax.jit XLA folded the cutoff, the mask and the count into
// the same program. On this card each of those is a launch of its own
// (about 1.9 us each graph-replayed, 14 of them a step); evict_sweep does
// all of it in one. Each block reduces the window itself (W <= a few
// thousand lanes, read from L2, 16 bytes a load) while its first columns'
// rows 0 and 3 are in flight; a surviving column is neither rewritten nor
// read past those two rows. The count leaves in the same launch: every
// block adds its count and a ticket to one 64-bit word (ev_done) in one
// atomic, and the block that takes the last ticket writes the total and
// zeroes the word for the next launch (the sweeps of a device run one at a
// time, in stream order).
//
// A thread owns EV_COLS consecutive columns: one 4-byte mask read and
// 16-byte row loads and stores where N % 4 == 0 and the rows are aligned
// (4-byte accesses otherwise). evict_fill loads all of its rows before
// any store; the grid is sized for the SM count (kernels/evict.py
// fill_plan / sweep_plan).
//
// Bound: memory. evict_fill reads regs and the mask once and writes out
// once: R*N*4*2 + N bytes, 532 KB at R=8, N=8192, 0.16 us at 3.35 TB/s.
// evict_sweep reads rows 0 and 3, the window (5 B a lane) and writes the
// evicted columns: about 70 KB at N=8192, W=1024 with few evictions,
// ~0.02 us, far below a launch.
//
// Exactness: selects and compares, bit for bit the plain versions.
//
// Plain C interface (bound with ctypes): the launchers return
// cudaGetLastError() and allocate nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define EV_R 8          // registers of the file (REGISTER_FIELDS)
#define EV_COLS 4       // consecutive columns a thread owns

namespace {

// The sweep's blocks that are done (high 32 bits) and their evictions (low
// 32 bits), one word so that a block reports both in one atomic.
__device__ unsigned long long ev_done;

// one thread's EV_COLS columns of row r: 16 bytes where vec, else 4-byte
// loads of the columns below n (0 past n)
__device__ __forceinline__ float4 ev_load(const float* row, int c0, int n,
                                          bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(row + c0);
  float v[EV_COLS];
#pragma unroll
  for (int j = 0; j < EV_COLS; ++j) v[j] = c0 + j < n ? row[c0 + j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float ev_at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// the columns of c0.. whose bit of `take` is set get f, the rest keep v
__device__ __forceinline__ float4 ev_pick(unsigned take, float f,
                                          const float4& v) {
  return make_float4(take & 1 ? f : v.x, take & 2 ? f : v.y,
                     take & 4 ? f : v.z, take & 8 ? f : v.w);
}

template <int R>
__global__ void evict_fill_kernel(const float* __restrict__ regs,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ fills,
                                  float* __restrict__ out, int n, int vec) {
  float fill[R];
#pragma unroll
  for (int r = 0; r < R; ++r) fill[r] = __ldg(fills + r);
  const size_t nn = (size_t)n;
  const int quads = (n + EV_COLS - 1) / EV_COLS;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += gridDim.x * blockDim.x) {
    const int c0 = q * EV_COLS;
    unsigned take = 0;
    if (vec) {
      const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(mask + c0));
      take = (m.x ? 1u : 0u) | (m.y ? 2u : 0u) | (m.z ? 4u : 0u) |
             (m.w ? 8u : 0u);
    } else {
#pragma unroll
      for (int j = 0; j < EV_COLS; ++j)
        take |= (c0 + j < n && __ldg(mask + c0 + j)) ? 1u << j : 0u;
    }
    // every row's loads, then every store; a quad evicted whole reads none
    float4 v[R];
    const bool keep_any = take != 0xFu;
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = keep_any ? ev_load(regs + r * nn, c0, n, vec)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 o = ev_pick(take, fill[r], v[r]);
      float* dst = out + r * nn + c0;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = o;
      } else {
#pragma unroll
        for (int j = 0; j < EV_COLS; ++j)
          if (c0 + j < n) dst[j] = ev_at(o, j);
      }
    }
  }
}

template <int R>
__global__ void evict_sweep_kernel(float* __restrict__ regs,
                                   const float* __restrict__ ts,
                                   const unsigned char* __restrict__ valid,
                                   const float* __restrict__ fills,
                                   int* __restrict__ n_out, int n, int w,
                                   float age, int vec, int wvec) {
  __shared__ float s_hi[32], s_lo[32];
  __shared__ int s_nan[32], s_cnt[32];
  const size_t nn = (size_t)n;
  const int quads = (n + EV_COLS - 1) / EV_COLS;
  const int step = gridDim.x * blockDim.x;
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  // the first columns' pkt_count and t_max, and the fills, in flight
  // during the reduction
  float4 cnt = make_float4(0.f, 0.f, 0.f, 0.f), tmax = cnt;
  if (q < quads) {
    cnt = ev_load(regs, q * EV_COLS, n, vec);
    tmax = ev_load(regs + 3 * nn, q * EV_COLS, n, vec);
  }
  float fill[R];
#pragma unroll
  for (int r = 0; r < R; ++r) fill[r] = __ldg(fills + r);

  // the window's max and min over its valid lanes, and whether one is NaN;
  // 16 bytes of ts and 4 of valid a load where W % 4 == 0 and aligned
  float hi = -INFINITY, lo = INFINITY;
  bool nan = false;
  auto fold = [&](float t, unsigned char ok) {
    if (ok) {
      nan |= t != t;
      hi = fmaxf(hi, t);
      lo = fminf(lo, t);
    }
  };
  if (wvec) {
    for (int i = threadIdx.x; i < w / 4; i += blockDim.x) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(ts) + i);
      const uchar4 ok = __ldg(reinterpret_cast<const uchar4*>(valid) + i);
      fold(t.x, ok.x);
      fold(t.y, ok.y);
      fold(t.z, ok.z);
      fold(t.w, ok.w);
    }
  } else {
    for (int i = threadIdx.x; i < w; i += blockDim.x)
      fold(__ldg(ts + i), __ldg(valid + i));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
  }
  nan = __any_sync(0xffffffffu, nan);
  if (lane == 0) {
    s_hi[warp] = hi;
    s_lo[warp] = lo;
    s_nan[warp] = nan;
  }
  __syncthreads();
  for (int k = 0; k < warps; ++k) {
    hi = fmaxf(hi, s_hi[k]);
    lo = fminf(lo, s_lo[k]);
    nan |= s_nan[k] != 0;
  }
  const float d = hi - age;
  const float cutoff = (nan || d != d) ? NAN : fminf(d, lo);

  int evicted = 0;
  for (bool first = true; q < quads; q += step, first = false) {
    const int c0 = q * EV_COLS;
    if (!first) {
      cnt = ev_load(regs, c0, n, vec);
      tmax = ev_load(regs + 3 * nn, c0, n, vec);
    }
    unsigned take = 0;
#pragma unroll
    for (int j = 0; j < EV_COLS; ++j)
      take |= (ev_at(cnt, j) > 0.f && ev_at(tmax, j) < cutoff) ? 1u << j
                                                                : 0u;
    if (!take) continue;
    evicted += __popc(take);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* dst = regs + r * nn + c0;
      if (vec && take == 0xFu) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(fill[r], fill[r], fill[r], fill[r]);
      } else {
#pragma unroll
        for (int j = 0; j < EV_COLS; ++j)
          if (take & (1u << j)) dst[j] = fill[r];
      }
    }
  }

  // the block's count and its ticket in one atomic; the last block writes
  // the total and zeroes the word for the next launch
  evicted = __reduce_add_sync(0xffffffffu, evicted);
  if (lane == 0) s_cnt[warp] = evicted;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int k = 0; k < warps; ++k) total += (unsigned)s_cnt[k];
    if (gridDim.x == 1) {           // one block: the count is its own
      *n_out = (int)total;
      return;
    }
    const unsigned long long before =
        atomicAdd(&ev_done, (1ull << 32) | total);
    if ((unsigned)(before >> 32) == gridDim.x - 1) {
      *n_out = (int)((unsigned)before + total);
      atomicExch(&ev_done, 0ull);
    }
  }
}

// 16-byte accesses: n a multiple of 4, a and b (rows of n floats)
// 16-byte aligned and mask (n bytes) 4-byte aligned
bool vec4_ok(int n, const void* a, const void* b, const void* mask) {
  const uintptr_t m = (uintptr_t)a | (uintptr_t)b;
  return n % EV_COLS == 0 && (m & 15) == 0 && ((uintptr_t)mask & 3) == 0;
}

bool plan_ok(int r_dim, int threads, int blocks) {
  return r_dim == EV_R && threads >= 32 && threads <= 1024 &&
         threads % 32 == 0 && blocks >= 1;
}

}  // namespace

extern "C" {

// threads, blocks: kernels/evict.py fill_plan
int evict_launch(const void* regs, const void* mask, const void* fills,
                 void* out, int r_dim, int n, int threads, int blocks,
                 void* stream) {
  if (n <= 0) return 0;
  if (!plan_ok(r_dim, threads, blocks)) return (int)cudaErrorInvalidValue;
  evict_fill_kernel<EV_R><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)regs, (const unsigned char*)mask, (const float*)fills,
      (float*)out, n, vec4_ok(n, regs, out, mask) ? 1 : 0);
  return (int)cudaGetLastError();
}

// threads, blocks: kernels/evict.py sweep_plan; age_bits: evict_age's f32
// bits. n_out is written by the launch's last block.
int evict_sweep_launch(void* regs, const void* ts, const void* valid,
                       const void* fills, void* n_out, int r_dim, int n,
                       int w, int age_bits, int threads, int blocks,
                       void* stream) {
  if (n <= 0 || w <= 0 || !plan_ok(r_dim, threads, blocks))
    return (int)cudaErrorInvalidValue;
  float age;
  memcpy(&age, &age_bits, sizeof(age));
  evict_sweep_kernel<EV_R><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)regs, (const float*)ts, (const unsigned char*)valid,
      (const float*)fills, (int*)n_out, n, w, age,
      vec4_ok(n, regs, regs, regs) ? 1 : 0,
      vec4_ok(w, ts, ts, valid) ? 1 : 0);
  return (int)cudaGetLastError();
}

const char* evict_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
