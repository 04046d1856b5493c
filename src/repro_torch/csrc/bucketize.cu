// Standalone range match ("bucketize") for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bucketize.py:32
// _bucketize_kernel (pallas_call at :58), reached from bucketize_pallas and
// ops.bucketize. For x (N, F) f32 and edges (F, U) f32 (+inf padded):
//
//   out[n, f] = #{u : x[n, f] > edges[f, u]}
//
// as int32. A count, not a search: the reference counts on any edge row,
// sorted or not, so a binary search stands in for it only on a row shown
// sorted. A strict '>': a
// value equal to an edge stays below it, NaN lands in bin 0, the +inf pads
// never match, +-inf inputs compare as any other value.
//
// Bound: memory. The call must move x, the edges and out once: at the
// finance fit's shape (N=16000, F=130, U=63) 16.7 MB, 4.98 us at 3.35
// TB/s; its N*F*U compares (131 M) take 2.0 us at the card's f32 rate. At
// the tree fits' F=5 both sit far below one launch (~2 us).
//
// Design. The TPU padded N to its 256-row tile and swept each tile against
// the whole table in VMEM with vectorised compares. Here:
//   - a block stages the whole (F, U) table once in shared memory (dynamic,
//     past 48 KB after cudaFuncSetAttribute; each edge's row and column
//     stepped along without a division), then walks tiles of x in
//     row-major order: a tile is 4 * blockDim consecutive elements, a
//     thread takes 4 of them with one 16-byte load and one 16-byte store
//     (scalar where x or out is not 16-byte aligned, and on the ragged last
//     tile), so a warp moves 512 contiguous bytes each way. The first
//     tile's load is issued before the table's, the next tile's before the
//     current tile is counted. The grid is one block an SM or fewer
//     (launch_plan in kernels/bucketize.py sizes blockDim and the grid
//     from N * F), so the table is staged once an SM, not once per 128
//     rows and feature;
//   - a thread's 4 elements belong to 4 consecutive features, and lanes 4
//     apart read the same feature class: feature f's row lives at slot
//     (f % 4) * ceil(F / 4) + f / 4 and the row stride is odd, so the 32
//     lanes of a warp start their reads on 32 distinct banks;
//   - staging checks each edge against the next of its row as it lands (a
//     shuffle from the next lane). With every row sorted (non-decreasing,
//     no NaN), as the fits' quantile edges are, the count #{u : x > e_u}
//     is the number of edges below x: a branch-free binary lifting over the
//     row padded with +inf to a power of two P > U, log2(P) dependent
//     reads, the thread's 4 elements in lockstep, and no per-row flag is
//     read;
//   - with a row out of order (or with a NaN edge) anywhere, a second pass
//     marks each row sorted or not and makes the group summaries, the
//     (min, max) of every group of 8 edges, for the rows out of order: an
//     element above a group's max counts all 8 of its edges, one at or
//     below its min none. Exact for any row, since every edge of the group
//     lies in [min, max] (a group holding a NaN gets (-inf, +inf) and is
//     never counted whole). Only an element that falls inside exactly one
//     group compares that group's 8 edges; one inside several (a row out
//     of order, a NaN element) compares the whole row. The compares are
//     independent: `set.gt` gives an all-ones mask per edge, summed into
//     two partial counts.
// A narrow table (F <= 8: the tree fits' F=5) takes a design of its own,
// which measured faster there: a block takes one feature and 128 rows, each
// warp
// staging that feature's row and its group summaries itself, a thread
// counting one element. A table past the shared-memory budget (227 KB)
// takes the serial walk of range_match.cuh through the read-only cache,
// one element per thread.
//
// Exactness: integer counts, equal to the plain version bit for bit.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "range_match.cuh"

namespace {

constexpr int kSmemBudget = 232448;   // 227 KB: a block's most on sm_90
constexpr int kGlobalBlock = 256;
constexpr int kMaxThreads = 512;      // a staged block's most (128 registers)
constexpr int kNarrowF = 8;           // a table this narrow: per feature
constexpr int kColumnBlock = 128;     // rows a per-feature block takes

// 0xffffffff where v > e (strict, false for NaN), else 0
__device__ __forceinline__ unsigned gt_mask(float v, float e) {
  unsigned r;
  asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(r) : "f"(v), "f"(e));
  return r;
}

// The staged table's geometry (kernels/bucketize.py table_geometry
// mirrors it): a row of `len` floats (U edges, then +inf up to both `up`,
// U padded to a multiple of 8, and `p`, the power of two above U) at an
// odd stride `rs`, the group summaries at `ss` float2 (odd), a sorted flag
// a row, 4 * ceil(F / 4) row slots.
struct Table {
  int up, groups, p, len, rs, ss, quarter, slots;
  __host__ __device__ explicit Table(int f_dim, int u_dim) {
    up = (u_dim + 7) & ~7;
    groups = up / 8;
    p = 1;
    while (p <= u_dim) p <<= 1;
    len = up > p ? up : p;
    rs = len + 1;
    ss = groups | 1;
    quarter = (f_dim + 3) / 4;
    slots = 4 * quarter;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) *
           ((size_t)slots * rs + 2 * (size_t)slots * ss + (size_t)slots);
  }
  __host__ __device__ int slot(int f) const {
    return (f & 3) * quarter + (f >> 2);
  }
};

// #{u : v > row[u]} on a sorted row: the number of edges below v, by
// binary lifting over the row's first p entries (row[p - 1] is +inf)
__device__ __forceinline__ int count_sorted(float v, const float* row,
                                            int half) {
  int c = 0;
  for (int step = half; step > 0; step >>= 1)
    c += row[c + step - 1] < v ? step : 0;
  return c;
}

// #{u : v > row[u]} on any row, from the row's group summaries
__device__ __forceinline__ int count_groups(float v, const float* row,
                                            const float2* sums, int groups) {
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
  unsigned c0 = whole, c1 = 0u;
  if (open == 1) {
    const float* e = row + 8 * which;
    c0 = c0 - gt_mask(v, e[0]) - gt_mask(v, e[1]) - gt_mask(v, e[2]) -
         gt_mask(v, e[3]);
    c1 = c1 - gt_mask(v, e[4]) - gt_mask(v, e[5]) - gt_mask(v, e[6]) -
         gt_mask(v, e[7]);
  } else if (open > 1) {
    c0 = 0u;
#pragma unroll 4
    for (int w = 0; w < 8 * groups; w += 2) {
      c0 -= gt_mask(v, row[w]);
      c1 -= gt_mask(v, row[w + 1]);
    }
  }
  return (int)(c0 + c1);
}

__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long i0, long long total,
                                        bool vec) {
  if (vec && i0 + 3 < total)
    return __ldg(reinterpret_cast<const float4*>(x + i0));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = i0 + j < total ? __ldg(x + i0 + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// i % m for the non-negative 64-bit i, by 32-bit division where i fits
__device__ __forceinline__ int mod_of(long long i, int m) {
  return i < 0x7fffffffLL ? (int)((unsigned)i % (unsigned)m) : (int)(i % m);
}

__global__ void __launch_bounds__(kMaxThreads)
bucketize_rows(const float* __restrict__ x, const float* __restrict__ edges,
               int* __restrict__ out, long long total, long long tiles,
               int f_dim, int u_dim, int vec) {
  extern __shared__ float4 smem4[];
  const Table tb(f_dim, u_dim);
  float* rows = reinterpret_cast<float*>(smem4);
  float2* sums = reinterpret_cast<float2*>(rows + (size_t)tb.slots * tb.rs);
  int* sorted = reinterpret_cast<int*>(sums + (size_t)tb.slots * tb.ss);
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31;

  // the thread's first 4 elements and their features, their load issued
  // before the table's so the round trips overlap; each later tile of this
  // block lies `step` elements on, `fstep` features on (mod F)
  const long long tile_elems = 4LL * nt;
  const long long step = tile_elems * gridDim.x;
  const int fstep = mod_of(step, f_dim);
  long long i0 = (long long)blockIdx.x * tile_elems + 4 * t;
  int f0 = mod_of(i0, f_dim);
  const bool v4 = vec != 0;
  float4 cur = load4(x, i0, total, v4);

  // the table: its edges' loads issued before their stores (with, for a
  // warp's last lane, the edge after its own), each edge's (row, column)
  // stepped along without a division; each edge checked against the next
  // one of its row as it lands (the warp's next lane holds it), so a row
  // out of order (or holding a NaN) is seen on the way; then the +inf pads
  // of each row past U
  const int n_edges = f_dim * u_dim;
  int unsorted = 0;
  // an edge `val` at (f, u), its row's next edge `next`: staged, and
  // checked (NaN fails every <=; the row's last compares with itself)
  auto stage = [&](float val, float next, int f, int u) {
    rows[tb.slot(f) * tb.rs + u] = val;
    unsorted |= !(val <= (u + 1 < u_dim ? next : val));
  };
  if (n_edges > 0 && (uintptr_t)edges % 16 == 0) {
    // 16-byte loads, four a thread a round; a thread's next edge after its
    // four is the next lane's first (the warp's last lane loads it)
    const int stride = 4 * nt;
    const int df = stride / u_dim, du = stride - df * u_dim;
    int f = (4 * t) / u_dim, u = 4 * t - f * u_dim;
    for (int base = 0; base < n_edges; base += 4 * stride) {
      float4 e[4];
      float after[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = base + 4 * t + j * stride;
        e[j] = load4(edges, k, n_edges, true);
        after[j] = lane == 31 && k + 4 < n_edges ? __ldg(edges + k + 4) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = base + 4 * t + j * stride;
        const float down = __shfl_down_sync(0xffffffffu, e[j].x, 1);
        const float val[4] = {e[j].x, e[j].y, e[j].z, e[j].w};
        const float next[4] = {e[j].y, e[j].z, e[j].w,
                               lane == 31 ? after[j] : down};
        int ff = f, uu = u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k + i < n_edges) stage(val[i], next[i], ff, uu);
          if (++uu == u_dim) {
            uu = 0;
            ++ff;
          }
        }
        u += du;
        f += df;
        if (u >= u_dim) {
          u -= u_dim;
          ++f;
        }
      }
    }
  } else if (n_edges > 0) {
    // the edges off 16-byte alignment: a load an edge, sixteen a round
    const int df = nt / u_dim, du = nt - df * u_dim;
    int f = t / u_dim, u = t - f * u_dim;
    for (int base = 0; base < n_edges; base += 16 * nt) {
      const int k0 = base + t;
      float e[16], after[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = k0 + j * nt;
        e[j] = k < n_edges ? __ldg(edges + k) : 0.f;
        after[j] = lane == 31 && k + 1 < n_edges ? __ldg(edges + k + 1) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = k0 + j * nt;
        const float down = __shfl_down_sync(0xffffffffu, e[j], 1);
        if (k < n_edges) stage(e[j], lane == 31 ? after[j] : down, f, u);
        u += du;
        f += df;
        if (u >= u_dim) {
          u -= u_dim;
          ++f;
        }
      }
    }
  }
  {
    const int pad = tb.len - u_dim;          // at least 1
    const int df = nt / pad, du = nt - df * pad;
    int f = t / pad, u = t - f * pad;
    for (int k = t; k < f_dim * pad; k += nt) {
      rows[tb.slot(f) * tb.rs + u_dim + u] = INFINITY;
      u += du;
      f += df;
      if (u >= pad) {
        u -= pad;
        ++f;
      }
    }
  }
  // with a row out of order anywhere in the table: each row's sorted flag
  // (a thread walks a row) and the group summaries, a group holding a NaN
  // edge at (-inf, +inf), so it is never counted whole and its edges are
  // compared one by one
  const bool any_unsorted = __syncthreads_or(unsorted);
  if (any_unsorted) {
    for (int f = t; f < f_dim; f += nt) {
      const float* e = rows + tb.slot(f) * tb.rs;
      bool in_order = u_dim == 0 || e[0] == e[0];
      for (int u = 1; u < u_dim; ++u) in_order &= e[u - 1] <= e[u];
      sorted[tb.slot(f)] = in_order;
    }
    if (tb.groups > 0) {
      const int df = nt / tb.groups, dg = nt - df * tb.groups;
      int f = t / tb.groups, g = t - f * tb.groups;
      for (int k = t; k < f_dim * tb.groups; k += nt) {
        const float* e = rows + tb.slot(f) * tb.rs + 8 * g;
        float lo = INFINITY, hi = -INFINITY;
        bool nan = false;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          nan |= e[i] != e[i];
          lo = fminf(lo, e[i]);
          hi = fmaxf(hi, e[i]);
        }
        sums[tb.slot(f) * tb.ss + g] =
            nan ? make_float2(-INFINITY, INFINITY) : make_float2(lo, hi);
        g += dg;
        f += df;
        if (g >= tb.groups) {
          g -= tb.groups;
          ++f;
        }
      }
    }
    __syncthreads();
  }

  const int half = tb.p >> 1;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const float4 nxt = tile + gridDim.x < tiles
                           ? load4(x, i0 + step, total, v4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float v[4] = {cur.x, cur.y, cur.z, cur.w};
    int sl[4], c[4] = {0, 0, 0, 0};
    int f = f0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sl[j] = tb.slot(f);
      f = f + 1 == f_dim ? 0 : f + 1;
    }
    if (!any_unsorted) {
      // every row sorted: the four searches in lockstep, their reads
      // independent, at most 16 steps (P <= 2^16)
      int st = half;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (st == 0) break;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[j] += rows[sl[j] * tb.rs + c[j] + st - 1] < v[j] ? st : 0;
        st >>= 1;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* r = rows + sl[j] * tb.rs;
        c[j] = sorted[sl[j]] ? count_sorted(v[j], r, half)
                             : count_groups(v[j], r, sums + sl[j] * tb.ss,
                                            tb.groups);
      }
    }
    if (v4 && i0 + 3 < total) {
      *reinterpret_cast<int4*>(out + i0) = make_int4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j < total) out[i0 + j] = c[j];
    }
    cur = nxt;
    i0 += step;
    f0 += fstep;
    if (f0 >= f_dim) f0 -= f_dim;
  }
}

// floats of one warp's staging: the row padded to a multiple of 8 (+inf),
// then a (min, max) pair per group of 8, rounded up to a 16-byte multiple
__host__ __device__ __forceinline__ int warp_floats(int u_dim) {
  const int up = (u_dim + 7) & ~7;
  return (up + up / 4 + 3) & ~3;
}

// a narrow table (F <= kNarrowF): a block takes one feature and
// kColumnBlock rows, each warp staging that feature's row and its group
// summaries itself (no block barrier), a thread counting one element
__global__ void __launch_bounds__(kColumnBlock)
bucketize_columns(const float* __restrict__ x, const float* __restrict__ edges,
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

// a table over the shared-memory budget: one element per thread, the
// shared serial walk through the read-only cache
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

// threads: a staged block's threads (a multiple of 32, up to 512); grid:
// its blocks (each walks tiles blockIdx.x, + grid, ...). A narrow table
// (per feature) and a table past the budget (the serial walk) ignore both.
int bucketize_launch(const void* x, const void* edges, void* out, int n,
                     int f_dim, int u_dim, int threads, int grid,
                     void* stream) {
  if (n <= 0 || f_dim <= 0) return 0;
  if (u_dim < 0 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* ef = (const float*)edges;
  int* o = (int*)out;
  const long long total = (long long)n * f_dim;
  if (f_dim <= kNarrowF &&
      (size_t)warp_floats(u_dim) * sizeof(float) * (kColumnBlock / 32) <=
          48 * 1024) {
    const unsigned gx = (unsigned)(((long long)n + kColumnBlock - 1) /
                                   kColumnBlock);
    const size_t smem =
        sizeof(float) * (size_t)warp_floats(u_dim) * (kColumnBlock / 32);
    bucketize_columns<<<dim3(gx, f_dim), kColumnBlock, smem, st>>>(
        xf, ef, o, (long long)n, f_dim, u_dim);
    return (int)cudaGetLastError();
  }
  const Table tb(f_dim, u_dim);
  if (tb.bytes() > (size_t)kSmemBudget ||
      (long long)f_dim * u_dim > 0x7fffffffLL) {
    const long long blocks = (total + kGlobalBlock - 1) / kGlobalBlock;
    bucketize_global<<<(unsigned)blocks, kGlobalBlock, 0, st>>>(
        xf, ef, o, total, f_dim, u_dim);
    return (int)cudaGetLastError();
  }
  // the opt-in above 48 KB, set once per device to the whole budget
  static bool opted_in[64] = {};
  int device = 0;
  const cudaError_t de = cudaGetDevice(&device);
  if (de != cudaSuccess) return (int)de;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucketize_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBudget);
    if (e != cudaSuccess) return (int)e;
    opted_in[device] = true;
  }
  const long long tile_elems = 4LL * threads;
  const long long tiles = (total + tile_elems - 1) / tile_elems;
  const unsigned blocks = (unsigned)(tiles < grid ? tiles : grid);
  const int vec = ((uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0);
  bucketize_rows<<<blocks, threads, tb.bytes(), st>>>(
      xf, ef, o, total, tiles, f_dim, u_dim, vec);
  return (int)cudaGetLastError();
}

const char* bucketize_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
