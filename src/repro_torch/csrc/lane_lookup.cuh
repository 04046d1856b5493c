// What the lane-split tree lookups share: asynchronous copies into shared
// memory, the head of the shared-memory layout, the range match that fills
// it, the frame of the per-row tree walk with the merge of a row's lanes,
// and the launchers' plan checks.
//
// Included by ensemble_lookup.cu (B1/B2) and ensemble_loop.cu (B7); the
// build hashes this header into every library's name (kernels/_build.py).
//
// Both kernels give a block `rows` rows of x with `lanes` threads a row (a
// power of two up to 32, lanes of a row in one warp), in three steps:
//   1. lane_copy_x: the block's rows of x, and the edges when staged, go to
//      shared memory by cp.async as one group; the kernel then commits its
//      own tables as a second group;
//   2. lane_range_match: while both groups fly, the (min, max) of every
//      group of 8 edges is read; then one thread per (row, feature) range
//      matches from the summaries and keeps the offset of its table row;
//   3. lane_rows: each lane walks whole trees of its row (the kernel's own
//      key and epilogue), and the lanes' partial votes or sums meet by xor
//      shuffles (lanes_merge_store).
// The two sources differ only in their staged tables and in step 3's walk.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "range_match.cuh"

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4-byte words [0, count) of src into dst (16-byte aligned), spread over
// the block's threads: 16 bytes a copy where src is 16-byte aligned
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           size_t count) {
  unsigned* d = static_cast<unsigned*>(dst);
  const unsigned* s = static_cast<const unsigned*>(src);
  size_t i = threadIdx.x;
  if (aligned16(s)) {
    for (; 4 * i + 3 < count; i += blockDim.x) cp_async16(d + 4 * i, s + 4 * i);
    i = (count & ~(size_t)3) + threadIdx.x;
  }
  for (; i < count; i += blockDim.x) cp_async4(d + i, s + i);
}

__host__ __device__ inline size_t up4(size_t words) {
  return (words + 3) & ~(size_t)3;
}

// The row's lanes add up their partial outputs acc[0 .. co) by xor
// shuffles (every thread of the warp takes part: call it from converged
// code), then lane c % lanes writes column c of the row when it is live.
// The values are integers in f32 below 2^24, so the order of the adds does
// not change a bit.
template <int MAX_CO>
__device__ __forceinline__ void lanes_merge_store(float (&acc)[MAX_CO], int co,
                                                  int lanes, int lane,
                                                  bool live, float* orow) {
  for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < MAX_CO; ++c)
      if (c < co) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < MAX_CO; ++c)
      if (c < co && (c & (lanes - 1)) == lane) orow[c] = acc[c];
  }
}

// The head of a lane lookup's shared memory, in 4-byte words, each part
// 16-byte aligned: the group summaries (float2) at word 0, the block's rows
// of x at `xs`, their table-row offsets at `off`, and from `tables` on what
// the kernel stages, the edges first.
struct LaneHead {
  size_t xs, off, tables;
};

__host__ __device__ inline LaneHead lane_head(int rows, int f_dim,
                                              int u_dim) {
  LaneHead h;
  h.xs = up4(2 * (size_t)f_dim * rm_groups(u_dim));
  h.off = h.xs + up4((size_t)rows * f_dim);
  h.tables = h.off + up4((size_t)rows * f_dim);
  return h;
}

// Step 1's first copy group: the block's `items` = rows x F values of x
// from row row0, and when STAGED the edges (to smem + h.tables).
template <bool STAGED>
__device__ __forceinline__ void lane_copy_x(float* smem, const LaneHead& h,
                                            const float* x,
                                            const float* edges,
                                            long long row0, int items,
                                            int f_dim, int u_dim) {
  copy_async(smem + h.xs, x + row0 * f_dim, items);
  if (STAGED) copy_async(smem + h.tables, edges, (size_t)f_dim * u_dim);
  cp_async_commit();
}

// Step 2, once the kernel has committed its tables as the second group:
// the group summaries are read from global memory while the copies fly;
// once x (and the edges) land, item i = r * F + f of the block's rows
// gets off[i] = (f * b_rows + bin) * stride, the offset of its table row.
// Returns with every copy landed and the block synced.
template <bool STAGED>
__device__ __forceinline__ void lane_range_match(float* smem,
                                                 const LaneHead& h,
                                                 const float* edges,
                                                 int items, int f_dim,
                                                 int u_dim, int b_rows,
                                                 int stride) {
  float2* sums = reinterpret_cast<float2*>(smem);
  const int groups = rm_groups(u_dim);
  for (int i = threadIdx.x; i < f_dim * groups; i += blockDim.x) {
    const int f = i / groups;
    sums[i] = rm_group_summary<false>(edges + (size_t)f * u_dim, u_dim,
                                      i - f * groups);
  }
  cp_async_wait<1>();
  __syncthreads();
  const float* xs = smem + h.xs;
  const float* e_tab = STAGED ? smem + h.tables : edges;
  int* off = reinterpret_cast<int*>(smem + h.off);
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int f = i % f_dim;
    const int b = range_match_grouped<STAGED>(
        xs[i], e_tab + (size_t)f * u_dim, sums + f * groups, u_dim);
    off[i] = (f * b_rows + b) * stride;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Step 3's frame: every thread takes each round, so the shuffles see whole
// warps. A thread's row is r; when r is one of the block's live_rows,
// walk(r, lane, acc) adds the row's trees lane, lane + lanes, ... into acc;
// then the row's lanes meet and write row r of out (the block's first row).
template <int MAX_CO, typename Walk>
__device__ __forceinline__ void lane_rows(int rows, int lanes, int live_rows,
                                          int co, float* out, Walk walk) {
  const int lane = threadIdx.x & (lanes - 1);
  for (int base = 0; base < rows * lanes; base += blockDim.x) {
    const int r = (base + (int)threadIdx.x) / lanes;
    const bool live = r < live_rows;
    float acc[MAX_CO];
#pragma unroll
    for (int c = 0; c < MAX_CO; ++c) acc[c] = 0.f;
    if (live) walk(r, lane, acc);
    lanes_merge_store<MAX_CO>(acc, co, lanes, lane, live,
                              out + (size_t)r * co);
  }
}

// The plan checks of both launchers: lanes a power of two up to 32, whole
// warps up to max_threads a block, and a block's threads whole rows.
inline bool lane_plan_ok(int rows, int lanes, int threads, int max_threads) {
  return rows >= 1 && lanes >= 1 && lanes <= 32 && !(lanes & (lanes - 1)) &&
         threads % 32 == 0 && threads >= 32 && threads <= max_threads &&
         threads % lanes == 0;
}

// Launch `kern` on `blocks` of `threads` with `smem` bytes of dynamic
// shared memory, opting in above the 48 KB default. -> cudaGetLastError()
template <typename Kernel, typename... Args>
inline int lane_launch(Kernel kern, int n, int rows, int threads, int smem,
                       void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)(((long long)n + rows - 1) / rows);
  kern<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}
