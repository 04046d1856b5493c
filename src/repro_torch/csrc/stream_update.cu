// Streaming register scatter, clamp, overflow count and touched-row readout
// for Hopper (sm_90a).
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
// A second output mode (the template flag kFeatures) writes each lane's
// feature row instead, rows (W, 8), and adds the count of register slots
// the clamp newly saturated into *n_over: the serving step's whole register
// half but the aging sweep, in this one launch.
//
// The decomposition is the TPU kernel's own: a grid step owns a tile of
// bucket columns (TILE_B there), scans the whole window for the lanes that
// fall in its tile, folds and clamps its own columns, and gathers the rows of
// the lanes it owns. On the TPU the rows block was carried across grid steps
// that run in order; here a block owns its tile [c0, c0 + tile) and writes
// the rows of the lanes whose gather column lies in it outright, so nothing
// is carried, nothing races, and the call is one launch of kBlock threads:
//   1. each thread starts loading the registers it will settle;
//   2. the block scans the window (17 bytes a lane, from L2) and lists, in
//      shared memory, each valid lane whose bucket lies in its tile (one
//      shared-memory int atomic a warp for the list's length); then each
//      column's q = kBlock / tile threads walk the list and fold its
//      column's lanes in registers:
//      six sums from +0.0, t_min/t_max in a total order of the floats. A
//      window longer than kListLanes is listed and folded in chunks;
//   3. a column's q partial folds meet by xor shuffles, and the column is
//      settled once, by the block that owns it: count registers regs + fold,
//      then the clamp; t_min/t_max the ordered min/max of register and fold.
//      Words whose bits change are written back, and the settled column is
//      kept in shared memory. With kFeatures the column's feature row is
//      kept instead: its threads (consecutive lanes of one warp) trade
//      cnt, t_min and t_max by shuffles, and the threads of rows 2 and 3
//      keep the duration and the mean IAT (netsim/features.py
//      table_from_registers: duration = cnt > 0 ? t_max - t_min : +0.0,
//      mean IAT = cnt > 1 ? duration / max(cnt - 1, 1) : +0.0, with
//      __fsub_rn / __fdiv_rn, torch's correctly rounded difference and true
//      division), once a column and not once a lane;
//   4. the block scans the window again and writes rows[:, i] for every lane
//      whose gather column (b < 0 -> b + N, then clamped into [0, N), the
//      reference's gather) lies in its tile, invalid lanes included; with
//      kFeatures its feature row, one 32-byte store at rows + 8 i.
//
// The overflow count (n_over not null, the clamp on): a count register slot
// is newly saturated when its settled value v >= limit and its register was
// below the limit before the fold, as netsim/stream.py saturate_counts(prev=)
// compares the file before and after a window, in float32. Each thread
// counts the slots it settles in step 3, the block sums them, and one int
// atomicAdd a block adds the sum to *n_over. The count runs over every
// column of the tile, not only the columns a valid lane names, and gives
// the same number: a column no valid lane names folds +0.0 into each count
// register, so v equals the register (up to the sign of a zero) and stays
// below the limit if it was, or was clamped from a register already at or
// above it; neither counts.
//
// No float atomics: shared-memory float atomics on one word (a flow's
// packets) retry one lane at a time, and on the card a first version built
// on them lost to the global atomics it replaced once a window held a heavy
// flow. The lanes of a flow are summed by the threads of one column
// instead. The tile (kernels/stream_update.py tile_columns) gives about two
// blocks an SM, up to kBlock columns; N need not be a multiple of it.
//
// Exactness against the plain version (kernels/ref.py stream_update_ref,
// regs + per-bucket sums, then the clamp): the fold sums the window from
// +0.0 as the plain version's segment sums do, integer-valued f32 adds are
// exact in any order below 2^24, and with the clamp on a sum that crosses
// 2^24 rounds to at least 2^24 and clamps to exactly 2^24; min/max are
// exact in any order (order_key's order: the floats' own, with -0.0
// below +0.0). Because every fold starts at +0.0, an untouched column's
// -0.0 count register becomes +0.0, as regs + sums gives it. Products use
// __fmul_rn/__fsub_rn so the compiler cannot contract them differently
// from the plain version.
//
// Bound: memory. In place, the function must read the six count rows whole
// (the clamp sees every column), t_min/t_max only at the columns the lanes
// name, and the window (17 B a lane), and write the register words that
// change and the rows (8*W*4 bytes in either mode); its adds and compares take less at the
// card's f32 rate. This design also reads t_min/t_max whole and each block
// reads the window from L2.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRegisters = 8;
constexpr int kTMin = 2;
constexpr int kTMax = 3;
constexpr int kBlock = 256;        // threads of a block; the widest tile
constexpr int kListLanes = 1024;   // lanes a block lists at once (16 KB)
constexpr int kScan = kListLanes / kBlock;   // lanes a thread loads at once

// A total order of the floats, as an int: the bits, with the magnitude bits
// of a value whose sign bit is set flipped (-0.0 below +0.0, every
// negative value below every positive one).
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The float max/min of that order.
__device__ __forceinline__ float ordered_min(float a, float b) {
  return order_key(b) < order_key(a) ? b : a;
}

__device__ __forceinline__ float ordered_max(float a, float b) {
  return order_key(b) > order_key(a) ? b : a;
}

// One lane of the window, as a block keeps it in its list: the column in
// the tile (int bits), ts, length, is_fwd.
__device__ __forceinline__ float4 lane_entry(int col, float t, float ln,
                                             float fw) {
  return make_float4(__int_as_float(col), t, ln, fw);
}

// kFeatures: rows is (W, 8) feature rows, else (8, W) register rows.
// n_over: the newly saturated count's word, or null for no count.
template <bool kFeatures>
__global__ void __launch_bounds__(kBlock)
stream_update_kernel(float* __restrict__ regs, const int* __restrict__ bucket,
                     const float* __restrict__ ts,
                     const float* __restrict__ length,
                     const float* __restrict__ is_fwd,
                     const unsigned char* __restrict__ valid,
                     float* __restrict__ rows, int* __restrict__ n_over,
                     int n, int w, int tile, int has_limit, float limit) {
  __shared__ float4 list[kListLanes];        // the tile's lanes of a chunk
  __shared__ int listed;                     // lanes listed so far
  __shared__ int over;                       // slots newly saturated
  extern __shared__ float settled[];         // [8][tile]
  const int c0 = blockIdx.x * tile;
  const int cols = min(tile, n - c0);
  const size_t nn = (size_t)n;
  const int lane = threadIdx.x & 31;
  // column c's q threads are consecutive; thread k of them settles the
  // registers r with r % q == k
  const int q = kBlock / tile;
  const int c = threadIdx.x / q;
  const int k = threadIdx.x & (q - 1);

  // 1. the registers this thread settles, in flight during the scan
  float reg[kRegisters];
  if (c < cols) {
#pragma unroll
    for (int r = 0; r < kRegisters; ++r)
      if (r % q == k) reg[r] = regs[r * nn + c0 + c];
  }
  if (threadIdx.x == 0) listed = over = 0;
  __syncthreads();

  // 2. fold the window chunk by chunk: list the chunk's lanes that fall in
  //    the tile (one shared-memory int atomic a warp), then each column's q
  //    threads sum its listed lanes in registers
  float fold[kRegisters];
#pragma unroll
  for (int r = 0; r < kRegisters; ++r)
    fold[r] = r == kTMin ? INFINITY : (r == kTMax ? -INFINITY : 0.f);
  int base = 0;
  for (int lo = 0; lo < w; lo += kListLanes) {
    // the chunk's loads first, so they are in flight together
    int b[kScan];
    unsigned char ok[kScan];
    float t[kScan], ln[kScan], fw[kScan];
#pragma unroll
    for (int s = 0; s < kScan; ++s) {
      const int i = lo + s * kBlock + threadIdx.x;
      b[s] = -1;
      ok[s] = 0;
      t[s] = ln[s] = fw[s] = 0.f;
      if (i < w) {
        b[s] = __ldg(bucket + i);
        ok[s] = __ldg(valid + i);
        t[s] = __ldg(ts + i);
        ln[s] = __ldg(length + i);
        fw[s] = __ldg(is_fwd + i);
      }
    }
#pragma unroll
    for (int s = 0; s < kScan; ++s) {
      const bool in = ok[s] != 0 && b[s] >= c0 && b[s] < c0 + cols;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (m) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&listed, __popc(m));
        at = __shfl_sync(0xffffffffu, at, 0) - base;
        if (in)
          list[at + __popc(m & ((1u << lane) - 1u))] =
              lane_entry(b[s] - c0, t[s], ln[s], fw[s]);
      }
    }
    __syncthreads();
    const int total = listed;
#pragma unroll 4
    for (int e = base + k; e < total; e += q) {
      const float4 v = list[e - base];
      if (__float_as_int(v.x) != c) continue;
      const float rv = __fsub_rn(1.0f, v.w);
      fold[0] += 1.0f;
      fold[1] += v.z;
      fold[kTMin] = ordered_min(fold[kTMin], v.y);
      fold[kTMax] = ordered_max(fold[kTMax], v.y);
      fold[4] += v.w;
      fold[5] += rv;
      fold[6] += __fmul_rn(v.z, v.w);
      fold[7] += __fmul_rn(v.z, rv);
    }
    base = total;
    __syncthreads();
  }

  // 3. the column's q partial folds meet by xor shuffles; the column is
  //    then settled once, by the threads that own it
  for (int o = q >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < kRegisters; ++r) {
      const float other = __shfl_xor_sync(0xffffffffu, fold[r], o);
      fold[r] = r == kTMin ? ordered_min(fold[r], other)
              : r == kTMax ? ordered_max(fold[r], other)
                           : __fadd_rn(fold[r], other);
    }
  }
  int newly = 0;
  float set[kRegisters];             // the settled registers this thread owns
#pragma unroll
  for (int r = 0; r < kRegisters; ++r) set[r] = 0.f;
  if (c < cols) {
    const bool lim = has_limit != 0;
#pragma unroll
    for (int r = 0; r < kRegisters; ++r) {
      if (r % q != k) continue;
      float v;
      if (r == kTMin) {
        v = ordered_min(reg[r], fold[r]);
      } else if (r == kTMax) {
        v = ordered_max(reg[r], fold[r]);
      } else {
        v = __fadd_rn(reg[r], fold[r]);
        if (lim && v > limit) v = limit;
        newly += v >= limit && reg[r] < limit;
      }
      if (__float_as_int(v) != __float_as_int(reg[r]))
        regs[r * nn + c0 + c] = v;
      set[r] = v;
      if (!kFeatures || (r != kTMin && r != kTMax)) settled[r * tile + c] = v;
    }
  }
  if (kFeatures) {
    // the column's q threads are lanes first .. first + q - 1 of one warp
    const int first = lane & ~(q - 1);
    const float cnt = __shfl_sync(0xffffffffu, set[0], first);
    const float t_min = __shfl_sync(0xffffffffu, set[kTMin], first + kTMin % q);
    const float t_max = __shfl_sync(0xffffffffu, set[kTMax], first + kTMax % q);
    const float dur = cnt > 0.f ? __fsub_rn(t_max, t_min) : 0.f;
    if (c < cols && k == kTMin % q) settled[kTMin * tile + c] = dur;
    if (c < cols && k == kTMax % q)
      settled[kTMax * tile + c] =
          cnt > 1.f ? __fdiv_rn(dur, fmaxf(__fsub_rn(cnt, 1.f), 1.f)) : 0.f;
  }
  if (n_over != nullptr) {           // the same branch for the whole block
    newly = __reduce_add_sync(0xffffffffu, newly);
    if (lane == 0 && newly) atomicAdd(&over, newly);
  }
  __syncthreads();
  if (n_over != nullptr && threadIdx.x == 0 && over) atomicAdd(n_over, over);

  // 4. the rows of the lanes this tile owns
  for (int lo = 0; lo < w; lo += kListLanes) {
    int b[kScan];
#pragma unroll
    for (int s = 0; s < kScan; ++s) {
      const int i = lo + s * kBlock + threadIdx.x;
      b[s] = i < w ? __ldg(bucket + i) : c0 - 1;
    }
#pragma unroll
    for (int s = 0; s < kScan; ++s) {
      const int i = lo + s * kBlock + threadIdx.x;
      int g = b[s];
      if (g < 0) g += n;                // the reference's gather semantics
      g = g < 0 ? 0 : (g >= n ? n - 1 : g);
      if (i >= w || g < c0 || g >= c0 + cols) continue;
      const float* col = settled + g - c0;
      if (kFeatures) {
        float4* dst = reinterpret_cast<float4*>(rows + (size_t)i * kRegisters);
        dst[0] = make_float4(col[0], col[tile], col[2 * tile], col[3 * tile]);
        dst[1] = make_float4(col[4 * tile], col[5 * tile], col[6 * tile],
                             col[7 * tile]);
      } else {
#pragma unroll
        for (int r = 0; r < kRegisters; ++r)
          rows[(size_t)r * w + i] = col[r * tile];
      }
    }
  }
}

}  // namespace

extern "C" {

// tile: bucket columns a block owns (kernels/stream_update.py
// tile_columns): a power of two from 32 to kBlock. features: rows takes
// (W, 8) feature rows (16-byte aligned), else (8, W) register rows. n_over:
// null, or the int the newly saturated count is added to (the clamp on).
int stream_update_launch(void* regs, const void* bucket, const void* ts,
                         const void* length, const void* is_fwd,
                         const void* valid, void* rows, void* n_over, int n,
                         int w, int has_limit, int limit_bits, int tile,
                         int features, void* stream) {
  if (n <= 0 || w < 0 || tile < 32 || tile > kBlock || (tile & (tile - 1)) ||
      (n_over != nullptr && !has_limit) ||
      (features && ((uintptr_t)rows & 15) != 0))
    return (int)cudaErrorInvalidValue;
  float limit;
  memcpy(&limit, &limit_bits, sizeof(float));
  const int grid = (int)(((long long)n + tile - 1) / tile);
  const size_t smem = sizeof(float) * kRegisters * (size_t)tile;
  auto kernel = features ? stream_update_kernel<true>
                         : stream_update_kernel<false>;
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (float*)regs, (const int*)bucket, (const float*)ts, (const float*)length,
      (const float*)is_fwd, (const unsigned char*)valid, (float*)rows,
      (int*)n_over, n, w, tile, has_limit, limit);
  return (int)cudaGetLastError();
}

const char* stream_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
