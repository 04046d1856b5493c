// Fused IIsy tree-ensemble lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/ensemble_lookup.py:
//   _fused_kernel          (:112, select='matmul')  ensemble_matmul_kernel
//   _fused_compare_kernel  (:132, select='compare') ensemble_compare_kernel
// Both compute, for each row n of x (N, F):
//   range match   bins[f] = #{u : x[n,f] > edges[f,u]}            (range_match.cuh)
//   decision key  key[t]  = sum_f ftab[(f*Bp + bins[f]) * Tp + t]  (stride-premultiplied)
//   matmul select out[n,c] = sum_t dtab[(c*T + t) * Sp + key[t]]    (dtable_flat (Co,T,Sp))
//   compare select leaf[t] = dtab[t * Sp + key[t]], then
//                  out[n,c] = #{t : leaf[t] == c} (Co > 1)  or  sum_t leaf[t] (Co == 1)
//
// The TPU wrote each lookup as a one-hot matmul because Pallas has no gather.
// Hopper gathers from shared memory directly: both selects are gathers on
// this card; 'select' only picks which of the two equivalent decision tables
// is read.
//
// Bound: memory. At the serving shape (N=2048, F=5, U~40, T=10, Sp~136, Co=2)
// the call must move ~75 KB (x, tables, out): ~22 ns at 3.35 TB/s, far below
// a launch, so each select is one launch per classify and what it costs is
// its chain of dependent steps.
//
// Matmul select (B1). A block takes `rows` rows of x (tile_n) with `lanes`
// threads a row (a power of two; kernels/ensemble_lookup.py launch_plan):
//   1. copies: the block's rows of x, and the edges when STAGED, go to
//      shared memory by cp.async as one group, the feature and decision
//      tables as a second group that lands behind the range match; meanwhile
//      the (min, max) of every group of 8 edges is read from global memory
//      into shared memory (rm_group_summary);
//   2. range match, one thread per (row, feature): whole groups from their
//      summaries and the one open group edge by edge (range_match_grouped);
//      it keeps the offset of the row's feature-table entry;
//   3. the row's `lanes` threads split its trees: each sums its trees' keys
//      and decision entries (from shared memory when STAGED, else through
//      the read-only cache); the partial sums meet by xor shuffles inside
//      the row's lanes, and each lane writes its share of the Co outputs.
// No block waits on the tables before its range match, and a row's chain is
// split over its lanes. Tables past the shared-memory budget (the mapped
// XGB decision table, 60 x 5712) take the unstaged path, with only x and the
// group summaries in shared memory.
//
// Compare select (B2) keeps its first design: one thread a row, the tables
// staged once per block behind a barrier (STAGED) or read through the
// read-only cache, the serial range match.
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

#define EL_MAX_CO 32       // per-row output columns kept in registers
#define EL_MM_THREADS 512  // most threads of a matmul-select block

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// words [0, count) of src into dst (16-byte aligned), spread over the
// block's threads: 16 bytes a copy where src is 16-byte aligned
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           size_t count) {
  size_t i = threadIdx.x;
  if (aligned16(src)) {
    for (; 4 * i + 3 < count; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
    i = (count & ~(size_t)3) + threadIdx.x;
  }
  for (; i < count; i += blockDim.x) cp_async4(dst + i, src + i);
}

__host__ __device__ inline size_t up4(size_t words) {
  return (words + 3) & ~(size_t)3;
}

// A matmul-select block's shared memory, in 4-byte words, each part
// 16-byte aligned: the group summaries, the block's rows of x, their
// feature-table offsets, then when STAGED the edges, the feature table's
// first t_dim columns (rounded up to 4) in rows `fs` apart, and the
// decision table. fs is 4 more than a multiple of 8, so the rows that one
// tree's lanes read fall on 8 different bank offsets. Mirrored by
// smem_bytes in kernels/ensemble_lookup.py.
struct MmLayout {
  size_t xs, rowoff, edges, ftab, dtab, words;
  int fs;
};

__host__ __device__ inline MmLayout mm_layout(int rows, int f_dim, int u_dim,
                                              int b_pad, int t_pad, int t_dim,
                                              int s_pad, int co, bool staged) {
  MmLayout l;
  l.fs = (int)up4(t_dim) + (up4(t_dim) % 8 ? 0 : 4);
  l.xs = up4(2 * (size_t)f_dim * rm_groups(u_dim));
  l.rowoff = l.xs + up4((size_t)rows * f_dim);
  l.edges = l.rowoff + up4((size_t)rows * f_dim);
  l.ftab = l.edges + (staged ? up4((size_t)f_dim * u_dim) : 0);
  l.dtab = l.ftab + (staged ? (size_t)f_dim * b_pad * l.fs : 0);
  l.words = l.dtab + (staged ? (size_t)co * t_dim * s_pad : 0);
  return l;
}

// MAX_CO: a bound on co known to the compiler, so a row's sums stay in
// registers and the class loops unroll to what the artifact has.
template <bool STAGED, int MAX_CO>
__global__ void __launch_bounds__(EL_MM_THREADS)
ensemble_matmul_kernel(const float* __restrict__ x,
                       const float* __restrict__ edges,
                       const float* __restrict__ ftab,
                       const float* __restrict__ dtab,
                       float* __restrict__ out, int n, int f_dim, int u_dim,
                       int b_pad, int t_pad, int t_dim, int s_pad, int co,
                       int rows, int lanes) {
  extern __shared__ __align__(16) float mm_smem[];
  const MmLayout l = mm_layout(rows, f_dim, u_dim, b_pad, t_pad, t_dim,
                               s_pad, co, STAGED);
  float2* sums = reinterpret_cast<float2*>(mm_smem);   // at word 0
  float* xs = mm_smem + l.xs;
  int* rowoff = reinterpret_cast<int*>(mm_smem + l.rowoff);
  const long long row0 = (long long)blockIdx.x * rows;
  const int live_rows = (int)min((long long)rows, (long long)n - row0);
  const int items = live_rows * f_dim;

  // 1. x (and the edges), then the tables, in flight while the group
  //    summaries are read
  copy_async(xs, x + row0 * f_dim, items);
  if (STAGED) copy_async(mm_smem + l.edges, edges, (size_t)f_dim * u_dim);
  cp_async_commit();
  if (STAGED) {
    float* f_dst = mm_smem + l.ftab;
    const size_t ft_rows = (size_t)f_dim * b_pad;
    if (aligned16(ftab) && t_pad % 4 == 0) {    // 16 bytes of a row a copy
      const int chunks = (t_dim + 3) / 4;
      for (size_t i = threadIdx.x; i < ft_rows * chunks; i += blockDim.x) {
        const size_t row = i / chunks, k = 4 * (i - row * chunks);
        cp_async16(f_dst + row * l.fs + k, ftab + row * t_pad + k);
      }
    } else {
      for (size_t i = threadIdx.x; i < ft_rows * t_dim; i += blockDim.x) {
        const size_t row = i / t_dim, col = i - row * t_dim;
        cp_async4(f_dst + row * l.fs + col, ftab + row * t_pad + col);
      }
    }
    copy_async(mm_smem + l.dtab, dtab, (size_t)co * t_dim * s_pad);
  }
  cp_async_commit();
  const int groups = rm_groups(u_dim);
  for (int i = threadIdx.x; i < f_dim * groups; i += blockDim.x) {
    const int f = i / groups;
    sums[i] = rm_group_summary<false>(edges + (size_t)f * u_dim, u_dim,
                                      i - f * groups);
  }
  cp_async_wait<1>();
  __syncthreads();

  // 2. range match, one thread per (row, feature)
  const float* e_tab = STAGED ? mm_smem + l.edges : edges;
  const int stride = STAGED ? l.fs : t_pad;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int f = i % f_dim;
    const int b = range_match_grouped<STAGED>(
        xs[i], e_tab + (size_t)f * u_dim, sums + f * groups, u_dim);
    rowoff[i] = (f * b_pad + b) * stride;
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. a row's lanes split its trees; every thread takes each round, so
  //    the shuffles see whole warps
  const float* f_tab = STAGED ? mm_smem + l.ftab : ftab;
  const float* d_tab = STAGED ? mm_smem + l.dtab : dtab;
  const int lane = threadIdx.x & (lanes - 1);
  for (int base = 0; base < rows * lanes; base += blockDim.x) {
    const int r = (base + (int)threadIdx.x) / lanes;
    const bool live = r < live_rows;
    float acc[MAX_CO];
#pragma unroll
    for (int c = 0; c < MAX_CO; ++c) acc[c] = 0.f;
    if (live) {
      const int* ro = rowoff + r * f_dim;
      for (int t = lane; t < t_dim; t += lanes) {
        float kf = 0.f;
#pragma unroll 4
        for (int f = 0; f < f_dim; ++f)
          kf += rm_load<STAGED>(f_tab + ro[f] + t);
        const int key = (int)kf;              // exact: integer below 2^24
#pragma unroll
        for (int c = 0; c < MAX_CO; ++c)
          if (c < co)
            acc[c] += rm_load<STAGED>(d_tab + ((size_t)c * t_dim + t) * s_pad +
                                      key);
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < MAX_CO; ++c)
        if (c < co) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
    }
    if (live) {
      float* orow = out + (row0 + r) * co;
#pragma unroll
      for (int c = 0; c < MAX_CO; ++c)
        if (c < co && (c & (lanes - 1)) == lane) orow[c] = acc[c];
    }
  }
}

template <bool STAGED>
__global__ void ensemble_compare_kernel(
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
    const int nd = t_dim * s_pad;
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
    const float leaf = rm_load<STAGED>(d_tab + (size_t)t * s_pad + key);
    if (co == 1) {
      acc[0] += leaf;
    } else {
#pragma unroll
      for (int c = 0; c < EL_MAX_CO; ++c)
        if (c < co) acc[c] += (leaf == (float)c) ? 1.f : 0.f;
    }
  }
  float* o = out + (size_t)row * co;
#pragma unroll
  for (int c = 0; c < EL_MAX_CO; ++c)
    if (c < co) o[c] = acc[c];
}

template <typename K, typename... Args>
int launch(K kern, int blocks, int threads, int smem, cudaStream_t stream,
           Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory a compare-select launch asks for.
size_t compare_smem_bytes(int f_dim, int u_dim, int b_pad, int t_pad,
                          int t_dim, int s_pad, int staged, int block) {
  size_t bytes = (size_t)f_dim * block * sizeof(int);
  if (staged)
    bytes += ((size_t)f_dim * u_dim + (size_t)f_dim * b_pad * t_pad +
              (size_t)t_dim * s_pad) * sizeof(float);
  return bytes;
}

}  // namespace

extern "C" {

// rows: rows of x a block takes (tile_n); lanes: threads a row takes (a
// power of two up to 32 for the matmul select, 1 for the compare select);
// threads: threads a block has (the compare select: rows); smem: dynamic
// shared memory in bytes. All four come from launch_plan in
// kernels/ensemble_lookup.py; a plan this source does not agree with is
// refused.
int ensemble_lookup_launch(const void* x, const void* edges, const void* ftab,
                           const void* dtab, void* out, int n, int f_dim,
                           int u_dim, int b_pad, int t_pad, int t_dim,
                           int s_pad, int co, int compare, int staged,
                           int rows, int lanes, int threads, int smem,
                           void* stream) {
  if (n <= 0) return 0;
  if (co < 1 || co > EL_MAX_CO || rows < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || threads < 1)
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* ef = (const float*)edges;
  const float* ff = (const float*)ftab;
  const float* df = (const float*)dtab;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (int)(((long long)n + rows - 1) / rows);
  if (compare) {
    if (lanes != 1 || threads != rows || rows > 1024 ||
        smem < 0 ||
        (size_t)smem != compare_smem_bytes(f_dim, u_dim, b_pad, t_pad, t_dim,
                                           s_pad, staged, rows))
      return (int)cudaErrorInvalidValue;
    return launch(staged ? ensemble_compare_kernel<true>
                         : ensemble_compare_kernel<false>,
                  blocks, threads, smem, s, xf, ef, ff, df, of, n, f_dim,
                  u_dim, b_pad, t_pad, t_dim, s_pad, co);
  }
  const MmLayout l = mm_layout(rows, f_dim, u_dim, b_pad, t_pad, t_dim, s_pad,
                               co, staged != 0);
  if (threads % 32 || threads > EL_MM_THREADS || threads % lanes ||
      smem < 0 || (size_t)smem != l.words * sizeof(float))
    return (int)cudaErrorInvalidValue;
  // two classes (or one sum), the served case, or up to EL_MAX_CO
  auto kern = co <= 2 ? (staged ? ensemble_matmul_kernel<true, 2>
                                : ensemble_matmul_kernel<false, 2>)
                      : (staged ? ensemble_matmul_kernel<true, EL_MAX_CO>
                                : ensemble_matmul_kernel<false, EL_MAX_CO>);
  return launch(kern, blocks, threads, smem, s, xf, ef, ff, df, of, n, f_dim,
                u_dim, b_pad, t_pad, t_dim, s_pad, co, rows, lanes);
}

const char* ensemble_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
