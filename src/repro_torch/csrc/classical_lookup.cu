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
// lane-padding columns M..Mp are never read or written.
//
// The TPU wrote the lookup as one blocked one-hot matmul because Pallas has
// no gather. Here the kernel is the lane lookups' front half
// (lane_lookup.cuh, shared with B1/B2/B7) with its own last step. A block
// takes `rows` rows of x (tile_n) with `lanes` threads a row
// (kernels/classical_lookup.py launch_plan):
//   1. x and the edges go to shared memory by cp.async as one group, the
//      value table's M live columns (packed, M words a row: at M=2 of Mp=8 a
//      quarter of the table) as a second group that lands behind step 2;
//   2. the range match from (min, max) summaries of groups of 8 edges, one
//      thread per (row, feature), keeping the offset of its table row;
//   3. a row's F features split over its lanes: each adds the M columns of
//      its features' table rows, and the lanes meet by xor shuffles
//      (lanes_merge_store), CL_MAX_M columns at a time.
// STAGE says what lives in shared memory; the rest is read through the
// read-only cache:
//   STAGE_ALL    the edges and the value table's M columns;
//   STAGE_EDGES  the edges (the value table past the budget);
//   STAGE_NONE   neither (x and the group summaries only).
//
// Bound: memory. The call must move x, the edges, the table entries it
// reads and out once: at the served shape (N=2048, F=5, U=63, Bp=64, M<=2)
// about 60 KB, ~20 ns at 3.35 TB/s, far below one launch; so the design
// keeps to one launch per classify, and what it costs is its chain of
// dependent steps.
//
// Exactness envelope: vtable entries are integers |q| <= 2^(bits-1) - 1.
// While F * (2^(bits-1) - 1) <= 2^24 every partial sum is an integer that
// f32 holds exactly, so the sum is exact in any order (the lanes' split
// and the shuffles included) and the output equals the plain PyTorch
// version bit for bit. At action_bits=16 that covers F <= 512 (the served
// models have F=5). No matmul, so TF32 cannot enter.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "lane_lookup.cuh"
#include "range_match.cuh"

#define CL_MAX_M 16      // output columns a row's lanes sum in registers at once
#define CL_THREADS 512   // most threads of a block

enum { STAGE_NONE = 0, STAGE_EDGES = 1, STAGE_ALL = 2 };

namespace {

// A block's shared memory, in 4-byte words, each part 16-byte aligned:
// lane_head (group summaries, the block's rows of x, their table-row
// offsets), then from STAGE_EDGES the edges, and at STAGE_ALL the value
// table's first m_dim columns, m_dim words a row. Mirrored by smem_bytes in
// kernels/classical_lookup.py.
struct ClLayout {
  LaneHead h;
  size_t vtab, words;
};

__host__ __device__ inline ClLayout cl_layout(int rows, int f_dim, int u_dim,
                                              int b_pad, int m_dim,
                                              int stage) {
  ClLayout l;
  l.h = lane_head(rows, f_dim, u_dim);
  l.vtab = l.h.tables +
           (stage >= STAGE_EDGES ? up4((size_t)f_dim * u_dim) : 0);
  l.words = l.vtab +
            (stage == STAGE_ALL ? (size_t)f_dim * b_pad * m_dim : 0);
  return l;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

// The first `cols` words of each of `n_rows` rows `stride` words apart in
// src, packed `cols` words a row into dst (16-byte aligned), spread over
// the block's threads: the widest copy (16, 8 or 4 bytes) that the row
// width, the stride and src's alignment allow.
__device__ __forceinline__ void copy_cols_async(float* dst, const float* src,
                                                int n_rows, int stride,
                                                int cols) {
  if (cols == stride) {
    copy_async(dst, src, (size_t)n_rows * cols);
    return;
  }
  const size_t a = reinterpret_cast<size_t>(src);
  const int k = (cols % 4 == 0 && stride % 4 == 0 && (a & 15) == 0) ? 4
                : (cols % 2 == 0 && stride % 2 == 0 && (a & 7) == 0) ? 2
                                                                     : 1;
  const int chunks = cols / k;
  for (size_t i = threadIdx.x; i < (size_t)n_rows * chunks; i += blockDim.x) {
    const size_t row = i / chunks, c = k * (i - row * chunks);
    float* d = dst + row * cols + c;
    const float* s = src + row * stride + c;
    if (k == 4) cp_async16(d, s);
    else if (k == 2) cp_async8(d, s);
    else cp_async4(d, s);
  }
}

// MAX_M: a bound on the columns summed at once known to the compiler, so a
// row's sums stay in registers (2: the served models; CL_MAX_M otherwise,
// walked in chunks of that many columns).
template <int STAGE, int MAX_M>
__global__ void __launch_bounds__(CL_THREADS)
classical_lookup_kernel(const float* __restrict__ x,
                        const float* __restrict__ edges,
                        const float* __restrict__ vtab,
                        float* __restrict__ out, int n, int f_dim, int u_dim,
                        int b_pad, int m_pad, int m_dim, int rows,
                        int lanes) {
  constexpr bool ES = STAGE >= STAGE_EDGES;   // edges
  constexpr bool VS = STAGE == STAGE_ALL;     // value table
  extern __shared__ __align__(16) float cl_smem[];
  const ClLayout l = cl_layout(rows, f_dim, u_dim, b_pad, m_dim, STAGE);
  const long long row0 = (long long)blockIdx.x * rows;
  const int live_rows = (int)min((long long)rows, (long long)n - row0);

  // 1. x (and the edges), then the value table's live columns, in flight
  //    while step 2 reads the group summaries
  lane_copy_x<ES>(cl_smem, l.h, x, edges, row0, live_rows * f_dim, f_dim,
                  u_dim);
  if (VS) copy_cols_async(cl_smem + l.vtab, vtab, f_dim * b_pad, m_pad, m_dim);
  cp_async_commit();

  // 2. range match, one thread per (row, feature)
  lane_range_match<ES>(cl_smem, l.h, edges, live_rows * f_dim, f_dim, u_dim,
                       b_pad, VS ? m_dim : m_pad);

  // 3. a row's lanes split its features
  const int* off = reinterpret_cast<const int*>(cl_smem + l.h.off);
  const float* v_tab = VS ? cl_smem + l.vtab : vtab;
  const int lane = threadIdx.x & (lanes - 1);
  for (int m0 = 0; m0 < m_dim; m0 += MAX_M) {
    const int co = min(MAX_M, m_dim - m0);
    for (int base = 0; base < rows * lanes; base += blockDim.x) {
      const int r = (base + (int)threadIdx.x) / lanes;
      const bool live = r < live_rows;
      float acc[MAX_M];
#pragma unroll
      for (int c = 0; c < MAX_M; ++c) acc[c] = 0.f;
      if (live) {
        const int* ro = off + r * f_dim;
        for (int f = lane; f < f_dim; f += lanes) {
          const float* v = v_tab + ro[f] + m0;
#pragma unroll
          for (int c = 0; c < MAX_M; ++c)
            if (c < co) acc[c] += rm_load<VS>(v + c);
        }
      }
      lanes_merge_store<MAX_M>(acc, co, lanes, lane, live,
                               out + (row0 + r) * m_dim + m0);
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, int,
                        int, int, int, int, int, int, int);

template <int STAGE>
Kernel pick_m(int m_dim) {
  return m_dim <= 2 ? classical_lookup_kernel<STAGE, 2>
                    : classical_lookup_kernel<STAGE, CL_MAX_M>;
}

Kernel pick(int stage, int m_dim) {
  if (stage == STAGE_ALL) return pick_m<STAGE_ALL>(m_dim);
  if (stage == STAGE_EDGES) return pick_m<STAGE_EDGES>(m_dim);
  return pick_m<STAGE_NONE>(m_dim);
}

}  // namespace

extern "C" {

// rows: rows of x a block takes (tile_n); lanes: threads a row (a power of
// two up to 32); threads: threads a block has; smem: dynamic shared memory
// in bytes; stage: STAGE_NONE, STAGE_EDGES or STAGE_ALL. All five come from
// launch_plan in kernels/classical_lookup.py; a plan this source does not
// agree with is refused.
int classical_lookup_launch(const void* x, const void* edges, const void* vtab,
                            void* out, int n, int f_dim, int u_dim, int b_pad,
                            int m_pad, int m_dim, int stage, int rows,
                            int lanes, int threads, int smem, void* stream) {
  if (n <= 0) return 0;
  if (f_dim < 1 || u_dim < 0 || b_pad < u_dim + 1 || m_dim < 1 ||
      m_dim > m_pad || stage < STAGE_NONE || stage > STAGE_ALL ||
      !lane_plan_ok(rows, lanes, threads, CL_THREADS))
    return (int)cudaErrorInvalidValue;
  const ClLayout l = cl_layout(rows, f_dim, u_dim, b_pad, m_dim, stage);
  if (smem < 0 || (size_t)smem != l.words * sizeof(float))
    return (int)cudaErrorInvalidValue;
  return lane_launch(pick(stage, m_dim), n, rows, threads, smem, stream,
                     (const float*)x, (const float*)edges, (const float*)vtab,
                     (float*)out, n, f_dim, u_dim, b_pad, m_pad, m_dim, rows,
                     lanes);
}

const char* classical_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
