// Fused IIsy tree-ensemble lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/ensemble_lookup.py:
//   _fused_kernel          (:112, select='matmul')  B1
//   _fused_compare_kernel  (:132, select='compare') B2
// both as ensemble_lookup_kernel<STAGE, COMPARE, MAX_CO>. For each row n of
// x (N, F):
//   range match   bins[f] = #{u : x[n,f] > edges[f,u]}            (range_match.cuh)
//   decision key  key[t]  = sum_f ftab[(f*Bp + bins[f]) * Tp + t]  (stride-premultiplied)
//   matmul select out[n,c] = sum_t dtab[(c*T + t) * Sp + key[t]]    (dtable_flat (Co,T,Sp))
//   compare select leaf[t] = dtab[t * Sp + key[t]], then
//                  out[n,c] = #{t : leaf[t] == c} (Co > 1)  or  sum_t leaf[t] (Co == 1)
// A key outside [0, Sp) matches no entry, as in the reference's one-hot
// match: the matmul select adds nothing for that tree, the compare select
// reads leaf 0 (a vote for class 0, or 0 added to the sum).
//
// The TPU wrote each lookup as a one-hot matmul because Pallas has no
// gather. Hopper gathers from shared memory directly: both selects are
// gathers on this card; 'select' only picks which of the two decision
// tables is read, and the kernel differs only in its last step.
//
// Bound: memory. At the serving shape (N=2048, F=5, U~40, T=10, Sp~136, Co=2)
// the call must move ~75 KB (x, tables, out): ~22 ns at 3.35 TB/s, far below
// a launch, so each select is one launch per classify and what it costs is
// its chain of dependent steps.
//
// A block takes `rows` rows of x (tile_n) with `lanes` threads a row (a
// power of two; kernels/ensemble_lookup.py launch_plan), in the three steps
// of lane_lookup.cuh: the copies (x and the edges, then the feature
// table's first T columns in rows `fs` apart and the decision table as a
// second group that lands behind the range match), the grouped range match
// keeping each (row, feature)'s feature-table offset, and the row's trees
// split over its lanes: each sums its trees' keys and reads their decision
// entries, and the lanes' partial votes or sums meet by xor shuffles.
// STAGE says which tables live in shared memory; the rest are read through
// the read-only cache:
//   STAGE_ALL   edges, the feature table and the decision table;
//   STAGE_KEYS  edges and the feature table: what the keys need. Taken when
//               the decision table is past the budget (the isolation
//               forest's 32 x 7488, the mapped XGB backend's 60 x 5712):
//               only its T entries a row come from global memory;
//   STAGE_NONE  none (x and the group summaries only).
//
// Exactness: keys and payloads are integers carried in f32 below 2^24, so
// every sum is exact in any order and the output is bit-identical to the
// plain PyTorch version. No matmul, so TF32 cannot enter.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "lane_lookup.cuh"
#include "range_match.cuh"

#define EL_MAX_CO 32     // per-row output columns kept in registers
#define EL_THREADS 512   // most threads of a block
#define EL_REG_F 8       // features whose row offsets a thread keeps in registers

enum { STAGE_NONE = 0, STAGE_KEYS = 1, STAGE_ALL = 2 };

namespace {

// A block's shared memory, in 4-byte words, each part 16-byte aligned:
// lane_head (group summaries, the block's rows of x, their feature-table
// offsets), then from STAGE_KEYS the edges and the feature table's first
// t_dim columns (rounded up to 4) in rows `fs` apart, and at STAGE_ALL the
// decision table (d_rows x t_dim x s_pad: Co rows for the matmul select,
// 1 for the compare select). fs is 4 more than a multiple of 8, so the rows
// that one tree's lanes read fall on 8 different bank offsets. Mirrored by
// smem_bytes in kernels/ensemble_lookup.py.
struct ElLayout {
  LaneHead h;
  size_t ftab, dtab, words;
  int fs;
};

__host__ __device__ inline ElLayout el_layout(int rows, int f_dim, int u_dim,
                                              int b_pad, int t_dim, int s_pad,
                                              int d_rows, int stage) {
  ElLayout l;
  l.h = lane_head(rows, f_dim, u_dim);
  l.fs = (int)up4(t_dim) + (up4(t_dim) % 8 ? 0 : 4);
  const bool keys = stage >= STAGE_KEYS;
  l.ftab = l.h.tables + (keys ? up4((size_t)f_dim * u_dim) : 0);
  l.dtab = l.ftab + (keys ? (size_t)f_dim * b_pad * l.fs : 0);
  l.words = l.dtab + (stage == STAGE_ALL ? (size_t)d_rows * t_dim * s_pad : 0);
  return l;
}

// MAX_CO: a bound on co known to the compiler, so a row's sums stay in
// registers and the class loops unroll to what the artifact has.
template <int STAGE, bool COMPARE, int MAX_CO>
__global__ void __launch_bounds__(EL_THREADS)
ensemble_lookup_kernel(const float* __restrict__ x,
                       const float* __restrict__ edges,
                       const float* __restrict__ ftab,
                       const float* __restrict__ dtab,
                       float* __restrict__ out, int n, int f_dim, int u_dim,
                       int b_pad, int t_pad, int t_dim, int s_pad, int co,
                       int rows, int lanes) {
  constexpr bool KS = STAGE >= STAGE_KEYS;    // edges, feature table
  constexpr bool DS = STAGE == STAGE_ALL;     // decision table
  extern __shared__ __align__(16) float el_smem[];
  const int d_rows = COMPARE ? 1 : co;
  const ElLayout l = el_layout(rows, f_dim, u_dim, b_pad, t_dim, s_pad,
                               d_rows, STAGE);
  const long long row0 = (long long)blockIdx.x * rows;
  const int live_rows = (int)min((long long)rows, (long long)n - row0);

  // 1. x (and the edges), then the tables, in flight while step 2 reads
  //    the group summaries
  lane_copy_x<KS>(el_smem, l.h, x, edges, row0, live_rows * f_dim, f_dim,
                  u_dim);
  if (KS) {
    float* f_dst = el_smem + l.ftab;
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
  }
  if (DS) copy_async(el_smem + l.dtab, dtab, (size_t)d_rows * t_dim * s_pad);
  cp_async_commit();

  // 2. range match, one thread per (row, feature)
  lane_range_match<KS>(el_smem, l.h, edges, live_rows * f_dim, f_dim, u_dim,
                       b_pad, KS ? l.fs : t_pad);

  // 3. a row's lanes split its trees
  const int* rowoff = reinterpret_cast<const int*>(el_smem + l.h.off);
  const float* f_tab = KS ? el_smem + l.ftab : ftab;
  const float* d_tab = DS ? el_smem + l.dtab : dtab;
  lane_rows<MAX_CO>(rows, lanes, live_rows, co, out + row0 * co,
                    [&](int r, int lane, float (&acc)[MAX_CO]) {
    // the row's feature-table offsets, held in registers when F is at most
    // EL_REG_F: one shared-memory read less in each tree's chain
    const int* ro = rowoff + r * f_dim;
    int rof[EL_REG_F];
#pragma unroll
    for (int f = 0; f < EL_REG_F; ++f) rof[f] = f < f_dim ? ro[f] : 0;
    for (int t = lane; t < t_dim; t += lanes) {
      float kf = 0.f;
      if (f_dim <= EL_REG_F) {
#pragma unroll
        for (int f = 0; f < EL_REG_F; ++f)
          if (f < f_dim) kf += rm_load<KS>(f_tab + rof[f] + t);
      } else {
#pragma unroll 4
        for (int f = 0; f < f_dim; ++f) kf += rm_load<KS>(f_tab + ro[f] + t);
      }
      const int key = (int)kf;              // exact: integer below 2^24
      // one compare a (row, tree); the entry is read at a key clamped into
      // the table and dropped when outside
      const bool inside = (unsigned)key < (unsigned)s_pad;
      const int k = inside ? key : 0;
      if (COMPARE) {
        const float e = rm_load<DS>(d_tab + (size_t)t * s_pad + k);
        const float leaf = inside ? e : 0.f;
        if (co == 1) {
          acc[0] += leaf;
        } else {
#pragma unroll
          for (int c = 0; c < MAX_CO; ++c)
            if (c < co) acc[c] += (leaf == (float)c) ? 1.f : 0.f;
        }
      } else {
#pragma unroll
        for (int c = 0; c < MAX_CO; ++c)
          if (c < co) {
            const float e =
                rm_load<DS>(d_tab + ((size_t)c * t_dim + t) * s_pad + k);
            acc[c] += inside ? e : 0.f;
          }
      }
    }
  });
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, float*, int, int, int, int, int, int,
                        int, int, int, int);

// two classes (or one sum), the served case, or up to EL_MAX_CO
template <int STAGE, bool COMPARE>
Kernel pick_co(int co) {
  return co <= 2 ? ensemble_lookup_kernel<STAGE, COMPARE, 2>
                 : ensemble_lookup_kernel<STAGE, COMPARE, EL_MAX_CO>;
}

template <bool COMPARE>
Kernel pick(int stage, int co) {
  if (stage == STAGE_ALL) return pick_co<STAGE_ALL, COMPARE>(co);
  if (stage == STAGE_KEYS) return pick_co<STAGE_KEYS, COMPARE>(co);
  return pick_co<STAGE_NONE, COMPARE>(co);
}

}  // namespace

extern "C" {

// rows: rows of x a block takes (tile_n); lanes: threads a row (a power of
// two up to 32); threads: threads a block has; smem: dynamic shared memory
// in bytes; stage: STAGE_NONE, STAGE_KEYS or STAGE_ALL. All five come from
// launch_plan in kernels/ensemble_lookup.py; a plan this source does not
// agree with is refused.
int ensemble_lookup_launch(const void* x, const void* edges, const void* ftab,
                           const void* dtab, void* out, int n, int f_dim,
                           int u_dim, int b_pad, int t_pad, int t_dim,
                           int s_pad, int co, int compare, int stage,
                           int rows, int lanes, int threads, int smem,
                           void* stream) {
  if (n <= 0) return 0;
  if (co < 1 || co > EL_MAX_CO || !lane_plan_ok(rows, lanes, threads,
                                                 EL_THREADS) ||
      stage < STAGE_NONE || stage > STAGE_ALL)
    return (int)cudaErrorInvalidValue;
  const ElLayout l = el_layout(rows, f_dim, u_dim, b_pad, t_dim, s_pad,
                               compare ? 1 : co, stage);
  if (smem < 0 || (size_t)smem != l.words * sizeof(float))
    return (int)cudaErrorInvalidValue;
  return lane_launch(compare ? pick<true>(stage, co) : pick<false>(stage, co),
                     n, rows, threads, smem, stream, (const float*)x,
                     (const float*)edges, (const float*)ftab,
                     (const float*)dtab, (float*)out, n, f_dim, u_dim, b_pad,
                     t_pad, t_dim, s_pad, co, rows, lanes);
}

const char* ensemble_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
