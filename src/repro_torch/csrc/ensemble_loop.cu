// Per-feature-loop IIsy tree-ensemble lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/ensemble_lookup.py:
//   _loop_kernel  (:249, reached from ensemble_lookup_pallas_loop :289)
// the pre-fusion formulation that the tile autotune keeps as a candidate
// (TileConfig(impl='loop')). For each row n of x (N, F) and tree t:
//   range match  bins[f] = #{u : x[n,f] > edges[f,u]}             (range_match.cuh)
//   key          k = 0; for f = 0..F-1: k = k + ftable[f, bins[f], t] * strides[t, f]
//                (f32, in that order, then cast to int32)
//   leaf         dtable[t, k] for k in [0, S), else 0.0             (compare-select)
//   out[n, c]  = #{t : leaf == c}  (vote, c < Co)   or   sum_t leaf  (sum, Co == 1)
//
// The TPU ran each feature's lookup as a small one-hot matmul and the leaf
// select as a masked sum over S. Here the kernel has the structure of the
// fused lookup (ensemble_lookup.cu), the three steps of lane_lookup.cuh: a
// block takes `rows` rows of x (tile_n) with `lanes` threads a row
// (kernels/ensemble_lookup.py loop_launch_plan):
//   1. copies: the block's rows of x, and the edges when STAGED, as one
//      cp.async group; the int32 codes, the strides and the unpadded (T, S)
//      decision table, each copied flat (16 bytes a copy where the array is
//      16-byte aligned; S = 130 rows are not), as a second group that lands
//      behind the range match;
//   2. the grouped range match, one thread per (row, feature), keeping the
//      offset of the row's code row;
//   3. the row's lanes split its trees, each lane whole trees: a tree's key
//      is summed feature by feature in the reference's order, and
//      __fmul_rn/__fadd_rn keep nvcc from contracting the step into an FMA,
//      so the key rounds as the plain version's does even past 2^24; the
//      lanes' votes or sums meet by xor shuffles.
// Tables past the shared-memory budget (the mapped XGB backend's 60 x 5712
// decision table) are read through the read-only cache (STAGED false).
//
// Bound: memory. At the serving shape (N=2048, F=5, U~39, T=10, S<=136)
// the call must move ~72 KB (x, tables, out): ~21 ns at 3.35 TB/s, far
// below a launch, so one launch per classify; its time is its chain of
// dependent steps. PERF.md holds the measured time.
//
// Exactness: codes, strides and payloads are integers carried in f32; keys
// below 2^24 and the sums (votes, or at most T 16-bit payloads) are exact in
// any order, so the output is bit-identical to ensemble_lookup_loop_ref.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <stddef.h>

#include "lane_lookup.cuh"
#include "range_match.cuh"

#define LP_MAX_CO 32     // per-row output columns kept in registers
#define LP_THREADS 512   // most threads of a block

namespace {

template <bool STAGED, typename T>
__device__ __forceinline__ T lp_load(const T* p) {
  if (STAGED) return *p;
  return __ldg(p);
}

// A block's shared memory, in 4-byte words, each part 16-byte aligned:
// lane_head (group summaries, the block's rows of x, their code-row
// offsets), then when STAGED the edges, the codes (F, U+1, T), the strides
// (T, F) and the decision table (T, S). Mirrored by loop_smem_bytes in
// kernels/ensemble_lookup.py.
struct LpLayout {
  LaneHead h;
  size_t codes, strides, dtab, words;
};

__host__ __device__ inline LpLayout lp_layout(int rows, int f_dim, int u_dim,
                                              int t_dim, int s_dim,
                                              bool staged) {
  LpLayout l;
  l.h = lane_head(rows, f_dim, u_dim);
  l.codes = l.h.tables + (staged ? up4((size_t)f_dim * u_dim) : 0);
  l.strides = l.codes + (staged ? up4((size_t)f_dim * (u_dim + 1) * t_dim) : 0);
  l.dtab = l.strides + (staged ? up4((size_t)t_dim * f_dim) : 0);
  l.words = l.dtab + (staged ? (size_t)t_dim * s_dim : 0);
  return l;
}

template <bool STAGED, int MAX_CO>
__global__ void __launch_bounds__(LP_THREADS)
ensemble_loop_kernel(const float* __restrict__ x,
                     const float* __restrict__ edges,
                     const int* __restrict__ ftab,
                     const int* __restrict__ strides,
                     const float* __restrict__ dtab, float* __restrict__ out,
                     int n, int f_dim, int u_dim, int t_dim, int s_dim, int co,
                     int vote, int rows, int lanes) {
  extern __shared__ __align__(16) float lp_smem[];
  const LpLayout l = lp_layout(rows, f_dim, u_dim, t_dim, s_dim, STAGED);
  const long long row0 = (long long)blockIdx.x * rows;
  const int live_rows = (int)min((long long)rows, (long long)n - row0);

  // 1. x (and the edges), then the tables, in flight while step 2 reads
  //    the group summaries
  lane_copy_x<STAGED>(lp_smem, l.h, x, edges, row0, live_rows * f_dim, f_dim,
                      u_dim);
  if (STAGED) {
    copy_async(lp_smem + l.codes, ftab, (size_t)f_dim * (u_dim + 1) * t_dim);
    copy_async(lp_smem + l.strides, strides, (size_t)t_dim * f_dim);
    copy_async(lp_smem + l.dtab, dtab, (size_t)t_dim * s_dim);
  }
  cp_async_commit();

  // 2. range match, one thread per (row, feature)
  lane_range_match<STAGED>(lp_smem, l.h, edges, live_rows * f_dim, f_dim,
                           u_dim, u_dim + 1, t_dim);

  // 3. a row's lanes split its trees, each lane whole trees
  const int* binoff = reinterpret_cast<const int*>(lp_smem + l.h.off);
  const int* c_tab =
      STAGED ? reinterpret_cast<const int*>(lp_smem + l.codes) : ftab;
  const int* st_tab =
      STAGED ? reinterpret_cast<const int*>(lp_smem + l.strides) : strides;
  const float* d_tab = STAGED ? lp_smem + l.dtab : dtab;
  lane_rows<MAX_CO>(rows, lanes, live_rows, co, out + row0 * co,
                    [&](int r, int lane, float (&acc)[MAX_CO]) {
    const int* bo = binoff + r * f_dim;
    for (int t = lane; t < t_dim; t += lanes) {
      float kf = 0.f;
      for (int f = 0; f < f_dim; ++f) {
        const float code = (float)lp_load<STAGED>(c_tab + bo[f] + t);
        const float stride = (float)lp_load<STAGED>(st_tab + t * f_dim + f);
        kf = __fadd_rn(kf, __fmul_rn(code, stride));
      }
      const int key = (int)kf;
      // read at a key clamped into the table, dropped when outside
      const bool inside = (unsigned)key < (unsigned)s_dim;
      const float e = lp_load<STAGED>(d_tab + (size_t)t * s_dim +
                                      (inside ? key : 0));
      const float leaf = inside ? e : 0.f;
      if (vote) {
#pragma unroll
        for (int c = 0; c < MAX_CO; ++c)
          if (c < co) acc[c] += (leaf == (float)c) ? 1.f : 0.f;
      } else {
        acc[0] += leaf;
      }
    }
  });
}

using Kernel = void (*)(const float*, const float*, const int*, const int*,
                        const float*, float*, int, int, int, int, int, int,
                        int, int, int);

}  // namespace

extern "C" {

// rows: rows of x a block takes (tile_n); lanes: threads a row (a power of
// two up to 32); threads: threads a block has; smem: dynamic shared memory
// in bytes. All four come from loop_launch_plan in
// kernels/ensemble_lookup.py; a plan this source does not agree with is
// refused.
int ensemble_loop_launch(const void* x, const void* edges, const void* ftab,
                         const void* strides, const void* dtab, void* out,
                         int n, int f_dim, int u_dim, int t_dim, int s_dim,
                         int co, int vote, int staged, int rows, int lanes,
                         int threads, int smem, void* stream) {
  if (n <= 0) return 0;
  if (co < 1 || co > LP_MAX_CO || (!vote && co != 1) ||
      !lane_plan_ok(rows, lanes, threads, LP_THREADS))
    return (int)cudaErrorInvalidValue;
  const LpLayout l = lp_layout(rows, f_dim, u_dim, t_dim, s_dim, staged != 0);
  if (smem < 0 || (size_t)smem != l.words * sizeof(float))
    return (int)cudaErrorInvalidValue;
  // two classes (or one sum), the served case, or up to LP_MAX_CO
  const Kernel kern =
      co <= 2 ? (staged ? ensemble_loop_kernel<true, 2>
                        : ensemble_loop_kernel<false, 2>)
              : (staged ? ensemble_loop_kernel<true, LP_MAX_CO>
                        : ensemble_loop_kernel<false, LP_MAX_CO>);
  return lane_launch(kern, n, rows, threads, smem, stream, (const float*)x,
                     (const float*)edges, (const int*)ftab,
                     (const int*)strides, (const float*)dtab, (float*)out, n,
                     f_dim, u_dim, t_dim, s_dim, co, vote, rows, lanes);
}

const char* ensemble_loop_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
