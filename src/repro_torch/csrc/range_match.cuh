// The IIsy range match, shared by every lookup kernel of the port.
//
// Counterpart of _range_match in repro/kernels/ensemble_lookup.py:66, the
// stage the Pallas kernels B1 (_fused_kernel), B2 (_fused_compare_kernel),
// B3 (_fused_classical_kernel) and B4 (_bucketize_kernel) all begin with:
//
//   bins[n, f] = #{u : x[n, f] > edges[f, u]}
//
// It counts with a strict '>': a value equal to an edge stays below it, a
// NaN compares false against every edge and lands in bin 0, and the +inf
// pads of a ragged edge row never match. The TPU ran the compares as one
// vectorised sweep over the edge row; here one thread walks the row.
//
// Included by ensemble_lookup.cu, ensemble_loop.cu, classical_lookup.cu and
// bucketize.cu; the build hashes this header into every library's name
// (kernels/_build.py).
//
// range_match_grouped gives the same count from a (min, max) summary of
// each group of RM_GROUP edges (rm_group_summary), as bucketize.cu does
// with its own padded copy: an element above a group's max counts the whole
// group, one at or below its min none, and only a group the element falls
// inside is compared edge by edge (the whole row when it falls inside
// several: a row out of order, a NaN element). Exact on any row, since every
// edge of a group lies in [min, max]; a group holding a NaN edge gets
// (-inf, +inf) and is never counted whole. On a sorted row an element falls
// inside at most one group.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define RM_GROUP 8   // edges a group summary covers

// STAGED: the table lives in shared memory; otherwise it is read from
// global memory through the read-only cache.
template <bool STAGED>
__device__ __forceinline__ float rm_load(const float* p) {
  if (STAGED) return *p;
  return __ldg(p);
}

// Number of edges in e[0 .. u_dim) that v lies strictly above.
template <bool STAGED>
__device__ __forceinline__ int range_match(float v, const float* e, int u_dim) {
  int b = 0;
  for (int u = 0; u < u_dim; ++u) b += (v > rm_load<STAGED>(e + u)) ? 1 : 0;
  return b;
}

__host__ __device__ __forceinline__ int rm_groups(int u_dim) {
  return (u_dim + RM_GROUP - 1) / RM_GROUP;
}

// (min, max) of edges g*RM_GROUP .. min((g+1)*RM_GROUP, u_dim) of e;
// (-inf, +inf) when one of them is NaN. The group's loads are issued
// together.
template <bool STAGED>
__device__ __forceinline__ float2 rm_group_summary(const float* e, int u_dim,
                                                   int g) {
  float lo = INFINITY, hi = -INFINITY;
  bool nan = false;
  const int u0 = g * RM_GROUP;
#pragma unroll
  for (int j = 0; j < RM_GROUP; ++j) {
    if (u0 + j < u_dim) {
      const float v = rm_load<STAGED>(e + u0 + j);
      nan |= v != v;
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
  return nan ? make_float2(-INFINITY, INFINITY) : make_float2(lo, hi);
}

// range_match(v, e, u_dim) from the row's group summaries sums[0 ..
// rm_groups(u_dim)), read from shared memory.
template <bool STAGED>
__device__ __forceinline__ int range_match_grouped(float v, const float* e,
                                                   const float2* sums,
                                                   int u_dim) {
  const int groups = rm_groups(u_dim);
  int whole = 0, open = 0, which = 0;
#pragma unroll 4
  for (int g = 0; g < groups; ++g) {
    const float2 s = sums[g];
    const bool above = v > s.y;
    const bool inside = !above && !(v <= s.x);
    whole += above ? min(RM_GROUP, u_dim - g * RM_GROUP) : 0;
    open += inside ? 1 : 0;
    which = inside ? g : which;
  }
  if (open > 1) return range_match<STAGED>(v, e, u_dim);
  if (open == 1) {
    const int u0 = which * RM_GROUP;
#pragma unroll
    for (int j = 0; j < RM_GROUP; ++j)
      if (u0 + j < u_dim) whole += (v > rm_load<STAGED>(e + u0 + j)) ? 1 : 0;
  }
  return whole;
}
