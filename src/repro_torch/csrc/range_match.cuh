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
// Included by ensemble_lookup.cu, classical_lookup.cu and bucketize.cu;
// the build hashes this header into every library's name (kernels/_build.py).

#pragma once

#include <cuda_runtime.h>

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
