// Int8-KV GQA decode attention (B8) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:32
// _decode_attn_kernel (pallas_call at :77). One decode step of a GQA layer
// over an int8 KV cache with per-(slot, head) f32 scales:
//
//   q (B, G, M, hd) f32            M = query heads per kv head
//   k_q, v_q (B, S, G, hd) int8    k_s, v_s (B, S, G, 1) f32
//   valid (B, S) f32               1.0 = live slot of the ring cache
//   out[b,g,m,:] = softmax_s(where(valid > .5, q.k_s * scale, -1e30)) @ v
//
// with k = k_q * k_s and v = v_q * v_s dequantized in f32 registers, never
// in memory. With every slot dead the output is the uniform mean of V over
// all S slots, as the dense softmax and the Pallas kernel give it.
//
// Bound: memory. One launch must read the int8 K/V once, the scales, the
// mask and q, and write out: at the served shape (B=8, S=32768, G=8, M=4,
// hd=128) 536.9 MB of int8, 16.8 MB of scales and 131 KB of mask (one (S,)
// row broadcast over B), 0.165 ms at 3.35 TB/s; its 2*B*G*M*S*hd*2 flops
// are 0.003 ms at 67 TFLOP/s.
//
// Design. The TPU kernel swapped S and G into a (B, G, S, hd) copy and ran
// an in-order grid over (b, g) with S in VMEM blocks. Here the kernel reads
// the cache where it lies, (B, S, G, hd) with its strides: a transposed
// copy of a 20 GB cache per step would cost more than the attention. One
// CTA per (b, g) takes the M query rows of the group; the loop over S runs
// inside the CTA. A group of lanes owns one slot at a time: hd/8 of them
// hold 8 dims each (one 8-byte load of K and of V), so a warp reads whole
// 8-byte-aligned rows. The group is hd/8 rounded up to a power of two
// (16 lanes for hd = 80, h2o-danube's head dim), so no group straddles a
// warp; the lanes past hd/8 hold zeros, load nothing and add nothing to
// the dot. The groups split the slots, kUnroll slots in flight
// each, and keep a running max, sum and accumulator per query row (one
// rescale per kUnroll slots). The dot's shuffle reduction is unrolled with
// a uniform predicate, so the compiler interleaves the slots' reductions.
// A shared-memory merge of the groups' (m, l, acc) ends the CTA.
// Exponentials use expf. A slot past S adds nothing (-inf); a dead slot
// scores -1e30, so it weighs 1 only while no live slot has been seen, as in
// the reference.
//
// The CTA is latency-bound, so it takes 16 warps where the registers allow
// (M <= 4) and 8 where they do not; PERF.md holds its time. B*G CTAs (64 at
// the served shape) use under half of the 132 SMs; a split over S
// (flash-decoding), cp.async/TMA staging and 16-byte loads are left for a
// later change. Sums run in another order than the dense softmax,
// so the kernel agrees with its plain version to rtol 2e-4 / atol 2e-5.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kDims = 8;           // dims per thread: one 8-byte load
constexpr float kDead = -1e30f;    // the reference's masked score

struct Strides {
  long long b, s, g;   // element strides; the head dim is contiguous
};

// lanes a slot takes: hd/8 rounded up to a power of two, so a slot's
// group lies inside one warp and its shuffles stay within it
__host__ __device__ __forceinline__ int lanes_per_slot(int tps) {
  int lps = 1;
  while (lps < tps) lps <<= 1;
  return lps;
}

__device__ __forceinline__ void unpack8(uint2 w, float scale, float* f) {
  f[0] = (float)(int8_t)(w.x) * scale;
  f[1] = (float)(int8_t)(w.x >> 8) * scale;
  f[2] = (float)(int8_t)(w.x >> 16) * scale;
  f[3] = (float)(int8_t)(w.x >> 24) * scale;
  f[4] = (float)(int8_t)(w.y) * scale;
  f[5] = (float)(int8_t)(w.y >> 8) * scale;
  f[6] = (float)(int8_t)(w.y >> 16) * scale;
  f[7] = (float)(int8_t)(w.y >> 24) * scale;
}

template <int M, int kUnroll, int kThreads>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ kq,
                        const float* __restrict__ ks,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vs,
                        const float* __restrict__ valid,
                        float* __restrict__ out, int S, int G, int hd,
                        Strides skq, Strides sks, Strides svq, Strides svs,
                        long long val_b, long long val_s, float scale) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tps = hd / kDims;                 // lanes that hold dims, <= 32
  const int lps = lanes_per_slot(tps);        // lanes per slot, pow2 >= tps
  const int groups = kThreads / lps;          // slots in flight per sweep
  const int grp = threadIdx.x / lps;
  const int lane = threadIdx.x % lps;
  const bool holds = lane < tps;              // lanes past hd/8 hold zeros
  const int d0 = (holds ? lane : 0) * kDims;

  float qr[M][kDims];
  const float* qb = q + ((long long)b * G + g) * M * hd + d0;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < kDims; ++j) qr[m][j] = holds ? qb[m * hd + j] : 0.f;

  float m_run[M], l_run[M], acc[M][kDims];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    m_run[m] = kDead;
    l_run[m] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[m][j] = 0.f;
  }

  const int8_t* kb = kq + b * skq.b + g * skq.g + d0;
  const int8_t* vb = vq + b * svq.b + g * svq.g + d0;
  const float* ksb = ks + b * sks.b + g * sks.g;
  const float* vsb = vs + b * svs.b + g * svs.g;
  const float* valb = valid + b * val_b;

  for (int base = 0; base < S; base += kUnroll * groups) {
    uint2 kw[kUnroll], vw[kUnroll];
    float ksc[kUnroll], vsc[kUnroll], live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = base + u * groups + grp;
      kw[u] = make_uint2(0u, 0u);
      vw[u] = make_uint2(0u, 0u);
      ksc[u] = 0.f;
      vsc[u] = 0.f;
      live[u] = -1.f;                          // -1: past S
      if (s < S) {
        if (holds) {
          kw[u] = __ldg(reinterpret_cast<const uint2*>(kb + s * skq.s));
          vw[u] = __ldg(reinterpret_cast<const uint2*>(vb + s * svq.s));
        }
        ksc[u] = __ldg(ksb + s * sks.s);
        vsc[u] = __ldg(vsb + s * svs.s);
        live[u] = __ldg(valb + s * val_s) > 0.5f ? 1.f : 0.f;
      }
    }
    // scores: every lane of the warp takes part in each shuffle
    float sc[kUnroll][M];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float k[kDims];
      unpack8(kw[u], ksc[u], k);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kDims; ++j) dot = fmaf(qr[m][j], k[j], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)   // a uniform predicate
          if (off < lps) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[u][m] = live[u] > 0.f ? dot * scale
                                 : (live[u] == 0.f ? kDead : -INFINITY);
      }
    }
    // online softmax: one rescale per kUnroll slots
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float mx = m_run[m];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, sc[u][m]);
      const float alpha = expf(m_run[m] - mx);
      l_run[m] *= alpha;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[m][j] *= alpha;
      m_run[m] = mx;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kDims];
      unpack8(vw[u], vsc[u], v);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float p = expf(sc[u][m] - m_run[m]);
        l_run[m] += p;
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[m][j] = fmaf(p, v[j], acc[m][j]);
      }
    }
  }

  // merge the groups' (m, l, acc): acc_s [groups][M][hd], then m_s, l_s
  // [groups][M] (m_s becomes each group's weight), then den_s [M]
  float* acc_s = smem;
  float* m_s = acc_s + groups * M * hd;
  float* l_s = m_s + groups * M;
  float* den_s = l_s + groups * M;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (holds) {
#pragma unroll
      for (int j = 0; j < kDims; ++j)
        acc_s[(grp * M + m) * hd + d0 + j] = acc[m][j];
    }
    if (lane == 0) {
      m_s[grp * M + m] = m_run[m];
      l_s[grp * M + m] = l_run[m];
    }
  }
  __syncthreads();
  if (threadIdx.x < M) {
    const int m = threadIdx.x;
    float gmax = kDead;
    for (int p = 0; p < groups; ++p) gmax = fmaxf(gmax, m_s[p * M + m]);
    float den = 0.f;
    for (int p = 0; p < groups; ++p) {
      const float w = expf(m_s[p * M + m] - gmax);
      m_s[p * M + m] = w;
      den += w * l_s[p * M + m];
    }
    den_s[m] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  float* ob = out + ((long long)b * G + g) * M * hd;
  for (int i = threadIdx.x; i < M * hd; i += kThreads) {
    const int m = i / hd;
    const int d = i - m * hd;
    float num = 0.f;
    for (int p = 0; p < groups; ++p)
      num = fmaf(m_s[p * M + m], acc_s[(p * M + m) * hd + d], num);
    ob[i] = num / den_s[m];
  }
}

template <int M>
int launch_m(const float* q, const int8_t* kq, const float* ks,
             const int8_t* vq, const float* vs, const float* valid,
             float* out, int B, int S, int G, int hd, Strides skq,
             Strides sks, Strides svq, Strides svs, long long val_b,
             long long val_s, float scale, cudaStream_t stream) {
  // 16 warps a CTA where the registers allow (M <= 4: 128 a thread), 8
  // where they do not; kUnroll = 4 slots in flight per group either way
  constexpr int kUnroll = 4;
  constexpr int kThreads = M <= 4 ? 512 : 256;
  auto kernel = decode_attention_kernel<M, kUnroll, kThreads>;
  const int groups = kThreads / lanes_per_slot(hd / kDims);
  const size_t smem =
      sizeof(float) * ((size_t)groups * M * hd + 2 * (size_t)groups * M + M);
  // the opt-in above 48 KB, raised once per instantiation and device to the
  // most any head dim needs (hd = 8), so no later launch, a captured one
  // included, sets it again
  static bool opted_in[64] = {};
  int device = 0;
  const cudaError_t de = cudaGetDevice(&device);
  if (de != cudaSuccess) return (int)de;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    const size_t most = sizeof(float) * ((size_t)kThreads * M * kDims +
                                         2 * (size_t)kThreads * M + M);
    if (most > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
      if (e != cudaSuccess) return (int)e;
    }
    opted_in[device] = true;
  }
  kernel<<<dim3(G, B), kThreads, smem, stream>>>(
      q, kq, ks, vq, vs, valid, out, S, G, hd, skq, sks, svq, svs, val_b,
      val_s, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attention_launch(const void* q, const void* kq, const void* ks,
                            const void* vq, const void* vs, const void* valid,
                            void* out, int B, int S, int G, int M, int hd,
                            int kq_sb, int kq_ss, int kq_sg, int ks_sb,
                            int ks_ss, int ks_sg, int vq_sb, int vq_ss,
                            int vq_sg, int vs_sb, int vs_ss, int vs_sg,
                            int val_sb, int val_ss, int scale_bits,
                            void* stream) {
  if (B <= 0 || G <= 0) return 0;
  // hd/8 lanes hold a slot's dims: 1 to 32 of them (hd 8, 16, ..., 256)
  const int tps = hd / kDims;
  if (S <= 0 || hd % kDims != 0 || tps < 1 || tps > 32)
    return (int)cudaErrorInvalidValue;
  float scale;
  memcpy(&scale, &scale_bits, sizeof(float));
  const Strides skq{kq_sb, kq_ss, kq_sg}, sks{ks_sb, ks_ss, ks_sg};
  const Strides svq{vq_sb, vq_ss, vq_sg}, svs{vs_sb, vs_ss, vs_sg};
  const cudaStream_t st = (cudaStream_t)stream;
#define DA_ARGS                                                              \
  (const float*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,  \
      (const float*)vs, (const float*)valid, (float*)out, B, S, G, hd, skq, \
      sks, svq, svs, (long long)val_sb, (long long)val_ss, scale, st
  switch (M) {
    case 1: return launch_m<1>(DA_ARGS);
    case 2: return launch_m<2>(DA_ARGS);
    case 3: return launch_m<3>(DA_ARGS);
    case 4: return launch_m<4>(DA_ARGS);
    case 5: return launch_m<5>(DA_ARGS);
    case 6: return launch_m<6>(DA_ARGS);
    case 7: return launch_m<7>(DA_ARGS);
    case 8: return launch_m<8>(DA_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DA_ARGS
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
