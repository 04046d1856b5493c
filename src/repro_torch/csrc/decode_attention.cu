// Int8-KV GQA decode attention (B8) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:32
// _decode_attn_kernel (pallas_call at :77). One decode step of a GQA layer
// over an int8 KV cache with per-(slot, head) f32 scales:
//
//   q (B, G, M, hd) f32            M = query heads per kv head (any M)
//   k_q, v_q (B, S, G, hd) int8    k_s, v_s (B, S, G, 1) f32
//   valid (B, S) f32               1.0 = live slot of the ring cache
//   out[b,g,m,:] = softmax_s(where(valid > .5, q.k_s * scale, -1e30)) @ v
//
// with k = k_q * k_s and v = v_q * v_s, never dequantized in memory. With
// every slot dead the output is the uniform mean of V over all S slots, as
// the dense softmax and the Pallas kernel give it.
//
// Bound: memory. One launch must read the int8 K/V once, the scales, the
// mask and q, and write out: at the served shape (B=8, S=32768, G=8, M=4,
// hd=128) 536.9 MB of int8, 16.8 MB of scales and 131 KB of mask (one (S,)
// row broadcast over B), 0.165 ms at 3.35 TB/s. The arithmetic sits close
// behind: 537 M int8 values to turn into f32 and 2.1 G multiply-adds.
//
// Design: split S across CTAs (flash-decoding), then combine.
//   - Grid (n_split, head groups, B x query groups). A CTA takes one chunk
//     of slots of one batch row and every kv head (all G of them where
//     G * lanes-per-head fits 256 threads; else the heads split over
//     blockIdx.y), for one group of at most 8 of the M query heads a kv
//     head serves: a thread keeps a q row and an accumulator of KD floats
//     per query head of its group, so the register budget is that of
//     M <= 8 whatever M is. M > 8 splits into ceil(M / 8) equal groups
//     (the last one short where 8 does not divide M: its missing heads
//     hold q = 0 and write nothing); each group's CTA reads the same K/V
//     rows, which its sibling has just brought into L2. A slot's
//     G x hd int8 row and its G scales lie contiguous in the cache, so the
//     CTA reads whole rows and whole scale sectors. The wrapper picks
//     n_split from B, G, S and the SM count so that the grid fills the card
//     (a chunk is a multiple of one sweep of the CTA's rows).
//   - A group of lanes owns one (slot, head): hd/KD lanes hold KD dims each
//     (KD = 16: one 16-byte load of K and of V; 8 where the cache's rows
//     are only 8-byte aligned, or a group of more than 4 query heads
//     leaves too few registers). The group is that count rounded up to
//     a power of two, so its shuffles stay inside a warp; lanes past
//     hd/KD hold zeros. The CTA's 256
//     threads make rows of (head, lane) groups; each row walks its own
//     slots of the chunk.
//   - Loads in flight: each thread copies the bytes it will read itself
//     (K, V, the two scales, the mask) into a ring of shared memory with
//     cp.async, kStages stages of kSlots slots ahead, so memory latency
//     hides behind the arithmetic without spending registers. A thread
//     reads only what it copied, so the ring needs no barrier; a copy for
//     a slot past the chunk (or a lane without dims) is zero-filled, so no
//     copy and no read needs a branch.
//   - Arithmetic, which bounds this kernel once it is not latency-bound
//     (M = 4, KD = 16 holds 128 registers of q and acc: one CTA of 8 warps
//     per SM): int8 to f32 by a byte permute into the mantissa of 2^23 and
//     one subtraction (exact, no I2F); the scale leaves the dot,
//     q.(k_q k_s) = k_s (q.k_q), and v_s folds into the softmax weight, so
//     no element is multiplied by its scale; scores in log2 units (the
//     scale carries log2(e)) so an exponential is one ex2; each shuffle
//     round of the group's dot sums takes every (slot, row) of the stage
//     at once; the running max is rescaled only when it grows (alpha = 1
//     otherwise, exactly).
//   - The CTA merges its rows' (m, l, acc) in shared memory and writes the
//     chunk's partial (m, l, acc[hd]) per (b, g, m) to scratch; a second
//     kernel, one block per (b, g, m) row, merges the chunks (their weights
//     once in shared memory). A chunk whose slots are all dead carries
//     m = -1e30 and weighs exp(-1e30 - m_live) = 0 beside a live one; with
//     every slot dead all chunks weigh 1 and the merge gives the uniform
//     mean. The output divides by max(l, 1e-30). With one chunk the first
//     kernel writes the normalised output and the combine is skipped.
// A slot past its chunk scores -inf and adds nothing; a dead slot scores
// -1e30, so it weighs 1 only while no live slot has been seen, as in the
// reference. Sums run in another order than the dense softmax, so the
// kernel agrees with its plain version to rtol 2e-4 / atol 2e-5.
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers
// (the output and the scratch of partials).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;          // ring depth, in stages
constexpr int kSlots = 4;           // slots a thread takes per stage
constexpr float kDead = -1e30f;     // the reference's masked score
constexpr float kMagic = 8388736.f; // 2^23 + 128

struct Strides {
  long long b, s, g;   // element strides; the head dim is contiguous
};

struct Geom {
  int tps;      // lanes of a (slot, head) group that hold dims: hd / KD
  int lps;      // lanes of the group: tps rounded up to a power of two
  int hpc;      // heads a CTA takes
  int hgroups;  // CTAs along the heads: ceil(G / hpc)
  int rows;     // (slot, head) rows of the CTA: kThreads / (hpc * lps)
};

__host__ __device__ __forceinline__ Geom geom(int G, int hd, int kd) {
  Geom r;
  r.tps = hd / kd;
  r.lps = 1;
  while (r.lps < r.tps) r.lps <<= 1;
  r.hpc = G < kThreads / r.lps ? G : kThreads / r.lps;
  r.hgroups = (G + r.hpc - 1) / r.hpc;
  r.rows = kThreads / (r.hpc * r.lps);
  return r;
}

template <int KD> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// BYTES from src to the shared address dst; with `ok` false nothing is
// read and dst is zero-filled (src must still be a valid address)
template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         bool ok) {
  const int n = ok ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr float kLog2e = 1.44269504088896341f;

// 2^x by the special-function unit: the scores are kept in log2 units
// (the score scale carries log2(e)), so an exponential is one instruction
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// four int8 codes to exact f32: each byte (offset by 128) goes into the
// mantissa of 2^23, one subtraction takes the offset back out
__device__ __forceinline__ void unpack4(unsigned w, float* f) {
  const unsigned x = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - kMagic;
  f[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - kMagic;
  f[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - kMagic;
  f[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - kMagic;
}

__device__ __forceinline__ void unpack(uint4 w, float* f) {
  unpack4(w.x, f);
  unpack4(w.y, f + 4);
  unpack4(w.z, f + 8);
  unpack4(w.w, f + 12);
}

__device__ __forceinline__ void unpack(uint2 w, float* f) {
  unpack4(w.x, f);
  unpack4(w.y, f + 4);
}

struct Args {
  const float* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const float* valid;
  float* out;       // (B, G, Mt, hd), written when n_split == 1
  float* part_acc;  // (B, n_split, G, Mt, hd)
  float* part_ml;   // (B, n_split, G, Mt, 2): the chunk's max and sum
  int S, G, hd, chunk, n_split;
  int Mt, mgroups;  // query heads per kv head, and the groups of M they
                    // split into (blockIdx.z = b * mgroups + group)
  Strides skq, sks, svq, svs;
  long long val_b, val_s;
  float scale;
};

template <int M, int KD>
__global__ void __launch_bounds__(kThreads, 1)
decode_attention_split(Args a) {
  using V = typename Vec<KD>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRing = kStages * kSlots * kThreads;
  V* kbuf = reinterpret_cast<V*>(smem);
  V* vbuf = kbuf + kRing;
  float* ksb = reinterpret_cast<float*>(vbuf + kRing);
  float* vsb = ksb + kRing;
  float* vab = vsb + kRing;

  const Geom gm = geom(a.G, a.hd, KD);
  const int c = blockIdx.x;
  const int b = blockIdx.z / a.mgroups;
  const int m0 = (blockIdx.z - b * a.mgroups) * M;   // the group's first head
  const int mn = min(M, a.Mt - m0);                  // its heads that exist
  const int t = threadIdx.x;
  const int unit = t % (gm.hpc * gm.lps);
  const int row = t / (gm.hpc * gm.lps);
  const int hl = unit / gm.lps;
  const int lane = unit % gm.lps;
  const int g = blockIdx.y * gm.hpc + hl;
  // a thread of a row past `rows` or a head past G loads nothing; every
  // thread still runs the loop, so each shuffle sees the whole warp
  const bool on = row < gm.rows && g < a.G;
  const bool holds = on && lane < gm.tps;
  const int d0 = (lane < gm.tps ? lane : 0) * KD;
  const int c0 = c * a.chunk;
  const int c1 = min(a.S, c0 + a.chunk);
  const int step = gm.rows * kSlots;
  const float scale2 = a.scale * kLog2e;
  const int iters = (c1 - c0 + step - 1) / step;

  float qr[M][KD];
  {
    const float* qb = a.q + (((long long)b * a.G + (holds ? g : 0)) * a.Mt
                             + m0) * a.hd + d0;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < KD; ++j)
        qr[m][j] = holds && m < mn ? qb[m * a.hd + j] : 0.f;
  }
  float m_run[M], l_run[M], acc[M][KD];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    m_run[m] = kDead;
    l_run[m] = 0.f;
#pragma unroll
    for (int j = 0; j < KD; ++j) acc[m][j] = 0.f;
  }

  // the thread's copy sources at its first slot of the chunk, each moved
  // on by one sweep of the CTA (`step` slots) per stage; a slot u of a
  // stage lies u * rows slots further
  const int gg = on ? g : 0;
  const long long s0 = c0 + row;
  const int8_t* kp = a.kq + b * a.skq.b + gg * a.skq.g + d0 + s0 * a.skq.s;
  const int8_t* vp = a.vq + b * a.svq.b + gg * a.svq.g + d0 + s0 * a.svq.s;
  const float* ksp = a.ks + b * a.sks.b + gg * a.sks.g + s0 * a.sks.s;
  const float* vsp = a.vs + b * a.svs.b + gg * a.svs.g + s0 * a.svs.s;
  const float* vap = a.valid + b * a.val_b + s0 * a.val_s;
  const long long rk = gm.rows * a.skq.s, rv = gm.rows * a.svq.s;
  const long long rks = gm.rows * a.sks.s, rvs = gm.rows * a.svs.s;
  const long long rva = gm.rows * a.val_s;
  // the ring, by the thread's own word: stage st, slot u at
  // [(st * kSlots + u) * kThreads + t]
  const unsigned k_sm = smem_addr(kbuf + t), v_sm = smem_addr(vbuf + t);
  const unsigned ks_sm = smem_addr(ksb + t), vs_sm = smem_addr(vsb + t);
  const unsigned va_sm = smem_addr(vab + t);
  int s_issue = c0 + row;

  // stage `it` of the ring: the thread's own slots of that iteration, every
  // copy issued (zero-filled where the slot lies past the chunk or the lane
  // holds nothing), so the copies need no branch
  auto issue = [&](int it) {
    if (it < iters) {
      const unsigned st = (unsigned)(it % kStages) * kSlots * kThreads;
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const bool ok = on && s_issue + u * gm.rows < c1;
        const unsigned o = st + u * kThreads;
        cp_async<sizeof(V)>(k_sm + o * sizeof(V), kp + u * rk, ok && holds);
        cp_async<sizeof(V)>(v_sm + o * sizeof(V), vp + u * rv, ok && holds);
        cp_async<4>(ks_sm + o * 4, ksp + u * rks, ok);
        cp_async<4>(vs_sm + o * 4, vsp + u * rvs, ok);
        cp_async<4>(va_sm + o * 4, vap + u * rva, ok);
      }
      s_issue += step;
      kp += kSlots * rk;
      vp += kSlots * rv;
      ksp += kSlots * rks;
      vsp += kSlots * rvs;
      vap += kSlots * rva;
    }
    cp_async_commit();
  };

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);

  for (int it = 0; it < iters; ++it) {
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();
    const int st = it % kStages;
    const int s_it = c0 + it * step + row;
    // a ring word of a slot past the chunk is zero-filled: finite codes,
    // scales and mask, so every lane reads its words unconditionally; a
    // lane without dims has q = 0
    float dot[kSlots][M], kscale[kSlots], live[kSlots], vsc[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int i = (st * kSlots + u) * kThreads + t;
      const bool in = on && s_it + u * gm.rows < c1;
      float k[KD];
      unpack(kbuf[i], k);
      // -1: past the chunk (adds nothing), 0: dead, 1: live
      live[u] = in ? (vab[i] > 0.5f ? 1.f : 0.f) : -1.f;
      kscale[u] = ksb[i] * scale2;
      vsc[u] = vsb[i];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < KD; ++j) d = fmaf(qr[m][j], k[j], d);
        dot[u][m] = d;
      }
    }
    // the group's sums: one uniform branch per round, every (slot, row)
    // of the round inside it, so the shuffles overlap
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < gm.lps) {
#pragma unroll
        for (int u = 0; u < kSlots; ++u)
#pragma unroll
          for (int m = 0; m < M; ++m)
            dot[u][m] += __shfl_xor_sync(0xffffffffu, dot[u][m], off);
      }
    }
    // scores in log2 units (the scale carries log2(e)): a live slot
    // q.k_q * k_s * scale, a dead one -1e30, one past the chunk -inf
    float sc[kSlots][M];
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
#pragma unroll
      for (int m = 0; m < M; ++m)
        sc[u][m] = live[u] > 0.f ? dot[u][m] * kscale[u]
                                 : (live[u] == 0.f ? kDead : -INFINITY);
    // online softmax: rescale only when a running max grows (alpha is
    // exp(0) = 1 for a row whose max stays)
    float mx[M];
    bool grow = false;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mx[m] = m_run[m];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) mx[m] = fmaxf(mx[m], sc[u][m]);
      grow |= mx[m] > m_run[m];
    }
    if (grow) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float alpha = ex2(m_run[m] - mx[m]);
        l_run[m] *= alpha;
#pragma unroll
        for (int j = 0; j < KD; ++j) acc[m][j] *= alpha;
        m_run[m] = mx[m];
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int i = (st * kSlots + u) * kThreads + t;
      float v[KD];
      unpack(vbuf[i], v);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float p = ex2(sc[u][m] - m_run[m]);
        l_run[m] += p;
        const float pv = p * vsc[u];
#pragma unroll
        for (int j = 0; j < KD; ++j) acc[m][j] = fmaf(pv, v[j], acc[m][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the rows in shared memory (the ring's space): ml_s [rows][hpc][M]
  // (m, l) pairs, gd_s [hpc][M] (max, sum) pairs, red [rows][hpc * hd]
  float* ml_s = reinterpret_cast<float*>(smem);
  float* gd_s = ml_s + gm.rows * gm.hpc * M * 2;
  float* red = gd_s + gm.hpc * M * 2;
  const int heads = min(gm.hpc, a.G - (int)blockIdx.y * gm.hpc);
  const bool final_out = a.n_split == 1;
  if (row < gm.rows && lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      ml_s[((row * gm.hpc + hl) * M + m) * 2] = m_run[m];
      ml_s[((row * gm.hpc + hl) * M + m) * 2 + 1] = l_run[m];
    }
  }
  __syncthreads();
  for (int idx = t; idx < heads * M; idx += kThreads) {
    const int h = idx / M, m = idx - h * M;
    float gmax = -INFINITY;
    for (int r = 0; r < gm.rows; ++r)
      gmax = fmaxf(gmax, ml_s[((r * gm.hpc + h) * M + m) * 2]);
    float den = 0.f;
    for (int r = 0; r < gm.rows; ++r)
      den += exp2f(ml_s[((r * gm.hpc + h) * M + m) * 2] - gmax)
             * ml_s[((r * gm.hpc + h) * M + m) * 2 + 1];
    gd_s[idx * 2] = gmax;
    gd_s[idx * 2 + 1] = den;
    if (!final_out && m < mn) {
      const long long o = (((long long)b * a.n_split + c) * a.G
                           + blockIdx.y * gm.hpc + h) * a.Mt + m0 + m;
      a.part_ml[o * 2] = gmax;
      a.part_ml[o * 2 + 1] = den;
    }
  }
  __syncthreads();
  const int width = gm.hpc * a.hd;
  // unrolled: acc and m_run are indexed by m, and stay in registers only
  // under constant indices
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (holds) {
      const float w = exp2f(m_run[m] - gd_s[(hl * M + m) * 2]);
#pragma unroll
      for (int j = 0; j < KD; ++j)
        red[row * width + hl * a.hd + d0 + j] = w * acc[m][j];
    }
    __syncthreads();
    for (int i = t; i < (m < mn ? heads * a.hd : 0); i += kThreads) {
      const int h = i / a.hd, d = i - h * a.hd;
      float sum = 0.f;
      for (int r = 0; r < gm.rows; ++r) sum += red[r * width + i];
      const long long o = ((((long long)b * (final_out ? 1 : a.n_split)
                             + (final_out ? 0 : c)) * a.G
                            + blockIdx.y * gm.hpc + h) * a.Mt + m0 + m)
                          * a.hd + d;
      if (final_out)
        a.out[o] = sum / fmaxf(gd_s[(h * M + m) * 2 + 1], 1e-30f);
      else
        a.part_acc[o] = sum;
    }
    __syncthreads();
  }
}

// merge the chunks' (m, l, acc) of each (b, g, m) row: one block per row;
// the chunks' weights exp2(m_c - max m) and the sum of w_c l_c once in
// shared memory, then a thread per output dim sums its chunks with eight
// loads in flight
constexpr int kCombineThreads = 128;

__global__ void __launch_bounds__(kCombineThreads)
decode_attention_combine(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         float* __restrict__ out, int n_split, int G, int M,
                         int hd) {
  extern __shared__ float w_s[];            // [n_split] weights, then den
  const int r = blockIdx.x;                 // (b * G + g) * M + m
  const long long gm_rows = (long long)G * M;
  const long long b = r / gm_rows, gmi = r - b * gm_rows;
  const float* ml = part_ml + (b * n_split * gm_rows + gmi) * 2;
  const long long ml_step = gm_rows * 2;
  for (int c = threadIdx.x; c < n_split; c += blockDim.x)
    w_s[c] = ml[c * ml_step];
  __syncthreads();
  float gmax = -INFINITY;
  for (int c = 0; c < n_split; ++c) gmax = fmaxf(gmax, w_s[c]);
  __syncthreads();
  for (int c = threadIdx.x; c < n_split; c += blockDim.x)
    w_s[c] = exp2f(w_s[c] - gmax);
  __syncthreads();
  if (threadIdx.x == 0) {
    float den = 0.f;
    for (int c = 0; c < n_split; ++c) den += w_s[c] * ml[c * ml_step + 1];
    w_s[n_split] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const long long acc_step = gm_rows * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    const float* ac = part_acc + (b * n_split * gm_rows + gmi) * hd + d;
    float num[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int c = 0;
    for (; c + 8 <= n_split; c += 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        num[k] = fmaf(w_s[c + k], ac[(c + k) * acc_step], num[k]);
    }
    for (; c < n_split; ++c) num[0] = fmaf(w_s[c], ac[c * acc_step], num[0]);
    const float sum = ((num[0] + num[1]) + (num[2] + num[3])) +
                      ((num[4] + num[5]) + (num[6] + num[7]));
    out[(long long)r * hd + d] = sum / w_s[n_split];
  }
}

template <int M, int KD>
int launch_mk(const Args& a, int B, cudaStream_t stream) {
  using V = typename Vec<KD>::T;
  auto kernel = decode_attention_split<M, KD>;
  const Geom gm = geom(a.G, a.hd, KD);
  const size_t ring = (size_t)kStages * kSlots * kThreads *
                      (2 * sizeof(V) + 3 * sizeof(float));
  // the merge reuses the ring; it needs at most 48 KB (rows * hpc * lps
  // <= 256 threads bounds each of its three arrays by 16 KB)
  const size_t merge = sizeof(float) *
      ((size_t)gm.rows * gm.hpc * M * 2 + (size_t)gm.hpc * M * 2 +
       (size_t)gm.rows * gm.hpc * a.hd);
  const size_t smem = ring > merge ? ring : merge;
  const size_t most = ring > 48 * 1024 ? ring : 48 * 1024;
  // the opt-in above 48 KB, set once per instantiation and device to the
  // most any shape needs, so no later launch, a captured one included,
  // sets it again
  static bool opted_in[64] = {};
  int device = 0;
  const cudaError_t de = cudaGetDevice(&device);
  if (de != cudaSuccess) return (int)de;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    if (most > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
      if (e != cudaSuccess) return (int)e;
    }
    opted_in[device] = true;
  }
  kernel<<<dim3(a.n_split, gm.hgroups, B * a.mgroups), kThreads, smem,
           stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  decode_attention_combine<<<(unsigned)(B * a.G * a.Mt), kCombineThreads,
                             sizeof(float) * (a.n_split + 1), stream>>>(
      a.part_acc, a.part_ml, a.out, a.n_split, a.G, a.Mt, a.hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// M: query heads per kv head; m_group: heads a CTA takes (1 to 8; M splits
// into ceil(M / m_group) groups); kd: dims per lane (16: 16-byte loads,
// m_group <= 4; 8: 8-byte loads); chunk: slots per CTA; n_split: chunks per
// batch row (ceil(S / chunk)); part: scratch of B * n_split * G * M *
// (hd + 2) f32 (unused when n_split == 1)
int decode_attention_launch(const void* q, const void* kq, const void* ks,
                            const void* vq, const void* vs, const void* valid,
                            void* out, void* part, int B, int S, int G, int M,
                            int m_group, int hd, int kq_sb, int kq_ss, int kq_sg,
                            int ks_sb, int ks_ss, int ks_sg, int vq_sb,
                            int vq_ss, int vq_sg, int vs_sb, int vs_ss,
                            int vs_sg, int val_sb, int val_ss, int scale_bits,
                            int kd, int chunk, int n_split, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  if (M < 1 || m_group < 1 || m_group > 8 || (kd == 16 && m_group > 4))
    return (int)cudaErrorInvalidValue;
  const int mgroups = (M + m_group - 1) / m_group;
  if ((long long)B * mgroups > 65535) return (int)cudaErrorInvalidValue;
  if (S <= 0 || (kd != 8 && kd != 16) || hd % kd != 0 || hd / kd < 1 ||
      hd / kd > 32 || chunk < 1 || n_split < 1 || n_split > 8192 ||
      (long long)(n_split - 1) * chunk >= S ||
      (long long)n_split * chunk < S || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const float*)q;
  a.kq = (const int8_t*)kq;
  a.ks = (const float*)ks;
  a.vq = (const int8_t*)vq;
  a.vs = (const float*)vs;
  a.valid = (const float*)valid;
  a.out = (float*)out;
  const long long n_acc = (long long)B * n_split * G * M * hd;
  a.part_acc = (float*)part;
  a.part_ml = part == nullptr ? nullptr : (float*)part + n_acc;
  a.S = S;
  a.G = G;
  a.hd = hd;
  a.chunk = chunk;
  a.n_split = n_split;
  a.Mt = M;
  a.mgroups = mgroups;
  a.skq = Strides{kq_sb, kq_ss, kq_sg};
  a.sks = Strides{ks_sb, ks_ss, ks_sg};
  a.svq = Strides{vq_sb, vq_ss, vq_sg};
  a.svs = Strides{vs_sb, vs_ss, vs_sg};
  a.val_b = val_sb;
  a.val_s = val_ss;
  memcpy(&a.scale, &scale_bits, sizeof(float));
  const cudaStream_t st = (cudaStream_t)stream;
  if (kd == 16) {
    switch (m_group) {
      case 1: return launch_mk<1, 16>(a, B, st);
      case 2: return launch_mk<2, 16>(a, B, st);
      case 3: return launch_mk<3, 16>(a, B, st);
      case 4: return launch_mk<4, 16>(a, B, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (m_group) {
    case 1: return launch_mk<1, 8>(a, B, st);
    case 2: return launch_mk<2, 8>(a, B, st);
    case 3: return launch_mk<3, 8>(a, B, st);
    case 4: return launch_mk<4, 8>(a, B, st);
    case 5: return launch_mk<5, 8>(a, B, st);
    case 6: return launch_mk<6, 8>(a, B, st);
    case 7: return launch_mk<7, 8>(a, B, st);
    case 8: return launch_mk<8, 8>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
