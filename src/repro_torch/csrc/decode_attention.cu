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
// row broadcast over B), 0.165 ms at 3.35 TB/s. The products (2.1 G
// multiply-adds) run on the tensor cores, so what remains on the CUDA
// cores is turning 537 M int8 codes into 16-bit operands.
//
// Design: split S across CTAs (flash-decoding), then combine.
//   - Grid (n_split, ceil(G / hpc), B x query groups). A CTA takes one
//     chunk of slots of one batch row, hpc kv heads (the largest power of
//     two up to 8 and G: their rows of a slot lie side by side in the
//     cache) and a group of at most 8 of the M query heads a kv head serves
//     (M > 8 splits into ceil(M / 8) equal groups; each group's CTA re-reads
//     the K/V rows its sibling has just brought into L2). Its 8 warps: one
//     kv head each, a head's 8 / hpc warps on side-by-side 16-slot tiles,
//     each warp with its own online-softmax state. The wrapper's
//     launch_plan sizes the chunk from B, G, M, S and the SM count: one CTA
//     an SM (its shared memory), a wave of them where S allows.
//   - The products are mma.sync m16n8k16 (f16 operands, f32 sums). An int8
//     code is exact in f16. q and the softmax weights p * v_s are f32: each
//     is split into two f16 terms, hi = f16(x) and lo = f16(x - hi), after
//     an exact power-of-two scale (q: per query head, to a max in [2^14,
//     2^15); the weights: per warp, from a running bound on v_s, widened
//     with the accumulator rescaled by a power of two), so the two terms
//     carry 22 bits of each operand. The terms take the MMA tile's rows
//     that the query heads leave empty: rows 0-7 hold the heads' hi terms
//     and rows 8-15 their lo terms, a thread holds rows g and g + 8 of
//     each fragment, and sums its two terms itself, so the split costs no
//     extra instruction and no shuffle. q.k: A = q's terms (rows x dims),
//     B = K's codes (dims x slots); p.v: A = the weights' terms (rows x
//     slots), taken straight from q.k's accumulator layout, B = V's codes
//     (slots x dims). k_s stays outside the dot, v_s is folded into the
//     weight.
//   - Codes to f16 two at a time: a byte permute puts two codes (their sign
//     bit flipped) under an f16 exponent of 1024, one packed subtract of
//     1152 leaves them exact; V's two codes come from two slots' words (a
//     permute, a mask-and-xor, a subtract).
//   - Loads: each warp copies its next tiles (K and V rows, 16-byte cp.async
//     where the rows are 16-byte aligned, 8-byte otherwise, zero-filled
//     past the chunk; the scales and the mask 4 bytes a slot) into its own
//     ring of shared memory, stages ahead, so no block barrier stands in
//     the loop; a lane's pieces of a tile sit a fixed number of slots
//     apart, so their addresses move by a constant. The rows are padded to
//     an odd number of 16-byte units, so the fragment reads hit 32
//     distinct banks. (Bulk copies of a row each, on mbarriers, and a CTA
//     copying each stage together behind a block barrier, both measured
//     slower on an H100.)
//   - q's fragments: a kv head's first warp loads its query heads' rows
//     once (a lane 4 of each step's dims), takes each row's max over the
//     row's 4 lanes, and writes the split terms to shared memory.
//   - The online softmax keeps the scores in log2 units (the scale carries
//     log2(e)), a row's max over a tile by two shuffles, and rescales the
//     accumulator only when a max grows or the v_s bound widens.
//   - The CTA merges its warps' (m, l, acc) in shared memory and writes the
//     chunk's partial (m, l, acc[hd]) per (b, g, m) to scratch; a second
//     kernel, one block per (b, g, m) row, merges the chunks. A chunk whose
//     slots are all dead carries m = -1e30 and weighs exp(-1e30 - m_live) =
//     0 beside a live one; with every slot dead all chunks weigh 1 and the
//     merge gives the uniform mean. The output divides by max(l, 1e-30).
//     With one chunk the first kernel writes the normalised output and the
//     combine is skipped.
// A slot past its chunk scores -inf and adds nothing; a dead slot scores
// -1e30, so it weighs 1 only while no live slot has been seen, as in the
// reference. Sums run in another order than the dense softmax, and the two
// f16 terms keep 22 bits of q and of the weights, so the kernel agrees with
// its plain version to rtol 2e-4 / atol 2e-5 (one term would not).
//
// Plain C interface (bound with ctypes): the launcher returns
// cudaGetLastError() and allocates nothing; the caller owns all buffers
// (the output and the scratch of partials).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;               // warps of a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;               // slots a warp takes per step
constexpr int kRows = 8;                // query heads a kv head's CTA takes
constexpr int kCtaSmem = 230400;        // dynamic shared memory: one CTA an
                                        // SM, 2 KB of the 227 left static
constexpr float kDead = -1e30f;         // the reference's masked score
constexpr float kLog2e = 1.44269504088896341f;
constexpr unsigned kExp1024 = 0x64646464u;  // f16 exponent bytes of 1024
constexpr unsigned kBias = 0x64806480u;     // (1152, 1152) in f16
constexpr int kCapLo = -100, kCapHi = 110;  // the v_s bound's exponents

// A warp's ring, by NV = ceil(hd / 32) (kernels/decode_attention.py
// ring_geometry mirrors it): a slot row of 32 NV bytes (hd zero-padded) at
// a stride of 32 NV + 16 (odd in 16-byte units); a stage holds the K and V
// rows of 16 slots, then their k_s, v_s and mask; as many stages (at most
// 4) as the CTA's budget holds beside q's fragments (a kv head's each).
template <int NV>
struct Ring {
  static constexpr int kRowBytes = 32 * NV;
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kStageBytes = 2 * kTile * kStride + 3 * kTile * 4;
  static constexpr int kFragBytes = kWarps * 2 * NV * 32 * 16;
  static constexpr int kStages =
      (kCtaSmem - kFragBytes) / (kWarps * kStageBytes) < 4
          ? (kCtaSmem - kFragBytes) / (kWarps * kStageBytes)
          : 4;
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static constexpr int kSmem = kRingBytes + kFragBytes;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kWarps * kRows * (kRowBytes + 2) * 4 <= kRingBytes,
                "the merge reuses the ring");
};

struct Strides {
  long long b, s, g;   // element strides; the head dim is contiguous
};

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

// 2^x by the special-function unit: the scores are kept in log2 units
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float pow2(int e) {   // e in [-126, 127]
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ unsigned hsub2(unsigned a, unsigned b) {
  unsigned r;
  asm("sub.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// the four int8 codes of a word, exact in f16: (c0, c1) and (c2, c3)
__device__ __forceinline__ void codes4(unsigned w, unsigned& lo,
                                       unsigned& hi) {
  const unsigned x = w ^ 0x80808080u;
  lo = hsub2(__byte_perm(x, kExp1024, 0x4140), kBias);
  hi = hsub2(__byte_perm(x, kExp1024, 0x4342), kBias);
}

// byte D of two slots' words, exact in f16: (a.D, b.D)
template <int D>
__device__ __forceinline__ unsigned codes_across(unsigned a, unsigned b) {
  const unsigned r = __byte_perm(a, b, D | ((4 + D) << 8));
  return hsub2((r & 0x00ff00ffu) ^ kBias, kBias);
}

// d += A (16 x 16, rows x k) * B (16 x 8, k x cols): f16 in, f32 sums
__device__ __forceinline__ void mma(float* d, const uint4& a, unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// x as hi + lo, two f16 terms each, packed for two values: (hi0, hi1) and
// (lo0, lo1)
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const __half2 l = __floats2half2_rn(x0 - __low2float(h),
                                      x1 - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// floor(log2(x)) + 1 for a finite x > 0 from its exponent bits (a
// subnormal x gives -126, still a bound), clamped to [kCapLo, kCapHi]
__device__ __forceinline__ int cap_of(float x) {
  const int e = (int)((__float_as_uint(x) >> 23) & 0xff) - 126;
  return min(max(e, kCapLo), kCapHi);
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
  int Mt, mg, mgroups;  // query heads per kv head, heads a CTA takes, and
                        // the groups (blockIdx.z = b * mgroups + group)
  int hpc;              // kv heads a CTA takes (1, 2, 4 or 8; blockIdx.y
                        // counts groups of them), kWarps / hpc warps each
  int vec;              // bytes a row copy moves: 16 or 8
  Strides skq, sks, svq, svs;
  long long val_b, val_s;
  float scale;
};

template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
decode_attention_mma(Args a) {
  using R = Ring<NV>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rowsc[kWarps][kRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, t4 = lane & 3;
  // the warp's kv head (hl of the CTA's hpc) and its phase: the warps of
  // one head take the chunk's 16-slot tiles in turn
  const int hpc = a.hpc, phases = kWarps / hpc;
  const int hl = warp % hpc, phase = warp / hpc;
  const int c = blockIdx.x, g0 = blockIdx.y * hpc, g = g0 + hl;
  const bool active = g < a.G;
  const int b = blockIdx.z / a.mgroups;
  const int m0 = (blockIdx.z - b * a.mgroups) * a.mg;  // the group's first
  const int mn = min(a.mg, a.Mt - m0);                  // its heads
  const int c0 = c * a.chunk, c1 = min(a.S, c0 + a.chunk);
  const int nk = (a.hd + 15) / 16;                      // q.k steps
  const int ntiles = (c1 - c0 + kTile - 1) / kTile;
  const int my_tiles = active && ntiles > phase
                           ? (ntiles - phase + phases - 1) / phases : 0;
  unsigned char* ring = smem + warp * R::kStages * R::kStageBytes;
  uint4* qf_all = reinterpret_cast<uint4*>(smem + R::kRingBytes);
  const uint4* qf = qf_all + hl * (nk * 32);

  // the zero pad of every ring row past hd, written once: no copy touches it
  {
    const int pad = R::kRowBytes - a.hd;   // a multiple of 8
    for (int i = lane; i < R::kStages * 2 * kTile * (pad / 8); i += 32) {
      const int row = i / (pad / 8), k = i - row * (pad / 8);
      const int st = row / (2 * kTile), r = row - st * 2 * kTile;
      *reinterpret_cast<uint2*>(ring + st * R::kStageBytes + r * R::kStride +
                                a.hd + 8 * k) = make_uint2(0u, 0u);
    }
  }
  // a tile's row copies: 16 * cpr pieces of `vec` bytes, piece i at slot
  // i / cpr; where cpr divides 32 a lane's pieces sit 32 / cpr slots apart
  // in one column, so its addresses move by a constant, else each piece's
  // slot comes from a multiply-shift (exact for i < 512); zero-filled past
  // the chunk
  const int vec = a.vec;
  const int cpr = a.hd / vec;
  const bool even = 32 % cpr == 0;
  const int lane_slot = even ? lane / cpr : 0;
  const int lane_col = even ? (lane % cpr) * vec : 0;
  const int slot_step = even ? 32 / cpr : 0;
  const int pieces = (kTile * cpr + 31) / 32;   // a lane's, when even
  const unsigned inv = (1u << 20) / (unsigned)cpr + 1u;
  const bool v16 = vec == 16;
  const int ga = active ? g : 0;
  const int8_t* kb = a.kq + b * a.skq.b + ga * a.skq.g;
  const int8_t* vb = a.vq + b * a.svq.b + ga * a.svq.g;
  const float* ksb = a.ks + b * a.sks.b + ga * a.sks.g;
  const float* vsb = a.vs + b * a.svs.b + ga * a.svs.g;
  const float* vab = a.valid + b * a.val_b;
  const long long k_ss = a.skq.s, v_ss = a.svq.s;
  const long long ks_ss = a.sks.s, vs_ss = a.svs.s, va_ss = a.val_s;

  auto piece = [&](unsigned kd, unsigned vd, const int8_t* k_src,
                   const int8_t* v_src, bool ok) {
    if (v16) {
      cp_async<16>(kd, k_src, ok);
      cp_async<16>(vd, v_src, ok);
    } else {
      cp_async<8>(kd, k_src, ok);
      cp_async<8>(vd, v_src, ok);
    }
  };
  // stage `it` of the ring: the warp's it-th tile, one commit group
  auto issue = [&](int it) {
    if (it < my_tiles) {
      const int s0 = c0 + kTile * (phase + phases * it);
      const int rows = min(kTile, c1 - s0);
      unsigned char* stp = ring + (it % R::kStages) * R::kStageBytes;
      const unsigned kst = smem_addr(stp);
      const unsigned vst = kst + kTile * R::kStride;
      const unsigned sst = vst + kTile * R::kStride;
      if (even) {
        const int8_t* kp = kb + (s0 + lane_slot) * k_ss + lane_col;
        const int8_t* vp = vb + (s0 + lane_slot) * v_ss + lane_col;
        const long long kstep = slot_step * k_ss, vstep = slot_step * v_ss;
        unsigned d = lane_slot * R::kStride + lane_col;
        const unsigned dstep = slot_step * R::kStride;
        for (int k = 0; k < pieces; ++k) {
          // cpr == 1: 16 pieces a tile, lanes 16-31 have none
          if (lane_slot + k * slot_step >= kTile) break;
          const bool ok = lane_slot + k * slot_step < rows;
          piece(kst + d, vst + d, ok ? kp : kb, ok ? vp : vb, ok);
          kp += kstep;
          vp += vstep;
          d += dstep;
        }
      } else {
        for (int i = lane; i < kTile * cpr; i += 32) {
          const int slot = (int)(((unsigned)i * inv) >> 20);
          const int col = (i - slot * cpr) * vec;
          const bool ok = slot < rows;
          const long long s = ok ? s0 + slot : 0;
          const unsigned d = slot * R::kStride + col;
          piece(kst + d, vst + d, kb + s * k_ss + col, vb + s * v_ss + col,
                ok);
        }
      }
      const int slot = lane & (kTile - 1);
      const bool ok = slot < rows;
      const long long s = ok ? s0 + slot : 0;
      if (lane < kTile) {
        cp_async<4>(sst + 4 * slot, ksb + s * ks_ss, ok);
        cp_async<4>(sst + 4 * (2 * kTile + slot), vab + s * va_ss, ok);
      } else {
        cp_async<4>(sst + 4 * (kTile + slot), vsb + s * vs_ss, ok);
      }
    }
    cp_async_commit();
  };
  // TPI tiles an iteration (2 where the registers allow: their chains of
  // MMAs and their softmax steps interleave); the ring keeps the next
  // kStages - TPI tiles in flight
  constexpr int TPI = NV <= 4 ? 2 : 1;
  static_assert(R::kStages > TPI, "the ring runs ahead of an iteration");
#pragma unroll
  for (int it = 0; it < R::kStages - TPI; ++it) issue(it);

  // q's A fragments, a kv head's by its first warp: lane (gid, t4) loads
  // query head gid's dims 16 i + 4 t4 .. + 3 of every step i at once, the
  // row's max |q| over the 4 lanes of the row, its scale 2^e (max |q| 2^e
  // in [2^14, 2^15); 0 for a zero or non-finite row), two f16 terms a
  // value; the score scale 2^-e * scale * log2(e) a row
  const float* qb = a.q + (((long long)b * a.G + ga) * a.Mt + m0) * a.hd;
  if (phase == 0) {
    const bool real = active && gid < mn;
    const float* qr = qb + (real ? gid : 0) * a.hd;
    float x[2 * NV][4];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * NV; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = 16 * i + 4 * t4 + k;
        x[i][k] = real && d < a.hd ? qr[d] : 0.f;
        amax = fmaxf(amax, fabsf(x[i][k]));
      }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    int e = 0;
    if (amax > 0.f && amax <= 3.402823466e38f) {
      const int fl = (int)((__float_as_uint(amax) >> 23) & 0xff) - 127;
      e = min(max(14 - fl, -126), 126);
    }
    if (t4 == 0) rowsc[hl][gid] = real ? pow2(-e) * a.scale * kLog2e : 0.f;
    const float up = pow2(e);
#pragma unroll
    for (int i = 0; i < 2 * NV; ++i) {
      if (i < nk) {
        uint4 f;
        split2(x[i][0] * up, x[i][1] * up, f.x, f.y);
        split2(x[i][2] * up, x[i][3] * up, f.z, f.w);
        qf_all[(hl * nk + i) * 32 + lane] = f;
      }
    }
  }
  __syncthreads();

  const float rs = rowsc[hl][gid];
  float acc[4 * NV][4];
#pragma unroll
  for (int j = 0; j < 4 * NV; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  float m_run = kDead, l_run = 0.f;
  int cap = kCapLo;                 // every v_s seen lies below 2^cap
  float wsc = pow2(14 - cap);       // the weights' scale 2^(14 - cap)
  const int sl0 = 2 * t4;           // the thread's slots of a tile: sl0,
                                    // sl0 + 1, sl0 + 8, sl0 + 9

  for (int it = 0; it < my_tiles; it += TPI) {
#pragma unroll
    for (int k = 0; k < TPI; ++k) issue(it + R::kStages - TPI + k);
    cp_async_wait<R::kStages - TPI>();
    __syncwarp();
    // the iteration's tiles: a tile past the warp's last (TPI = 2, an odd
    // count) lies past the chunk, its stage never copied: its slots score
    // -inf and read v_s as 0, whatever its stale bytes hold
    const unsigned char* ks_t[TPI];
    const float* sc[TPI];
    int s0[TPI];
#pragma unroll
    for (int k = 0; k < TPI; ++k) {
      ks_t[k] = ring + ((it + k) % R::kStages) * R::kStageBytes;
      sc[k] = reinterpret_cast<const float*>(ks_t[k] + 2 * kTile * R::kStride);
      s0[k] = c0 + kTile * (phase + phases * (it + k));
    }

    // q.k: two 8-slot column tiles (slots gid and 8 + gid) a tile, a word
    // of K's codes a step each, the even and odd steps into separate sums
    // so independent chains of MMAs run side by side
    float d[TPI][2][2][4] = {};
#pragma unroll
    for (int i = 0; i < 2 * NV; ++i) {
      if (i < nk) {
        const uint4 af = qf[i * 32 + lane];
#pragma unroll
        for (int k = 0; k < TPI; ++k) {
          const unsigned w0 = *reinterpret_cast<const unsigned*>(
              ks_t[k] + gid * R::kStride + 16 * i + 4 * t4);
          const unsigned w1 = *reinterpret_cast<const unsigned*>(
              ks_t[k] + (8 + gid) * R::kStride + 16 * i + 4 * t4);
          unsigned b0, b1, b2, b3;
          codes4(w0, b0, b1);
          codes4(w1, b2, b3);
          mma(d[k][0][i & 1], af, b0, b1);
          mma(d[k][1][i & 1], af, b2, b3);
        }
      }
    }
    // scores of head gid at the thread's four slots a tile, in log2 units:
    // a live slot dot * k_s * scale, a dead one -1e30, one past the chunk
    // -inf
    const int sl[4] = {sl0, sl0 + 1, sl0 + 8, sl0 + 9};
    float s[TPI][4], vsl[TPI][4];
    float mx = -INFINITY, vm = 0.f;
#pragma unroll
    for (int k = 0; k < TPI; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = j >> 1, c = j & 1;
        const float dot = (d[k][n][0][c] + d[k][n][0][c + 2]) +
                          (d[k][n][1][c] + d[k][n][1][c + 2]);
        const bool in = s0[k] + sl[j] < c1;
        const bool live = sc[k][2 * kTile + sl[j]] > 0.5f;
        s[k][j] = in ? (live ? dot * sc[k][sl[j]] * rs : kDead) : -INFINITY;
        vsl[k][j] = in ? sc[k][kTile + sl[j]] : 0.f;
        mx = fmaxf(mx, s[k][j]);
        vm = fmaxf(vm, fabsf(vsl[k][j]));
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      vm = fmaxf(vm, __shfl_xor_sync(0xffffffffu, vm, off));
    }
    // rescale only when the row's max grows or the v_s bound widens
    const bool grow_m = mx > m_run;
    const bool grow_v = vm > pow2(cap);
    if (grow_m || grow_v) {
      const float m_new = grow_m ? mx : m_run;
      const int cap_new = grow_v ? cap_of(vm) : cap;
      const float alpha_m = grow_m ? ex2(m_run - m_new) : 1.f;
      const float alpha = alpha_m * exp2f((float)(cap - cap_new));
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] *= alpha;
      l_run *= alpha_m;
      m_run = m_new;
      cap = cap_new;
      wsc = pow2(14 - cap);
    }
    // p.v: A = the weights' two terms (rows gid, gid + 8) over a tile's 16
    // slots, straight from q.k's accumulator layout
    uint4 aw[TPI];
#pragma unroll
    for (int k = 0; k < TPI; ++k) {
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ex2(s[k][j] - m_run);
        l_run += p;
        w[j] = p * (vsl[k][j] * wsc);
      }
      split2(w[0], w[1], aw[k].x, aw[k].y);
      split2(w[2], w[3], aw[k].z, aw[k].w);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int o = 4 * (gid + 8 * i);
#pragma unroll
      for (int k = 0; k < TPI; ++k) {
        const unsigned char* vs_t = ks_t[k] + kTile * R::kStride;
        const unsigned va = *reinterpret_cast<const unsigned*>(
            vs_t + sl0 * R::kStride + o);
        const unsigned vb2 = *reinterpret_cast<const unsigned*>(
            vs_t + (sl0 + 1) * R::kStride + o);
        const unsigned vc = *reinterpret_cast<const unsigned*>(
            vs_t + (sl0 + 8) * R::kStride + o);
        const unsigned vd = *reinterpret_cast<const unsigned*>(
            vs_t + (sl0 + 9) * R::kStride + o);
        mma(acc[4 * i + 0], aw[k], codes_across<0>(va, vb2),
            codes_across<0>(vc, vd));
        mma(acc[4 * i + 1], aw[k], codes_across<1>(va, vb2),
            codes_across<1>(vc, vd));
        mma(acc[4 * i + 2], aw[k], codes_across<2>(va, vb2),
            codes_across<2>(vc, vd));
        mma(acc[4 * i + 3], aw[k], codes_across<3>(va, vb2),
            codes_across<3>(vc, vd));
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // merge the warps in shared memory (the ring's space): m_s, l_s [warp][8],
  // red [warp][8][32 NV] (query head gid's dims 32 i + 8 t4 + d and + 4,
  // the two terms summed, the weights' scale taken back out); a kv head's
  // phases merge into its chunk's partial
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  __syncthreads();
  float* m_s = reinterpret_cast<float*>(smem);
  float* l_s = m_s + kWarps * kRows;
  float* red = l_s + kWarps * kRows;
  constexpr int kWidth = 32 * NV;          // dims of a head's row in red
  if (t4 == 0) {
    m_s[warp * kRows + gid] = m_run;
    l_s[warp * kRows + gid] = l_run;
  }
  const float unscale = pow2(cap - 14);
  float* my_red = red + (warp * kRows + gid) * kWidth;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float* c4 = acc[4 * i + d];
      my_red[32 * i + 8 * t4 + d] = (c4[0] + c4[2]) * unscale;
      my_red[32 * i + 8 * t4 + 4 + d] = (c4[1] + c4[3]) * unscale;
    }
  __syncthreads();
  // per (kv head, query head): the phases' weights exp2(m_w - max) in place
  // of m_s, the max and the sum of weighted l in gd
  __shared__ float gd[kWarps][kRows][2];
  for (int pair = (int)threadIdx.x; pair < hpc * kRows; pair += kThreads) {
    const int ph = pair / kRows, h = pair - ph * kRows;
    float gmax = -INFINITY;
    for (int p = 0; p < phases; ++p)
      gmax = fmaxf(gmax, m_s[(ph + hpc * p) * kRows + h]);
    float den = 0.f;
    for (int p = 0; p < phases; ++p) {
      const int w = ph + hpc * p;
      const float e = exp2f(m_s[w * kRows + h] - gmax);
      m_s[w * kRows + h] = e;
      den += e * l_s[w * kRows + h];
    }
    gd[ph][h][0] = gmax;
    gd[ph][h][1] = den;
  }
  __syncthreads();
  const bool final_out = a.n_split == 1;
  const int per_head = mn * a.hd;
  for (int idx = (int)threadIdx.x; idx < hpc * per_head; idx += kThreads) {
    const int ph = idx / per_head, r = idx - ph * per_head;
    const int h = r / a.hd, d = r - h * a.hd;
    const int gh = blockIdx.y * hpc + ph;
    if (gh >= a.G) continue;
    float sum = 0.f;
    for (int p = 0; p < phases; ++p) {
      const int w = ph + hpc * p;
      sum += m_s[w * kRows + h] * red[(w * kRows + h) * kWidth + d];
    }
    const long long row = (long long)gh * a.Mt + m0 + h;
    if (final_out) {
      a.out[((long long)b * a.G * a.Mt + row) * a.hd + d] =
          sum / fmaxf(gd[ph][h][1], 1e-30f);
    } else {
      const long long o = ((long long)b * a.n_split + c) * a.G * a.Mt + row;
      a.part_acc[o * a.hd + d] = sum;
      if (d == 0) {
        a.part_ml[o * 2] = gd[ph][h][0];
        a.part_ml[o * 2 + 1] = gd[ph][h][1];
      }
    }
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

template <int NV>
int launch_nv(const Args& a, int B, cudaStream_t stream) {
  auto kernel = decode_attention_mma<NV>;
  constexpr size_t smem = Ring<NV>::kSmem;
  // the opt-in to the whole budget, set once per instantiation and device,
  // so no later launch, a captured one included, sets it again
  static bool opted_in[64] = {};
  int device = 0;
  const cudaError_t de = cudaGetDevice(&device);
  if (de != cudaSuccess) return (int)de;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCtaSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in[device] = true;
  }
  kernel<<<dim3(a.n_split, (a.G + a.hpc - 1) / a.hpc, B * a.mgroups),
           kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  decode_attention_combine<<<(unsigned)(B * a.G * a.Mt), kCombineThreads,
                             sizeof(float) * (a.n_split + 1), stream>>>(
      a.part_acc, a.part_ml, a.out, a.n_split, a.G, a.Mt, a.hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// M: query heads per kv head; m_group: query heads a CTA takes (1 to 8; M
// splits into ceil(M / m_group) groups); vec: bytes a row copy moves (16:
// rows 16-byte aligned, hd % 16 == 0; else 8); chunk: slots per CTA;
// n_split: chunks per batch row (ceil(S / chunk)); hpc: kv heads a CTA
// takes (1, 2, 4 or 8); part: scratch of B * n_split * G * M * (hd + 2) f32
// (unused when n_split == 1)
int decode_attention_launch(const void* q, const void* kq, const void* ks,
                            const void* vq, const void* vs, const void* valid,
                            void* out, void* part, int B, int S, int G, int M,
                            int m_group, int hd, int kq_sb, int kq_ss, int kq_sg,
                            int ks_sb, int ks_ss, int ks_sg, int vq_sb,
                            int vq_ss, int vq_sg, int vs_sb, int vs_ss,
                            int vs_sg, int val_sb, int val_ss, int scale_bits,
                            int vec, int chunk, int n_split, int hpc,
                            void* stream) {
  if (B <= 0 || G <= 0) return 0;
  if (M < 1 || m_group < 1 || m_group > kRows ||
      (hpc != 1 && hpc != 2 && hpc != 4 && hpc != 8) ||
      (G + hpc - 1) / hpc > 65535)
    return (int)cudaErrorInvalidValue;
  const int mgroups = (M + m_group - 1) / m_group;
  if ((long long)B * mgroups > 65535) return (int)cudaErrorInvalidValue;
  if (S <= 0 || (vec != 8 && vec != 16) || hd % vec != 0 || hd < 8 ||
      hd > 256 || chunk < 1 || n_split < 1 || n_split > 65535 ||
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
  a.mg = m_group;
  a.mgroups = mgroups;
  a.vec = vec;
  a.hpc = hpc;
  a.skq = Strides{kq_sb, kq_ss, kq_sg};
  a.sks = Strides{ks_sb, ks_ss, ks_sg};
  a.svq = Strides{vq_sb, vq_ss, vq_sg};
  a.svs = Strides{vs_sb, vs_ss, vs_sg};
  a.val_b = val_sb;
  a.val_s = val_ss;
  memcpy(&a.scale, &scale_bits, sizeof(float));
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((hd + 31) / 32) {
    case 1: return launch_nv<1>(a, B, st);
    case 2: return launch_nv<2>(a, B, st);
    case 3: return launch_nv<3>(a, B, st);
    case 4: return launch_nv<4>(a, B, st);
    case 5: return launch_nv<5>(a, B, st);
    case 6: return launch_nv<6>(a, B, st);
    case 7: return launch_nv<7>(a, B, st);
    case 8: return launch_nv<8>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
