// Grouped expert GEMM (B9) for Hopper (sm_90a): the routed experts of a
// dropless MoE layer, every expert's tokens in one launch a matrix.
//
// Replaces no TPU kernel: the JAX package's MoE runs its experts as one
// batched matmul over (E, capacity) buffers in XLA and drops what passes
// the capacity. This kernel serves DeepSeek-V3's layer as published:
// dropless, the expert weights held as fp8 e4m3 codes with one float32
// scale a 128 x 128 block (tech report §3.3), the activations in bf16.
//
//   pairs sorted by expert: expert e owns rows [offsets[e], offsets[e] +
//   counts[e]) of the P = T x K routed (token, choice) pairs;
//   gate_up: H[p] = silu(x[src[p]] . Wg[e]^T) * (x[src[p]] . Wu[e]^T)
//            x (T, D) bf16, Wg / Wu (E, F, D) e4m3, H (P, F) bf16
//   down:    Y[dst[p]] = w[p] * (H[p] . Wd[e]^T)
//            Wd (E, D, F) e4m3, w (P,) f32, Y (P, D) bf16 (dst: the pair's
//            row in token order, so a token's K rows lie side by side)
//   stored:  each down block adds the rows its epilogue stored (one atomic
//            a block), so a call that stores every pair adds P x N / 128:
//            the count a caller holds against the routed pairs
//
// The products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 sums). Each stage's tile of e4m3 codes is dequantized once in shared
// memory, code x its block's scale rounded to bf16 (as the served model
// holds its other linear weights: bf16 copies of the dequantized values),
// and the warps read both operands with ldmatrix.
//
// Bound: operations. At the served shape (8192 tokens, K 8, E 256, D 7168,
// F 2048: 256 tokens an expert on average) a layer is 5.77 TFLOP against
// 11.3 GB of fp8 weights, 512 FLOP a weight byte, above the card's ridge
// (295 FLOP a byte at bf16's 989 TFLOP/s).
//
// Design, right and simple first:
//   - Tile 128 rows (pairs) x 128 columns (one scale block of N), 64 deep
//     a stage (half a scale block of K). 8 warps, 4 along the rows x 2
//     along the columns, each 32 x 64 (gate_up: that tile of both
//     matrices, whose products share the A fragments). A ring of 3 stages
//     of A (bf16) and of the codes filled by cp.async (16 bytes a thread;
//     a row past the expert's count zero-filled). Each thread dequantizes
//     the codes it copied of the next stage into the other of two bf16
//     tiles while the products of this one run: one barrier a stage.
//     16-byte chunks of a bf16 row swizzled by the row's low three bits,
//     so ldmatrix hits 32 banks. The down kernel (one matrix) fits two
//     blocks an SM.
//   - Launch geometry fixed at capture: the grid's x is the most 128-row
//     tiles any routing can need, ceil(P / 128) + E; tile_start (E + 1,
//     the prefix of ceil(counts / 128), computed on the device) maps a
//     block to its expert by a binary search, and a block past the last
//     tile exits. The grid's y walks the output columns, so the tiles of
//     one expert and one weight block run side by side and read it from
//     L2.
//
// Each launch checks cudaGetLastError() and allocates nothing; the caller
// owns every buffer.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // rows (routed pairs) a tile
constexpr int kBN = 128;      // output columns a tile: one scale block
constexpr int kBK = 64;       // reduction depth a stage
constexpr int kScale = 128;   // the scale block
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kAStage = kBM * kBK * 2;    // bf16 A tile, bytes
constexpr int kBStage = kBN * kBK;        // e4m3 codes of one matrix
constexpr int kBTile = kBN * kBK * 2;     // its bf16 tile

template <int NMAT>
__host__ __device__ constexpr int stage_bytes() {
  return kAStage + NMAT * kBStage;
}

template <int NMAT>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<NMAT>() + 2 * NMAT * kBTile;
}

struct Args {
  const __nv_bfloat16* a;     // gate_up: x (T, K); down: H (P, K)
  const int* src;             // gate_up: the token of each sorted pair
  const int* offsets;         // (E,) first sorted pair of each expert
  const int* counts;          // (E,) pairs of each expert
  const int* tile_start;      // (E + 1,) first tile of each expert
  const uint8_t* w0;          // (E, N, K) e4m3 codes: gate / down
  const uint8_t* w1;          // (E, N, K) e4m3 codes: up (gate_up)
  const float* s0;            // (E, N / 128, K / 128) scales of w0
  const float* s1;            // scales of w1
  const float* pair_w;        // down: (P,) weight of each sorted pair
  const int* dst;             // down: (P,) output row of each sorted pair
  __nv_bfloat16* out;         // gate_up: H (P, N); down: Y (P, N)
  unsigned long long* stored; // down: rows stored, summed (may be null)
  int n_experts, n, k;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// two e4m3 codes (low byte first) times the scale, rounded to bf16x2
__device__ __forceinline__ uint32_t dequant2(uint32_t v, float sc) {
  const __half2_raw hr =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(v & 0xffffu),
                                 __NV_E4M3);
  const float2 f = __half22float2(__half2(hr));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x * sc, f.y * sc);
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + __expf(-x));
}

// byte offset of 16-byte chunk c of row r in a bf16 tile of 64-wide rows
__device__ __forceinline__ int swz(int r, int c) {
  return r * (kBK * 2) + ((c ^ (r & 7)) << 4);
}

// NMAT 2: gate_up (A rows gathered by src, the SiLU x up epilogue);
// NMAT 1: down (A rows in order, the pair-weight epilogue, rows by dst)
template <int NMAT>
__global__ void __launch_bounds__(kThreads, NMAT == 1 ? 2 : 1)
grouped_gemm_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int bx = blockIdx.x;
  if (bx >= a.tile_start[a.n_experts]) return;
  int lo = 0, hi = a.n_experts - 1;      // last e with tile_start[e] <= bx
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.tile_start[mid] <= bx) lo = mid; else hi = mid - 1;
  }
  const int e = lo;
  const int mt = bx - a.tile_start[e];
  const int row0 = a.offsets[e] + mt * kBM;
  const int rows = min(kBM, a.counts[e] - mt * kBM);
  const int nb = blockIdx.y;                      // the column block
  const int n0 = nb * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, q = lane & 3;
  const int ksteps = a.k / kBK;
  uint8_t* btile = smem + kStages * stage_bytes<NMAT>();

  // the A rows this thread copies: rows tid / 8 + 32 i, chunk tid % 8
  const __nv_bfloat16* arow[4];
  bool aok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + 32 * i;
    aok[i] = r < rows;
    int row = aok[i] ? row0 + r : 0;
    if (NMAT == 2 && aok[i]) row = a.src[row];
    arow[i] = a.a + (size_t)row * a.k;
  }
  const int ac = tid & 7;
  // the code rows this thread copies and dequantizes: rows tid / 4 + 64 i,
  // 16 codes at column 16 (tid % 4)
  const int bc = tid & 3;
  const uint8_t* wbase[2] = {
      a.w0 + ((size_t)e * a.n + n0) * a.k,
      NMAT == 2 ? a.w1 + ((size_t)e * a.n + n0) * a.k : nullptr};
  const float* scales[2] = {a.s0, a.s1};
  const size_t srow = ((size_t)e * (a.n / kScale) + nb) * (a.k / kScale);

  auto load = [&](int stage, int ks) {
    uint8_t* sa = smem + stage * stage_bytes<NMAT>();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i;
      cp16(smem_addr(sa + swz(r, ac)), arow[i] + ks * kBK + ac * 8, aok[i]);
    }
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      uint8_t* sb = sa + kAStage + m * kBStage;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (tid >> 2) + 64 * i;
        cp16(smem_addr(sb + r * kBK + bc * 16),
             wbase[m] + (size_t)r * a.k + ks * kBK + bc * 16, true);
      }
    }
    commit();
  };

  float acc[NMAT][2][8][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][i][j][c] = 0.0f;

  // dequantize the codes this thread copied of stage ks into bf16 tile
  // buffer ks & 1
  auto dequant = [&](int ks) {
    const uint8_t* sa = smem + (ks % kStages) * stage_bytes<NMAT>();
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      const float sc = scales[m][srow + (ks * kBK) / kScale];
      const uint8_t* sb = sa + kAStage + m * kBStage;
      uint8_t* bt = btile + ((ks & 1) * NMAT + m) * kBTile;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (tid >> 2) + 64 * i;
        const uint4 v = *reinterpret_cast<const uint4*>(sb + r * kBK
                                                        + bc * 16);
        uint4 lo4, hi4;
        lo4.x = dequant2(v.x, sc); lo4.y = dequant2(v.x >> 16, sc);
        lo4.z = dequant2(v.y, sc); lo4.w = dequant2(v.y >> 16, sc);
        hi4.x = dequant2(v.z, sc); hi4.y = dequant2(v.z >> 16, sc);
        hi4.z = dequant2(v.w, sc); hi4.w = dequant2(v.w >> 16, sc);
        *reinterpret_cast<uint4*>(bt + swz(r, 2 * bc)) = lo4;
        *reinterpret_cast<uint4*>(bt + swz(r, 2 * bc + 1)) = hi4;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ksteps) load(s, s); else commit();
  }
  wait_group<kStages - 2>();
  dequant(0);
  for (int ks = 0; ks < ksteps; ++ks) {
    // stage ks's A tiles landed and its bf16 tiles written by every
    // thread; the products of step ks - 1 done, so its ring slot and bf16
    // buffer are free
    __syncthreads();
    const int next = ks + kStages - 1;
    if (next < ksteps) load(next % kStages, next); else commit();
    const uint8_t* sa = smem + (ks % kStages) * stage_bytes<NMAT>();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + (lane & 15);
        ldmatrix_x4(af[i], smem_addr(sa + swz(r, kk * 2 + (lane >> 4))));
      }
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        const uint8_t* bt = btile + ((ks & 1) * NMAT + m) * kBTile;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = wn * 64 + jj * 16 + (lane & 7) + ((lane >> 4) << 3);
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_addr(bt + swz(r, kk * 2 + ((lane >> 3) & 1))));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma(acc[m][i][2 * jj], af[i], bf);
            mma(acc[m][i][2 * jj + 1], af[i], bf + 2);
          }
        }
      }
    }
    if (ks + 1 < ksteps) {    // the next step's codes, beside the products
      wait_group<kStages - 2>();
      dequant(ks + 1);
    }
  }
  wait_group<0>();

  // epilogue: a thread holds rows g and g + 8, columns 2q and 2q + 1 of
  // each 16 x 8 subtile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + i * 16 + g + 8 * h;
      if (r >= rows) continue;
      const int p = row0 + r;
      size_t orow;
      float wgt = 1.0f;
      if (NMAT == 2) {
        orow = (size_t)p;
      } else {
        orow = (size_t)a.dst[p];
        wgt = a.pair_w[p];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + j * 8 + 2 * q;
        float v0, v1;
        if (NMAT == 2) {
          v0 = silu(acc[0][i][j][2 * h]) * acc[NMAT - 1][i][j][2 * h];
          v1 = silu(acc[0][i][j][2 * h + 1]) * acc[NMAT - 1][i][j][2 * h + 1];
        } else {
          v0 = wgt * acc[0][i][j][2 * h];
          v1 = wgt * acc[0][i][j][2 * h + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(a.out + orow * a.n + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  if (NMAT == 1 && a.stored != nullptr && tid == 0)
    atomicAdd(a.stored, (unsigned long long)rows);
}

template <int NMAT>
int launch(const Args& a, int max_tiles, cudaStream_t stream) {
  auto kernel = grouped_gemm_kernel<NMAT>;
  // the opt-in to more than 48 KB of dynamic shared memory, once per
  // instantiation and device, so no later launch (a captured one
  // included) sets it again
  static bool opted_in[64] = {};
  int device = 0;
  const cudaError_t de = cudaGetDevice(&device);
  if (de != cudaSuccess) return (int)de;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<NMAT>());
    if (e != cudaSuccess) return (int)e;
    opted_in[device] = true;
  }
  kernel<<<dim3(max_tiles, a.n / kBN), kThreads, smem_bytes<NMAT>(),
           stream>>>(a);
  return (int)cudaGetLastError();
}

bool shape_ok(int n_experts, int n, int k, int max_tiles) {
  return n_experts > 0 && n > 0 && k > 0 && n % kBN == 0 &&
         k % kScale == 0 && max_tiles > 0 && n / kBN <= 65535;
}

}  // namespace

extern "C" {

// x (T, D) bf16; src / offsets / counts / tile_start int32; wg, wu (E, F,
// D) e4m3; sg, su (E, F / 128, D / 128) f32; h (P, F) bf16. max_tiles:
// ceil(P / 128) + E, the grid's x.
int grouped_gemm_gate_up_launch(const void* x, const void* src,
                                const void* offsets, const void* counts,
                                const void* tile_start, const void* wg,
                                const void* wu, const void* sg,
                                const void* su, void* h, int n_experts,
                                int f, int d, int max_tiles, void* stream) {
  if (!shape_ok(n_experts, f, d, max_tiles))
    return (int)cudaErrorInvalidValue;
  Args a{(const __nv_bfloat16*)x, (const int*)src, (const int*)offsets,
         (const int*)counts, (const int*)tile_start, (const uint8_t*)wg,
         (const uint8_t*)wu, (const float*)sg, (const float*)su, nullptr,
         nullptr, (__nv_bfloat16*)h, nullptr, n_experts, f, d};
  return launch<2>(a, max_tiles, (cudaStream_t)stream);
}

// h (P, F) bf16 rows in expert order; wd (E, D, F) e4m3; sd (E, D / 128,
// F / 128) f32; pair_w (P,) f32 and dst (P,) int32 in expert order; y
// (P, D) bf16, row dst[p] written from sorted row p; stored (int64, or
// null) gains the rows each block stored.
int grouped_gemm_down_launch(const void* h, const void* offsets,
                             const void* counts, const void* tile_start,
                             const void* wd, const void* sd,
                             const void* pair_w, const void* dst, void* y,
                             void* stored, int n_experts, int d, int f,
                             int max_tiles, void* stream) {
  if (!shape_ok(n_experts, d, f, max_tiles))
    return (int)cudaErrorInvalidValue;
  Args a{(const __nv_bfloat16*)h, nullptr, (const int*)offsets,
         (const int*)counts, (const int*)tile_start, (const uint8_t*)wd,
         nullptr, (const float*)sd, nullptr, (const float*)pair_w,
         (const int*)dst, (__nv_bfloat16*)y, (unsigned long long*)stored,
         n_experts, d, f};
  return launch<1>(a, max_tiles, (cudaStream_t)stream);
}

const char* grouped_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
