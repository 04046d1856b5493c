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
//   stored:  each down tile adds the rows its epilogue stored (one atomic
//            a row tile and 128-column block), so a call that stores every
//            pair adds P x N / 128: the count a caller holds against the
//            routed pairs
//   shapes:  the down launch's row tiles at each width (64, 128, 192, 256
//            pairs), one count a row tile
//
// Numbers: each weight is code x its block's scale in float32, rounded to
// bf16 (as core/quantize.dequantize_blocks(..., bf16)); bf16 products, f32
// sums; H rounded to bf16.
//
// Bound: operations. At the served shape (8192 tokens, K 8, E 256, D 7168,
// F 2048: 256 pairs an expert on average) a layer is 5.77 TFLOP against
// 11.3 GB of fp8 weights, 512 FLOP a weight byte, above the card's ridge
// (295 FLOP a byte at bf16's 989 TFLOP/s): 5.83 ms at the bf16 tensor rate.
//
// Design (warp-specialised, persistent, wgmma fed by TMA):
//   - Swapped operands: the output columns (weight rows) are wgmma's M and
//     the expert's pairs its N, so a tile's width follows the expert's
//     pairs. A tile is one expert's row tile of up to 256 pairs, run at N =
//     its pairs rounded up to 64 (64, 128, 192 or 256), by 128 weight rows:
//     down, 128 output columns (a scale block); gate_up, 64 columns of Wg
//     and the same 64 of Wu, so a warp's 16 A rows are 8 gate rows and their
//     8 up rows and a thread holds both sums of each H element.
//   - Two consumer warpgroups of 64 A rows each run m64nNk16 wgmma with A
//     in registers: each k32 the warp loads its codes with one ldmatrix,
//     puts each thread's two-code pairs where wgmma's fragment wants them
//     (two shuffles and a byte permute a word), and dequantizes them to bf16
//     while the previous k32's wgmma runs (two A buffers, wait_group 1).
//     Sums stay in registers (N / 2 floats a thread, 128 at N = 256).
//   - One producer warpgroup fills a ring of 4 stages, each 64 deep: the
//     codes by TMA (a 2-D map over (E x rows, K), 64-byte swizzle) and the
//     float32 scales beside them; the pairs' rows, 128-byte swizzled as
//     wgmma reads them, by TMA from H (down) or gathered x[src[p]] by
//     cp.async from all 128 producer threads (gate_up). Full barriers take
//     the TMA bytes (and the cp.async arrivals); empty barriers one arrival
//     a consumer warp. Registers: 168 a thread at launch (384 threads);
//     setmaxnreg leaves the producer 40 and gives each consumer 232 (ptxas:
//     no spill, the wgmmas not serialized; the sums are zeroed at each tile
//     so none stay live across tiles).
//   - Persistent: one block an SM walks tiles i = blockIdx.x + j gridDim.x
//     of a list held on the device: walk (the experts, most pairs first)
//     and tile_start (the prefix of ceil(counts / 256) along the walk); a
//     tile's expert is a binary search, its row tile and column block the
//     rest (tile_at). An expert's tiles run row tile by row tile, so the
//     ~132 tiles in flight share each row tile's pairs and the expert's
//     weight slabs in L2; the largest experts run first. The producer runs
//     ahead into the next tile while the consumers store the last.
//   - Epilogue: the sums (gate_up: silu(gate) x up; down: x the pair's
//     weight) rounded to bf16, written transposed into a swizzled staging
//     tile by stmatrix, then stored a row at a time in 16-byte pieces (down
//     to the pair's row in token order).
//   Shared memory a block: 4 x (32 KB rows + 8 KB codes) + staging (gate_up
//   32 KB, down 64 KB) + barriers: 197,728 / 230,496 bytes.
//
// Each launch checks cudaGetLastError() and allocates nothing; the caller
// owns every buffer. The tensor maps are encoded on the host for each
// launch (no device work), so a CUDA graph captures the launch as is.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;      // pairs a row tile at most
constexpr int kUnit = 64;       // a tile's N: its pairs rounded up to this
constexpr int kBK = 64;         // reduction depth a stage
constexpr int kScale = 128;     // the scale block
constexpr int kStages = 4;
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kRowBytes = kTile * kBK * 2;   // a stage's rows, bf16
constexpr int kCodeBytes = 128 * kBK;        // a stage's codes: 128 A rows

// output columns a tile: gate_up 64 of F (each of Wg and Wu), down 128 of D
template <int NMAT>
__host__ __device__ constexpr int tile_cols() { return NMAT == 2 ? 64 : 128; }

// a staging row: one pair's columns of one consumer warpgroup, bf16
template <int NMAT>
__host__ __device__ constexpr int staging_row_bytes() {
  return tile_cols<NMAT>() / kConsumers * 2;
}

template <int NMAT>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + kStages * (kRowBytes + kCodeBytes) +
         kConsumers * kTile * staging_row_bytes<NMAT>() + kStages * 16 +
         kStages * 8;
}

struct Args {
  const __nv_bfloat16* x;     // gate_up: x (T, K)
  const int* src;             // gate_up: the token of each sorted pair
  const int* offsets;         // (E,) first sorted pair of each expert
  const int* counts;          // (E,) pairs of each expert
  const int* tile_start;      // (E + 1,) first row tile of each walk place
  const int* walk;            // (E,) the experts, most pairs first
  const float* s0;            // (E, N / 128, K / 128) scales: gate / down
  const float* s1;            // scales of up (gate_up)
  const float* pair_w;        // down: (P,) weight of each sorted pair
  const int* dst;             // down: (P,) output row of each sorted pair
  __nv_bfloat16* out;         // gate_up: H (P, N); down: Y (P, N)
  unsigned long long* stored; // down: rows stored, summed (may be null)
  unsigned long long* shapes; // down: row tiles at each N (may be null)
  int n_experts, n, k;
};

struct Tile {
  int e, block, row0, rows, n;
};

// tile i of the list: the walk place whose tiles hold it, then the row
// tile and the column block. An expert's tiles go row tile by row tile, so
// a row tile's column blocks run side by side (its pairs' rows are read
// from memory once) beside the next row tiles (the expert's weight slabs
// are read again from L2).
__device__ __forceinline__ Tile tile_at(const Args& a, int i, int blocks) {
  int lo = 0, hi = a.n_experts - 1;    // last place with start <= i
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(a.tile_start + mid) * blocks <= i) lo = mid; else hi = mid - 1;
  }
  const int local = i - __ldg(a.tile_start + lo) * blocks;
  Tile t;
  t.e = __ldg(a.walk + lo);
  const int m = local / blocks;
  t.block = local - m * blocks;
  t.row0 = __ldg(a.offsets + t.e) + m * kTile;
  t.rows = min(kTile, __ldg(a.counts + t.e) - m * kTile);
  t.n = (t.rows + kUnit - 1) / kUnit * kUnit;
  return t;
}

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// the barrier gains this thread's arrival when its cp.asyncs land
__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t* r) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1,%2,%3,%4};\n"
      :: "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// a K-major bf16 operand in shared memory, 128-byte rows swizzled in
// 1024-byte atoms of 8 rows
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

// m64nNk16, A (bf16) from registers, B (bf16, K-major) by descriptor, f32
// sums; accumulate 0 overwrites them
template <int N>
struct Mma;

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t* a,
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t* a,
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  }
};

template <>
struct Mma<192> {
  __device__ __forceinline__ static void run(float (&d)[96], const uint32_t* a,
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  }
};

template <>
struct Mma<256> {
  __device__ __forceinline__ static void run(float (&d)[128], const uint32_t* a,
                                             uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  }
};


// -- the consumer's A operand -------------------------------------------------
//
// The warp's 16 A rows (a fragment's rows g and g + 8, g = lane / 4) at two
// k16 steps: ldmatrix hands thread (g, q) codes 4q .. 4q + 3 of a row's 16;
// wgmma wants codes 2q, 2q + 1 (a0 / a1) and 2q + 8, 2q + 9 (a2 / a3), so
// each thread takes those pairs from lanes q / 2 and q / 2 + 2 of its row.
struct AFrag {
  uint32_t row_off;      // byte offset of this lane's ldmatrix row in a
                         // code stage
  uint32_t swz;          // its swizzle: the row / 2 mod 4
  int src_lo;            // lane holding this thread's low pair
  uint32_t sel;          // byte permute picking this thread's half
};

// the codes of k16 steps 2h and 2h + 1 at stage `code` -> a[0..3] (step 2h)
// and a[4..7] (step 2h + 1), each weight code x scale rounded to bf16; rows
// g take s_lo, rows g + 8 s_hi
__device__ __forceinline__ void load_a(uint32_t (&a)[8], const AFrag& f,
                                       uint32_t code, int h, int lane,
                                       float s_lo, float s_hi) {
  const uint32_t chunk = (uint32_t)(2 * h + (lane >> 4));
  uint32_t r[4];
  ldmatrix_x4(r, code + f.row_off + ((chunk ^ f.swz) << 4));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = __shfl_sync(0xffffffffu, r[j], f.src_lo);
    const uint32_t hi = __shfl_sync(0xffffffffu, r[j], f.src_lo + 2);
    const uint32_t p = __byte_perm(lo, hi, f.sel);
    const float sc = (j & 1) ? s_hi : s_lo;
    a[(j >> 1) * 4 + (j & 1)] = dequant2(p, sc);
    a[(j >> 1) * 4 + (j & 1) + 2] = dequant2(p >> 16, sc);
  }
}

struct Smem {
  uint32_t rows, code, staging, full, empty;   // shared addresses
  float* scales;                               // (kStages, 2)
};

// one k32 step: two m64nNk16 products on stage rows `rows` (the step's
// first 16 columns), one commit group
template <int N>
__device__ __forceinline__ void mma_k32(float (&acc)[N / 2],
                                        const uint32_t (&a)[8], uint32_t rows,
                                        int accumulate) {
  fence_acc(acc);
  wgmma_fence();
  Mma<N>::run(acc, a, desc_sw128(rows), accumulate);
  Mma<N>::run(acc, a + 4, desc_sw128(rows + 32), 1);
  wgmma_commit();
  fence_acc(acc);
}

// the consumer warpgroup's share of one tile: the K loop, then the
// epilogue. `it` counts the stages this thread has consumed.
template <int N, int NMAT>
__device__ __forceinline__ void consume(const Args& a, const Smem& s,
                                        const AFrag& f, const Tile& t,
                                        int& it, int wg, int warp, int lane) {
  // zeroed, so no value flows from the last tile's sums: without it ptxas
  // keeps them live across tiles, spills, and serializes the wgmmas
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  uint32_t a0[8], a1[8];        // the A fragments of k32 steps 2ks, 2ks + 1
  const int stages = a.k / kBK;
  const int it0 = it;
  {
    const int st = it0 % kStages;
    mbar_wait(s.full + 8 * st, (uint32_t)(it0 / kStages) & 1);
    if (NMAT == 2) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    load_a(a0, f, s.code + st * kCodeBytes, 0, lane, s.scales[2 * st],
           s.scales[2 * st + 1]);
  }
#pragma unroll 1
  for (int ks = 0; ks < stages; ++ks) {
    const int st = (it0 + ks) % kStages;
    const uint32_t rows = s.rows + st * kRowBytes;
    mma_k32<N>(acc, a0, rows, ks > 0);
    wgmma_wait<1>();            // the previous stage's last step done
    if (ks > 0 && lane == 0)
      mbar_arrive(s.empty + 8 * ((it0 + ks - 1) % kStages));
    load_a(a1, f, s.code + st * kCodeBytes, 1, lane, s.scales[2 * st],
           s.scales[2 * st + 1]);
    mma_k32<N>(acc, a1, rows + 64, 1);
    wgmma_wait<1>();            // step 2ks done: a0 is free
    if (ks + 1 < stages) {
      const int sn = (it0 + ks + 1) % kStages;
      mbar_wait(s.full + 8 * sn, (uint32_t)((it0 + ks + 1) / kStages) & 1);
      if (NMAT == 2)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_a(a0, f, s.code + sn * kCodeBytes, 0, lane, s.scales[2 * sn],
             s.scales[2 * sn + 1]);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(s.empty + 8 * ((it0 + stages - 1) % kStages));
  it = it0 + stages;

  // epilogue: thread (g, q) holds rows g, g + 8 of its warp's 16 and pairs
  // 8j + 2q, 8j + 2q + 1 in acc[4j .. 4j + 3]
  constexpr int RB = staging_row_bytes<NMAT>();
  const uint32_t stg = s.staging + wg * kTile * RB;
  const int q = lane & 3;
  if (NMAT == 2) {
    // rows g: gate, g + 8: up, of H column 8 warp + g of this warpgroup's 32
#pragma unroll
    for (int jj = 0; jj < N / 32; ++jj) {
      uint32_t r[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = 4 * jj + m;
        r[m] = pack_bf16(silu(acc[4 * j]) * acc[4 * j + 2],
                         silu(acc[4 * j + 1]) * acc[4 * j + 3]);
      }
      const int row = 32 * jj + lane;    // matrix lane / 8, its row lane % 8
      stmatrix_x4_trans(stg + row * RB + ((warp ^ ((row >> 1) & 3)) << 4), r);
    }
  } else {
    // rows g and g + 8: Y columns 16 warp + g and + 8 of this warpgroup's 64
    const float* pw = a.pair_w + t.row0;
#pragma unroll
    for (int jj = 0; jj < N / 16; ++jj) {
      uint32_t r[4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int j = 2 * jj + m;
        const int p = 8 * j + 2 * q;
        const float w0 = p < t.rows ? __ldg(pw + p) : 0.0f;
        const float w1 = p + 1 < t.rows ? __ldg(pw + p + 1) : 0.0f;
        r[2 * m] = pack_bf16(acc[4 * j] * w0, acc[4 * j + 1] * w1);
        r[2 * m + 1] = pack_bf16(acc[4 * j + 2] * w0, acc[4 * j + 3] * w1);
      }
      const int mi = lane >> 3;
      const int row = 16 * jj + 8 * (mi >> 1) + (lane & 7);
      const int chunk = 2 * warp + (mi & 1);
      stmatrix_x4_trans(stg + row * RB + ((chunk ^ (row & 7)) << 4), r);
    }
  }
  named_sync(1 + wg);
  const int tid = threadIdx.x & 127;
  constexpr int CH = RB / 16;           // 16-byte pieces a staging row
  const int c = tid % CH;
  const uint8_t* stg_ptr =
      reinterpret_cast<const uint8_t*>(__cvta_shared_to_generic(stg));
  const int col = t.block * tile_cols<NMAT>() + wg * (tile_cols<NMAT>() / 2) +
                  8 * c;
  for (int r = tid / CH; r < t.rows; r += 128 / CH) {
    const int sw = NMAT == 2 ? (c ^ ((r >> 1) & 3)) : (c ^ (r & 7));
    const uint4 v = *reinterpret_cast<const uint4*>(stg_ptr + r * RB + sw * 16);
    const size_t orow = NMAT == 2 ? (size_t)(t.row0 + r)
                                  : (size_t)__ldg(a.dst + t.row0 + r);
    *reinterpret_cast<uint4*>(a.out + orow * a.n + col) = v;
  }
  named_sync(1 + wg);                   // staging free for the next tile
  if (NMAT == 1 && wg == 0 && tid == 0) {
    if (a.stored != nullptr)
      atomicAdd(a.stored, (unsigned long long)t.rows);
    if (a.shapes != nullptr && t.block == 0)
      atomicAdd(a.shapes + (N / kUnit - 1), 1ull);
  }
}

// NMAT 2: gate_up (rows gathered by src, the SiLU x up epilogue); NMAT 1:
// down (rows of H in order, the pair-weight epilogue, rows by dst)
template <int NMAT>
__global__ void __launch_bounds__(kThreads, 1)
grouped_gemm_kernel(const Args a, const __grid_constant__ CUtensorMap m0,
                    const __grid_constant__ CUtensorMap m1,
                    const __grid_constant__ CUtensorMap mh) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  Smem s;
  s.rows = base;
  s.code = s.rows + kStages * kRowBytes;
  s.staging = s.code + kStages * kCodeBytes;
  s.full = s.staging + kConsumers * kTile * staging_row_bytes<NMAT>();
  s.empty = s.full + 8 * kStages;
  s.scales = reinterpret_cast<float*>(smem_raw + (s.empty + 8 * kStages - raw));
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(s.full + 8 * i, NMAT == 2 ? 1 + 128 : 1);
      mbar_init(s.empty + 8 * i, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int blocks = a.n / tile_cols<NMAT>();
  const int total = __ldg(a.tile_start + a.n_experts) * blocks;
  const int stages = a.k / kBK;

  if (wg == 0) {
    // -- producer --------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (NMAT == 1 && threadIdx.x != 0) return;   // down: one thread
    const int tid = threadIdx.x;
    const int nsb = a.n / kScale, ksb = a.k / kScale;
    int it = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const Tile t = tile_at(a, i, blocks);
      if (t.rows <= 0) continue;
      const int col0 = t.block * tile_cols<NMAT>();
      const size_t srow = ((size_t)t.e * nsb + col0 / kScale) * ksb;
      // gate_up: the first element of each gathered row this thread
      // copies, read once a tile
      uint32_t xrow[NMAT == 2 ? kTile / 32 : 1];
      if (NMAT == 2) {
#pragma unroll
        for (int i = 0; i < kTile / 32; ++i) {
          const int r = (tid >> 2) + 32 * i;
          xrow[i] = r < t.rows ? (uint32_t)__ldg(a.src + t.row0 + r) *
                                     (uint32_t)a.k : 0u;
        }
      }
      for (int ks = 0; ks < stages; ++ks, ++it) {
        const int st = it % kStages;
        mbar_wait(s.empty + 8 * st, ((uint32_t)(it / kStages) & 1) ^ 1);
        const int k0 = ks * kBK;
        const uint32_t full = s.full + 8 * st;
        const uint32_t rows = s.rows + st * kRowBytes;
        const uint32_t code = s.code + st * kCodeBytes;
        if (tid == 0) {
          const float sc0 = __ldg(a.s0 + srow + k0 / kScale);
          s.scales[2 * st] = sc0;
          s.scales[2 * st + 1] =
              NMAT == 2 ? __ldg(a.s1 + srow + k0 / kScale) : sc0;
          const int wrow = t.e * a.n + col0;
          if (NMAT == 2) {
            mbar_expect(full, kCodeBytes);
            tma_2d(code, &m0, k0, wrow, full);
            tma_2d(code + kCodeBytes / 2, &m1, k0, wrow, full);
          } else {
            mbar_expect(full, kCodeBytes + t.n * kBK * 2);
            tma_2d(code, &m0, k0, wrow, full);
            for (int b = 0; b < t.n; b += 64)
              tma_2d(rows + b * kBK * 2, &mh, k0, t.row0 + b, full);
          }
        }
        if (NMAT == 2) {
          // gathered rows: pieces 2 (tid % 4) and + 1 of rows tid / 4 +
          // 32 i, zero past the tile's pairs
#pragma unroll
          for (int i = 0; i < kTile / 32; ++i) {
            const int r = (tid >> 2) + 32 * i;
            if (r < t.n) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = 2 * (tid & 3) + h;
                cp16(rows + r * 128 + ((c ^ (r & 7)) << 4),
                     a.x + (size_t)xrow[i] + k0 + 8 * c, r < t.rows);
              }
            }
          }
          cp_arrive(full);
        }
      }
    }
    if (NMAT == 2) asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // -- consumers -------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    AFrag f;
    {
      // the lane's ldmatrix row: matrices lane / 8 = (rows g | rows g + 8)
      // x (step 2h | 2h + 1). gate_up: rows g are Wg's columns 32 c + 8 warp
      // + g of the tile, rows g + 8 the same columns of Wu (the second half
      // of the code stage); down: rows 64 c + 16 warp + (0 | 8) + g
      const int hi = (lane >> 3) & 1, i8 = lane & 7;
      const int row = NMAT == 2 ? 32 * c + 8 * warp + i8
                                : 64 * c + 16 * warp + 8 * hi + i8;
      f.row_off = (NMAT == 2 ? hi * (kCodeBytes / 2) : 0) + row * kBK;
      f.swz = (uint32_t)((row >> 1) & 3);
    }
    const int q = lane & 3;
    f.src_lo = (lane & ~3) | (q >> 1);
    f.sel = (q & 1) ? 0x7632u : 0x5410u;
    int it = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const Tile t = tile_at(a, i, blocks);
      if (t.rows <= 0) continue;
      switch (t.n) {
        case 64: consume<64, NMAT>(a, s, f, t, it, c, warp, lane); break;
        case 128: consume<128, NMAT>(a, s, f, t, it, c, warp, lane); break;
        case 192: consume<192, NMAT>(a, s, f, t, it, c, warp, lane); break;
        default: consume<256, NMAT>(a, s, f, t, it, c, warp, lane); break;
      }
    }
  }
}

// -- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, reached through the runtime (no link
// against the driver library)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D map over a row-major (rows, cols) array, boxes of (box_rows,
// box_cols)
int map_2d(CUtensorMap* m, CUtensorMapDataType type, int elem_bytes,
           const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
           uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (uint64_t)elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(m, type, 2, const_cast<void*>(ptr), dims, strides,
                         box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NMAT>
int launch(const Args& a, const CUtensorMap& m0, const CUtensorMap& m1,
           const CUtensorMap& mh, int grid, cudaStream_t stream) {
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
  kernel<<<grid, kThreads, smem_bytes<NMAT>(), stream>>>(a, m0, m1, mh);
  return (int)cudaGetLastError();
}

bool shape_ok(int n_experts, int n, int k, int n_pairs, int grid, int cols) {
  return n_experts > 0 && n > 0 && k > 0 && n % cols == 0 &&
         n % kScale == 0 && k % kScale == 0 && n_pairs > 0 && grid > 0;
}

}  // namespace

extern "C" {

// x (T, D) bf16; src / offsets / counts / tile_start / walk int32; wg, wu
// (E, F, D) e4m3; sg, su (E, F / 128, D / 128) f32; h (P, F) bf16. grid:
// the blocks (at most one an SM: each walks the tile list).
int grouped_gemm_gate_up_launch(const void* x, const void* src,
                                const void* offsets, const void* counts,
                                const void* tile_start, const void* walk,
                                const void* wg, const void* wu,
                                const void* sg, const void* su, void* h,
                                int n_experts, int f, int d, int n_pairs,
                                int grid, void* stream) {
  if (!shape_ok(n_experts, f, d, n_pairs, grid, tile_cols<2>()))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m0, m1, mh = {};
  int err = map_2d(&m0, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wg,
                   (uint64_t)n_experts * f, d, tile_cols<2>(), kBK,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = map_2d(&m1, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wu,
                 (uint64_t)n_experts * f, d, tile_cols<2>(), kBK,
                 CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  Args a{(const __nv_bfloat16*)x, (const int*)src, (const int*)offsets,
         (const int*)counts, (const int*)tile_start, (const int*)walk,
         (const float*)sg, (const float*)su, nullptr, nullptr,
         (__nv_bfloat16*)h, nullptr, nullptr, n_experts, f, d};
  return launch<2>(a, m0, m1, mh, grid, (cudaStream_t)stream);
}

// h (P, F) bf16 rows in expert order; wd (E, D, F) e4m3; sd (E, D / 128,
// F / 128) f32; pair_w (P,) f32 and dst (P,) int32 in expert order; y
// (P, D) bf16, row dst[p] written from sorted row p; stored (int64, or
// null) gains the rows each tile stored; shapes ((4,) int64, or null) the
// row tiles at N = 64, 128, 192 and 256.
int grouped_gemm_down_launch(const void* h, const void* offsets,
                             const void* counts, const void* tile_start,
                             const void* walk, const void* wd,
                             const void* sd, const void* pair_w,
                             const void* dst, void* y, void* stored,
                             void* shapes, int n_experts, int d, int f,
                             int n_pairs, int grid, void* stream) {
  if (!shape_ok(n_experts, d, f, n_pairs, grid, tile_cols<1>()))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m0, mh;
  int err = map_2d(&m0, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wd,
                   (uint64_t)n_experts * d, f, tile_cols<1>(), kBK,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = map_2d(&mh, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h,
                 (uint64_t)n_pairs, f, 64, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  Args a{nullptr, nullptr, (const int*)offsets, (const int*)counts,
         (const int*)tile_start, (const int*)walk, (const float*)sd, nullptr,
         (const float*)pair_w, (const int*)dst, (__nv_bfloat16*)y,
         (unsigned long long*)stored, (unsigned long long*)shapes, n_experts,
         d, f};
  return launch<1>(a, m0, m0, mh, grid, (cudaStream_t)stream);
}

// out[0..4): the kernel's registers a thread (at launch; the warpgroups
// then split them 40 / 232 / 232), its dynamic shared memory a block, its
// local (spilled) bytes a thread and its threads a block. nmat: 2 gate_up,
// 1 down.
int grouped_gemm_info(int nmat, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t e = nmat == 2
      ? cudaFuncGetAttributes(&attr, grouped_gemm_kernel<2>)
      : cudaFuncGetAttributes(&attr, grouped_gemm_kernel<1>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = nmat == 2 ? smem_bytes<2>() : smem_bytes<1>();
  out[2] = (int)attr.localSizeBytes;
  out[3] = kThreads;
  return 0;
}

const char* grouped_gemm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
