// The wgmma GEMM mainloop for Hopper (sm_90a): one block's BM x BN output
// tiles of out = epilogue(a @ b), fed by TMA into a ring of shared-memory
// stages on mbarriers and multiplied by warpgroup wgmma. Every GEMM of the
// port's tensor cores is built on it: the 8-bit matmul (matmul8.cu: M1's
// fp8 and int8 cases, M2), the 16-bit and f32 matmul (matmul.cu: M1's bf16,
// f16 and f32 cases) and the per-expert GEMM (expert_matmul.cu: E1 bf16).
//
// - A stage holds 128 bytes of K (one 128-byte swizzle row: 128 8-bit, 64
//   16-bit or 32 f32 elements) of BM rows of A and BN columns of B, as TMA
//   writes them with CU_TENSOR_MAP_SWIZZLE_128B (hopper.cuh's layout). A
//   is K-major: one panel of BM rows x 128 bytes. B given as (N, K) is
//   K-major too: one panel of BN rows. B given as (K, N) (16-bit only) is
//   MN-major: BN / 64 panels of 64 rows of K x 64 columns (128 bytes),
//   which the 16-bit wgmma reads with its transpose bit.
// - The block is warp-specialised: one thread of the producer warpgroup
//   walks the block's tiles and issues every copy of every stage
//   (wgmma_gemm_produce); two consumer warpgroups multiply and release a
//   stage to the producer as soon as they are done with it. setmaxnreg
//   moves the producer's registers to the consumers (24 / 240 of 384
//   threads). A consumer owns WM rows x WN columns of a tile: BM / 2 rows
//   and all BN columns, or, for BM 64, the 64 rows and half the columns.
// - int8 runs wgmma m64n128k32.s32.s8.s8 on both operands in shared memory
//   (four k32 steps a stage), all of K in the s32 accumulators (exact).
// - fp8 runs as f16 on wgmma m64n128k16.f32.f16.f16 (see its consumer
//   below for why): A converted in registers, B converted into f16 panels
//   in shared memory by the consumers.
// - bf16 and f16 run wgmma m64nNk16.f32 (N = WN: 64, 128 or 256) on both
//   operands in shared memory, four k16 steps a stage, f32 accumulators.
// - f32 runs as three TF32 products a k8 step (3xTF32, see its consumer
//   below): wgmma m64nNk8.f32.tf32.tf32 (N = WN: 32 or 128), A split in
//   registers, B split into two tf32 panels in shared memory by the
//   consumers, a stage's products summed in the wgmma accumulators and
//   added to f32 accumulators in registers.
// - Tiles come from a schedule. The 8-bit kernel takes one tile a block
//   (OneTile); the 16-bit and f32 kernels are persistent: at most 132
//   blocks (the H100's SMs), each walking the tiles of a schedule in a
//   static stride (block b takes tiles b, b + grid, ...), the ring running
//   on from one tile into the next, so a tile's epilogue overlaps the next
//   one's copies. M1's schedule (GemmTiles) walks groups of kRasterM row
//   tiles column by column, so that the blocks in flight share B's panels
//   in L2; E1's (expert_matmul.cu) walks only the live tiles.
// - The accumulators stay in registers (f32, s32 for int8) and the epilogue
//   (mma_tile.cuh's Epilogue: none, device scalars or a host scale) stores
//   them straight from there, except a 16-bit body's 16-bit output: a
//   consumer writes its tile to shared memory and hands it to TMA stores
//   (wgmma_gemm_store_tma), so that the writes drain while the next tile's
//   products run (stored from the registers, every block's writes came in
//   one burst and the tensor cores waited); a tile with rows that must not
//   be stored (E1's rows past counts[e]) stores its other rows from the
//   registers.
//
// K: a stage past the end of K (a 16-bit K that is a multiple of 32 but
// not of 64, an f32 K that is a multiple of 8 but not of 32) is
// zero-filled by the tensor map in both operands, and a product of zeros
// adds exactly 0 to every sum, so the ragged last stage needs no masking.
// 8-bit and TF32 wgmma have no transpose bit: both operands must be
// K-major, so 8-bit and f32 B given as (K, N) is transposed to (N, K)
// before the GEMM (matmul8.cu, matmul.cu).
#pragma once

#include "hopper.cuh"
#include "mma_tile.cuh"  // the operand tags and Epilogue

namespace cubecl {
namespace {

constexpr int kGemmThreads = 384;  // a producer warpgroup and two consumers
constexpr int kGemmKB = 128;       // bytes of K a stage holds
constexpr int kGemmMaxBlocks = 132;  // persistent blocks: the H100's SMs
constexpr int kRasterM = 8;        // row tiles of a raster group (M1)
constexpr int kPanel = 64 * kGemmKB;  // an MN-major B panel: 64 rows of K
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use

// the tile's shared memory for E-byte operands: the ring of stages, the
// B panels the consumers write (two buffers: fp8's two f16 panels of 64 k,
// f32's big and small tf32 panels, BN rows x 256 bytes a buffer either
// way) or the 16-bit route's output tile (BM x BN x 2 bytes, staged for its
// TMA stores), then the full and empty barriers of each stage, plus the
// slack that aligns the base to 1024 bytes. The 8-bit ring holds as many
// stages as 144 KiB hold, at most 5; the 16-bit and f32 ones as many as the
// rest of the block's 227 KiB holds, at most 6. ops/matmul.py's
// _matmul_smem repeats this arithmetic.
template <int BM, int BN, int E>
struct WgGemmTile {
  static_assert(E == 1 ? BM % 128 == 0 && BM <= 256 && BN == 128
                : E == 2 ? (BM == 64 || BM == 128 || BM == 256) &&
                               (BN == 128 || BN == 256) && BM * BN <= 32768
                         : (BM == 64 || BM == 128) && (BN == 64 || BN == 128),
                "tile");
  static constexpr int A_BYTES = BM * kGemmKB;
  static constexpr int STAGE = A_BYTES + BN * kGemmKB;
  static constexpr int MAX_STAGES = E == 1 ? 5 : 6;
  static constexpr int OUT_BYTES = E == 2 ? BM * BN * 2 : 0;
  static constexpr int F16B_BYTES = E == 2 ? 0 : BN * 2 * kGemmKB;
  static constexpr int RING =
      E == 1 ? 144 * 1024
             : kSmemMax - 1024 - 2 * MAX_STAGES * 8 - OUT_BYTES -
                   2 * F16B_BYTES;
  static constexpr int STAGES =
      RING / STAGE < MAX_STAGES ? RING / STAGE : MAX_STAGES;
  static constexpr int F16B = STAGES * STAGE;   // the converted B panels
  static constexpr int OUT = F16B;              // the 16-bit output tile
  static constexpr int BAR = F16B + 2 * F16B_BYTES + OUT_BYTES;
  static constexpr int SMEM = BAR + 2 * STAGES * 8 + 1024;
  // a consumer's share of the tile
  static constexpr int WM = BM >= 128 ? BM / 2 : 64;
  static constexpr int WN = BM >= 128 ? BN : BN / 2;
  static constexpr int MI = WM / 64;  // m64 row blocks of a consumer
};

// -- the instructions --------------------------------------------------------

#define CUBECL_WG_F(i) "+f"(d[i])
#define CUBECL_WG_I(i) "+r"(d[i])
#define CUBECL_WG_8(C, i)                                                  \
  C(i), C(i + 1), C(i + 2), C(i + 3), C(i + 4), C(i + 5), C(i + 6), C(i + 7)
#define CUBECL_WG_32(C, o)                                                 \
  CUBECL_WG_8(C, o), CUBECL_WG_8(C, o + 8), CUBECL_WG_8(C, o + 16),        \
      CUBECL_WG_8(C, o + 24)
#define CUBECL_WG_16(C) CUBECL_WG_8(C, 0), CUBECL_WG_8(C, 8)
#define CUBECL_WG_64(C) CUBECL_WG_32(C, 0), CUBECL_WG_32(C, 32)
#define CUBECL_WG_128(C) CUBECL_WG_64(C), CUBECL_WG_32(C, 64), \
                         CUBECL_WG_32(C, 96)
#define CUBECL_WG_R16                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define CUBECL_WG_R32 CUBECL_WG_R16                                        \
  ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "    \
  "%29, %30, %31"
#define CUBECL_WG_R64 CUBECL_WG_R32                                        \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "    \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, " \
  "%59, %60, %61, %62, %63"
#define CUBECL_WG_R128 CUBECL_WG_R64                                       \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "    \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "  \
  "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "     \
  "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "     \
  "%126, %127"

// d (64 x 128, s32) += A (64 x 32 s8) . B (32 x 128 s8), both K-major in
// shared memory (descriptors da, db): exact
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
               CUBECL_WG_R64 "}, %64, %65, p;\n}\n"
               : CUBECL_WG_64(CUBECL_WG_I)
               : "l"(da), "l"(db), "r"(1));
}
// d (64 x 128, f32) += A (64 x 16 f16 in registers) . B (16 x 128 f16,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_f16_rs_n128(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
               CUBECL_WG_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
               : CUBECL_WG_64(CUBECL_WG_F)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N, f32) += A (64 x 16, K-major) . B (16 x N; K-major, or
// MN-major when TB: the transpose bit), both 16-bit of the tag's type in
// shared memory (descriptors da, db); N = 2 x the accumulators a thread.
// The operands after d: da, db, the scale-d predicate's register, TB.
#define CUBECL_WG16(T, PTX, N, OUTS, REGS, NEXT)                           \
  template <bool TB>                                                        \
  __device__ __forceinline__ void wgmma_ss(T, float (&d)[N / 2],           \
                                           uint64_t da, uint64_t db) {     \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" NEXT(2) ", 0;\n"   \
                 " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX    \
                 " {" REGS "}, %" NEXT(0) ", %" NEXT(1) ", p, 1, 1, 0, %"  \
                 NEXT(3) ";\n}\n"                                           \
                 : OUTS                                                     \
                 : "l"(da), "l"(db), "r"(1), "n"(int(TB)));                 \
  }
#define CUBECL_AFTER16(i) CUBECL_AFTER16_##i
#define CUBECL_AFTER16_0 "16"
#define CUBECL_AFTER16_1 "17"
#define CUBECL_AFTER16_2 "18"
#define CUBECL_AFTER16_3 "19"
#define CUBECL_AFTER16_4 "20"
#define CUBECL_AFTER16_5 "21"
#define CUBECL_AFTER32(i) CUBECL_AFTER32_##i
#define CUBECL_AFTER32_0 "32"
#define CUBECL_AFTER32_1 "33"
#define CUBECL_AFTER32_2 "34"
#define CUBECL_AFTER32_3 "35"
#define CUBECL_AFTER32_4 "36"
#define CUBECL_AFTER32_5 "37"
#define CUBECL_AFTER64(i) CUBECL_AFTER64_##i
#define CUBECL_AFTER64_0 "64"
#define CUBECL_AFTER64_1 "65"
#define CUBECL_AFTER64_2 "66"
#define CUBECL_AFTER64_3 "67"
#define CUBECL_AFTER64_4 "68"
#define CUBECL_AFTER64_5 "69"
#define CUBECL_AFTER128(i) CUBECL_AFTER128_##i
#define CUBECL_AFTER128_0 "128"
#define CUBECL_AFTER128_1 "129"
#define CUBECL_AFTER128_2 "130"
#define CUBECL_AFTER128_3 "131"
#define CUBECL_AFTER128_4 "132"
#define CUBECL_AFTER128_5 "133"
#define CUBECL_WG16_TYPE(T, PTX)                                            \
  CUBECL_WG16(T, PTX, 64, CUBECL_WG_32(CUBECL_WG_F, 0), CUBECL_WG_R32,     \
              CUBECL_AFTER32)                                               \
  CUBECL_WG16(T, PTX, 128, CUBECL_WG_64(CUBECL_WG_F), CUBECL_WG_R64,       \
              CUBECL_AFTER64)                                               \
  CUBECL_WG16(T, PTX, 256, CUBECL_WG_128(CUBECL_WG_F), CUBECL_WG_R128,     \
              CUBECL_AFTER128)
CUBECL_WG16_TYPE(BF16, "bf16.bf16")
CUBECL_WG16_TYPE(F16, "f16.f16")
#undef CUBECL_WG16_TYPE

// d (64 x N, f32) = A (64 x 8, tf32) . B (8 x N, tf32, K-major in shared
// memory: descriptor db) + d, or + 0 when acc is 0; N = 2 x the
// accumulators a thread. A in registers (RS): a[0..3] are A's rows g, g +
// 8, g, g + 8 and columns t, t, t + 4, t + 4 of the warp's 16 rows (g =
// lane / 4, t = lane % 4); or A K-major in shared memory (SS: descriptor
// da). TF32 has no transpose bit. A tf32 operand is an f32 bit pattern
// whose low 13 bits are zero.
#define CUBECL_TF32(N, OUTS, REGS, NEXT)                                   \
  __device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],            \
                                             const uint32_t (&a)[4],       \
                                             uint64_t db, int acc = 1) {   \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" NEXT(5) ", 0;\n"   \
                 " wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k8.f32.tf32.tf32 {" REGS "}, {%" NEXT(0) ", %" NEXT(1)   \
                 ", %" NEXT(2) ", %" NEXT(3) "}, %" NEXT(4) ", p, 1, 1;\n}\n" \
                 : OUTS                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                   "r"(acc));                                               \
  }                                                                         \
  __device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],            \
                                             uint64_t da, uint64_t db,     \
                                             int acc = 1) {                \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" NEXT(2) ", 0;\n"   \
                 " wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k8.f32.tf32.tf32 {" REGS "}, %" NEXT(0) ", %" NEXT(1)    \
                 ", p, 1, 1;\n}\n"                                          \
                 : OUTS                                                     \
                 : "l"(da), "l"(db), "r"(acc));                            \
  }
CUBECL_TF32(32, CUBECL_WG_16(CUBECL_WG_F), CUBECL_WG_R16, CUBECL_AFTER16)
CUBECL_TF32(64, CUBECL_WG_32(CUBECL_WG_F, 0), CUBECL_WG_R32, CUBECL_AFTER32)
CUBECL_TF32(128, CUBECL_WG_64(CUBECL_WG_F), CUBECL_WG_R64, CUBECL_AFTER64)
CUBECL_TF32(256, CUBECL_WG_128(CUBECL_WG_F), CUBECL_WG_R128,
            CUBECL_AFTER128)
#undef CUBECL_TF32
#undef CUBECL_AFTER128_5
#undef CUBECL_AFTER128_4
#undef CUBECL_AFTER128_3
#undef CUBECL_AFTER128_2
#undef CUBECL_AFTER128_1
#undef CUBECL_AFTER128_0
#undef CUBECL_AFTER128
#undef CUBECL_AFTER64_5
#undef CUBECL_AFTER64_4
#undef CUBECL_AFTER64_3
#undef CUBECL_AFTER64_2
#undef CUBECL_AFTER64_1
#undef CUBECL_AFTER64_0
#undef CUBECL_AFTER64
#undef CUBECL_AFTER32_5
#undef CUBECL_AFTER32_4
#undef CUBECL_AFTER32_3
#undef CUBECL_AFTER32_2
#undef CUBECL_AFTER32_1
#undef CUBECL_AFTER32_0
#undef CUBECL_AFTER32
#undef CUBECL_AFTER16_5
#undef CUBECL_AFTER16_4
#undef CUBECL_AFTER16_3
#undef CUBECL_AFTER16_2
#undef CUBECL_AFTER16_1
#undef CUBECL_AFTER16_0
#undef CUBECL_AFTER16
#undef CUBECL_WG16
#undef CUBECL_WG_R128
#undef CUBECL_WG_R64
#undef CUBECL_WG_R32
#undef CUBECL_WG_R16
#undef CUBECL_WG_128
#undef CUBECL_WG_64
#undef CUBECL_WG_32
#undef CUBECL_WG_16
#undef CUBECL_WG_8
#undef CUBECL_WG_I
#undef CUBECL_WG_F

// two fp8 values (the low one in the low byte) -> two f16, exactly (every
// e4m3 and e5m2 value is an f16 value)
__device__ __forceinline__ uint32_t f16x2_of(E4M3, uint32_t v) {
  uint32_t d;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(d) : "h"(uint16_t(v)));
  return d;
}
__device__ __forceinline__ uint32_t f16x2_of(E5M2, uint32_t v) {
  uint32_t d;
  asm("cvt.rn.f16x2.e5m2x2 %0, %1;\n" : "=r"(d) : "h"(uint16_t(v)));
  return d;
}

// the two consumer warpgroups' barrier (the producer's threads have left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// at most one committed wgmma group still in flight
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keep reads of the accumulators after the wait that completes them
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void acc_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// acc += part, after the wait that completes part's group (ordinary f32
// additions, rounded to nearest)
template <int MI, int N>
__device__ __forceinline__ void acc_fence_add(float (&acc)[MI][N],
                                              float (&part)[MI][N]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    acc_fence(part[mi]);
#pragma unroll
    for (int j = 0; j < N; ++j) acc[mi][j] += part[mi][j];
  }
}

// -- schedules: which tiles a block computes ---------------------------------

// a tile: the operands' coordinates (z: the third axis of both tensor maps,
// m0: A's first row, n0: B's first column) and its rows of the output
// (from crow0; rows at or past row_end are not stored)
struct GemmJob {
  int z, m0, n0;
  int64_t crow0, row_end;
};

// one tile a block, by blockIdx (the 8-bit kernel's grid of N / BN x M /
// BM blocks)
template <int BM, int BN>
struct OneTile {
  __device__ __forceinline__ bool get(int t, GemmJob& j) const {
    if (t != static_cast<int>(blockIdx.x)) return false;
    j.z = 0;
    j.m0 = blockIdx.y * BM;
    j.n0 = blockIdx.x * BN;
    j.crow0 = j.m0;
    j.row_end = 0;  // unused: every row is stored
    return true;
  }
};

// M1's tiles, tm x tn of them: tile t lies in raster group t / (kRasterM
// tn), whose kRasterM row tiles (fewer in the last group) it walks column
// by column
template <int BM, int BN>
struct GemmTiles {
  int tm, tn;
  __device__ __forceinline__ bool get(int t, GemmJob& j) const {
    if (t >= tm * tn) return false;
    const int g = t / (kRasterM * tn), first = g * kRasterM;
    const int rows = min(kRasterM, tm - first);
    const int r = t - g * kRasterM * tn;
    j.z = 0;
    j.m0 = (first + r % rows) * BM;
    j.n0 = (r / rows) * BN;
    j.crow0 = j.m0;
    j.row_end = 0;  // unused: every row is stored
    return true;
  }
};

// -- the producer: one thread keeps the ring full ------------------------

// A ring position: stage st of the ring, in its phase-th use modulo 2.
template <int STAGES>
struct RingPos {
  int st = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++st == STAGES) {
      st = 0;
      phase ^= 1;
    }
  }
};

// For every tile of the schedule that block blockIdx.x walks, and every kt
// < KT: stage (the ring's next) gets A rows [m0, m0 + BM) and B columns
// [n0, n0 + BN) of K bytes [kt * 128, kt * 128 + 128) of slice z. ta maps A
// as (z, rows, K bytes) in boxes of BM rows x 128 bytes; tb maps B as (z,
// N, K bytes) in boxes of BN rows x 128 bytes (K-major), or, when BMN, as
// (z, K, N bytes) in boxes of 64 rows x 128 bytes (MN-major; E-byte
// elements, so a stage holds 128 / E rows of K).
template <int BM, int BN, int E, bool BMN, typename Sched>
__device__ __forceinline__ void wgmma_gemm_produce(
    uint8_t* smem, uint64_t* full, uint64_t* empty, const CUtensorMap* ta,
    const CUtensorMap* tb, Sched sched, int KT) {
  using L = WgGemmTile<BM, BN, E>;
  tma_prefetch_map(ta);
  tma_prefetch_map(tb);
  RingPos<L::STAGES> pos;
  GemmJob j;
  for (int t = blockIdx.x; sched.get(t, j); t += gridDim.x) {
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&empty[pos.st], pos.phase ^ 1);  // the first round passes
      mbar_expect_tx(&full[pos.st], L::STAGE);
      uint8_t* s = smem + pos.st * L::STAGE;
      tma_load_3d(s, ta, &full[pos.st], kt * kGemmKB, j.m0, j.z);
      if constexpr (BMN) {
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          tma_load_3d(s + L::A_BYTES + p * kPanel, tb, &full[pos.st],
                      (j.n0 + 64 * p) * E, kt * (kGemmKB / E), j.z);
      } else {
        tma_load_3d(s + L::A_BYTES, tb, &full[pos.st], kt * kGemmKB, j.n0,
                    j.z);
      }
      pos.advance();
    }
  }
}

// -- a consumer warpgroup: its BM / 2 rows over all of K ------------------

// int8: acc[mi] is the m64 x 128 s32 tile of rows wg * BM / 2 + 64 mi of
// the block; all of K runs in the wgmma accumulators (exact), one group
// in flight: a stage is released when the group after it has been issued
// and its own has completed.
template <int BM, int BN>
__device__ __forceinline__ void wgmma_gemm_consume(
    S8, uint8_t* smem, uint64_t* full, uint64_t* empty, int wg, int KT,
    int (&acc)[WgGemmTile<BM, BN, 1>::MI][64]) {
  using L = WgGemmTile<BM, BN, 1>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[mi][j] = 0;
  int st = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(&full[st], phase);
    const uint32_t a_s =
        smem_addr(smem + st * L::STAGE) + wg * (BM / 2) * kGemmKB;
    const uint32_t b_s = smem_addr(smem + st * L::STAGE + L::A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kGemmKB / 32; ++ks)
#pragma unroll
      for (int mi = 0; mi < L::MI; ++mi)
        wgmma_s8_n128(acc[mi],
                      sw128_desc(a_s + mi * 64 * kGemmKB + ks * 32, 16, 1024),
                      sw128_desc(b_s + ks * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait1();  // the group of stage kt - 1 has completed
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = st;
    if (++st == L::STAGES) {
      st = 0;
      phase ^= 1;
    }
  }
  wgmma_wait0();
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi) acc_fence(acc[mi]);
}

// fp8 (T = E4M3 or E5M2): the values run as f16 on the 16-bit wgmma, with
// f32 accumulators. The 8-bit wgmma keeps too few bits in its sums for the
// f32 results this GEMM owes (on the H100 its f32 outputs missed the port's
// 2e-5 / 1e-4 even with each k32 step's sum added into f32 registers);
// fp8 values are exact in f16, and the 16-bit wgmma sums in f32. A k16
// step reads 16 bytes of K of each operand: the step's 16 values are taken
// in the order pi = (0 1 4 5 8 9 12 13 2 3 6 7 10 11 14 15) of the bytes,
// the same for A and B, which leaves the sum unchanged and lets one
// ldmatrix of the fp8 rows give a thread its A fragment:
// - A: ldmatrix.x4 of two 16-byte chunks of 16 rows; each 32-bit word of
//   4 bytes (k 4t..4t+3) converts to the f16 pairs of logical k 2t and
//   2t + 8, straight into the wgmma's register fragment;
// - B: the consumers convert the stage's 128 x 128 fp8 B into f16 in
//   shared memory (two K-major 128-byte-swizzled panels of 64 k, in logical
//   order), double-buffered so that one stage's conversion overlaps the
//   previous stage's products.
// acc[mi] is the m64 x 128 f32 tile of rows wg * BM / 2 + 64 mi.
template <int BM, int BN, typename T>
__device__ __forceinline__ void wgmma_gemm_consume(
    T, uint8_t* smem, uint64_t* full, uint64_t* empty, int wg, int KT,
    float (&acc)[WgGemmTile<BM, BN, 1>::MI][64]) {
  using L = WgGemmTile<BM, BN, 1>;
  const int tid = threadIdx.x - 128;  // 0..255 over both consumers
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[mi][j] = 0.f;
  int st = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(&full[st], phase);
    const uint8_t* stage = smem + st * L::STAGE;
    // 1. B, fp8 [n][k] -> f16 panels [k / 64][n][k % 64], this thread's
    //    16-byte chunks; the panels of kt - 2 are free (their group was
    //    waited for before the last barrier)
    uint8_t* fb = smem + L::F16B + (kt & 1) * L::F16B_BYTES;
#pragma unroll
    for (int i = tid; i < BN * kGemmKB / 16; i += 256) {
      const int n = i / 8, c = i % 8, sw = n & 7;
      const uint4 x = *reinterpret_cast<const uint4*>(
          stage + L::A_BYTES + n * kGemmKB + ((c ^ sw) << 4));
      const uint4 lo = make_uint4(f16x2_of(T{}, x.x), f16x2_of(T{}, x.y),
                                  f16x2_of(T{}, x.z), f16x2_of(T{}, x.w));
      const uint4 hi =
          make_uint4(f16x2_of(T{}, x.x >> 16), f16x2_of(T{}, x.y >> 16),
                     f16x2_of(T{}, x.z >> 16), f16x2_of(T{}, x.w >> 16));
      uint8_t* row = fb + (c / 4) * BN * kGemmKB + n * kGemmKB;
      const int ch = 2 * (c % 4);
      *reinterpret_cast<uint4*>(row + ((ch ^ sw) << 4)) = lo;
      *reinterpret_cast<uint4*>(row + (((ch + 1) ^ sw) << 4)) = hi;
    }
    // 2. the previous group has completed: the A registers are free
    wgmma_wait0();
    // 3. A fragments, 8 k16 steps of each m64 block
    uint32_t af[L::MI][8][4];
    const uint32_t a_s = smem_addr(stage) + wg * (BM / 2) * kGemmKB;
#pragma unroll
    for (int mi = 0; mi < L::MI; ++mi) {
      const int row = mi * 64 + warp * 16 + (lane & 15);
#pragma unroll
      for (int s2 = 0; s2 < 4; ++s2) {
        uint32_t r[4];
        ldsm_x4(r, a_s + row * kGemmKB +
                       (((2 * s2 + (lane >> 4)) ^ (row & 7)) << 4));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t(&a)[4] = af[mi][2 * s2 + h];
          a[0] = f16x2_of(T{}, r[2 * h]);
          a[1] = f16x2_of(T{}, r[2 * h + 1]);
          a[2] = f16x2_of(T{}, r[2 * h] >> 16);
          a[3] = f16x2_of(T{}, r[2 * h + 1] >> 16);
        }
      }
    }
    // 4. this warp is done with the fp8 stage. Its reads of the stage
    //    (ldmatrix of A, the B chunks) are the generic proxy's and the
    //    producer's next copy into it is the async proxy's: the proxy fence
    //    orders them before the arrive that lets the copy start (it also
    //    publishes the f16 B stores to the wgmma below). With the arrive
    //    first, a copy could overwrite A rows that an ldmatrix had not
    //    read yet: on the H100, rows of one warp were wrong in 1-2% of the
    //    256 x 128 tile's launches.
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    // 5. every consumer's share of the f16 B is in place
    consumers_sync();
    const uint32_t b_s = smem_addr(fb);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint64_t db = sw128_desc(
          b_s + (s / 4) * BN * kGemmKB + (s % 4) * 32, 16, 1024);
#pragma unroll
      for (int mi = 0; mi < L::MI; ++mi)
        wgmma_f16_rs_n128(acc[mi], af[mi][s], db);
    }
    wgmma_commit();
    if (++st == L::STAGES) {
      st = 0;
      phase ^= 1;
    }
  }
  wgmma_wait0();
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi) acc_fence(acc[mi]);
}

// bf16 / f16 (T = BF16 or F16), one tile: acc[mi] is the m64 x WN f32
// tile of the consumer's rows 64 mi; a_off and b_off are the consumer's
// offsets into a stage's A and B. The ring position `pos` runs on from the
// previous tile. One group in flight, as int8's: a stage is released when
// the group after it has been issued and its own has completed; the tile's
// last stage when all its groups have.
template <int BM, int BN, bool BMN, typename T>
__device__ __forceinline__ void wgmma_gemm_consume16(
    T, uint8_t* smem, uint64_t* full, uint64_t* empty, int a_off, int b_off,
    int KT, RingPos<WgGemmTile<BM, BN, 2>::STAGES>& pos,
    float (&acc)[WgGemmTile<BM, BN, 2>::MI][WgGemmTile<BM, BN, 2>::WN / 2]) {
  using L = WgGemmTile<BM, BN, 2>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
    for (int j = 0; j < L::WN / 2; ++j) acc[mi][j] = 0.f;
  int prev = 0;
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(&full[pos.st], pos.phase);
    const uint32_t a_s = smem_addr(smem + pos.st * L::STAGE) + a_off;
    const uint32_t b_s = smem_addr(smem + pos.st * L::STAGE + L::A_BYTES) +
                         b_off;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kGemmKB / 32; ++ks) {
      // K-major: the k16 step is 32 bytes along the swizzled rows; MN-major:
      // 16 rows of K (2048 bytes) down a panel, panels kPanel apart
      const uint64_t db = BMN ? sw128_desc(b_s + ks * 2048, kPanel, 1024)
                              : sw128_desc(b_s + ks * 32, 16, 1024);
#pragma unroll
      for (int mi = 0; mi < L::MI; ++mi)
        wgmma_ss<BMN>(T{}, acc[mi],
                      sw128_desc(a_s + mi * 64 * kGemmKB + ks * 32, 16, 1024),
                      db);
    }
    wgmma_commit();
    wgmma_wait1();  // the group of stage kt - 1 has completed
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = pos.st;
    pos.advance();
  }
  wgmma_wait0();
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi) acc_fence(acc[mi]);
}

// f32 (3xTF32), one tile: out = a @ b in f32 from three TF32 products a
// k8 step. One TF32 product keeps 10 mantissa bits of each operand and
// misses f32's 2e-5 / 1e-4 by far; with each operand split into big = x
// truncated to tf32 and small = tf32(x - big) (tf32_split), A_small B_big +
// A_big B_small + A_big B_big drops only A_small B_small (at most 2^-20 of
// a product): as close to
// the float64 product as an f32 FMA loop is (the TPU kernel runs f32 at
// Precision.HIGHEST, several bf16 passes on its matrix unit, for the same
// reason). The tensor cores' f32 sums round toward zero: kept in the
// wgmma accumulators over all of K they drift out of f32's 2e-5 / 1e-4 on
// the H100 (a build that kept them so failed the f32 card checks at K
// 4096: tests/test_torch_cuda.py, chip_smoke.py's phase m). So each
// stage's twelve products go into `part`, started from zero, and
// part is added to the f32 accumulator `acc` by ordinary (round to
// nearest) additions once the stage's group has completed: the drift is
// a stage's, on sums of 32 products. TF32 wgmma has no transpose bit, so
// both operands are K-major. Each landed stage:
// - B: the consumers split the stage's BN x 32 f32 into a big and a small
//   tf32 panel in shared memory, each 16-byte chunk at the same swizzled
//   offset it had (the layout does not change), double-buffered so that
//   one stage's split overlaps the previous stage's products;
// - A: ldmatrix.x4 of the stage's 32-byte k8 column gives a thread its
//   four f32 of the step in the RS fragment's order (each 32-bit word of
//   an 8 x 8 b16 matrix is one f32: row lane / 4, column lane % 4), split
//   in registers; all four k8 steps' halves stay live until their group
//   completes;
// - the stage is released after the proxy fence (F11's order, as fp8's),
//   the consumers meet at a barrier (every share of B split), and each
//   k8 step issues A_small B_big, A_big B_small, then A_big B_big into
//   part, one group a stage.
// acc[mi] is the m64 x WN f32 tile of the consumer's rows 64 mi (part's
// registers beside it: at most 64 each, so BM x BN is at most 128 x 128);
// a_off and b_off its offsets into a stage's A and into a B panel; `pos`
// and `panel` (the B panel buffer next written) run on from the previous
// tile.
template <int BM, int BN>
__device__ __forceinline__ void wgmma_gemm_consume_tf32x3(
    uint8_t* smem, uint64_t* full, uint64_t* empty, int a_off, int b_off,
    int KT, RingPos<WgGemmTile<BM, BN, 4>::STAGES>& pos, int& panel,
    float (&acc)[WgGemmTile<BM, BN, 4>::MI][WgGemmTile<BM, BN, 4>::WN / 2]) {
  using L = WgGemmTile<BM, BN, 4>;
  constexpr int PB = BN * kGemmKB;  // a panel: the small one follows the big
  const int tid = threadIdx.x - 128;  // 0..255 over both consumers
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float part[L::MI][L::WN / 2];
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
    for (int j = 0; j < L::WN / 2; ++j) acc[mi][j] = part[mi][j] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(&full[pos.st], pos.phase);
    const uint8_t* stage = smem + pos.st * L::STAGE;
    // 1. B's split, this thread's 16-byte chunks; the buffer's last reader
    //    (the group of two stages ago) was waited for before the last
    //    barrier
    uint8_t* pb = smem + L::F16B + panel * L::F16B_BYTES;
#pragma unroll
    for (int i = tid; i < PB / 16; i += 256) {
      uint4 big, small;
      tf32_split4(*reinterpret_cast<const uint4*>(stage + L::A_BYTES + 16 * i),
                  big, small);
      *reinterpret_cast<uint4*>(pb + 16 * i) = big;
      *reinterpret_cast<uint4*>(pb + PB + 16 * i) = small;
    }
    // 2. the previous group has completed: its part joins acc, and the A
    //    registers are free
    wgmma_wait0();
    acc_fence_add(acc, part);
    // 3. A's halves, 4 k8 steps of each m64 block
    uint32_t ab[L::MI][4][4], as[L::MI][4][4];
    const uint32_t a_s = smem_addr(stage) + a_off;
#pragma unroll
    for (int mi = 0; mi < L::MI; ++mi) {
      const int row = mi * 64 + warp * 16 + (lane & 15);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t r[4];
        ldsm_x4(r, a_s + row * kGemmKB +
                       (((2 * s + (lane >> 4)) ^ (row & 7)) << 4));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tf32_split(r[j], ab[mi][s][j], as[mi][s][j]);
      }
    }
    // 4. this warp is done with the stage: fence, then release (F11)
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[pos.st]);
    // 5. every consumer's share of B is split
    consumers_sync();
    const uint32_t b_s = smem_addr(pb) + b_off;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t big = sw128_desc(b_s + s * 32, 16, 1024);
      const uint64_t small = sw128_desc(b_s + PB + s * 32, 16, 1024);
#pragma unroll
      for (int mi = 0; mi < L::MI; ++mi) {
        wgmma_tf32(part[mi], as[mi][s], big, s);  // s 0: part from zero
        wgmma_tf32(part[mi], ab[mi][s], small);
        wgmma_tf32(part[mi], ab[mi][s], big);
      }
    }
    wgmma_commit();
    panel ^= 1;
    pos.advance();
  }
  wgmma_wait0();
  acc_fence_add(acc, part);
}

// Store a consumer's tile through the epilogue: c has rows of N elements,
// row0 is the consumer's first row, n0 its first column; when BOUNDED,
// rows at or past row_end are skipped.
template <bool BOUNDED, int MI, int NR, typename Acc>
__device__ __forceinline__ void wgmma_gemm_store(const Epilogue& ep, void* c,
                                                 int64_t row0,
                                                 int64_t row_end, int N,
                                                 int n0,
                                                 const Acc (&acc)[MI][NR]) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int64_t row = row0 + mi * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < NR / 4; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (!BOUNDED || row < row_end)
        ep.store2(c, row * N + col, acc[mi][4 * j], acc[mi][4 * j + 1]);
      if (!BOUNDED || row + 8 < row_end)
        ep.store2(c, (row + 8) * N + col, acc[mi][4 * j + 2],
                  acc[mi][4 * j + 3]);
    }
  }
}

// two f32 -> one word of two 16-bit values of out_dtype (kBF16 or kF16),
// rounded to nearest even, the first in the low half
__device__ __forceinline__ uint32_t pack16(int out_dtype, float lo,
                                           float hi) {
  if (out_dtype == kBF16) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- TMA stores ----------------------------------------------------------

// one box of a 3-D tensor map from shared memory, in this thread's bulk
// group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's committed stores are done
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// one consumer warpgroup's barrier (2 + wg: 0 is __syncthreads, 1 the two
// consumers')
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// A consumer's 16-bit tile through shared memory and TMA stores, so that
// the consumers hand the output to the copy engine and go on to the next
// tile while it is written (stored from the registers, the writes of all
// blocks came in one burst and the tensor cores waited for them). The
// tile is staged in out (MI x WN / 64 boxes of 64 rows x 128 bytes, the
// 128-byte swizzle, as the map tc reads them) and stored at byte column
// col0, row row0, slice z of tc. The warpgroup's first thread issues the
// stores and, before the staging is written again, waits until they have
// read it.
template <int MI, int NR>
__device__ __forceinline__ void wgmma_gemm_store_tma(
    const Epilogue& ep, uint8_t* out, const CUtensorMap* tc, int col0,
    int row0, int z, int wg, const float (&acc)[MI][NR]) {
  constexpr int PANELS = NR / 32;  // 64-column boxes of a row block
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const bool leader = threadIdx.x % 128 == 0;
  if (leader) tma_store_wait_read();
  warpgroup_sync(wg);
  const float s = ep.scaled ? ep.s : 1.f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + lane / 4 + 8 * h;  // row of the box
#pragma unroll
      for (int j = 0; j < NR / 4; ++j) {
        uint8_t* box = out + (mi * PANELS + j / 8) * kPanel;
        *reinterpret_cast<uint32_t*>(
            box + r * kGemmKB + (((j % 8) ^ (r & 7)) << 4) + 4 * (lane % 4)) =
            pack16(ep.out_dtype, acc[mi][4 * j + 2 * h] * s,
                   acc[mi][4 * j + 2 * h + 1] * s);
      }
    }
  fence_proxy_async();
  warpgroup_sync(wg);
  if (leader) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
        tma_store_3d(tc, out + (mi * PANELS + p) * kPanel, col0 + 128 * p,
                     row0 + 64 * mi, z);
    tma_store_commit();
  }
}

// The GEMM body of a persistent block, 16-bit (T = BF16 or F16: M1's bf16
// / f16 kernels, E1 bf16) or f32 (T = TF32: M1's f32 kernels, 3xTF32,
// B K-major): every tile of `sched` that this block walks, KT stages
// each, into c (rows of N elements) through the epilogue. A 16-bit body's
// 16-bit output leaves by TMA stores through tc (c as (z, rows, N bytes)
// in boxes of 64 rows x 128 bytes) where all of a consumer's rows are
// stored; every other output (a tile with rows past row_end, an f32
// output, any output of the f32 body) from the registers. smem: the
// kernel's dynamic shared memory, WgGemmTile<BM, BN, T::E>::SMEM bytes.
template <typename T, int BM, int BN, bool BMN, bool BOUNDED, typename Sched>
__device__ __forceinline__ void wgmma_gemm(
    uint8_t* smem_raw, const CUtensorMap* ta, const CUtensorMap* tb,
    const CUtensorMap* tc, Sched sched, void* c, int N, int KT,
    int out_dtype, int scaled, const float* sa, const float* sb,
    float scale) {
  constexpr bool F32 = T::E == 4;
  static_assert(!(F32 && BMN), "TF32 wgmma reads K-major B only");
  using L = WgGemmTile<BM, BN, T::E>;
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + L::STAGES;
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0)
      wgmma_gemm_produce<BM, BN, T::E, BMN>(smem, full, empty, ta, tb, sched,
                                            KT);
    return;
  }
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128 - 1;
  // the consumer's rows and columns of a tile, and its offsets in a stage
  const int wm0 = BM >= 128 ? wg * L::WM : 0;
  const int wn0 = BM >= 128 ? 0 : wg * L::WN;
  const int a_off = wm0 * kGemmKB;
  const int b_off = BMN ? (wn0 / 64) * kPanel : wn0 * kGemmKB;
  const Epilogue ep = make_epilogue(out_dtype, scaled, sa, sb, scale);
  RingPos<L::STAGES> pos;
  int panel = 0;  // the f32 body's next B panel buffer
  float acc[L::MI][L::WN / 2];
  GemmJob j;
  for (int t = blockIdx.x; sched.get(t, j); t += gridDim.x) {
    if constexpr (F32) {
      wgmma_gemm_consume_tf32x3<BM, BN>(smem, full, empty, a_off, b_off, KT,
                                        pos, panel, acc);
    } else {
      wgmma_gemm_consume16<BM, BN, BMN>(T{}, smem, full, empty, a_off, b_off,
                                        KT, pos, acc);
    }
    if constexpr (!F32) {
      if (out_dtype != kF32 &&
          (!BOUNDED || j.crow0 + wm0 + L::WM <= j.row_end)) {
        wgmma_gemm_store_tma(ep, smem + L::OUT + wg * L::WM * L::WN * 2, tc,
                             (j.n0 + wn0) * 2, j.m0 + wm0, j.z, wg, acc);
        continue;
      }
    }
    wgmma_gemm_store<BOUNDED>(ep, c, j.crow0 + wm0, j.row_end, N, j.n0 + wn0,
                              acc);
  }
  if (!F32 && threadIdx.x % 128 == 0) tma_store_wait();
}

// -- tensor maps (host) ----------------------------------------------------

// depth x rows x cols bytes (row-major, rows of `cols` bytes, slices of
// `rows` rows) as a tensor map of box_rows x 128-byte boxes with the
// 128-byte swizzle; bytes past cols, rows past rows, read as zeros
inline cudaError_t bytes_map(CUtensorMap* map, const void* base, int cols,
                             int rows, int box_rows, int depth = 1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols,
                                 (cuuint64_t)cols * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)kGemmKB, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cubecl
