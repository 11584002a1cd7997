// The wgmma GEMM mainloop for Hopper (sm_90a): one block's BM x 128 output
// tile of out = epilogue(a @ b^T), a (M, K) and b (N, K) both K-major, fed
// by TMA into a ring of shared-memory stages on mbarriers and multiplied by
// warpgroup wgmma. The 8-bit instances of the matmul (matmul8.cu: M1's fp8
// and int8 cases, M2) are built on it; the 16-bit GEMMs (M1's bf16/f16, E1)
// still run mma_tile.cuh.
//
// - A stage holds 128 bytes of K (one 128-byte swizzle row, 128 8-bit
//   elements) of BM rows of A and 128 rows of B, each a panel of rows x 128
//   bytes as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B (hopper.cuh's
//   layout).
// - The block is warp-specialised: one thread of the producer warpgroup
//   issues both copies of a stage; two consumer warpgroups own BM / 2 rows
//   each (one or two m64 x 128 wgmma tiles) and release a stage to the
//   producer as soon as they are done with it. setmaxnreg moves the
//   producer's registers to the consumers (24 / 240 of 384 threads).
// - int8 runs wgmma m64n128k32.s32.s8.s8 on both operands in shared memory
//   (four k32 steps a stage, descriptors 32 bytes apart in the row), all of
//   K in the s32 accumulators (exact), one group in flight.
// - fp8 runs as f16 on wgmma m64n128k16.f32.f16.f16 (see its consumer
//   below for why): A converted in registers, B converted into f16 panels
//   in shared memory by the consumers.
// - The accumulators stay in registers (f32, s32 for int8) and the epilogue
//   (mma_tile.cuh's Epilogue: none, device scalars or a host scale) stores
//   them straight from there.
//
// 8-bit wgmma has no transpose bit: both operands must be K-major, so B
// given as (K, N) is transposed to (N, K) before the GEMM (matmul8.cu).
#pragma once

#include "hopper.cuh"
#include "mma_tile.cuh"  // the operand tags (E4M3, E5M2, S8) and Epilogue

namespace cubecl {
namespace {

constexpr int kGemmThreads = 384;  // a producer warpgroup and two consumers
constexpr int kGemmKB = 128;       // bytes of K a stage holds
constexpr int kGemmBN = 128;       // columns of a tile

// the tile's shared memory: the ring of stages (as many as 144 KiB hold,
// at most 5), the fp8 route's two f16 B panels (2 x 128 rows x 256 bytes),
// then the full and empty barriers of each stage, plus the slack that
// aligns the base to 1024 bytes. ops/matmul.py's _matmul_smem repeats this
// arithmetic.
template <int BM, int BN>
struct WgGemmTile {
  static_assert(BM % 128 == 0 && BM <= 256 && BN == kGemmBN, "tile");
  static constexpr int A_BYTES = BM * kGemmKB;
  static constexpr int STAGE = A_BYTES + BN * kGemmKB;
  static constexpr int STAGES =
      144 * 1024 / STAGE < 5 ? 144 * 1024 / STAGE : 5;
  static constexpr int F16B = STAGES * STAGE;   // the f16 B panels
  static constexpr int F16B_BYTES = BN * 2 * kGemmKB;
  static constexpr int BAR = F16B + 2 * F16B_BYTES;
  static constexpr int SMEM = BAR + 2 * STAGES * 8 + 1024;
  static constexpr int MI = BM / 128;  // m64 row blocks of a consumer
};

// -- the instructions --------------------------------------------------------

#define CUBECL_WG_F(i) "+f"(d[i])
#define CUBECL_WG_I(i) "+r"(d[i])
#define CUBECL_WG_8(C, i)                                                  \
  C(i), C(i + 1), C(i + 2), C(i + 3), C(i + 4), C(i + 5), C(i + 6), C(i + 7)
#define CUBECL_WG_64(C)                                                    \
  CUBECL_WG_8(C, 0), CUBECL_WG_8(C, 8), CUBECL_WG_8(C, 16),                \
      CUBECL_WG_8(C, 24), CUBECL_WG_8(C, 32), CUBECL_WG_8(C, 40),          \
      CUBECL_WG_8(C, 48), CUBECL_WG_8(C, 56)
#define CUBECL_WG_R64                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63"

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
#undef CUBECL_WG_R64
#undef CUBECL_WG_64
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

// make this thread's shared-memory stores visible to wgmma's reads (the
// async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// -- the producer: one thread keeps the ring full ------------------------

// Stage kt % STAGES gets A rows [m0, m0 + BM) and B rows [n0, n0 + BN) of
// K bytes [kt * 128, kt * 128 + 128), for every kt < KT.
template <int BM, int BN>
__device__ __forceinline__ void wgmma_gemm_produce(
    uint8_t* smem, uint64_t* full, uint64_t* empty, const CUtensorMap* ta,
    const CUtensorMap* tb, int m0, int n0, int KT) {
  using L = WgGemmTile<BM, BN>;
  tma_prefetch_map(ta);
  tma_prefetch_map(tb);
  int st = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(&empty[st], phase ^ 1);  // the first round passes at once
    mbar_expect_tx(&full[st], L::STAGE);
    uint8_t* s = smem + st * L::STAGE;
    tma_load_3d(s, ta, &full[st], kt * kGemmKB, m0, 0);
    tma_load_3d(s + L::A_BYTES, tb, &full[st], kt * kGemmKB, n0, 0);
    if (++st == L::STAGES) {
      st = 0;
      phase ^= 1;
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
    int (&acc)[WgGemmTile<BM, BN>::MI][64]) {
  using L = WgGemmTile<BM, BN>;
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
    float (&acc)[WgGemmTile<BM, BN>::MI][64]) {
  using L = WgGemmTile<BM, BN>;
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
    // 4. this warp is done with the fp8 stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    // 5. every consumer's share of the f16 B is in place
    fence_proxy_async();
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

// Store a consumer's tile through the epilogue: c has rows of N elements,
// row0 is the warpgroup's first row, n0 the block's first column.
template <int MI, typename Acc>
__device__ __forceinline__ void wgmma_gemm_store(const Epilogue& ep, void* c,
                                                 int64_t row0, int N, int n0,
                                                 const Acc (&acc)[MI][64]) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int64_t row = row0 + mi * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      ep.store2(c, row * N + col, acc[mi][4 * j], acc[mi][4 * j + 1]);
      ep.store2(c, (row + 8) * N + col, acc[mi][4 * j + 2],
                acc[mi][4 * j + 3]);
    }
  }
}

// -- tensor maps (host) ----------------------------------------------------

// rows x cols bytes (row-major, rows of `cols` bytes) as a tensor map of
// 128-byte x box_rows boxes with the 128-byte swizzle
inline cudaError_t bytes_map(CUtensorMap* map, const void* base, int cols,
                             int rows, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 1};
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
