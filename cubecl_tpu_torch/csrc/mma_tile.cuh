// The GEMM tile loops shared by the matmul kernel (matmul.cu, M1/M2) and the
// per-expert GEMM (expert_matmul.cu, E1): one block's BM x BN output tile,
// accumulated over all of K, then stored through an epilogue.
//
// - 16- and 8-bit operands run on the tensor cores through warp-level
//   mma.sync: m16n8k16 for bf16/f16, m16n8k32 for int8 (s32 accumulate)
//   and for e4m3/e5m2 (sm_89+). Both shapes consume 32 bytes of K per
//   step with the same register layout in bytes, so one template covers
//   all five types. A block of 256 threads (8 warps as 2 x 4) owns the
//   tile; A and B tiles of BKB bytes of K are staged in shared memory in
//   two buffers filled by cp.async, so the next tile's copy overlaps the
//   current tile's products. Rows are padded by 16 bytes, which makes the
//   ldmatrix reads conflict-free. B given as (N, K) is mma's native "col"
//   operand: it is staged n-major like A and read with ldmatrix. B given
//   as (K, N) is staged k-major and read with ldmatrix.trans for 16-bit
//   types; 8-bit types cannot use the 16-bit transpose, so a transposing
//   shared-memory store stages them n-major instead.
// - f32 operands run on the CUDA cores: each of 256 threads owns a
//   (BM/16) x (BN/16) block of the output and accumulates with fmaf.
//
// Both loops take `rows`, the number of the tile's BM rows of A that
// exist: a row at or past it is read as row rows - 1 (so a ragged tile
// reads nothing past its rows) and the store skips it. The matmul kernel
// passes BM.
#pragma once

#include "common.cuh"

#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace cubecl {
namespace {

constexpr int NT = 256;  // threads per block, every GEMM kernel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// -- the five tensor-core input types: bytes per element, accumulator type
// and one mma.sync of 16 x 8 outputs over 32 bytes of K
struct BF16 { static constexpr int E = 2; using Acc = float; };
struct F16 { static constexpr int E = 2; using Acc = float; };
struct E4M3 { static constexpr int E = 1; using Acc = float; };
struct E5M2 { static constexpr int E = 1; using Acc = float; };
struct S8 { static constexpr int E = 1; using Acc = int; };

#define CUBECL_MMA_F32(NAME, SHAPE, TYPES)                                    \
  __device__ __forceinline__ void mma(NAME, float (&d)[4],                    \
                                      const uint32_t (&a)[4],                 \
                                      uint32_t b0, uint32_t b1) {             \
    asm volatile("mma.sync.aligned." SHAPE ".row.col." TYPES                  \
                 " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "            \
                 "{%0, %1, %2, %3};\n"                                        \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),       \
                   "r"(b1));                                                  \
  }
CUBECL_MMA_F32(BF16, "m16n8k16", "f32.bf16.bf16.f32")
CUBECL_MMA_F32(F16, "m16n8k16", "f32.f16.f16.f32")
CUBECL_MMA_F32(E4M3, "m16n8k32", "f32.e4m3.e4m3.f32")
CUBECL_MMA_F32(E5M2, "m16n8k32", "f32.e5m2.e5m2.f32")
#undef CUBECL_MMA_F32

__device__ __forceinline__ void mma(S8, int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- the epilogue: scale, convert, store two neighbouring columns

struct Epilogue {
  int out_dtype;  // kF32, kBF16, kF16 or kI32
  int scaled;     // 0: cast only; else multiply by s = sa * sb
  float s;

  __device__ __forceinline__ void store2(void* c, int64_t idx, float v0,
                                         float v1) const {
    if (scaled) { v0 *= s; v1 *= s; }
    if (out_dtype == kF32) {
      *reinterpret_cast<float2*>(static_cast<float*>(c) + idx) =
          make_float2(v0, v1);
    } else if (out_dtype == kBF16) {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(c) + idx) =
          __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    } else {  // kF16
      *reinterpret_cast<__half2*>(static_cast<__half*>(c) + idx) =
          __halves2half2(__float2half_rn(v0), __float2half_rn(v1));
    }
  }
  __device__ __forceinline__ void store2(void* c, int64_t idx, int v0,
                                         int v1) const {
    if (out_dtype == kI32 && !scaled) {
      *reinterpret_cast<int2*>(static_cast<int*>(c) + idx) = make_int2(v0, v1);
    } else {
      store2(c, idx, static_cast<float>(v0), static_cast<float>(v1));
    }
  }
};

__device__ __forceinline__ Epilogue make_epilogue(int out_dtype, int scaled,
                                                  const float* sa,
                                                  const float* sb, float scale) {
  // scaled == 1: device scalars (the quantized route); 2: a host scale
  const float s = scaled == 1 ? sa[0] * sb[0] : scale;
  return Epilogue{out_dtype, scaled, s};
}

// -- tensor-core tile ---------------------------------------------------------

template <int BM, int BN, int BKB, bool BT, int E>
struct MmaTile {
  static constexpr int AP = BKB + 16;            // A row, bytes (padded)
  static constexpr bool BN_MAJOR = BT || E == 1;  // B staged [n][k]
  static constexpr int BP = BN_MAJOR ? BKB + 16 : BN * 2 + 16;
  static constexpr int B_ROWS = BN_MAJOR ? BN : BKB / 2;
  static constexpr int A_BYTES = BM * AP;
  static constexpr int STAGE = A_BYTES + B_ROWS * BP;
  static constexpr int SMEM = 2 * STAGE;
  static constexpr int MI = BM / 32;  // 16-row mma tiles per warp (warps 2 x 4)
  static constexpr int NI = BN / 32;  // 8-column mma tiles per warp
};

// acc = a_blk[0:BM, :] @ b[:, n0:n0 + BN] over all of K. a_blk: the tile's
// first row of A, rows of K elements; b: (K, N), or (N, K) when BT. smem
// holds MmaTile::SMEM bytes.
template <typename T, int BM, int BN, int BKB, bool BT>
__device__ __forceinline__ void mma_tile_mainloop(
    uint8_t* smem, const uint8_t* __restrict__ a_blk, int rows,
    const uint8_t* __restrict__ b, int N, int K, int n0,
    typename T::Acc (&acc)[BM / 32][BN / 32][4]) {
  constexpr int E = T::E;
  using Tile = MmaTile<BM, BN, BKB, BT, E>;
  using Acc = typename T::Acc;
  constexpr int MI = Tile::MI, NI = Tile::NI;
  static_assert(NI % 2 == 0, "B fragments are loaded in pairs of n8 tiles");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * (BM / 2), wn = (warp & 3) * (BN / 4);
  const int64_t KB = static_cast<int64_t>(K) * E;  // row of A (and of B^T)

  // stage k-tile kt into buffer st
  auto load = [&](int st, int kt) {
    uint8_t* As = smem + st * Tile::STAGE;
    uint8_t* Bs = As + Tile::A_BYTES;
    const int64_t kb = static_cast<int64_t>(kt) * BKB;
    constexpr int ACH = BM * BKB / 16;  // 16-byte chunks of the A tile
#pragma unroll
    for (int i = tid; i < ACH; i += NT) {
      const int r = i / (BKB / 16), q = i % (BKB / 16);
      cp_async16(As + r * Tile::AP + q * 16,
                 a_blk + min(r, rows - 1) * KB + kb + q * 16);
    }
    if constexpr (BT) {  // B (N, K): rows of K bytes, like A
      constexpr int BCH = BN * BKB / 16;
#pragma unroll
      for (int i = tid; i < BCH; i += NT) {
        const int r = i / (BKB / 16), q = i % (BKB / 16);
        cp_async16(Bs + r * Tile::BP + q * 16, b + (n0 + r) * KB + kb + q * 16);
      }
    } else if constexpr (E == 2) {  // B (K, N), 16-bit: staged k-major
      constexpr int BCH = (BKB / 2) * BN * 2 / 16;
      const uint8_t* src = b + (static_cast<int64_t>(kt) * (BKB / 2)) * N * 2 + n0 * 2;
#pragma unroll
      for (int i = tid; i < BCH; i += NT) {
        const int r = i / (BN * 2 / 16), q = i % (BN * 2 / 16);
        cp_async16(Bs + r * Tile::BP + q * 16,
                   src + static_cast<int64_t>(r) * N * 2 + q * 16);
      }
    } else {  // B (K, N), 8-bit: a transposing store to [n][k]
      constexpr int BCH = BKB * BN / 16;
      const uint8_t* src = b + (static_cast<int64_t>(kt) * BKB) * N + n0;
#pragma unroll
      for (int i = tid; i < BCH; i += NT) {
        const int r = i / (BN / 16), q = i % (BN / 16);
        const uint4 v = *reinterpret_cast<const uint4*>(
            src + static_cast<int64_t>(r) * N + q * 16);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          Bs[(q * 16 + j) * Tile::BP + r] =
              static_cast<uint8_t>((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  const int KT = static_cast<int>(KB / BKB);
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait1();  // every group but the newest: tile kt has landed
    __syncthreads();
    const uint8_t* As = smem + (kt & 1) * Tile::STAGE;
    const uint8_t* Bs = As + Tile::A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BKB / 32; ++ks) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], As + (wm + i * 16 + (lane & 15)) * Tile::AP + ks * 32 +
                           (lane >> 4) * 16);
      uint32_t bf[NI][2];
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        if constexpr (Tile::BN_MAJOR) {
          // matrices: (n 0-7, k bytes 0-15), (n 0-7, 16-31), (n 8-15, ...)
          ldsm_x4(r, Bs + (wn + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * Tile::BP +
                         ks * 32 + ((lane >> 3) & 1) * 16);
        } else {
          // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), ...
          ldsm_x4_trans(r, Bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    Tile::BP +
                               (wn + j * 8 + (lane >> 4) * 8) * 2);
        }
        bf[j][0] = r[0]; bf[j][1] = r[1];
        bf[j + 1][0] = r[2]; bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma(T{}, acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
}

// Store the tile accumulated by mma_tile_mainloop into c (rows of N
// elements) from row row0 on; tile rows at or past `rows` are skipped.
template <int BM, int BN, typename Acc>
__device__ __forceinline__ void mma_tile_store(const Epilogue& ep, void* c,
                                               int64_t row0, int rows, int N,
                                               int n0,
                                               const Acc (&acc)[BM / 32][BN / 32][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * (BM / 2), wn = (warp & 3) * (BN / 4);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < BM / 32; ++i)
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int row = wm + i * 16 + g, col = n0 + wn + j * 8 + 2 * t4;
      if (row < rows)
        ep.store2(c, (row0 + row) * N + col, acc[i][j][0], acc[i][j][1]);
      if (row + 8 < rows)
        ep.store2(c, (row0 + row + 8) * N + col, acc[i][j][2], acc[i][j][3]);
    }
}

// -- f32 tile on the CUDA cores -----------------------------------------------

template <int BM, int BN, int BK>
constexpr int fma_smem_bytes() {
  return (BK * BM + BK * BN) * 4;  // As [BK][BM], Bs [BK][BN]
}

// acc = a_blk[0:BM, :] @ b[:, n0:n0 + BN] over all of K in f32; smem holds
// fma_smem_bytes<BM, BN, BK>() bytes.
template <int BM, int BN, int BK, bool BT>
__device__ __forceinline__ void fma_tile_mainloop(
    float* smem, const float* __restrict__ a_blk, int rows,
    const float* __restrict__ b, int N, int K, int n0,
    float (&acc)[BM / 16][BN / 16]) {
  constexpr int TM = BM / 16, TN = BN / 16;
  float* As = smem;            // [BK][BM] (a transposed)
  float* Bs = As + BK * BM;    // [BK][BN]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A (M, K) rows -> As[k][m], four k at a time
#pragma unroll
    for (int i = tid; i < BM * BK / 4; i += NT) {
      const int r = i / (BK / 4), q = i % (BK / 4);
      const float4 v = *reinterpret_cast<const float4*>(
          a_blk + static_cast<int64_t>(min(r, rows - 1)) * K + k0 + q * 4);
      As[(q * 4 + 0) * BM + r] = v.x;
      As[(q * 4 + 1) * BM + r] = v.y;
      As[(q * 4 + 2) * BM + r] = v.z;
      As[(q * 4 + 3) * BM + r] = v.w;
    }
    if constexpr (BT) {  // B (N, K) rows -> Bs[k][n]
#pragma unroll
      for (int i = tid; i < BN * BK / 4; i += NT) {
        const int r = i / (BK / 4), q = i % (BK / 4);
        const float4 v = *reinterpret_cast<const float4*>(
            b + static_cast<int64_t>(n0 + r) * K + k0 + q * 4);
        Bs[(q * 4 + 0) * BN + r] = v.x;
        Bs[(q * 4 + 1) * BN + r] = v.y;
        Bs[(q * 4 + 2) * BN + r] = v.z;
        Bs[(q * 4 + 3) * BN + r] = v.w;
      }
    } else {  // B (K, N) rows -> Bs[k][n] as they are
#pragma unroll
      for (int i = tid; i < BK * BN / 4; i += NT) {
        const int r = i / (BN / 4), q = i % (BN / 4);
        *reinterpret_cast<float4*>(Bs + r * BN + q * 4) =
            *reinterpret_cast<const float4*>(
                b + static_cast<int64_t>(k0 + r) * N + n0 + q * 4);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(As + kk * BM + ty * TM + i);
        av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(Bs + kk * BN + tx * TN + j);
        bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Store the f32 tile into c from row row0 on; tile rows at or past `rows`
// are skipped.
template <int BM, int BN>
__device__ __forceinline__ void fma_tile_store(const Epilogue& ep, void* c,
                                               int64_t row0, int rows, int N,
                                               int n0,
                                               const float (&acc)[BM / 16][BN / 16]) {
  constexpr int TM = BM / 16, TN = BN / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty * TM + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; j += 2)
      ep.store2(c, (row0 + row) * N + n0 + tx * TN + j, acc[i][j],
                acc[i][j + 1]);
  }
}

}  // namespace
}  // namespace cubecl
