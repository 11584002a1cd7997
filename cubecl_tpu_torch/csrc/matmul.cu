// Tiled GEMM for Hopper (sm_90a): the autotuned matmul and its scaled form.
//
// Replaces the TPU kernels of cubecl_tpu/ops/matmul.py:
//   M1 _build_matmul (pallas_call :112): out = cast(a @ b) for f32 / bf16 /
//      fp8 / int8 operands, f32 or int32 accumulation, B as (K, N) or, when
//      b_transposed, as (N, K), and an optional epilogue that multiplies the
//      accumulator by sa * sb read from two device scalars;
//   M2 _build_matmul_scaled (pallas_call :508): the same with sa, sb given
//      as host floats. One kernel with an epilogue flag serves both.
//
// Math (as M1): out[m, n] = cast_out(epilogue(sum_k a[m, k] * b[k, n])).
// The accumulator is f32 (int32 for int8 operands: exact). The epilogue,
// when scaled, is f32(acc) * (sa * sb) with the scale product taken in f32
// first, as the TPU kernel does. Outputs are f32, bf16, f16 or int32; bf16
// and f16 round to nearest even, as torch's .to() does.
//
// Bound on the H100 at 4096^3: 2 * 4096^3 operations over the dtype's
// tensor-core peak (bf16/f16 989 TFLOP/s: 0.139 ms; fp8 and int8 1979:
// 0.069 ms); f32 runs off the tensor cores (67 TFLOP/s: 2.05 ms), because
// TF32 keeps 10 mantissa bits and misses the f32 tolerance of the TPU
// kernel's Precision.HIGHEST by some 10x. The bytes (a, b and out once)
// are 0.03 ms at 3.35 TB/s, so the kernel is bound by operations.
//
// Design, simple and right first:
// - 16- and 8-bit operands run on the tensor cores through warp-level
//   mma.sync: m16n8k16 for bf16/f16, m16n8k32 for int8 (s32 accumulate)
//   and for e4m3/e5m2 (sm_89+). Both shapes consume 32 bytes of K per
//   step with the same register layout in bytes, so one kernel template
//   covers all five types.
// - A block of 256 threads (8 warps as 2 x 4) owns a BM x BN output tile;
//   A and B tiles of BKB bytes of K are staged in shared memory in two
//   buffers filled by cp.async, so the next tile's copy overlaps the
//   current tile's products. Rows are padded by 16 bytes, which makes the
//   ldmatrix reads conflict-free.
// - B given as (N, K) is mma's native "col" operand: it is staged n-major
//   like A and read with ldmatrix. B given as (K, N) is staged k-major and
//   read with ldmatrix.trans for 16-bit types; 8-bit types cannot use the
//   16-bit transpose, so a transposing shared-memory store stages them
//   n-major instead.
// - f32 operands run on the CUDA cores: each of 256 threads owns a
//   (BM/16) x (BN/16) block of the output and accumulates with fmaf.
// - The tile sizes are template instances chosen by a switch at launch
//   (the tunables of ops/matmul.py are exactly this list), so one nvcc
//   build covers every tunable. Shapes the tile does not divide are
//   refused by the Python wrapper; there is no masking here.
// wgmma, TMA, deeper pipelines and persistent blocks are later work.
#include "common.cuh"

#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace cubecl {
namespace {

constexpr int NT = 256;  // threads per block, both kernels

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

// -- tensor-core kernel -------------------------------------------------------

template <int BM, int BN, int BKB, bool BT, int E>
struct MmaTile {
  static constexpr int AP = BKB + 16;            // A row, bytes (padded)
  static constexpr bool BN_MAJOR = BT || E == 1;  // B staged [n][k]
  static constexpr int BP = BN_MAJOR ? BKB + 16 : BN * 2 + 16;
  static constexpr int B_ROWS = BN_MAJOR ? BN : BKB / 2;
  static constexpr int A_BYTES = BM * AP;
  static constexpr int STAGE = A_BYTES + B_ROWS * BP;
  static constexpr int SMEM = 2 * STAGE;
};

template <typename T, int BM, int BN, int BKB, bool BT>
__global__ void __launch_bounds__(NT)
mma_gemm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                void* __restrict__ c, int N, int K, int out_dtype, int scaled,
                const float* __restrict__ sa, const float* __restrict__ sb,
                float scale) {
  constexpr int E = T::E;
  using Tile = MmaTile<BM, BN, BKB, BT, E>;
  using Acc = typename T::Acc;
  constexpr int MI = BM / 32;  // 16-row mma tiles per warp (warps 2 x 4)
  constexpr int NI = BN / 32;  // 8-column mma tiles per warp
  static_assert(NI % 2 == 0, "B fragments are loaded in pairs of n8 tiles");
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * (BM / 2), wn = (warp & 3) * (BN / 4);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int64_t KB = static_cast<int64_t>(K) * E;  // row of A (and of B^T)
  const uint8_t* a_blk = a + m0 * KB;

  // stage k-tile kt into buffer st
  auto load = [&](int st, int kt) {
    uint8_t* As = smem + st * Tile::STAGE;
    uint8_t* Bs = As + Tile::A_BYTES;
    const int64_t kb = static_cast<int64_t>(kt) * BKB;
    constexpr int ACH = BM * BKB / 16;  // 16-byte chunks of the A tile
#pragma unroll
    for (int i = tid; i < ACH; i += NT) {
      const int r = i / (BKB / 16), q = i % (BKB / 16);
      cp_async16(As + r * Tile::AP + q * 16, a_blk + r * KB + kb + q * 16);
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

  Acc acc[MI][NI][4];
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

  const Epilogue ep = make_epilogue(out_dtype, scaled, sa, sb, scale);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int row = m0 + wm + i * 16 + g, col = n0 + wn + j * 8 + 2 * t4;
      ep.store2(c, static_cast<int64_t>(row) * N + col, acc[i][j][0], acc[i][j][1]);
      ep.store2(c, static_cast<int64_t>(row + 8) * N + col, acc[i][j][2],
                acc[i][j][3]);
    }
}

// -- f32 kernel on the CUDA cores ---------------------------------------------

template <int BM, int BN, int BK>
constexpr int fma_smem_bytes() {
  return (BK * BM + BK * BN) * 4;  // As [BK][BM], Bs [BK][BN]
}

template <int BM, int BN, int BK, bool BT>
__global__ void __launch_bounds__(NT)
fma_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                void* __restrict__ c, int N, int K, int out_dtype, int scaled,
                const float* __restrict__ sa, const float* __restrict__ sb,
                float scale) {
  constexpr int TM = BM / 16, TN = BN / 16;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [BK][BM] (a transposed)
  float* Bs = As + BK * BM;                     // [BK][BN]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
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
          a + static_cast<int64_t>(m0 + r) * K + k0 + q * 4);
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

  const Epilogue ep = make_epilogue(out_dtype, scaled, sa, sb, scale);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; j += 2)
      ep.store2(c, static_cast<int64_t>(m0 + ty * TM + i) * N + n0 + tx * TN + j,
                acc[i][j], acc[i][j + 1]);
}

// -- launch -------------------------------------------------------------------

// Above 48 KB a kernel must opt in to dynamic shared memory: once per
// instance (the static below), at its first launch, which comes before any
// graph capture (the capture's warm launch).
template <typename T, int BM, int BN, int BKB, bool BT>
cudaError_t launch_mma(const void* a, const void* b, void* c, int M, int N,
                       int K, int out_dtype, int scaled, const float* sa,
                       const float* sb, float scale, cudaStream_t st) {
  constexpr int smem = MmaTile<BM, BN, BKB, BT, T::E>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      mma_gemm_kernel<T, BM, BN, BKB, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  mma_gemm_kernel<T, BM, BN, BKB, BT><<<dim3(N / BN, M / BM), NT, smem, st>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), c, N, K,
      out_dtype, scaled, sa, sb, scale);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, bool BT>
cudaError_t launch_fma(const void* a, const void* b, void* c, int M, int N,
                       int K, int out_dtype, int scaled, const float* sa,
                       const float* sb, float scale, cudaStream_t st) {
  constexpr int smem = fma_smem_bytes<BM, BN, BK>();
  static_assert(smem <= 48 * 1024, "the f32 tiles need no opt-in");
  fma_gemm_kernel<BM, BN, BK, BT><<<dim3(N / BN, M / BM), NT, smem, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), c, N, K,
      out_dtype, scaled, sa, sb, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cubecl

// The tile instances: (BM, BN, bytes of K per stage) for the tensor cores,
// (BM, BN, K per stage) for f32. ops/matmul.py's TILES lists the same.
#define CUBECL_MMA_TILES(X)                                  \
  X(64, 128, 64) X(64, 128, 128) X(128, 128, 64) X(128, 128, 128) \
  X(128, 256, 64) X(128, 256, 128) X(256, 128, 64) X(256, 128, 128)
#define CUBECL_FMA_TILES(X) X(64, 64, 8) X(64, 64, 16) X(128, 128, 8) X(128, 128, 16)

// a (M, K); b (K, N), or (N, K) when b_transposed; c (M, N); all
// contiguous and 16-byte aligned, M % tm == N % tn == K % tk == 0 (the
// wrapper checks). in_dtype: kF32, kBF16, kF16, kE4M3, kE5M2 or kI8;
// out_dtype: kF32, kBF16, kF16 or kI32 (int8 operands only, unscaled).
// scaled: 0 none, 1 multiply by sa[0] * sb[0] (device scalars), 2 by
// scale. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a type or tile this library was not built for.
extern "C" int cubecl_matmul(const void* a, const void* b, void* c,
                             const float* sa, const float* sb, int in_dtype,
                             int out_dtype, int M, int N, int K, int tm,
                             int tn, int tk, int b_transposed, int scaled,
                             float scale, void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32) {
#define CUBECL_FMA(BM, BN, BK)                                                \
  if (tm == BM && tn == BN && tk == BK)                                       \
    return b_transposed                                                       \
               ? launch_fma<BM, BN, BK, true>(a, b, c, M, N, K, out_dtype,    \
                                              scaled, sa, sb, scale, st)      \
               : launch_fma<BM, BN, BK, false>(a, b, c, M, N, K, out_dtype,   \
                                               scaled, sa, sb, scale, st);
    CUBECL_FMA_TILES(CUBECL_FMA)
#undef CUBECL_FMA
    return cudaErrorInvalidValue;
  }
#define CUBECL_MMA_TYPE(CODE, T)                                              \
  if (in_dtype == CODE) {                                                     \
    CUBECL_MMA_TILES(CUBECL_MMA_TILE_##T)                                     \
    return cudaErrorInvalidValue;                                             \
  }
#define CUBECL_MMA_TILE(T, BM, BN, BKB)                                       \
  if (tm == BM && tn == BN && tk * T::E == BKB)                               \
    return b_transposed                                                       \
               ? launch_mma<T, BM, BN, BKB, true>(a, b, c, M, N, K,           \
                                                  out_dtype, scaled, sa, sb,  \
                                                  scale, st)                  \
               : launch_mma<T, BM, BN, BKB, false>(a, b, c, M, N, K,          \
                                                   out_dtype, scaled, sa, sb, \
                                                   scale, st);
#define CUBECL_MMA_TILE_BF16(BM, BN, BKB) CUBECL_MMA_TILE(BF16, BM, BN, BKB)
#define CUBECL_MMA_TILE_F16(BM, BN, BKB) CUBECL_MMA_TILE(F16, BM, BN, BKB)
#define CUBECL_MMA_TILE_E4M3(BM, BN, BKB) CUBECL_MMA_TILE(E4M3, BM, BN, BKB)
#define CUBECL_MMA_TILE_E5M2(BM, BN, BKB) CUBECL_MMA_TILE(E5M2, BM, BN, BKB)
#define CUBECL_MMA_TILE_S8(BM, BN, BKB) CUBECL_MMA_TILE(S8, BM, BN, BKB)
  CUBECL_MMA_TYPE(kBF16, BF16)
  CUBECL_MMA_TYPE(kF16, F16)
  CUBECL_MMA_TYPE(kE4M3, E4M3)
  CUBECL_MMA_TYPE(kE5M2, E5M2)
  CUBECL_MMA_TYPE(kI8, S8)
  return cudaErrorInvalidValue;
}
