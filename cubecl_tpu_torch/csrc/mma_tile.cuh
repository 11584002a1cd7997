// The GEMM pieces shared by the matmul kernels (matmul.cu and matmul8.cu,
// M1/M2) and the per-expert GEMM (expert_matmul.cu, E1):
//
// - the operand type tags of the tensor-core bodies (wgmma_gemm.cuh);
// - the epilogue that scales, converts and stores two neighbouring output
//   columns (none, device scalars sa * sb, or a host scale), used by every
//   GEMM body;
// - E1's f32 tile loop on the CUDA cores: each of 256 threads owns a
//   (BM/16) x (BN/16) block of a BM x BN output tile and accumulates with
//   fmaf over all of K. It takes `rows`, the number of the tile's BM rows
//   of A that exist: a row at or past it is read as row rows - 1 (so a
//   ragged tile reads nothing past its rows) and the store skips it.
//
// M1's GEMMs run on wgmma (wgmma_gemm.cuh), f32 as three TF32 products.
#pragma once

#include "common.cuh"

#include <cuda_fp16.h>

namespace cubecl {
namespace {

constexpr int NT = 256;  // threads per block of the f32 GEMM loops

// -- the tensor-core operand types: bytes per element and accumulator type
// (the wgmma bodies of wgmma_gemm.cuh take them as tags)
struct BF16 { static constexpr int E = 2; using Acc = float; };
struct F16 { static constexpr int E = 2; using Acc = float; };
struct E4M3 { static constexpr int E = 1; using Acc = float; };
struct E5M2 { static constexpr int E = 1; using Acc = float; };
struct S8 { static constexpr int E = 1; using Acc = int; };
// f32 operands, run as three TF32 products (3xTF32)
struct TF32 { static constexpr int E = 4; using Acc = float; };

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
