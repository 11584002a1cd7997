// Tiled GEMM for Hopper (sm_90a): the autotuned matmul and its scaled form,
// for f32 and 16-bit operands; the 8-bit ones (fp8, int8) run matmul8.cu.
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
// Design, simple and right first: the tile loops of mma_tile.cuh (16-bit
// operands on the tensor cores through mma.sync with two cp.async stages
// and ldmatrix; f32 on the CUDA cores, never TF32), one block per BM x BN
// output tile. The tile sizes are template instances chosen by a
// switch at launch (the tunables of ops/matmul.py are exactly this list),
// so one nvcc build covers every tunable. Shapes the tile does not divide
// are refused by the Python wrapper; there is no masking here.
// wgmma and TMA for 16-bit operands are later work (matmul8.cu's mainloop,
// wgmma_gemm.cuh).
#include "mma_tile.cuh"

namespace cubecl {
namespace {

// -- tensor-core kernel -------------------------------------------------------

template <typename T, int BM, int BN, int BKB, bool BT>
__global__ void __launch_bounds__(NT)
mma_gemm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                void* __restrict__ c, int N, int K, int out_dtype, int scaled,
                const float* __restrict__ sa, const float* __restrict__ sb,
                float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  typename T::Acc acc[BM / 32][BN / 32][4];
  mma_tile_mainloop<T, BM, BN, BKB, BT>(
      smem, a + static_cast<int64_t>(m0) * K * T::E, BM, b, N, K, n0, acc);
  const Epilogue ep = make_epilogue(out_dtype, scaled, sa, sb, scale);
  mma_tile_store<BM, BN>(ep, c, m0, BM, N, n0, acc);
}

// -- f32 kernel on the CUDA cores ---------------------------------------------

template <int BM, int BN, int BK, bool BT>
__global__ void __launch_bounds__(NT)
fma_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                void* __restrict__ c, int N, int K, int out_dtype, int scaled,
                const float* __restrict__ sa, const float* __restrict__ sb,
                float scale) {
  extern __shared__ float4 smem4[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[BM / 16][BN / 16];
  fma_tile_mainloop<BM, BN, BK, BT>(reinterpret_cast<float*>(smem4),
                                    a + static_cast<int64_t>(m0) * K, BM, b, N,
                                    K, n0, acc);
  const Epilogue ep = make_epilogue(out_dtype, scaled, sa, sb, scale);
  fma_tile_store<BM, BN>(ep, c, m0, BM, N, n0, acc);
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
// cudaErrorInvalidValue for a type or tile this library was not built for:
// kE4M3, kE5M2 and kI8 are matmul8.cu's (cubecl_matmul8), not this one's.
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
  CUBECL_MMA_TYPE(kBF16, BF16)
  CUBECL_MMA_TYPE(kF16, F16)
  return cudaErrorInvalidValue;
}
