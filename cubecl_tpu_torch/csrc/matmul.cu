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
// The accumulator is f32. The epilogue, when scaled, is f32(acc) * (sa *
// sb) with the scale product taken in f32 first, as the TPU kernel does.
// Outputs are f32, bf16 or f16; bf16 and f16 round to nearest even, as
// torch's .to() does.
//
// Bound on the H100 at 4096^3: 2 * 4096^3 operations over the dtype's
// tensor-core peak (bf16/f16 989 TFLOP/s: 0.139 ms). f32 takes the lesser
// of the CUDA cores' (67 TFLOP/s: 2.05 ms) and three TF32 products' (3 x
// 2 * 4096^3 at 495 TFLOP/s: 0.833 ms): one TF32 product keeps 10
// mantissa bits and misses the f32 tolerance of the TPU kernel's
// Precision.HIGHEST by some 10x, three (3xTF32) hold it. The bytes (a, b
// and out once) are 0.03 ms at 3.35 TB/s, so the kernel is bound by
// operations. Both bodies are wgmma fed by TMA (wgmma_gemm.cuh's
// wgmma_gemm), the instruction that reaches the tensor cores' full rate on
// Hopper:
// - a ring of stages of 128 bytes of K (64 16-bit or 32 f32 elements) on
//   mbarriers, filled by one producer thread, so device-memory latency
//   hides behind the products; two consumer warpgroups with f32
//   accumulators in registers (at most 128 a thread);
// - persistent blocks (at most 132) walk the tiles in raster groups of
//   kRasterM row tiles, so a tile's epilogue overlaps the next tile's
//   copies and no wave is left half empty beyond the last one.
// bf16 / f16 (gemm16_wgmma_kernel): SS wgmma m64nNk16, 3-6 stages;
// - a 16-bit output leaves through shared memory by TMA stores, which
//   drain while the next tile's products run; an f32 output is stored from
//   the registers;
// - B given as (N, K) is K-major and copied like A; B given as (K, N), the
//   JAX reference's layout, is copied as it lies in 64-column panels and
//   read by wgmma with its transpose bit: no transposing pass;
// - K is taken in stages of 64; a K that is a multiple of 32 but not of 64
//   leaves a last stage that the tensor maps zero-fill (exact: the zeros
//   add nothing to the sums).
// f32 (gemm_tf32x3_kernel): three TF32 products a k8 step, RS wgmma
// m64nNk8 with A split in registers and B split into two tf32 panels by
// the consumers (wgmma_gemm.cuh's wgmma_gemm_consume_tf32x3), 5-6 stages;
// - a stage's products are summed in the wgmma accumulators, which round
//   toward zero, and added to f32 registers by ordinary additions: over
//   all of K in the wgmma accumulators the sums drifted out of f32's
//   tolerance;
// - TF32 has no transpose bit: B given as (K, N) is first transposed into a
//   scratch (N, K) the wrapper allocates (f32_transpose_kernel: 2 K N x 4
//   bytes moved, about 0.04 ms at 4096^2, inside the same call);
// - every output (f32, bf16, f16) is stored from the registers;
// - K is taken in stages of 32; a K that is a multiple of 8 but not of 32
//   leaves a last stage that the tensor maps zero-fill.
// The tile sizes are template instances chosen by a switch at launch (the
// tunables of ops/matmul.py are exactly these lists), so one nvcc build
// covers every tunable. Shapes the tile does not divide are refused by the
// Python wrapper; there is no masking beyond the zero-filled K stage.
#include "wgmma_gemm.cuh"

namespace cubecl {
namespace {

// -- bf16 / f16 on wgmma ------------------------------------------------------

template <typename T, int BM, int BN, bool BMN>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm16_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tc,
                    void* __restrict__ c, int tiles_m, int tiles_n, int N,
                    int KT, int out_dtype, int scaled,
                    const float* __restrict__ sa,
                    const float* __restrict__ sb, float scale) {
  extern __shared__ uint8_t smem_raw[];
  wgmma_gemm<T, BM, BN, BMN, false>(
      smem_raw, &ta, &tb, &tc, GemmTiles<BM, BN>{tiles_m, tiles_n}, c, N, KT,
      out_dtype, scaled, sa, sb, scale);
}

// -- f32 on wgmma, three TF32 products a k8 step ------------------------------

template <int BM, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   void* __restrict__ c, int tiles_m, int tiles_n, int N,
                   int KT, int out_dtype, int scaled,
                   const float* __restrict__ sa,
                   const float* __restrict__ sb, float scale) {
  extern __shared__ uint8_t smem_raw[];
  wgmma_gemm<TF32, BM, BN, false, false>(
      smem_raw, &ta, &tb, nullptr, GemmTiles<BM, BN>{tiles_m, tiles_n}, c, N,
      KT, out_dtype, scaled, sa, sb, scale);
}

// bt (N, K) = b (K, N)^T in f32; N % 32 == 0, any K. A block of 256
// threads moves a 32 x 32 tile through shared memory (a padded row, so the
// column reads do not share banks): coalesced reads of b's rows, coalesced
// writes of bt's.
__global__ void __launch_bounds__(256)
f32_transpose_kernel(const float* __restrict__ b, float* __restrict__ bt,
                     int K, int N) {
  __shared__ float s[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int x = threadIdx.x % 32, y = threadIdx.x / 32;
#pragma unroll
  for (int r = y; r < 32; r += 8)
    if (k0 + r < K) s[r][x] = b[static_cast<int64_t>(k0 + r) * N + n0 + x];
  __syncthreads();
#pragma unroll
  for (int r = y; r < 32; r += 8)
    if (k0 + x < K) bt[static_cast<int64_t>(n0 + r) * K + k0 + x] = s[x][r];
}

// -- launch -------------------------------------------------------------------

// Above 48 KB a kernel must opt in to dynamic shared memory: once per
// instance (the static below), at its first launch, which comes before any
// graph capture (the capture's warm launch). The tensor maps are kernel
// parameters (__grid_constant__), encoded per call: a captured CUDA graph
// keeps them with the launch. B (N, K) maps as rows of K bytes in boxes of
// BN rows; B (K, N) as rows of N bytes in boxes of 64 rows of K; a 16-bit
// output as rows of N bytes in boxes of 64 rows (an f32 output is stored
// from the registers: its map is not read).
template <typename T, int BM, int BN, bool BMN>
cudaError_t launch_gemm16(const void* a, const void* b, void* c, int M,
                          int N, int K, int out_dtype, int scaled,
                          const float* sa, const float* sb, float scale,
                          cudaStream_t st) {
  constexpr int smem = WgGemmTile<BM, BN, 2>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm16_wgmma_kernel<T, BM, BN, BMN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap ta, tb, tc;
  cudaError_t e = bytes_map(&ta, a, K * 2, M, BM);
  if (e == cudaSuccess)
    e = BMN ? bytes_map(&tb, b, N * 2, K, 64) : bytes_map(&tb, b, K * 2, N, BN);
  if (e == cudaSuccess)
    e = out_dtype == kF32 ? (tc = ta, cudaSuccess)
                          : bytes_map(&tc, c, N * 2, M, 64);
  if (e != cudaSuccess) return e;
  const int tm = M / BM, tn = N / BN;
  const int blocks = tm * tn < kGemmMaxBlocks ? tm * tn : kGemmMaxBlocks;
  gemm16_wgmma_kernel<T, BM, BN, BMN><<<blocks, kGemmThreads, smem, st>>>(
      ta, tb, tc, c, tm, tn, N, (K * 2 + kGemmKB - 1) / kGemmKB, out_dtype,
      scaled, sa, sb, scale);
  return cudaGetLastError();
}

// a (M, K) and b (N, K), f32, as rows of K x 4 bytes in boxes of BM and BN
// rows; the output is stored from the registers (no map)
template <int BM, int BN>
cudaError_t launch_tf32x3(const void* a, const void* b, void* c, int M,
                          int N, int K, int out_dtype, int scaled,
                          const float* sa, const float* sb, float scale,
                          cudaStream_t st) {
  constexpr int smem = WgGemmTile<BM, BN, 4>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tf32x3_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap ta, tb;
  cudaError_t e = bytes_map(&ta, a, K * 4, M, BM);
  if (e == cudaSuccess) e = bytes_map(&tb, b, K * 4, N, BN);
  if (e != cudaSuccess) return e;
  const int tm = M / BM, tn = N / BN;
  const int blocks = tm * tn < kGemmMaxBlocks ? tm * tn : kGemmMaxBlocks;
  gemm_tf32x3_kernel<BM, BN><<<blocks, kGemmThreads, smem, st>>>(
      ta, tb, c, tm, tn, N, (K * 4 + kGemmKB - 1) / kGemmKB, out_dtype,
      scaled, sa, sb, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cubecl

// The tile instances, (BM, BN, bytes of K a stage), of the 16-bit body and
// of the f32 one: ops/matmul.py's kernel_tiles(2) and kernel_tiles(4) list
// the same.
#define CUBECL_WG16_TILES(X) \
  X(64, 128, 128) X(128, 128, 128) X(128, 256, 128) X(256, 128, 128)
#define CUBECL_TF32_TILES(X) X(64, 64, 128) X(128, 128, 128)

// a (M, K); b (K, N), or (N, K) when b_transposed; c (M, N); scratch (N,
// K) f32 when the operands are f32 and b is (K, N), else unused; all
// contiguous and 16-byte aligned, M % tm == N % tn == 0, K % 8 == 0 for
// f32 and K % 32 == 0 for 16-bit operands (the wrapper checks). in_dtype:
// kF32, kBF16 or kF16; out_dtype: kF32, kBF16 or kF16. scaled: 0 none, 1
// multiply by sa[0] * sb[0] (device scalars), 2 by scale. Returns
// cudaGetLastError() after the last launch, or cudaErrorInvalidValue for a
// type or tile this library was not built for: kE4M3, kE5M2 and kI8 are
// matmul8.cu's (cubecl_matmul8), not this one's.
extern "C" int cubecl_matmul(const void* a, const void* b, void* c,
                             void* scratch, const float* sa, const float* sb,
                             int in_dtype, int out_dtype, int M, int N, int K,
                             int tm, int tn, int tk, int b_transposed,
                             int scaled, float scale, void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32) {
    bool built = false;
#define CUBECL_TF32_BUILT(BM, BN, BKB) \
  built |= tm == BM && tn == BN && tk * 4 == BKB;
    CUBECL_TF32_TILES(CUBECL_TF32_BUILT)
#undef CUBECL_TF32_BUILT
    if (!built) return cudaErrorInvalidValue;
    if (!b_transposed) {
      f32_transpose_kernel<<<dim3(N / 32, (K + 31) / 32), 256, 0, st>>>(
          static_cast<const float*>(b), static_cast<float*>(scratch), K, N);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      b = scratch;
    }
#define CUBECL_TF32(BM, BN, BKB)                                           \
  if (tm == BM && tn == BN)                                                \
    return launch_tf32x3<BM, BN>(a, b, c, M, N, K, out_dtype, scaled, sa,  \
                                 sb, scale, st);
    CUBECL_TF32_TILES(CUBECL_TF32)
#undef CUBECL_TF32
    return cudaErrorInvalidValue;
  }
#define CUBECL_WG16_TYPE(CODE, T)                                             \
  if (in_dtype == CODE) {                                                     \
    CUBECL_WG16_TILES(CUBECL_WG16_TILE_##T)                                   \
    return cudaErrorInvalidValue;                                             \
  }
#define CUBECL_WG16_TILE(T, BM, BN, BKB)                                      \
  if (tm == BM && tn == BN && tk * T::E == BKB)                               \
    return b_transposed                                                       \
               ? launch_gemm16<T, BM, BN, false>(a, b, c, M, N, K, out_dtype, \
                                                 scaled, sa, sb, scale, st)   \
               : launch_gemm16<T, BM, BN, true>(a, b, c, M, N, K, out_dtype,  \
                                                scaled, sa, sb, scale, st);
#define CUBECL_WG16_TILE_BF16(BM, BN, BKB) CUBECL_WG16_TILE(BF16, BM, BN, BKB)
#define CUBECL_WG16_TILE_F16(BM, BN, BKB) CUBECL_WG16_TILE(F16, BM, BN, BKB)
  CUBECL_WG16_TYPE(kBF16, BF16)
  CUBECL_WG16_TYPE(kF16, F16)
  return cudaErrorInvalidValue;
}
