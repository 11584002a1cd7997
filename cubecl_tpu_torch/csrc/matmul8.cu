// The 8-bit GEMM for Hopper (sm_90a): M1's fp8 and int8 cases and M2, on
// wgmma fed by TMA.
//
// Replaces, for 8-bit operands (e4m3, e5m2, int8), the TPU kernels of
// cubecl_tpu/ops/matmul.py:
//   M1 _build_matmul (pallas_call :112): out = cast(a @ b), f32 or int32
//      accumulation (int8: exact), an optional epilogue that multiplies by
//      sa * sb read from two device scalars (the matmul_quantized route);
//   M2 _build_matmul_scaled (pallas_call :508): the same with sa, sb given
//      as host floats (the product taken in f32 first).
// One kernel with matmul.cu's epilogue flag serves both, as there; the
// 16-bit and f32 cases stay in matmul.cu.
//
// Bound on the H100 at 4096^3: 2 * 4096^3 operations over the 8-bit
// tensor-core peak (1979 TFLOP/s): 0.069 ms; the bytes (a, b, the output
// once) are under 0.02 ms. The design answers the operations, within what
// the f32 results allow:
// - int8 on wgmma m64n128k32.s32.s8.s8, the 8-bit peak's instruction
//   (mma.sync m16n8k32 does not reach it), exact in s32;
// - fp8 (e4m3, e5m2) on the 16-bit wgmma, as exact f16 values, with f32
//   sums: the 8-bit wgmma's f32 sums keep too few bits for this GEMM's f32
//   results (wgmma_gemm.cuh), so fp8 is bound by 989 TFLOP/s (0.139 ms);
// - TMA copies into a ring of 3-4 stages (wgmma_gemm.cuh) issued by one
//   producer thread, so device-memory latency hides behind the products;
//   two consumer warpgroups a block, a BM x BN tile of 128 x 128 or 256 x
//   128 (the tunables of ops/matmul.py are exactly CUBECL_WG_TILES).
// - B given as (N, K) is K-major, what an 8-bit wgmma operand (and the
//   fp8 route's conversion) reads, and is copied as it is. B given as
//   (K, N), the JAX reference's layout, is first transposed to (N, K) into
//   a scratch buffer the wrapper allocates, by byte_transpose_kernel below
//   (4 x 4 byte blocks by __byte_perm in registers, through shared memory
//   so that both sides are coalesced); it moves 2 K N bytes, about 0.01 ms
//   at 4096^2, inside the same call.
// One block per output tile, not persistent; shapes the tile does not
// divide are refused by the Python wrapper (there is no masking).
#include "wgmma_gemm.cuh"

namespace cubecl {
namespace {

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm8_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   void* __restrict__ c, int N, int K, int out_dtype,
                   int scaled, const float* __restrict__ sa,
                   const float* __restrict__ sb, float scale) {
  using L = WgGemmTile<BM, BN, 1>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + L::STAGES;
  const int KT = K / kGemmKB;

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
      wgmma_gemm_produce<BM, BN, 1, false>(smem, full, empty, &ta, &tb,
                                           OneTile<BM, BN>{}, KT);
    return;
  }
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128 - 1;
  typename T::Acc acc[L::MI][64];
  wgmma_gemm_consume<BM, BN>(T{}, smem, full, empty, wg, KT, acc);
  const Epilogue ep = make_epilogue(out_dtype, scaled, sa, sb, scale);
  wgmma_gemm_store<false>(ep, c, blockIdx.y * BM + wg * (BM / 2), 0, N,
                          blockIdx.x * BN, acc);
}

// bt (N, K) = b (K, N)^T, bytes; K % 128 == N % 128 == 0. A block of 256
// threads moves a 128 x 128 tile: coalesced 16-byte reads of b's rows into
// shared memory as words, then each thread takes 16 rows of k and one word
// column (4 n), transposes 4 x 4 byte blocks in registers and writes 16
// bytes of k to each of its 4 rows of bt.
constexpr int kTrWords = 128 / 4 + 1;  // a staged row of words, padded

__global__ void __launch_bounds__(256)
byte_transpose_kernel(const uint8_t* __restrict__ b, uint8_t* __restrict__ bt,
                      int K, int N) {
  __shared__ uint32_t s[128 * kTrWords];
  const int k0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int chunk = tid + 256 * i;  // 8 chunks of 16 bytes a row
    const int r = chunk / 8, q = chunk % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(
        b + static_cast<int64_t>(k0 + r) * N + n0 + 16 * q);
    uint32_t* d = s + r * kTrWords + 4 * q;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();
  const int w = tid % 32;   // word column: n0 + 4 w .. 4 w + 3
  const int kc = tid / 32;  // rows of k: 16 kc .. 16 kc + 15
  uint32_t o[4][4];         // o[j][g]: row n 4 w + j, k bytes 4 g .. 4 g + 3
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t* src = s + (16 * kc + 4 * g) * kTrWords + w;
    const uint32_t x0 = src[0], x1 = src[kTrWords], x2 = src[2 * kTrWords],
                   x3 = src[3 * kTrWords];
    // x_i holds n bytes 0..3 of k row 4 g + i; o[j][g] gathers byte j of each
    const uint32_t t0 = __byte_perm(x0, x1, 0x5140);
    const uint32_t t1 = __byte_perm(x0, x1, 0x7362);
    const uint32_t t2 = __byte_perm(x2, x3, 0x5140);
    const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
    o[0][g] = __byte_perm(t0, t2, 0x5410);
    o[1][g] = __byte_perm(t0, t2, 0x7632);
    o[2][g] = __byte_perm(t1, t3, 0x5410);
    o[3][g] = __byte_perm(t1, t3, 0x7632);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint4*>(bt + static_cast<int64_t>(n0 + 4 * w + j) * K +
                              k0 + 16 * kc) =
        make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
}

// Above 48 KB a kernel must opt in to dynamic shared memory: once per
// instance, at its first launch (before any graph capture).
template <typename T, int BM, int BN>
cudaError_t launch_gemm8(const void* a, const void* b, void* c, int M, int N,
                         int K, int out_dtype, int scaled, const float* sa,
                         const float* sb, float scale, cudaStream_t st) {
  constexpr int smem = WgGemmTile<BM, BN, 1>::SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm8_wgmma_kernel<T, BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  // the maps are kernel parameters (__grid_constant__), encoded per call:
  // a captured CUDA graph keeps them with the launch
  CUtensorMap ta, tb;
  cudaError_t e = bytes_map(&ta, a, K, M, BM);
  if (e == cudaSuccess) e = bytes_map(&tb, b, K, N, BN);
  if (e != cudaSuccess) return e;
  gemm8_wgmma_kernel<T, BM, BN><<<dim3(N / BN, M / BM), kGemmThreads, smem,
                                  st>>>(ta, tb, c, N, K, out_dtype, scaled, sa,
                                        sb, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cubecl

// The tile instances (BM, BN, bytes of K a stage): ops/matmul.py's
// kernel_tiles(1) lists the same.
#define CUBECL_WG_TILES(X) X(128, 128, 128) X(256, 128, 128)

// a (M, K); b (K, N), or (N, K) when b_transposed; c (M, N); scratch (N,
// K) bytes when b is (K, N), else unused; all contiguous and 16-byte
// aligned, M % tm == N % tn == K % tk == 0 with tk 128 (the wrapper
// checks). in_dtype: kE4M3, kE5M2 or kI8; out_dtype and scaled as
// cubecl_matmul's (matmul.cu). Returns cudaGetLastError() after the last
// launch, or cudaErrorInvalidValue for a type or tile this library was not
// built for.
extern "C" int cubecl_matmul8(const void* a, const void* b, void* c,
                              void* scratch, const float* sa,
                              const float* sb, int in_dtype, int out_dtype,
                              int M, int N, int K, int tm, int tn, int tk,
                              int b_transposed, int scaled, float scale,
                              void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype != kE4M3 && in_dtype != kE5M2 && in_dtype != kI8)
    return cudaErrorInvalidValue;
  bool built = false;
#define CUBECL_WG_BUILT(BM, BN, BKB) \
  built |= tm == BM && tn == BN && tk == BKB;
  CUBECL_WG_TILES(CUBECL_WG_BUILT)
#undef CUBECL_WG_BUILT
  if (!built) return cudaErrorInvalidValue;
  if (!b_transposed) {
    byte_transpose_kernel<<<dim3(N / 128, K / 128), 256, 0, st>>>(
        static_cast<const uint8_t*>(b), static_cast<uint8_t*>(scratch), K, N);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    b = scratch;
  }
#define CUBECL_WG_TILE(T, BM, BN, BKB)                                      \
  if (tm == BM && tn == BN)                                                 \
    return launch_gemm8<T, BM, BN>(a, b, c, M, N, K, out_dtype, scaled, sa, \
                                   sb, scale, st);
#define CUBECL_WG_E4M3(BM, BN, BKB) CUBECL_WG_TILE(E4M3, BM, BN, BKB)
#define CUBECL_WG_E5M2(BM, BN, BKB) CUBECL_WG_TILE(E5M2, BM, BN, BKB)
#define CUBECL_WG_S8(BM, BN, BKB) CUBECL_WG_TILE(S8, BM, BN, BKB)
  if (in_dtype == kE4M3) {
    CUBECL_WG_TILES(CUBECL_WG_E4M3)
  } else if (in_dtype == kE5M2) {
    CUBECL_WG_TILES(CUBECL_WG_E5M2)
  } else {
    CUBECL_WG_TILES(CUBECL_WG_S8)
  }
  return cudaErrorInvalidValue;
}
