// Per-expert GEMM with dead-tile skipping for Hopper (sm_90a).
//
// Replaces the TPU kernel E1 of cubecl_tpu/ops/moe.py: expert_matmul
// (pallas_call :97). out[e] = cast(xg[e] @ w[e]) for xg (E, cap, d), w (E,
// d, f) -> out (E, cap, f), f32 or bf16 operands, f32 accumulation, the
// output in xg's dtype. Rows at or past counts[e] (clamped to [0, cap]) are
// neither read nor written: their output is undefined, as in the JAX
// kernel, and moe_combine masks them.
//
// Bound on the H100: the live rows' operations, 2 * sum_e(counts[e]) * d *
// f, over the dtype's peak (bf16 989 TFLOP/s; f32 off the tensor cores, 67),
// or the bytes of the live rows and of the weights of the experts with a
// live row over 3.35 TB/s, whichever is larger: the 0.77B MoE prefill
// (16384 live rows, d 2048, f 5632) is bound by operations at 0.382 ms, a
// decode step (16 live rows) by the live experts' weights.
//
// Design, simple and right first: M1's tile loops (mma_tile.cuh) on a grid
// of (n-tile, m-tile, expert). A block reads counts[e] and returns at once
// when its m-tile starts at or past it: the counterpart of the TPU kernel's
// pl.when(t * bt < cnt[e]) and of its _t_live clamp, so a dead tile costs a
// block launch and moves no bytes. A live tile's rows past counts[e] (and
// so past cap) read the tile's last live row and are not stored, which
// masks the ragged tail of a capacity that is not a multiple of the tile.
// bf16 runs on the tensor cores (mma.sync), f32 on the CUDA cores (TF32
// misses the f32 tolerance, as in M1). One tile per dtype; wgmma and TMA
// come with M1's.
#include "mma_tile.cuh"

namespace cubecl {
namespace {

// the tiles: bf16 (BM, BN, bytes of K a stage), f32 (BM, BN, K a stage);
// ops/moe.py's EXPERT_TILES lists the same
constexpr int MMA_BM = 128, MMA_BN = 128, MMA_BKB = 64;
constexpr int FMA_BM = 64, FMA_BN = 64, FMA_BK = 16;

__device__ __forceinline__ int live_rows(const int* counts, int e, int cap) {
  return min(max(counts[e], 0), cap);
}

template <typename T, int BM, int BN, int BKB>
__global__ void __launch_bounds__(NT)
expert_mma_kernel(const uint8_t* __restrict__ xg, const uint8_t* __restrict__ w,
                  void* __restrict__ out, const int* __restrict__ counts,
                  int cap, int N, int K, int out_dtype) {
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int live = live_rows(counts, e, cap);
  if (m0 >= live) return;  // a dead tile
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t row0 = static_cast<int64_t>(e) * cap + m0;
  const int rows = min(BM, live - m0);
  typename T::Acc acc[BM / 32][BN / 32][4];
  mma_tile_mainloop<T, BM, BN, BKB, false>(
      smem, xg + row0 * K * T::E, rows,
      w + static_cast<int64_t>(e) * K * N * T::E, N, K, n0, acc);
  mma_tile_store<BM, BN>(Epilogue{out_dtype, 0, 1.f}, out, row0, rows, N, n0,
                         acc);
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(NT)
expert_fma_kernel(const float* __restrict__ xg, const float* __restrict__ w,
                  void* __restrict__ out, const int* __restrict__ counts,
                  int cap, int N, int K, int out_dtype) {
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int live = live_rows(counts, e, cap);
  if (m0 >= live) return;  // a dead tile
  extern __shared__ float4 smem4[];
  const int64_t row0 = static_cast<int64_t>(e) * cap + m0;
  const int rows = min(BM, live - m0);
  float acc[BM / 16][BN / 16];
  fma_tile_mainloop<BM, BN, BK, false>(
      reinterpret_cast<float*>(smem4), xg + row0 * K, rows,
      w + static_cast<int64_t>(e) * K * N, N, K, n0, acc);
  fma_tile_store<BM, BN>(Epilogue{out_dtype, 0, 1.f}, out, row0, rows, N, n0,
                         acc);
}

}  // namespace
}  // namespace cubecl

// xg (E, cap, K), w (E, K, N), out (E, cap, N), all contiguous, 16-byte
// aligned and of one dtype (kF32 or kBF16); counts (E,) int32 on the card.
// N % tn == 0 and K % tk == 0 (the wrapper checks); cap is any size >= 1.
// (tm, tn, tk) must be the dtype's tile. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a type, tile or grid this
// library does not take.
extern "C" int cubecl_expert_matmul(const void* xg, const void* w, void* out,
                                    const int* counts, int dtype, int E,
                                    int cap, int N, int K, int tm, int tn,
                                    int tk, void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535 || cap < 1) return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    constexpr int BM = MMA_BM, BN = MMA_BN, BKB = MMA_BKB;
    if (tm != BM || tn != BN || tk * BF16::E != BKB) return cudaErrorInvalidValue;
    constexpr int smem = MmaTile<BM, BN, BKB, false, BF16::E>::SMEM;
    static const cudaError_t attr = cudaFuncSetAttribute(
        expert_mma_kernel<BF16, BM, BN, BKB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(N / BN, (cap + BM - 1) / BM, E);
    expert_mma_kernel<BF16, BM, BN, BKB><<<grid, NT, smem, st>>>(
        static_cast<const uint8_t*>(xg), static_cast<const uint8_t*>(w), out,
        counts, cap, N, K, kBF16);
    return cudaGetLastError();
  }
  if (dtype == kF32) {
    constexpr int BM = FMA_BM, BN = FMA_BN, BK = FMA_BK;
    if (tm != BM || tn != BN || tk != BK) return cudaErrorInvalidValue;
    constexpr int smem = fma_smem_bytes<BM, BN, BK>();
    static_assert(smem <= 48 * 1024, "the f32 tile needs no opt-in");
    const dim3 grid(N / BN, (cap + BM - 1) / BM, E);
    expert_fma_kernel<BM, BN, BK><<<grid, NT, smem, st>>>(
        static_cast<const float*>(xg), static_cast<const float*>(w), out,
        counts, cap, N, K, kF32);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
