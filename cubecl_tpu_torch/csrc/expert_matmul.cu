// Per-expert GEMM with dead-tile skipping for Hopper (sm_90a).
//
// Replaces the TPU kernel E1 of cubecl_tpu/ops/moe.py: expert_matmul
// (pallas_call :97). out[e] = cast(xg[e] @ w[e]) for xg (E, cap, d), w (E,
// d, f) -> out (E, cap, f), f32 or bf16 operands, f32 accumulation, the
// output in xg's dtype. Rows at or past counts[e] (clamped to [0, cap]) are
// neither read into a live row's product nor written: their output is
// undefined, as in the JAX kernel, and moe_combine masks them.
//
// Bound on the H100: the live rows' operations, 2 * sum_e(counts[e]) * d *
// f, over the dtype's peak (bf16 989 TFLOP/s; f32 off the tensor cores, 67),
// or the bytes of the live rows and of the weights of the experts with a
// live row over 3.35 TB/s, whichever is larger: the 0.77B MoE prefill
// (16384 live rows, d 2048, f 5632) is bound by operations at 0.382 ms, a
// decode step (16 live rows) by the live experts' weights (0.048 ms).
//
// bf16: M1's wgmma body (wgmma_gemm.cuh's wgmma_gemm), persistent blocks
// on a schedule of the live tiles only (ExpertTiles):
// - the counts are read on the device by every block (no host sync), and a
//   block walks tile indices of the live (expert, n-tile, m-tile) tiles
//   alone, m-tiles of an expert innermost, so the blocks in flight share
//   an expert's weight panels in L2. A dead tile (m0 >= counts[e]) is never
//   scheduled: it costs no block and moves no bytes, the counterpart of the
//   TPU kernel's pl.when(t * bt < cnt[e]) and of its _t_live clamp.
// - xg arrives by a 3-D tensor map over (E, cap, d bytes), K-major; rows
//   past cap zero-fill within the expert, never reading the next expert's
//   rows. w by a 3-D map over (E, d, f bytes), MN-major panels of 64
//   columns x 64 rows of K that the 16-bit wgmma reads with its transpose
//   bit. A d that is a multiple of 32 but not of 64 leaves a last stage
//   that both maps zero-fill (exact).
// - prefill and decode, which the host cannot tell apart without a sync
//   (cap is the same; only counts differ), take two tiles of one kernel,
//   chosen on the device from the counts that every block reads: 128 x 256
//   (a ring of 3 stages) where its live tiles give every block at least
//   two, else 128 x 128 (6 stages, 16 KB of w each: 96 KB in flight a
//   block). Prefill is bound by operations, which the wide tile's
//   m64n256 wgmma serves best; decode by the weights' bytes, where what
//   counts is the live tiles against 132 SMs: the decode down projection
//   (f 2048) has 16 n-tiles x 8 experts = 128 live tiles at BN 128, 64 at
//   BN 256. Both tiles read the same tensor maps (boxes of 128 rows of xg,
//   64 rows of K of w).
// - the epilogue rounds the f32 sums to bf16 and stores them by TMA from
//   shared memory where all of a consumer's rows are live (a 3-D map over
//   (E, cap, f bytes)); a tile with rows at or past counts[e] stores its
//   live rows from the registers and skips the others.
// f32 runs on the CUDA cores (fma_tile_mainloop of mma_tile.cuh, TF32
// misses the f32 tolerance, as in M1) on a grid of (n-tile, m-tile,
// expert) whose blocks return at once past counts[e].
#include <mutex>

#include "wgmma_gemm.cuh"

namespace cubecl {
namespace {

// the tiles: bf16 (BM, BN, bytes of K a stage) and the wide tile's BN, f32
// (BM, BN, K a stage); ops/moe.py's EXPERT_TILES and EXPERT_WIDE_BN list
// the same
constexpr int WG_BM = 128, WG_BN = 128, WG_BKB = 128, WG_WIDE_BN = 256;
static_assert(WG_BKB == kGemmKB, "a stage of the wgmma body");
constexpr int FMA_BM = 64, FMA_BN = 64, FMA_BK = 16;

__device__ __forceinline__ int live_rows(const int* counts, int e, int cap) {
  return min(max(counts[e], 0), cap);
}

// E1's live tiles: expert e has ceil(live_e / BM) m-tiles by tn n-tiles,
// ordered expert, n-tile, m-tile. get() takes increasing t (a block's
// static stride), so a cursor over the experts (e, the tiles before it)
// only moves forward.
template <int BM, int BN>
struct ExpertTiles {
  const int* counts;
  int E, cap, tn;
  int e = 0, before = 0, live = -1;
  __device__ __forceinline__ bool get(int t, GemmJob& j) {
    for (;;) {
      if (e >= E) return false;
      if (live < 0) live = live_rows(counts, e, cap);
      const int mt = (live + BM - 1) / BM;
      if (t < before + mt * tn) {
        const int r = t - before;
        j.z = e;
        j.m0 = (r % mt) * BM;
        j.n0 = (r / mt) * BN;
        j.crow0 = static_cast<int64_t>(e) * cap + j.m0;
        j.row_end = static_cast<int64_t>(e) * cap + live;
        return true;
      }
      before += mt * tn;
      ++e;
      live = -1;
    }
  }
};

// The bf16 kernel: the wide tile (BM x WBN) when its live tiles give every
// block at least two (N a multiple of WBN), else BM x BN. Every block reads
// the same counts, so all take the same branch.
template <int BM, int BN, int WBN>
__global__ void __launch_bounds__(kGemmThreads, 1)
expert_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tc,
                    void* __restrict__ out, const int* __restrict__ counts,
                    int E, int cap, int N, int KT) {
  extern __shared__ uint8_t smem_raw[];
  int wide_tiles = 0;
  for (int e = 0; e < E; ++e)
    wide_tiles += (live_rows(counts, e, cap) + BM - 1) / BM * (N / WBN);
  if (N % WBN == 0 && wide_tiles >= 2 * static_cast<int>(gridDim.x))
    wgmma_gemm<BF16, BM, WBN, true, true>(
        smem_raw, &ta, &tb, &tc,
        ExpertTiles<BM, WBN>{counts, E, cap, N / WBN},
        out, N, KT, kBF16, 0, nullptr, nullptr, 1.f);
  else
    wgmma_gemm<BF16, BM, BN, true, true>(
        smem_raw, &ta, &tb, &tc, ExpertTiles<BM, BN>{counts, E, cap, N / BN},
        out,
        N, KT, kBF16, 0, nullptr, nullptr, 1.f);
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

// The weights' tensor map, by (address, shape): a model calls E1 with the
// same few weight tensors every step, and a map holds only the address, the
// shape and the strides, so a hit is right even when the memory has been
// freed and reused. A small table, replaced in turn.
cudaError_t weight_map(CUtensorMap* map, const void* w, int E, int K, int N) {
  struct Entry {
    const void* w;
    int E, K, N;
    CUtensorMap map;
  };
  constexpr int kSlots = 64;
  static Entry table[kSlots];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i)
    if (table[i].w == w && table[i].E == E && table[i].K == K &&
        table[i].N == N) {
      *map = table[i].map;
      return cudaSuccess;
    }
  const cudaError_t e = bytes_map(map, w, N * 2, K, 64, E);
  if (e != cudaSuccess) return e;
  table[next] = Entry{w, E, K, N, *map};
  next = (next + 1) % kSlots;
  used = used < kSlots ? used + 1 : kSlots;
  return cudaSuccess;
}

}  // namespace
}  // namespace cubecl

// xg (E, cap, K), w (E, K, N), out (E, cap, N), all contiguous, 16-byte
// aligned and of one dtype (kF32 or kBF16); counts (E,) int32 on the card.
// N % tn == 0, and K % tk == 0 for f32, K % 32 == 0 for bf16 (the wrapper
// checks); cap is any size >= 1. (tm, tn, tk) must be the dtype's tile.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a type, tile or grid this library does not take.
extern "C" int cubecl_expert_matmul(const void* xg, const void* w, void* out,
                                    const int* counts, int dtype, int E,
                                    int cap, int N, int K, int tm, int tn,
                                    int tk, void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535 || cap < 1) return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    constexpr int BM = WG_BM, BN = WG_BN, WBN = WG_WIDE_BN;
    if (tm != BM || tn != BN || tk * BF16::E != WG_BKB)
      return cudaErrorInvalidValue;
    constexpr int smem =
        WgGemmTile<BM, BN, 2>::SMEM > WgGemmTile<BM, WBN, 2>::SMEM
            ? WgGemmTile<BM, BN, 2>::SMEM
            : WgGemmTile<BM, WBN, 2>::SMEM;
    static const cudaError_t attr = cudaFuncSetAttribute(
        expert_wgmma_kernel<BM, BN, WBN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    CUtensorMap ta, tb, tc;
    cudaError_t e = bytes_map(&ta, xg, K * 2, cap, BM, E);
    if (e == cudaSuccess) e = weight_map(&tb, w, E, K, N);
    if (e == cudaSuccess) e = bytes_map(&tc, out, N * 2, cap, 64, E);
    if (e != cudaSuccess) return e;
    // the live tiles are known only on the device: as many blocks as the
    // most tiles there can be, at most one an SM
    const int64_t most =
        static_cast<int64_t>(E) * ((cap + BM - 1) / BM) * (N / BN);
    const int blocks = most < kGemmMaxBlocks ? static_cast<int>(most)
                                             : kGemmMaxBlocks;
    expert_wgmma_kernel<BM, BN, WBN><<<blocks, kGemmThreads, smem, st>>>(
        ta, tb, tc, out, counts, E, cap, N, (K * 2 + kGemmKB - 1) / kGemmKB);
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
