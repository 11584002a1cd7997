// Small-channel 3x3 convolution for Hopper (sm_90a): C1.
//
// Replaces the TPU kernel C1 of cubecl_tpu/ops/conv.py,
// conv2d_pairs_packed (pallas_call :379): a 3x3, stride-1, SAME convolution
// with at most 64 input and 64 output channels, f32 accumulation, the output
// in the input's dtype. The TPU kernel works on the pixel-pair layout
// (N, H*W/2, 128), which puts two pixels on the 128 lanes of the MXU; in
// memory that layout is exactly NHWC with 64 channels a pixel, so this
// kernel reads and writes (N, H, W, 64) and computes the convolution the
// pairs encode. The pair packing, the rolls and the pre-rolled edge masks
// exist only for the TPU's lanes and are left behind.
//
// Semantics kept from the JAX kernel: the weights arrive zero-padded to
// (3, 3, 64, 64) and rounded to the input's dtype (the wrapper does both),
// so output channels K..63 come out as exact zeros; input channels from
// `cin` on are read as zeros, so what lies in the padded lanes never reaches
// the output; the H and W edges are zero-padded per image (no wrap).
//
// Bound on the H100: at ResNet-50's conv2_x shape (32, 56, 56, 64) -> 64 the
// work is 7.4 GFLOP over 25.7 MB (bf16): at the card's ridge, 7.5 us on the
// tensor cores (989 TFLOP/s) against 7.7 us for the bytes; in f32 as three
// TF32 products (495 TFLOP/s each) 44.8 us of operations against 110 us on
// the CUDA cores (67 TFLOP/s). Two bodies, by dtype, both on the tensor
// cores:
//
// bf16: an implicit GEMM on the tensor cores (conv3x3_wgmma_kernel). The
// output is a GEMM of M = the pixels, N = 64 output channels and K = 9 taps
// x 64 input channels; the A rows of a tap are the pixels shifted by it.
// - Persistent blocks: one a SM (at most 132), each walking the output
//   tiles in a static stride. The weights are loaded once a block, by TMA:
//   9 tap panels of 64 c x 128 bytes (k), 72 KB with the 128-byte swizzle,
//   which is the MN-major B operand of wgmma (B = W[tap], k contiguous).
// - A tile is TR output rows x TW columns of one image (TW = W up to 198
//   columns, wider images in equal column blocks; TR as many rows as a
//   stage of at most 600 halo pixels holds, and at most H). Its halo, TR + 2
//   rows x TW + 2 columns x 64 channels, arrives by one 4-D TMA copy of the
//   (N, H, W, C) tensor map whose C extent is cin: the copy's out-of-bounds
//   fill supplies the zero padding at the image's edges and the zero input
//   channels from cin on, so nothing in the padded lanes is ever read. A
//   ring of 2 halo stages on mbarriers, filled by one producer thread, loads
//   the next tile while the current one is computed. At (32, 56, 56, 64):
//   TR 8 x TW 56 = 448 pixels = 7 m64 blocks, a 10 x 58-pixel halo (73 KB a
//   stage); weights and two stages take 219 KB of the SM's 227.
// - Two consumer warpgroups take the tile's m64 blocks in turn: 64 pixels x
//   64 output channels, 32 f32 accumulators a thread, 9 taps x 4 k16 steps
//   = 36 wgmma m64n64k16. A, the shifted pixels, comes from registers:
//   ldmatrix takes one row address a lane, so each lane points at the halo
//   pixel (r + dy, c + dx) of its row, with the swizzle's XOR applied in that
//   address. The shift costs nothing and M needs no layout (ragged W such as
//   56 or 130 included); a block's padding rows read pixel 0 and are not
//   stored.
// - The epilogue rounds the sums to bf16 (nearest even) and stores them from
//   the registers, skipping pixels past H and W.
//
// f32: the same implicit GEMM as three TF32 products a k8 step
// (conv3x3_tf32x3_kernel), with hopper.cuh's split (tf32_split: big =
// x truncated to tf32, small = tf32(x - big); A_small B_big + A_big B_small
// + A_big B_big): one TF32 product would miss f32's 2e-5 / 1e-4, three hold
// it, as for M1's f32 GEMM. What does not carry over from the bf16 body:
// - The weights do not fit resident: 9 taps of 64 x 64 f32 are 147 KB, as
//   big and small tf32 halves 295 KB, more than a block's 227 KB. A small
//   kernel (conv3x3_split_weights_kernel) splits them once a call into a
//   scratch of 9 taps x {big, small} x 64 output x 64 input channels, and a
//   ring of 3 tap stages (each the tap's two halves, 2 x 16 KB) streams them
//   beside the halo: every m64 block pair of a tile reads the 9 taps anew
//   from L2 (288 KB for 128 pixels; L2's bandwidth, not the tensor cores,
//   is what this body's plan trades against).
// - TF32 wgmma has no transpose bit: both operands are K-major. A, the
//   shifted pixels with the channels contiguous, already is; B is W[tap]
//   laid out as (64 output, 64 input) with the input channel contiguous
//   (the transpose of the bf16 body's MN-major B), written so by the
//   split kernel. A 128-byte swizzle row holds 32 f32 channels, so a tap
//   is 2 panels (input channels 0-31, 32-63) of each half: 4 boxes of 64
//   rows x 128 bytes, 32 KB.
// - The f32 halo is twice the bf16 one: a pixel is 256 bytes, 2 panels
//   of 128 (channels 0-31 and 32-63), copied by 2 TMA boxes of 32 channels
//   x (TW + 2) x (TR + 2) from the same 4-D map (C extent cin: a box past
//   cin arrives as zeros). A stage holds at most 256 halo pixels (64 KB),
//   so TW is at most 83 columns (wider images in equal column blocks) and
//   TR as many rows as fit, at most H: at (32, 56, 56, 64) TR 2 x TW 56 =
//   112 pixels (2 m64 blocks, one a consumer), a 4 x 58 halo (58 KB a
//   stage). Shared memory: 3 tap stages (96 KB) + 2 halo stages (at most
//   128 KB) + barriers + the 1 KB alignment slack, at most 225 KB.
// - The tensor cores' f32 sums round toward zero (as the f32 GEMM found):
//   each tap's sums (K 64: 8 k8 steps x 3 products) start from zero in
//   their own wgmma accumulator and are added to f32 registers, never one
//   accumulator over all of K = 576.
// - The activations are split in registers after the row loads, as M1
//   f32's A is: ldmatrix.x4 of a 32-byte k8 column gives a lane its four
//   f32 of the RS fragment (each 32-bit word of an 8 x 8 b16 matrix is one
//   f32), with the per-lane shifted row address of the bf16 body (the shift
//   is free). The two consumers walk a tile's m64 blocks in pairs, in step
//   with the weight ring (a consumer without a block of its own still
//   waits on and releases each tap stage); each releases a halo stage after
//   a proxy fence (its ldmatrix reads before the next TMA copy, F11).
// - The epilogue stores the f32 sums from the registers, skipping pixels
//   past H and W.
#include <algorithm>

#include "hopper.cuh"
#include "wgmma_gemm.cuh"  // wgmma_tf32 (and hopper.cuh's tf32_split)

namespace cubecl {
namespace {

constexpr int CH = 64;  // channels in and out

// -- the bf16 body: an implicit GEMM on wgmma --------------------------------

constexpr int kWgThreads = 384;    // a producer warpgroup, two consumers
constexpr int kWgStages = 2;       // halo stages of the ring
constexpr int kMaxBlocks = 132;    // persistent blocks: the H100's SMs
constexpr int kTapBytes = CH * CH * 2;       // one tap's bf16 weights
constexpr int kWeightBytes = 9 * kTapBytes;  // 72 KB, resident
constexpr int kPixBytes = CH * 2;  // a pixel's 64 channels: a 128-byte row
constexpr int kMaxHalo = 600;      // halo pixels a stage may hold
constexpr int kMaxTW = 198;        // output columns a tile may span

// The bf16 launch plan of an (N, H, W) input; ops/conv.py's c1_plan
// repeats this arithmetic. A stage starts on a 1024-byte boundary (the
// swizzle atom), so its stride is the halo's bytes rounded up to 1024.
struct WgPlan {
  int tw, tr;          // output columns and rows of a tile
  int wb, hb;          // tiles across an image's W and down its H
  int tiles, blocks;   // tiles in all, persistent blocks
  int halo_bytes, stage_stride, smem;
};

inline WgPlan wg_plan(int N, int H, int W) {
  WgPlan p;
  p.wb = (W + kMaxTW - 1) / kMaxTW;
  p.tw = (W + p.wb - 1) / p.wb;
  p.tr = std::min(H, kMaxHalo / (p.tw + 2) - 2);
  p.hb = (H + p.tr - 1) / p.tr;
  p.tiles = N * p.hb * p.wb;
  p.blocks = std::min(p.tiles, kMaxBlocks);
  p.halo_bytes = (p.tr + 2) * (p.tw + 2) * kPixBytes;
  p.stage_stride = (p.halo_bytes + 1023) / 1024 * 1024;
  p.smem = kWeightBytes + kWgStages * p.stage_stride +
           (1 + 2 * kWgStages) * 8 + 1024;
  return p;
}

// the largest plan's shared memory, which the kernel opts in to once
constexpr int kWgMaxSmem =
    kWeightBytes + kWgStages * ((kMaxHalo * kPixBytes + 1023) / 1024 * 1024) +
    (1 + 2 * kWgStages) * 8 + 1024;
static_assert(kWgMaxSmem <= 232448, "weights and halo ring fit an SM");

__global__ void __launch_bounds__(kWgThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     __nv_bfloat16* __restrict__ out, int H, int W,
                     WgPlan p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* halo = smem + kWeightBytes;  // the ring, after the weights
  uint64_t* w_full = reinterpret_cast<uint64_t*>(
      halo + kWgStages * p.stage_stride);
  uint64_t* full = w_full + 1;
  uint64_t* empty = full + kWgStages;
  const int per_image = p.hb * p.wb;

  if (threadIdx.x == 0) {
    mbar_init(w_full, 1);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: one thread issues every copy -----------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    tma_prefetch_map(&tx);
    tma_prefetch_map(&tw);
    mbar_expect_tx(w_full, kWeightBytes);
    for (int t = 0; t < 9; ++t)
      tma_load_3d(smem + t * kTapBytes, &tw, w_full, 0, t * CH, 0);
    int st = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int n = t / per_image, hb = t / p.wb % p.hb, wb = t % p.wb;
      mbar_wait(&empty[st], phase ^ 1);  // the first round passes at once
      mbar_expect_tx(&full[st], p.halo_bytes);
      // the halo starts one row above and one column left of the tile;
      // rows, columns and channels outside the tensor arrive as zeros
      tma_load_4d(halo + st * p.stage_stride, &tx, &full[st], 0,
                  wb * p.tw - 1, hb * p.tr - 1, n);
      if (++st == kWgStages) {
        st = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // -- consumers: warpgroup c takes the tile's m64 blocks c, c + 2, ... ----
  setmaxnreg_inc<240>();
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int hw = p.tw + 2;  // halo pixels a halo row
  const int pix = p.tr * p.tw;
  const int mblocks = (pix + 63) / 64;
  // B of tap t, k16 step ks: the tap's panel from row 16 ks, MN-major
  const uint64_t dw = sw128_desc(smem_addr(smem), kTapBytes, 1024);

  mbar_wait(w_full, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int n = t / per_image, hb = t / p.wb % p.hb, wb = t % p.wb;
    const int h0 = hb * p.tr, w0 = wb * p.tw;
    mbar_wait(&full[st], phase);
    const uint32_t x_s = smem_addr(halo + st * p.stage_stride);
    for (int mb = c; mb < mblocks; mb += 2) {
      // the A row this lane addresses for ldmatrix: pixel q of the tile
      // (rows 16 warp + lane % 16 of the block; channel chunk lane / 16)
      int q = mb * 64 + warp * 16 + (lane & 15);
      if (q >= pix) q = 0;  // a padding row: its sums are not stored
      const int qr = q / p.tw;
      const int hp0 = qr * hw + (q - qr * p.tw);  // its halo pixel at tap 0
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        uint32_t a[3][4][4];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int hp = hp0 + dy * hw + dx;
          const uint32_t row = x_s + hp * kPixBytes;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            ldsm_x4(a[dx][ks],
                    row + ((((2 * ks) | (lane >> 4)) ^ (hp & 7)) << 4));
        }
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_rs_m64n64(
                acc, a[dx][ks],
                dw + (((dy * 3 + dx) * kTapBytes + ks * 16 * kPixBytes) >> 4));
        wgmma_commit();
        wgmma_wait0();
      }
      reg_fence(acc);
      // this thread's sums: rows 16 warp + lane / 4 (+ 8), channels
      // 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qo = mb * 64 + warp * 16 + lane / 4 + 8 * i;
        if (qo >= pix) continue;
        const int r = qo / p.tw;
        const int h = h0 + r, w = w0 + qo - r * p.tw;
        if (h >= H || w >= W) continue;
        __nv_bfloat16* o =
            out + (((int64_t)n * H + h) * W + w) * CH + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(o + 8 * j) =
              pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with it
    if (++st == kWgStages) {
      st = 0;
      phase ^= 1;
    }
  }
}

// x (N, H, W, 64) bf16 as a 4-D tensor map of halo boxes: C of extent cin
// (channels from cin on read as zeros), a pixel's row 128 bytes apart, box
// 64 channels x (TW + 2) x (TR + 2) x 1, 128-byte swizzle
inline cudaError_t halo_map(CUtensorMap* map, const void* x, int N, int H,
                            int W, int cin, const WgPlan& p) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)kPixBytes,
                                 (cuuint64_t)W * kPixBytes,
                                 (cuuint64_t)H * W * kPixBytes};
  const cuuint32_t box[4] = {(cuuint32_t)CH, (cuuint32_t)(p.tw + 2),
                             (cuuint32_t)(p.tr + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_conv3x3_wgmma(const void* x, const void* w, void* out,
                                 int N, int H, int W, int cin,
                                 cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgMaxSmem);
  if (attr != cudaSuccess) return attr;
  const WgPlan p = wg_plan(N, H, W);
  // the maps are kernel parameters (__grid_constant__), encoded per call:
  // a captured CUDA graph keeps them with the launch
  CUtensorMap tx, tw;
  cudaError_t e = halo_map(&tx, x, N, H, W, cin, p);
  // the weights (3, 3, 64, 64) as 576 rows of 64: nine 64 x 64 boxes
  if (e == cudaSuccess) e = rows_map(&tw, w, CH, 9 * CH, 1);
  if (e != cudaSuccess) return e;
  conv3x3_wgmma_kernel<<<p.blocks, kWgThreads, p.smem, stream>>>(
      tx, tw, static_cast<__nv_bfloat16*>(out), H, W, p);
  return cudaGetLastError();
}

// -- the f32 body: the implicit GEMM as three TF32 products a k8 step -------

constexpr int kF32Halo = 256;      // halo pixels a stage may hold (64 KB)
constexpr int kF32MaxTW = kF32Halo / 3 - 2;  // 83: a tile of one row fits
constexpr int kF32WStages = 3;     // tap stages of the weight ring
constexpr int kF32Panel = 64 * 128;  // 64 rows x 32 f32 (128 bytes)
constexpr int kF32TapBytes = 4 * kF32Panel;  // a tap's big and small halves

// The f32 launch plan of an (N, H, W) input; ops/conv.py's c1_plan repeats
// this arithmetic. A halo panel (one of the pixel's two 128-byte halves)
// starts on a 1024-byte boundary.
struct F32Plan {
  int tw, tr;          // output columns and rows of a tile
  int wb, hb;          // tiles across an image's W and down its H
  int tiles, blocks;   // tiles in all, persistent blocks
  int rounds;          // m64 block pairs of a tile
  int halo_px, panel;  // halo pixels, a halo panel's stride in bytes
  int smem;
};

inline F32Plan f32_plan(int N, int H, int W) {
  F32Plan p;
  p.wb = (W + kF32MaxTW - 1) / kF32MaxTW;
  p.tw = (W + p.wb - 1) / p.wb;
  p.tr = std::min(H, kF32Halo / (p.tw + 2) - 2);
  p.hb = (H + p.tr - 1) / p.tr;
  p.tiles = N * p.hb * p.wb;
  p.blocks = std::min(p.tiles, kMaxBlocks);
  p.rounds = ((p.tr * p.tw + 63) / 64 + 1) / 2;
  p.halo_px = (p.tr + 2) * (p.tw + 2);
  p.panel = (p.halo_px * 128 + 1023) / 1024 * 1024;
  p.smem = kF32WStages * kF32TapBytes + kWgStages * 2 * p.panel +
           2 * (kF32WStages + kWgStages) * 8 + 1024;
  return p;
}

// the largest plan's shared memory, which the kernel opts in to once
constexpr int kF32MaxSmem = kF32WStages * kF32TapBytes +
                            kWgStages * 2 * kF32Halo * 128 +
                            2 * (kF32WStages + kWgStages) * 8 + 1024;
static_assert(kF32MaxSmem <= 232448, "weight and halo rings fit an SM");

// w (3, 3, 64 in, 64 out) f32 -> ws [tap][big, small][out][in]: each weight
// split once (tf32_split) and transposed to the K-major B of TF32 wgmma
__global__ void conv3x3_split_weights_kernel(const float* __restrict__ w,
                                             float* __restrict__ ws) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (tap, out, in)
  if (i >= 9 * CH * CH) return;
  const int k = i % CH, n = i / CH % CH, tap = i / (CH * CH);
  uint32_t big, small;
  tf32_split(__float_as_uint(w[(tap * CH + k) * CH + n]), big, small);
  ws[((tap * 2) * CH + n) * CH + k] = __uint_as_float(big);
  ws[((tap * 2 + 1) * CH + n) * CH + k] = __uint_as_float(small);
}

__global__ void __launch_bounds__(kWgThreads, 1)
conv3x3_tf32x3_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      float* __restrict__ out, int H, int W, F32Plan p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* wring = smem;                                // the tap stages
  uint8_t* halo = smem + kF32WStages * kF32TapBytes;    // the halo stages
  const int hstride = 2 * p.panel;                      // a halo stage
  uint64_t* hfull = reinterpret_cast<uint64_t*>(halo + kWgStages * hstride);
  uint64_t* hempty = hfull + kWgStages;
  uint64_t* wfull = hempty + kWgStages;
  uint64_t* wempty = wfull + kF32WStages;
  const int per_image = p.hb * p.wb;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(&hfull[st], 1);
      mbar_init(&hempty[st], 8);  // lane 0 of every consumer warp
    }
    for (int st = 0; st < kF32WStages; ++st) {
      mbar_init(&wfull[st], 1);
      mbar_init(&wempty[st], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: one thread issues every copy -----------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    tma_prefetch_map(&tx);
    tma_prefetch_map(&tw);
    RingPos<kWgStages> hp;
    RingPos<kF32WStages> wp;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int n = t / per_image, hb = t / p.wb % p.hb, wb = t % p.wb;
      mbar_wait(&hempty[hp.st], hp.phase ^ 1);  // the first round passes
      mbar_expect_tx(&hfull[hp.st], 2 * p.halo_px * 128);
      // the halo starts one row above and one column left of the tile;
      // rows, columns and channels outside the tensor arrive as zeros
#pragma unroll
      for (int c = 0; c < 2; ++c)
        tma_load_4d(halo + hp.st * hstride + c * p.panel, &tx, &hfull[hp.st],
                    32 * c, wb * p.tw - 1, hb * p.tr - 1, n);
      hp.advance();
      for (int r = 0; r < p.rounds; ++r)
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(&wempty[wp.st], wp.phase ^ 1);
          mbar_expect_tx(&wfull[wp.st], kF32TapBytes);
          // boxes [big, small] x [in 0-31, in 32-63] of the tap
#pragma unroll
          for (int q = 0; q < 4; ++q)
            tma_load_3d(wring + wp.st * kF32TapBytes + q * kF32Panel, &tw,
                        &wfull[wp.st], 32 * (q % 2),
                        (tap * 2 + q / 2) * CH, 0);
          wp.advance();
        }
    }
    return;
  }

  // -- consumers: warpgroup c takes m64 block 2 r + c of round r ----------
  setmaxnreg_inc<240>();
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int hw = p.tw + 2;  // halo pixels a halo row
  const int pix = p.tr * p.tw;
  const int mblocks = (pix + 63) / 64;
  RingPos<kWgStages> hp;
  RingPos<kF32WStages> wp;
  float part[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) part[j] = 0.f;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int n = t / per_image, hb = t / p.wb % p.hb, wb = t % p.wb;
    const int h0 = hb * p.tr, w0 = wb * p.tw;
    mbar_wait(&hfull[hp.st], hp.phase);
    const uint32_t x_s = smem_addr(halo + hp.st * hstride);
    for (int r = 0; r < p.rounds; ++r) {
      const int mb = 2 * r + c;
      const bool live = mb < mblocks;
      // the A row this lane addresses for ldmatrix: pixel q of the tile
      // (rows 16 warp + lane % 16 of the block; k half lane / 16)
      int q = mb * 64 + warp * 16 + (lane & 15);
      if (q >= pix) q = 0;  // a padding row: its sums are not stored
      const int qr = q / p.tw;
      const int hp0 = qr * hw + (q - qr * p.tw);  // its halo pixel at tap 0
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        mbar_wait(&wfull[wp.st], wp.phase);
        if (live) {
          const int hpx = hp0 + (tap / 3) * hw + tap % 3;
          const uint32_t row = x_s + hpx * 128;
          // A's halves, the tap's 8 k8 steps (4 in each 32-channel panel)
          uint32_t ab[8][4], as[8][4];
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            uint32_t v[4];
            ldsm_x4(v, row + (s / 4) * p.panel +
                           ((((2 * (s % 4)) | (lane >> 4)) ^ (hpx & 7)) << 4));
#pragma unroll
            for (int j = 0; j < 4; ++j) tf32_split(v[j], ab[s][j], as[s][j]);
          }
          const uint32_t w_s = smem_addr(wring + wp.st * kF32TapBytes);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const uint32_t k = w_s + (s / 4) * kF32Panel + (s % 4) * 32;
            const uint64_t big = sw128_desc(k, 16, 1024);
            const uint64_t small = sw128_desc(k + 2 * kF32Panel, 16, 1024);
            wgmma_tf32(part, as[s], big, s);  // s 0: the tap's sums from 0
            wgmma_tf32(part, ab[s], small);
            wgmma_tf32(part, ab[s], big);
          }
          wgmma_commit();
          wgmma_wait0();
          acc_fence(part);
#pragma unroll
          for (int j = 0; j < 32; ++j) acc[j] += part[j];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&wempty[wp.st]);  // done with the tap
        wp.advance();
      }
      if (!live) continue;
      // this thread's sums: rows 16 warp + lane / 4 (+ 8), channels
      // 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qo = mb * 64 + warp * 16 + lane / 4 + 8 * i;
        if (qo >= pix) continue;
        const int rr = qo / p.tw;
        const int h = h0 + rr, w = w0 + qo - rr * p.tw;
        if (h >= H || w >= W) continue;
        float* o = out + (((int64_t)n * H + h) * W + w) * CH + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
    // this warp's ldmatrix reads of the stage come before the next TMA
    // copy into it (F11's order)
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&hempty[hp.st]);
    hp.advance();
  }
}

// x (N, H, W, 64) f32 as a 4-D tensor map of half-pixel halo boxes: C of
// extent cin (channels from cin on read as zeros), a pixel's row 256 bytes
// apart, box 32 channels (128 bytes) x (TW + 2) x (TR + 2) x 1, 128-byte
// swizzle
inline cudaError_t halo_map_f32(CUtensorMap* map, const void* x, int N,
                                int H, int W, int cin, const F32Plan& p) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)CH * 4,
                                 (cuuint64_t)W * CH * 4,
                                 (cuuint64_t)H * W * CH * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)(p.tw + 2),
                             (cuuint32_t)(p.tr + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the split weights (9 x 2 x 64 rows of 64 f32) as a tensor map of 64-row
// x 32-column boxes, 128-byte swizzle
inline cudaError_t split_weights_map(CUtensorMap* map, const void* ws) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)CH, (cuuint64_t)(9 * 2 * CH), 1};
  const cuuint64_t strides[2] = {(cuuint64_t)CH * 4,
                                 (cuuint64_t)9 * 2 * CH * CH * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)CH, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ws), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_conv3x3_tf32x3(const void* x, const void* w, void* out,
                                  float* ws, int N, int H, int W, int cin,
                                  cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kF32MaxSmem);
  if (attr != cudaSuccess) return attr;
  const F32Plan p = f32_plan(N, H, W);
  conv3x3_split_weights_kernel<<<(9 * CH * CH + 255) / 256, 256, 0,
                                 stream>>>(static_cast<const float*>(w), ws);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap tx, tw;
  e = halo_map_f32(&tx, x, N, H, W, cin, p);
  if (e == cudaSuccess) e = split_weights_map(&tw, ws);
  if (e != cudaSuccess) return e;
  conv3x3_tf32x3_kernel<<<p.blocks, kWgThreads, p.smem, stream>>>(
      tx, tw, static_cast<float*>(out), H, W, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cubecl

// x (N, H, W, 64) and out (N, H, W, 64), w (3, 3, 64, 64): contiguous, one
// dtype (f32 or bf16), N, H, W >= 1; input channels from cin on read as
// zero. scratch: f32's split weights, 9 x 2 x 64 x 64 floats (unused
// for bf16). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another dtype.
extern "C" int cubecl_conv3x3(const void* x, const void* w, void* out,
                              void* scratch, int dtype, int N, int H, int W,
                              int cin, void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_conv3x3_tf32x3(x, w, out, static_cast<float*>(scratch), N,
                                 H, W, cin, st);
  if (dtype == kBF16) return launch_conv3x3_wgmma(x, w, out, N, H, W, cin, st);
  return cudaErrorInvalidValue;
}

// C1's launch plan for a dtype and an (N, H, W) input: plan[0..6] =
// threads a block, output rows and columns of a tile, dynamic shared
// memory bytes a block, and the grid (x, y, z). Returns 0, or
// cudaErrorInvalidValue for another dtype.
extern "C" int cubecl_conv3x3_plan(int dtype, int N, int H, int W,
                                   int* plan) {
  using namespace cubecl;
  if (dtype == kF32) {
    const F32Plan p = f32_plan(N, H, W);
    plan[0] = kWgThreads;
    plan[1] = p.tr;
    plan[2] = p.tw;
    plan[3] = p.smem;
    plan[4] = p.blocks;
    plan[5] = 1;
    plan[6] = 1;
    return 0;
  }
  if (dtype == kBF16) {
    const WgPlan p = wg_plan(N, H, W);
    plan[0] = kWgThreads;
    plan[1] = p.tr;
    plan[2] = p.tw;
    plan[3] = p.smem;
    plan[4] = p.blocks;
    plan[5] = 1;
    plan[6] = 1;
    return 0;
  }
  return cudaErrorInvalidValue;
}
