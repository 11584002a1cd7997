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
// tensor cores (989 TFLOP/s) against 7.7 us for the bytes; in f32, off the
// tensor cores, 110 us of operations (67 TFLOP/s). Two bodies, by dtype:
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
// f32: the CUDA cores (conv3x3_kernel), on purpose (TF32 would not hold
// f32's 2e-5 / 1e-4, as for A8 and M1; the products are exact in f32):
// - a 256-thread block owns 2 output rows x 64 columns of one image, all 64
//   output channels; it stages the 4 input rows x 66 columns it needs, all
//   64 channels, as f32 in shared memory (zero outside the image), and the
//   whole (3, 3, 64, 64) weight tensor as f32: 211 KB, one block an SM;
// - warp w owns output channels 8w..8w+7, lane l the pixels (row 0 and 1,
//   columns l and l + 32): 32 accumulators a thread, fed per (tap, channel)
//   by two broadcast float4 weight reads and four conflict-free input reads.
#include <algorithm>

#include "hopper.cuh"

namespace cubecl {
namespace {

// the f32 body's launch plan: ops/conv.py's c1_plan repeats NT, (TR, TW),
// SMEM and the grid, and is held against cubecl_conv3x3_plan on the card
constexpr int CH = 64;            // channels in and out
constexpr int NT = 256;           // threads: 8 warps
constexpr int TW = 64;            // output columns a block covers
constexpr int TR = 2;             // output rows a block covers
constexpr int XR = TR + 2;        // staged input rows
constexpr int XC = TW + 2;        // staged input columns
constexpr int XS = XC + 1;        // row stride of a staged (row, channel)
constexpr int SMEM = (9 * CH * CH + XR * CH * XS) * 4;

template <typename T>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int H, int W, int cin) {
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);  // [tap][c][k]
  float* Xs = Ws + 9 * CH * CH;                 // [row][c][col], stride XS

  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TR;
  const int n = blockIdx.z;

  for (int i = tid; i < 9 * CH * CH / 4; i += NT) {
    float e[4];
    load4(w + i * 4, e);
    *reinterpret_cast<float4*>(&Ws[i * 4]) = make_float4(e[0], e[1], e[2], e[3]);
  }
  // input (h0 - 1 + r, w0 - 1 + col, c): 4 channels a thread, neighbouring
  // threads on neighbouring channels of a pixel
  const T* xn = x + (int64_t)n * H * W * CH;
  for (int i = tid; i < XR * XC * (CH / 4); i += NT) {
    const int c4 = i % (CH / 4);
    const int col = (i / (CH / 4)) % XC;
    const int r = i / (CH / 4 * XC);
    const int h = h0 - 1 + r, ww = w0 - 1 + col;
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    if (h >= 0 && h < H && ww >= 0 && ww < W && c4 * 4 < cin) {
      load4(xn + ((int64_t)h * W + ww) * CH + c4 * 4, e);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c4 * 4 + j >= cin) e[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) Xs[(r * CH + c4 * 4 + j) * XS + col] = e[j];
  }
  __syncthreads();

  const int lane = tid % 32;
  const int k0 = (tid / 32) * 8;  // this warp's 8 output channels
  // pixel p: row p / 2, column lane + 32 * (p % 2)
  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  for (int dy = 0; dy < 3; ++dy) {
    for (int dx = 0; dx < 3; ++dx) {
      const float* wt = Ws + (dy * 3 + dx) * CH * CH + k0;
      const float* xt = Xs + dy * CH * XS + lane + dx;
#pragma unroll 4
      for (int c = 0; c < CH; ++c) {
        const float4 wa = *reinterpret_cast<const float4*>(wt + c * CH);
        const float4 wb = *reinterpret_cast<const float4*>(wt + c * CH + 4);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const float* xc = xt + c * XS;
        const float xv[4] = {xc[0], xc[32], xc[CH * XS], xc[CH * XS + 32]};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[p][j] = fmaf(xv[p], wv[j], acc[p][j]);
      }
    }
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int h = h0 + p / 2, ww = w0 + lane + 32 * (p % 2);
    if (h >= H || ww >= W) continue;
    T* o = out + (((int64_t)n * H + h) * W + ww) * CH + k0;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = from_float<T>(acc[p][j]);
  }
}

template <typename T>
cudaError_t launch_conv3x3(const void* x, const void* w, void* out, int N,
                           int H, int W, int cin, cudaStream_t stream) {
  // above 48 KB a kernel must opt in to dynamic shared memory, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((W + TW - 1) / TW, (H + TR - 1) / TR, N);
  conv3x3_kernel<T><<<grid, NT, SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), H, W, cin);
  return cudaGetLastError();
}

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

}  // namespace
}  // namespace cubecl

// x (N, H, W, 64) and out (N, H, W, 64), w (3, 3, 64, 64): contiguous, one
// dtype (f32 or bf16), N, H, W >= 1; input channels from cin on read as
// zero. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another dtype.
extern "C" int cubecl_conv3x3(const void* x, const void* w, void* out,
                              int dtype, int N, int H, int W, int cin,
                              void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_conv3x3<float>(x, w, out, N, H, W, cin, st);
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
    plan[0] = NT;
    plan[1] = TR;
    plan[2] = TW;
    plan[3] = SMEM;
    plan[4] = (W + TW - 1) / TW;
    plan[5] = (H + TR - 1) / TR;
    plan[6] = N;
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
