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
// work is 7.4 GFLOP over 25.7 MB (bf16): bound by operations on the tensor
// cores (7.5 us at 989 TFLOP/s), by bytes and operations alike in f32 on the
// CUDA cores (110 us at 67 TFLOP/s). This first version runs on the f32 CUDA
// cores for both dtypes (the products of bf16 values are exact in f32):
// - a 256-thread block owns 2 output rows x 64 columns of one image, all 64
//   output channels; it stages the 4 input rows x 66 columns it needs, all
//   64 channels, as f32 in shared memory (zero outside the image), and the
//   whole (3, 3, 64, 64) weight tensor as f32: 211 KB, one block an SM;
// - warp w owns output channels 8w..8w+7, lane l the pixels (row 0 and 1,
//   columns l and l + 32): 32 accumulators a thread, fed per (tap, channel)
//   by two broadcast float4 weight reads and four conflict-free input reads.
// Implicit GEMM on mma.sync (csrc/mma_tile.cuh) or wgmma, and a pipeline
// that overlaps the next rows' staging, are for later versions.
#include "common.cuh"

namespace cubecl {
namespace {

// the launch plan: ops/conv.py's C1_THREADS, C1_TILE and C1_SMEM copy NT,
// (TR, TW) and SMEM, and are held against cubecl_conv3x3_plan on the card
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

}  // namespace
}  // namespace cubecl

// x (N, H, W, 64) and out (N, H, W, 64), w (3, 3, 64, 64): contiguous, one
// dtype (f32 or bf16); input channels from cin on read as zero. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for another
// dtype.
extern "C" int cubecl_conv3x3(const void* x, const void* w, void* out,
                              int dtype, int N, int H, int W, int cin,
                              void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_conv3x3<float>(x, w, out, N, H, W, cin, st);
  if (dtype == kBF16)
    return launch_conv3x3<__nv_bfloat16>(x, w, out, N, H, W, cin, st);
  return cudaErrorInvalidValue;
}

// C1's launch plan: plan[0..3] = threads a block, output rows and columns a
// block, dynamic shared memory bytes a block. Returns 0.
extern "C" int cubecl_conv3x3_plan(int* plan) {
  using namespace cubecl;
  plan[0] = NT;
  plan[1] = TR;
  plan[2] = TW;
  plan[3] = SMEM;
  return 0;
}
