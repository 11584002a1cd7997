// Whole-array sum for Hopper (sm_90a): R1.
//
// Replaces the TPU kernel R1 of cubecl_tpu/ops/reduce.py,
// _build_reduce_native (pallas_call :246): the f32 sum of a whole array of
// f32, bf16 or f16 elements, written to one f32.
//
// Bound on the H100: every input byte is read once and nothing else moves
// (the partials are a few KiB), so the kernel is bound by bytes: 64M f32
// (256 MiB) over 3.35 TB/s is 0.0801 ms, 64M bf16 0.0401 ms. The additions
// (one per element, in f32 on the CUDA cores) are far below their peak.
//
// Design. The TPU kernel walks its grid in order and carries a resident
// (1, 128) accumulator from one step to the next; Hopper's blocks run in
// parallel and in no order, so nothing may carry between them:
// - the array is cut into chunks of `chunk` elements (the wrapper's
//   block_rows x 128); block b takes chunks b, b + blocks, ... (a
//   grid-stride loop over chunks);
// - inside a chunk, each of the 256 threads reads 16-byte vectors (4 f32 or
//   8 bf16/f16), neighbouring threads on neighbouring addresses, four
//   vectors in flight per step, and adds them into one f32 accumulator;
// - a warp-shuffle butterfly, then a fold of the 8 warps' sums through
//   shared memory, gives one f32 partial per block, stored in a workspace;
// - a second, one-block launch folds the partials in a fixed order.
// No float atomicAdd: for a given (n, chunk, blocks) every addition happens
// in the same order in every run, so the result is the same to the bit.
//
// The wrapper (ops/reduce.py::reduce_sum_native) allocates the workspace
// and the output, checks that n is a multiple of 128 (so that no 16-byte
// vector straddles the end) and that the input is 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // threads of a partial block
constexpr int kFinalThreads = 1024; // threads of the final fold
constexpr int kInFlight = 4;        // 16-byte vectors a thread loads per step

// The f32 sum of one 16-byte vector of T.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static float sum(const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return (v.x + v.y) + (v.z + v.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static float sum(const __nv_bfloat16* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      s[i] = f.x + f.y;
    }
    return (s[0] + s[1]) + (s[2] + s[3]);
  }
};
template <> struct Vec16<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static float sum(const __half* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      s[i] = f.x + f.y;
    }
    return (s[0] + s[1]) + (s[2] + s[3]);
  }
};

// The sum of x over the block, valid in thread 0: a butterfly in each warp,
// then thread 0 adds the warps' sums in order.
template <int NT>
__device__ __forceinline__ float block_sum(float x, float* smem) {
  x = cubecl::warp_sum32(x);
  if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += smem[w];
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_partial_kernel(const T* __restrict__ x, float* __restrict__ partials,
                          int64_t n, int64_t chunk, int blocks) {
  constexpr int V = Vec16<T>::N;
  constexpr int64_t kStep = (int64_t)kThreads * V;
  __shared__ float smem[kThreads / 32];
  float acc = 0.f;
  for (int64_t c = blockIdx.x; c * chunk < n; c += blocks) {
    const int64_t end = (c + 1) * chunk < n ? (c + 1) * chunk : n;
    int64_t i = c * chunk + (int64_t)threadIdx.x * V;
    for (; i + (kInFlight - 1) * kStep < end; i += kInFlight * kStep) {
      float s[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) s[k] = Vec16<T>::sum(x + i + k * kStep);
      acc += (s[0] + s[1]) + (s[2] + s[3]);
    }
    for (; i < end; i += kStep) acc += Vec16<T>::sum(x + i);
  }
  const float s = block_sum<kThreads>(acc, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kFinalThreads)
    reduce_final_kernel(const float* __restrict__ partials,
                        float* __restrict__ out, int blocks) {
  __shared__ float smem[kFinalThreads / 32];
  float acc = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kFinalThreads) acc += partials[i];
  const float s = block_sum<kFinalThreads>(acc, smem);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T>
int launch(const void* x, float* partials, float* out, int64_t n,
           int64_t chunk, int blocks, cudaStream_t st) {
  reduce_partial_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), partials, n, chunk, blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_final_kernel<<<1, kFinalThreads, 0, st>>>(partials, out, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// out[0] = sum of x[0 .. n) in f32; partials holds `blocks` floats.
extern "C" int cubecl_reduce_sum(const void* x, float* partials, float* out,
                                 int64_t n, int64_t chunk, int blocks,
                                 int dtype, void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || chunk <= 0 || blocks <= 0 || n % 128 || chunk % 128)
    return cudaErrorInvalidValue;
  if (dtype == kF32) return launch<float>(x, partials, out, n, chunk, blocks, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, partials, out, n, chunk, blocks, st);
  if (dtype == kF16) return launch<__half>(x, partials, out, n, chunk, blocks, st);
  return cudaErrorInvalidValue;
}
