// The selective-scan recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel S1 of cubecl_tpu/ops/ssm.py: scan_chunked_core
// (pallas_call :235). For a, u of shape (B, L, DN):
//   h[b, t, c] = a[b, t, c] * h[b, t - 1, c] + u[b, t, c],  h[b, -1, c] = 0,
// carried in f32, each h rounded to a's dtype (f32 or bf16) when stored.
// The TPU kernel's chunk and hierarchical in-tile scan are two layouts of
// this one computation on the TPU's (8, 128) tiles; they change no result.
//
// Bound on the H100: bytes, each of a and u read once and h written once,
// 3 * B * L * DN elements over 3.35 TB/s (f32 (8, 2048, 24576): 1.44 ms).
// One multiply-add an element is far below the card's rate.
//
// Design, simple first: one thread per (b, channel) walks t in order, so
// the carry stays in a register and every h is one fmaf. Adjacent threads
// take adjacent channels, so each warp's loads and stores of one time step
// are coalesced. Each thread issues the loads of UNROLL time steps before
// the dependent multiply-adds, so that enough bytes are in flight to cover
// the memory latency. A split over L for small B * DN, and the
// discretization fused in (as Mamba's own kernel does), are later work.
#include "common.cuh"

namespace cubecl {
namespace {

constexpr int SCAN_THREADS = 256;
constexpr int UNROLL = 8;

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const T* __restrict__ a, const T* __restrict__ u, T* __restrict__ h,
            int L, int64_t DN) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * SCAN_THREADS + threadIdx.x;
  if (c >= DN) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * L * DN + c;
  float carry = 0.f;
  int t = 0;
  for (; t + UNROLL <= L; t += UNROLL) {
    float av[UNROLL], uv[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int64_t idx = base + static_cast<int64_t>(t + i) * DN;
      av[i] = to_float(a[idx]);
      uv[i] = to_float(u[idx]);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      carry = fmaf(av[i], carry, uv[i]);
      h[base + static_cast<int64_t>(t + i) * DN] = from_float<T>(carry);
    }
  }
  for (; t < L; ++t) {
    const int64_t idx = base + static_cast<int64_t>(t) * DN;
    carry = fmaf(to_float(a[idx]), carry, to_float(u[idx]));
    h[idx] = from_float<T>(carry);
  }
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                const T* __restrict__ dh, T* __restrict__ da,
                T* __restrict__ du, int L, int64_t DN) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * SCAN_THREADS + threadIdx.x;
  if (c >= DN) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * L * DN + c;
  float g = 0.f;
  float a_next = 0.f;  // a[t + 1]; g is 0 past the end, so any value does
  int t = L - 1;
  for (; t + 1 >= UNROLL; t -= UNROLL) {
    float av[UNROLL], hv[UNROLL], dv[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int64_t idx = base + static_cast<int64_t>(t - i) * DN;
      av[i] = to_float(a[idx]);
      dv[i] = to_float(dh[idx]);
      hv[i] = t - i > 0 ? to_float(h[idx - DN]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int64_t idx = base + static_cast<int64_t>(t - i) * DN;
      g = fmaf(a_next, g, dv[i]);
      du[idx] = from_float<T>(g);
      da[idx] = from_float<T>(g * hv[i]);
      a_next = av[i];
    }
  }
  for (; t >= 0; --t) {
    const int64_t idx = base + static_cast<int64_t>(t) * DN;
    g = fmaf(a_next, g, to_float(dh[idx]));
    du[idx] = from_float<T>(g);
    da[idx] = from_float<T>(t > 0 ? g * to_float(h[idx - DN]) : 0.f);
    a_next = to_float(a[idx]);
  }
}

template <typename T>
cudaError_t launch_scan_bwd(const void* a, const void* h, const void* dh,
                            void* da, void* du, int B, int L, int64_t DN,
                            cudaStream_t st) {
  const int64_t blocks = (DN + SCAN_THREADS - 1) / SCAN_THREADS;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  scan_bwd_kernel<T><<<dim3(static_cast<unsigned>(blocks), B), SCAN_THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<T*>(da), static_cast<T*>(du), L,
      DN);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scan(const void* a, const void* u, void* h, int B, int L,
                        int64_t DN, cudaStream_t st) {
  const int64_t blocks = (DN + SCAN_THREADS - 1) / SCAN_THREADS;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  scan_kernel<T><<<dim3(static_cast<unsigned>(blocks), B), SCAN_THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(u), static_cast<T*>(h), L,
      DN);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cubecl

// a, u, h (B, L, DN), contiguous and of one dtype (kF32 or kBF16); B in
// [1, 65535], L >= 1, DN >= 1. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a type or shape this kernel does not take.
extern "C" int cubecl_selective_scan(const void* a, const void* u, void* h,
                                     int dtype, int B, int L, int64_t DN,
                                     void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || L < 1 || DN < 1) return cudaErrorInvalidValue;
  if (dtype == kF32) return launch_scan<float>(a, u, h, B, L, DN, st);
  if (dtype == kBF16) return launch_scan<__nv_bfloat16>(a, u, h, B, L, DN, st);
  return cudaErrorInvalidValue;
}

// The backward: a, h, dh in, da, du out, all (B, L, DN), contiguous and of
// one dtype (kF32 or kBF16); the same limits and return codes as
// cubecl_selective_scan.
extern "C" int cubecl_selective_scan_bwd(const void* a, const void* h,
                                         const void* dh, void* da, void* du,
                                         int dtype, int B, int L, int64_t DN,
                                         void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || L < 1 || DN < 1) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_scan_bwd<float>(a, h, dh, da, du, B, L, DN, st);
  if (dtype == kBF16)
    return launch_scan_bwd<__nv_bfloat16>(a, h, dh, da, du, B, L, DN, st);
  return cudaErrorInvalidValue;
}
