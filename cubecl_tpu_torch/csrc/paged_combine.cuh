// The second launch of a paged attention call whose positions are split
// over blocks (P1 in paged_attention.cu, P3's decode-shaped chunks in
// paged_chunked.cu): each split wrote, per query row, its unnormalised f32
// accumulator (D floats), then its running max m and sum l (base 2); this
// kernel rescales the splits of each row to their common max, adds them
// and divides by the summed l. A split that saw no position wrote m =
// -inf, l = 0 and weighs 0; a row no split saw gets zeros.
#pragma once

#include "common.cuh"

namespace cubecl {
namespace {

// the width of the instance that runs a head dim with none of its own (P1
// and P3's ragged instances): the next of 64, 128 and 256
inline int paged_ragged_width(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// part: per (b, kv head, split, row < G*C), D + 2 floats; o (B, H, C, D)
// of T, row r = g * C + i being query head hk * G + g, token i. Block
// (b * Hkv + kv head, row), D / 4 threads of 4 columns.
template <typename T, int D>
__global__ void __launch_bounds__(D / 4)
paged_combine_kernel(const float* __restrict__ part, T* __restrict__ o, int H,
                     int Hkv, int C, int splits) {
  const int bh = blockIdx.x, row = blockIdx.y;
  const int G = H / Hkv, GC = G * C;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int64_t stride = (int64_t)GC * (D + 2);  // one split to the next
  const float* pr = part + ((int64_t)bh * splits * GC + row) * (D + 2);
  float m = -INFINITY;
  for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, pr[sp * stride + D]);
  const float m_use = m == -INFINITY ? 0.f : m;
  float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < splits; ++sp) {
    const float* ps = pr + sp * stride;
    const float w = exp2f(ps[D] - m_use);  // 0 for a split with no position
    l += ps[D + 1] * w;
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] += ps[4 * threadIdx.x + e] * w;
  }
  const float inv = l == 0.f ? 1.f : 1.f / l;
  T* orow =
      o + (((int64_t)b * H + (int64_t)hk * G) * C + row) * D + 4 * threadIdx.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) orow[e] = from_float<T>(a[e] * inv);
}


// The same for a head dim dr below the instance's D (P1's and P3's ragged
// instances: a dr with no instance of its own runs in the next width D):
// part holds dr + 2 floats a row, o rows of dr; thread t combines the
// columns 4 t.. below dr.
template <typename T, int D>
__global__ void __launch_bounds__(D / 4)
paged_combine_ragged_kernel(const float* __restrict__ part,
                            T* __restrict__ o, int H, int Hkv, int C,
                            int splits, int dr) {
  const int bh = blockIdx.x, row = blockIdx.y;
  const int G = H / Hkv, GC = G * C;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int64_t stride = (int64_t)GC * (dr + 2);  // one split to the next
  const float* pr = part + ((int64_t)bh * splits * GC + row) * (dr + 2);
  float m = -INFINITY;
  for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, pr[sp * stride + dr]);
  const float m_use = m == -INFINITY ? 0.f : m;
  float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < splits; ++sp) {
    const float* ps = pr + sp * stride;
    const float w = exp2f(ps[dr] - m_use);  // 0 for a split with no position
    l += ps[dr + 1] * w;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * (int)threadIdx.x + e < dr) a[e] += ps[4 * threadIdx.x + e] * w;
  }
  const float inv = l == 0.f ? 1.f : 1.f / l;
  T* orow = o + (((int64_t)b * H + (int64_t)hk * G) * C + row) * dr;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (4 * (int)threadIdx.x + e < dr)
      orow[4 * threadIdx.x + e] = from_float<T>(a[e] * inv);
}

}  // namespace
}  // namespace cubecl
