// Paged decode attention for Hopper (sm_90a): the serving decode kernel.
//
// Replaces the TPU decode kernels of cubecl_tpu/ops/paged_attention.py:
//   P1 _paged_call_headed (static capacity grid, used under jit) and
//   P2 _paged_call_live (grid over a compacted list of live work, used in
//   eager decode). Both compute the same function; they differ only in how
//   Mosaic's grid skips dead pages. Here one block per (kv head, batch row)
//   reads its own block-table row and loops over exactly ceil(len / 64)
//   position tiles, so dead pages cost nothing and no work list is built.
//
// Math (as P1/P2): the G = H / Hkv query rows of one kv head against that
// head's pages of layer `layer` in the stacked pool (L, Hkv, P, page, D);
// base-2 online softmax over positions < lengths[b] with f32 statistics and
// accumulator; a row of length 0 gets zeros.
//
// Bound on the H100: decode reads every cached K/V byte once per step and
// does ~2G flops per byte, so HBM bandwidth bounds it. Each tile of 64
// positions is fetched with 16-byte loads, 8 in flight per thread (K and V of
// a quarter row); K stays in registers for the scores, V goes to shared
// memory for the P.V product. One block per (kv head, row) keeps the design
// simple; at small B*Hkv it leaves SMs idle, which a split over positions
// (flash-decoding) and cp.async double buffering would fix later.
#include "common.cuh"

namespace cubecl {
namespace {

constexpr int PT = 64;     // positions per tile (one per 4 threads)
constexpr int PNT = 256;   // threads per block
constexpr int MAXG = 8;    // query rows per kv head supported

template <typename T, int D>
__global__ void __launch_bounds__(PNT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ o, int H,
                    int Hkv, int G, int layer, int P, int page, int max_pages,
                    float scale_log2) {
  constexpr int EPC = Chunk<T>::N;        // elements per 16-byte chunk
  constexpr int CPT = D / 4 / EPC;        // chunks per thread (a quarter row)
  constexpr int PARTS = PNT / D;          // position groups of the P.V phase
  // V rows padded so the float4 stores of 8 lanes hit 8 distinct bank groups
  constexpr int VS = D + (EPC == 8 ? 4 : 16);
  static_assert(PARTS * MAXG * D <= PT * VS, "combine buffer must fit in vs");
  __shared__ __align__(16) float qs[MAXG * D];
  __shared__ __align__(16) float vs[PT * VS];
  __shared__ float ss[MAXG * PT];
  __shared__ float m_s[MAXG], l_s[MAXG], a_s[MAXG];

  const int tid = threadIdx.x;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lengths[b];
  T* op = o + ((int64_t)b * H + (int64_t)hk * G) * D;
  if (len <= 0) {  // nothing cached yet: zeros, as P1's l == 0 guard gives
    for (int i = tid; i < G * D; i += PNT) op[i] = from_float<T>(0.f);
    return;
  }
  const T* qp = q + ((int64_t)b * H + (int64_t)hk * G) * D;
  for (int i = tid; i < G * D; i += PNT) qs[i] = to_float(qp[i]);
  if (tid < MAXG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int64_t head_page0 = ((int64_t)layer * Hkv + hk) * P;
  const int* tab = table + (int64_t)b * max_pages;

  const int tl = tid / 4;         // score phase: position in the tile
  const int quarter = tid % 4;    //   and which interleaved quarter of the row
  const int dcol = tid % D;       // P.V phase: output column
  const int part = tid / D;       //   and position group
  const int warp = tid / 32, lane = tid % 32;
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += PT) {
    const int t = t0 + tl;
    const bool valid = t < len;
    float kx[CPT * EPC], vx[CPT * EPC];
    if (valid) {
      const int64_t row = (head_page0 + tab[t / page]) * page + (t % page);
      const T* kr = kpool + row * D;
      const T* vr = vpool + row * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        Chunk<T>::load(kr + (c * 4 + quarter) * EPC, kx + c * EPC);
        Chunk<T>::load(vr + (c * 4 + quarter) * EPC, vx + c * EPC);
      }
    } else {
#pragma unroll
      for (int e = 0; e < CPT * EPC; ++e) kx[e] = vx[e] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < EPC; e += 4)
        *reinterpret_cast<float4*>(&vs[tl * VS + (c * 4 + quarter) * EPC + e]) =
            make_float4(vx[c * EPC + e], vx[c * EPC + e + 1],
                        vx[c * EPC + e + 2], vx[c * EPC + e + 3]);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            s = fmaf(qs[g * D + (c * 4 + quarter) * EPC + e], kx[c * EPC + e], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (quarter == 0) ss[g * PT + tl] = valid ? s * scale_log2 : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp g owns query row g (the tile holds >= 1 live
    // position, so the new max is finite)
    if (warp < G) {
      float* row = ss + warp * PT;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_old = m_s[warp];
      const float m_new = fmaxf(m_old, warp_max32(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float sum = warp_sum32(p0 + p1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        m_s[warp] = m_new;
        l_s[warp] = l_s[warp] * alpha + sum;
        a_s[warp] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float a = acc[g] * a_s[g];
        for (int tt = part; tt < PT; tt += PARTS)
          a = fmaf(ss[g * PT + tt], vs[tt * VS + dcol], a);
        acc[g] = a;
      }
    }
    __syncthreads();  // vs and ss are rewritten by the next tile
  }

  // sum the PARTS partial accumulators (vs is free now)
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) vs[(part * MAXG + g) * D + dcol] = acc[g];
  __syncthreads();
  for (int i = tid; i < G * D; i += PNT) {
    const int g = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) s += vs[(p * MAXG + g) * D + d];
    const float l = l_s[g];
    op[i] = from_float<T>(l == 0.f ? 0.f : s * (1.f / l));
  }
}

template <typename T, int D>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const void* table, const void* lengths, void* o,
                         int B, int H, int Hkv, int layer, int P, int page,
                         int max_pages, float scale_log2, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  paged_decode_kernel<T, D><<<grid, PNT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(o), H, Hkv, H / Hkv,
      layer, P, page, max_pages, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cubecl

// q (B, H, D); k_pages/v_pages (L, Hkv, P, page, D); table (B, max_pages)
// int32; lengths (B,) int32; o (B, H, D). Contiguous, q/pools/o one dtype.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a dtype / head_dim / group size this kernel was not built for.
extern "C" int cubecl_paged_decode(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, void* o, int dtype,
                                   int B, int H, int Hkv, int D, int layer,
                                   int P, int page, int max_pages,
                                   float scale_log2, void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXG) return cudaErrorInvalidValue;
#define CUBECL_PAGED(T, HD)                                                 \
  launch_paged<T, HD>(q, k_pages, v_pages, table, lengths, o, B, H, Hkv,    \
                      layer, P, page, max_pages, scale_log2, st)
  if (dtype == kF32 && D == 64) return CUBECL_PAGED(float, 64);
  if (dtype == kF32 && D == 128) return CUBECL_PAGED(float, 128);
  if (dtype == kBF16 && D == 64) return CUBECL_PAGED(__nv_bfloat16, 64);
  if (dtype == kBF16 && D == 128) return CUBECL_PAGED(__nv_bfloat16, 128);
#undef CUBECL_PAGED
  return cudaErrorInvalidValue;
}
