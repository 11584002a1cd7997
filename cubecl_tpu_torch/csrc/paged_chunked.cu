// Chunked paged attention for Hopper (sm_90a): C query tokens per sequence
// against the paged KV cache, causal inside the chunk. The verify step of
// speculative decoding, chunked prefill, and the prefill of the uncached
// suffix after a prefix-cache hit.
//
// Replaces the TPU kernel P3 of cubecl_tpu/ops/paged_attention.py,
// _paged_chunked_call. Math (as P3): query token i of row b sits at position
// starts[b] + i and attends the positions t <= starts[b] + i of its kv
// head's pages in layer `layer` of the stacked pool (L, Hkv, P, page, D),
// found through the row's block table; base-2 online softmax with f32
// statistics and accumulator; the l == 0 guard gives a row with no live
// position zeros. P3 relies on lengths[b] = starts[b] + C and masks only
// t <= starts[b] + i; this kernel also masks t < lengths[b], which is the
// same on such inputs. Table entries are clamped to [0, P). GQA: the G query
// heads of a kv head ride as rows r = g * C + i, as in P3. int8 KV: the K
// scale multiplies each score column and the V scale each probability
// column (the row sum takes the unscaled probability), as P3 does with its
// pre-gathered scale windows; here each position's scale is read through
// the same table lookup as its K/V row.
//
// Bound on the H100: the work ranges from decode-like to prefill-like. The
// speculative verify step (C = 5, G = 2: 10 query rows per kv head) reads
// every cached K/V byte for a few rows and is bandwidth-bound, like P1;
// chunked prefill (C = 256, G = 2: 512 rows) is a causal flash forward whose
// K/V come through the table and is compute-bound. This first version is
// A1's kernel (flash_attention.cu) with the table lookup in its K/V staging:
// one 256-thread block per (64-row tile of the G*C rows, kv head, batch
// row), f32 CUDA-core math from shared memory, and a loop over 64-position
// tiles that ends at the tile's last live position,
// min(lengths[b], starts[b] + max i of its rows + 1). At small G*C most of a
// tile's rows are idle (their threads skip the products), and at small
// B*Hkv SMs are idle: tensor cores, cp.async/TMA staging and a split over
// positions are for later versions.
#include <type_traits>

#include "common.cuh"

namespace cubecl {
namespace {

constexpr int BM = 64;       // query rows (of the G*C) per block
constexpr int BN = 64;       // positions per tile
constexpr int NT = 256;      // threads: 16 x 16, each a 4x4 score block
constexpr int PS = BM + 4;   // row stride of the transposed P tile (floats)

template <int D>
constexpr int chunked_smem_bytes() {
  // Qs [D][BM] + Ks [D][BN] + Vs [BN][D] + Ps [BN][PS] + 2 x [BN] scales
  return (D * BM + D * BN + BN * D + BN * PS + 2 * BN) * 4;
}

template <typename T, typename TK, int D>
__global__ void __launch_bounds__(NT)
paged_chunked_kernel(const T* __restrict__ q, const TK* __restrict__ kpool,
                     const TK* __restrict__ vpool,
                     const float* __restrict__ kscale,
                     const float* __restrict__ vscale,
                     const int* __restrict__ table,
                     const int* __restrict__ lengths,
                     const int* __restrict__ starts, T* __restrict__ o, int H,
                     int Hkv, int C, int layer, int P, int page, int max_pages,
                     float scale_log2) {
  constexpr bool QUANT = std::is_same<TK, int8_t>::value;
  constexpr int DC = D / 64;  // 4-wide column groups of the output per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [D][BM]  (q transposed)
  float* Ks = Qs + D * BM;                      // [D][BN]  (k transposed)
  float* Vs = Ks + D * BN;                      // [BN][D]
  float* Ps = Vs + BN * D;                      // [BN][PS] (p transposed)
  float* ksc = Ps + BN * PS;                    // [BN] int8: K scales
  float* vsc = ksc + BN;                        // [BN] int8: V scales

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns tx*4.., output columns tx*4 + 64*c
  const int ty = tid / 16;  // rows ty*4..ty*4+3
  const int G = H / Hkv;
  const int GC = G * C;
  // the tiles of late chunk tokens do the most work: schedule them first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int start = starts[b];
  const int64_t head_page0 = ((int64_t)layer * Hkv + hk) * P;
  const int* tab = table + (int64_t)b * max_pages;
  // row r = g * C + i is query head hk * G + g, token i: (B, H, C, D)
  const int64_t qrow0 = ((int64_t)b * H + (int64_t)hk * G) * C;

  // q tile -> Qs[d][m]; rows past G*C are zero (their output is not stored)
  for (int i = tid; i < BM * D / 4; i += NT) {
    const int m = i % BM, c = i / BM;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + m < GC) load4(q + (qrow0 + r0 + m) * D + c * 4, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) Qs[(c * 4 + e) * BM + m] = x[e];
  }

  float acc[4][4 * DC];
  float m_i[4], l_i[4];
  int qpos[4];  // each row's query position, or -1 past G*C (nothing live)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
    const int r = r0 + ty * 4 + i;
    qpos[i] = r < GC ? start + r % C : -1;
#pragma unroll
    for (int j = 0; j < 4 * DC; ++j) acc[i][j] = 0.f;
  }

  // the tile's last live position: its largest chunk token i
  const int r_end = min(r0 + BM, GC);
  int i_max = C - 1;
  if (r_end - r0 < C) {
    i_max = 0;
    for (int r = r0; r < r_end; ++r) i_max = max(i_max, r % C);
  }
  const int kv_end = min(len, start + i_max + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;
  // threads whose 4 rows all lie past G*C (most of the tile at the verify
  // step's G*C = 10) skip the products; they still stage K/V and join the
  // row reductions of their warp
  const bool rows_live = r0 + ty * 4 < GC;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BN * D / 4; i += NT) {
      const int n = i % BN, c = i / BN;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      const int t = k0 + n;
      if (t < kv_end) {
        const int pid = min(max(tab[t / page], 0), P - 1);
        const int64_t row = (head_page0 + pid) * page + (t % page);
        load4(kpool + row * D + c * 4, x);
        load4(vpool + row * D + c * 4, y);
        if (QUANT && c == 0) {
          ksc[n] = kscale[row];
          vsc[n] = vscale[row];
        }
      } else if (QUANT && c == 0) {
        ksc[n] = 0.f;
        vsc[n] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) Ks[(c * 4 + e) * BN + n] = x[e];
      *reinterpret_cast<float4*>(&Vs[n * D + c * 4]) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    if (rows_live) {
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 a =
            *reinterpret_cast<const float4*>(&Qs[d * BM + ty * 4]);
        const float4 bb =
            *reinterpret_cast<const float4*>(&Ks[d * BN + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
    }

    // online softmax, base 2; a row's 64 columns live in 16 lanes of a warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = col < len && col <= qpos[i];
        float x = s[i][j] * scale_log2;
        // int8: the K scale on the score column, after the base-2 scaling
        if (QUANT) x *= ksc[tx * 4 + j];
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = warp_max16(mx);
      const float m_new = fmaxf(m_i[i], mx);
      // a row with nothing live yet keeps p = 0 instead of exp2(nan)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_i[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);
        rs += s[i][j];
      }
      rs = warp_sum16(rs);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * DC; ++j) acc[i][j] *= alpha;
    }
    // int8: the V scale on the probability column (l took the unscaled p)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float vj = QUANT ? vsc[tx * 4 + j] : 1.f;
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * PS + ty * 4]) =
          make_float4(s[0][j] * vj, s[1][j] * vj, s[2][j] * vj, s[3][j] * vj);
    }
    __syncthreads();

    if (rows_live) {
#pragma unroll 4
      for (int n = 0; n < BN; ++n) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&Ps[n * PS + ty * 4]);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(&Vs[n * D + c * 64 + tx * 4]);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][c * 4 + j] = fmaf(pv[i], vv[j], acc[i][c * 4 + j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= GC) continue;
    const float inv = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
    T* orow = o + (qrow0 + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        orow[c * 64 + tx * 4 + j] = from_float<T>(acc[i][c * 4 + j] * inv);
  }
}

template <typename T, typename TK, int D>
cudaError_t launch_chunked(const void* q, const void* kp, const void* vp,
                           const float* ks, const float* vsc,
                           const void* table, const void* lengths,
                           const void* starts, void* o, int B, int H, int Hkv,
                           int C, int layer, int P, int page, int max_pages,
                           float scale_log2, cudaStream_t stream) {
  constexpr int smem = chunked_smem_bytes<D>();
  // above 48 KB a kernel must opt in to dynamic shared memory, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_chunked_kernel<T, TK, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int GC = (H / Hkv) * C;
  const dim3 grid((GC + BM - 1) / BM, Hkv, B);
  paged_chunked_kernel<T, TK, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TK*>(kp),
      static_cast<const TK*>(vp), ks, vsc, static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<T*>(o), H, Hkv, C, layer, P, page, max_pages, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cubecl

// q (B, H, C, D); k_pages/v_pages (L, Hkv, P, page, D); table (B, max_pages)
// int32; lengths and starts (B,) int32; o (B, H, C, D). Contiguous; q and o
// of `dtype` (f32 or bf16), the pools of `kv_dtype`: the same dtype, or int8
// with f32 scale pools k_scales/v_scales (L, Hkv, P, page) (null
// otherwise). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a dtype / head_dim this kernel was not built for.
extern "C" int cubecl_paged_chunked(const void* q, const void* k_pages,
                                    const void* v_pages, const float* k_scales,
                                    const float* v_scales, const void* table,
                                    const void* lengths, const void* starts,
                                    void* o, int dtype, int kv_dtype, int B,
                                    int H, int Hkv, int C, int D, int layer,
                                    int P, int page, int max_pages,
                                    float scale_log2, void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0 || C <= 0) return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kI8;
  if (quant != (k_scales != nullptr && v_scales != nullptr))
    return cudaErrorInvalidValue;
  if (!quant && kv_dtype != dtype) return cudaErrorInvalidValue;
#define CUBECL_CHUNKED(T, TK, HD)                                            \
  launch_chunked<T, TK, HD>(q, k_pages, v_pages, k_scales, v_scales, table,  \
                            lengths, starts, o, B, H, Hkv, C, layer, P, page, \
                            max_pages, scale_log2, st)
  if (dtype == kF32) {
    if (D == 64) return quant ? CUBECL_CHUNKED(float, int8_t, 64)
                              : CUBECL_CHUNKED(float, float, 64);
    if (D == 128) return quant ? CUBECL_CHUNKED(float, int8_t, 128)
                               : CUBECL_CHUNKED(float, float, 128);
  }
  if (dtype == kBF16) {
    if (D == 64)
      return quant ? CUBECL_CHUNKED(__nv_bfloat16, int8_t, 64)
                   : CUBECL_CHUNKED(__nv_bfloat16, __nv_bfloat16, 64);
    if (D == 128)
      return quant ? CUBECL_CHUNKED(__nv_bfloat16, int8_t, 128)
                   : CUBECL_CHUNKED(__nv_bfloat16, __nv_bfloat16, 128);
  }
#undef CUBECL_CHUNKED
  return cudaErrorInvalidValue;
}
