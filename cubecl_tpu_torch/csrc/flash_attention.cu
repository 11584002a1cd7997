// Flash-attention forward for Hopper (sm_90a): the prefill kernel.
//
// Replaces the TPU forward kernels of cubecl_tpu/ops/attention.py:
//   A1 _fwd_call (rectangular grid), A2 _fwd_call_tri (causal grid over live
//   tiles only) and A8 _fwd_call_packed (hd 32/64 heads packed on the MXU's
//   128 lanes). All three compute the same function; on this card one kernel
//   covers them: the packing exists only for the TPU's lane width, and A2's
//   live-tile enumeration is the causal early exit of the kv loop below.
//
// Math (as A1): o = softmax(q k^T * sm_scale) v with a base-2 online softmax
// (scores scaled by sm_scale*log2(e), exp2), f32 statistics and accumulator,
// causal mask col <= row (absolute positions), and the l == 0 guard in the
// epilogue. With an lse pointer (training), each row's base-2 log-sum-exp
// m + log2(l) of the scaled scores is written as f32 (B, H, Sq), the
// residual of the backward kernels (flash_attention_bwd.cu); A1's
// (..., 128) lane-broadcast layout of it exists only for the TPU and is not
// copied. Serving passes null and nothing is written. Unlike A1, the scale
// is applied to the f32 scores inside the kernel instead of being folded
// into q and rounded to q's dtype first, so in bf16 the two differ by that
// one rounding of q.
//
// Bound on the H100: at prefill sizes (S ~ 1k, D 64/128) attention is
// compute-bound. This first version runs the two inner products on the f32
// CUDA cores (no tensor cores): each 256-thread block owns a 64-row q tile of
// one (batch, head) and sweeps 64-row kv tiles staged in shared memory; every
// thread computes a 4x4 block of scores and a 4 x D/16 block of the output
// from float4 shared-memory reads, so the FMA pipe, not shared-memory
// bandwidth, is the limit. Tiles wholly above the diagonal are never
// visited. GQA: head h reads kv head h / (H / Hkv) directly, with no repeat.
// wgmma, TMA and a pipelined ring of kv tiles are for later versions.
//
// The same kernel body, with the block-sparse schedule of flash_tiles.cuh
// in place of the dense causal range, replaces A5 _bsp_fwd_call
// (block-sparse forward over build_block_schedule's kv_ids and counts):
// a block owns 64 rows of one user q tile and visits the kernel tiles of
// that tile's active kv tiles, with the JAX kernels' finite mask value.
#include "flash_tiles.cuh"

namespace cubecl {
namespace {

constexpr int BM = 64;       // q rows per block
constexpr int BN = 64;       // kv rows per tile
constexpr int NT = 256;      // threads: 16 x 16, each a 4x4 score block
constexpr int PS = BM + 4;   // row stride of the transposed P tile (floats)

template <int D>
constexpr int flash_smem_bytes() {
  // Qs [D][BM] + Ks [D][BN] + Vs [BN][D] + Ps [BN][PS], all f32
  return (D * BM + D * BN + BN * D + BN * PS) * 4;
}

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Skv,
                 float scale_log2, int causal, Tiles tiles) {
  constexpr int DC = D / 64;  // 4-wide column groups of the output per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [D][BM]  (q transposed)
  float* Ks = Qs + D * BM;                      // [D][BN]  (k transposed)
  float* Vs = Ks + D * BN;                      // [BN][D]
  float* Ps = Vs + BN * D;                      // [BN][PS] (p transposed)

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns tx*4.., output columns tx*4 + 64*c
  const int ty = tid / 16;  // rows ty*4..ty*4+3
  int q0, q_end;  // the block's rows; rows from q_end on are not its own
  tiles.own(q0, q_end);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qp = q + ((int64_t)b * H + h) * Sq * D;
  const T* kp = k + ((int64_t)b * Hkv + hk) * Skv * D;
  const T* vp = v + ((int64_t)b * Hkv + hk) * Skv * D;
  T* op = o + ((int64_t)b * H + h) * Sq * D;

  // q tile -> Qs[d][m]; rows past q_end are zero (their output is not stored)
  for (int i = tid; i < BM * D / 4; i += NT) {
    const int m = i % BM, c = i / BM;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + m < q_end) load4(qp + (int64_t)(q0 + m) * D + c * 4, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) Qs[(c * 4 + e) * BM + m] = x[e];
  }

  float acc[4][4 * DC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * DC; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = tiles.count(q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    int k0, k_end;  // the tile's columns; those from k_end on are absent
    if (!tiles.visit(kt, q0, q_end, k0, k_end)) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BN * D / 4; i += NT) {
      const int n = i % BN, c = i / BN;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + n < k_end) {
        load4(kp + (int64_t)(k0 + n) * D + c * 4, x);
        load4(vp + (int64_t)(k0 + n) * D + c * 4, y);
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
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * BM + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&Ks[d * BN + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax, base 2; a row's 64 columns live in 16 lanes of a warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = col < k_end && (!causal || col <= row);
        if constexpr (Tiles::kSparse)  // causal: the finite mask value
          s[i][j] = ok ? s[i][j] * scale_log2
                       : (col < k_end ? kMaskValue : -INFINITY);
        else
          s[i][j] = ok ? s[i][j] * scale_log2 : -INFINITY;
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
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * PS + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Ps[n * PS + ty * 4]);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= q_end) continue;
    const float inv = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
    // every lane of the row's 16 holds its stats; a row with nothing live
    // gets 0, finite, and its masked columns give exp2(s - 0) = 0 anyway
    if (lse != nullptr && tx == 0)
      lse[((int64_t)b * H + h) * Sq + row] =
          l_i[i] == 0.f ? 0.f : m_i[i] + log2f(l_i[i]);
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        op[(int64_t)row * D + c * 64 + tx * 4 + j] =
            from_float<T>(acc[i][c * 4 + j] * inv);
  }
}

template <typename T, int D, typename Tiles>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int Hkv, int Sq, int Skv,
                         float scale_log2, int causal, int blocks,
                         Tiles tiles, cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<D>();
  // above 48 KB a kernel must opt in to dynamic shared memory, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, Tiles>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(blocks, H, B);
  flash_fwd_kernel<T, D, Tiles><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv, Sq, Skv,
      scale_log2, causal, tiles);
  return cudaGetLastError();
}

// the four (dtype, head_dim) instances of one schedule
template <typename Tiles>
int launch_flash_any(const void* q, const void* k, const void* v, void* o,
                     float* lse, int dtype, int B, int H, int Hkv, int Sq,
                     int Skv, int D, float scale_log2, int causal, int blocks,
                     Tiles tiles, cudaStream_t st) {
#define CUBECL_FLASH(T, HD)                                                   \
  launch_flash<T, HD, Tiles>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, scale_log2, \
                             causal, blocks, tiles, st)
  if (dtype == kF32 && D == 64) return CUBECL_FLASH(float, 64);
  if (dtype == kF32 && D == 128) return CUBECL_FLASH(float, 128);
  if (dtype == kBF16 && D == 64) return CUBECL_FLASH(__nv_bfloat16, 64);
  if (dtype == kBF16 && D == 128) return CUBECL_FLASH(__nv_bfloat16, 128);
#undef CUBECL_FLASH
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cubecl

extern "C" const char* cubecl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, H, Sq, D), k/v (B, Hkv, Skv, D), o (B, H, Sq, D): contiguous, one
// dtype; lse (B, H, Sq) f32, or null for none. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a dtype / head_dim this
// kernel was not built for.
extern "C" int cubecl_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, float* lse, int dtype, int B, int H,
                                int Hkv, int Sq, int Skv, int D,
                                float scale_log2, int causal, void* stream) {
  using namespace cubecl;
  return launch_flash_any(q, k, v, o, lse, dtype, B, H, Hkv, Sq, Skv, D,
                          scale_log2, causal, (Sq + BM - 1) / BM,
                          DenseQTiles{Sq, Skv, causal},
                          static_cast<cudaStream_t>(stream));
}

// A5, the block-sparse forward: q, k, v, o (B, H, S, D), one head count;
// lse (B, H, Sq) f32 or null; ids (n_q, stride) and counts (n_q,) int32, the
// schedule of the causally pruned block mask at user tiles (bq, bk) that
// divide Sq and Skv, every count >= 1. Returns as cubecl_flash_fwd.
extern "C" int cubecl_flash_bsp_fwd(const void* q, const void* k,
                                    const void* v, void* o, float* lse,
                                    const int* ids, const int* counts,
                                    int stride, int bq, int bk, int dtype,
                                    int B, int H, int Sq, int Skv, int D,
                                    float scale_log2, int causal,
                                    void* stream) {
  using namespace cubecl;
  const int q_sub = (bq + kFlashTile - 1) / kFlashTile;
  const int k_sub = (bk + kFlashTile - 1) / kFlashTile;
  const SparseQTiles tiles{ids, counts, stride, bq, bk, q_sub, k_sub,
                           causal, /*keep_f9=*/1, 0};
  return launch_flash_any(q, k, v, o, lse, dtype, B, H, H, Sq, Skv, D,
                          scale_log2, causal, (Sq / bq) * q_sub, tiles,
                          static_cast<cudaStream_t>(stream));
}
