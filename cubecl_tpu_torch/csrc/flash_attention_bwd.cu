// Flash-attention backward for Hopper (sm_90a): the training kernels.
//
// Replaces the TPU backward kernels of cubecl_tpu/ops/attention.py:
//   A3 _bwd_dkv_call (dK, dV; rectangular or triangular grid) and
//   A4 _bwd_dq_call (dQ; rectangular or triangular grid),
// the two halves of the custom_vjp's _bwd. Both recompute the probabilities
// from the forward's residuals instead of storing them:
//   s  = q k^T * sm_scale*log2(e)        masked: col <= row (causal, absolute
//                                        positions), col < Skv, row < Sq
//   p  = exp2(s - lse)                   lse: the forward's base-2 row stats
//   dV = p^T dO        dP = dO v^T       di = rowsum(dO * o), from o in the
//   dS = p * (dP - di) * sm_scale        output dtype (computed by the caller)
//   dK = dS^T q        dQ = dS k
// Masked entries get p = 0 by a select, so a row with nothing live gives no
// NaN whatever its lse.
//
// The TPU grid carries the dK/dV (or dQ) accumulator across sequential grid
// steps; here blocks run in parallel and in no order, so each block owns its
// output tile and loops over the other side itself:
//   dkv: one block per 64-row kv tile of one (batch, kv head). It loops over
//        the H / Hkv query heads of the kv head's group and, for each, over
//        the q tiles that can see the tile: under causal, from the tile that
//        holds row k0 to the end (A3's triangular schedule as a loop bound).
//        The group sum that JAX gets from the transpose of jnp.repeat happens
//        in the block's registers: no atomics, a deterministic result.
//        Blocks with small k0 have the most causal work and are scheduled
//        first.
//   dq:  one block per 64-row q tile of one (batch, head), looping over the
//        kv tiles up to the diagonal; the bottom tiles (most work) go first.
// Rows past Sq / Skv of a staged tile are zero-filled and never stored, so
// any S works (the train shape is S = 1023); no padding to 128.
//
// Bound on the H100: like the forward, this first version is compute-bound
// on the f32 CUDA cores (no tensor cores). 256 threads; every thread holds a
// 4x4 block of s/p/dS and a 4 x D/16 block of each output accumulator, and
// reads its operands as float4 from shared memory, where every tile is
// staged in f32: q, dO and k, v transposed for the two score products, and
// row-major where they are the right operand of a product. That is 210 KB
// (dkv) and 178 KB (dq) of the 227 KB a block may have at D = 128.
//
// Rounding against the JAX kernels: A3/A4 feed p and dS to the MXU at the
// storage dtype (attention.py:560-572); these kernels keep them in f32, so
// in bf16 the two differ by that one rounding (as the forward differs by
// the rounding of q * scale). Outputs are written once, in the inputs'
// dtype, from f32 accumulators.
//
// The same kernel bodies, with the block-sparse schedules of
// flash_tiles.cuh in place of the dense causal ranges, replace
//   A6 _bsp_dq_call  (dQ over the forward schedule: a block owns 64 rows of
//                     one user q tile and visits its active kv tiles) and
//   A7 _bsp_dkv_call (dK, dV over the transposed schedule: a block owns 64
//                     rows of one user kv tile and visits the q tiles that
//                     attend it; a kv tile no q tile attends has count 0 and
//                     stores zeros).
// They give the gradient of the block-sparse forward (A5), which masks with
// the JAX kernels' finite value. Where that differs from A6/A7 (ROADMAP
// Queue 3, F9: a row whose every visited column is causally masked, for
// bq != bk; the forward gives it the mean of V over those columns), each of
// its visited columns gets 1/n of the row's dO in dV, and dQ, dK nothing;
// A6/A7 take p = 1 there from an lse that rounds to the mask value.
//
// Left for later: tensor cores (mma.sync / wgmma), TMA and a pipelined ring
// of tiles; A1/A3/A4's kv_len, segment and sliding-window options.
#include "flash_tiles.cuh"

namespace cubecl {
namespace {

constexpr int BM = 64;      // q rows per tile
constexpr int BN = 64;      // kv rows per tile
constexpr int NT = 256;     // threads: 16 x 16, each a 4x4 score block
constexpr int PS = BM + 4;  // row stride of a transposed 64x64 score tile

template <int D>
constexpr int dkv_smem_bytes() {
  // Kt, Vt [D][BN]; Qt, dOt [D][BM]; Qr, dOr [BM][D]; Ps [BM][PS];
  // lse, di [BM]
  return (2 * D * BN + 2 * D * BM + 2 * BM * D + BM * PS + 2 * BM) * 4;
}

template <int D>
constexpr int dq_smem_bytes() {
  // Qt, dOt [D][BM]; Kt, Vt [D][BN]; Kr [BN][D]; Ss [BN][PS]; lse, di [BM]
  return (2 * D * BM + 2 * D * BN + BN * D + BN * PS + 2 * BM) * 4;
}

// Rows r0.. r0+R-1 of a (rows, D) matrix -> f32 shared memory, transposed
// (t[d * R + r]) and/or row-major (rm[r * D + d]); rows >= n are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void stage(const T* __restrict__ src, int r0,
                                      int n, float* t, float* rm) {
  for (int i = threadIdx.x; i < R * D / 4; i += NT) {
    const int r = i % R, c = i / R;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) load4(src + (int64_t)(r0 + r) * D + c * 4, x);
    if (t != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) t[(c * 4 + e) * R + r] = x[e];
    }
    if (rm != nullptr)
      *reinterpret_cast<float4*>(&rm[r * D + c * 4]) =
          make_float4(x[0], x[1], x[2], x[3]);
  }
}

// acc[i][j] += sum_d a[d][ai*4 + i] * b[d][bj*4 + j] over transposed tiles
template <int D>
__device__ __forceinline__ void outer4(const float* a, int as, int ai,
                                       const float* b, int bs, int bj,
                                       float (&acc)[4][4]) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(&a[d * as + ai * 4]);
    const float4 y = *reinterpret_cast<const float4*>(&b[d * bs + bj * 4]);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
}

// acc[i][c*4 + j] += sum_n w[n][ty*4 + i] * m[n][c*64 + tx*4 + j]: a 64-row
// transposed weight tile (stride PS) times a row-major (64, D) operand
template <int D>
__device__ __forceinline__ void accum(const float* w, const float* m, int ty,
                                     int tx, float (&acc)[4][4 * (D / 64)]) {
  constexpr int DC = D / 64;
#pragma unroll 4
  for (int n = 0; n < 64; ++n) {
    const float4 w4 = *reinterpret_cast<const float4*>(&w[n * PS + ty * 4]);
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float4 m4 =
          *reinterpret_cast<const float4*>(&m[n * D + c * 64 + tx * 4]);
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][c * 4 + j] = fmaf(wv[i], mv[j], acc[i][c * 4 + j]);
    }
  }
}

// w[(tx*4 + j) * PS + ty*4 + i] = x[i][j]: a thread's 4x4 block, transposed
__device__ __forceinline__ void store_t(float* w, int ty, int tx,
                                        const float (&x)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(&w[(tx * 4 + j) * PS + ty * 4]) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int r0,
                                           int n, int ty, int tx,
                                           const float (&acc)[4][4 * (D / 64)]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[(int64_t)r * D + c * 64 + tx * 4 + j] =
            from_float<T>(acc[i][c * 4 + j]);
  }
}

// ---------------------------------------------------------------- dK, dV

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                     float scale, float scale_log2, int causal, Tiles tiles) {
  constexpr int DC = D / 64;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][BN]
  float* Vt = Kt + D * BN;                      // [D][BN]
  float* Qt = Vt + D * BN;                      // [D][BM]
  float* dOt = Qt + D * BM;                     // [D][BM]
  float* Qr = dOt + D * BM;                     // [BM][D]
  float* dOr = Qr + BM * D;                     // [BM][D]
  float* Ps = dOr + BM * D;                     // [BM][PS]: p, then dS
  float* lse_s = Ps + BM * PS;                  // [BM]
  float* di_s = lse_s + BM;                     // [BM]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // q columns tx*4.. of the (kv, q) score block
  const int ty = tid / 16;  // kv rows ty*4.., output rows of dK / dV
  int k0, k_end;  // the block's kv rows; rows from k_end on are not its own
  tiles.own(k0, k_end);
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int64_t kvo = ((int64_t)b * Hkv + hk) * Skv * D;

  stage<T, D, BN>(k + kvo, k0, k_end, Kt, nullptr);
  stage<T, D, BN>(v + kvo, k0, k_end, Vt, nullptr);

  float dk_acc[4][4 * DC], dv_acc[4][4 * DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_tiles = tiles.count(k0);
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const int64_t qo = ((int64_t)b * H + h) * Sq;
    for (int t = 0; t < n_tiles; ++t) {
      // q rows [q0, q_end); rows below f9_end have no live column (F9)
      int q0, q_end, f9_end;
      float inv_n;
      if (!tiles.visit(t, k0, k_end, q0, q_end, f9_end, inv_n)) continue;
      __syncthreads();  // the previous tile's readers are done
      stage<T, D, BM>(q + qo * D, q0, q_end, Qt, Qr);
      stage<T, D, BM>(dout + qo * D, q0, q_end, dOt, dOr);
      if (tid < BM) {
        const bool in = q0 + tid < q_end;
        lse_s[tid] = in ? lse[qo + q0 + tid] : 0.f;
        di_s[tid] = in ? di[qo + q0 + tid] : 0.f;
      }
      __syncthreads();

      // transposed scores s^T[n][m] and dP^T[n][m]: kv rows, q columns
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      outer4<D>(Kt, BN, ty, Qt, BM, tx, s);
      outer4<D>(Vt, BN, ty, dOt, BM, tx, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = tx * 4 + j;
        const int row = q0 + m;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + ty * 4 + i;
          const bool in = row < q_end && col < k_end;
          const bool ok = in && (!causal || col <= row);
          const float p = ok ? exp2f(s[i][j] * scale_log2 - lse_s[m]) : 0.f;
          if constexpr (Tiles::kSparse) {
            // an F9 row: p = 1/n on each visited column, for dV only
            s[i][j] = in && row < f9_end ? inv_n : p;
            dp[i][j] = ok ? p * (dp[i][j] - di_s[m]) * scale : 0.f;  // dS
          } else {
            s[i][j] = p;
            dp[i][j] = p * (dp[i][j] - di_s[m]) * scale;  // dS
          }
        }
      }
      // Ps[m][n] = p: dV[n][:] += sum_m p[m][n] dO[m][:]
      store_t(Ps, ty, tx, s);
      __syncthreads();
      accum<D>(Ps, dOr, ty, tx, dv_acc);
      __syncthreads();
      // Ps[m][n] = dS: dK[n][:] += sum_m dS[m][n] q[m][:]
      store_t(Ps, ty, tx, dp);
      __syncthreads();
      accum<D>(Ps, Qr, ty, tx, dk_acc);
    }
  }
  store_rows<T, D>(dk + kvo, k0, k_end, ty, tx, dk_acc);
  store_rows<T, D>(dv + kvo, k0, k_end, ty, tx, dv_acc);
}

// ------------------------------------------------------------------- dQ

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int H,
                    int Hkv, int Sq, int Skv, float scale, float scale_log2,
                    int causal, Tiles tiles) {
  constexpr int DC = D / 64;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BM]
  float* dOt = Qt + D * BM;                     // [D][BM]
  float* Kt = dOt + D * BM;                     // [D][BN]
  float* Vt = Kt + D * BN;                      // [D][BN]
  float* Kr = Vt + D * BN;                      // [BN][D]
  float* Ss = Kr + BN * D;                      // [BN][PS]: dS transposed
  float* lse_s = Ss + BN * PS;                  // [BM]
  float* di_s = lse_s + BM;                     // [BM]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // kv columns tx*4.., dQ columns tx*4 + 64c
  const int ty = tid / 16;  // q rows ty*4..
  int q0, q_end;  // the block's rows; rows from q_end on are not its own
  tiles.own(q0, q_end);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int64_t qo = ((int64_t)b * H + h) * Sq;
  const int64_t kvo = ((int64_t)b * Hkv + hk) * Skv * D;

  stage<T, D, BM>(q + qo * D, q0, q_end, Qt, nullptr);
  stage<T, D, BM>(dout + qo * D, q0, q_end, dOt, nullptr);
  if (tid < BM) {
    const bool in = q0 + tid < q_end;
    lse_s[tid] = in ? lse[qo + q0 + tid] : 0.f;
    di_s[tid] = in ? di[qo + q0 + tid] : 0.f;
  }

  float acc[4][4 * DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * DC; ++j) acc[i][j] = 0.f;

  const int n_tiles = tiles.count(q0);
  for (int t = 0; t < n_tiles; ++t) {
    int k0, k_end;  // the tile's columns; those from k_end on are absent
    if (!tiles.visit(t, q0, q_end, k0, k_end)) continue;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D, BN>(k + kvo, k0, k_end, Kt, Kr);
    stage<T, D, BN>(v + kvo, k0, k_end, Vt, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    outer4<D>(Qt, BM, ty, Kt, BN, tx, s);
    outer4<D>(dOt, BM, ty, Vt, BN, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      const int row = q0 + m;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = row < q_end && col < k_end && (!causal || col <= row);
        const float p = ok ? exp2f(s[i][j] * scale_log2 - lse_s[m]) : 0.f;
        dp[i][j] = p * (dp[i][j] - di_s[m]) * scale;  // dS
      }
    }
    // Ss[n][m] = dS: dQ[m][:] += sum_n dS[m][n] k[n][:]
    store_t(Ss, ty, tx, dp);
    __syncthreads();
    accum<D>(Ss, Kr, ty, tx, acc);
  }
  store_rows<T, D>(dq + qo * D, q0, q_end, ty, tx, acc);
}

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes) {
  // above 48 KB a kernel must opt in to dynamic shared memory
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D, typename Tiles>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int H, int Hkv, int Sq,
                       int Skv, float scale, float scale_log2, int causal,
                       int blocks, Tiles tiles, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  static const cudaError_t attr =
      opt_in_smem(flash_bwd_dkv_kernel<T, D, Tiles>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(blocks, Hkv, B);
  flash_bwd_dkv_kernel<T, D, Tiles><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq, Skv, scale,
      scale_log2, causal, tiles);
  return cudaGetLastError();
}

template <typename T, int D, typename Tiles>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int B, int H, int Hkv, int Sq, int Skv,
                      float scale, float scale_log2, int causal, int blocks,
                      Tiles tiles, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  static const cudaError_t attr =
      opt_in_smem(flash_bwd_dq_kernel<T, D, Tiles>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(blocks, H, B);
  flash_bwd_dq_kernel<T, D, Tiles><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), H, Hkv, Sq, Skv, scale, scale_log2, causal, tiles);
  return cudaGetLastError();
}

// the four (dtype, head_dim) instances of one schedule
template <typename Tiles>
int launch_dkv_any(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* di,
                   void* dk, void* dv, int dtype, int B, int H, int Hkv,
                   int Sq, int Skv, int D, float scale, float scale_log2,
                   int causal, int blocks, Tiles tiles, cudaStream_t st) {
#define CUBECL_DKV(T, HD)                                                    \
  launch_dkv<T, HD, Tiles>(q, k, v, dout, lse, di, dk, dv, B, H, Hkv, Sq,    \
                           Skv, scale, scale_log2, causal, blocks, tiles, st)
  if (dtype == kF32 && D == 64) return CUBECL_DKV(float, 64);
  if (dtype == kF32 && D == 128) return CUBECL_DKV(float, 128);
  if (dtype == kBF16 && D == 64) return CUBECL_DKV(__nv_bfloat16, 64);
  if (dtype == kBF16 && D == 128) return CUBECL_DKV(__nv_bfloat16, 128);
#undef CUBECL_DKV
  return cudaErrorInvalidValue;
}

template <typename Tiles>
int launch_dq_any(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* di,
                  void* dq, int dtype, int B, int H, int Hkv, int Sq, int Skv,
                  int D, float scale, float scale_log2, int causal,
                  int blocks, Tiles tiles, cudaStream_t st) {
#define CUBECL_DQ(T, HD)                                                     \
  launch_dq<T, HD, Tiles>(q, k, v, dout, lse, di, dq, B, H, Hkv, Sq, Skv,    \
                          scale, scale_log2, causal, blocks, tiles, st)
  if (dtype == kF32 && D == 64) return CUBECL_DQ(float, 64);
  if (dtype == kF32 && D == 128) return CUBECL_DQ(float, 128);
  if (dtype == kBF16 && D == 64) return CUBECL_DQ(__nv_bfloat16, 64);
  if (dtype == kBF16 && D == 128) return CUBECL_DQ(__nv_bfloat16, 128);
#undef CUBECL_DQ
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cubecl

// q, dout (B, H, Sq, D), k/v (B, Hkv, Skv, D), dk/dv (B, Hkv, Skv, D):
// contiguous, one dtype; lse, di (B, H, Sq) f32. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a dtype / head_dim this
// kernel was not built for.
extern "C" int cubecl_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* di,
                                    void* dk, void* dv, int dtype, int B,
                                    int H, int Hkv, int Sq, int Skv, int D,
                                    float scale, float scale_log2, int causal,
                                    void* stream) {
  using namespace cubecl;
  return launch_dkv_any(q, k, v, dout, lse, di, dk, dv, dtype, B, H, Hkv, Sq,
                        Skv, D, scale, scale_log2, causal,
                        (Skv + BN - 1) / BN,
                        DenseKVTiles{Sq, Skv, causal, 0},
                        static_cast<cudaStream_t>(stream));
}

// the same inputs; dq (B, H, Sq, D) in their dtype
extern "C" int cubecl_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* di,
                                   void* dq, int dtype, int B, int H, int Hkv,
                                   int Sq, int Skv, int D, float scale,
                                   float scale_log2, int causal,
                                   void* stream) {
  using namespace cubecl;
  return launch_dq_any(q, k, v, dout, lse, di, dq, dtype, B, H, Hkv, Sq, Skv,
                       D, scale, scale_log2, causal, (Sq + BM - 1) / BM,
                       DenseQTiles{Sq, Skv, causal},
                       static_cast<cudaStream_t>(stream));
}

// A6, dQ of the block-sparse forward: the inputs of cubecl_flash_bwd_dq with
// one head count, and the forward's schedule (ids (n_q, stride), counts) at
// user tiles (bq, bk)
extern "C" int cubecl_flash_bsp_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* di,
                                   void* dq, const int* ids,
                                   const int* counts, int stride, int bq,
                                   int bk, int dtype, int B, int H, int Sq,
                                   int Skv, int D, float scale,
                                   float scale_log2, int causal,
                                   void* stream) {
  using namespace cubecl;
  const int q_sub = (bq + kFlashTile - 1) / kFlashTile;
  const int k_sub = (bk + kFlashTile - 1) / kFlashTile;
  const SparseQTiles tiles{ids, counts, stride, bq, bk, q_sub, k_sub,
                           causal, /*keep_f9=*/0, 0};
  return launch_dq_any(q, k, v, dout, lse, di, dq, dtype, B, H, H, Sq, Skv,
                       D, scale, scale_log2, causal, (Sq / bq) * q_sub,
                       tiles, static_cast<cudaStream_t>(stream));
}

// A7, dK and dV of the block-sparse forward: the inputs of
// cubecl_flash_bwd_dkv with one head count, the transposed schedule (t_ids
// (n_kv, t_stride), t_counts, zero counts allowed) and the forward's (f_ids
// (n_q, f_stride), f_counts) at user tiles (bq, bk)
extern "C" int cubecl_flash_bsp_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* di,
                                    void* dk, void* dv, const int* t_ids,
                                    const int* t_counts, int t_stride,
                                    const int* f_ids, const int* f_counts,
                                    int f_stride, int bq, int bk, int dtype,
                                    int B, int H, int Sq, int Skv, int D,
                                    float scale, float scale_log2, int causal,
                                    void* stream) {
  using namespace cubecl;
  const int q_sub = (bq + kFlashTile - 1) / kFlashTile;
  const int k_sub = (bk + kFlashTile - 1) / kFlashTile;
  const SparseKVTiles tiles{t_ids, t_counts, f_ids, f_counts, t_stride,
                            f_stride, bq, bk, k_sub, q_sub, causal, 0};
  return launch_dkv_any(q, k, v, dout, lse, di, dk, dv, dtype, B, H, H, Sq,
                        Skv, D, scale, scale_log2, causal, (Skv / bk) * k_sub,
                        tiles, static_cast<cudaStream_t>(stream));
}
