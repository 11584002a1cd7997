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
// output rows and loops over the other side itself, as the JAX
// decomposition does: two kernels, no atomics, a deterministic result.
//   dkv: a block owns kv rows of one (batch, kv head). It loops over the
//        H / Hkv query heads of the kv head's group and, for each, over the
//        q tiles that can see its rows: under causal, from the tile that
//        holds its first row to the end (A3's triangular schedule as a loop
//        bound). The group sum that JAX gets from the transpose of
//        jnp.repeat happens in the block's registers. Blocks with small k0
//        have the most causal work and are scheduled first.
//   dq:  a block owns q rows of one (batch, head), looping over the kv
//        tiles up to the diagonal; the bottom tiles (most work) go first.
// Rows past Sq / Skv of a tile are zero and never stored, so any S works
// (the train shape is S = 1023); no padding to 128.
//
// Bound on the H100: dK/dV does four products of 2 D flops per live
// (query, key) pair and dQ three, against 2-4 D bytes a row, so both are
// compute-bound in bf16 (the 0.77B llama's bf16 B8 H16/8 S1023 causal:
// 0.069 ms and 0.052 ms at 989 TFLOP/s). Two bodies, chosen by dtype:
//
// bf16: the tensor cores (flash_bwd_dkv_wgmma_kernel,
// flash_bwd_dq_wgmma_kernel), warp-specialised as the bf16 forward
// (flash_attention.cu): one thread of a producer warpgroup issues TMA
// copies (128-byte-swizzled 64 x 64 boxes; rows past S arrive as zeros)
// into a ring of kStages stages on mbarriers, and two consumer warpgroups
// of 64 rows each run wgmma (setmaxnreg 24/240). The block's own rows sit
// stationary in shared memory; the other side streams through the ring.
//   dkv: K and V of the block's 128 kv rows stay; (q, dO) 64-row tiles
//        stream, with their lse and di, which a second producer warp
//        stages by plain loads (a TMA box cannot start at any row of a
//        (B, H, Sq) f32 array when Sq * 4 is no multiple of 16). A consumer
//        computes the TRANSPOSED scores s^T = K q^T and dP^T = V dO^T
//        (both operands K-major in shared memory), so that p^T and dS^T,
//        packed in bf16 pairs, are already the register A fragments of
//        dV += p^T dO and dK += dS^T q (m64nDk16, dO and q as MN-major B
//        with the transpose bit: one swizzled tile serves as K-major B of
//        the score products and as MN-major B here). lse and di are
//        indexed by the accumulator's column and read from shared memory.
//        dK and dV (2 x D / 2 f32 registers a thread) stay in registers
//        across the whole walk: at D 128 the consumer holds 128 of them
//        beside s^T and dP^T (64), inside the 240 that setmaxnreg grants
//        (hopper.cuh's mbar_wait says what kept ptxas from using them).
//   dq:  q, dO, and each row's lse and di (in registers) stay; K and V
//        stream. s = q K^T, dP = dO V^T (m64n64), then dQ += dS K with dS
//        from registers and K as MN-major B.
// Both consumers of a block walk the same tiles of the other side (the
// union of their ranges, which differ by one tile under the causal mask):
// each computes on its own and releases every stage, so the barrier phases
// cannot drift; a wait of seconds traps. The mask is applied only on tiles
// that cross the diagonal or an end of the rows, by selects (no branch per
// element); exp2 is the special-function unit's ex2.approx. The role of a
// warpgroup is taken through __shfl_sync, so that the compiler sees it
// warp-uniform.
// Rounding, as the JAX kernels: p and dS are fed to the products at the
// storage dtype with f32 accumulation (p.astype(do.dtype) and
// ds.astype(q.dtype) in _bwd_dkv_call / _bwd_dq_call); dS is computed from
// the unrounded f32 p. Outputs are written once, in bf16, from f32
// accumulators.
//
// f32 dK/dV: the tensor cores as three TF32 products
// (flash_bwd_dkv_tf32x3_kernel, on flash_tf32.cuh; the forward's f32 body
// says why three). One warpgroup a block owns a 64-row kv tile and one of
// its two gradients: two blocks a kv tile, dV's and dK's, each holding one
// 64 x D f32 accumulator (both in one block spilled from D 128). K (and V
// for dK's block) stay in shared memory as they are, the A operands of the
// transposed scores, split in registers at each use. A block walks each
// visited q tile in two steps of 32 rows, staging one operand at a time
// into one split buffer by plain loads: q (K-major over D) for s^T = K q^T,
// dK's block dO for dP^T = V dO^T (m64n32k8, twelve products a 32-column
// panel of D summed from zero and added in f32); then dO (dV's block) or q
// (dK's) transposed, K-major along the step's rows, for dV += p^T dO or
// dK += dS^T q, whose A operand is p^T or dS^T itself, split from the
// score accumulators (m64n64k8 a 64-column block, twelve products summed
// from zero and added in f32: one addition a step however many heads and
// rows the group sums). Five products a tile pair where the math needs
// four (s^T twice); 48, 96 and 192 KB at D 64, 128 and 256. exp2 is
// exp2f. Bound: 3 x 8 D flops a live pair at 495 TFLOP/s of TF32.
//
// f32 dQ: the CUDA cores (flash_bwd_dq_kernel): 256 threads; every thread
// holds a 4x4 block of s/p/dS and a 4 x D/16 block of the output
// accumulator, and reads its operands as float4 from shared memory, where
// every tile is staged in f32: q, dO and k, v transposed for the two score
// products, and row-major where they are the right operand of a product.
// That is 178 KB of the 227 KB a block may have at D = 128.
//
// D 256 (GPT-J-6B's and Qwen3-Next's head dim) has bodies of its own, on
// every schedule (A6 and A7 too, with F9's rows as above): the ones above
// run out of room. At D 256 a bf16 consumer's dK and
// dV would be 256 f32 registers a thread (setmaxnreg grants 240), and
// their shared memory (NC tiles of K, V and 3 ring stages, 32 KB a tile)
// 320 KB of the 227 KB a block may hold; the f32 dQ body's staging takes
// 346 KB.
//   bf16 (flash_bwd_dkv_wide_kernel, flash_bwd_dq_wide_kernel): a block
//        owns ONE 64-row tile, stationary (64 KB for its two operands),
//        and streams the other side through a ring of 2 stages (128 KB).
//        Its two consumer warpgroups share the tile (setmaxnreg 40/232:
//        at 24 the producer's lse/di warp spilled on the masked schedule):
//     dkv: by role. Warpgroup 1 computes s^T = K q^T, masks it, takes p^T
//        and accumulates dV += p^T dO; warpgroup 2 computes dP^T = V dO^T,
//        takes dS^T = p^T (dP^T - di) * scale with the f32 p^T that
//        warpgroup 1 hands it through 16 KB of shared memory (each
//        thread's 32 values at the same place in both fragments, two named
//        barriers a tile), and accumulates dK += dS^T q. Each holds one
//        64 x 256 accumulator (128 registers a thread) beside one score
//        tile: 4 products of 64 x 64 x 256 a tile pair, as the math needs;
//        215 KB of shared memory.
//     dq:  by columns. Warpgroup c accumulates dQ's columns 128 c ..
//        128 c + 127 (64 registers, as a D 128 consumer) and computes the
//        whole s and dP itself: 5 products a tile pair against the 3 that
//        the math needs (1.67x), and no hand-over; 198 KB.
//        The score products walk D in 16 k16 steps, the descriptors made
//        beside each step; the gradient products are D 128's m64n128k16,
//        two a step for a 256-wide accumulator. p and dS round to bf16
//        where the other bodies round them (dS from the unrounded p); the
//        group sum over the query heads stays in registers.
//   f32 dQ (flash_bwd_dq_sliced_kernel): the CUDA-core body's arithmetic
//        with one layout of the streamed tile in shared memory at a time:
//        transposed for s (then dP), then row-major for dQ, each staged
//        again from global memory (L2); 214,528 bytes.
//
// The same kernel bodies, with the block-sparse schedules of
// flash_tiles.cuh in place of the dense causal ranges, replace
//   A6 _bsp_dq_call  (dQ over the forward schedule: a block owns rows of
//                     one user q tile and visits its active kv tiles) and
//   A7 _bsp_dkv_call (dK, dV over the transposed schedule: a block owns
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
// A3/A4's options (kv_len, segment ids, a sliding window) are the same
// bodies on the masked schedule of flash_tiles.cuh
// (cubecl_flash_masked_dkv, cubecl_flash_masked_dq): dK/dV walks the
// transposed band (for kv rows from k, q rows in [k - right, k + 127 +
// left], from k under the causal mask), dQ the band; a tile is skipped
// whole past kv_len, off the band or where the segment id ranges do not
// overlap, and a tile that is not wholly live has its dead scores set to
// -inf once they are in (exp2 of them is 0), so the loops mask nothing.
// Masked entries get p = 0, so a row with no live key (F16) gives nothing
// to any gradient. The dense and block-sparse instances keep their code.
#include "flash_tf32.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace cubecl {
namespace {

constexpr int BM = 64;      // q rows per tile
constexpr int BN = 64;      // kv rows per tile
constexpr int NT = 256;     // threads: 16 x 16, each a 4x4 score block
constexpr int PS = BM + 4;  // row stride of a transposed 64x64 score tile

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
template <int D, int DC = D / 64>
__device__ __forceinline__ void accum(const float* w, const float* m, int ty,
                                     int tx, float (&acc)[4][4 * DC]) {
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

template <typename T, int D, int DC = D / 64>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int r0,
                                           int n, int ty, int tx,
                                           const float (&acc)[4][4 * DC]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[(int64_t)r * D + c * 64 + tx * 4 + j] =
            from_float<T>(acc[i][c * 4 + j]);
  }
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
    // the options: the dead scores of a tile not wholly live to -inf
    if constexpr (Tiles::kMasked)
      if (!tiles.mask.whole(q0, k0))
        tiles.mask.template kill<false>(s, q0 + ty * 4, k0 + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      const int row = q0 + m;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        bool ok = true;
        if constexpr (!Tiles::kMasked)
          ok = row < q_end && col < k_end && (!causal || col <= row);
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

// -- D 256 on the CUDA cores: one tile of the streamed side at a time ------

// the stationary side's two operands transposed [D][64]; one (64, D) tile
// of the streamed side, transposed for a score product or row-major for a
// gradient product; the 64 x 64 weight tile [64][PS]; lse, di [64]
template <int D>
constexpr int sliced_smem_bytes() {
  return (3 * D * 64 + 64 * PS + 2 * 64) * 4;
}

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ di, T* __restrict__ dq,
                           int H, int Hkv, int Sq, int Skv, float scale,
                           float scale_log2, int causal, Tiles tiles) {
  static_assert(D == 256, "the sliced body is built for D 256");
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BM]
  float* dOt = Qt + D * BM;                     // [D][BM]
  float* X = dOt + D * BM;  // K^T, V^T [D][BN], then K [BN][D]
  float* Ss = X + D * BN;   // [BN][PS]: dS transposed
  float* lse_s = Ss + BN * PS;                  // [BM]
  float* di_s = lse_s + BM;                     // [BM]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // kv columns tx*4.., dQ columns tx*4 + 64c
  const int ty = tid / 16;  // q rows ty*4..
  int q0, q_end;
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

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int n_tiles = tiles.count(q0);
  for (int t = 0; t < n_tiles; ++t) {
    int k0, k_end;
    if (!tiles.visit(t, q0, q_end, k0, k_end)) continue;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D, BN>(k + kvo, k0, k_end, X, nullptr);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    outer4<D>(Qt, BM, ty, X, BN, tx, s);
    __syncthreads();
    stage<T, D, BN>(v + kvo, k0, k_end, X, nullptr);
    __syncthreads();
    outer4<D>(dOt, BM, ty, X, BN, tx, dp);
    if constexpr (Tiles::kMasked)
      if (!tiles.mask.whole(q0, k0))
        tiles.mask.template kill<false>(s, q0 + ty * 4, k0 + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      const int row = q0 + m;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        bool ok = true;
        if constexpr (!Tiles::kMasked)
          ok = row < q_end && col < k_end && (!causal || col <= row);
        const float p = ok ? exp2f(s[i][j] * scale_log2 - lse_s[m]) : 0.f;
        dp[i][j] = p * (dp[i][j] - di_s[m]) * scale;  // dS
      }
    }
    __syncthreads();  // V^T's readers are done
    // dQ[m][:] += sum_n dS[m][n] k[n][:]
    stage<T, D, BN>(k + kvo, k0, k_end, nullptr, X);
    store_t(Ss, ty, tx, dp);
    __syncthreads();
    accum<D>(Ss, X, ty, tx, acc);
  }
  store_rows<T, D>(dq + qo * D, q0, q_end, ty, tx, acc);
}

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes) {
  // above 48 KB a kernel must opt in to dynamic shared memory
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the CUDA-core dQ bodies of a head dim: D 256's sliced one, else the
// other (each only where chosen, so that no body is built at a D it does
// not fit)
template <typename T, int D, typename Tiles>
constexpr auto dq_cuda_core() {
  if constexpr (D == 256)
    return flash_bwd_dq_sliced_kernel<T, D, Tiles>;
  else
    return flash_bwd_dq_kernel<T, D, Tiles>;
}

// -- the f32 dK/dV body: 3xTF32 wgmma (flash_tf32.cuh) ---------------------

// dynamic shared memory of the f32 dK/dV body: the kv tile's K and V as
// they are (D / 32 panels of 64 rows each; dV's block stages no V), one
// streamed operand of a 32-row q step split in two (q or dO as D / 32
// panels of 32 rows, or transposed as D rows of 32), the step's lse and
// di, and the slack to align the base to 1024: 48, 96 and 192 KB at D 64,
// 128 and 256
template <int D>
struct F32BwdSmem {
  static constexpr int kK = 0;
  static constexpr int kV = kK + BN * D * 4;
  static constexpr int kXb = kV + BN * D * 4;
  static constexpr int kXs = kXb + kStep * D * 4;
  static constexpr int kLse = kXs + kStep * D * 4;
  static constexpr int kDi = kLse + kStep * 4;
  static constexpr int kBytes = kDi + kStep * 4 + 1024;
};

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkv_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ di, T* __restrict__ dk,
                            T* __restrict__ dv, int H, int Hkv, int Sq,
                            int Skv, float scale, float scale_log2,
                            int causal, Tiles tiles) {
  static_assert(sizeof(T) == 4, "the 3xTF32 body takes f32 inputs");
  static_assert(D == 64 || D == 128 || D == 256,
                "the 3xTF32 body is built for D 64, 128 and 256");
  using L = F32BwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* di_s = reinterpret_cast<float*>(smem + L::kDi);

  int k0, k_end;  // the block's kv rows; rows from k_end on are not its own
  tiles.own(k0, k_end);
  // two blocks a kv tile, by role: dV (s^T, p^T, dV += p^T dO) or dK (s^T,
  // dP^T, dS^T, dK += dS^T q), each with one 64 x D accumulator (both in
  // one block took 2 x D / 2 registers a thread and spilled from D 128)
  const int hk = blockIdx.y / 2;
  const bool dk_role = blockIdx.y % 2;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int64_t kvo = ((int64_t)b * Hkv + hk) * Skv * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this thread's rows of the transposed m64n32 scores (kv rows) and of
  // dK or dV: row_l and row_l + 8 of the tile; its columns (q rows of the
  // step) 8 j + col_l + {0, 1}
  const int row_l = warp * 16 + lane / 4;
  const int col_l = (lane % 4) * 2;

  stage_rows<BN, D, false>(k + kvo, D, k0, k_end, smem + L::kK, nullptr);
  if (dk_role)
    stage_rows<BN, D, false>(v + kvo, D, k0, k_end, smem + L::kV, nullptr);
  const uint32_t k_s = smem_addr(smem + L::kK);
  const uint32_t v_s = smem_addr(smem + L::kV);
  const uint32_t xb_s = smem_addr(smem + L::kXb);
  const uint32_t xs_s = smem_addr(smem + L::kXs);
  // stage one operand of the step into X (split), after the readers of the
  // last one; the stores, then wgmma's reads
  auto into_x = [&](auto&& copy) {
    __syncthreads();
    copy();
    fence_proxy_async();
    __syncthreads();
  };

  // dK or dV, each step's products summed from zero and then added
  // (accumulate), so that a sum over H / Hkv heads of Sq rows takes one
  // addition a step
  float acc[D / 64][32];
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[c][j] = 0.f;

  const int n_tiles = tiles.count(k0);
  for (int g = 0; g < rep; ++g) {
    const int64_t qo = ((int64_t)b * H + hk * rep + g) * Sq;
    const float* qh = q + qo * D;
    const float* doh = dout + qo * D;
    for (int t = 0; t < n_tiles; ++t) {
      // q rows [q0, q_end); rows below f9_end have no live column (F9)
      int q0, q_end, f9_end;
      float inv_n;
      if (!tiles.visit(t, k0, k_end, q0, q_end, f9_end, inv_n)) continue;
      // the mask on edge tiles only: q rows past q_end, kv rows past
      // k_end, the diagonal, F9's rows (the options: their dead scores
      // set to -inf once the scores are in)
      bool edge = false, whole = true;
      if constexpr (Tiles::kMasked)
        whole = tiles.mask.whole(q0, k0);
      else
        edge = q0 + kFlashTile > q_end || k0 + kFlashTile > k_end ||
               (causal && k0 + kFlashTile - 1 > q0) || q0 < f9_end;
      // the tile's two steps of 32 q rows
      for (int qs = q0; qs < q0 + kFlashTile && qs < q_end; qs += kStep) {
        // s^T = K q^T, with the step's lse and di
        into_x([&] {
          stage_rows<kStep, D, true>(qh, D, qs, q_end, smem + L::kXb,
                                     smem + L::kXs);
          if (threadIdx.x < kStep) {
            const bool in = qs + threadIdx.x < q_end;
            lse_s[threadIdx.x] = in ? lse[qo + qs + threadIdx.x] : 0.f;
            di_s[threadIdx.x] = in ? di[qo + qs + threadIdx.x] : 0.f;
          }
        });
        float s[16], dp[16];
        scores<D>(s, k_s, xb_s, xs_s);
        if (dk_role) {  // dP^T = V dO^T
          into_x([&] {
            stage_rows<kStep, D, true>(doh, D, qs, q_end, smem + L::kXb,
                                       smem + L::kXs);
          });
          scores<D>(dp, v_s, xb_s, xs_s);
        }
        if constexpr (Tiles::kMasked)
          if (!whole)
            tiles.mask.template kill<true>(s, k0 + row_l, qs + col_l);

        // p^T (into s: dV's block) or dS^T (into dp: dK's block)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 8 * j + col_l + e;
            const float l = lse_s[m], d = di_s[m];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float& x = s[4 * j + 2 * i + e];
              bool ok = true, f9 = false;
              if (edge) {
                const int row = qs + m;
                const int col = k0 + row_l + 8 * i;
                const bool in = row < q_end && col < k_end;
                ok = in && (!causal || col <= row);
                // an F9 row: p = 1/n on each visited column, for dV only
                f9 = Tiles::kSparse && in && row < f9_end;
              }
              // masked: p = 0 by a select (the exp2 may be inf there)
              const float p = ok ? exp2f(x * scale_log2 - l) : 0.f;
              x = f9 ? inv_n : p;
              if (dk_role) {
                float& y = dp[4 * j + 2 * i + e];
                y = p * (y - d) * scale;
              }
            }
          }

        // dV += p^T dO or dK += dS^T q over the step's rows, dO or q
        // transposed
        into_x([&] {
          stage_cols<D>(dk_role ? qh : doh, D, qs, q_end, 0, smem + L::kXb,
                        smem + L::kXs);
        });
        // one call on the block's operand: a call a role put dK's and dV's
        // accumulators in other registers, and their join spilled them
        float x[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) x[j] = dk_role ? dp[j] : s[j];
        accumulate<D, 64>(acc, x, xb_s, xs_s);
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  store_f32<D, 64>((dk_role ? dk : dv) + kvo, D, k0 + row_l, k_end, col_l,
                   acc, one);
}

template <int D, typename Tiles>
cudaError_t launch_dkv_tf32x3(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* di, void* dk, void* dv, int B,
                              int H, int Hkv, int Sq, int Skv, float scale,
                              float scale_log2, int causal, int blocks,
                              Tiles tiles, cudaStream_t stream) {
  constexpr int smem = F32BwdSmem<D>::kBytes;
  const auto kernel = flash_bwd_dkv_tf32x3_kernel<float, D, Tiles>;
  static const cudaError_t attr = opt_in_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  // two blocks a kv tile: dV's and dK's
  const dim3 grid(blocks, 2 * Hkv, B);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, di,
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Sq, Skv,
      scale, scale_log2, causal, tiles);
  return cudaGetLastError();
}

template <typename T, int D, typename Tiles>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int B, int H, int Hkv, int Sq, int Skv,
                      float scale, float scale_log2, int causal, int blocks,
                      Tiles tiles, cudaStream_t stream) {
  constexpr int smem = D == 256 ? sliced_smem_bytes<D>() : dq_smem_bytes<D>();
  const auto kernel = dq_cuda_core<T, D, Tiles>();
  static const cudaError_t attr = opt_in_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(blocks, H, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), H, Hkv, Sq, Skv, scale, scale_log2, causal, tiles);
  return cudaGetLastError();
}

// -- the bf16 bodies: wgmma fed by TMA, warp-specialised ------------------

constexpr int kStages = 3;        // stages of the streamed side's ring
constexpr int kPanel = 64 * 128;  // one 64-row x 64-column bf16 panel, bytes
constexpr int NC = 2;             // consumer warpgroups (64 rows each)
constexpr int kWgThreads = 128 * (NC + 1);
constexpr int kStat = kFlashTile * 4;  // one tile's lse (or di), f32 bytes

// dynamic shared memory of the bf16 bodies: the stationary side's NC tiles
// of two operands (K and V for dkv, q and dO for dq), each tile D / 64
// panels; the ring of the streamed side's two operands (q and dO, or K and
// V); for dkv the ring's lse and di; the mbarriers (the stationary tiles',
// and each stage's full and empty); plus the slack to align the base to
// 1024
template <int D, bool kStats>
struct BwdSmem {
  static constexpr int kTile = D / 64 * kPanel;
  static constexpr int kA = 0;
  static constexpr int kB = kA + NC * kTile;
  static constexpr int kRa = kB + NC * kTile;
  static constexpr int kRb = kRa + kStages * kTile;
  static constexpr int kLse = kRb + kStages * kTile;
  static constexpr int kDi = kLse + (kStats ? kStages * kStat : 0);
  static constexpr int kBar = kDi + (kStats ? kStages * kStat : 0);
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

// wgmma descriptors of the k16 step kk over a tile of TMA's swizzled
// panels: K-major (the reduction along a row's D columns; 4 steps to a
// panel) and MN-major (the reduction down the tile's 64 rows, read through
// the transpose bit; the next 64 columns one panel on)
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, kPanel, 1024);
}

template <int S = kStages>
__device__ __forceinline__ void next_stage(int& st, uint32_t& phase) {
  if (++st == S) {
    st = 0;
    phase ^= 1;
  }
}

// d (64 x D) += A (64 x 64 bf16, four k16 fragments in registers) . B (the
// 64 x D tile at b_s, MN-major)
template <int D>
__device__ __forceinline__ void rs_tile(float (&d)[D / 2],
                                        const uint32_t (&a)[4][4],
                                        uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (D == 128)
      wgmma_rs_m64n128(d, a[kk], mnmajor(b_s, kk));
    else
      wgmma_rs_m64n64(d, a[kk], mnmajor(b_s, kk));
  }
}

// an m64n64 f32 accumulator in bf16 pairs: the A fragments of its four
// k16 column slices
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// this thread's rows r, r + 8 (r = warp * 16 + lane / 4) of an m64nN
// accumulator d[4 j + 2 i + e], columns 8 j + (lane % 4) * 2 + e, stored
// in bf16 where the row is below r_end (rows LD elements apart)
template <int D, int LD = D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ dst,
                                          int row_a, int r_end, int col_l,
                                          const float (&d)[D / 2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= r_end) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + (int64_t)row * LD + 8 * j +
                                         col_l) =
          __floats2bfloat162_rn(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  }
}

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ di,
                           T* __restrict__ dk, T* __restrict__ dv, int H,
                           int Hkv, int Sq, int Skv, float scale,
                           float scale_log2, int causal, Tiles tiles) {
  static_assert(sizeof(T) == 2, "the wgmma body takes 16-bit inputs");
  using L = BwdSmem<D, true>;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  // the block's NC kernel kv tiles, one per consumer warpgroup; a tile at
  // or past its k_end has no rows (the grid's padding)
  int r0[NC], r_end[NC], count[NC];
  int n_tiles = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    tiles.own(blockIdx.x * NC + c, gridDim.x * NC, r0[c], r_end[c]);
    count[c] = r0[c] < r_end[c] ? tiles.count(r0[c]) : 0;
    n_tiles = max(n_tiles, count[c]);
  }
  // does the consumer of kv rows [k0, k_end) and n tiles compute on q tile
  // t (its rows [q0, q_end), F9's rows below f9_end)? The tile's rows are
  // the same whichever consumer asks.
  auto visits = [&](int k0, int k_end, int n, int t, int& q0, int& q_end,
                    int& f9_end, float& inv_n) {
    return t < n && tiles.visit(t, k0, k_end, q0, q_end, f9_end, inv_n);
  };
  // the tiles the block loads: the union of its consumers' tiles, walked in
  // the same order by the producer and by every consumer, once for each
  // query head of the kv head's group
  auto loaded = [&](int t, int& q0, int& q_end, int& f9_end, float& inv_n) {
    bool any = false;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      any |= visits(r0[c], r_end[c], count[c], t, q0, q_end, f9_end, inv_n);
    return any;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      // the copies' issuer, and the 32 lanes that stage lse and di
      mbar_init(&full[st], 1 + 32);
      mbar_init(&empty[st], 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform for the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // -- producer: one thread issues every copy; warp 1 stages each q
    // tile's lse and di (a row statistic: (B, H, Sq) with any Sq, which a
    // TMA box cannot start at) with plain loads ---------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      int st = 0;
      uint32_t phase = 0;
      for (int g = 0; g < rep; ++g) {
        const int64_t bh = (int64_t)b * H + hk * rep + g;
        for (int t = 0; t < n_tiles; ++t) {
          int q0 = 0, q_end = 0, f9_end = 0;
          float inv_n = 0.f;
          if (!loaded(t, q0, q_end, f9_end, inv_n)) continue;
          mbar_wait(&empty[st], phase ^ 1);
          float* lse_s =
              reinterpret_cast<float*>(smem + L::kLse + st * kStat);
          float* di_s = reinterpret_cast<float*>(smem + L::kDi + st * kStat);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = q0 + lane + 32 * u;  // rows past q_end: 0
            lse_s[lane + 32 * u] = r < q_end ? lse[bh * Sq + r] : 0.f;
            di_s[lane + 32 * u] = r < q_end ? di[bh * Sq + r] : 0.f;
          }
          mbar_arrive(&full[st]);  // release: the stores above are seen
          next_stage(st, phase);
        }
      }
      return;
    }
    if (threadIdx.x != 0) return;
    tma_prefetch_map(&tq);
    tma_prefetch_map(&tk);
    tma_prefetch_map(&tv);
    tma_prefetch_map(&tdo);
    mbar_expect_tx(kv_full, 2 * NC * L::kTile);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load_3d(smem + L::kA + c * L::kTile + p * kPanel, &tk, kv_full,
                    p * 64, r0[c], b * Hkv + hk);
        tma_load_3d(smem + L::kB + c * L::kTile + p * kPanel, &tv, kv_full,
                    p * 64, r0[c], b * Hkv + hk);
      }
    int st = 0;
    uint32_t phase = 0;
    for (int g = 0; g < rep; ++g) {
      const int bh = b * H + hk * rep + g;
      for (int t = 0; t < n_tiles; ++t) {
        int q0 = 0, q_end = 0, f9_end = 0;
        float inv_n = 0.f;
        if (!loaded(t, q0, q_end, f9_end, inv_n)) continue;
        mbar_wait(&empty[st], phase ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[st], 2 * L::kTile);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load_3d(smem + L::kRa + st * L::kTile + p * kPanel, &tq,
                      &full[st], p * 64, q0, bh);
          tma_load_3d(smem + L::kRb + st * L::kTile + p * kPanel, &tdo,
                      &full[st], p * 64, q0, bh);
        }
        next_stage(st, phase);
      }
    }
    return;
  }

  // -- consumers: warpgroup c owns 64 kv rows -------------------------------
  setmaxnreg_inc<240>();
  const int c = wg - 1;
  int k0 = r0[0], k_end = r_end[0], n_own = count[0];
#pragma unroll
  for (int cc = 1; cc < NC; ++cc)
    if (cc == c) {
      k0 = r0[cc];
      k_end = r_end[cc];
      n_own = count[cc];
    }
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  // this thread's rows of the transposed m64n64 scores (kv rows) and of
  // dK, dV: row_l and row_l + 8 of the tile; its columns (q rows of the
  // scores) 8 j + col_l + {0, 1}
  const int row_l = warp * 16 + lane / 4;
  const int col_l = (lane % 4) * 2;

  float dk_acc[D / 2], dv_acc[D / 2];  // (64 x D) f32 each
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
  const uint32_t k_s = smem_addr(smem + L::kA + c * L::kTile);
  const uint32_t v_s = smem_addr(smem + L::kB + c * L::kTile);

  mbar_wait(kv_full, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int g = 0; g < rep; ++g) {
    for (int t = 0; t < n_tiles; ++t) {
      int q0 = 0, q_end = 0, f9_end = 0;
      float inv_n = 0.f;
      if (!loaded(t, q0, q_end, f9_end, inv_n)) continue;
      mbar_wait(&full[st], phase);
      if (visits(k0, k_end, n_own, t, q0, q_end, f9_end, inv_n)) {
        const uint32_t q_s = smem_addr(smem + L::kRa + st * L::kTile);
        const uint32_t do_s = smem_addr(smem + L::kRb + st * L::kTile);
        const float* lse_s =
            reinterpret_cast<const float*>(smem + L::kLse + st * kStat);
        const float* di_s =
            reinterpret_cast<const float*>(smem + L::kDi + st * kStat);
        // the mask on edge tiles only: q rows past q_end, kv rows past
        // k_end, the diagonal, F9's rows (the options: their dead scores
        // set to -inf below, once the scores are in)
        bool edge = false;
        if constexpr (!Tiles::kMasked)
          edge = q0 + kFlashTile > q_end || k0 + kFlashTile > k_end ||
                 (causal && k0 + kFlashTile - 1 > q0) || q0 < f9_end;
        // s^T = K q^T and dP^T = V dO^T over D in k16 steps (the first
        // overwrites)
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_m64n64(s, kmajor(k_s, kk), kmajor(q_s, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_m64n64(dp, kmajor(v_s, kk), kmajor(do_s, kk), kk > 0);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(s);
        reg_fence(dp);
        if constexpr (Tiles::kMasked)
          if (!tiles.mask.whole(q0, k0))
            tiles.mask.template kill<true>(s, k0 + row_l, q0 + col_l);

        // p^T (into s) and dS^T (into dp)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 8 * j + col_l + e;
            const float l = lse_s[m], d = di_s[m];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float& x = s[4 * j + 2 * i + e];
              bool ok = true, f9 = false;
              if (edge) {
                const int row = q0 + m;
                const int col = k0 + row_l + 8 * i;
                const bool in = row < q_end && col < k_end;
                ok = in && (!causal || col <= row);
                // an F9 row: p = 1/n on each visited column, for dV only
                f9 = Tiles::kSparse && in && row < f9_end;
              }
              // masked: p = 0 by a select (the exp2 may be inf there)
              const float p = ok ? exp2_approx(x * scale_log2 - l) : 0.f;
              x = f9 ? inv_n : p;
              float& y = dp[4 * j + 2 * i + e];
              y = p * (y - d) * scale;
            }
          }

        // dV += p^T dO and dK += dS^T q: p^T and dS^T in bf16 pairs are
        // the A fragments (all operands ready before the fence, none
        // written while the products run)
        uint32_t pa[4][4], da[4][4];
        pack_a(s, pa);
        pack_a(dp, da);
        reg_fence(dv_acc);
        reg_fence(dk_acc);
        wgmma_fence();
        rs_tile<D>(dv_acc, pa, do_s);
        rs_tile<D>(dk_acc, da, q_s);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(dv_acc);
        reg_fence(dk_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with it
      next_stage(st, phase);
    }
  }

  const int64_t kvo = ((int64_t)b * Hkv + hk) * Skv * D;
  store_acc<D>(dk + kvo, k0 + row_l, k_end, col_l, dk_acc);
  store_acc<D>(dv + kvo, k0 + row_l, k_end, col_l, dv_acc);
}

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, T* __restrict__ dq,
                          int H, int Hkv, int Sq, float scale,
                          float scale_log2, int causal, Tiles tiles) {
  static_assert(sizeof(T) == 2, "the wgmma body takes 16-bit inputs");
  using L = BwdSmem<D, false>;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  // the block's NC kernel q tiles, one per consumer warpgroup, as the bf16
  // forward's
  int r0[NC], r_end[NC], count[NC];
  int n_tiles = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    tiles.own(blockIdx.x * NC + c, gridDim.x * NC, r0[c], r_end[c]);
    count[c] = r0[c] < r_end[c] ? tiles.count(r0[c]) : 0;
    n_tiles = max(n_tiles, count[c]);
  }
  auto visits = [&](int q0, int q_end, int n, int t, int& c0, int& c_end) {
    return t < n && tiles.visit(t, q0, q_end, c0, c_end);
  };
  auto loaded = [&](int t, int& c0, int& c_end) {
    bool any = false;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      any |= visits(r0[c], r_end[c], count[c], t, c0, c_end);
    return any;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform for the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // -- producer -----------------------------------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    tma_prefetch_map(&tq);
    tma_prefetch_map(&tk);
    tma_prefetch_map(&tv);
    tma_prefetch_map(&tdo);
    mbar_expect_tx(q_full, 2 * NC * L::kTile);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load_3d(smem + L::kA + c * L::kTile + p * kPanel, &tq, q_full,
                    p * 64, r0[c], b * H + h);
        tma_load_3d(smem + L::kB + c * L::kTile + p * kPanel, &tdo, q_full,
                    p * 64, r0[c], b * H + h);
      }
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      int c0 = 0, c_end = 0;
      if (!loaded(t, c0, c_end)) continue;
      mbar_wait(&empty[st], phase ^ 1);
      mbar_expect_tx(&full[st], 2 * L::kTile);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load_3d(smem + L::kRa + st * L::kTile + p * kPanel, &tk,
                    &full[st], p * 64, c0, b * Hkv + hk);
        tma_load_3d(smem + L::kRb + st * L::kTile + p * kPanel, &tv,
                    &full[st], p * 64, c0, b * Hkv + hk);
      }
      next_stage(st, phase);
    }
    return;
  }

  // -- consumers: warpgroup c owns 64 q rows --------------------------------
  setmaxnreg_inc<240>();
  const int c = wg - 1;
  int q0 = r0[0], q_end = r_end[0], n_own = count[0];
#pragma unroll
  for (int cc = 1; cc < NC; ++cc)
    if (cc == c) {
      q0 = r0[cc];
      q_end = r_end[cc];
      n_own = count[cc];
    }
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  // this thread's rows of the m64nN accumulators: row_a and row_a + 8; its
  // columns 8 j + col_l + {0, 1}
  const int row_a = q0 + warp * 16 + lane / 4;
  const int col_l = (lane % 4) * 2;
  const int64_t qo = ((int64_t)b * H + h) * Sq;
  float lse_r[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row_a + 8 * i < q_end;
    lse_r[i] = in ? lse[qo + row_a + 8 * i] : 0.f;
    di_r[i] = in ? di[qo + row_a + 8 * i] : 0.f;
  }

  float acc[D / 2];  // dQ, (64 x D) f32
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  const uint32_t q_s = smem_addr(smem + L::kA + c * L::kTile);
  const uint32_t do_s = smem_addr(smem + L::kB + c * L::kTile);

  mbar_wait(q_full, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    int c0 = 0, c_end = 0;
    if (!loaded(t, c0, c_end)) continue;
    mbar_wait(&full[st], phase);
    if (visits(q0, q_end, n_own, t, c0, c_end)) {
      const uint32_t k_s = smem_addr(smem + L::kRa + st * L::kTile);
      const uint32_t v_s = smem_addr(smem + L::kRb + st * L::kTile);
      // s = q K^T and dP = dO V^T over D in k16 steps
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(s, kmajor(q_s, kk), kmajor(k_s, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(dp, kmajor(do_s, kk), kmajor(v_s, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);
      reg_fence(dp);

      // dS (into dp); the mask on tiles that cross the diagonal or the
      // columns' end only (rows past q_end are never stored, and a row of
      // dQ sees only its own row of dS)
      bool edge = false;
      if constexpr (Tiles::kMasked) {  // the options: dead scores to -inf
        if (!tiles.mask.whole(q0, c0))
          tiles.mask.template kill<false>(s, row_a, c0 + col_l);
      } else {
        edge = c0 + kFlashTile > c_end || (causal && c0 + kFlashTile - 1 > q0);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_a + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            const int col = c0 + 8 * j + col_l + e;
            const bool ok =
                !edge || (col < c_end && (!causal || col <= row));
            const float p =
                ok ? exp2_approx(s[x] * scale_log2 - lse_r[i]) : 0.f;
            dp[x] = p * (dp[x] - di_r[i]) * scale;
          }
      }

      // dQ += dS K: dS in bf16 pairs is the A fragment, K the MN-major B
      uint32_t da[4][4];
      pack_a(dp, da);
      reg_fence(acc);
      wgmma_fence();
      rs_tile<D>(acc, da, k_s);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    next_stage(st, phase);
  }

  store_acc<D>(dq + qo * D, row_a, q_end, col_l, acc);
}

// -- D 256 on the tensor cores: one tile a block, two consumers on it ----

constexpr int kWideStages = 2;  // stages of the streamed side's ring
// setmaxnreg of the D 256 bodies' warpgroups: the producer's lse/di warp
// walks the masked schedule's tiles too, and spilled at 24 registers; 40
// leave the consumers 232 (40 x 128 + 232 x 256 <= 65,536), which neither
// role fills
constexpr int kWideProducerRegs = 40;
constexpr int kWideConsumerRegs = 232;

// dynamic shared memory of the D 256 bodies: the stationary side's one
// tile of two operands (four panels each), the ring of the streamed side's
// two operands, for dkv the ring's lse and di and the f32 p^T handed from
// one consumer to the other, the mbarriers, and the slack to align the
// base to 1024: 215,080 bytes (dkv), 197,672 (dq)
template <bool kStats>
struct WideSmem {
  static constexpr int kTile = 4 * kPanel;
  static constexpr int kA = 0;
  static constexpr int kB = kA + kTile;
  static constexpr int kRa = kB + kTile;
  static constexpr int kRb = kRa + kWideStages * kTile;
  static constexpr int kLse = kRb + kWideStages * kTile;
  static constexpr int kDi = kLse + (kStats ? kWideStages * kStat : 0);
  static constexpr int kP = kDi + (kStats ? kWideStages * kStat : 0);
  static constexpr int kBar = kP + (kStats ? 64 * 64 * 4 : 0);
  static constexpr int kBytes = kBar + (1 + 2 * kWideStages) * 8 + 1024;
};

// named barriers 1.. (0 is __syncthreads'): sync waits until n threads
// have arrived, arrive only counts; either orders this thread's earlier
// shared-memory accesses before the barrier completes
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// a 64 x 64 score tile over D 256 from two K-major tiles of four panels:
// 16 k16 steps (the first overwrites), each step's descriptors made beside
// its product. a_s goes through an empty asm, so that the compiler keeps
// none of the stationary tile's 16 descriptors (32 registers) across the
// walk.
__device__ __forceinline__ void scores256(float (&d)[32], uint32_t a_s,
                                          uint32_t b_s) {
  asm volatile("" : "+r"(a_s));
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_ss_m64n64(d, kmajor(a_s, kk), kmajor(b_s, kk), kk > 0);
}

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int Hkv, int Sq,
                          int Skv, float scale, float scale_log2, int causal,
                          Tiles tiles) {
  static_assert(sizeof(T) == 2 && D == 256,
                "the wide body takes 16-bit inputs at D 256");
  using L = WideSmem<true>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kWideStages;

  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  // the block's one kv tile, shared by both consumers
  int k0, k_end;
  tiles.own(blockIdx.x, gridDim.x, k0, k_end);
  const int n_tiles = k0 < k_end ? tiles.count(k0) : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kWideStages; ++st) {
      mbar_init(&full[st], 1 + 32);  // the issuer, the lse/di lanes
      mbar_init(&empty[st], 8);      // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // -- producer: as flash_bwd_dkv_wgmma_kernel's ---------------------------
    setmaxnreg_dec<kWideProducerRegs>();
    if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      int st = 0;
      uint32_t phase = 0;
      for (int g = 0; g < rep; ++g) {
        const int64_t bh = (int64_t)b * H + hk * rep + g;
        for (int t = 0; t < n_tiles; ++t) {
          int q0 = 0, q_end = 0, f9_end = 0;
          float inv_n = 0.f;
          if (!tiles.visit(t, k0, k_end, q0, q_end, f9_end, inv_n)) continue;
          mbar_wait(&empty[st], phase ^ 1);
          float* lse_s =
              reinterpret_cast<float*>(smem + L::kLse + st * kStat);
          float* di_s = reinterpret_cast<float*>(smem + L::kDi + st * kStat);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = q0 + lane + 32 * u;
            lse_s[lane + 32 * u] = r < q_end ? lse[bh * Sq + r] : 0.f;
            di_s[lane + 32 * u] = r < q_end ? di[bh * Sq + r] : 0.f;
          }
          mbar_arrive(&full[st]);
          next_stage<kWideStages>(st, phase);
        }
      }
      return;
    }
    if (threadIdx.x != 0) return;
    tma_prefetch_map(&tq);
    tma_prefetch_map(&tk);
    tma_prefetch_map(&tv);
    tma_prefetch_map(&tdo);
    mbar_expect_tx(kv_full, 2 * L::kTile);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      tma_load_3d(smem + L::kA + p * kPanel, &tk, kv_full, p * 64, k0,
                  b * Hkv + hk);
      tma_load_3d(smem + L::kB + p * kPanel, &tv, kv_full, p * 64, k0,
                  b * Hkv + hk);
    }
    int st = 0;
    uint32_t phase = 0;
    for (int g = 0; g < rep; ++g) {
      const int bh = b * H + hk * rep + g;
      for (int t = 0; t < n_tiles; ++t) {
        int q0 = 0, q_end = 0, f9_end = 0;
        float inv_n = 0.f;
        if (!tiles.visit(t, k0, k_end, q0, q_end, f9_end, inv_n)) continue;
        mbar_wait(&empty[st], phase ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kTile);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          tma_load_3d(smem + L::kRa + st * L::kTile + p * kPanel, &tq,
                      &full[st], p * 64, q0, bh);
          tma_load_3d(smem + L::kRb + st * L::kTile + p * kPanel, &tdo,
                      &full[st], p * 64, q0, bh);
        }
        next_stage<kWideStages>(st, phase);
      }
    }
    return;
  }

  // -- consumers, one role each over the block's 64 kv rows: warpgroup 1
  // computes s^T = K q^T and p^T, hands p^T to warpgroup 2 through shared
  // memory and accumulates dV += p^T dO; warpgroup 2 computes dP^T = V dO^T,
  // dS^T from the handed p^T and accumulates dK += dS^T q --------------------
  setmaxnreg_inc<kWideConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row_l = warp * 16 + lane / 4;
  const int col_l = (lane % 4) * 2;
  // p^T as both warpgroups' m64n64 fragments hold it: this thread's 32
  // values, 8 float4 128 threads apart
  float4* p_buf = reinterpret_cast<float4*>(smem + L::kP) + threadIdx.x % 128;

  float lo[64], hi[64];  // dV (warpgroup 1) or dK (2): columns 0..127, 128..
#pragma unroll
  for (int j = 0; j < 64; ++j) lo[j] = hi[j] = 0.f;
  const uint32_t k_s = smem_addr(smem + L::kA);
  const uint32_t v_s = smem_addr(smem + L::kB);

  mbar_wait(kv_full, 0);
  int st = 0, n = 0;  // n: the tiles this block has computed on
  uint32_t phase = 0;
  for (int g = 0; g < rep; ++g) {
    for (int t = 0; t < n_tiles; ++t) {
      int q0 = 0, q_end = 0, f9_end = 0;
      float inv_n = 0.f;
      if (!tiles.visit(t, k0, k_end, q0, q_end, f9_end, inv_n)) continue;
      mbar_wait(&full[st], phase);
      const uint32_t q_s = smem_addr(smem + L::kRa + st * L::kTile);
      const uint32_t do_s = smem_addr(smem + L::kRb + st * L::kTile);
      uint32_t a[4][4];
      if (wg == 1) {
        const float* lse_s =
            reinterpret_cast<const float*>(smem + L::kLse + st * kStat);
        float s[32];
        wgmma_fence();
        scores256(s, k_s, q_s);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(s);
        // the mask: q rows past q_end, kv rows past k_end, the diagonal
        // (the options: their dead scores to -inf)
        bool edge = false;
        if constexpr (Tiles::kMasked) {
          if (!tiles.mask.whole(q0, k0))
            tiles.mask.template kill<true>(s, k0 + row_l, q0 + col_l);
        } else {
          edge = q0 + kFlashTile > q_end || k0 + kFlashTile > k_end ||
                 (causal && k0 + kFlashTile - 1 > q0);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 8 * j + col_l + e;
            const float l = lse_s[m];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float& x = s[4 * j + 2 * i + e];
              bool ok = true;
              if (edge) {
                const int row = q0 + m;
                const int col = k0 + row_l + 8 * i;
                ok = row < q_end && col < k_end && (!causal || col <= row);
              }
              x = ok ? exp2_approx(x * scale_log2 - l) : 0.f;
            }
          }
        if (n > 0) named_sync(2, 256);  // warpgroup 2 has read the last p^T
#pragma unroll
        for (int u = 0; u < 8; ++u)
          p_buf[128 * u] =
              make_float4(s[4 * u], s[4 * u + 1], s[4 * u + 2], s[4 * u + 3]);
        named_arrive(1, 256);
        // an F9 row (its tile crosses the diagonal, so `edge` held): p = 1/n
        // on each visited column, for dV only (dS took the p above, 0)
        if constexpr (Tiles::kSparse) {
          if (q0 < f9_end) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int row = q0 + 8 * j + col_l + e;
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                  const int col = k0 + row_l + 8 * i;
                  if (row < f9_end && row < q_end && col < k_end)
                    s[4 * j + 2 * i + e] = inv_n;
                }
              }
          }
        }
        pack_a(s, a);
      } else {
        const float* di_s =
            reinterpret_cast<const float*>(smem + L::kDi + st * kStat);
        if (n > 0) named_arrive(2, 256);  // done with the last p^T
        float dp[32];
        wgmma_fence();
        scores256(dp, v_s, do_s);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(dp);
        named_sync(1, 256);  // this tile's p^T is in
        // dS^T = p^T (dP^T - di) * scale, from the unrounded p
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 p4 = p_buf[128 * u];
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int x = 4 * u + w;
            const float d = di_s[8 * u + col_l + w % 2];
            dp[x] = p[w] * (dp[x] - d) * scale;
          }
        }
        pack_a(dp, a);
      }
      // dV += p^T dO (warpgroup 1) or dK += dS^T q (2): two m64n128k16 a
      // k16 step, columns 0..127 (panels 0, 1) and 128..255 (2, 3)
      const uint32_t b_s = wg == 1 ? do_s : q_s;
      reg_fence(lo);
      reg_fence(hi);
      wgmma_fence();
      rs_tile<128>(lo, a, b_s);
      rs_tile<128>(hi, a, b_s + 2 * kPanel);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(lo);
      reg_fence(hi);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      next_stage<kWideStages>(st, phase);
      ++n;
    }
  }

  T* out = (wg == 1 ? dv : dk) + ((int64_t)b * Hkv + hk) * Skv * D;
  store_acc<128, D>(out, k0 + row_l, k_end, col_l, lo);
  store_acc<128, D>(out + 128, k0 + row_l, k_end, col_l, hi);
}

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dq,
                         int H, int Hkv, int Sq, float scale,
                         float scale_log2, int causal, Tiles tiles) {
  static_assert(sizeof(T) == 2 && D == 256,
                "the wide body takes 16-bit inputs at D 256");
  using L = WideSmem<false>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWideStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  // the block's one q tile, shared by both consumers
  int q0, q_end;
  tiles.own(blockIdx.x, gridDim.x, q0, q_end);
  const int n_tiles = q0 < q_end ? tiles.count(q0) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kWideStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // -- producer -----------------------------------------------------------
    setmaxnreg_dec<kWideProducerRegs>();
    if (threadIdx.x != 0) return;
    tma_prefetch_map(&tq);
    tma_prefetch_map(&tk);
    tma_prefetch_map(&tv);
    tma_prefetch_map(&tdo);
    mbar_expect_tx(q_full, 2 * L::kTile);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      tma_load_3d(smem + L::kA + p * kPanel, &tq, q_full, p * 64, q0,
                  b * H + h);
      tma_load_3d(smem + L::kB + p * kPanel, &tdo, q_full, p * 64, q0,
                  b * H + h);
    }
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      int c0 = 0, c_end = 0;
      if (!tiles.visit(t, q0, q_end, c0, c_end)) continue;
      mbar_wait(&empty[st], phase ^ 1);
      mbar_expect_tx(&full[st], 2 * L::kTile);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        tma_load_3d(smem + L::kRa + st * L::kTile + p * kPanel, &tk,
                    &full[st], p * 64, c0, b * Hkv + hk);
        tma_load_3d(smem + L::kRb + st * L::kTile + p * kPanel, &tv,
                    &full[st], p * 64, c0, b * Hkv + hk);
      }
      next_stage<kWideStages>(st, phase);
    }
    return;
  }

  // -- consumers: warpgroup c owns dQ's columns 128 c.. 128 c + 127 of the
  // block's 64 q rows; both compute the whole s and dP ---------------------
  setmaxnreg_inc<kWideConsumerRegs>();
  const int c = wg - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row_a = q0 + warp * 16 + lane / 4;
  const int col_l = (lane % 4) * 2;
  const int64_t qo = ((int64_t)b * H + h) * Sq;
  float lse_r[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row_a + 8 * i < q_end;
    lse_r[i] = in ? lse[qo + row_a + 8 * i] : 0.f;
    di_r[i] = in ? di[qo + row_a + 8 * i] : 0.f;
  }

  float acc[64];  // (64 x 128) f32
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  const uint32_t q_s = smem_addr(smem + L::kA);
  const uint32_t do_s = smem_addr(smem + L::kB);
  const int half = 2 * c * kPanel;  // the consumer's panels of K

  mbar_wait(q_full, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    int c0 = 0, c_end = 0;
    if (!tiles.visit(t, q0, q_end, c0, c_end)) continue;
    mbar_wait(&full[st], phase);
    const uint32_t k_s = smem_addr(smem + L::kRa + st * L::kTile);
    const uint32_t v_s = smem_addr(smem + L::kRb + st * L::kTile);
    // s = q K^T and dP = dO V^T over the whole D
    float s[32], dp[32];
    wgmma_fence();
    scores256(s, q_s, k_s);
    scores256(dp, do_s, v_s);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);
    reg_fence(dp);

    bool edge = false;
    if constexpr (Tiles::kMasked) {
      if (!tiles.mask.whole(q0, c0))
        tiles.mask.template kill<false>(s, row_a, c0 + col_l);
    } else {
      edge = c0 + kFlashTile > c_end || (causal && c0 + kFlashTile - 1 > q0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          const int col = c0 + 8 * j + col_l + e;
          const bool ok = !edge || (col < c_end && (!causal || col <= row));
          const float p = ok ? exp2_approx(s[x] * scale_log2 - lse_r[i])
                             : 0.f;
          dp[x] = p * (dp[x] - di_r[i]) * scale;
        }
    }

    // dQ[:, half] += dS K[:, half]: m64n128k16 over the consumer's panels
    uint32_t da[4][4];
    pack_a(dp, da);
    reg_fence(acc);
    wgmma_fence();
    rs_tile<128>(acc, da, k_s + half);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    next_stage<kWideStages>(st, phase);
  }

  store_acc<128, D>(dq + qo * D + 128 * c, row_a, q_end, col_l, acc);
}

// the tensor-core bodies of a head dim: D 256's wide ones, else the others
template <int D, typename Tiles>
constexpr auto dkv_tensor_core() {
  if constexpr (D == 256)
    return flash_bwd_dkv_wide_kernel<__nv_bfloat16, D, Tiles>;
  else
    return flash_bwd_dkv_wgmma_kernel<__nv_bfloat16, D, Tiles>;
}
template <int D, typename Tiles>
constexpr auto dq_tensor_core() {
  if constexpr (D == 256)
    return flash_bwd_dq_wide_kernel<__nv_bfloat16, D, Tiles>;
  else
    return flash_bwd_dq_wgmma_kernel<__nv_bfloat16, D, Tiles>;
}

template <int D, typename Tiles>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* di, void* dk, void* dv, int B,
                             int H, int Hkv, int Sq, int Skv, float scale,
                             float scale_log2, int causal, int blocks,
                             Tiles tiles, cudaStream_t stream) {
  using T = __nv_bfloat16;
  if (Sq == 0) {  // no query: dK and dV are sums of nothing
    const size_t n = (size_t)B * Hkv * Skv * D * sizeof(T);
    cudaMemsetAsync(dk, 0, n, stream);
    cudaMemsetAsync(dv, 0, n, stream);
    return cudaGetLastError();
  }
  constexpr int smem =
      D == 256 ? WideSmem<true>::kBytes : BwdSmem<D, true>::kBytes;
  const auto kernel = dkv_tensor_core<D, Tiles>();
  static const cudaError_t attr = opt_in_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  // the maps are kernel parameters (__grid_constant__), encoded per call
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e = rows_map(&tq, q, D, Sq, B * H);
  if (e == cudaSuccess) e = rows_map(&tdo, dout, D, Sq, B * H);
  if (e == cudaSuccess) e = rows_map(&tk, k, D, Skv, B * Hkv);
  if (e == cudaSuccess) e = rows_map(&tv, v, D, Skv, B * Hkv);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, Hkv, B);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<T*>(dk), static_cast<T*>(dv),
      H, Hkv, Sq, Skv, scale, scale_log2, causal, tiles);
  return cudaGetLastError();
}

template <int D, typename Tiles>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* di, void* dq, int B, int H, int Hkv,
                            int Sq, int Skv, float scale, float scale_log2,
                            int causal, int blocks, Tiles tiles,
                            cudaStream_t stream) {
  using T = __nv_bfloat16;
  if (Skv == 0) {  // no key: dQ is a sum of nothing
    cudaMemsetAsync(dq, 0, (size_t)B * H * Sq * D * sizeof(T), stream);
    return cudaGetLastError();
  }
  constexpr int smem =
      D == 256 ? WideSmem<false>::kBytes : BwdSmem<D, false>::kBytes;
  const auto kernel = dq_tensor_core<D, Tiles>();
  static const cudaError_t attr = opt_in_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e = rows_map(&tq, q, D, Sq, B * H);
  if (e == cudaSuccess) e = rows_map(&tdo, dout, D, Sq, B * H);
  if (e == cudaSuccess) e = rows_map(&tk, k, D, Skv, B * Hkv);
  if (e == cudaSuccess) e = rows_map(&tv, v, D, Skv, B * Hkv);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, H, B);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, di, static_cast<T*>(dq), H, Hkv, Sq, scale,
      scale_log2, causal, tiles);
  return cudaGetLastError();
}

// The (dtype, head_dim) instances of one schedule: f32 dK/dV on the 3xTF32
// body and f32 dQ on the CUDA-core bodies (one 64-row tile to a block),
// bf16 on the wgmma bodies (NC 64-row tiles to a block, one at D 256;
// `tiles` counts the launch's tiles so), on every schedule. The launchers
// of both bodies take the same arguments. Neither falls back on the other: an
// error of the chosen body is returned as it is.
constexpr int tiles_per_block(int dtype, int D) {
  return dtype == kBF16 && D != 256 ? NC : 1;
}

template <typename Tiles>
int launch_dkv_any(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* di,
                   void* dk, void* dv, int dtype, int B, int H, int Hkv,
                   int Sq, int Skv, int D, float scale, float scale_log2,
                   int causal, int blocks, Tiles tiles, cudaStream_t st) {
#define CUBECL_DKV(LAUNCH)                                                   \
  LAUNCH(q, k, v, dout, lse, di, dk, dv, B, H, Hkv, Sq, Skv, scale,          \
         scale_log2, causal, blocks, tiles, st)
  if (dtype == kF32 && D == 64)
    return CUBECL_DKV((launch_dkv_tf32x3<64, Tiles>));
  if (dtype == kF32 && D == 128)
    return CUBECL_DKV((launch_dkv_tf32x3<128, Tiles>));
  if (dtype == kBF16 && D == 64)
    return CUBECL_DKV((launch_dkv_wgmma<64, Tiles>));
  if (dtype == kBF16 && D == 128)
    return CUBECL_DKV((launch_dkv_wgmma<128, Tiles>));
  if (dtype == kF32 && D == 256)
    return CUBECL_DKV((launch_dkv_tf32x3<256, Tiles>));
  if (dtype == kBF16 && D == 256)
    return CUBECL_DKV((launch_dkv_wgmma<256, Tiles>));
#undef CUBECL_DKV
  return cudaErrorInvalidValue;
}

template <typename Tiles>
int launch_dq_any(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* di,
                  void* dq, int dtype, int B, int H, int Hkv, int Sq, int Skv,
                  int D, float scale, float scale_log2, int causal,
                  int blocks, Tiles tiles, cudaStream_t st) {
#define CUBECL_DQ(LAUNCH)                                                    \
  LAUNCH(q, k, v, dout, lse, di, dq, B, H, Hkv, Sq, Skv, scale, scale_log2,  \
         causal, blocks, tiles, st)
  if (dtype == kF32 && D == 64)
    return CUBECL_DQ((launch_dq<float, 64, Tiles>));
  if (dtype == kF32 && D == 128)
    return CUBECL_DQ((launch_dq<float, 128, Tiles>));
  if (dtype == kBF16 && D == 64)
    return CUBECL_DQ((launch_dq_wgmma<64, Tiles>));
  if (dtype == kBF16 && D == 128)
    return CUBECL_DQ((launch_dq_wgmma<128, Tiles>));
  if (dtype == kF32 && D == 256)
    return CUBECL_DQ((launch_dq<float, 256, Tiles>));
  if (dtype == kBF16 && D == 256)
    return CUBECL_DQ((launch_dq_wgmma<256, Tiles>));
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
  const int rows = tiles_per_block(dtype, D) * kFlashTile;  // kv rows a block
  return launch_dkv_any(q, k, v, dout, lse, di, dk, dv, dtype, B, H, Hkv, Sq,
                        Skv, D, scale, scale_log2, causal,
                        (Skv + rows - 1) / rows,
                        DenseKVTiles{Sq, Skv, causal, rows},
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
  const int rows = tiles_per_block(dtype, D) * kFlashTile;  // q rows a block
  return launch_dq_any(q, k, v, dout, lse, di, dq, dtype, B, H, Hkv, Sq, Skv,
                       D, scale, scale_log2, causal, (Sq + rows - 1) / rows,
                       DenseQTiles{Sq, Skv, causal},
                       static_cast<cudaStream_t>(stream));
}

// A3 with its options: the inputs of cubecl_flash_bwd_dkv, and the
// options and segment ids of cubecl_flash_masked_fwd (which see)
extern "C" int cubecl_flash_masked_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, void* dk, void* dv, const int* seg_q,
    const int* seg_kv, const int* ranges, int dtype, int B, int H, int Hkv,
    int Sq, int Skv, int D, float scale, float scale_log2, int causal,
    int kv_len, int left, int right, void* stream) {
  using namespace cubecl;
  const int rows = tiles_per_block(dtype, D) * kFlashTile;  // kv rows a block
  const MaskedKVTiles tiles{make_mask(B, Sq, Skv, causal, kv_len, left, right,
                                      seg_q, seg_kv, ranges)};
  return launch_dkv_any(q, k, v, dout, lse, di, dk, dv, dtype, B, H, Hkv, Sq,
                        Skv, D, scale, scale_log2, causal,
                        (Skv + rows - 1) / rows, tiles,
                        static_cast<cudaStream_t>(stream));
}

// A4 with its options: the inputs of cubecl_flash_bwd_dq and the options
extern "C" int cubecl_flash_masked_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, void* dq, const int* seg_q,
    const int* seg_kv, const int* ranges, int dtype, int B, int H, int Hkv,
    int Sq, int Skv, int D, float scale, float scale_log2, int causal,
    int kv_len, int left, int right, void* stream) {
  using namespace cubecl;
  const int rows = tiles_per_block(dtype, D) * kFlashTile;  // q rows a block
  const MaskedQTiles tiles{make_mask(B, Sq, Skv, causal, kv_len, left, right,
                                     seg_q, seg_kv, ranges)};
  return launch_dq_any(q, k, v, dout, lse, di, dq, dtype, B, H, Hkv, Sq, Skv,
                       D, scale, scale_log2, causal, (Sq + rows - 1) / rows,
                       tiles, static_cast<cudaStream_t>(stream));
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
  // a block's kernel tiles lie in one user tile, as in the bf16 forward
  const int per = tiles_per_block(dtype, D);
  const int slots = (q_sub + per - 1) / per * per;
  const SparseQTiles tiles{ids, counts, stride, bq, bk, slots, k_sub,
                           causal, /*keep_f9=*/0, 0};
  return launch_dq_any(q, k, v, dout, lse, di, dq, dtype, B, H, H, Sq, Skv,
                       D, scale, scale_log2, causal, (Sq / bq) * slots / per,
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
  const int per = tiles_per_block(dtype, D);
  const int slots = (k_sub + per - 1) / per * per;
  const SparseKVTiles tiles{t_ids, t_counts, f_ids, f_counts, t_stride,
                            f_stride, bq, bk, slots, q_sub, causal, 0};
  return launch_dkv_any(q, k, v, dout, lse, di, dk, dv, dtype, B, H, H, Sq,
                        Skv, D, scale, scale_log2, causal,
                        (Skv / bk) * slots / per, tiles,
                        static_cast<cudaStream_t>(stream));
}
