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
// Bound on the H100: at prefill and training sizes (S ~ 1k, D 64/128)
// attention does 4 D flops per live (query, key) pair against 4 D bytes of
// q, k, v and o per row, so it is compute-bound in bf16 from D 128 (the
// 0.77B llama's bf16 B8 H16/8 S1024 causal: 34.4 GFLOP, 0.035 ms at
// 989 TFLOP/s against 0.030 ms for its bytes) and close to balanced at
// D 64. Two bodies, chosen by dtype:
//
// bf16: the tensor cores (flash_fwd_wgmma_kernel). Both products are wgmma:
// S = Q K^T (m64n64k16, Q and K from shared memory) and O += P V
// (m64nDk16, P from registers, V from shared memory as the MN-major B with
// the transpose bit). The f32 accumulator fragment of S, after the online
// softmax, is packed into bf16 pairs in registers and is the A fragment of
// the second product, one k16 slice at a time: P never touches shared
// memory. Rounding P to bf16 for P.V is A1's own rounding (p.astype(v's
// dtype), f32 accumulation); m, l and O stay f32 in registers, l sums the
// unrounded p. The block is warp-specialised: one thread of a producer
// warpgroup issues TMA copies (3-D tensor maps (D, S, B*H) with the
// 128-byte swizzle the wgmma descriptors name; rows past S arrive as
// zeros) of the q tiles and of K/V tiles into a ring of kStages stages
// completed on mbarriers, so the next tiles' copies overlap the current
// tile's products; consumer warpgroups of 64 q rows each run the products
// and the softmax, with setmaxnreg moving the producer's registers to
// them. Two consumers a block (128 q rows), so each K/V tile read from L2
// serves 128 rows; block-sparse, both tiles lie in one user q tile (the
// same kv walk), and where it has fewer the second has no rows. The
// producer loads the union of the consumers' tiles; each consumer
// computes on its own and releases every stage. The causal mask is applied only on the tiles that cross the
// diagonal or the tile's column end; exp2 is the special-function unit's
// ex2.approx alone (16 results a clock an SM: half the tensor cores' time
// per score at D 128, all of it at D 64).
//
// f32: the tensor cores as three TF32 products (flash_fwd_tf32x3_kernel,
// on flash_tf32.cuh). One TF32 product keeps about three decimal digits and
// would break the f32 exactness the port's f32 paths hold against their
// plain versions (atol 2e-5, rtol 1e-4); the split of each operand into a
// big and a small tf32 half holds it, as M1's f32 GEMM does. One warpgroup
// a block owns a 64-row q tile of one (batch, head), kept in shared memory
// as it is (the A operand of S, split in registers at each use), and walks
// each visited 64-row kv tile in two steps of 32 keys: the step's K is
// staged split (big and small tiles, K-major over D) and its V transposed
// and split (K-major along the keys), by plain loads; S = Q K^T is
// m64n32k8, twelve products (four k8 steps) a 32-column panel of D summed
// from zero and added in f32; the online softmax runs on the f32
// accumulator; O += P V takes P from that accumulator as the split A
// fragment, m64n64k8 a 64-column block of O, twelve products summed from
// zero and added to O in f32 (the tensor cores' sums round toward zero).
// 48, 96 and 192 KB of shared memory at D 64, 128 and 256. exp2 is exp2f.
// Bound: 3 x 4 D flops a live pair at 495 TFLOP/s of TF32 (the D 128
// prefill of GPT-J's heads, 0.2 ms).
//
// Both: tiles wholly above the diagonal are never visited; GQA reads kv
// head h / (H / Hkv) directly, with no repeat.
//
// D 256 (GPT-J-6B's and Qwen3-Next's head dim), the forward alone: bf16
// keeps its body with 2 K/V stages (wg_stages: q tiles and K/V tiles are
// 32 KB each, and 3 stages would take 256 KB of the 227 KB a block may
// hold); O is 128 f32 registers a consumer thread, held beside S's 32
// under the consumers' setmaxnreg budget of 240; P V is two m64n128k16
// products a k16 step (columns 0..127, 128..255), and Q K^T's 16 k16
// steps make their descriptors beside each product instead of keeping 32
// registers of them across the loop. f32 runs the same 3xTF32 body (O 128
// registers a thread, 192 KB). A5 runs the same D 256 bodies on the
// block-sparse schedule (ops/attention.py pads D 129-255 to 256).
//
// A1's options (kv_len, segment ids, a sliding window) and A8's window are
// the same bodies on the masked schedule of flash_tiles.cuh
// (cubecl_flash_masked_fwd): the walk covers the band's tiles only, a tile
// is skipped whole past kv_len, off the band or where the segment id ranges
// do not overlap, and a tile that is not wholly live has its dead scores
// set to -inf before the softmax, which then masks nothing. The dense and
// block-sparse instances keep their code: the masked one differs in
// `if constexpr` branches only.
//
// The same kernel bodies, with the block-sparse schedule of flash_tiles.cuh
// in place of the dense causal range, replace A5 _bsp_fwd_call
// (block-sparse forward over build_block_schedule's kv_ids and counts):
// a 64-row kernel tile lies in one user q tile and visits the kernel tiles
// of that tile's active kv tiles, with the JAX kernels' finite mask value.
#include "flash_tf32.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace cubecl {
namespace {

constexpr int BM = 64;  // q rows per kernel tile

// -- the f32 body: 3xTF32 wgmma (flash_tf32.cuh) ---------------------------

// dynamic shared memory of the f32 body: the q tile as it is (D / 32 panels
// of 64 rows), a step's 32 keys split in two (K: D / 32 panels of 32 rows
// each half; V transposed: D rows of 32 keys each half), and the slack to
// align the base to 1024: 48, 96 and 192 KB at D 64, 128 and 256
template <int D>
struct F32Smem {
  static constexpr int kQ = 0;
  static constexpr int kKb = kQ + BM * D * 4;
  static constexpr int kKs = kKb + kStep * D * 4;
  static constexpr int kVb = kKs + kStep * D * 4;
  static constexpr int kVs = kVb + kStep * D * 4;
  static constexpr int kBytes = kVs + kStep * D * 4 + 1024;
};

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int H, int Hkv, int Sq,
                        int Skv, float scale_log2, int causal, Tiles tiles) {
  static_assert(sizeof(T) == 4, "the 3xTF32 body takes f32 inputs");
  static_assert(D == 64 || D == 128 || D == 256,
                "the 3xTF32 body is built for D 64, 128 and 256");
  using L = F32Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int q0, q_end;  // the block's rows; rows from q_end on are not its own
  tiles.own(q0, q_end);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* kp = k + ((int64_t)b * Hkv + hk) * Skv * D;
  const T* vp = v + ((int64_t)b * Hkv + hk) * Skv * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this thread's rows of the m64nN accumulators: row_a and row_a + 8; its
  // columns 8 j + col_l + {0, 1}
  const int row_a = q0 + warp * 16 + lane / 4;
  const int col_l = (lane % 4) * 2;

  // the q tile as it is; rows past q_end are zero (their output is not
  // stored)
  stage_rows<BM, D, false>(q + ((int64_t)b * H + h) * Sq * D, D, q0, q_end,
                           smem + L::kQ, nullptr);
  const uint32_t q_s = smem_addr(smem + L::kQ);
  const uint32_t kb_s = smem_addr(smem + L::kKb);
  const uint32_t ks_s = smem_addr(smem + L::kKs);
  const uint32_t vb_s = smem_addr(smem + L::kVb);
  const uint32_t vs_s = smem_addr(smem + L::kVs);

  // O, (64 x D) f32 in column blocks of AN: 32 at D 256, where blocks of
  // 64 (a 32-register part beside O's 128) spilled
  constexpr int AN = D == 256 ? 32 : 64;
  float acc[D / AN][AN / 2];
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < D / AN; ++c)
#pragma unroll
    for (int j = 0; j < AN / 2; ++j) acc[c][j] = 0.f;

  const int n_tiles = tiles.count(q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    int c0, c_end;  // the tile's columns; those from c_end on are absent
    if (!tiles.visit(kt, q0, q_end, c0, c_end)) continue;
    // the mask on edge tiles only (the options: dead scores to -inf on a
    // tile that is not wholly live)
    bool edge = false, whole = true;
    if constexpr (Tiles::kMasked)
      whole = tiles.mask.whole(q0, c0);
    else
      edge = c0 + kFlashTile > c_end || (causal && c0 + kFlashTile - 1 > q0);
    // the tile's two steps of 32 keys
    for (int k0 = c0; k0 < c0 + kFlashTile && k0 < c_end; k0 += kStep) {
      __syncthreads();  // the previous step's products are done
      stage_rows<kStep, D, true>(kp, D, k0, c_end, smem + L::kKb,
                                 smem + L::kKs);
      stage_cols<D>(vp, D, k0, c_end, 0, smem + L::kVb, smem + L::kVs);
      fence_proxy_async();  // the stores, then wgmma's reads
      __syncthreads();

      // S = Q K^T
      float s[16];
      scores<D>(s, q_s, kb_s, ks_s);
      if constexpr (Tiles::kMasked)
        if (!whole) tiles.mask.template kill<false>(s, row_a, k0 + col_l);

      // online softmax, base 2; a row's 32 columns live in 4 lanes
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_a + 8 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * i + e];
            if (edge) {
              const int col = k0 + 8 * j + col_l + e;
              const bool ok = col < c_end && (!causal || col <= row);
              if constexpr (Tiles::kSparse)  // causal: the finite mask value
                x = ok ? x * scale_log2
                       : (col < c_end ? kMaskValue : -INFINITY);
              else
                x = ok ? x * scale_log2 : -INFINITY;
            } else {
              x *= scale_log2;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[i], mx);
        // a row with nothing live yet keeps p = 0 instead of exp2(nan)
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m_i[i] - m_use);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * i + e];
            x = exp2f(x - m_use);
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_i[i] = l_i[i] * alpha + rs;
        m_i[i] = m_new;
#pragma unroll
        for (int c = 0; c < D / AN; ++c)
#pragma unroll
          for (int j = 0; j < AN / 8; ++j) {
            acc[c][4 * j + 2 * i] *= alpha;
            acc[c][4 * j + 2 * i + 1] *= alpha;
          }
      }

      // O += P V: P, the accumulator of S, is the split A fragment
      accumulate<D, AN>(acc, s, vb_s, vs_s);
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    inv[i] = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
    // a row with nothing live gets lse 0, finite, and its masked columns
    // give exp2(s - 0) = 0 anyway
    if (lse != nullptr && lane % 4 == 0 && row < q_end)
      lse[((int64_t)b * H + h) * Sq + row] =
          l_i[i] == 0.f ? 0.f : m_i[i] + log2f(l_i[i]);
  }
  store_f32<D, AN>(o + ((int64_t)b * H + h) * Sq * D, D, row_a, q_end,
                   col_l, acc, inv);
}

template <int D, typename Tiles>
cudaError_t launch_flash_tf32x3(const void* q, const void* k, const void* v,
                                void* o, float* lse, int B, int H, int Hkv,
                                int Sq, int Skv, float scale_log2, int causal,
                                int blocks, Tiles tiles,
                                cudaStream_t stream) {
  constexpr int smem = F32Smem<D>::kBytes;
  // above 48 KB a kernel must opt in to dynamic shared memory, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<float, D, Tiles>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(blocks, H, B);
  flash_fwd_tf32x3_kernel<float, D, Tiles>
      <<<grid, kF32Threads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv,
          Sq, Skv, scale_log2, causal, tiles);
  return cudaGetLastError();
}

// -- the bf16 body: wgmma fed by TMA, warp-specialised ---------------------

constexpr int kPanel = 64 * 128;  // one 64-row x 64-column bf16 panel, bytes
constexpr int NC = 2;             // consumer warpgroups (64 q rows each)
constexpr int kWgThreads = 128 * (NC + 1);

// K/V stages of the ring: 3, or 2 at D 256, whose NC q tiles and K/V
// tiles are 32 KB each (3 stages would take 256 KB of the 227 KB a block
// may hold; 2 take 192 KB)
template <int D>
constexpr int wg_stages() {
  return D == 256 ? 2 : 3;
}

// dynamic shared memory of the bf16 body: NC q tiles, then the K and V
// rings, each tile D / 64 panels; then the mbarriers (the q tiles', and
// each stage's full and empty); plus the slack to align the base to 1024
template <int D>
struct WgSmem {
  static constexpr int kStages = wg_stages<D>();
  static constexpr int kTile = D / 64 * kPanel;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + NC * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <typename T, int D, typename Tiles>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o, float* __restrict__ lse, int H,
                       int Hkv, int Sq, float scale_log2, int causal,
                       Tiles tiles) {
  static_assert(sizeof(T) == 2, "the wgmma body takes 16-bit inputs");
  static_assert(D == 64 || D == 128 || D == 256,
                "the wgmma body is built for D 64, 128 and 256");
  using L = WgSmem<D>;
  constexpr int kPanels = D / 64;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  // the block's NC kernel q tiles, one per consumer warpgroup; a tile at or
  // past its r_end has no rows (the grid's padding)
  int r0[NC], r_end[NC], count[NC];
  int n_tiles = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    tiles.own(blockIdx.x * NC + c, gridDim.x * NC, r0[c], r_end[c]);
    count[c] = r0[c] < r_end[c] ? tiles.count(r0[c]) : 0;
    n_tiles = max(n_tiles, count[c]);
  }
  // does the consumer of rows [q0, q_end) and n tiles compute on tile t
  // (its columns [c0, c_end))?
  auto visits = [&](int q0, int q_end, int n, int t, int& c0, int& c_end) {
    return t < n && tiles.visit(t, q0, q_end, c0, c_end);
  };
  // the tiles the block loads: the union of its consumers' tiles, walked in
  // the same order by the producer and by every consumer
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
      mbar_init(&empty[st], 4 * NC);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: one thread issues every copy -----------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    tma_prefetch_map(&tq);
    tma_prefetch_map(&tk);
    tma_prefetch_map(&tv);
    mbar_expect_tx(q_full, NC * L::kTile);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_load_3d(smem + L::kQ + c * L::kTile + p * kPanel, &tq, q_full,
                    p * 64, r0[c], b * H + h);
    int st = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      int c0 = 0, c_end = 0;
      if (!loaded(t, c0, c_end)) continue;
      mbar_wait(&empty[st], phase ^ 1);  // the first round passes at once
      mbar_expect_tx(&full[st], 2 * L::kTile);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load_3d(smem + L::kK + st * L::kTile + p * kPanel, &tk, &full[st],
                    p * 64, c0, b * Hkv + hk);
        tma_load_3d(smem + L::kV + st * L::kTile + p * kPanel, &tv, &full[st],
                    p * 64, c0, b * Hkv + hk);
      }
      if (++st == kStages) {
        st = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // -- consumers: warpgroup c owns 64 q rows --------------------------------
  setmaxnreg_inc<240>();
  const int c = threadIdx.x / 128 - 1;
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
  // this thread's rows of the m64nN accumulator: row_a and row_a + 8; its
  // columns 8 j + col_l + {0, 1}
  const int row_a = q0 + warp * 16 + lane / 4;
  const int col_l = (lane % 4) * 2;

  float acc[D / 2];  // O, (64 x D) f32
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  const uint32_t q_s = smem_addr(smem + L::kQ + c * L::kTile);
  // Q's descriptors, k16 steps, 4 to a 128-byte panel, made once; at D 256
  // (16 of them: 32 registers beside O's 128) made again for each tile
  constexpr bool kWide = D == 256;
  uint64_t dq[kWide ? 1 : D / 16];
  if constexpr (!kWide) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dq[kk] = sw128_desc(q_s + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024);
  }

  mbar_wait(q_full, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    int c0 = 0, c_end = 0;
    if (!loaded(t, c0, c_end)) continue;
    mbar_wait(&full[st], phase);
    if (visits(q0, q_end, n_own, t, c0, c_end)) {
      // S = Q K^T over D in k16 steps (the first overwrites s)
      const uint32_t k_s = smem_addr(smem + L::kK + st * L::kTile);
      float s[32];
      uint64_t dk[kWide ? 1 : D / 16];
      if constexpr (!kWide) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          dk[kk] = sw128_desc(k_s + (kk / 4) * kPanel + (kk % 4) * 32, 16,
                              1024);
      }
      if constexpr (kWide) {
        // Q's base through an empty asm, so that the compiler makes each
        // step's descriptors beside its product and keeps none across the
        // loop
        uint32_t qb = q_s;
        asm volatile("" : "+r"(qb));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kPanel + (kk % 4) * 32;
          wgmma_ss_m64n64(s, sw128_desc(qb + off, 16, 1024),
                          sw128_desc(k_s + off, 16, 1024), kk > 0);
        }
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_m64n64(s, dq[kk], dk[kk], kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);

      // online softmax, base 2; a row's 64 columns live in 4 lanes
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
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * i + e];
            if (edge) {
              const int col = c0 + 8 * j + col_l + e;
              const bool ok = col < c_end && (!causal || col <= row);
              if constexpr (Tiles::kSparse)  // causal: the finite mask value
                x = ok ? x * scale_log2
                       : (col < c_end ? kMaskValue : -INFINITY);
              else
                x = ok ? x * scale_log2 : -INFINITY;
            } else {
              x *= scale_log2;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[i], mx);
        // a row with nothing live yet keeps p = 0 instead of exp2(nan)
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2_approx(m_i[i] - m_use);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * i + e];
            x = exp2_approx(x - m_use);
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_i[i] = l_i[i] * alpha + rs;
        m_i[i] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 2 * i] *= alpha;
          acc[4 * j + 2 * i + 1] *= alpha;
        }
      }

      // O += P V over the tile's 64 columns in k16 steps: the accumulator
      // of S for columns 16 kk.. is, in bf16 pairs, the A fragment (all
      // operands ready before the fence, none written while the products
      // run)
      const uint32_t v_s = smem_addr(smem + L::kV + st * L::kTile);
      uint32_t pa[4][4];
      uint64_t dv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        dv[kk] = sw128_desc(v_s + kk * 2048, kPanel, 1024);
      }
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (D == 256) {
          // two m64n128k16: columns 0..127 (panels 0, 1), 128..255 (2, 3)
          wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(acc), pa[kk],
                           dv[kk]);
          wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(acc + 64), pa[kk],
                           sw128_desc(v_s + 2 * kPanel + kk * 2048, kPanel,
                                      1024));
        } else if constexpr (D == 128) {
          wgmma_rs_m64n128(acc, pa[kk], dv[kk]);
        } else {
          wgmma_rs_m64n64(acc, pa[kk], dv[kk]);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with it
    if (++st == kStages) {
      st = 0;
      phase ^= 1;
    }
  }

  T* op = o + ((int64_t)b * H + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= q_end) continue;
    const float inv = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
    // a row with nothing live gets lse 0, finite
    if (lse != nullptr && lane % 4 == 0)
      lse[((int64_t)b * H + h) * Sq + row] =
          l_i[i] == 0.f ? 0.f : m_i[i] + log2f(l_i[i]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + (int64_t)row * D + 8 * j +
                                         col_l) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                acc[4 * j + 2 * i + 1] * inv);
  }
}

template <int D, typename Tiles>
cudaError_t launch_flash_wgmma(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int Hkv,
                               int Sq, int Skv, float scale_log2, int causal,
                               int blocks, Tiles tiles, cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr int smem = WgSmem<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<T, D, Tiles>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  // the maps are kernel parameters (__grid_constant__), encoded per call:
  // a captured CUDA graph keeps them with the launch
  CUtensorMap tq, tk, tv;
  cudaError_t e = rows_map(&tq, q, D, Sq, B * H);
  // no keys: no tile is visited, the maps only have to be valid
  if (e == cudaSuccess)
    e = Skv > 0 ? rows_map(&tk, k, D, Skv, B * Hkv)
                : rows_map(&tk, q, D, Sq, 1);
  if (e == cudaSuccess)
    e = Skv > 0 ? rows_map(&tv, v, D, Skv, B * Hkv)
                : rows_map(&tv, q, D, Sq, 1);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, H, B);
  flash_fwd_wgmma_kernel<T, D, Tiles><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), lse, H, Hkv, Sq, scale_log2, causal,
      tiles);
  return cudaGetLastError();
}

// the f32 instances of one schedule (the 3xTF32 body, 64-row blocks)
template <typename Tiles>
int launch_f32_any(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Sq, int Skv, int D,
                   float scale_log2, int causal, int blocks, Tiles tiles,
                   cudaStream_t st) {
#define CUBECL_FLASH(HD)                                                     \
  launch_flash_tf32x3<HD, Tiles>(q, k, v, o, lse, B, H, Hkv, Sq, Skv,        \
                                 scale_log2, causal, blocks, tiles, st)
  if (D == 64) return CUBECL_FLASH(64);
  if (D == 128) return CUBECL_FLASH(128);
  if (D == 256) return CUBECL_FLASH(256);
#undef CUBECL_FLASH
  return cudaErrorInvalidValue;
}

// the bf16 instances of one schedule (the wgmma body, NC 64-row tiles to a
// block; `tiles` counts the launch's tiles so)
template <typename Tiles>
int launch_bf16_any(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int Hkv, int Sq, int Skv, int D,
                    float scale_log2, int causal, int blocks, Tiles tiles,
                    cudaStream_t st) {
#define CUBECL_FLASH(HD)                                                     \
  launch_flash_wgmma<HD, Tiles>(q, k, v, o, lse, B, H, Hkv, Sq, Skv,         \
                                    scale_log2, causal, blocks, tiles, st)
  if (D == 64) return CUBECL_FLASH(64);
  if (D == 128) return CUBECL_FLASH(128);
  if (D == 256) return CUBECL_FLASH(256);
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
// kernel was not built for (D 64, 128 and 256).
extern "C" int cubecl_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, float* lse, int dtype, int B, int H,
                                int Hkv, int Sq, int Skv, int D,
                                float scale_log2, int causal, void* stream) {
  using namespace cubecl;
  const DenseQTiles tiles{Sq, Skv, causal};
  const int n = (Sq + BM - 1) / BM;  // 64-row kernel tiles
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)  // NC to a block
    return launch_bf16_any(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D,
                           scale_log2, causal, (n + NC - 1) / NC, tiles, st);
  if (dtype == kF32)
    return launch_f32_any(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, scale_log2,
                          causal, n, tiles, st);
  return cudaErrorInvalidValue;
}

// A1 with its options (and A8's window): the inputs of cubecl_flash_fwd;
// keys at or past kv_len absent; the band row - left <= col <= row + right
// (no band: left = right = Sq + Skv); segment ids seg_q (B, Sq) and seg_kv
// (B, Skv) int32 with ranges (the per-64-row least and greatest ids, as
// make_mask reads them), or all three null. Returns as cubecl_flash_fwd.
extern "C" int cubecl_flash_masked_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const int* seg_q, const int* seg_kv,
                                       const int* ranges, int dtype, int B,
                                       int H, int Hkv, int Sq, int Skv, int D,
                                       float scale_log2, int causal,
                                       int kv_len, int left, int right,
                                       void* stream) {
  using namespace cubecl;
  const MaskedQTiles tiles{make_mask(B, Sq, Skv, causal, kv_len, left, right,
                                     seg_q, seg_kv, ranges)};
  const int n = (Sq + BM - 1) / BM;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_bf16_any(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D,
                           scale_log2, causal, (n + NC - 1) / NC, tiles, st);
  if (dtype == kF32)
    return launch_f32_any(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, scale_log2,
                          causal, n, tiles, st);
  return cudaErrorInvalidValue;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    // NC kernel tiles of one user tile to a block, never two user tiles
    // (their kv walks differ): where NC does not divide q_sub, the last
    // block's later tiles have no rows
    const int slots = (q_sub + NC - 1) / NC * NC;
    const SparseQTiles tiles{ids, counts, stride, bq, bk, slots, k_sub,
                             causal, /*keep_f9=*/1, 0};
    return launch_bf16_any(q, k, v, o, lse, B, H, H, Sq, Skv, D, scale_log2,
                           causal, (Sq / bq) * slots / NC, tiles, st);
  }
  const SparseQTiles tiles{ids, counts, stride, bq, bk, q_sub, k_sub,
                           causal, /*keep_f9=*/1, 0};
  const int blocks = (Sq / bq) * q_sub;
  if (dtype == kF32)
    return launch_f32_any(q, k, v, o, lse, B, H, H, Sq, Skv, D, scale_log2,
                          causal, blocks, tiles, st);
  return cudaErrorInvalidValue;
}
