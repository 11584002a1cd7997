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
// every cached K/V byte for a few rows and is bound by bytes, like P1;
// chunked prefill (C = 256, G = 2: 512 rows) is a causal flash forward whose
// K/V come through the table and is bound by operations. Two bodies, by
// q's dtype:
//
// bf16 q (bf16 or int8 pools): the tensor cores
// (paged_chunked_wgmma_kernel). A block is one warpgroup that owns a
// 64-row tile of the G*C rows of one (batch row, kv head) and walks
// 64-position tiles of its range, as A1's consumers do
// (flash_attention.cu): S = Q K^T by wgmma m64n64k16 with Q and K in
// shared memory, the online softmax (base 2, f32 statistics) on the
// accumulator fragment, P packed in registers as the A operand of O += P
// V (wgmma m64nDk16, V the MN-major B with the transpose bit). P is
// rounded as the path that the chunk continues rounds it: one bf16 P,
// A1's, in a prefill-shaped chunk; two bf16 halves (hi and the rounding's
// remainder, two products a k16 step, about 17 bits) in a decode-shaped
// one, whose steps before it ran P1 with f32 P, and on int8 pools; there
// each tile's P V is summed from zero and added to O in f32 (rounded to
// nearest, as P1 sums), so that the tensor cores' round-toward-zero sums
// do not run across the tiles of the range.
// - Staging: cp.async through the table, a ring of 3 stages. A K or V row
//   of a position is D contiguous elements of the (L, Hkv, P, page, D)
//   pool, found by one table lookup; each thread copies 16-byte chunks of
//   its rows to where the 128-byte swizzle puts them (the layout TMA would
//   write and the wgmma descriptors read), positions past the block's
//   range as zeros (the copy's source size 0). cp.async rather than TMA:
//   the unit the table maps is a row, so every page size that the wrapper
//   takes (1, 7, 16, 128, ...) is the same code, with no box that a page
//   must hold whole and no tensor map to encode per call; the bytes in
//   flight come from the ring and from the split below. The copies of
//   the stage two tiles ahead are issued before each tile's products; a
//   thread fences the async proxy after its copies land, and a barrier
//   precedes the wgmma that reads them.
// - int8 pools arrive as int8 (64 x D bytes a stage) and are converted to
//   bf16 into one swizzled K/V tile before the products (exact: |v| <=
//   127); each position's K and V scales ride the same table lookup (4-byte
//   copies) and go on the score column (after the base-2 scaling) and on
//   the probability column of P V, l taking the unscaled p, as P3 does.
// - Decode-shaped tiles (G*C <= 64 rows: the verify step's 10, the ragged
//   batch's 32) are bound by bytes, and B*Hkv blocks leave most SMs idle,
//   so the positions are split: when one row tile a (b, kv head) makes
//   fewer than 264 blocks (132 SMs twice), the table's span (max_pages *
//   page) is cut into splits of equal 64-position multiples, enough for
//   264 blocks; each block writes its partial (acc, m, l) in f32 and a
//   second, small launch (paged_combine.cuh's paged_combine_kernel, which
//   P1 shares) rescales and adds the splits of each row. wgmma m64 with the idle rows, not mma.sync
//   m16n8k16: the work is bound by bytes, so the idle rows cost tensor-core
//   time that is not the bound, and the prefill tiles' body is the same.
// - Prefill-shaped tiles (more than 64 rows) are bound by operations: one
//   block a 64-row tile and the whole range, no split; the tiles of late
//   chunk tokens (the most positions) go first.
// - The range of a row tile ends at its last live position,
//   min(lengths[b], starts[b] + max i of its rows + 1); the mask (t <
//   lengths[b], t <= the row's position) runs on the tiles that cross the
//   first row's position or the length. Rows past G*C (the m64 tile's
//   padding) read zeros and are not stored.
// Shared memory (D 128): Q 16 KB + 3 stages x (K + V) 32 KB = 112 KB bf16,
// two blocks an SM; int8: Q + 3 x 16 KB + the converted 32 KB + scales.
// - D 96 (Phi-3-mini's head dim): the pools stay (..., 96) and no padded
//   column is read. Its bf16 tiles take D 128's two 128-byte panels, the
//   second half used (columns 64..95, its last 32 never written): Q K^T
//   takes six k16 steps, which read none of them; P V is D 128's
//   m64n128k16 (an MN-major V under the 128-byte swizzle is 64 columns an
//   atom), whose columns 96..127 are never stored. 112 KB bf16, as D 128.
// - D 80 (Phi-2's head dim) takes the same route: D 128's two panels,
//   columns 80..127 never written, Q K^T five k16 steps, P V D 128's
//   m64n128k16 with 48 dead columns, never stored. D 32 (Pythia-31M's)
//   takes D 64's one panel: two k16 steps, P V m64n64k16 with 32 dead
//   columns. Both tiles are byte-bound where decode-shaped (the dead
//   columns move no byte) and the prefill-shaped tiles' P V does 1.6x
//   (D 80) or 2x (D 32) the useful work; narrower panels (m64n80k16, a
//   64-byte swizzle at D 32) are the alternative, not built (PR 21's
//   narrow-panel D 96 measured no faster). int8 rows are 80 and 32 bytes
//   (5 and 2 chunks), whole chunks, as the cp.async copies want.
//
// - D 256 (GPT-J-6B's and Qwen3-Next's head dim): four 128-byte panels a
//   tile, 230,400 bytes with bf16 pools (one block an SM), 199,168 with
//   int8; Q K^T 16 k16 steps, their descriptors made beside each product;
//   O is 128 f32 registers a thread, so P V is two m64n128k16 a k16 step
//   and, with the halves, P's two halves go to shared memory (where the
//   tile's K was) as the A operands of m64n64k16 products from shared
//   memory, the tile's sums from zero one 64-column panel of V at a time
//   into a 32-register accumulator added to O (with both halves and a
//   second accumulator in registers, ptxas spilled).
//
// Each D of PAGED_HEAD_DIMS is a template instance of its own (D 32, 64,
// 80, 96, 128, 256): the body static_asserts its D and the P V product
// names each accumulator width (wgmma_pv), so no D can fall into another's
// layout. Every other D from 1 to 255 (MPT-30B's 112, ...) runs in the
// ragged instances of the next width of 64, 128 and 256 (RAGGED, the real
// D an argument): the pools stay at the real D and are never padded or
// copied; the copies take a row's own bytes, in cp.async pieces of 16, 8
// or 4 bytes as the rows' alignment allows (plain loads for rows of an odd
// number of bf16 or int8 elements), into the width's layout, whose columns
// past D stay the zeros the block wrote first; o and the splits' partials
// are written at the real D (paged_combine.cuh's paged_combine_ragged_
// kernel). Q K^T and P V run over the width's columns.
//
// f32 q (f32 or int8 pools): the tensor cores as three TF32 products
// (paged_chunked_tf32x3_kernel, on flash_tf32.cuh; one TF32 product would
// not hold f32's tolerance). One warpgroup owns 64 of the G*C rows and
// the positions of its split, as the bf16 body (tc_plan: decode-shaped
// tiles split their positions, combined by paged_combine_kernel<float>),
// and walks them in steps of 32: the step's K and V rows come through the
// table into a ring of raw slots (three where shared memory leaves two
// blocks an SM or, at D 256 f32, fits one) by the TMA unit's bulk copies,
// a row each, issued by one warp (16-byte cp.async copies by every thread
// ran the verify step at 0.6 TB/s; PERF.md §6), each split from
// shared memory once it has landed into one split tile (K K-major for S,
// V transposed for P V, P the f32 accumulator split in registers). int8
// values are exact in tf32: their small halves are zero, so S and P V take
// two products a k8 step. The tiles are D in 32-column panels: D 80 runs
// at 96 (three panels, the last 16 columns zeros, never stored), D 32 at
// 32. Shared memory (TfSmem): 31,232 bytes (D 32) to 100,352 (D 128, two
// slots) with f32 pools, two blocks an SM; 231,936 at D 256 (q 64 KB, the
// split step 64 KB, three slots of 32.5 KB), one; int8 pools 18,304 to
// 108,160 (D 256, one slot), two blocks an SM.
#include <algorithm>
#include <climits>
#include <type_traits>

#include "flash_tf32.cuh"
#include "hopper.cuh"
#include "paged_combine.cuh"

namespace cubecl {
namespace {

// -- bf16 q: the tensor cores ----------------------------------------------

constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcStages = 3;     // K/V stages of the cp.async ring
constexpr int kTcRows = 64;      // query rows (of the G*C) a block: m64
constexpr int kTcCols = 64;      // positions a stage
constexpr int kTcFill = 264;     // blocks that fill the H100's 132 SMs twice
constexpr int kTcPanel = 64 * 128;  // 64 rows x 64 bf16, 128-byte swizzle

// dynamic shared memory: the Q tile, the ring (each stage K then V: bf16
// tiles of (D + 63) / 64 panels, or int8 rows of D bytes), for int8 the
// bf16 K/V tile they are converted into and each stage's K and V scales,
// and the slack that aligns the base to 1024
template <int D, bool QUANT>
struct TcSmem {
  // 64 rows of D bf16 in 64-column panels (D 96: two, the last 32 columns
  // unused; D 80: two, the last 48; D 32: one, the last 32)
  static constexpr int kTile = (D + 63) / 64 * kTcPanel;
  static constexpr int kRaw = QUANT ? kTcCols * D : kTile;  // K (or V)
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kTile;
  static constexpr int kConv = kRing + kTcStages * 2 * kRaw;
  static constexpr int kScale = kConv + (QUANT ? 2 * kTile : 0);
  static constexpr int kBytes =
      kScale + (QUANT ? kTcStages * 2 * kTcCols * 4 : 0) + 1024;
};

// The split of the positions; ops/paged_attention.py's p3_plan repeats
// this arithmetic. A block owns row tile blockIdx.x / splits (the last
// first) and the positions [split * split_len, (split + 1) * split_len)
// of it (split = blockIdx.x % splits), cut at the tile's last live one.
struct TcPlan {
  int row_tiles;  // 64-row tiles of the G*C rows
  int splits;     // position splits of a row tile (1: none)
  int split_len;  // positions a split: a multiple of kTcCols
};

inline TcPlan tc_plan(int B, int Hkv, int GC, int page, int max_pages) {
  TcPlan p;
  p.row_tiles = (GC + kTcRows - 1) / kTcRows;
  // the positions a table row addresses, in 64-position tiles
  const int kv_tiles =
      std::max(1, (int)(((int64_t)page * max_pages + kTcCols - 1) / kTcCols));
  p.splits = 1;
  p.split_len = kv_tiles * kTcCols;
  const int base = p.row_tiles * B * Hkv;
  if (p.row_tiles == 1 && base < kTcFill) {
    // at least `want` splits of `per` tiles (fewer only where the span
    // has fewer tiles)
    const int want = (kTcFill + base - 1) / base;
    const int per = std::max(1, kv_tiles / want);
    p.splits = (kv_tiles + per - 1) / per;
    p.split_len = per * kTcCols;
  }
  return p;
}

// O (+)= P V for 16 positions: m64nNk16 over the accumulator's N columns
// (D 80's and 96's is N 128, D 32's N 64), one instance a built N
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) {
    wgmma_rs_m64n128(d, a, db);
  } else {
    static_assert(N == 64, "P3's P V is built for N 64 and 128");
    wgmma_rs_m64n64(d, a, db);
  }
}

// the bf16 body. part (splits > 1): per (b, kv head, split, row < G*C) the
// row's unnormalised f32 accumulator (D), then its m and l. RAGGED (a head
// dim dr without an instance of its own, run in this instance's width D,
// 64, 128 or 256): q, the pools, o and part hold rows of dr elements; in
// shared memory each row keeps D's panels and swizzle, its columns from dr
// on the zeros that the block writes once at its start (the copies write
// a row's own bytes only), so K's columns there are zeros, never a stale
// NaN that q's zero columns would turn into NaN scores
template <int D, bool QUANT, bool RAGGED = false>
__device__ __forceinline__ void paged_chunked_wgmma_body(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpool_,
    const void* __restrict__ vpool_, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    __nv_bfloat16* __restrict__ o, float* __restrict__ part, int H, int Hkv,
    int C, int layer, int P, int page, int max_pages, float scale_log2,
    TcPlan plan, int dr = D) {
  using TK = typename std::conditional<QUANT, int8_t, __nv_bfloat16>::type;
  using L = TcSmem<D, QUANT>;
  constexpr int kChunks = D * (int)sizeof(TK) / 16;  // 16-byte chunks a row
  constexpr int kEl = 16 / (int)sizeof(TK);          // elements a chunk
  const int DR = RAGGED ? dr : D;  // the head dim of q, the pools, o, part
  // RAGGED: the bytes of a K/V row and of a q row, their chunks, and the
  // widest copy each row's alignment allows (the bases are 16-byte aligned)
  const int rb = DR * (int)sizeof(TK), rbq = 2 * DR;
  const int kc = RAGGED ? (rb + 15) / 16 : kChunks;
  const int qc = RAGGED ? (rbq + 15) / 16 : D / 8;
  const int unit = copy_unit(rb, (int)sizeof(TK)), unit_q = copy_unit(rbq, 2);
  // the accumulator's columns: D 80 and 96 compute D 128's, D 32 D 64's,
  // the columns past D unstored
  constexpr int DP = (D + 63) / 64 * 64;
  static_assert(D == 32 || D == 64 || D == 80 || D == 96 || D == 128 ||
                    D == 256,
                "P3's wgmma body is built for D 32, 64, 80, 96, 128 and 256");
  // D 256: Q's and K's descriptors made beside each product, and P V's
  // tile sums 64 columns at a time, so that O's 128 registers fit
  constexpr bool kWide = D == 256;
  const TK* kpool = static_cast<const TK*>(kpool_);
  const TK* vpool = static_cast<const TK*>(vpool_);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_addr(smem);
  if constexpr (RAGGED) {
    // every tile's columns from dr on: zeros, before any copy lands
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < (L::kBytes - 1024) / 16; i += kTcThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = H / Hkv;
  const int GC = G * C;
  const int split = blockIdx.x % plan.splits;
  const int r0 = (plan.row_tiles - 1 - blockIdx.x / plan.splits) * kTcRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int start = starts[b];
  const int64_t head_page0 = ((int64_t)layer * Hkv + hk) * P;
  const int* tab = table + (int64_t)b * max_pages;
  // row r = g * C + i is query head hk * G + g, token i: (B, H, C, D)
  const int64_t qrow0 = ((int64_t)b * H + (int64_t)hk * G) * C;

  // the tile's first and last chunk tokens: the positions every live row
  // sees, and the tile's last live position
  const int r_end = min(r0 + kTcRows, GC);
  int i_min = 0, i_max = C - 1;
  if (r_end - r0 < C) {
    i_min = C - 1;
    i_max = 0;
    for (int r = r0; r < r_end; ++r) {
      i_min = min(i_min, r % C);
      i_max = max(i_max, r % C);
    }
  }
  const int kv_end = min(len, start + i_max + 1);
  const int full_end = min(len, start + i_min + 1);
  const int p0 = split * plan.split_len;
  const int p1 = min(kv_end, p0 + plan.split_len);
  const int n_tiles = p1 > p0 ? (p1 - p0 + kTcCols - 1) / kTcCols : 0;
  // P into P V as two bf16 halves (about 17 bits) or one (8): P3 rounds P
  // as the path it continues does. A decode-shaped chunk (the verify step)
  // continues the decode steps, whose P1 keeps P in f32: one bf16 P put the
  // 0.77B llama's verify logits 0.117 from the decode steps', outside
  // phase k's bound. A prefill-shaped chunk continues the prefill, whose
  // A1 (and the JAX kernel on bf16 pools) rounds P to bf16: two halves
  // put chunked prefill's logits 0.105 from the one-shot prefill's, one
  // rounds as A1 (0 apart). int8 pools: two halves always, as the JAX
  // kernel's f32 P there. The block's choice is uniform (plan.row_tiles).
  const bool halves = QUANT || plan.row_tiles == 1;

  // stage st <- K and V of positions [p0 + 64 t, + 64), zeros from p1 on;
  // thread tid copies chunk tid % kChunks of every (128 / kChunks)-th row
  auto load_kv = [&](int t, int st) {
    const int k0 = p0 + t * kTcCols;
    const uint32_t ks0 = s_base + L::kRing + st * 2 * L::kRaw;
#pragma unroll 4
    for (int i = tid; i < kTcCols * kc; i += kTcThreads) {
      const int n = i / kc, c = i % kc;
      const int pos = k0 + n;
      const bool ok = pos < p1;
      int64_t row = 0;
      if (ok) {
        const int pid = min(max(tab[pos / page], 0), P - 1);
        row = (head_page0 + pid) * page + pos % page;
      }
      const uint32_t dst = QUANT ? ks0 + n * D + c * 16
                                 : ks0 + (c / 8) * kTcPanel + n * 128 +
                                       (((c % 8) ^ (n % 8)) << 4);
      if constexpr (RAGGED) {
        // the row's own bytes: whole 16-byte chunks, or pieces of `unit`
        const uint8_t* ksrc =
            reinterpret_cast<const uint8_t*>(kpool + row * dr) + c * 16;
        const uint8_t* vsrc =
            reinterpret_cast<const uint8_t*>(vpool + row * dr) + c * 16;
        if (unit == 16) {
          cp_async16_zfill(dst, ksrc, ok);
          cp_async16_zfill(dst + L::kRaw, vsrc, ok);
        } else {
          const int nb = min(16, rb - c * 16);
          copy_chunk(dst, ksrc, nb, unit, ok);
          copy_chunk(dst + L::kRaw, vsrc, nb, unit, ok);
        }
      } else {
        cp_async16_zfill(dst, kpool + row * D + c * kEl, ok);
        cp_async16_zfill(dst + L::kRaw, vpool + row * D + c * kEl, ok);
      }
      if (QUANT && c == 0) {
        const uint32_t sc = s_base + L::kScale + (st * 2 * kTcCols + n) * 4;
        cp_async4_zfill(sc, kscale + row, ok);
        cp_async4_zfill(sc + kTcCols * 4, vscale + row, ok);
      }
    }
  };

  // Q (rows past G*C as zeros) with stage 0, then stage 1: a group each
  for (int i = tid; i < kTcRows * qc; i += kTcThreads) {
    const int m = i / qc, c = i % qc;
    const bool ok = r0 + m < GC;
    const uint32_t dst = s_base + L::kQ + (c / 8) * kTcPanel + m * 128 +
                         (((c % 8) ^ (m % 8)) << 4);
    const uint8_t* qsrc = reinterpret_cast<const uint8_t*>(
        q + (ok ? (qrow0 + r0 + m) * DR : 0)) + c * 16;
    if (RAGGED && unit_q != 16)
      copy_chunk(dst, qsrc, min(16, rbq - c * 16), unit_q, ok);
    else if (RAGGED)
      cp_async16_zfill(dst, qsrc, ok);
    else
      cp_async16_zfill(dst, q + (ok ? (qrow0 + r0 + m) * D + c * 8 : 0), ok);
  }
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    cp_async_commit();
  }

  // this thread's rows of the m64nN accumulator: row_a and row_a + 8; its
  // columns 8 j + col_l + {0, 1}; a row's position (rows past G*C: none
  // masked, their sums are not stored)
  const int row_a = r0 + warp * 16 + lane / 4;
  const int col_l = (lane % 4) * 2;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_a + 8 * i;
    qpos[i] = r < GC ? start + r % C : INT_MAX;
  }

  float acc[DP / 2];  // O, (64 x DP) f32
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
  const uint32_t q_s = s_base + L::kQ;
  // Q's descriptors, k16 steps, 4 to a 128-byte panel (D 256: none kept)
  uint64_t dq[kWide ? 1 : D / 16];
  if constexpr (!kWide) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      dq[kk] =
          sw128_desc(q_s + (kk / 4) * kTcPanel + (kk % 4) * 32, 16, 1024);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kTcStages;
    cp_async_wait<kTcStages - 2>();  // this thread's copies of tile t
    fence_proxy_async();             // ... visible to wgmma
    __syncthreads();                 // everyone's; tile t - 1 is done
    if (t + kTcStages - 1 < n_tiles)
      load_kv(t + kTcStages - 1, (t + kTcStages - 1) % kTcStages);
    cp_async_commit();
    uint32_t k_s = s_base + L::kRing + st * 2 * L::kRaw;
    uint32_t v_s = k_s + L::kRaw;
    const float* ksc =
        reinterpret_cast<const float*>(smem + L::kScale) + st * 2 * kTcCols;
    if constexpr (QUANT) {
      // int8 -> bf16 (exact) into the swizzled K/V tile: 16 values a chunk
      const uint8_t* raw = smem + L::kRing + st * 2 * L::kRaw;
      uint8_t* conv = smem + L::kConv;
#pragma unroll 4
      for (int i = tid; i < 2 * kTcCols * (D / 16); i += kTcThreads) {
        const int kv = i / (kTcCols * (D / 16));
        const int n = i / (D / 16) % kTcCols, c = i % (D / 16);
        const uint4 x = *reinterpret_cast<const uint4*>(raw + kv * L::kRaw +
                                                        n * D + c * 16);
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
        uint32_t h[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float f[4];
          unpack_s8x4(w[j], f);
          h[2 * j] = pack_bf16(f[0], f[1]);
          h[2 * j + 1] = pack_bf16(f[2], f[3]);
        }
        // bf16 chunks 2c and 2c + 1 of row n (one panel: 2c % 8 <= 6)
        uint8_t* row = conv + kv * L::kTile + (c / 4) * kTcPanel + n * 128;
        const int c0 = (2 * c) % 8;
        *reinterpret_cast<uint4*>(row + ((c0 ^ (n % 8)) << 4)) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (n % 8)) << 4)) =
            make_uint4(h[4], h[5], h[6], h[7]);
      }
      fence_proxy_async();
      __syncthreads();
      k_s = s_base + L::kConv;
      v_s = k_s + L::kTile;
    }

    // S = Q K^T over D in k16 steps (the first overwrites s)
    float s[32];
    if constexpr (kWide) {
      // Q's base through an empty asm, so that the compiler makes each
      // step's descriptors beside its product and keeps none across the
      // loop (16 of Q's would take 32 registers beside O's 128)
      uint32_t qb = q_s;
      asm volatile("" : "+r"(qb));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kTcPanel + (kk % 4) * 32;
        wgmma_ss_m64n64(s, sw128_desc(qb + off, 16, 1024),
                        sw128_desc(k_s + off, 16, 1024), kk > 0);
      }
    } else {
      uint64_t dk[D / 16];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        dk[kk] =
            sw128_desc(k_s + (kk / 4) * kTcPanel + (kk % 4) * 32, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(s, dq[kk], dk[kk], kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);

    // online softmax, base 2; a row's 64 columns live in 4 lanes
    const int k0 = p0 + t * kTcCols;
    const bool edge = k0 + kTcCols > full_end;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x *= scale_log2;
          // int8: the K scale on the score column, after the base-2 scaling
          if constexpr (QUANT) x *= ksc[8 * j + col_l + e];
          if (edge) {
            const int col = k0 + 8 * j + col_l + e;
            if (!(col < len && col <= qpos[i])) x = -INFINITY;
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
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j + 2 * i] *= alpha;
        acc[4 * j + 2 * i + 1] *= alpha;
      }
    }

    // O += P V over the tile's 64 columns in k16 steps: the accumulator of
    // S for columns 16 kk.., in bf16 pairs, is the A fragment; int8: the V
    // scale on the probability column (l took the unscaled p). With
    // `halves`, P goes in as p = hi + lo (lo = bf16(p - hi), the rounding's
    // remainder, exact in f32), two products a k16 step: P V to about
    // 2^-17 of p. V is exact in bf16 (bf16 pools, or int8 values).
    uint32_t pa[4][4], pl[4][4];
    uint64_t dv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float lo = s[8 * kk + 2 * r], hi = s[8 * kk + 2 * r + 1];
        if constexpr (QUANT) {
          // s[8 kk + 2 r + e] is column 16 kk + 8 (r / 2) + col_l + e
          const int col = 16 * kk + 8 * (r / 2) + col_l;
          lo *= ksc[kTcCols + col];
          hi *= ksc[kTcCols + col + 1];
        }
        pa[kk][r] = pack_bf16(lo, hi);
        if (halves) {
          const float2 back = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&pa[kk][r]));
          pl[kk][r] = pack_bf16(lo - back.x, hi - back.y);
        }
      }
      dv[kk] = sw128_desc(v_s + kk * 2048, kTcPanel, 1024);
    }
    reg_fence(acc);
    if constexpr (kWide) {
      // V's 64-column panel p, k16 step kk (MN-major, the transpose bit)
      auto dvp = [&](int p, int kk) {
        return sw128_desc(v_s + p * kTcPanel + kk * 2048, kTcPanel, 1024);
      };
      if (halves) {
        // P's two bf16 halves into the place of the tile's K (read by Q
        // K^T and free until the ring refills the stage after the next
        // barrier), hi in panel 0 and lo in panel 1, each 64 rows x 64
        // positions under the 128-byte swizzle that Q's descriptors read:
        // the A operands of shared-memory wgmma, so that no register holds
        // them beside O's 128. Then the tile's P V from zero in a
        // 64-column accumulator, panel by panel of V, each added to O in
        // f32 (a second 128-register accumulator would not fit either)
        uint8_t* ph = smem + (k_s - s_base);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // s[4 j + 2 i + e] is row warp * 16 + lane / 4 + 8 i, column
            // 8 j + col_l + e
            float lo = s[4 * j + 2 * i], hi = s[4 * j + 2 * i + 1];
            if constexpr (QUANT) {
              lo *= ksc[kTcCols + 8 * j + col_l];
              hi *= ksc[kTcCols + 8 * j + col_l + 1];
            }
            const uint32_t h = pack_bf16(lo, hi);
            const float2 back = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&h));
            const int row = warp * 16 + lane / 4 + 8 * i;
            const int off = row * 128 + ((j ^ (row % 8)) << 4) + col_l * 2;
            *reinterpret_cast<uint32_t*>(ph + off) = h;
            *reinterpret_cast<uint32_t*>(ph + kTcPanel + off) =
                pack_bf16(lo - back.x, hi - back.y);
          }
        }
        fence_proxy_async();
        __syncthreads();
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float ot[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss_m64n64_tb(ot, sw128_desc(k_s + kk * 32, 16, 1024),
                               dvp(p, kk), kk > 0);
            wgmma_ss_m64n64_tb(
                ot, sw128_desc(k_s + kTcPanel + kk * 32, 16, 1024),
                dvp(p, kk), 1);
          }
          wgmma_commit();
          wgmma_wait0();
          reg_fence(ot);
#pragma unroll
          for (int j = 0; j < 32; ++j) acc[32 * p + j] += ot[j];
        }
      } else {
        // two m64n128k16 a k16 step: columns 0..127, then 128..255
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(acc), pa[kk],
                           dvp(0, kk));
          wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(acc + 64),
                           pa[kk], dvp(2, kk));
        }
        wgmma_commit();
        wgmma_wait0();
        reg_fence(acc);
      }
    } else if (halves) {
      // a decode-shaped chunk continues the decode steps, whose P1 sums in
      // f32 rounded to nearest: the tile's P V is summed from zero in its
      // own accumulator and added to O in f32, so that the tensor cores'
      // round-toward-zero sums do not run across the tiles of the range
      float ot[DP / 2];
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) ot[j] = 0.f;
      reg_fence(ot);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<DP>(ot, pa[kk], dv[kk]);
        wgmma_pv<DP>(ot, pl[kk], dv[kk]);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(ot);
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] += ot[j];
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_pv<DP>(acc, pa[kk], dv[kk]);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= GC) continue;
    if (plan.splits == 1) {
      const float inv = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
      __nv_bfloat16* orow = o + (qrow0 + row) * DR;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if constexpr (RAGGED) {  // columns below dr, one at a time
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + col_l + e < dr)
              orow[8 * j + col_l + e] =
                  __float2bfloat16(acc[4 * j + 2 * i + e] * inv);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col_l) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                    acc[4 * j + 2 * i + 1] * inv);
        }
      }
    } else {
      float* pr = part + (((int64_t)(b * Hkv + hk) * plan.splits + split) *
                              GC + row) * (DR + 2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if constexpr (RAGGED) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + col_l + e < dr)
              pr[8 * j + col_l + e] = acc[4 * j + 2 * i + e];
        } else {
          *reinterpret_cast<float2*>(pr + 8 * j + col_l) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
      if (lane % 4 == 0) {
        pr[DR] = m_i[i];
        pr[DR + 1] = l_i[i];
      }
    }
  }
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(kTcThreads)
paged_chunked_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const void* __restrict__ kpool_,
                           const void* __restrict__ vpool_,
                           const float* __restrict__ kscale,
                           const float* __restrict__ vscale,
                           const int* __restrict__ table,
                           const int* __restrict__ lengths,
                           const int* __restrict__ starts,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ part, int H, int Hkv, int C,
                           int layer, int P, int page, int max_pages,
                           float scale_log2, TcPlan plan) {
  paged_chunked_wgmma_body<D, QUANT>(q, kpool_, vpool_, kscale, vscale,
                                     table, lengths, starts, o, part, H, Hkv,
                                     C, layer, P, page, max_pages, scale_log2,
                                     plan);
}

// the bf16 body at a head dim dr (1..DP) with no instance of its own
template <int DP, bool QUANT>
__global__ void __launch_bounds__(kTcThreads)
paged_chunked_wgmma_ragged_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kpool_,
    const void* __restrict__ vpool_, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    __nv_bfloat16* __restrict__ o, float* __restrict__ part, int H, int Hkv,
    int C, int layer, int P, int page, int max_pages, float scale_log2,
    TcPlan plan, int dr) {
  paged_chunked_wgmma_body<DP, QUANT, true>(
      q, kpool_, vpool_, kscale, vscale, table, lengths, starts, o, part, H,
      Hkv, C, layer, P, page, max_pages, scale_log2, plan, dr);
}

// RAGGED: the instance of width D runs head dim dr
template <int D, bool QUANT, bool RAGGED = false>
cudaError_t launch_chunked_wgmma(const void* q, const void* kp, const void* vp,
                                 const float* ks, const float* vsc,
                                 const void* table, const void* lengths,
                                 const void* starts, void* o, void* part,
                                 int B, int H, int Hkv, int C, int layer,
                                 int P, int page, int max_pages,
                                 float scale_log2, cudaStream_t stream,
                                 int dr = D) {
  constexpr int smem = TcSmem<D, QUANT>::kBytes;
  const void* kernel;
  if constexpr (RAGGED)
    kernel = (const void*)paged_chunked_wgmma_ragged_kernel<D, QUANT>;
  else
    kernel = (const void*)paged_chunked_wgmma_kernel<D, QUANT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int GC = (H / Hkv) * C;
  const TcPlan p = tc_plan(B, Hkv, GC, page, max_pages);
  if (p.splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(p.row_tiles * p.splits, Hkv, B);
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const int* tab = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  const int* sts = static_cast<const int*>(starts);
  auto* ot = static_cast<__nv_bfloat16*>(o);
  auto* pt = static_cast<float*>(part);
  if constexpr (RAGGED)
    paged_chunked_wgmma_ragged_kernel<D, QUANT>
        <<<grid, kTcThreads, smem, stream>>>(qt, kp, vp, ks, vsc, tab, len,
                                             sts, ot, pt, H, Hkv, C, layer, P,
                                             page, max_pages, scale_log2, p,
                                             dr);
  else
    paged_chunked_wgmma_kernel<D, QUANT><<<grid, kTcThreads, smem, stream>>>(
        qt, kp, vp, ks, vsc, tab, len, sts, ot, pt, H, Hkv, C, layer, P, page,
        max_pages, scale_log2, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  if constexpr (RAGGED)
    paged_combine_ragged_kernel<__nv_bfloat16, D>
        <<<dim3(B * Hkv, GC), D / 4, 0, stream>>>(pt, ot, H, Hkv, C,
                                                  p.splits, dr);
  else
    paged_combine_kernel<__nv_bfloat16, D>
        <<<dim3(B * Hkv, GC), D / 4, 0, stream>>>(pt, ot, H, Hkv, C,
                                                  p.splits);
  return cudaGetLastError();
}


// -- f32 q: the tensor cores as three TF32 products ------------------------

// the f32 body's tile width: D in 32-column panels (D 80: 96, its last 16
// columns zeros, never stored)
constexpr int tf_width(int D) { return (D + 31) / 32 * 32; }

// dynamic shared memory of the f32 body: the q tile as it is (W / 32
// panels of 64 rows), one split step X (32 positions of K, K-major over
// W, or of V transposed: a big and, with f32 pools, a small tile), the raw
// slots of the K/V ring (rows of W pool values 16 bytes apart past their
// width; int8: each slot's 32 scales after its rows) and the slack to
// align the base to 1024 (flash_tf32.cuh's raw_slots: two blocks an SM
// where three, two or one slot allow it)
template <int D, bool QUANT>
struct TfSmem {
  using TK = typename std::conditional<QUANT, int8_t, float>::type;
  static constexpr int W = tf_width(D);
  static constexpr int kQ = 0;
  static constexpr int kXb = kQ + kTcRows * W * 4;
  static constexpr int kXs = kXb + kStep * W * 4;
  static constexpr int kRaw = kXs + (QUANT ? 0 : kStep * W * 4);
  static constexpr int kLd = raw_ld<TK>(W);
  static constexpr int kSlot = kStep * kLd + (QUANT ? kStep * 4 : 0);
  static constexpr int kSlots = raw_slots(kRaw + 1024, kSlot);
  static constexpr int kBytes = kRaw + kSlots * kSlot + 1024;
  static_assert(kSlots >= 1 && kBytes <= 232448, "fits one block");
};

// The f32 body. A block is one warpgroup owning 64 of the G*C rows of one
// (batch row, kv head), and the positions of its split (tc_plan, as the
// bf16 body), walked in steps of 32 positions. A step's K, then its V,
// come through the ring and the table (bulk copies a row, positions past
// the range as zeros), each issued three operands (or as many as the
// slots) ahead of the one in use, and each is split from shared memory into X
// once it has landed: K K-major for S = Q K^T (m64n32k8, Q split in
// registers from the tile as it is), V transposed for O += P V with P the
// f32 m64n32 accumulator split in registers (P1's f32 P). Each group of
// 32 terms is summed from zero and added in f32. int8 pools: their values
// are exact in tf32, so X holds one tile and S and P V take two products
// a k8 step (tf32x3's BX); the K scale goes on the score column, the V
// scale on the probability column (l takes the unscaled p). part (splits
// > 1): per (b, kv head, split, row < G*C) the row's unnormalised f32
// accumulator (DR values), then its m and l. RAGGED (a head dim dr with no
// instance of its own, in this instance's width D): q, the pools, o and
// part hold rows of dr values; the copies take a row's own bytes (pieces
// of 16, 8 or 4), into slots whose columns from dr on are the zeros the
// block writes once (as at D 80, whose slots' last 16 columns stay zero)
template <int D, bool QUANT, bool RAGGED = false>
__device__ __forceinline__ void paged_chunked_tf32x3_body(
    const float* __restrict__ q, const void* __restrict__ kpool_,
    const void* __restrict__ vpool_, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    float* __restrict__ o, float* __restrict__ part, int H, int Hkv, int C,
    int layer, int P, int page, int max_pages, float scale_log2, TcPlan plan,
    int dr = D) {
  using L = TfSmem<D, QUANT>;
  using TK = typename L::TK;
  constexpr int W = L::W;
  constexpr int NR = L::kSlots;
  // O in column blocks of AN: 64 where W is a multiple of 64 below 256,
  // else 32 (W 32, 96; at 256 blocks of 64 spilled in the flash forward)
  constexpr int AN = W % 64 == 0 && W < 256 ? 64 : 32;
  static_assert(D == 32 || D == 64 || D == 80 || D == 96 || D == 128 ||
                    D == 256,
                "P3's f32 body is built for D 32, 64, 80, 96, 128 and 256");
  const int DR = RAGGED ? dr : D;  // the head dim of q, the pools, o, part
  // a pool row's bytes, its 16-byte chunks, and the widest copy its
  // alignment allows (the bases are 16-byte aligned)
  const int rb = DR * (int)sizeof(TK);
  const int kc = (rb + 15) / 16;
  const int unit = copy_unit(rb, (int)sizeof(TK));
  const TK* kpool = static_cast<const TK*>(kpool_);
  const TK* vpool = static_cast<const TK*>(vpool_);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_addr(smem);
  if constexpr (RAGGED || D != W) {
    // the slots' columns from DR on: zeros, before any copy lands
    uint4* z = reinterpret_cast<uint4*>(smem + L::kRaw);
    for (int i = threadIdx.x; i < NR * L::kSlot / 16; i += kTcThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = H / Hkv;
  const int GC = G * C;
  const int split = blockIdx.x % plan.splits;
  const int r0 = (plan.row_tiles - 1 - blockIdx.x / plan.splits) * kTcRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int start = starts[b];
  const int64_t head_page0 = ((int64_t)layer * Hkv + hk) * P;
  const int* tab = table + (int64_t)b * max_pages;
  // row r = g * C + i is query head hk * G + g, token i: (B, H, C, D)
  const int64_t qrow0 = ((int64_t)b * H + (int64_t)hk * G) * C;

  // the tile's first and last chunk tokens: the positions every live row
  // sees, and the tile's last live position
  const int r_end = min(r0 + kTcRows, GC);
  int i_min = 0, i_max = C - 1;
  if (r_end - r0 < C) {
    i_min = C - 1;
    i_max = 0;
    for (int r = r0; r < r_end; ++r) {
      i_min = min(i_min, r % C);
      i_max = max(i_max, r % C);
    }
  }
  const int kv_end = min(len, start + i_max + 1);
  const int full_end = min(len, start + i_min + 1);
  const int p0 = split * plan.split_len;
  const int p1 = min(kv_end, p0 + plan.split_len);
  const int n_steps = p1 > p0 ? (p1 - p0 + kStep - 1) / kStep : 0;

  // the slots' barriers: operand u completes slot u % NR's (u / NR)-th
  // phase
  __shared__ uint64_t ring_bar[NR];
  if (tid == 0) {
    for (int sl = 0; sl < NR; ++sl) mbar_init(&ring_bar[sl], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // operand u (step u / 2's K, or its V) into slot `slot` through the
  // table, zeros from p1 on, completing on the slot's barrier: warp 0 a
  // bulk copy a row (lane j row j; int8: the rows' scales by 4-byte
  // cp.async, one group a call); a ragged row whose bytes are no multiple
  // of 16 in every thread's cp.async pieces (copy_chunk), the barrier then
  // arrived on with no bytes. Nothing past the walk.
  auto issue = [&](int u, int slot) {
    if (u < 2 * n_steps) {
      const int k0 = p0 + (u / 2) * kStep;
      const TK* pool = u % 2 ? vpool : kpool;
      const float* sc = u % 2 ? vscale : kscale;
      const uint32_t dst0 = s_base + L::kRaw + slot * L::kSlot;
      if (!RAGGED || rb % 16 == 0) {
        if (warp == 0) {
          const int pos = k0 + lane;
          const bool ok = pos < p1;
          int64_t row = 0;
          if (ok) {
            const int pid = min(max(tab[pos / page], 0), P - 1);
            row = (head_page0 + pid) * page + pos % page;
          }
          fill_rows(dst0, L::kLd, ok ? pool + row * DR : nullptr, rb,
                    &ring_bar[slot]);
          if (QUANT)
            cp_async4_zfill(dst0 + kStep * L::kLd + lane * 4, sc + row, ok);
        }
      } else {
#pragma unroll 1
        for (int i = tid; i < kStep * kc; i += kTcThreads) {
          const int n = i / kc, c = i % kc;
          const int pos = k0 + n;
          const bool ok = pos < p1;
          int64_t row = 0;
          if (ok) {
            const int pid = min(max(tab[pos / page], 0), P - 1);
            row = (head_page0 + pid) * page + pos % page;
          }
          copy_chunk(dst0 + n * L::kLd + c * 16,
                     reinterpret_cast<const uint8_t*>(pool + row * DR) +
                         c * 16,
                     min(16, rb - c * 16), unit, ok);
          if (QUANT && c == 0)
            cp_async4_zfill(dst0 + kStep * L::kLd + n * 4, sc + row, ok);
        }
        if (tid == 0) mbar_expect_tx(&ring_bar[slot], 0);
      }
    }
    cp_async_commit();
  };
  // the first NR operands in flight, then the q tile (rows past G*C and
  // columns past DR as zeros)
#pragma unroll
  for (int sl = 0; sl < NR; ++sl) issue(sl, sl);
  load_rows<kTcRows, W, kTcThreads>(q + qrow0 * DR, DR, r0, GC, DR,
                                    smem + L::kQ);

  // this thread's rows of the m64nN accumulators: row_a and row_a + 8; its
  // columns 8 j + col_l + {0, 1}; a row's position (rows past G*C: none
  // masked, their sums are not stored)
  const int row_a = r0 + warp * 16 + lane / 4;
  const int col_l = (lane % 4) * 2;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_a + 8 * i;
    qpos[i] = r < GC ? start + r % C : INT_MAX;
  }
  const uint32_t q_s = s_base + L::kQ;
  const uint32_t xb_s = s_base + L::kXb;
  const uint32_t xs_s = s_base + L::kXs;

  float acc[W / AN][AN / 2];  // O, (64 x W) f32
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < W / AN; ++c)
#pragma unroll
    for (int j = 0; j < AN / 2; ++j) acc[c][j] = 0.f;

  // operand u, landed, split into X after the last products read X, then
  // visible to wgmma; its slot refilled with operand u + NR. sc: the
  // operand's scales at this thread's 8 columns (int8)
  auto take = [&](int u, bool cols, float (&sc)[8]) {
    cp_async_wait<NR - 1>();  // this thread's cp.async copies of operand u
    mbar_wait(&ring_bar[u % NR], (u / NR) & 1);  // its bulk copies
    __syncthreads();  // everyone's; the last products are done
    const uint8_t* raw = smem + L::kRaw + (u % NR) * L::kSlot;
    if (cols)
      split_cols<W, TK, kTcThreads>(raw, smem + L::kXb, smem + L::kXs);
    else
      split_rows<W, TK, kTcThreads>(raw, smem + L::kXb, smem + L::kXs);
    if constexpr (QUANT) {
      const float* s = reinterpret_cast<const float*>(raw + kStep * L::kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sc[2 * j + e] = s[8 * j + col_l + e];
    }
    fence_proxy_async();  // the split's stores, then wgmma's reads
    __syncthreads();
    issue(u + NR, u % NR);
  };

  for (int st = 0; st < n_steps; ++st) {
    const int k0 = p0 + st * kStep;
    float sc[8];
    // S = Q K^T over W
    take(2 * st, false, sc);
    float s[16];
    scores<W, QUANT>(s, q_s, xb_s, xs_s);

    // online softmax, base 2; a row's 32 columns live in 4 lanes
    const bool edge = k0 + kStep > full_end;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x *= scale_log2;
          // int8: the K scale on the score column, after the base-2 scaling
          if constexpr (QUANT) x *= sc[2 * j + e];
          if (edge) {
            const int col = k0 + 8 * j + col_l + e;
            if (!(col < len && col <= qpos[i])) x = -INFINITY;
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
      for (int c = 0; c < W / AN; ++c)
#pragma unroll
        for (int j = 0; j < AN / 8; ++j) {
          acc[c][4 * j + 2 * i] *= alpha;
          acc[c][4 * j + 2 * i + 1] *= alpha;
        }
    }

    // O += P V over the step's 32 positions, V transposed; int8: the V
    // scale on the probability column (l took the unscaled p)
    take(2 * st + 1, true, sc);
    if constexpr (QUANT) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) s[4 * j + 2 * i + e] *= sc[2 * j + e];
    }
    accumulate<W, AN, QUANT>(acc, s, xb_s, xs_s);
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= GC) continue;
    float* dst;
    float mul = 1.f;
    if (plan.splits == 1) {
      mul = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
      dst = o + (qrow0 + row) * DR;
    } else {
      dst = part + (((int64_t)(b * Hkv + hk) * plan.splits + split) * GC +
                    row) * (DR + 2);
      if (lane % 4 == 0) {
        dst[DR] = m_i[i];
        dst[DR + 1] = l_i[i];
      }
    }
#pragma unroll
    for (int c = 0; c < W / AN; ++c)
#pragma unroll
      for (int j = 0; j < AN / 8; ++j) {
        const int col = AN * c + 8 * j + col_l;
        const float x0 = acc[c][4 * j + 2 * i] * mul;
        const float x1 = acc[c][4 * j + 2 * i + 1] * mul;
        if constexpr (RAGGED) {  // columns below dr, one at a time
          if (col < dr) dst[col] = x0;
          if (col + 1 < dr) dst[col + 1] = x1;
        } else if (col < D) {  // D even: both columns or neither
          *reinterpret_cast<float2*>(dst + col) = make_float2(x0, x1);
        }
      }
  }
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(kTcThreads)
paged_chunked_tf32x3_kernel(const float* __restrict__ q,
                            const void* __restrict__ kpool_,
                            const void* __restrict__ vpool_,
                            const float* __restrict__ kscale,
                            const float* __restrict__ vscale,
                            const int* __restrict__ table,
                            const int* __restrict__ lengths,
                            const int* __restrict__ starts,
                            float* __restrict__ o, float* __restrict__ part,
                            int H, int Hkv, int C, int layer, int P, int page,
                            int max_pages, float scale_log2, TcPlan plan) {
  paged_chunked_tf32x3_body<D, QUANT>(q, kpool_, vpool_, kscale, vscale,
                                      table, lengths, starts, o, part, H, Hkv,
                                      C, layer, P, page, max_pages,
                                      scale_log2, plan);
}

// the f32 body at a head dim dr (1..DP) with no instance of its own
template <int DP, bool QUANT>
__global__ void __launch_bounds__(kTcThreads)
paged_chunked_tf32x3_ragged_kernel(
    const float* __restrict__ q, const void* __restrict__ kpool_,
    const void* __restrict__ vpool_, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    float* __restrict__ o, float* __restrict__ part, int H, int Hkv, int C,
    int layer, int P, int page, int max_pages, float scale_log2, TcPlan plan,
    int dr) {
  paged_chunked_tf32x3_body<DP, QUANT, true>(
      q, kpool_, vpool_, kscale, vscale, table, lengths, starts, o, part, H,
      Hkv, C, layer, P, page, max_pages, scale_log2, plan, dr);
}

// RAGGED: the instance of width D runs head dim dr
template <int D, bool QUANT, bool RAGGED = false>
cudaError_t launch_chunked_tf32x3(const void* q, const void* kp,
                                  const void* vp, const float* ks,
                                  const float* vsc, const void* table,
                                  const void* lengths, const void* starts,
                                  void* o, void* part, int B, int H, int Hkv,
                                  int C, int layer, int P, int page,
                                  int max_pages, float scale_log2,
                                  cudaStream_t stream, int dr = D) {
  constexpr int smem = TfSmem<D, QUANT>::kBytes;
  const void* kernel;
  if constexpr (RAGGED)
    kernel = (const void*)paged_chunked_tf32x3_ragged_kernel<D, QUANT>;
  else
    kernel = (const void*)paged_chunked_tf32x3_kernel<D, QUANT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int GC = (H / Hkv) * C;
  const TcPlan p = tc_plan(B, Hkv, GC, page, max_pages);
  if (p.splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(p.row_tiles * p.splits, Hkv, B);
  const auto* qt = static_cast<const float*>(q);
  const int* tab = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  const int* sts = static_cast<const int*>(starts);
  auto* ot = static_cast<float*>(o);
  auto* pt = static_cast<float*>(part);
  if constexpr (RAGGED)
    paged_chunked_tf32x3_ragged_kernel<D, QUANT>
        <<<grid, kTcThreads, smem, stream>>>(qt, kp, vp, ks, vsc, tab, len,
                                             sts, ot, pt, H, Hkv, C, layer, P,
                                             page, max_pages, scale_log2, p,
                                             dr);
  else
    paged_chunked_tf32x3_kernel<D, QUANT><<<grid, kTcThreads, smem, stream>>>(
        qt, kp, vp, ks, vsc, tab, len, sts, ot, pt, H, Hkv, C, layer, P, page,
        max_pages, scale_log2, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  if constexpr (RAGGED)
    paged_combine_ragged_kernel<float, D>
        <<<dim3(B * Hkv, GC), D / 4, 0, stream>>>(pt, ot, H, Hkv, C,
                                                  p.splits, dr);
  else
    paged_combine_kernel<float, D>
        <<<dim3(B * Hkv, GC), D / 4, 0, stream>>>(pt, ot, H, Hkv, C,
                                                  p.splits);
  return cudaGetLastError();
}

// dynamic shared memory of the body for (dtype, int8 pools, D): each
// built D a case of its own; -1 for a D that has no instance
template <int D>
int p3_smem_of(int dtype, bool quant) {
  if (dtype == kF32)
    return quant ? TfSmem<D, true>::kBytes : TfSmem<D, false>::kBytes;
  return quant ? TcSmem<D, true>::kBytes : TcSmem<D, false>::kBytes;
}
inline int p3_smem(int dtype, bool quant, int D) {
  switch (D) {
    case 32:
      return p3_smem_of<32>(dtype, quant);
    case 64:
      return p3_smem_of<64>(dtype, quant);
    case 80:
      return p3_smem_of<80>(dtype, quant);
    case 96:
      return p3_smem_of<96>(dtype, quant);
    case 128:
      return p3_smem_of<128>(dtype, quant);
    case 256:
      return p3_smem_of<256>(dtype, quant);
    default:  // a D up to 256 without an instance: its ragged width's
      return D >= 1 && D < 256 ? p3_smem(dtype, quant, paged_ragged_width(D))
                               : -1;
  }
}

}  // namespace
}  // namespace cubecl

// q (B, H, C, D); k_pages/v_pages (L, Hkv, P, page, D); table (B, max_pages)
// int32; lengths and starts (B,) int32; o (B, H, C, D). Contiguous; q and o
// of `dtype` (f32 or bf16), the pools of `kv_dtype`: the same dtype, or int8
// with f32 scale pools k_scales/v_scales (L, Hkv, P, page) (null
// otherwise). part: the partial sums where a body splits the positions,
// cubecl_paged_chunked_plan's plan[8] floats (null where that is 0). D 32, 64, 80, 96, 128 and 256 are instances of their own; any
// other D from 1 to 255 runs in the next of the widths 64, 128 and 256
// (RAGGED). Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a dtype or head_dim this kernel was not built
// for.
extern "C" int cubecl_paged_chunked(const void* q, const void* k_pages,
                                    const void* v_pages, const float* k_scales,
                                    const float* v_scales, const void* table,
                                    const void* lengths, const void* starts,
                                    void* o, void* part, int dtype,
                                    int kv_dtype, int B, int H, int Hkv, int C,
                                    int D, int layer, int P, int page,
                                    int max_pages, float scale_log2,
                                    void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv != 0 || C <= 0) return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kI8;
  if (quant != (k_scales != nullptr && v_scales != nullptr))
    return cudaErrorInvalidValue;
  if (!quant && kv_dtype != dtype) return cudaErrorInvalidValue;
#define CUBECL_CHUNKED_TF(HD, QUANT)                                          \
  launch_chunked_tf32x3<HD, QUANT>(q, k_pages, v_pages, k_scales, v_scales,   \
                                   table, lengths, starts, o, part, B, H,     \
                                   Hkv, C, layer, P, page, max_pages,         \
                                   scale_log2, st)
#define CUBECL_CHUNKED_WG(HD, QUANT)                                          \
  launch_chunked_wgmma<HD, QUANT>(q, k_pages, v_pages, k_scales, v_scales,   \
                                  table, lengths, starts, o, part, B, H, Hkv, \
                                  C, layer, P, page, max_pages, scale_log2,  \
                                  st)
  if (dtype == kF32) {
    if (D == 32)
      return quant ? CUBECL_CHUNKED_TF(32, true)
                   : CUBECL_CHUNKED_TF(32, false);
    if (D == 64)
      return quant ? CUBECL_CHUNKED_TF(64, true)
                   : CUBECL_CHUNKED_TF(64, false);
    if (D == 80)
      return quant ? CUBECL_CHUNKED_TF(80, true)
                   : CUBECL_CHUNKED_TF(80, false);
    if (D == 96)
      return quant ? CUBECL_CHUNKED_TF(96, true)
                   : CUBECL_CHUNKED_TF(96, false);
    if (D == 128)
      return quant ? CUBECL_CHUNKED_TF(128, true)
                   : CUBECL_CHUNKED_TF(128, false);
    if (D == 256)
      return quant ? CUBECL_CHUNKED_TF(256, true)
                   : CUBECL_CHUNKED_TF(256, false);
  }
  if (dtype == kBF16) {
    if (D == 32)
      return quant ? CUBECL_CHUNKED_WG(32, true)
                   : CUBECL_CHUNKED_WG(32, false);
    if (D == 64)
      return quant ? CUBECL_CHUNKED_WG(64, true)
                   : CUBECL_CHUNKED_WG(64, false);
    if (D == 80)
      return quant ? CUBECL_CHUNKED_WG(80, true)
                   : CUBECL_CHUNKED_WG(80, false);
    if (D == 96)
      return quant ? CUBECL_CHUNKED_WG(96, true)
                   : CUBECL_CHUNKED_WG(96, false);
    if (D == 128)
      return quant ? CUBECL_CHUNKED_WG(128, true)
                   : CUBECL_CHUNKED_WG(128, false);
    if (D == 256)
      return quant ? CUBECL_CHUNKED_WG(256, true)
                   : CUBECL_CHUNKED_WG(256, false);
  }
#undef CUBECL_CHUNKED_WG
#undef CUBECL_CHUNKED_TF
  if (D < 1 || D >= 256) return cudaErrorInvalidValue;
  const int DP = paged_ragged_width(D);
#define CUBECL_RAGGED_F32(W, QUANT)                                          \
  launch_chunked_tf32x3<W, QUANT, true>(q, k_pages, v_pages, k_scales,       \
                                        v_scales, table, lengths, starts, o, \
                                        part, B, H, Hkv, C, layer, P, page,  \
                                        max_pages, scale_log2, st, D)
#define CUBECL_RAGGED_WG(W, QUANT)                                           \
  launch_chunked_wgmma<W, QUANT, true>(q, k_pages, v_pages, k_scales,        \
                                       v_scales, table, lengths, starts, o,  \
                                       part, B, H, Hkv, C, layer, P, page,   \
                                       max_pages, scale_log2, st, D)
#define CUBECL_RAGGED(W)                                                     \
  (dtype == kF32 ? (quant ? CUBECL_RAGGED_F32(W, true)                      \
                          : CUBECL_RAGGED_F32(W, false))                     \
                 : (quant ? CUBECL_RAGGED_WG(W, true)                       \
                          : CUBECL_RAGGED_WG(W, false)))
  if (dtype == kF32 || dtype == kBF16)
    return DP == 64    ? CUBECL_RAGGED(64)
           : DP == 128 ? CUBECL_RAGGED(128)
                       : CUBECL_RAGGED(256);
#undef CUBECL_RAGGED
#undef CUBECL_RAGGED_WG
#undef CUBECL_RAGGED_F32
  return cudaErrorInvalidValue;
}

// P3's launch plan for q of `dtype`, pools of `kv_dtype` and the shapes:
// plan[0..8] = the body (1: bf16 wgmma, 2: f32 3xTF32 wgmma; both one
// warpgroup a block on tc_plan's grid), threads a block,
// dynamic shared memory bytes, the grid (x, y, z), position splits, the
// positions a split, and the floats of `part` (0 without a split).
// Returns 0, or cudaErrorInvalidValue for what cubecl_paged_chunked
// refuses.
extern "C" int cubecl_paged_chunked_plan(int dtype, int kv_dtype, int B,
                                         int H, int Hkv, int C, int D,
                                         int page, int max_pages, int* plan) {
  using namespace cubecl;
  if (Hkv <= 0 || H % Hkv != 0 || C <= 0 ||
      (dtype != kF32 && dtype != kBF16) ||
      (kv_dtype != kI8 && kv_dtype != dtype))
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kI8;
  const int smem = p3_smem(dtype, quant, D);
  if (smem < 0) return cudaErrorInvalidValue;
  const int GC = (H / Hkv) * C;
  const TcPlan p = tc_plan(B, Hkv, GC, page, max_pages);
  plan[0] = dtype == kF32 ? 2 : 1;
  plan[1] = kTcThreads;
  plan[2] = smem;
  plan[3] = p.row_tiles * p.splits;
  plan[4] = Hkv;
  plan[5] = B;
  plan[6] = p.splits;
  plan[7] = p.split_len;
  plan[8] = p.splits > 1 ? B * Hkv * p.splits * GC * (D + 2) : 0;
  return 0;
}
