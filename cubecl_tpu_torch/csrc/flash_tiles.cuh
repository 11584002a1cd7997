// The tile schedules of the flash kernels: which rows a block owns and which
// 64-row tiles of the other side it visits. flash_attention.cu (A1, A5) and
// flash_attention_bwd.cu (A3, A4, A6, A7) instantiate each kernel body once
// with the dense schedule and once with the block-sparse one, so the tile
// bodies (staging, the two score products, the online softmax, the
// gradient products) are written once.
//
// A schedule is a small struct passed by value to the kernel (kSparse and
// kMasked choose the bodies' masking at compile time, so each schedule's
// instances hold only their own code):
//   own(r0, r_end)          the block's 64 rows start at r0; rows at or past
//                           r_end are neither read nor written
//   own(i, n, r0, r_end)    the same for the i-th of the launch's n kernel
//                           tiles, where a block owns several (the bf16
//                           bodies: one per consumer warpgroup, all of
//                           them walking the same tiles of the other side)
//   count(r0)               how many tiles the block visits
//   visit(t, r0, r_end, ..) the t-th tile's first row c0 and its end c_end
//                           (rows at or past it are masked as absent);
//                           false when the tile can be skipped whole
//   kSparse                 causally masked scores take the finite mask
//                           value (block-sparse) or -inf (dense)
//
// Dense (A1, A3, A4): the causal range of the whole sequence, 64 x 64
// tiles, masked with -inf, as before the block-sparse kernels existed.
//
// Block-sparse (A5, A6, A7): the schedule of build_block_schedule in
// ops/attention.py, per user tile of the block mask its active tiles of the
// other side (ids, padded by repeating the last; counts). The user's tiles
// (bq, bk) are any divisors of S (_fit_block), so a user tile is swept as
// ceil(b / 64) kernel tiles: a block owns 64 rows of ONE user tile (rows
// past the user tile's end belong to the next one and are masked out), and
// a visited user tile is ceil(b / 64) kernel tiles whose columns past the
// user tile's end are absent (-inf). Causally masked scores take the JAX
// kernels' finite DEFAULT_MASK_VALUE, not -inf, so that a row whose every
// visited column is masked (possible only for bq != bk) comes out as the
// JAX forward gives it: the mean of V over the visited columns (ROADMAP
// Queue 3, F9). A kernel tile wholly above the diagonal is skipped unless it
// holds such a row.
//
// Masked (A1, A3, A4 with their options, and A8's window): FlashMask below,
// the options of _fwd_call, _bwd_dkv_call and _bwd_dq_call in
// cubecl_tpu/ops/attention.py: keys at or past kv_len, a band
// row - left <= col <= row + right (the sliding window) and segment ids
// (packed sequences: a pair is live where the two ids are equal), beside
// the causal mask. The walk covers only the tiles the band can reach; a
// tile is skipped whole when it is past kv_len, off the band (JAX's test at
// attention.py:207-215) or when its rows' and its columns' id ranges do not
// overlap (_seg_overlap, :61: disjoint ranges share no id, contiguous or
// not); a tile whose every pair is live takes no element mask, the others
// (across a band edge, a segment boundary, the diagonal or kv_len) test
// each element (FlashMask::kill, one pass before the bodies' loops, which
// then mask nothing). Masked scores are -inf, as the dense schedule's: a
// row with no live key among them gets zeros and an lse of 0 (F16, ROADMAP
// Queue 3; the JAX kernels give it the mean of V over whichever columns
// passed their 128/1024-row tile tests). The per-64-row min and max of the ids
// come from the wrapper (ops/attention.py::_tile_ranges, one small torch
// op a call); the ids themselves are read by the element test, from
// global memory through the read-only cache, on tiles that need it only.
#pragma once

#include "common.cuh"

namespace cubecl {
namespace {

constexpr int kFlashTile = 64;  // rows of every q and kv tile
// DEFAULT_MASK_VALUE of cubecl_tpu/ops/attention.py, -0.7 * f32 max,
// rounded to f32 (bits 0xff333332)
constexpr float kMaskValue = -2.381976325e+38f;

// -- the options of the masked schedules ----------------------------------

struct FlashMask {
  int Sq, Skv;
  int kv_end;          // min(Skv, kv_len): columns at or past it are absent
  int causal;
  int left, right;     // the band; at most Sq + Skv (no band: both so)
  const int* seg_q;    // (B, Sq) segment ids, or null (no segments)
  const int* seg_kv;   // (B, Skv)
  // (B, ceil(S / 64)) each: the least and greatest id of every 64-row tile
  const int* q_lo;
  const int* q_hi;
  const int* k_lo;
  const int* k_hi;
  // (B, ceil(S / 128), 2) each: for every 128 rows of one side, the first
  // and one past the last 64-row tile of the other side whose id range
  // overlaps theirs (an empty range where none does)
  const int* q_walk;  // q rows -> kv tiles
  const int* k_walk;  // kv rows -> q tiles

  // the tile slots of batch row blockIdx.z (every flash grid is (., ., B))
  __device__ __forceinline__ int q_slot(int q0) const {
    return blockIdx.z * ((Sq + kFlashTile - 1) / kFlashTile) + q0 / kFlashTile;
  }
  __device__ __forceinline__ int k_slot(int c0) const {
    return blockIdx.z * ((Skv + kFlashTile - 1) / kFlashTile) +
           c0 / kFlashTile;
  }
  // [lo, hi) of the tiles that the 128 rows from base (a multiple of 128)
  // can reach through their segment ids: all of them without ids
  __device__ __forceinline__ void seg_walk(bool kv_rows, int base, int& lo,
                                           int& hi) const {
    if (seg_q == nullptr) {
      lo = 0;
      hi = 1 << 30;
      return;
    }
    const int n = ((kv_rows ? Skv : Sq) + 2 * kFlashTile - 1) /
                  (2 * kFlashTile);
    const int* w = (kv_rows ? k_walk : q_walk) +
                   2 * (blockIdx.z * n + base / (2 * kFlashTile));
    lo = __ldg(w);
    hi = __ldg(w + 1);
  }
  // can the q tile at row q0 and the kv tile at column c0 hold a live pair?
  __device__ __forceinline__ bool tile_live(int q0, int c0) const {
    if (q0 >= Sq || c0 >= kv_end) return false;
    if (causal && c0 > q0 + kFlashTile - 1) return false;
    if (c0 + kFlashTile - 1 + left < q0 || c0 > q0 + kFlashTile - 1 + right)
      return false;
    if (seg_q == nullptr) return true;
    const int qs = q_slot(q0), ks = k_slot(c0);
    return __ldg(q_lo + qs) <= __ldg(k_hi + ks) &&
           __ldg(q_hi + qs) >= __ldg(k_lo + ks);
  }
  // is every pair of the tile live, so that no element needs the mask?
  __device__ __forceinline__ bool whole(int q0, int c0) const {
    if (q0 + kFlashTile > Sq || c0 + kFlashTile > kv_end) return false;
    if (causal && c0 + kFlashTile - 1 > q0) return false;
    if (q0 + kFlashTile - 1 - c0 > left || c0 + kFlashTile - 1 - q0 > right)
      return false;
    if (seg_q == nullptr) return true;
    const int qs = q_slot(q0), ks = k_slot(c0);
    const int id = __ldg(q_lo + qs);
    return __ldg(q_hi + qs) == id && __ldg(k_lo + ks) == id &&
           __ldg(k_hi + ks) == id;
  }
  // the element test: is (row, col) a live pair?
  __device__ __forceinline__ bool live(int row, int col) const {
    if (row >= Sq || col >= kv_end) return false;
    if (causal && col > row) return false;
    if (row - col > left || col - row > right) return false;
    return seg_q == nullptr ||
           __ldg(seg_q + (int64_t)blockIdx.z * Sq + row) ==
               __ldg(seg_kv + (int64_t)blockIdx.z * Skv + col);
  }
  // The dead pairs of a tile that is not wholly live, set to -inf in its
  // scores before the softmax (forward) or the probabilities (backward), so
  // that the bodies' own loops mask nothing: one pass on such tiles only
  // (tested inside the softmax loop, the element test cost every tile its
  // time, the branch made into selects). x[i][j] at (r + i, c + j): a
  // thread's 4x4 block of the CUDA-core bodies; kT: rows are keys and
  // columns queries (dK/dV's transposed scores).
  template <bool kT>
  __device__ __forceinline__ void kill(float (&x)[4][4], int r, int c) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (!(kT ? live(c + j, r + i) : live(r + i, c + j)))
          x[i][j] = -INFINITY;
  }
  // the same for an m64nW wgmma accumulator of N = W / 2 registers (the
  // bf16 bodies' m64n64, the 3xTF32 bodies' m64n32): x[4 j + 2 i + e] at
  // (r + 8 i, c + 8 j + e)
  template <bool kT, int N>
  __device__ __forceinline__ void kill(float (&x)[N], int r, int c) const {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = r + 8 * i, b = c + 8 * j + e;
          if (!(kT ? live(b, a) : live(a, b))) x[4 * j + 2 * i + e] = -INFINITY;
        }
  }
};

// The mask of one call: ranges holds q_lo, q_hi (B x ceil(Sq / 64) each),
// k_lo, k_hi (B x ceil(Skv / 64) each), then q_walk (B x ceil(Sq / 128) x
// 2) and k_walk (B x ceil(Skv / 128) x 2); null with null segment ids.
inline FlashMask make_mask(int B, int Sq, int Skv, int causal, int kv_len,
                           int left, int right, const int* seg_q,
                           const int* seg_kv, const int* ranges) {
  const int nq = B * ((Sq + kFlashTile - 1) / kFlashTile);
  const int nk = B * ((Skv + kFlashTile - 1) / kFlashTile);
  const int span = Sq + Skv;  // a band this wide is no band
  auto clamp = [](int x, int hi) { return x < 0 ? 0 : (x > hi ? hi : x); };
  FlashMask m{Sq, Skv, clamp(kv_len, Skv), causal, clamp(left, span),
              clamp(right, span), seg_q, seg_kv, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr};
  if (seg_q != nullptr) {
    m.q_lo = ranges;
    m.q_hi = ranges + nq;
    m.k_lo = ranges + 2 * nq;
    m.k_hi = ranges + 2 * nq + nk;
    m.q_walk = ranges + 2 * nq + 2 * nk;
    m.k_walk = m.q_walk + 2 * B * ((Sq + 2 * kFlashTile - 1) /
                                   (2 * kFlashTile));
  }
  return m;
}

// -- blocks owning q rows (forward, dQ) ----------------------------------

struct DenseQTiles {
  static constexpr bool kSparse = false;
  static constexpr bool kMasked = false;
  int Sq, Skv, causal;
  __device__ __forceinline__ void own(int& r0, int& r_end) {
    own(blockIdx.x, gridDim.x, r0, r_end);
  }
  // the i-th of the launch's n kernel tiles (a block may own several)
  __device__ __forceinline__ void own(int i, int n, int& r0, int& r_end) {
    // the causal tiles near the bottom do the most work: schedule them first
    r0 = (n - 1 - i) * kFlashTile;
    r_end = Sq;
  }
  __device__ __forceinline__ int count(int r0) const {
    // causal: columns <= the tile's last row; everything past is not visited
    const int kv_end = causal ? min(Skv, r0 + kFlashTile) : Skv;
    return (kv_end + kFlashTile - 1) / kFlashTile;
  }
  __device__ __forceinline__ bool visit(int t, int r0, int r_end, int& c0,
                                        int& c_end) const {
    c0 = t * kFlashTile;
    c_end = Skv;
    return true;
  }
};

struct SparseQTiles {
  static constexpr bool kSparse = true;
  static constexpr bool kMasked = false;
  const int* ids;     // (n_q, stride): the active kv tiles of each q tile
  const int* counts;  // (n_q,)
  int stride, bq, bk;
  // kernel tiles per user q tile (ceil(bq / 64), or more where a block owns
  // several: a tile at or past the user tile's end has no rows), per user
  // kv tile
  int q_sub, k_sub;
  int causal;
  int keep_f9;        // the forward: never skip a tile a fully masked row sees
  int ti;             // the block's user q tile, set by own()
  __device__ __forceinline__ void own(int& r0, int& r_end) {
    own(blockIdx.x, gridDim.x, r0, r_end);
  }
  // the i-th kernel tile of the launch (a block may own several of one
  // user tile)
  __device__ __forceinline__ void own(int i, int n, int& r0, int& r_end) {
    ti = i / q_sub;
    r0 = ti * bq + (i % q_sub) * kFlashTile;
    r_end = (ti + 1) * bq;
  }
  __device__ __forceinline__ int count(int r0) const {
    return counts[ti] * k_sub;
  }
  __device__ __forceinline__ bool visit(int t, int r0, int r_end, int& c0,
                                        int& c_end) const {
    const int ki = ids[ti * stride + t / k_sub];
    c0 = ki * bk + (t % k_sub) * kFlashTile;
    c_end = (ki + 1) * bk;
    if (!causal || c0 <= min(r0 + kFlashTile, r_end) - 1) return true;
    // wholly above the diagonal: its scores are all masked. A row whose
    // first visited column lies past it (F9) still sees them; others get 0
    return keep_f9 && ids[ti * stride] * bk > r0;
  }
};

// The options (FlashMask) over the dense grid: a block's rows as
// DenseQTiles's; it walks the kv tiles that the band and the segment ids of
// its 128-row pair can reach (a bf16 block's two consumers, tiles 2i and
// 2i + 1, walk the same tiles in the same order; a CUDA-core block walks at
// most a tile more on a side, each skipped), and computes on those that
// tile_live admits.
struct MaskedQTiles {
  static constexpr bool kSparse = false;
  static constexpr bool kMasked = true;
  FlashMask mask;
  int walk0, walk_end;  // the block's walk: kv tiles [walk0, walk_end)
  __device__ __forceinline__ void own(int& r0, int& r_end) {
    own(blockIdx.x, gridDim.x, r0, r_end);
  }
  // also sets the walk of the 128 rows from r0 - r0 % 128 (both tiles of a
  // bf16 block share it)
  __device__ __forceinline__ void own(int i, int n, int& r0, int& r_end) {
    r0 = (n - 1 - i) * kFlashTile;
    r_end = mask.Sq;
    const int base = r0 - r0 % (2 * kFlashTile);
    int end = min(mask.kv_end, base + 2 * kFlashTile + mask.right);
    if (mask.causal) end = min(end, base + 2 * kFlashTile);
    int lo, hi;
    mask.seg_walk(false, base, lo, hi);
    walk0 = max(max(0, base - mask.left) / kFlashTile, lo);
    walk_end = min((end + kFlashTile - 1) / kFlashTile, hi);
  }
  __device__ __forceinline__ int count(int r0) const {
    return max(0, walk_end - walk0);
  }
  __device__ __forceinline__ bool visit(int t, int r0, int r_end, int& c0,
                                        int& c_end) const {
    c0 = (walk0 + t) * kFlashTile;
    c_end = mask.kv_end;
    return mask.tile_live(r0, c0);
  }
};

// -- blocks owning kv rows (dK, dV) --------------------------------------

struct DenseKVTiles {
  static constexpr bool kSparse = false;
  static constexpr bool kMasked = false;
  int Sq, Skv, causal;
  // kv rows a block owns (64, or 128 where it owns two kernel tiles): the
  // block's consumers walk the same q tiles, from the block's first row
  int block_rows;
  __device__ __forceinline__ void own(int& k0, int& k_end) {
    own(blockIdx.x, gridDim.x, k0, k_end);
  }
  // the i-th of the launch's n kernel tiles; small k0 = most causal work:
  // first
  __device__ __forceinline__ void own(int i, int n, int& k0, int& k_end) {
    k0 = i * kFlashTile;
    k_end = Skv;
  }
  // causal: only rows >= k0 see the tile (64-row tiles on both sides), so
  // the walk starts at the block's first row
  __device__ __forceinline__ int first(int k0) const {
    return causal ? k0 - k0 % block_rows : 0;
  }
  __device__ __forceinline__ int count(int k0) const {
    const int q_start = first(k0);
    return q_start < Sq ? (Sq - q_start + kFlashTile - 1) / kFlashTile : 0;
  }
  // q rows [q0, q_end); f9_end: rows below it have no live column (none);
  // false for a q tile wholly above the kv tile's first column
  __device__ __forceinline__ bool visit(int t, int k0, int k_end, int& q0,
                                        int& q_end, int& f9_end,
                                        float& inv_n) const {
    q0 = first(k0) + t * kFlashTile;
    q_end = Sq;
    f9_end = 0;
    inv_n = 0.f;
    return !causal || q0 + kFlashTile - 1 >= k0;
  }
};

struct SparseKVTiles {
  static constexpr bool kSparse = true;
  static constexpr bool kMasked = false;
  const int* ids;       // (n_kv, stride): the transposed schedule
  const int* counts;    // (n_kv,), 0 for a kv tile no q tile attends
  const int* fwd_ids;   // (n_q, fwd_stride): the forward schedule
  const int* fwd_counts;
  int stride, fwd_stride, bq, bk;
  int k_sub, q_sub;     // kernel tiles per user kv tile (or more, as in
                        // SparseQTiles), per user q tile
  int causal;
  int ti;               // the block's user kv tile, set by own()
  __device__ __forceinline__ void own(int& k0, int& k_end) {
    own(blockIdx.x, gridDim.x, k0, k_end);
  }
  // the i-th kernel tile of the launch (a block may own several of one
  // user tile; k_sub then counts them so, and a tile at or past the user
  // tile's end has no rows)
  __device__ __forceinline__ void own(int i, int n, int& k0, int& k_end) {
    ti = i / k_sub;
    k0 = ti * bk + (i % k_sub) * kFlashTile;
    k_end = (ti + 1) * bk;
  }
  __device__ __forceinline__ int count(int k0) const {
    return counts[ti] * q_sub;
  }
  // F9: the rows of q tile qi below its first visited column have no live
  // column; the forward gave each the mean of V over its fwd_counts[qi] * bk
  // visited columns, so each of those columns gets 1 / (that count) of the
  // row's dO in dV, and nothing flows to dQ or dK
  __device__ __forceinline__ bool visit(int t, int k0, int k_end, int& q0,
                                        int& q_end, int& f9_end,
                                        float& inv_n) const {
    const int qi = ids[ti * stride + t / q_sub];
    q0 = qi * bq + (t % q_sub) * kFlashTile;
    q_end = (qi + 1) * bq;
    f9_end = causal ? fwd_ids[qi * fwd_stride] * bk : 0;
    inv_n = 1.f / (float)(fwd_counts[qi] * bk);
    // q rows that all lie above the kv tile's first column see none of it
    // (every score masked), unless one of them is an F9 row
    return !causal || min(q0 + kFlashTile, q_end) - 1 >= k0 || q0 < f9_end;
  }
};

// The options over the dense grid, kv side: a block's rows as
// DenseKVTiles's (kv rows at or past kv_len get zero gradients); it walks
// the q tiles that can see its 128-row pair through the band (rows from
// k - right, or from k under the causal mask, to k + 127 + left) and the
// segment ids, and computes on those that tile_live admits.
struct MaskedKVTiles {
  static constexpr bool kSparse = false;
  static constexpr bool kMasked = true;
  FlashMask mask;
  int walk0, walk_end;  // the block's walk: q tiles [walk0, walk_end)
  __device__ __forceinline__ void own(int& k0, int& k_end) {
    own(blockIdx.x, gridDim.x, k0, k_end);
  }
  // also sets the walk of the 128 kv rows from k0 - k0 % 128
  __device__ __forceinline__ void own(int i, int n, int& k0, int& k_end) {
    k0 = i * kFlashTile;
    k_end = mask.Skv;
    const int base = k0 - k0 % (2 * kFlashTile);
    const int end = min(mask.Sq, base + 2 * kFlashTile + mask.left);
    int lo, hi;
    mask.seg_walk(true, base, lo, hi);
    walk0 = max((mask.causal ? base : max(0, base - mask.right)) / kFlashTile,
                lo);
    walk_end = min((end + kFlashTile - 1) / kFlashTile, hi);
  }
  __device__ __forceinline__ int count(int k0) const {
    return k0 < mask.kv_end ? max(0, walk_end - walk0) : 0;
  }
  __device__ __forceinline__ bool visit(int t, int k0, int k_end, int& q0,
                                        int& q_end, int& f9_end,
                                        float& inv_n) const {
    q0 = (walk0 + t) * kFlashTile;
    q_end = mask.Sq;
    f9_end = 0;
    inv_n = 0.f;
    return mask.tile_live(q0, k0);
  }
};

}  // namespace
}  // namespace cubecl
