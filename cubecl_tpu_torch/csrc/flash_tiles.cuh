// The tile schedules of the flash kernels: which rows a block owns and which
// 64-row tiles of the other side it visits. flash_attention.cu (A1, A5) and
// flash_attention_bwd.cu (A3, A4, A6, A7) instantiate each kernel body once
// with the dense schedule and once with the block-sparse one, so the tile
// bodies (staging, the two score products, the online softmax, the
// gradient products) are written once.
//
// A schedule is a small struct passed by value to the kernel:
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
#pragma once

#include "common.cuh"

namespace cubecl {
namespace {

constexpr int kFlashTile = 64;  // rows of every q and kv tile
// DEFAULT_MASK_VALUE of cubecl_tpu/ops/attention.py, -0.7 * f32 max,
// rounded to f32 (bits 0xff333332)
constexpr float kMaskValue = -2.381976325e+38f;

// -- blocks owning q rows (forward, dQ) ----------------------------------

struct DenseQTiles {
  static constexpr bool kSparse = false;
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

// -- blocks owning kv rows (dK, dV) --------------------------------------

struct DenseKVTiles {
  static constexpr bool kSparse = false;
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

}  // namespace
}  // namespace cubecl
