// Paged decode attention for Hopper (sm_90a): the serving decode kernel.
//
// Replaces the TPU decode kernels of cubecl_tpu/ops/paged_attention.py:
//   P1 _paged_call_headed (static capacity grid, used under jit) and
//   P2 _paged_call_live (grid over a compacted list of live work, used in
//   eager decode). Both compute the same function; they differ only in how
//   Mosaic's grid skips dead pages. Here a block reads its own block-table
//   row and walks only the 64-position tiles below lengths[b], so dead
//   pages cost nothing and no work list is built.
//
// Math (as P1/P2): the G = H / Hkv query rows of one kv head against that
// head's pages of layer `layer` in the stacked pool (L, Hkv, P, page, D),
// for any G;
// base-2 online softmax over positions < lengths[b] with f32 statistics,
// accumulator and probabilities; a row of length 0 gets zeros. Table
// entries are clamped to [0, P) before they are read (P1's scale gather
// wraps -1 to the last page).
//
// int8 KV (P1's k_scales/v_scales option): the pools hold int8 values and
// the scale pools (L, Hkv, P, page) one f32 scale per (token, head). As in
// P1, the K scale multiplies each position's score column and the V scale
// its probability column (the row sum l takes the unscaled probability), so
// no dequantized K/V tile is ever formed. Each position's scales ride the
// same table lookup as its K/V rows.
//
// Bound on the H100: decode reads every cached K/V byte once per step and
// does ~2G flops per byte, so HBM bandwidth bounds it (int8 halves the bytes
// of bf16, plus 8 bytes of scales per position); the CUDA cores do the
// f32 products. What this design does about it:
// - A split over positions (flash-decoding). B * Hkv blocks leave most of
//   the 132 SMs idle at serving batch sizes, so each (batch row, kv head)
//   is cut into `splits` blocks, enough that the grid fills the card once
//   at two blocks an SM (p1_splits; ops/paged_attention.py's p1_plan
//   repeats it). A block owns whole 64-position tiles: the row's
//   ceil(len / 64) tiles shared out ceil(tiles / splits) a split, from
//   lengths[b] on the device, so the splits of a row are as long as its
//   actual length allows. Where B * Hkv fills the card alone, one split.
//   Each split writes its partial (acc, m, l) in f32 and a second, small
//   launch (paged_combine.cuh, P3's combine) rescales and adds them.
// - Bytes in flight: a ring of 3 stages of K and V rows per warp, copied
//   with cp.async (16 bytes a copy, zeros past the split's end) through
//   the block table, the copies of two tiles ahead issued before each
//   tile's products. A warp owns 8 positions of each tile and its own
//   online softmax, so it copies, reads and frees its stages alone: the
//   loop has no __syncthreads, only __syncwarp; the block's 8 warps meet
//   once at the end and combine their (acc, m, l) in shared memory.
// - Lane (p, quarter) of a warp computes position p's score on an
//   interleaved quarter of the row (16-byte chunks c * 4 + quarter), two
//   shuffles finish it; rows of 8 chunks or more put chunk j of odd rows
//   at j ^ 4, so that the 8 lanes of a 16-byte load hit 32 banks. For P V
//   each lane owns D / 32 output columns of every query row and reads V's
//   8 rows of the warp, the probabilities by shuffle.
// - D 96 (Phi-3-mini's head dim; the pools stay (..., 96), with no padding
//   read or held): a row is 12 chunks (bf16), 24 (f32) or 6 (int8). Its
//   quarter is 3 or 6 chunks, or for int8 2 chunks in quarters 0 and 1
//   and one in 2 and 3. The slots (Slots96): f32 rows (384 bytes) swizzle
//   as above; bf16 rows (192 bytes) put odd rows 64 bytes over already;
//   int8 rows (96 bytes) rotate the chunks of even rows by 2 (j at (j + 2)
//   % 6), which gives each 8-lane phase of a load its 8 bank groups. For
//   P V a lane owns columns lane, lane + 32 and lane + 64 (three 4-, 2- or
//   1-byte reads a row, neighbouring lanes on neighbouring addresses). f32
//   pools, whose 147 KB of shared memory hold one block an SM, let ptxas
//   use the SM's registers (P1MinBlocks): at its default 128 they spilled.
// - D 256 (GPT-J-6B's and Qwen3-Next's head dim): a quarter row is 8
//   chunks (bf16), 16 (f32) or 4 (int8), whole, swizzled as at D 128; for
//   P V a lane owns 8 neighbouring columns (one 16-byte read a row for
//   bf16, two for f32, one of 8 bytes for int8). The warps' rings take
//   192 KB on bf16 pools, 96 KB on int8; f32 pools keep one stage a warp
//   (p1_stages: three 16 KB stages a warp would take 384 KB, two 256 KB),
//   copied and waited for at each tile, the block's 8 warps overlapping
//   one another's copies. Every D 256 kernel is built for one block an SM
//   (P1MinBlocks; int8 pools, whose 108,032 bytes would hold two, for the
//   registers of 8 columns a lane and query row), and the splits fill the
//   card once at one block an SM (p1_per_sm).
// - D 80 (Phi-2's and H2O-Danube's head dim; pools unpadded, as at D 96):
//   a row is 10 chunks (bf16), 20 (f32) or 5 (int8), so the quarters hold
//   3-3-2-2 chunks (bf16), 5 each (f32) or 2-1-1-1 (int8), the `j < RC`
//   guard of D 96's int8 rows skipping the missing ones. The XOR swizzle
//   would send chunks 8 and 9 past a 10-chunk row, so D 80 has slots of
//   its own (Slots80): f32 rows (320 bytes) as they are, an odd row
//   starting 4 chunks over already; bf16 rows (160 bytes) rotate odd rows
//   by 2 chunks, int8 rows (80 bytes) even rows by 1, which gives each
//   8-lane phase of a 16-byte load its 8 bank groups. For P V a lane owns
//   columns lane, lane + 32 and, in lanes 0..15, lane + 64, as at D 96.
//   f32 pools (125,440 bytes: one block an SM) take P1MinBlocks' one, as
//   at D 96.
// - D 32 (Pythia-31M's head dim): rows of 4 chunks (bf16), 8 (f32,
//   swizzled as at D 128) or 2 (int8: quarters 2 and 3 hold none); for P
//   V a lane owns one column (one 4-, 2- or 1-byte read a row).
// - Past 8 query heads a kv head (Mistral-Large-2's 12, MiniMax's 16,
//   Falcon-7B's multi-query 71; paged_grouped_kernel): a block holds at
//   most MAXG = 8 query rows (q in shared memory, m, l and acc in
//   registers, the warps' combine buffer sized for 8), so the G rows of a
//   kv head are cut into groups = ceil(G / 8) row groups of ceil(G /
//   groups) rows, the last maybe fewer (its other rows zeros, never
//   written), each a block of its own. A split's row groups are neighbours
//   in block order (block x = split * groups + group), so they walk the
//   same positions at about the same time and can share the K/V through
//   the L2. The splits count every block of a (batch row, kv head): B *
//   Hkv * groups blocks before the split (p1_splits). A block writes its
//   rows' outputs, or where the positions are split their partials, one a
//   query row as the other kernels do (the combine reads row hk * G + g).
//   The same body with its block's rows from blockIdx.x (GROUPED); the
//   kernels of at most 8 rows are the code they were.
// What holds it back: the f32 products and shuffles per position (G of
// each) run on the CUDA cores; at B * Hkv near one wave the split is 1 and
// the tail of the wave idles; past 8 rows a kv head each row group reads
// the kv head's K/V again (from the L2 where a neighbour just read it).
//
// P1's two options (StreamingLLM serving), each a kernel of its own on the
// same body, chosen at compile time (MODE), so that the plain decode's
// instances (paged_decode_kernel) are the code they were:
// - window + sinks (paged_window_kernel): attend only positions < sinks
//   and >= len - window. A windowed step has to read the window's bytes,
//   not the context's (the JAX kernel's step guard skips the dead middle's
//   compute; its DMA is what a TPU grid step costs anyway). So a block
//   walks only the live tiles: those of [0, min(sinks, len)) and of
//   [max(0, len - window), len), merged where they meet, shared out over
//   the splits as the full walk shares out its tiles (WindowTiles); the
//   dead middle inside a boundary tile is masked like the tail, and never
//   copied. The split count is sized from the most live tiles a row of
//   the table can have, not from its capacity.
// - ring positions (paged_ring_kernel): a bounded cache whose slots are
//   recycled; each slot's absolute position is in pos_meta (P, page),
//   shared by every layer and kv head, -1 where nothing was written. A
//   block walks the table-order slots [0, min(len, capacity)) (a position
//   t lands at table order <= t, so slots past len hold nothing of this
//   row) as the full walk does; each position's meta rides its K/V rows
//   (one 4-byte cp.async into the stage, as the int8 scales do) and the
//   mask is meta in [0, len) and, with a window, in its window.
#include "paged_decode.cuh"

// every other D up to 256: paged_ragged.cu, the same arguments
extern "C" int cubecl_paged_decode_ragged(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const void* table,
    const void* lengths, const int* pos_meta, void* o, void* part, int dtype,
    int kv_dtype, int B, int H, int Hkv, int D, int layer, int P, int page,
    int max_pages, int window, int sinks, float scale_log2, void* stream);

// q (B, H, D); k_pages/v_pages (L, Hkv, P, page, D); table (B, max_pages)
// int32; lengths (B,) int32; o (B, H, D). Contiguous; q and o of `dtype`
// (f32 or bf16), the pools of `kv_dtype`: the same dtype, or int8 with f32
// scale pools k_scales/v_scales (L, Hkv, P, page) (null otherwise). window
// > 0: attend only positions < sinks and >= lengths[b] - window (sinks are
// read only then). pos_meta (P, page) int32, or null: the ring, each
// slot's absolute position (-1: never written), masked by the window too.
// part: the splits' partial sums where the positions are split,
// cubecl_paged_decode_plan's plan[6] floats (null where that is 0).
// Any H that is a multiple of Hkv. D 32, 64, 80, 96, 128 and 256 are
// instances of their own; any other D from 1 to 255 runs in the next of
// the widths 64, 128 and 256 (paged_ragged.cu). Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a dtype or head_dim
// this kernel was not built for.
extern "C" int cubecl_paged_decode(const void* q, const void* k_pages,
                                   const void* v_pages, const float* k_scales,
                                   const float* v_scales, const void* table,
                                   const void* lengths, const int* pos_meta,
                                   void* o, void* part, int dtype,
                                   int kv_dtype, int B, int H, int Hkv, int D,
                                   int layer, int P, int page, int max_pages,
                                   int window, int sinks, float scale_log2,
                                   void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if (window < 0 || sinks < 0) return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kI8;
  if (quant != (k_scales != nullptr && v_scales != nullptr))
    return cudaErrorInvalidValue;
  if (!quant && kv_dtype != dtype) return cudaErrorInvalidValue;
  const int mode = p1_mode(window, pos_meta != nullptr);
#define CUBECL_PAGED_MODE(M, T, TK, HD)                                      \
  launch_paged<M, T, TK, HD>(q, k_pages, v_pages, k_scales, v_scales, table, \
                             lengths, pos_meta, o, part, B, H, Hkv, layer, P, \
                             page, max_pages, window, sinks, scale_log2, st)
#define CUBECL_PAGED(T, TK, HD)                                   \
  (mode == kModeFull     ? CUBECL_PAGED_MODE(kModeFull, T, TK, HD)         \
   : mode == kModeWindow ? CUBECL_PAGED_MODE(kModeWindow, T, TK, HD)       \
                     : CUBECL_PAGED_MODE(kModeRing, T, TK, HD))
  if (dtype == kF32) {
    if (D == 32) return quant ? CUBECL_PAGED(float, int8_t, 32)
                              : CUBECL_PAGED(float, float, 32);
    if (D == 64) return quant ? CUBECL_PAGED(float, int8_t, 64)
                              : CUBECL_PAGED(float, float, 64);
    if (D == 80) return quant ? CUBECL_PAGED(float, int8_t, 80)
                              : CUBECL_PAGED(float, float, 80);
    if (D == 96) return quant ? CUBECL_PAGED(float, int8_t, 96)
                              : CUBECL_PAGED(float, float, 96);
    if (D == 128) return quant ? CUBECL_PAGED(float, int8_t, 128)
                               : CUBECL_PAGED(float, float, 128);
    if (D == 256) return quant ? CUBECL_PAGED(float, int8_t, 256)
                               : CUBECL_PAGED(float, float, 256);
  }
  if (dtype == kBF16) {
    if (D == 32) return quant ? CUBECL_PAGED(__nv_bfloat16, int8_t, 32)
                              : CUBECL_PAGED(__nv_bfloat16, __nv_bfloat16, 32);
    if (D == 64) return quant ? CUBECL_PAGED(__nv_bfloat16, int8_t, 64)
                              : CUBECL_PAGED(__nv_bfloat16, __nv_bfloat16, 64);
    if (D == 80) return quant ? CUBECL_PAGED(__nv_bfloat16, int8_t, 80)
                              : CUBECL_PAGED(__nv_bfloat16, __nv_bfloat16, 80);
    if (D == 96) return quant ? CUBECL_PAGED(__nv_bfloat16, int8_t, 96)
                              : CUBECL_PAGED(__nv_bfloat16, __nv_bfloat16, 96);
    if (D == 128)
      return quant ? CUBECL_PAGED(__nv_bfloat16, int8_t, 128)
                   : CUBECL_PAGED(__nv_bfloat16, __nv_bfloat16, 128);
    if (D == 256)
      return quant ? CUBECL_PAGED(__nv_bfloat16, int8_t, 256)
                   : CUBECL_PAGED(__nv_bfloat16, __nv_bfloat16, 256);
  }
#undef CUBECL_PAGED
#undef CUBECL_PAGED_MODE
  if ((dtype == kF32 || dtype == kBF16) && D >= 1 && D < 256)
    return cubecl_paged_decode_ragged(q, k_pages, v_pages, k_scales, v_scales,
                                      table, lengths, pos_meta, o, part,
                                      dtype, kv_dtype, B, H, Hkv, D, layer, P,
                                      page, max_pages, window, sinks,
                                      scale_log2, stream);
  return cudaErrorInvalidValue;
}

// P1's launch plan for q of `dtype`, pools of `kv_dtype`, the shapes and
// the options (window, sinks, ring: a pos_meta given): plan[0..7] =
// threads a block, dynamic shared memory bytes, the grid (x: the splits of
// a (batch row, kv head) times its row groups, y: Hkv, z: B), the splits,
// the floats of `part` (0 without a split), the mode (0 plain, 1 window +
// sinks, 2 ring); plan[8] = the row groups of a kv head; plan[9] = the
// stages of a warp's ring (p1_stages). Returns 0, or
// cudaErrorInvalidValue for what cubecl_paged_decode refuses.
extern "C" int cubecl_paged_decode_plan(int dtype, int kv_dtype, int B, int H,
                                        int Hkv, int D, int page,
                                        int max_pages, int window, int sinks,
                                        int ring, int* plan) {
  using namespace cubecl;
  if (Hkv <= 0 || H <= 0 || H % Hkv != 0 || B <= 0 ||
      (dtype != kF32 && dtype != kBF16) ||
      (kv_dtype != kI8 && kv_dtype != dtype) || window < 0 || sinks < 0)
    return cudaErrorInvalidValue;
  const int mode = p1_mode(window, ring != 0);
  const P1Sizes sz =
      mode == kModeFull     ? p1_sizes<kModeFull>(dtype, kv_dtype, D)
      : mode == kModeWindow ? p1_sizes<kModeWindow>(dtype, kv_dtype, D)
                            : p1_sizes<kModeRing>(dtype, kv_dtype, D);
  if (sz.smem < 0) return cudaErrorInvalidValue;
  const int groups = p1_groups(H / Hkv);
  const int splits =
      p1_splits(B, Hkv, groups,
                p1_walk_tiles(mode, page, max_pages, window, sinks),
                sz.per_sm);
  plan[0] = PNT;
  plan[1] = sz.smem;
  plan[2] = splits * groups;
  plan[3] = Hkv;
  plan[4] = B;
  plan[5] = splits;
  plan[6] = splits > 1 ? B * Hkv * splits * (H / Hkv) * (D + 2) : 0;
  plan[7] = mode;
  plan[8] = groups;
  plan[9] = sz.stages;
  return 0;
}
