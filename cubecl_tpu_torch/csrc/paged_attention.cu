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
#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "paged_combine.cuh"

namespace cubecl {
namespace {

constexpr int PT = 64;          // positions per tile
constexpr int PNT = 256;        // threads per block
constexpr int PNW = PNT / 32;   // warps per block
constexpr int WR = PT / PNW;    // positions of a tile a warp owns
constexpr int MAXG = 8;         // query rows a block holds (a row group)
constexpr int STAGES = 3;       // ring of K/V stages per warp (p1_stages)
constexpr int kSMs = 132;       // the H100's SMs
constexpr int kSmSmem = 233472;  // shared memory of an SM (228 KB)

// the body's modes: every position below the length, window + sinks, ring
constexpr int kModeFull = 0;
constexpr int kModeWindow = 1;
constexpr int kModeRing = 2;


// the stages of a warp's ring: STAGES, or 1 for f32 pools at D 256, whose
// 16 KB stages (8 K and 8 V rows of 1 KB) would take 384 KB at 3 stages a
// warp and 256 KB at 2, past the 227 KB a block may hold (one: 136 KB)
template <typename TK, int D>
constexpr int p1_stages() {
  return D == 256 && sizeof(TK) == 4 ? 1 : STAGES;
}

// dynamic shared memory: q (MAXG x D f32), then the warps' rings (a
// stage: WR K rows, WR V rows, for int8 their WR K and WR V scales, for
// the ring the WR positions' meta); the rings are reused at the end for
// the warps' (acc, m, l)
template <typename TK, int D, int MODE = kModeFull>
struct P1Smem {
  static constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  static constexpr int kStages = p1_stages<TK, D>();
  static constexpr int kRow = D * (int)sizeof(TK);
  static constexpr int kMeta = 2 * WR * kRow + (kQuant ? 2 * WR * 4 : 0);
  static constexpr int kStage = kMeta + (MODE == kModeRing ? WR * 4 : 0);
  static constexpr int kRing = MAXG * D * 4;
  static constexpr int kRingBytes = PNW * kStages * kStage;
  static constexpr int kComb = PNW * MAXG * (D + 2) * 4;
  static constexpr int kBytes =
      kRing + (kRingBytes > kComb ? kRingBytes : kComb);
};

// the most tiles a row walks: the table's (full walk, ring), or (window)
// those of the sinks and of a window that starts inside a tile
inline int p1_walk_tiles(int mode, int page, int max_pages, int window,
                         int sinks) {
  const int64_t cap = (int64_t)page * max_pages;
  const int64_t tiles = std::max<int64_t>(1, (cap + PT - 1) / PT);
  if (mode != kModeWindow) return (int)tiles;
  const int64_t live =
      (std::min<int64_t>(sinks, cap) + PT - 1) / PT + (window - 1) / PT + 2;
  return (int)std::min(tiles, live);
}

// row groups of a kv head's G query rows: ceil(G / MAXG), each of
// p1_group_rows(G) rows but the last
inline int p1_groups(int G) { return (G + MAXG - 1) / MAXG; }
inline int p1_group_rows(int G) {
  return (G + p1_groups(G) - 1) / p1_groups(G);
}

// splits of each (batch row, kv head): enough blocks, its row groups
// counted, to fill the card once at per_sm blocks an SM (p1_per_sm), at
// most the tiles a row walks; 1 where B * Hkv * groups fills it alone
inline int p1_splits(int B, int Hkv, int groups, int tiles, int per_sm) {
  const int rows = B * Hkv * groups;
  return std::max(1, std::min(kSMs * per_sm / rows, tiles));
}

// window mode: a row's live tiles, those of the sinks [0, min(sinks, len))
// then those of the window [max(0, len - window), len) (one run where the
// two meet), numbered 0.. in that order; split `split` takes
// ceil(live / splits) of them, as the full walk takes its tiles. Its tile
// t starts at position first + t * PT, plus the dead middle's gap from
// tile `jump` on; a position is live below len, outside the dead middle
// [sinks, sinks + mid)
struct WindowTiles {
  int count, jump, first, gap, mid;
  __device__ __forceinline__ WindowTiles(int len, int window, int sinks,
                                         int split, int splits) {
    const int ta = (min(sinks, len) + PT - 1) / PT;
    const int tb = max(0, len - window) / PT;
    const int tl = (len + PT - 1) / PT;
    const int na = tb <= ta ? 0 : ta;  // the sinks' own tiles
    const int tw = tb <= ta ? 0 : tb;  // the window's first tile
    const int live = na + tl - tw;
    const int per = (live + splits - 1) / splits;
    const int k0 = min(live, split * per);
    count = min(live, k0 + per) - k0;
    jump = k0 < na ? na - k0 : count;
    first = (k0 < na ? k0 : tw + k0 - na) * PT;
    gap = (tw - na) * PT;
    mid = max(0, len - window - sinks);
  }
  __device__ __forceinline__ int pos0(int t) const {
    return first + t * PT + (t >= jump ? gap : 0);
  }
  __device__ __forceinline__ bool live(int pos, int len, int sinks) const {
    return pos < len && (unsigned)(pos - sinks) >= (unsigned)mid;
  }
};

// D 80's slots (see the header): the 16-byte slot of chunk j of a row,
// from the row's shift: j (f32: shift 0), or (j + shift) % chunks (bf16:
// 2 on odd rows, 0 on even; int8: 1 on even rows, 0 on odd)
template <typename TK>
struct Slots80 {
  static constexpr int kRow = 80 * (int)sizeof(TK);
  static constexpr int kChunks = kRow / 16;
  __device__ __forceinline__ static int shift(int row) {
    if constexpr (kChunks == 10) return (row & 1) ? 2 : 0;
    else if constexpr (kChunks == 5) return (row & 1) ? 0 : 1;
    else return 0;
  }
  __device__ __forceinline__ static int slot(int j, int shift) {
    return j + shift < kChunks ? j + shift : j + shift - kChunks;
  }
  // P V: the element at column d of a row that starts at `row`
  __device__ __forceinline__ static float at(const uint8_t* row, int shift,
                                             int d) {
    const int byte = d * (int)sizeof(TK);
    const TK x = *reinterpret_cast<const TK*>(
        row + slot(byte / 16, shift) * 16 + byte % 16);
    if constexpr (std::is_same<TK, int8_t>::value) {
      return static_cast<float>(x);
    } else {
      return to_float(x);
    }
  }
};

// D 96's slots: the 16-byte slot of chunk j of a row, from the row's
// shift (`shift`): j ^ shift where a row is a multiple of 128 bytes (f32),
// j (bf16: shift 0), or (j + shift) % 6 (int8: 2 on even rows, 0 on odd)
template <typename TK>
struct Slots96 {
  static constexpr int kRow = 96 * (int)sizeof(TK);
  static constexpr int kChunks = kRow / 16;
  __device__ __forceinline__ static int shift(int row) {
    if constexpr (kRow % 128 == 0) return (row & 1) * 4;
    else if constexpr (kChunks == 6) return (row & 1) ? 0 : 2;
    else return 0;
  }
  __device__ __forceinline__ static int slot(int j, int shift) {
    if constexpr (kChunks == 6) {
      return j + shift < 6 ? j + shift : j + shift - 6;
    } else {
      return j ^ shift;
    }
  }
  // P V: the element at column d of a row that starts at `row`
  __device__ __forceinline__ static float at(const uint8_t* row, int shift,
                                             int d) {
    const int byte = d * (int)sizeof(TK);
    // a shift of chunks within 8-chunk groups is the byte offset's XOR
    const int off = kChunks == 6 ? slot(byte / 16, shift) * 16 + byte % 16
                                 : byte ^ (shift << 4);
    const TK x = *reinterpret_cast<const TK*>(row + off);
    if constexpr (std::is_same<TK, int8_t>::value) {
      return static_cast<float>(x);
    } else {
      return to_float(x);
    }
  }
};

// where a grouped block writes: its first query head row, its partials,
// its live rows; kept in shared memory from the start to the end (as
// registers through the loop they made the tightest instances spill, and
// they are not cheap to recompute)
struct P1Out {
  int64_t row;
  float* part;
  int rows;
};
__device__ __forceinline__ P1Out& p1_out() {
  __shared__ P1Out out;
  return out;
}

// the body of the kernels below, for MODE; part (splits > 1): per (b, kv
// head, split, query row < H / Hkv) the row's unnormalised f32 accumulator
// (D), then its m and l. GROUPED: block x is split x / groups and row
// group x % groups of the kv head's H / Hkv rows, G its rows (the last
// group's past H / Hkv are zeros); else G = H / Hkv <= MAXG, block x split
// x
template <int MODE, bool GROUPED, typename T, typename TK, int D>
__device__ __forceinline__ void paged_decode_body(
    const T* __restrict__ q, const TK* __restrict__ kpool,
    const TK* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ o,
    float* __restrict__ part, int H, int Hkv, int G, int layer, int P,
    int page, int max_pages, float scale_log2, int splits, int window,
    int sinks, const int* __restrict__ meta) {
  using L = P1Smem<TK, D, MODE>;
  constexpr bool QUANT = L::kQuant;
  constexpr int EPC = Chunk<TK>::N;    // elements per 16-byte chunk
  constexpr bool D96 = D == 96;        // the slots and columns of Slots96
  constexpr bool D80 = D == 80;        // ... of Slots80
  using S96 = Slots96<TK>;
  using S80 = Slots80<TK>;
  // P V's columns lane + 32 e of the rotated rows (D 80 and 96)
  using SX = typename std::conditional<D80, S80, S96>::type;
  static_assert(D == 32 || D == 64 || D == 80 || D == 96 || D == 128 ||
                    D == 256,
                "P1 is built for D 32, 64, 80, 96, 128 and 256");
  constexpr int NS = L::kStages;       // stages of a warp's ring
  constexpr int RC = L::kRow / 16;     // chunks per row
  constexpr int CPT = (RC + 3) / 4;    // chunks per lane: a quarter row
  constexpr int SWZ = RC >= 8 ? 4 : 0;  // odd rows: chunk j at j ^ SWZ
  // P V: output columns per lane (D 80: the third in lanes 0..15 only)
  constexpr int CW = D80 ? 3 : D / 32;
  static_assert(CPT >= 1, "a quarter row must hold one 16-byte chunk");
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int split, g0, live;  // grouped: the split, the first row, the live rows
  if constexpr (GROUPED) {
    const int groups = (H / Hkv + G - 1) / G;
    split = blockIdx.x / groups;
    g0 = (blockIdx.x % groups) * G;
    live = min(G, H / Hkv - g0);
  } else {
    split = blockIdx.x;
  }
  const int hk = blockIdx.y, b = blockIdx.z;
  const int len = max(lengths[b], 0);
  // the table-order positions walked: those below the length (the ring:
  // the slots written so far, at most the table's)
  const int n = MODE == kModeRing ? min(len, max_pages * page) : len;
  // this split's positions [p0, p1): whole tiles, ceil(tiles / splits) each
  const int tiles = (n + PT - 1) / PT;
  const int per = (tiles + splits - 1) / splits;
  const int p0 = min(n, split * per * PT);
  const int p1 = min(n, p0 + per * PT);
  // window mode walks its live tiles instead
  const WindowTiles wt(len, window, sinks, split, splits);
  const int n_tiles = MODE == kModeWindow ? wt.count : (p1 - p0 + PT - 1) / PT;
  int64_t orow0;  // the block's first query head row
  float* pr;      // its partials
  if constexpr (GROUPED) {
    orow0 = (int64_t)b * H + (int64_t)hk * (H / Hkv) + g0;
    pr = splits == 1 ? nullptr
                     : part + ((((int64_t)b * Hkv + hk) * splits + split) *
                                   (H / Hkv) + g0) * (D + 2);
  } else {
    orow0 = (int64_t)b * H + (int64_t)hk * G;
    pr = splits == 1 ? nullptr
                     : part + (((int64_t)b * Hkv + hk) * splits + split) * G *
                                  (D + 2);
  }
  if constexpr (GROUPED) {
    if (tid == 0) p1_out() = P1Out{orow0, pr, live};
    if (n_tiles == 0) {  // no position: zeros (and an empty partial)
      for (int i = tid; i < live * (D + 2); i += PNT) {
        if (splits == 1) {
          if (i < live * D) o[orow0 * D + i] = from_float<T>(0.f);
        } else {
          pr[i] = i % (D + 2) == D ? -INFINITY : 0.f;
        }
      }
      return;
    }
    for (int i = tid; i < G * D; i += PNT)
      qs[i] = i < live * D ? to_float(q[orow0 * D + i]) : 0.f;
  } else {
    if (n_tiles == 0) {  // no position: zeros (and an empty partial)
      for (int i = tid; i < G * (D + 2); i += PNT) {
        if (splits == 1) {
          if (i < G * D) o[orow0 * D + i] = from_float<T>(0.f);
        } else {
          pr[i] = i % (D + 2) == D ? -INFINITY : 0.f;
        }
      }
      return;
    }
    for (int i = tid; i < G * D; i += PNT) qs[i] = to_float(q[orow0 * D + i]);
  }
  const int64_t head_page0 = ((int64_t)layer * Hkv + hk) * P;
  const int* tab = table + (int64_t)b * max_pages;

  const int p = lane / 4, quarter = lane % 4;  // score phase
  const int swz = D96   ? S96::shift(p)
                  : D80 ? S80::shift(p)
                        : (p & 1) * SWZ;
  uint8_t* ring = smem + L::kRing + warp * NS * L::kStage;
  const uint32_t ring_s = smem_addr(ring);

  // stage st <- K and V rows (and scales, the ring's meta) of this warp's
  // positions of tile t; lane (p, quarter) copies the chunks of row p that
  // it reads itself (window mode: only where it is live). The modes'
  // positions are written out in each branch: as lambdas shared with the
  // products below they changed the plain decode's SASS
  auto issue = [&](int t, int st) {
    int pos;
    bool ok;
    if constexpr (MODE == kModeWindow) {
      pos = wt.pos0(t) + warp * WR + p;
      ok = wt.live(pos, len, sinks);
    } else {
      pos = p0 + t * PT + warp * WR + p;
      ok = pos < p1;
    }
    int64_t row = 0;
    int pid = 0;
    if (ok) {
      pid = min(max(tab[pos / page], 0), P - 1);
      row = (head_page0 + pid) * page + pos % page;
    }
    const uint32_t kd = ring_s + st * L::kStage + p * L::kRow;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = c * 4 + quarter;
      if (RC % 4 == 0 || j < RC) {  // int8 D 96: quarters 2, 3 hold one
        const int at = D96   ? S96::slot(j, swz)
                       : D80 ? S80::slot(j, swz)
                             : (j ^ swz);
        cp_async16_zfill(kd + at * 16, kpool + row * D + j * EPC, ok);
        cp_async16_zfill(kd + WR * L::kRow + at * 16,
                         vpool + row * D + j * EPC, ok);
      }
    }
    if constexpr (QUANT) {
      if (quarter < 2) {
        const uint32_t sd = ring_s + st * L::kStage + 2 * WR * L::kRow +
                            (quarter * WR + p) * 4;
        cp_async4_zfill(sd, (quarter == 0 ? kscale : vscale) + row, ok);
      }
    }
    if constexpr (MODE == kModeRing) {
      if (quarter == 2) {
        cp_async4_zfill(ring_s + st * L::kStage + L::kMeta + p * 4,
                        meta + (int64_t)pid * page + pos % page, ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_tiles) issue(st, st);
    cp_async_commit();
  }
  __syncthreads();  // qs

  float m[MAXG], l[MAXG], acc[MAXG][CW];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < CW; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % NS;
    if constexpr (NS == 1) {
      // one stage: the warp has read tile t - 1; tile t is copied, then
      // waited for
      __syncwarp();
      issue(t, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
    } else {
      cp_async_wait<NS - 2>();  // this lane's copies of tile t
      __syncwarp();             // the warp's; its tile t - 1 is read
      if (t + NS - 1 < n_tiles) issue(t + NS - 1, (t + NS - 1) % NS);
      cp_async_commit();
    }
    const uint8_t* stage = ring + st * L::kStage;

    // scores of position p: its quarter of the row, then two shuffles
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    const TK* krow = reinterpret_cast<const TK*>(stage + p * L::kRow);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = c * 4 + quarter;
      if (RC % 4 == 0 || j < RC) {
        float kx[EPC];
        Chunk<TK>::load(krow + (D96   ? S96::slot(j, swz)
                                : D80 ? S80::slot(j, swz)
                                      : (j ^ swz)) * EPC,
                        kx);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G)
#pragma unroll
            for (int e = 0; e < EPC; ++e)
              s[g] = fmaf(qs[g * D + j * EPC + e], kx[e], s[g]);
      }
    }
    bool valid;
    if constexpr (MODE == kModeWindow) {
      valid = wt.live(wt.pos0(t) + warp * WR + p, len, sinks);
    } else {
      valid = p0 + t * PT + warp * WR + p < p1;
    }
    if constexpr (MODE == kModeRing) {
      // the slot's absolute position: written (>= 0), in this row's
      // context and, with a window, in it or among the sinks
      const int at = reinterpret_cast<const int*>(stage + L::kMeta)[p];
      valid = valid && at >= 0 && at < len &&
              (window <= 0 || at < sinks || at >= len - window);
    }
    float ksc = 1.f, vsc = 1.f;
    if constexpr (QUANT) {
      const float* sc =
          reinterpret_cast<const float*>(stage + 2 * WR * L::kRow);
      ksc = sc[p];
      vsc = sc[WR + p];
    }

    // online softmax over the warp's 8 positions, per query row; pv: the
    // probability of position p (int8: times its V scale)
    float pv[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float x = s[g];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        // int8: the K scale on the score column, after the base-2 scaling
        x = valid ? x * scale_log2 * ksc : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        // a warp with no live position yet keeps p = 0, not exp2(nan)
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float pg = exp2f(x - m_use);
        const float alpha = exp2f(m[g] - m_use);
        float sum = pg;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[g] = l[g] * alpha + sum;  // l sums the unscaled p
        m[g] = m_new;
        pv[g] = QUANT ? pg * vsc : pg;
#pragma unroll
        for (int e = 0; e < CW; ++e) acc[g][e] *= alpha;
      }
    }

    // O += P V over the warp's 8 positions: lane owns columns lane * CW..
    const uint8_t* vrows = stage + WR * L::kRow;
    if constexpr (D96 || D80) {
      // columns lane, lane + 32, lane + 64 (D 80: lanes 0..15 only)
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        const int sh = SX::shift(r);
        float v[CW];
#pragma unroll
        for (int e = 0; e < CW; ++e)
          v[e] = !D80 || e < 2 || lane < 16
                     ? SX::at(vrows + r * L::kRow, sh, e * 32 + lane)
                     : 0.f;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float pr_g = __shfl_sync(0xffffffffu, pv[g], r * 4);
#pragma unroll
            for (int e = 0; e < CW; ++e)
              acc[g][e] = fmaf(pr_g, v[e], acc[g][e]);
          }
        }
      }
    } else {
      // the byte of the lane's columns
      const int cb = lane * CW * (int)sizeof(TK);
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        const uint8_t* vp = vrows + r * L::kRow +
                            (((cb / 16) ^ ((r & 1) * SWZ)) * 16) + cb % 16;
        float v[CW];
        if constexpr (CW == 8) {
          // D 256: 16 bytes (bf16), 32 (f32: the row's chunks 2 lane and 2
          // lane + 1, neighbours under the swizzle) or 8 (int8)
          if constexpr (std::is_same<TK, float>::value) {
            load4(reinterpret_cast<const float*>(vp), v);
            load4(reinterpret_cast<const float*>(vp) + 4, v + 4);
          } else if constexpr (std::is_same<TK, __nv_bfloat16>::value) {
            Chunk<TK>::load(reinterpret_cast<const TK*>(vp), v);
          } else {
            const uint2 u = *reinterpret_cast<const uint2*>(vp);
            unpack_s8x4(u.x, v);
            unpack_s8x4(u.y, v + 4);
          }
        } else if constexpr (CW == 4) {
          load4(reinterpret_cast<const TK*>(vp), v);
        } else if constexpr (CW == 1) {
          // D 32: one column, 4, 2 or 1 bytes
          if constexpr (std::is_same<TK, int8_t>::value) {
            v[0] = static_cast<float>(*reinterpret_cast<const int8_t*>(vp));
          } else {
            v[0] = to_float(*reinterpret_cast<const TK*>(vp));
          }
        } else if constexpr (std::is_same<TK, float>::value) {
          const float2 f = *reinterpret_cast<const float2*>(vp);
          v[0] = f.x;
          v[1] = f.y;
        } else if constexpr (std::is_same<TK, __nv_bfloat16>::value) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vp));
          v[0] = f.x;
          v[1] = f.y;
        } else {
          const char2 c2 = *reinterpret_cast<const char2*>(vp);
          v[0] = c2.x;
          v[1] = c2.y;
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float pr_g = __shfl_sync(0xffffffffu, pv[g], r * 4);
#pragma unroll
            for (int e = 0; e < CW; ++e)
              acc[g][e] = fmaf(pr_g, v[e], acc[g][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();     // every warp is done with its ring

  // the warps' (acc, m, l) into the block's, then the output or the partial
  float* comb = reinterpret_cast<float*>(smem + L::kRing);
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      float* cw = comb + (warp * MAXG + g) * (D + 2);
#pragma unroll
      for (int e = 0; e < CW; ++e)
        if (!D80 || e < 2 || lane < 16)
          cw[D96 || D80 ? e * 32 + lane : lane * CW + e] = acc[g][e];
      if (lane == 0) {
        cw[D] = m[g];
        cw[D + 1] = l[g];
      }
    }
  }
  __syncthreads();
  int rows_out = G;  // the rows written, from the first at orow0, to pr
  if constexpr (GROUPED) {
    const P1Out at = p1_out();
    orow0 = at.row;
    pr = at.part;
    rows_out = at.rows;
  }
  for (int i = tid; i < rows_out * D; i += PNT) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < PNW; ++w)
      mx = fmaxf(mx, comb[(w * MAXG + g) * (D + 2) + D]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < PNW; ++w) {
      const float* cw = comb + (w * MAXG + g) * (D + 2);
      const float wt = exp2f(cw[D] - m_use);  // 0 for a warp with no position
      lsum += cw[D + 1] * wt;
      a += cw[d] * wt;
    }
    if (splits == 1) {
      o[orow0 * D + i] = from_float<T>(lsum == 0.f ? 0.f : a * (1.f / lsum));
    } else {
      float* pg = pr + g * (D + 2);
      pg[d] = a;
      if (d == 0) {
        pg[D] = mx;
        pg[D + 1] = lsum;
      }
    }
  }
}

// the launch bounds' least blocks an SM: f32 pools at D 80 and 96 (q and
// the rings: 123 and 147 KB of shared memory) hold one block an SM, so
// ptxas may give
// their kernels the SM's registers (at its default of 128 they spilled);
// so does every pool at D 256 (bf16 and f32 by shared memory; int8, whose
// 108 KB would hold two, for the registers of 8 columns a lane and query
// row); f32 pools at D 32 ask for two, the blocks that the splits count
// on (without bounds ptxas held their plain decode to 80 registers and
// spilled); every other instance keeps the bounds it was built with (0:
// none)
template <typename TK, int D>
struct P1MinBlocks {
  static constexpr int value =
      ((D == 80 || D == 96) && sizeof(TK) == 4) || D == 256 ? 1
      : D == 32 && sizeof(TK) == 4                          ? 2
                                                            : 0;
};

// the grouped kernels' least blocks an SM, so that ptxas budgets the
// registers the SM gives each block: the two that shared memory holds for
// bf16 and int8 pools; one for f32 pools, which serve the exactness checks
// (at D 96 and 128 their shared memory holds one; at D 64 the ring
// spilled at two)
template <typename TK, int D, int MODE>
struct P1GroupedMinBlocks {
  static constexpr int value =
      sizeof(TK) == 4 || D == 256 ||
              kSmSmem / (P1Smem<TK, D, MODE>::kBytes + 1024) < 2
          ? 1
          : 2;
};

// blocks an SM for the splits: one where the launch bounds ask for one
// (P1MinBlocks), else two where shared memory holds two, else one
template <typename TK, int D>
inline int p1_per_sm(int smem) {
  return P1MinBlocks<TK, D>::value != 1 && kSmSmem / (smem + 1024) >= 2
             ? 2
             : 1;
}

// the plain decode: every position below the length
template <typename T, typename TK, int D>
__global__ void __launch_bounds__(PNT, P1MinBlocks<TK, D>::value)
paged_decode_kernel(const T* __restrict__ q, const TK* __restrict__ kpool,
                    const TK* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    float* __restrict__ part, int H, int Hkv, int G,
                    int layer, int P, int page, int max_pages,
                    float scale_log2, int splits) {
  paged_decode_body<kModeFull, false, T, TK, D>(
      q, kpool, vpool, kscale, vscale, table, lengths, o, part, H, Hkv, G,
      layer, P, page, max_pages, scale_log2, splits, 0, 0, nullptr);
}

// window + sinks: positions < sinks and >= len - window (window > 0)
template <typename T, typename TK, int D>
__global__ void __launch_bounds__(PNT, P1MinBlocks<TK, D>::value)
paged_window_kernel(const T* __restrict__ q, const TK* __restrict__ kpool,
                    const TK* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    float* __restrict__ part, int H, int Hkv, int G,
                    int layer, int P, int page, int max_pages,
                    float scale_log2, int splits, int window, int sinks) {
  paged_decode_body<kModeWindow, false, T, TK, D>(
      q, kpool, vpool, kscale, vscale, table, lengths, o, part, H, Hkv, G,
      layer, P, page, max_pages, scale_log2, splits, window, sinks, nullptr);
}

// the ring: each slot's absolute position in meta (P, page)
template <typename T, typename TK, int D>
__global__ void __launch_bounds__(PNT, P1MinBlocks<TK, D>::value)
paged_ring_kernel(const T* __restrict__ q, const TK* __restrict__ kpool,
                  const TK* __restrict__ vpool,
                  const float* __restrict__ kscale,
                  const float* __restrict__ vscale,
                  const int* __restrict__ table,
                  const int* __restrict__ lengths, T* __restrict__ o,
                  float* __restrict__ part, int H, int Hkv, int G, int layer,
                  int P, int page, int max_pages, float scale_log2,
                  int splits, int window, int sinks,
                  const int* __restrict__ meta) {
  paged_decode_body<kModeRing, false, T, TK, D>(
      q, kpool, vpool, kscale, vscale, table, lengths, o, part, H, Hkv, G,
      layer, P, page, max_pages, scale_log2, splits, window, sinks, meta);
}

// past 8 query heads a kv head, each mode: the row groups' blocks (G: a
// block's rows; window and sinks read in window and ring mode, meta in
// ring mode)
template <int MODE, typename T, typename TK, int D>
__global__ void __launch_bounds__(PNT, P1GroupedMinBlocks<TK, D, MODE>::value)
paged_grouped_kernel(const T* __restrict__ q, const TK* __restrict__ kpool,
                     const TK* __restrict__ vpool,
                     const float* __restrict__ kscale,
                     const float* __restrict__ vscale,
                     const int* __restrict__ table,
                     const int* __restrict__ lengths, T* __restrict__ o,
                     float* __restrict__ part, int H, int Hkv, int G,
                     int layer, int P, int page, int max_pages,
                     float scale_log2, int splits, int window, int sinks,
                     const int* __restrict__ meta) {
  paged_decode_body<MODE, true, T, TK, D>(
      q, kpool, vpool, kscale, vscale, table, lengths, o, part, H, Hkv, G,
      layer, P, page, max_pages, scale_log2, splits, window, sinks, meta);
}

template <int MODE, bool GROUPED, typename T, typename TK, int D>
const void* p1_kernel() {
  if constexpr (GROUPED) {
    return (const void*)paged_grouped_kernel<MODE, T, TK, D>;
  } else if constexpr (MODE == kModeFull) {
    return (const void*)paged_decode_kernel<T, TK, D>;
  } else if constexpr (MODE == kModeWindow) {
    return (const void*)paged_window_kernel<T, TK, D>;
  } else {
    return (const void*)paged_ring_kernel<T, TK, D>;
  }
}

template <int MODE, typename T, typename TK, int D>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const float* ks, const float* vsc, const void* table,
                         const void* lengths, const int* meta, void* o,
                         void* part, int B, int H, int Hkv, int layer, int P,
                         int page, int max_pages, int window, int sinks,
                         float scale_log2, cudaStream_t stream) {
  constexpr int smem = P1Smem<TK, D, MODE>::kBytes;
  const int groups = p1_groups(H / Hkv);
  static const cudaError_t attr = cudaFuncSetAttribute(
      p1_kernel<MODE, false, T, TK, D>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static const cudaError_t attr_grouped = cudaFuncSetAttribute(
      p1_kernel<MODE, true, T, TK, D>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (attr_grouped != cudaSuccess) return attr_grouped;
  const int splits =
      p1_splits(B, Hkv, groups,
                p1_walk_tiles(MODE, page, max_pages, window, sinks),
                p1_per_sm<TK, D>(smem));
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(splits * groups, Hkv, B);
  const T* qt = static_cast<const T*>(q);
  const TK *kt = static_cast<const TK*>(kp), *vt = static_cast<const TK*>(vp);
  const int* tab = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  T* ot = static_cast<T*>(o);
  float* pt = static_cast<float*>(part);
  if (groups > 1) {  // past 8 query heads a kv head: the row groups
    paged_grouped_kernel<MODE, T, TK, D><<<grid, PNT, smem, stream>>>(
        qt, kt, vt, ks, vsc, tab, len, ot, pt, H, Hkv,
        p1_group_rows(H / Hkv), layer, P, page, max_pages, scale_log2,
        splits, window, sinks, meta);
  } else if constexpr (MODE == kModeFull) {
    paged_decode_kernel<T, TK, D><<<grid, PNT, smem, stream>>>(
        qt, kt, vt, ks, vsc, tab, len, ot, pt, H, Hkv, H / Hkv, layer, P,
        page, max_pages, scale_log2, splits);
  } else if constexpr (MODE == kModeWindow) {
    paged_window_kernel<T, TK, D><<<grid, PNT, smem, stream>>>(
        qt, kt, vt, ks, vsc, tab, len, ot, pt, H, Hkv, H / Hkv, layer, P,
        page, max_pages, scale_log2, splits, window, sinks);
  } else {
    paged_ring_kernel<T, TK, D><<<grid, PNT, smem, stream>>>(
        qt, kt, vt, ks, vsc, tab, len, ot, pt, H, Hkv, H / Hkv, layer, P,
        page, max_pages, scale_log2, splits, window, sinks, meta);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  paged_combine_kernel<T, D><<<dim3(B * Hkv, H / Hkv), D / 4, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(o), H, Hkv, 1, splits);
  return cudaGetLastError();
}

// the instance for (dtype, kv_dtype, D, mode): its dynamic shared memory
// (-1: none is built), blocks an SM for the splits and a warp's stages
struct P1Sizes {
  int smem, per_sm, stages;
};
template <int MODE>
P1Sizes p1_sizes(int dtype, int kv_dtype, int D) {
  const bool quant = kv_dtype == kI8;
#define CUBECL_P1_SIZES(TK, HD)                                    \
  P1Sizes{P1Smem<TK, HD, MODE>::kBytes,                            \
          p1_per_sm<TK, HD>(P1Smem<TK, HD, MODE>::kBytes),         \
          p1_stages<TK, HD>()}
#define CUBECL_P1_D(HD)                                            \
  if (D == HD)                                                     \
    return quant ? CUBECL_P1_SIZES(int8_t, HD)                     \
                 : dtype == kF32 ? CUBECL_P1_SIZES(float, HD)      \
                                 : CUBECL_P1_SIZES(__nv_bfloat16, HD);
  CUBECL_P1_D(32)
  CUBECL_P1_D(64)
  CUBECL_P1_D(80)
  CUBECL_P1_D(96)
  CUBECL_P1_D(128)
  CUBECL_P1_D(256)
#undef CUBECL_P1_D
#undef CUBECL_P1_SIZES
  return P1Sizes{-1, 0, 0};
}

// the mode of a call: the ring where meta is given, else window + sinks
// where window > 0 (sinks alone change nothing), else the plain decode
inline int p1_mode(int window, bool ring) {
  return ring ? kModeRing : window > 0 ? kModeWindow : kModeFull;
}

}  // namespace
}  // namespace cubecl

// q (B, H, D); k_pages/v_pages (L, Hkv, P, page, D); table (B, max_pages)
// int32; lengths (B,) int32; o (B, H, D). Contiguous; q and o of `dtype`
// (f32 or bf16), the pools of `kv_dtype`: the same dtype, or int8 with f32
// scale pools k_scales/v_scales (L, Hkv, P, page) (null otherwise). window
// > 0: attend only positions < sinks and >= lengths[b] - window (sinks are
// read only then). pos_meta (P, page) int32, or null: the ring, each
// slot's absolute position (-1: never written), masked by the window too.
// part: the splits' partial sums where the positions are split,
// cubecl_paged_decode_plan's plan[6] floats (null where that is 0).
// Any H that is a multiple of Hkv. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a dtype / head_dim (D 32, 64,
// 80, 96, 128 and 256 are built) this kernel was not built for.
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
