// The body of P1 (paged decode attention) and its kernels, included by
// paged_attention.cu (the instances at the head dims of PAGED_HEAD_DIMS,
// whose design its header describes) and paged_ragged.cu (every other D up
// to 256, run in the next instance width up). Each .cu file is its own
// nvcc, so the two sets of instances build in parallel.
#pragma once

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
// x. RAGGED (paged_ragged.cu): the head dim is dr (any of 1..D), run in
// this instance's width D: q, the pools, o and part hold rows of dr
// elements; in shared memory a row keeps D's layout, its columns from dr
// on zero (never copied, never stored)
template <int MODE, bool GROUPED, typename T, typename TK, int D,
          bool RAGGED = false>
__device__ __forceinline__ void paged_decode_body(
    const T* __restrict__ q, const TK* __restrict__ kpool,
    const TK* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ o,
    float* __restrict__ part, int H, int Hkv, int G, int layer, int P,
    int page, int max_pages, float scale_log2, int splits, int window,
    int sinks, const int* __restrict__ meta, int dr = D) {
  using L = P1Smem<TK, D, MODE>;
  // the head dim of q, the pools, o and part (D itself unless RAGGED)
  const int DR = RAGGED ? dr : D;
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
                                   (H / Hkv) + g0) * (DR + 2);
  } else {
    orow0 = (int64_t)b * H + (int64_t)hk * G;
    pr = splits == 1 ? nullptr
                     : part + (((int64_t)b * Hkv + hk) * splits + split) * G *
                                  (DR + 2);
  }
  if constexpr (GROUPED) {
    if (tid == 0) p1_out() = P1Out{orow0, pr, live};
    if (n_tiles == 0) {  // no position: zeros (and an empty partial)
      for (int i = tid; i < live * (DR + 2); i += PNT) {
        if (splits == 1) {
          if (i < live * DR) o[orow0 * DR + i] = from_float<T>(0.f);
        } else {
          pr[i] = i % (DR + 2) == DR ? -INFINITY : 0.f;
        }
      }
      return;
    }
    if constexpr (RAGGED) {
      for (int i = tid; i < G * D; i += PNT) {
        const int g = i / D, d = i % D;
        qs[i] = g < live && d < dr ? to_float(q[(orow0 + g) * dr + d]) : 0.f;
      }
    } else {
      for (int i = tid; i < G * D; i += PNT)
        qs[i] = i < live * D ? to_float(q[orow0 * D + i]) : 0.f;
    }
  } else {
    if (n_tiles == 0) {  // no position: zeros (and an empty partial)
      for (int i = tid; i < G * (DR + 2); i += PNT) {
        if (splits == 1) {
          if (i < G * DR) o[orow0 * DR + i] = from_float<T>(0.f);
        } else {
          pr[i] = i % (DR + 2) == DR ? -INFINITY : 0.f;
        }
      }
      return;
    }
    if constexpr (RAGGED) {
      for (int i = tid; i < G * D; i += PNT) {
        const int d = i % D;
        qs[i] = d < dr ? to_float(q[(orow0 + i / D) * dr + d]) : 0.f;
      }
    } else {
      for (int i = tid; i < G * D; i += PNT)
        qs[i] = to_float(q[orow0 * D + i]);
    }
  }
  const int64_t head_page0 = ((int64_t)layer * Hkv + hk) * P;
  const int* tab = table + (int64_t)b * max_pages;

  const int p = lane / 4, quarter = lane % 4;  // score phase
  const int swz = D96   ? S96::shift(p)
                  : D80 ? S80::shift(p)
                        : (p & 1) * SWZ;
  uint8_t* ring = smem + L::kRing + warp * NS * L::kStage;
  const uint32_t ring_s = smem_addr(ring);
  if constexpr (RAGGED) {
    // the columns from dr on stay zero in every row slot of the ring (the
    // copies write the row's own bytes only), so q's zeros there meet
    // zeros, never a stale NaN of shared memory
    uint4* r4 = reinterpret_cast<uint4*>(ring);
    for (int i = lane; i < NS * L::kStage / 16; i += 32)
      r4[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

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
    if constexpr (RAGGED) {
      // the row's own rb bytes: its whole 16-byte chunks where rows are 16
      // bytes apart, else chunk by chunk in pieces of `unit` (copy_unit),
      // in a rolled loop for the rare head dims that need it. Both are
      // worked out here, from dr alone, so that no register holds them
      // across the tile loop
      const int rb = dr * (int)sizeof(TK);
      const int unit = copy_unit(rb, (int)sizeof(TK));
      const uint8_t* ksrc = reinterpret_cast<const uint8_t*>(kpool + row * dr);
      const uint8_t* vsrc = reinterpret_cast<const uint8_t*>(vpool + row * dr);
      if (unit == 16) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = c * 4 + quarter;
          if (j * 16 < rb) {
            cp_async16_zfill(kd + (j ^ swz) * 16, ksrc + j * 16, ok);
            cp_async16_zfill(kd + WR * L::kRow + (j ^ swz) * 16,
                             vsrc + j * 16, ok);
          }
        }
      } else {
#pragma unroll 1
        for (int j = quarter; j * 16 < rb; j += 4) {
          const uint32_t at = kd + (j ^ swz) * 16;
          const int nb = min(16, rb - j * 16);
          copy_chunk(at, ksrc + j * 16, nb, unit, ok);
          copy_chunk(at + WR * L::kRow, vsrc + j * 16, nb, unit, ok);
        }
      }
    } else {
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
  for (int i = tid; i < rows_out * DR; i += PNT) {
    const int g = i / DR, d = i % DR;
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
      o[orow0 * DR + i] = from_float<T>(lsum == 0.f ? 0.f : a * (1.f / lsum));
    } else {
      float* pg = pr + g * (DR + 2);
      pg[d] = a;
      if (d == 0) {
        pg[DR] = mx;
        pg[DR + 1] = lsum;
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
// (-1: none is built), blocks an SM for the splits and a warp's stages;
// a D up to 256 without an instance of its own takes its ragged width's
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
  if (D >= 1 && D < 256)
    return p1_sizes<MODE>(dtype, kv_dtype, paged_ragged_width(D));
  return P1Sizes{-1, 0, 0};
}

// the mode of a call: the ring where meta is given, else window + sinks
// where window > 0 (sinks alone change nothing), else the plain decode
inline int p1_mode(int window, bool ring) {
  return ring ? kModeRing : window > 0 ? kModeWindow : kModeFull;
}

}  // namespace
}  // namespace cubecl
