// The 3xTF32 building blocks of the f32 flash bodies and of P3's f32 body:
// the forward's flash_fwd_tf32x3_kernel (flash_attention.cu), the
// backward's flash_bwd_dkv_tf32x3_kernel and flash_bwd_dq_tf32x3_kernel
// (flash_attention_bwd.cu) and paged_chunked_tf32x3_kernel
// (paged_chunked.cu).
//
// An f32 product runs on the tensor cores as three TF32 products (3xTF32,
// as csrc/wgmma_gemm.cuh's GEMM): each operand x is split into big = x
// truncated to tf32 and small = tf32(x - big) (hopper.cuh's tf32_split),
// and A_small B_big + A_big B_small + A_big B_big drops only A_small B_small
// (at most 2^-20 of a product). One
// TF32 product keeps about three decimal digits and misses f32's 2e-5 /
// 1e-4 against the plain version; three hold it. The tensor cores' f32
// sums round toward zero, so every group of products covers 32 terms of
// the reduction (four k8 steps, twelve products) summed from zero in
// `part`, which is then added to the f32 result by ordinary (round to
// nearest) additions, as wgmma_gemm_consume_tf32x3 does per stage.
//
// TF32 wgmma has no transpose bit: both operands are K-major. A body keeps
// three kinds of tile in shared memory, all f32 in panels of rows x 128
// bytes (32 values) with the 128-byte swizzle of hopper.cuh (the 16-byte
// chunks of row r XOR-permuted by r % 8), panels on 1024-byte boundaries:
//   - its own 64-row tile as it is (q for the forward, K and V for dK/dV):
//     the A operand of the score products, read by ldmatrix into the RS
//     fragment order and split in registers at each use (a_frag);
//   - a 32-row step of the streamed side split into a big and a small
//     tile, rows K-major over D (K for the forward, q or dO for dK/dV):
//     the B operand of the score products (stage_rows);
//   - a 32-row step transposed and split, one 128-byte row per column of
//     the streamed side (V for the forward, dO or q for dK/dV): the B
//     operand of the products that reduce over the step's rows
//     (stage_cols). Their A operand is the m64n32 score accumulator itself
//     (p or p^T, dS^T), split in registers (acc_frag): a thread's
//     accumulator holds columns 2t and 2t + 1 of each k8 slice where the
//     RS fragment wants columns t and t + 4, so the transposed tile stores
//     row 8a + j of the step at position 8a + kperm(j) of its k8 group,
//     and the reduction pairs them right with no shuffle.
#pragma once

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace cubecl {
namespace {

constexpr int kF32Threads = 128;  // one warpgroup a block
constexpr int kStep = 32;         // rows of the streamed side a step

// the byte offset of 16-byte chunk ch (0..7) of row r in a swizzled panel
__device__ __forceinline__ int sw_off(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

// the position of row j (0..7) of a k8 group in a transposed tile: rows
// 2t and 2t + 1 (one thread's pair of accumulator columns) at t and t + 4
__device__ __forceinline__ int kperm(int j) {
  return (j >> 1) | ((j & 1) << 2);
}

// a thread's 16-byte loads of a staged tile that are in flight at once:
// each batch's loads are issued before any of them is used (one at a time,
// every load's latency lay on the staging's path)
constexpr int kLoadBatch = 8;

// Rows r0 .. r0 + R - 1 (those at or past n: zeros) of an f32 matrix with
// rows ld apart, columns 0 .. C - 1, into C / 32 panels of R rows (panel p
// at p * R * 128 bytes): split into `big` and `small` where SPLIT, else as
// they are into `big`.
template <int R, int C, bool SPLIT>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int ld, int r0, int n,
                                           uint8_t* big, uint8_t* small) {
  constexpr int CH = C / 4;                     // 16-byte chunks a row
  constexpr int N = R * CH / kF32Threads;       // a thread's chunks
  constexpr int NB = N < kLoadBatch ? N : kLoadBatch;
  static_assert(N % NB == 0, "whole batches");
  // rolled: one batch's registers live at a time
#pragma unroll 1
  for (int b0 = 0; b0 < N; b0 += NB) {
    float4 x[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int i = threadIdx.x + (b0 + u) * kF32Threads;
      const int r = i / CH, ch = i % CH;
      x[u] = r0 + r < n ? __ldg(reinterpret_cast<const float4*>(
                              src + (int64_t)(r0 + r) * ld + 4 * ch))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int i = threadIdx.x + (b0 + u) * kF32Threads;
      const int r = i / CH, ch = i % CH;
      const int off = (ch / 8) * R * 128 + sw_off(r, ch % 8);
      if constexpr (SPLIT) {
        uint4 b, s;
        tf32_split4(*reinterpret_cast<const uint4*>(&x[u]), b, s);
        *reinterpret_cast<uint4*>(big + off) = b;
        *reinterpret_cast<uint4*>(small + off) = s;
      } else {
        *reinterpret_cast<float4*>(big + off) = x[u];
      }
    }
  }
}

// Rows r0 .. r0 + 31 (those at or past n: zeros) of an f32 matrix with rows
// ld apart, columns c0 .. c0 + C - 1, transposed into C rows of one panel
// (128 bytes: the step's 32 rows, permuted by kperm within each 8) and
// split into `big` and `small`. A warp's lanes take the step's 32 rows of
// one 4-column chunk, so that each store fills one panel row.
template <int C>
__device__ __forceinline__ void stage_cols(const float* __restrict__ src,
                                           int ld, int r0, int n, int c0,
                                           uint8_t* big, uint8_t* small) {
  constexpr int N = kStep * C / 4 / kF32Threads;  // a thread's chunks
  constexpr int NB = N < kLoadBatch ? N : kLoadBatch;
  static_assert(N % NB == 0, "whole batches");
  const int r = threadIdx.x % kStep;  // the same row in every chunk
  const int pos = (r & ~7) | kperm(r & 7);
  const bool in = r0 + r < n;
  const float* row = src + (int64_t)(r0 + r) * ld + c0;
  // rolled: one batch's registers live at a time
#pragma unroll 1
  for (int b0 = 0; b0 < N; b0 += NB) {
    float4 x[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int ch = (threadIdx.x + (b0 + u) * kF32Threads) / kStep;
      x[u] = in ? __ldg(reinterpret_cast<const float4*>(row + 4 * ch))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int ch = (threadIdx.x + (b0 + u) * kF32Threads) / kStep;
      const float xv[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = sw_off(4 * ch + e, pos / 4) + (pos % 4) * 4;
        uint32_t b, s;
        tf32_split(__float_as_uint(xv[e]), b, s);
        *reinterpret_cast<uint32_t*>(big + off) = b;
        *reinterpret_cast<uint32_t*>(small + off) = s;
      }
    }
  }
}

// The split RS fragment of k8 step s (0..3) of a 64-row panel at shared
// address `panel` (stage_rows<64, ., false>): ldmatrix.x4 of the step's
// 32-byte column gives a thread rows g, g + 8 and columns t, t + 4 (g =
// lane / 4, t = lane % 4 of the warp's 16 rows), one f32 a 32-bit word
__device__ __forceinline__ void a_frag(uint32_t panel, int s,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32) % 4 * 16 + (lane & 15);
  uint32_t r[4];
  ldsm_x4(r, panel + row * 128 + (((2 * s + (lane >> 4)) ^ (row & 7)) << 4));
#pragma unroll
  for (int j = 0; j < 4; ++j) tf32_split(r[j], big[j], small[j]);
}

// the split RS fragment of k8 slice kk (0..3) of an m64n32 accumulator
// (x[4 j + 2 i + e] at row g + 8 i, column 8 j + 2 t + e): columns 2t, 2t
// + 1 as the fragment's t, t + 4 (the transposed tiles' kperm)
__device__ __forceinline__ void acc_frag(const float (&x)[16], int kk,
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  tf32_split(__float_as_uint(x[4 * kk]), big[0], small[0]);
  tf32_split(__float_as_uint(x[4 * kk + 2]), big[1], small[1]);
  tf32_split(__float_as_uint(x[4 * kk + 1]), big[2], small[2]);
  tf32_split(__float_as_uint(x[4 * kk + 3]), big[3], small[3]);
}

// d (64 x 32, f32) (+)= A (64 x 8 tf32 in registers) . B (8 x 32 tf32,
// K-major in shared memory); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, "
      "%18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 8 tf32 in registers) . B (8 x 64 tf32,
// K-major in shared memory); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the three products of one k8 step: A_small B_big (overwriting d where
// first), A_big B_small, A_big B_big; B's halves at descriptors bb, bs.
// BX: B is exact in tf32 (int8 values), its small half zero and never
// staged: A_small B_big and A_big B_big only
template <int N, bool BX = false>
__device__ __forceinline__ void tf32x3(float (&d)[N], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], uint64_t bb,
                                       uint64_t bs, bool first) {
  wgmma_tf32(d, as, bb, first ? 0 : 1);
  if constexpr (!BX) wgmma_tf32(d, ab, bs, 1);
  wgmma_tf32(d, ab, bb, 1);
}

// a K-major descriptor of k8 step s of a panel (its rows 128 bytes apart,
// 8-row swizzle atoms 1024 bytes apart)
__device__ __forceinline__ uint64_t step_desc(uint32_t panel, int s) {
  return sw128_desc(panel + 32 * s, 16, 1024);
}

// s (64 x 32) = A B^T over D: A the block's 64-row tile as it is at a_s
// (D / 32 panels of 64 rows), B the step's 32 rows split at b_big and
// b_small (D / 32 panels of 32 rows); each panel's twelve products summed
// from zero, then added in f32
template <int D, bool BX = false>
__device__ __forceinline__ void scores(float (&s)[16], uint32_t a_s,
                                       uint32_t b_big, uint32_t b_small) {
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0.f;
  // the bases through an empty asm, so that the compiler makes each
  // step's addresses and descriptors beside its use and keeps none across
  // the caller's loops
  asm volatile("" : "+r"(a_s), "+r"(b_big), "+r"(b_small));
  // rolled: one panel's fragments live at a time
#pragma unroll 1
  for (int p = 0; p < D / 32; ++p) {
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) a_frag(a_s + p * 64 * 128, st, ab[st], as[st]);
    float part[16];
    const uint32_t bp = p * kStep * 128;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st)
      tf32x3<16, BX>(part, ab[st], as[st], step_desc(b_big + bp, st),
                     step_desc(b_small + bp, st), st == 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(part);
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] += part[j];
  }
}

// acc (64 x C as C / N column blocks of m64nN, N 32 or 64) += X . B over
// the step's 32 rows: X the m64n32 accumulator x (columns: the step's
// rows) in split RS fragments, B the step's C x 32 transposed tile split
// at b_big and b_small; each column block's twelve products summed from
// zero, then added in f32
template <int C, int N, bool BX = false>
__device__ __forceinline__ void accumulate(float (&acc)[C / N][N / 2],
                                           const float (&x)[16],
                                           uint32_t b_big, uint32_t b_small) {
  uint32_t xb[4][4], xs[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_frag(x, kk, xb[kk], xs[kk]);
  asm volatile("" : "+r"(b_big), "+r"(b_small));  // as in scores
#pragma unroll
  for (int c = 0; c < C / N; ++c) {
    float part[N / 2];
    const uint32_t bc = c * N * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tf32x3<N / 2, BX>(part, xb[kk], xs[kk], step_desc(b_big + bc, kk),
                        step_desc(b_small + bc, kk), kk == 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(part);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[c][j] += part[j];
  }
}

// this thread's rows r, r + 8 (r = its first row) of a 64 x C accumulator
// (C / N column blocks: acc[c][4 j + 2 i + e] at column N c + 8 j + col_l
// + e) times `mul[i]`, stored in f32 where the row is below r_end (rows ld
// floats apart)
template <int C, int N>
__device__ __forceinline__ void store_f32(
    float* __restrict__ dst, int ld, int r, int r_end, int col_l,
    const float (&acc)[C / N][N / 2], const float (&mul)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r + 8 * i;
    if (row >= r_end) continue;
#pragma unroll
    for (int c = 0; c < C / N; ++c)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<float2*>(dst + (int64_t)row * ld + N * c +
                                   8 * j + col_l) =
            make_float2(acc[c][4 * j + 2 * i] * mul[i],
                        acc[c][4 * j + 2 * i + 1] * mul[i]);
  }
}

// -- asynchronous staging: raw rows by cp.async, split once they land ------
//
// The bodies with a ring (the dQ body of flash_attention_bwd.cu, P3's f32
// body of paged_chunked.cu) copy each operand of a 32-row step (the step's
// K, its V) as it is into a raw slot of a ring of NR slots, NR operands
// ahead of the one in use: dQ's contiguous rows by every thread's 16-byte
// cp.async (copy_raw), P3's rows, each found through the table, by a bulk
// copy of the TMA unit a row issued by one warp (fill_rows), completing
// on the slot's mbarrier (each measured faster than the other's way on
// its body: PERF.md §6). When an operand has landed the block splits
// it from shared memory into the split tiles above (split_rows,
// split_cols) and runs its products while the next copies are in
// flight. A raw row is the operand's C values (f32, or int8 for
// P3's int8 pools) and 16 bytes more: with rows 16 bytes past a multiple
// of 128 apart, the 32 lanes of a warp that read 16 bytes each of one
// column chunk of 32 rows (split_cols) hit every bank once a 128 bytes.

constexpr int kRawPad = 16;

// the bytes from one raw row of C values of TK to the next
template <typename TK>
__host__ __device__ constexpr int raw_ld(int C) {
  return C * (int)sizeof(TK) + kRawPad;
}

// The raw slots of a body whose other shared memory takes `base` bytes
// (the 1 KB of alignment slack included) and whose slots take `slot` bytes
// each: as many, up to 3, as leave two blocks an SM (113 KB each), else as
// many as fit one block's 232,448 bytes; 0 where not even one fits
__host__ __device__ constexpr int raw_slots(int base, int slot) {
  constexpr int two = 115712, one = 232448;
  return (two - base) / slot >= 1
             ? ((two - base) / slot < 3 ? (two - base) / slot : 3)
             : ((one - base) / slot < 3 ? (one - base) / slot : 3);
}

// Rows r0 .. r0 + R - 1 of an f32 matrix (rows ld apart; columns from dc
// on, and rows at or past n, as zeros) into C / 32 panels of R rows as
// they are (stage_rows' layout), by NTH threads, plain loads: the block's
// own tiles, read once
template <int R, int C, int NTH>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int ld, int r0, int n, int dc,
                                          uint8_t* dst) {
  constexpr int CH = C / 4;
  const bool vec = ld % 4 == 0;  // 16-byte rows (the bases are aligned)
#pragma unroll 4
  for (int i = threadIdx.x; i < R * CH; i += NTH) {
    const int r = i / CH, ch = i % CH;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) {
      const float* p = src + (int64_t)(r0 + r) * ld + 4 * ch;
      if (vec && 4 * ch + 4 <= dc) {
        const float4 y = __ldg(reinterpret_cast<const float4*>(p));
        x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * ch + e < dc) x[e] = __ldg(p + e);
      }
    }
    *reinterpret_cast<float4*>(dst + (ch / 8) * R * 128 + sw_off(r, ch % 8)) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// Rows r0 .. r0 + 31 of an f32 matrix with C columns (rows ld apart, 16-byte
// aligned), those at or past n as zeros, into the raw slot at `slot` by
// cp.async (the caller commits the group), by NTH threads
template <int C, int NTH>
__device__ __forceinline__ void copy_raw(const float* __restrict__ src,
                                         int ld, int r0, int n,
                                         uint32_t slot) {
  constexpr int CH = C / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < kStep * CH; i += NTH) {
    const int r = i / CH, ch = i % CH;
    const bool ok = r0 + r < n;
    cp_async16_zfill(slot + r * raw_ld<float>(C) + 16 * ch,
                     src + (ok ? (int64_t)(r0 + r) * ld + 4 * ch : 0), ok);
  }
}

// one row of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory by the TMA unit's bulk copy, completing on
// the mbarrier `bar`
__device__ __forceinline__ void bulk_row(uint32_t dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The 32 rows of a raw slot (`ld` bytes apart), row `lane` from `src`
// (`bytes` of it, a multiple of 16) by the TMA unit, or zeros where src is
// null (past the range); called by one warp, whose lane 0 is the one
// arrival on `bar` and announces the bytes the copies complete there
__device__ __forceinline__ void fill_rows(uint32_t slot, int ld,
                                          const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const int lane = threadIdx.x % 32;
  const unsigned live = __ballot_sync(0xffffffffu, src != nullptr);
  if (lane == 0) mbar_expect_tx(bar, __popc(live) * bytes);
  __syncwarp();
  const uint32_t dst = slot + lane * ld;
  if (src != nullptr) {
    bulk_row(dst, src, bytes, bar);
  } else {
#pragma unroll 1
    for (uint32_t b = 0; b < bytes; b += 16)
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst + b),
                   "r"(0)
                   : "memory");
  }
}

// A raw slot's 32 rows of C values of TK into C / 32 panels of 32 rows,
// K-major over C (stage_rows' layout): f32 split into `big` and `small`,
// int8 as its exact f32 values into `big` alone (its small half is zero)
template <int C, typename TK, int NTH>
__device__ __forceinline__ void split_rows(const uint8_t* raw, uint8_t* big,
                                           uint8_t* small) {
  constexpr int CH = C * (int)sizeof(TK) / 16;  // raw chunks a row
#pragma unroll 2
  for (int i = threadIdx.x; i < kStep * CH; i += NTH) {
    const int r = i / CH, ch = i % CH;
    const uint4 x =
        *reinterpret_cast<const uint4*>(raw + r * raw_ld<TK>(C) + 16 * ch);
    if constexpr (sizeof(TK) == 4) {
      const int off = (ch / 8) * kStep * 128 + sw_off(r, ch % 8);
      uint4 b, s;
      tf32_split4(x, b, s);
      *reinterpret_cast<uint4*>(big + off) = b;
      *reinterpret_cast<uint4*>(small + off) = s;
    } else {
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float f[4];
        unpack_s8x4(w[k], f);
        const int oc = 4 * ch + k;  // the 4 values' chunk in the panels
        *reinterpret_cast<float4*>(big + (oc / 8) * kStep * 128 +
                                   sw_off(r, oc % 8)) =
            make_float4(f[0], f[1], f[2], f[3]);
      }
    }
  }
}

// A raw slot's 32 rows of C values of TK transposed into C rows of one
// panel (stage_cols' layout: the step's rows permuted by kperm within each
// 8): f32 split into `big` and `small`, int8 into `big` alone. A warp's
// lanes take the 32 rows of one 16-byte column chunk, so that each store
// fills one panel row.
template <int C, typename TK, int NTH>
__device__ __forceinline__ void split_cols(const uint8_t* raw, uint8_t* big,
                                           uint8_t* small) {
  constexpr int E = 16 / (int)sizeof(TK);  // values a chunk
  constexpr int CH = C / E;                // raw chunks a row
  const int r = threadIdx.x % kStep;
  const int pos = (r & ~7) | kperm(r & 7);
  const uint8_t* row = raw + r * raw_ld<TK>(C);
#pragma unroll 2
  for (int ch = threadIdx.x / kStep; ch < CH; ch += NTH / kStep) {
    const uint4 x = *reinterpret_cast<const uint4*>(row + 16 * ch);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(TK) == 4) {
        const int off = sw_off(4 * ch + k, pos / 4) + (pos % 4) * 4;
        uint32_t b, s;
        tf32_split(w[k], b, s);
        *reinterpret_cast<uint32_t*>(big + off) = b;
        *reinterpret_cast<uint32_t*>(small + off) = s;
      } else {
        float f[4];
        unpack_s8x4(w[k], f);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<float*>(
              big + sw_off(E * ch + 4 * k + e, pos / 4) + (pos % 4) * 4) =
              f[e];
      }
    }
  }
}

}  // namespace
}  // namespace cubecl
