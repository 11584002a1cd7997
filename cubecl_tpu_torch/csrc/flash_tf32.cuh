// The 3xTF32 building blocks of the f32 flash bodies: the forward's
// flash_fwd_tf32x3_kernel (flash_attention.cu) and the backward's
// flash_bwd_dkv_tf32x3_kernel (flash_attention_bwd.cu).
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
// first), A_big B_small, A_big B_big; B's halves at descriptors bb, bs
template <int N>
__device__ __forceinline__ void tf32x3(float (&d)[N], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], uint64_t bb,
                                       uint64_t bs, bool first) {
  wgmma_tf32(d, as, bb, first ? 0 : 1);
  wgmma_tf32(d, ab, bs, 1);
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
template <int D>
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
      tf32x3(part, ab[st], as[st], step_desc(b_big + bp, st),
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
template <int C, int N>
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
      tf32x3(part, xb[kk], xs[kk], step_desc(b_big + bc, kk),
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

}  // namespace
}  // namespace cubecl
