// Hopper (sm_90a) building blocks in inline PTX for the tensor-core kernels
// (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu, csrc/conv3x3.cu,
// csrc/paged_chunked.cu's bf16 body, csrc/wgmma_gemm.cuh, and the K0
// printer's cmma kernels, which include wgmma_gemm.cuh):
// mbarriers, TMA tensor copies, cp.async copies, the 128-byte-swizzle
// shared-memory descriptors of wgmma, the wgmma instructions themselves,
// the 3xTF32 split of an f32 operand and setmaxnreg; on the host, the
// tensor maps the copies read.
//
// Layout convention: a tile of 16-bit elements is stored as 64-column
// "panels", each rows x 128 bytes as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B (the 16-byte chunks of row r XOR-permuted by
// r % 8; 8 rows = one 1024-byte swizzle atom). Panels start on 1024-byte
// boundaries, so every descriptor's base offset is 0.
#pragma once

#include <cuda.h>  // CUtensorMap (the type only: no driver call is linked)
#include <stdint.h>

#include "common.cuh"

namespace cubecl {
namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
// make the initialised barriers visible to the other threads and to the
// asynchronous proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// the producer's arrival, announcing the bytes its copies will complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the barrier's phase of the given parity has completed. A wait
// that lasts some seconds (2^33 clocks at ~1.7 GHz) cannot be a slow copy:
// it is a schedule fault (producer and consumers walking different tiles),
// and it traps, so that the launch fails with an error instead of hanging
// the card. The loop is one block of PTX (labels are local to its braces):
// written as a C++ loop around __trap(), it cost the dK/dV consumers of
// flash_attention_bwd.cu their setmaxnreg headroom (ptxas allocated them
// ~180 of the 240 registers, spilled, and serialized their wgmma).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u64 t0, t1;\n"
      " mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " mov.u64 t1, %%clock64;\n"
      " sub.u64 t1, t1, t0;\n"
      " setp.gt.u64 p, t1, 8589934592;\n"
      " @p trap;\n"
      " bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// -- TMA -------------------------------------------------------------------

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// -- cp.async: 16 bytes a thread from global to shared memory, through L2
// (the K0 printer's pipelined cmma K loop) ---------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// the same, 16 bytes of zeros where !valid (nothing is read from src)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes (through L1), or 4 bytes of zeros where !valid
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// 8 bytes (through L1), or 8 bytes of zeros where !valid
__device__ __forceinline__ void cp_async8_zfill(uint32_t dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
// The widest copy that rows of `bytes` bytes, packed from a 16-byte
// aligned base, allow: 16, 8 or 4 (cp.async), else `elem`, the element
// size (plain loads: rows of an odd number of 2- or 1-byte elements)
__device__ __forceinline__ int copy_unit(int bytes, int elem) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : elem;
}
// The first nb (1..16) bytes of a 16-byte chunk of a row whose rows start
// `unit` bytes apart in alignment, below 16 (the callers copy whole chunks
// of 16-byte-aligned rows with cp_async16_zfill): 8 or 4, cp.async pieces
// of that size; 2 or 1, rows of an odd count of 2- or 1-byte elements,
// plain loads and stores of `unit` bytes, which a __syncwarp or
// __syncthreads orders before the readers, as it orders the copies' wait.
// Zeros where !valid, nothing read from src then. nb is a multiple of
// unit. The loops stay rolled: the path is for rare head dims, and the
// kernels' registers and build time are what an unrolled one would cost.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const uint8_t* src,
                                           int nb, int unit, bool valid) {
  if (unit == 8) {
#pragma unroll 1
    for (int b = 0; b < nb; b += 8) cp_async8_zfill(dst + b, src + b, valid);
  } else if (unit == 4) {
#pragma unroll 1
    for (int b = 0; b < nb; b += 4) cp_async4_zfill(dst + b, src + b, valid);
  } else if (unit == 2) {
#pragma unroll 1
    for (int b = 0; b < nb; b += 2) {
      const uint32_t x =
          valid ? *reinterpret_cast<const uint16_t*>(src + b) : 0u;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst + b), "r"(x)
                   : "memory");
    }
  } else {
#pragma unroll 1
    for (int b = 0; b < nb; ++b) {
      const uint32_t x = valid ? src[b] : 0u;
      asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(dst + b), "r"(x)
                   : "memory");
    }
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's cp.async groups but the newest N have completed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor for the 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
//   K-major operand (Q, K: the reduction runs along the 128-byte rows):
//     start = panel + 32 * (k16 step within the panel), SBO = 1024 (the
//     next 8 rows), LBO unused (1).
//   MN-major operand (V in P.V: the reduction runs down the rows):
//     start = panel + 2048 * k16 step (16 rows), SBO = 1024 (the next 8
//     rows of K), LBO = the stride of the next 64 columns (panel size).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// make this thread's shared-memory stores visible to wgmma's reads and
// TMA's writes (the async proxy), and its reads ordered before them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma region
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CUBECL_F8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define CUBECL_F32 \
  CUBECL_F8(0), CUBECL_F8(8), CUBECL_F8(16), CUBECL_F8(24)
#define CUBECL_R32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"

// d (64 x 64, f32) (+)= A (64 x 16 bf16, K-major in smem) . B (16 x 64 bf16,
// K-major in smem); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" CUBECL_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CUBECL_F32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 16 bf16, K-major in smem) . B (16 x 64
// bf16, MN-major in smem: the transpose bit); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_m64n64_tb(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" CUBECL_R32
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : CUBECL_F32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16 bf16 in registers) . B (16 x 64 bf16,
// MN-major in smem: the transpose bit)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" CUBECL_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CUBECL_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16 bf16 in registers) . B (16 x 128 bf16,
// MN-major in smem)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" CUBECL_R32
      ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : CUBECL_F32, CUBECL_F8(32), CUBECL_F8(40), CUBECL_F8(48),
        CUBECL_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef CUBECL_F8
#undef CUBECL_F32
#undef CUBECL_R32

// four 8 x 8 matrices of 16-bit elements from shared memory, one row
// address a lane (lanes 8 i .. 8 i + 7 give matrix i's rows)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// -- 3xTF32: an f32 operand as the sum of two tf32 values ------------------

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero),
// as the f32 bit pattern that a tf32 wgmma operand is: cvt.rna.tf32.f32's
// rounding (half a tf32 ulp added to the magnitude's bits, the 13 low bits
// cleared; an overflow rounds to infinity, as cvt.rna's does; an infinity
// stays one) in two integer instructions. Not for a NaN: the addition
// carries a NaN's mantissa into its exponent and sign (0x7fffffff, the
// NaN that CUDA's arithmetic returns, comes out as -0) or rounds it to
// infinity (0x7f800001).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// the split of x: big = x truncated to tf32 (its 13 low bits cleared) and
// small = tf32(x - big), x - big being exact in f32 and of x's sign; x =
// big + small to about 2^-22 of |x|. Truncation never leaves the finite
// range, so every finite x has a finite big and small, up to FLT_MAX (F12:
// big rounded to nearest took |x| >= (2 - 2^-11) 2^127 to infinity, x - big
// to -infinity and the cross terms to inf - inf = NaN, where the f32
// product is finite); it is also one instruction where rounding was two.
// Truncation leaves small up to one tf32 ulp of big instead of half of
// one, so the one dropped term A_small B_small is at most 2^-20 of a
// product: the emulation (tests/test_torch_matmul.py) keeps 3xTF32 as
// close to plain f32 as rounding did. A NaN's big is 0x7fffffff, a NaN to
// the tensor cores too (they read the 19 high bits only: truncated, a NaN
// whose mantissa is all in the 13 low bits, 0x7f800001, would be an
// infinity there). Where big is not finite (x an infinity or a NaN), x -
// big is NaN (0x7fffffff) and small -0. So an output whose row of A and
// column of B are finite is the f32 product to 3xTF32's precision; a NaN
// operand gives NaN wherever the f32 product does; an infinite operand
// gives NaN or an infinity of the f32 product's sign where that product
// is infinite (the cross terms inf . small are NaN where the other
// operand's small half is 0, a value that tf32 holds exactly, and an
// infinity of the other sign where that half's sign is not the value's).
// The guard is one compare and select a value: the split is a large share
// of the consumers' work (a finite-check on each half as well ran the
// 4096^3 GEMM 31% slower, PERF.md).
__device__ __forceinline__ void tf32_split(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  const float f = __uint_as_float(x);
  big = isnan(f) ? 0x7fffffffu : x & 0xffffe000u;
  small = tf32_rna(f - __uint_as_float(big));
}
// the split of four neighbouring values (a 16-byte chunk)
__device__ __forceinline__ void tf32_split4(const uint4& x, uint4& big,
                                            uint4& small) {
  tf32_split(x.x, big.x, small.x);
  tf32_split(x.y, big.y, small.y);
  tf32_split(x.z, big.z, small.z);
  tf32_split(x.w, big.w, small.w);
}

// -- registers -------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x by the special-function unit alone (ex2.approx.ftz: relative error
// about 2^-22; results below 2^-126 flush to 0, which an online softmax
// sum of at least 1 cannot see)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- tensor maps (host) ----------------------------------------------------

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (n, S, D) bf16 array as a 3-D tensor map of 64 x 64 boxes, 128-byte
// swizzle; rows past S (and whole boxes past it) read as zeros
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int D, int S,
                            int n) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cubecl
