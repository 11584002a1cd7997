// P1 (paged decode attention) at every head dim up to 256 that has no
// instance of its own: the body of paged_decode.cuh in the next of the
// widths 64, 128 and 256 (DP), with the real head dim dr as an argument.
// Replaces the same TPU kernels as paged_attention.cu (P1
// _paged_call_headed and P2 _paged_call_live of
// cubecl_tpu/ops/paged_attention.py, which take any head dim).
//
// The pools stay (L, Hkv, P, page, dr): a decode step copies no pool and
// pads none, since that would be a copy of the whole cache every step.
// In shared memory a K/V row keeps DP's layout (its 16-byte chunks and
// their swizzle); the copies write the row's own dr columns and the
// columns from dr to DP stay the zeros the block wrote once at its start,
// so q's zeros there meet zeros. A row of dr elements is no whole number
// of 16-byte chunks when dr * size is not a multiple of 16 (bf16 dr % 8,
// int8 dr % 16, f32 dr % 4), and then rows do not start 16 bytes apart
// either: the copies take the widest piece that the rows' alignment
// allows (cp.async of 16, 8 or 4 bytes, its source size 0 past the end;
// for rows of an odd number of bf16 or of int8 elements, plain loads and
// stores), and never read into the next row. int8 scales ride the rows
// as at the exact widths (a row's scale multiplies its score column, so
// no dequantized column is formed). q, o and the splits' partials (dr + 2
// floats a row, combined by paged_combine_ragged_kernel) are read and
// written at dr.
//
// Bound as the exact instances: the K/V bytes of the live positions,
// which are dr's, not DP's; the products over DP's columns (at most 2x at
// dr 65, the CUDA cores' share of the work) are not the bound. One kernel
// template for every mode and the row groups, 72 instances, in a file of
// its own so that nvcc builds them beside paged_attention.cu's.
#include "paged_decode.cuh"

namespace cubecl {
namespace {

// the least blocks an SM of the launch bounds: the grouped kernels' as at
// the exact widths; the others' the blocks an SM that the splits count on
// (p1_per_sm: one where the width's bounds ask for one or shared memory
// holds one, else two). Without them ptxas held three of these kernels to
// 80 or 128 registers and spilled
template <int MODE, bool GROUPED, typename TK, int DP>
struct P1RaggedMinBlocks {
  static constexpr int value =
      GROUPED ? P1GroupedMinBlocks<TK, DP, MODE>::value
      : P1MinBlocks<TK, DP>::value == 1 ||
              kSmSmem / (P1Smem<TK, DP, MODE>::kBytes + 1024) < 2
          ? 1
          : 2;
};

template <int MODE, bool GROUPED, typename T, typename TK, int DP>
__global__ void __launch_bounds__(
    PNT, P1RaggedMinBlocks<MODE, GROUPED, TK, DP>::value)
paged_ragged_kernel(const T* __restrict__ q, const TK* __restrict__ kpool,
                    const TK* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    float* __restrict__ part, int H, int Hkv, int G,
                    int layer, int P, int page, int max_pages,
                    float scale_log2, int splits, int window, int sinks,
                    const int* __restrict__ meta, int dr) {
  paged_decode_body<MODE, GROUPED, T, TK, DP, true>(
      q, kpool, vpool, kscale, vscale, table, lengths, o, part, H, Hkv, G,
      layer, P, page, max_pages, scale_log2, splits, window, sinks, meta, dr);
}

template <int MODE, typename T, typename TK, int DP>
cudaError_t launch_ragged(const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vsc,
                          const void* table, const void* lengths,
                          const int* meta, void* o, void* part, int B, int H,
                          int Hkv, int dr, int layer, int P, int page,
                          int max_pages, int window, int sinks,
                          float scale_log2, cudaStream_t stream) {
  constexpr int smem = P1Smem<TK, DP, MODE>::kBytes;
  const int groups = p1_groups(H / Hkv);
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_ragged_kernel<MODE, false, T, TK, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static const cudaError_t attr_grouped = cudaFuncSetAttribute(
      paged_ragged_kernel<MODE, true, T, TK, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (attr_grouped != cudaSuccess) return attr_grouped;
  const int splits =
      p1_splits(B, Hkv, groups,
                p1_walk_tiles(MODE, page, max_pages, window, sinks),
                p1_per_sm<TK, DP>(smem));
  if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(splits * groups, Hkv, B);
  const T* qt = static_cast<const T*>(q);
  const TK *kt = static_cast<const TK*>(kp), *vt = static_cast<const TK*>(vp);
  const int* tab = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  T* ot = static_cast<T*>(o);
  float* pt = static_cast<float*>(part);
  if (groups > 1)  // past 8 query heads a kv head: the row groups
    paged_ragged_kernel<MODE, true, T, TK, DP><<<grid, PNT, smem, stream>>>(
        qt, kt, vt, ks, vsc, tab, len, ot, pt, H, Hkv,
        p1_group_rows(H / Hkv), layer, P, page, max_pages, scale_log2,
        splits, window, sinks, meta, dr);
  else
    paged_ragged_kernel<MODE, false, T, TK, DP><<<grid, PNT, smem, stream>>>(
        qt, kt, vt, ks, vsc, tab, len, ot, pt, H, Hkv, H / Hkv, layer, P,
        page, max_pages, scale_log2, splits, window, sinks, meta, dr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  paged_combine_ragged_kernel<T, DP>
      <<<dim3(B * Hkv, H / Hkv), DP / 4, 0, stream>>>(
          static_cast<const float*>(part), ot, H, Hkv, 1, splits, dr);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cubecl

// cubecl_paged_decode's arguments (which see), for a D from 1 to 255 that
// has no instance of its own; cudaErrorInvalidValue for any other
extern "C" int cubecl_paged_decode_ragged(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const void* table,
    const void* lengths, const int* pos_meta, void* o, void* part, int dtype,
    int kv_dtype, int B, int H, int Hkv, int D, int layer, int P, int page,
    int max_pages, int window, int sinks, float scale_log2, void* stream) {
  using namespace cubecl;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H <= 0 || H % Hkv != 0 || D < 1 || D >= 256 ||
      window < 0 || sinks < 0)
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == kI8;
  if (quant != (k_scales != nullptr && v_scales != nullptr))
    return cudaErrorInvalidValue;
  if (!quant && kv_dtype != dtype) return cudaErrorInvalidValue;
  const int mode = p1_mode(window, pos_meta != nullptr);
  const int DP = paged_ragged_width(D);
#define CUBECL_RAGGED_MODE(M, T, TK, W)                                      \
  launch_ragged<M, T, TK, W>(q, k_pages, v_pages, k_scales, v_scales, table, \
                             lengths, pos_meta, o, part, B, H, Hkv, D, layer, \
                             P, page, max_pages, window, sinks, scale_log2,  \
                             st)
#define CUBECL_RAGGED_W(T, TK, W)                                            \
  (mode == kModeFull     ? CUBECL_RAGGED_MODE(kModeFull, T, TK, W)           \
   : mode == kModeWindow ? CUBECL_RAGGED_MODE(kModeWindow, T, TK, W)         \
                         : CUBECL_RAGGED_MODE(kModeRing, T, TK, W))
#define CUBECL_RAGGED(T, TK)                                                 \
  (DP == 64    ? CUBECL_RAGGED_W(T, TK, 64)                                  \
   : DP == 128 ? CUBECL_RAGGED_W(T, TK, 128)                                 \
               : CUBECL_RAGGED_W(T, TK, 256))
  if (dtype == kF32)
    return quant ? CUBECL_RAGGED(float, int8_t) : CUBECL_RAGGED(float, float);
  if (dtype == kBF16)
    return quant ? CUBECL_RAGGED(__nv_bfloat16, int8_t)
                 : CUBECL_RAGGED(__nv_bfloat16, __nv_bfloat16);
#undef CUBECL_RAGGED
#undef CUBECL_RAGGED_W
#undef CUBECL_RAGGED_MODE
  return cudaErrorInvalidValue;
}
