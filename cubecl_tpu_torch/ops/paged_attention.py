"""Paged-KV attention: the attention of each decode step (P1/P2) and of a
chunk of C tokens per sequence (P3).

The KV cache is a stacked whole-model pool ``(L, Hkv, P, page, D)``; each
sequence owns a row of the block table ``page_indices`` (B, max_pages)
int32, which maps its position t to slot ``t % page`` of page
``page_indices[b, t // page]``. Query head h reads kv head h // (H // Hkv).
Table entries are clamped to ``[0, P)`` before they are read (the JAX
package's scale gather wraps -1 to the last page instead).

``paged_attention`` attends one query per head, q (B, H, D), to positions
``< lengths[b]`` of layer ``layer`` and returns (B, H, D) in q's dtype; a
row with no position to attend gets zeros. Its two StreamingLLM options, as
the JAX P1's: ``window > 0`` attends only the positions ``< sinks`` and
``>= lengths[b] - window`` (``sinks`` is read only then); ``pos_meta``
(P, page) int32, shared by every layer and kv head, makes the table a ring
whose slot ``(page_indices[b, i], j)`` holds absolute position
``pos_meta[page_indices[b, i], j]`` (-1 where nothing was written): a
position is live where that value is in ``[0, lengths[b])`` (and in the
window). A ring writes position t at table order ``<= t``, so only the
table-order slots ``< lengths[b]`` are read. ``paged_attention_chunked``
attends C queries per row, q (B, H, C, D): query token i of row b sits at
position
``starts[b] + i`` and attends the positions ``t <= starts[b] + i`` with
``t < lengths[b]`` (``lengths`` counts the chunk, whose K/V are already in
the pages); a row with no live position gets zeros.

int8 KV: the pools hold int8 values and ``k_scales`` / ``v_scales``
``(L, Hkv, P, page)`` one f32 scale per (token, head), as
:func:`quantize_kv` makes them; the value of a cached element is
``int8 * scale``.

On CUDA tensors ``paged_attention`` launches the hand-written kernel of
``csrc/paged_attention.cu`` (replaces the TPU kernels P1
``_paged_call_headed`` and P2 ``_paged_call_live``) and
``paged_attention_chunked`` that of ``csrc/paged_chunked.cu`` (replaces P3
``_paged_chunked_call``): q of f32 or bf16, pools of q's dtype or int8, any
D from 1 to 256 and any number of query heads a kv head. The head dims of
``PAGED_HEAD_DIMS`` (32, 64, 80, 96, 128, 256) are instances of their own
(D 32 is Pythia-31M's head dim, D 80 Phi-2's, D 96 Phi-3-mini's, their
pools unpadded, P3's bf16 tiles in D 64's or D 128's panels; D 256
GPT-J-6B's and Qwen3-Next's, where P1 keeps one stage a warp on f32 pools
and runs one block an SM, and P3's bf16 body holds four 64-column panels a
tile); every other D (MPT-30B's 112, ...) runs in the ragged instances of
the next width of 64, 128 and 256 (:func:`paged_width`; P1's in
``csrc/paged_ragged.cu``), the real D an argument: the pools, q and o stay
at the real D (no call copies or pads a pool), and the columns past it are
zeros in shared memory, never stored. Past 256 both raise (ROADMAP Queue
2a). P1 cuts a kv head's query heads into row
groups of at most 8, a block each (:func:`p1_group_rows`), splits the
positions of each (batch row, kv head) over blocks where B * Hkv * groups
leaves the card idle, copies K and V through the table with cp.async into
a ring per warp, and combines the splits in a second, small launch
(:func:`p1_plan`); with a window it walks only the tiles that hold a live
position (:func:`p1_window_tiles`). P3 runs bf16 q
(bf16 or int8 pools) on the tensor cores
(``wgmma``, cp.async staging through the table; decode-shaped chunks split
their positions over blocks and a second, small launch combines the
splits: :func:`p3_plan`) and f32 q on the CUDA cores. The caller keeps
``lengths`` within ``max_pages * page``: the kernels read it on the
device and do not check it. On CPU tensors each
runs its plain version, which is also the kernel's reference on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from ..utils import native
from .attention import KERNEL_DTYPES, LOG2E

# the head dims P1 and P3 have instances of their own for (flash is built
# at 64, 128 and 256; flash at 32 pads to 64, at 80 and 96 to 128; a paged
# pool is never padded); any other D up to PAGED_MAX_HEAD_DIM runs in the
# ragged instance of its paged_width
PAGED_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
PAGED_MAX_HEAD_DIM = 256
PAGED_RAGGED_WIDTHS = (64, 128, 256)


def paged_width(D: int) -> int:
    """The width of the instance that runs head dim ``D``: D itself where
    it has an instance, else the next of PAGED_RAGGED_WIDTHS (csrc
    ``paged_combine.cuh::paged_ragged_width``); past 256 a ValueError
    naming ROADMAP Queue 2a."""
    if D in PAGED_HEAD_DIMS:
        return D
    if not 1 <= D <= PAGED_MAX_HEAD_DIM:
        raise ValueError(f"P1 and P3 take head dims 1..{PAGED_MAX_HEAD_DIM} "
                         f"(D past {PAGED_MAX_HEAD_DIM}: ROADMAP Queue 2a); "
                         f"got D {D}")
    return next(w for w in PAGED_RAGGED_WIDTHS if D <= w)

# P1's body (csrc/paged_attention.cu), for p1_plan: 256 threads (8 warps)
# a block, at most 8 query rows a block (a row group; q in f32 ahead of the
# rings), 64-position tiles (8 positions a warp), a ring of 3 stages of K
# and V rows per warp (one stage on f32 pools at D 256: p1_stages); the
# positions of a (batch row, kv head) split over blocks until the grid, its
# row groups counted, fills the 132 SMs once at two blocks an SM (one where
# shared memory holds one or the launch bounds ask for one: p1_per_sm)
P1_GROUP_ROWS = 8  # csrc MAXG
P1_THREADS = 256
P1_TILE = 64
P1_STAGES = 3
P1_SMS = 132
P1_SM_SMEM = 233472  # shared memory of an SM (228 KB)


# P1's modes (the kernel it launches): every position below the length,
# window + sinks, the ring
P1_FULL, P1_WINDOW, P1_RING = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class P1Plan:
    """One call of P1: ``threads`` a block, dynamic shared memory
    ``smem_bytes``, the ``grid`` (splits * groups, Hkv, B), the position
    ``splits`` of a (batch row, kv head), the f32 ``scratch`` (floats)
    of the splits' partial sums, the ``mode`` (P1_FULL, P1_WINDOW,
    P1_RING), the row ``groups`` of a kv head's query heads (block x
    is split x // groups, row group x % groups) and the ``stages`` of a
    warp's ring: the arithmetic of csrc/paged_attention.cu's
    ``cubecl_paged_decode_plan``."""
    threads: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    splits: int
    scratch: int
    mode: int = P1_FULL
    groups: int = 1
    stages: int = P1_STAGES


def p1_group_rows(G: int, group: int):
    """The query rows [first, end) of a kv head's ``G`` that row group
    ``group`` holds: ceil(G / 8) groups of ceil(G / groups) rows, the last
    the rest, as the kernel cuts them (csrc ``p1_groups``,
    ``p1_group_rows``)."""
    groups = -(-G // P1_GROUP_ROWS)
    rows = -(-G // groups)
    return min(G, group * rows), min(G, (group + 1) * rows)


def p1_stages(kv_dtype, D: int) -> int:
    """The stages of a P1 warp's ring (csrc ``p1_stages``): 3, or 1 for f32
    pools at D 256, whose 16 KB stages would take 384 KB at 3 a warp and
    256 KB at 2."""
    return 1 if D == 256 and kv_dtype == torch.float32 else P1_STAGES


def p1_min_blocks(kv_dtype, D: int) -> int:
    """The least blocks an SM of P1's launch bounds (csrc
    ``P1MinBlocks``): one for f32 pools at D 80 and 96 and every pool at D
    256, two for f32 pools at D 32, else none (0)."""
    if D == 256 or (D in (80, 96) and kv_dtype == torch.float32):
        return 1
    return 2 if D == 32 and kv_dtype == torch.float32 else 0


def p1_per_sm(kv_dtype, D: int, smem: int) -> int:
    """P1's blocks an SM for the splits (csrc ``p1_per_sm``): one where
    the launch bounds ask for one, else two where shared memory holds two,
    else one."""
    return 2 if p1_min_blocks(kv_dtype, D) != 1 and \
        P1_SM_SMEM // (smem + 1024) >= 2 else 1


# cached: a decode step's host time is what its launches wait on
@functools.lru_cache(maxsize=256)
def p1_plan(dtype, kv_dtype, B: int, H: int, Hkv: int, D: int, page: int,
            max_pages: int, window: int = 0, sinks: int = 0,
            ring: bool = False) -> P1Plan:
    """P1's launch plan for q of ``dtype``, pools of ``kv_dtype`` and the
    options of the call (``ring``: a ``pos_meta`` is given)."""
    W = paged_width(D)  # the instance's width; raises past 256
    if dtype not in KERNEL_DTYPES or kv_dtype not in (dtype, torch.int8) \
            or Hkv <= 0 or H <= 0 or H % Hkv \
            or B <= 0 or window < 0 or sinks < 0:
        raise ValueError(f"P1 takes q of {KERNEL_DTYPES}, pools of q's "
                         f"dtype or int8, H a multiple of Hkv and a "
                         f"window and sinks >= 0; got {dtype}, {kv_dtype}, "
                         f"D {D}, H {H}, Hkv {Hkv}, window {window}, sinks "
                         f"{sinks}")
    # the ring where a pos_meta is given, else window + sinks where window
    # > 0 (sinks alone change nothing), else the full walk
    mode = P1_RING if ring else P1_WINDOW if window > 0 else P1_FULL
    warps = P1_THREADS // 32
    rows = P1_TILE // warps  # a warp's positions of a tile
    quant = kv_dtype == torch.int8
    # shared memory holds the instance's width; the scratch the real D
    stage = 2 * rows * W * (1 if quant else dtype.itemsize) + (
        2 * rows * 4 if quant else 0) + (rows * 4 if mode == P1_RING else 0)
    stages = p1_stages(kv_dtype, W)
    ring_bytes = warps * stages * stage
    comb = warps * P1_GROUP_ROWS * (W + 2) * 4  # the warps' (acc, m, l)
    smem = P1_GROUP_ROWS * W * 4 + max(ring_bytes, comb)
    per_sm = p1_per_sm(kv_dtype, W, smem)
    cap = page * max_pages
    tiles = max(1, -(-cap // P1_TILE))
    if mode == P1_WINDOW:  # the sinks' tiles and a window's, at most
        tiles = min(tiles, -(-min(sinks, cap) // P1_TILE)
                    + (window - 1) // P1_TILE + 2)
    groups = -(-(H // Hkv) // P1_GROUP_ROWS)
    splits = max(1, min(P1_SMS * per_sm // (B * Hkv * groups), tiles))
    scratch = B * H * splits * (D + 2) if splits > 1 else 0
    return P1Plan(P1_THREADS, smem, (splits * groups, Hkv, B), splits,
                  scratch, mode, groups, stages)


def p1_split_positions(plan: P1Plan, length: int, split: int):
    """The positions [first, end) of split ``split`` of a row of
    ``length`` under ``plan``: the row's ceil(length / 64) tiles shared out
    ceil(tiles / splits) a split, as the kernel cuts them on the device
    (the ring: ``length`` is min(lengths[b], the table's capacity), the
    table-order slots written)."""
    length = max(length, 0)
    tiles = -(-length // P1_TILE)
    per = -(-tiles // plan.splits)
    p0 = min(length, split * per * P1_TILE)
    return p0, min(length, p0 + per * P1_TILE)


def p1_window_tiles(plan: P1Plan, length: int, split: int, window: int,
                    sinks: int):
    """The tiles (first positions, in walk order) of split ``split`` of a
    row of ``length`` under a window-mode ``plan``: the row's live tiles,
    those of [0, min(sinks, length)) then those of [max(0, length -
    window), length) (one run where they meet), shared out ceil(live /
    splits) a split, as the kernel's ``WindowTiles`` cuts them."""
    length = max(length, 0)
    ta = -(-min(sinks, length) // P1_TILE)
    tb = max(0, length - window) // P1_TILE
    tl = -(-length // P1_TILE)
    sink_tiles, window_tile = (0, 0) if tb <= ta else (ta, tb)
    live = [*range(sink_tiles), *range(window_tile, tl)]
    per = -(-len(live) // plan.splits)
    return [t * P1_TILE for t in live[split * per:(split + 1) * per]]

# P3's bodies (csrc/paged_chunked.cu), for p3_plan. bf16 q on wgmma: one
# warpgroup a block owning 64 of the G*C rows, positions staged 64 a stage
# in a ring of 3 (K then V; int8 as raw rows, converted into one bf16 tile,
# with their scales); the positions split over blocks where one row tile
# a (b, kv head) makes fewer than P3_FILL blocks. A bf16 tile is 64 rows in
# 64-column panels (D 80 and 96: two, as D 128, the columns past D unused;
# D 32: one, as D 64; the pools are not padded; D 256: four, 230,400 bytes
# with bf16 pools). f32 q on the CUDA cores: 256 threads, a 64-row tile,
# the f32 tiles in shared memory.
P3_ROWS = 64
P3_COLS = 64
P3_STAGES = 3
P3_FILL = 264  # blocks that fill the H100's 132 SMs twice
P3_WG_THREADS = 128
P3_FMA_THREADS = 256


@dataclasses.dataclass(frozen=True)
class P3Plan:
    """One call of P3: its ``body`` ("wgmma" or "cuda-cores"), ``threads``
    a block, dynamic shared memory ``smem_bytes``, the ``grid``, the
    position ``splits`` of a row tile and the positions ``split_len`` of
    a split (a multiple of 64), and the f32 ``scratch`` (floats) of the
    splits' partial sums: the arithmetic of csrc/paged_chunked.cu's
    ``cubecl_paged_chunked_plan``."""
    body: str
    threads: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    splits: int
    split_len: int
    scratch: int


# cached: a call's host time is what the verify step's launches wait on
@functools.lru_cache(maxsize=256)
def p3_plan(dtype, kv_dtype, B: int, H: int, Hkv: int, C: int, D: int,
            page: int, max_pages: int) -> P3Plan:
    """P3's launch plan for q of ``dtype`` and pools of ``kv_dtype``."""
    quant = kv_dtype == torch.int8
    W = paged_width(D)  # the instance's width; raises past 256
    if kv_dtype not in (dtype, torch.int8) or H % Hkv or C <= 0:
        raise ValueError(f"P3 takes pools of q's dtype or int8; got "
                         f"{dtype}, {kv_dtype}, D {D}")
    GC = H // Hkv * C
    rows = -(-GC // P3_ROWS)
    if dtype == torch.float32:
        smem = (W * 64 * 3 + 64 * 68 + 2 * 64) * 4
        return P3Plan("cuda-cores", P3_FMA_THREADS, smem, (rows, Hkv, B), 1,
                      0, 0)
    if dtype != torch.bfloat16:
        raise ValueError(f"P3 takes q of {KERNEL_DTYPES}; got {dtype}")
    tile = -(-W // 64) * 64 * P3_ROWS * 2
    raw = P3_COLS * W if quant else tile
    smem = tile + P3_STAGES * 2 * raw + (2 * tile + P3_STAGES * 2 * P3_COLS
                                        * 4 if quant else 0) + 1024
    kv_tiles = max(1, -(-page * max_pages // P3_COLS))
    splits, split_len = 1, kv_tiles * P3_COLS
    base = rows * B * Hkv
    if rows == 1 and base < P3_FILL:
        per = max(1, kv_tiles // -(-P3_FILL // base))
        splits, split_len = -(-kv_tiles // per), per * P3_COLS
    scratch = B * Hkv * splits * GC * (D + 2) if splits > 1 else 0
    return P3Plan("wgmma", P3_WG_THREADS, smem, (rows * splits, Hkv, B),
                  splits, split_len, scratch)


def p3_block_positions(plan: P3Plan, C: int, G: int, start: int,
                       length: int, x: int):
    """The rows and positions of block ``x`` of a batch row (kv head
    alike) under ``plan``: (first row, end row, first position, end
    position) of the G*C rows, the positions cut at the tile's last live
    one, min(length, start + its last chunk token + 1)."""
    GC = G * C
    rows = -(-GC // P3_ROWS)
    r0 = (rows - 1 - x // plan.splits) * P3_ROWS
    r_end = min(r0 + P3_ROWS, GC)
    i_max = C - 1 if r_end - r0 >= C else max(r % C for r in
                                               range(r0, r_end))
    kv_end = min(length, start + i_max + 1)
    p0 = (x % plan.splits) * plan.split_len
    return r0, r_end, p0, max(p0, min(kv_end, p0 + plan.split_len))


def quantize_kv(x):
    """Symmetric int8 per (token, head) over the last axis: x (..., D)
    float -> (int8 values (..., D), f32 scales (...)); ``scale = amax /
    127`` (1 where amax is 0), values rounded half to even."""
    f = x.float()
    amax = f.abs().amax(-1)
    scales = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    return torch.round(f / scales[..., None]).to(torch.int8), scales


def _check_pools(k_pages, v_pages, k_scales, v_scales) -> bool:
    """Whether the pools are int8; raises on shapes that do not agree."""
    if k_pages.dim() != 5 or v_pages.shape != k_pages.shape:
        raise ValueError(f"want stacked pools (L, Hkv, P, page, D); got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    quant = k_scales is not None
    if quant != (k_pages.dtype == torch.int8) \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"int8 pools need scales and scales need int8 "
                         f"pools; got {k_pages.dtype}, {v_pages.dtype}, "
                         f"scales {'given' if quant else 'none'}")
    if quant and (k_scales.shape != k_pages.shape[:4]
                  or v_scales.shape != k_pages.shape[:4]):
        raise ValueError(f"want scales {tuple(k_pages.shape[:4])}; got "
                         f"{tuple(k_scales.shape)}, {tuple(v_scales.shape)}")
    return quant


def _check_table(B, page_indices, lengths, starts=None):
    if page_indices.dim() != 2 or page_indices.shape[0] != B \
            or tuple(lengths.shape) != (B,) \
            or (starts is not None and tuple(starts.shape) != (B,)):
        raise ValueError(f"want page_indices (B, max_pages) and lengths"
                         f"{', starts' if starts is not None else ''} (B,) "
                         f"for B={B}; got {tuple(page_indices.shape)}, "
                         f"{tuple(lengths.shape)}")


def _check_shapes(q, k_pages, v_pages, page_indices, lengths, k_scales,
                  v_scales) -> bool:
    if q.dim() != 3:
        raise ValueError(f"want q (B, H, D); got {tuple(q.shape)}")
    quant = _check_pools(k_pages, v_pages, k_scales, v_scales)
    B, H, D = q.shape
    if k_pages.shape[4] != D or H % k_pages.shape[1]:
        raise ValueError(f"pools {tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    _check_table(B, page_indices, lengths)
    return quant


def _check_chunk_shapes(q, k_pages, v_pages, page_indices, lengths, starts,
                        k_scales, v_scales) -> bool:
    if q.dim() != 4:
        raise ValueError(f"want q (B, H, C, D); got {tuple(q.shape)}")
    quant = _check_pools(k_pages, v_pages, k_scales, v_scales)
    B, H, _, D = q.shape
    if k_pages.shape[4] != D or H % k_pages.shape[1]:
        raise ValueError(f"pools {tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    _check_table(B, page_indices, lengths, starts)
    return quant


def _gather(pages, scales, layer: int, page_indices):
    """Layer ``layer``'s pages of every table row, as contiguous f32
    (B, Hkv, max_pages * page, D), dequantized where ``scales`` is given."""
    _, Hkv, P, page, D = pages.shape
    idx = page_indices.long().clamp(0, P - 1)
    B, S = idx.shape[0], idx.shape[1] * page
    x = pages[layer][:, idx].reshape(Hkv, B, S, D).transpose(0, 1).float()
    if scales is not None:
        s = scales[layer][:, idx].reshape(Hkv, B, S).transpose(0, 1)
        x = x * s.float()[..., None]
    return x


def _check_options(window, sinks, pos_meta, k_pages):
    if window < 0 or sinks < 0:
        raise ValueError(f"want window >= 0 and sinks >= 0; got {window}, "
                         f"{sinks}")
    if pos_meta is not None and (tuple(pos_meta.shape) != tuple(
            k_pages.shape[2:4]) or pos_meta.dtype != torch.int32):
        raise ValueError(f"want pos_meta (P, page) {tuple(k_pages.shape[2:4])}"
                         f" int32; got {tuple(pos_meta.shape)} "
                         f"{pos_meta.dtype}")


def _live(page_indices, lengths, S, window, sinks, pos_meta):
    """(B, S) bool: the table-order positions a row attends."""
    t = torch.arange(S, device=lengths.device)
    ln = lengths.long().view(-1, 1)
    if pos_meta is None:
        pos = t.expand(ln.shape[0], S)
        live = pos < ln
    else:   # the ring: absolute positions from the meta, slots < len read
        idx = page_indices.long().clamp(0, pos_meta.shape[0] - 1)
        pos = pos_meta[idx].reshape(ln.shape[0], S).long()
        live = (pos >= 0) & (pos < ln) & (t < ln)
    if window > 0:   # StreamingLLM: the sinks and the last `window`
        live = live & ((pos < sinks) | (pos >= ln - window))
    return live


def paged_attention_plain(q, k_pages, v_pages, page_indices, lengths,
                          sm_scale: Optional[float] = None, layer: int = 0,
                          k_scales=None, v_scales=None, window: int = 0,
                          sinks: int = 0, pos_meta=None):
    """Gathers the table's pages into contiguous (dequantized) K/V and
    runs masked softmax attention in f32."""
    _check_shapes(q, k_pages, v_pages, page_indices, lengths, k_scales,
                  v_scales)
    _check_options(window, sinks, pos_meta, k_pages)
    B, H, D = q.shape
    Hkv = k_pages.shape[1]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    k = _gather(k_pages, k_scales, layer, page_indices)
    v = _gather(v_pages, v_scales, layer, page_indices)
    S = k.shape[2]
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.matmul(qg, k.transpose(-1, -2)) * scale          # (B, Hkv, G, S)
    live = _live(page_indices, lengths, S, window, sinks, pos_meta)
    s = s.masked_fill(~live.view(B, 1, 1, S), float("-inf"))
    p = torch.softmax(s, dim=-1)
    # a row with no live position: zeros
    p = p.masked_fill(~live.any(-1).view(B, 1, 1, 1), 0.0)
    o = torch.matmul(p, v)
    return o.reshape(B, H, D).to(q.dtype)


def paged_attention_chunked_plain(q, k_pages, v_pages, page_indices, lengths,
                                  starts, sm_scale: Optional[float] = None,
                                  layer: int = 0, k_scales=None,
                                  v_scales=None):
    """Gathers the table's pages into contiguous (dequantized) K/V and
    runs softmax attention in f32 under the chunk's causal and length
    masks."""
    _check_chunk_shapes(q, k_pages, v_pages, page_indices, lengths, starts,
                        k_scales, v_scales)
    B, H, C, D = q.shape
    Hkv = k_pages.shape[1]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    k = _gather(k_pages, k_scales, layer, page_indices)
    v = _gather(v_pages, v_scales, layer, page_indices)
    S = k.shape[2]
    qg = q.reshape(B, Hkv, G * C, D).float()                # row g * C + i
    s = torch.matmul(qg, k.transpose(-1, -2)) * scale      # (B, Hkv, GC, S)
    t = torch.arange(S, device=q.device)
    qpos = starts.long().view(B, 1) + torch.arange(C, device=q.device)
    live = (t <= qpos[..., None]) & (t < lengths.long().view(B, 1, 1))
    live = live.view(B, 1, 1, C, S)                         # (B, ., G, C, S)
    s = s.view(B, Hkv, G, C, S).masked_fill(~live, float("-inf"))
    p = torch.softmax(s, dim=-1).masked_fill(~live.any(-1, keepdim=True), 0.0)
    o = torch.matmul(p.view(B, Hkv, G * C, S), v)
    return o.view(B, H, C, D).to(q.dtype)


def _check_kernel_inputs(what, q, k_pages, v_pages, ints, scales, quant):
    tensors = (q, k_pages, v_pages, *ints, *scales)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: the kernel wants every tensor on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    if q.dtype not in KERNEL_DTYPES or k_pages.dtype not in (q.dtype,
                                                             torch.int8):
        raise ValueError(f"{what} kernel takes q of one dtype of "
                         f"{KERNEL_DTYPES} and pools of q's dtype or int8; "
                         f"got {q.dtype}, {k_pages.dtype}")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{what} kernel wants int32 page_indices, lengths "
                         "and starts")
    if quant and any(s.dtype != torch.float32 or not s.is_contiguous()
                     for s in scales):
        raise ValueError(f"{what} kernel wants contiguous f32 scales")
    if not 1 <= q.shape[-1] <= PAGED_MAX_HEAD_DIM:
        raise ValueError(f"{what} kernel takes head_dim 1.."
                         f"{PAGED_MAX_HEAD_DIM} (past it: ROADMAP Queue 2a); "
                         f"got {q.shape[-1]}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{what} kernel wants contiguous pools")


def _layer_in(layer, L):
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")


def _ptr(t):
    return None if t is None else t.data_ptr()


def paged_attention(q, k_pages, v_pages, page_indices, lengths,
                    sm_scale: Optional[float] = None, layer: int = 0,
                    k_scales=None, v_scales=None, window: int = 0,
                    sinks: int = 0, pos_meta=None):
    """Paged decode attention; see the module docstring. P1 has no
    backward: under autograd this raises, on either device."""
    native.refuse_grad("paged_attention (P1)", "paged_attention_plain", q,
                       k_pages, v_pages, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_indices,
                                     lengths, sm_scale, layer, k_scales,
                                     v_scales, window, sinks, pos_meta)
    quant = _check_shapes(q, k_pages, v_pages, page_indices, lengths,
                          k_scales, v_scales)
    _check_options(window, sinks, pos_meta, k_pages)
    scales = (k_scales, v_scales) if quant else ()
    if pos_meta is not None:
        pos_meta = pos_meta.contiguous()
    ints = (page_indices, lengths) if pos_meta is None \
        else (page_indices, lengths, pos_meta)
    _check_kernel_inputs("paged_attention", q, k_pages, v_pages, ints,
                         scales, quant)
    B, H, D = q.shape
    L, Hkv, P, page, _ = k_pages.shape
    _layer_in(layer, L)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q = q.contiguous()
    page_indices, lengths = page_indices.contiguous(), lengths.contiguous()
    native.check_aligned(q, k_pages, v_pages)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = native.kernels()
    plan = p1_plan(q.dtype, k_pages.dtype, B, H, Hkv, D, page,
                   page_indices.shape[1], window, sinks, pos_meta is not None)
    with torch.cuda.device(q.device):
        # the splits' partial sums, combined by the call's second launch
        part = torch.empty(plan.scratch, device=q.device) \
            if plan.scratch else None
        rc = lib.cubecl_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scales), _ptr(v_scales), page_indices.data_ptr(),
            lengths.data_ptr(), _ptr(pos_meta), o.data_ptr(), _ptr(part),
            native.DTYPE_CODES[q.dtype], native.DTYPE_CODES[k_pages.dtype],
            B, H, Hkv, D, layer, P, page, page_indices.shape[1], window,
            sinks, scale * LOG2E, torch.cuda.current_stream().cuda_stream)
    native.check(lib, rc, "paged_attention")
    paged_attention.launches += 1
    if quant:
        paged_attention.int8_launches += 1
    if plan.mode == P1_WINDOW:
        paged_attention.window_launches += 1
    elif plan.mode == P1_RING:
        paged_attention.ring_launches += 1
    if plan.groups > 1:
        paged_attention.grouped_launches += 1
    if D not in PAGED_HEAD_DIMS:
        paged_attention.ragged_launches += 1
    return o


paged_attention.launches = 0
# among them: the launches on int8 pools, with a window (no ring), on a
# ring, with more than 8 query heads a kv head (row groups), at a head dim
# without an instance of its own (the ragged instances)
paged_attention.int8_launches = 0
paged_attention.window_launches = 0
paged_attention.ring_launches = 0
paged_attention.grouped_launches = 0
paged_attention.ragged_launches = 0


def paged_attention_chunked(q, k_pages, v_pages, page_indices, lengths,
                            starts, sm_scale: Optional[float] = None,
                            layer: int = 0, k_scales=None, v_scales=None):
    """Chunked paged attention; see the module docstring. P3 has no
    backward: under autograd this raises, on either device."""
    native.refuse_grad("paged_attention_chunked (P3)",
                       "paged_attention_chunked_plain", q, k_pages, v_pages,
                       k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_attention_chunked_plain(
            q, k_pages, v_pages, page_indices, lengths, starts, sm_scale,
            layer, k_scales, v_scales)
    quant = _check_chunk_shapes(q, k_pages, v_pages, page_indices, lengths,
                                starts, k_scales, v_scales)
    scales = (k_scales, v_scales) if quant else ()
    _check_kernel_inputs("paged_attention_chunked", q, k_pages, v_pages,
                         (page_indices, lengths, starts), scales, quant)
    B, H, C, D = q.shape
    L, Hkv, P, page, _ = k_pages.shape
    _layer_in(layer, L)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q = q.contiguous()
    page_indices, lengths, starts = (t.contiguous() for t in
                                     (page_indices, lengths, starts))
    native.check_aligned(q, k_pages, v_pages)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = native.kernels()
    plan = p3_plan(q.dtype, k_pages.dtype, B, H, Hkv, C, D, page,
                   page_indices.shape[1])
    with torch.cuda.device(q.device):
        # the splits' partial sums, combined by the call's second launch
        part = torch.empty(plan.scratch, device=q.device) \
            if plan.scratch else None
        rc = lib.cubecl_paged_chunked(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scales), _ptr(v_scales), page_indices.data_ptr(),
            lengths.data_ptr(), starts.data_ptr(), o.data_ptr(), _ptr(part),
            native.DTYPE_CODES[q.dtype], native.DTYPE_CODES[k_pages.dtype],
            B, H, Hkv, C, D, layer, P, page, page_indices.shape[1],
            scale * LOG2E, torch.cuda.current_stream().cuda_stream)
    native.check(lib, rc, "paged_attention_chunked")
    paged_attention_chunked.launches += 1
    if D not in PAGED_HEAD_DIMS:
        paged_attention_chunked.ragged_launches += 1
    return o


paged_attention_chunked.launches = 0
# among them: the launches at a head dim without an instance of its own
paged_attention_chunked.ragged_launches = 0


def p1_kernel_plan(dtype, kv_dtype, B: int, H: int, Hkv: int, D: int,
                   page: int, max_pages: int, window: int = 0,
                   sinks: int = 0, ring: bool = False) -> P1Plan:
    """The built P1's launch plan (``cubecl_paged_decode_plan``): what
    :func:`p1_plan` must equal (builds the CUDA kernels on first use)."""
    lib = native.kernels()
    plan = (ctypes.c_int * 10)()
    rc = lib.cubecl_paged_decode_plan(
        native.DTYPE_CODES[dtype], native.DTYPE_CODES[kv_dtype], B, H, Hkv,
        D, page, max_pages, window, sinks, int(ring),
        ctypes.cast(plan, ctypes.c_void_p))
    native.check(lib, rc, "paged_decode_plan")
    return P1Plan(plan[0], plan[1], (plan[2], plan[3], plan[4]), plan[5],
                  plan[6], plan[7], plan[8], plan[9])


def p3_kernel_plan(dtype, kv_dtype, B: int, H: int, Hkv: int, C: int,
                   D: int, page: int, max_pages: int) -> P3Plan:
    """The built P3's launch plan (``cubecl_paged_chunked_plan``): what
    :func:`p3_plan` must equal (builds the CUDA kernels on first use)."""
    lib = native.kernels()
    plan = (ctypes.c_int * 9)()
    rc = lib.cubecl_paged_chunked_plan(
        native.DTYPE_CODES[dtype], native.DTYPE_CODES[kv_dtype], B, H, Hkv,
        C, D, page, max_pages, ctypes.cast(plan, ctypes.c_void_p))
    native.check(lib, rc, "paged_chunked_plan")
    return P3Plan("wgmma" if plan[0] else "cuda-cores", plan[1], plan[2],
                  (plan[3], plan[4], plan[5]), plan[6], plan[7], plan[8])
