"""Paged attention at head dim 96 (Phi-3-mini's) in cubecl_tpu_torch against
cubecl_tpu: P1 (every position, window + sinks, the ring, int8 pools,
stacked layers, the split over positions and its combine), P3 (the verify
and prefill shapes, its split), both launch plans at D 96 and the refusal
of a head dim without an instance, and the llama at head dim 96 served
through ``decode_step``, ``decode_chunk``, ``prefill_chunked``,
``speculative_generate``, ``beam_generate``, an int8 cache and
StreamingLLM's window and ring.

The port runs its plain versions on these CPU tensors (on the card D 96
launches the D 96 instances of csrc/paged_attention.cu and
csrc/paged_chunked.cu, held to the plain versions by
tests/test_torch_cuda.py); the JAX kernels run in Pallas interpret mode,
on stacked pools (the JAX ring takes layer 1's pool alone). f32
tolerances, summation order only: the kernels atol 2e-5 / rtol 1e-4, the
model's logits atol 3e-5 / rtol 1e-4 (tests/test_torch_serving.py's).
int8 pools given to both sides as the same values and scales take the
kernels' tolerance; the model's int8 cache, quantized from slightly other
f32 numbers on each side, atol 0.02 (tests/test_torch_serving.py's).
Greedy tokens equal.
"""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.ops.paged_attention import (
    P1_RING,
    P1_TILE,
    P1_WINDOW,
    PAGED_HEAD_DIMS,
    paged_width,
    P1Plan,
    p1_plan,
    p1_split_positions,
    p1_window_tiles,
    p3_block_positions,
    p3_plan,
    paged_attention,
    paged_attention_chunked,
    quantize_kv,
)

jax_paged = importlib.import_module("cubecl_tpu.ops.paged_attention")

ATOL, RTOL = 2e-5, 1e-4
LOGIT_ATOL, LOGIT_RTOL = 3e-5, 1e-4
INT8_ATOL = 0.02
D = 96
B, H, HKV = 5, 4, 2
L, P, PAGE, MAX_PAGES = 2, 48, 8, 8
# a length-0 row, mid-page, the full capacity, one position, past a tile
LENGTHS = np.array([0, 13, 64, 1, 41], np.int32)


@pytest.fixture(scope="module")
def pools():
    """q, f32 pools, int8 pools with their scales (quantize_kv of the f32
    ones), and a table whose rows own disjoint pages (as a ring's do)."""
    rng = np.random.default_rng(96)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    vp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    (k8, ks), (v8, vs) = (quantize_kv(torch.from_numpy(x)) for x in (kp, vp))
    table = rng.permutation(P)[:B * MAX_PAGES].reshape(B, MAX_PAGES)
    return dict(q=q, f32=(kp, vp, None, None),
                int8=tuple(t.numpy() for t in (k8, v8, ks, vs)),
                table=table.astype(np.int32))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port(pools, kv, lengths, **kw):
    kp, vp, ks, vs = pools[kv]
    return paged_attention(_t(pools["q"]), _t(kp), _t(vp),
                           _t(pools["table"]), _t(lengths), k_scales=_t(ks),
                           v_scales=_t(vs), **kw).numpy()


def _jax(pools, kv, lengths, layer=None, **kw):
    """The JAX P1 on the stacked pools (``layer``) or, for a ring, on
    layer 1's pool."""
    kp, vp, ks, vs = pools[kv]
    if layer is None:
        kp, vp = kp[1], vp[1]
        ks, vs = (None, None) if ks is None else (ks[1], vs[1])
    else:
        kw["layer"] = layer
    return np.asarray(jax_paged.paged_attention(
        _j(pools["q"]), _j(kp), _j(vp), _j(pools["table"]), _j(lengths),
        k_scales=_j(ks), v_scales=_j(vs), interpret=True, **kw))


# -- P1 -----------------------------------------------------------------------

@pytest.mark.parametrize("dynamic_grid", [True, False], ids=["P2", "P1"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_decode_matches_jax_kernel(pools, kv, dynamic_grid):
    """Every position below the length, layer 1 of the stacked pools, on
    both of the JAX kernel's grids; a length-0 row's zeros."""
    ref = _jax(pools, kv, LENGTHS, layer=1, dynamic_grid=dynamic_grid)
    got = _port(pools, kv, LENGTHS, layer=1)
    assert got.shape == (B, H, D)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert not got[LENGTHS == 0].any()


def test_decode_scale_and_layer(pools):
    """An explicit sm_scale on layer 0 against the JAX static grid."""
    ref = _jax(pools, "f32", LENGTHS, layer=0, sm_scale=0.2,
               dynamic_grid=False)
    np.testing.assert_allclose(_port(pools, "f32", LENGTHS, layer=0,
                                     sm_scale=0.2), ref, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("window,sinks", [(6, 3), (20, 9)],
                         ids=["w6-s3", "w20-s9"])
def test_windowed_matches_jax_kernel(pools, kv, window, sinks):
    """Window + sinks (sinks that end inside a page, a window that starts
    inside a tile) against the JAX P1."""
    ref = _jax(pools, kv, LENGTHS, layer=1, window=window, sinks=sinks)
    got = _port(pools, kv, LENGTHS, layer=1, window=window, sinks=sinks)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert not got[LENGTHS == 0].any()


def _ring_meta(table, lengths, capacity, sinks):
    """pos_meta of a ring that decoded each row token by token: position t
    at table order t below the sinks, else at sinks + (t - sinks) %
    (capacity - sinks); -1 where nothing came."""
    meta = np.full((P, PAGE), -1, np.int32)
    for b, n in enumerate(lengths):
        for t in range(n):
            j = t if t < sinks else sinks + (t - sinks) % (capacity - sinks)
            meta[table[b, j // PAGE], j % PAGE] = t
    return meta


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("lengths", [[0, 13, 64, 1, 41], [70, 65, 100, 64,
                                                           130]],
                         ids=["fresh", "recycled"])
def test_ring_matches_jax_kernel(pools, kv, lengths):
    """Ring positions from pos_meta (sinks 8, window 40 on 64 slots):
    never-written slots, then recycled ones holding stale positions,
    against the JAX P1 on layer 1's pool; a row with no live position gets
    zeros (ROADMAP F14)."""
    lengths = np.array(lengths, np.int32)
    meta = _ring_meta(pools["table"], lengths, PAGE * MAX_PAGES, 8)
    ref = _jax(pools, kv, lengths, window=40, sinks=8,
               pos_meta=jnp.asarray(meta))
    got = _port(pools, kv, lengths, layer=1, window=40, sinks=8,
                pos_meta=torch.from_numpy(meta))
    live = lengths > 0
    np.testing.assert_allclose(got[live], ref[live], atol=ATOL, rtol=RTOL)
    assert not got[~live].any()


def _p1_split_combine(pools, lengths, layer, splits):
    """P1's arithmetic in f32 numpy: each split of a (batch row, kv head)
    (p1_split_positions) as 8 warps, each an online softmax over its 8
    positions of every 64-position tile (base 2), the warps combined in
    the block, then the splits by the second launch."""
    q, (kp, vp, _, _), table = pools["q"], pools["f32"], pools["table"]
    G = H // HKV
    S = MAX_PAGES * PAGE
    scale = 1.0 / math.sqrt(D) * math.log2(math.e)
    plan = P1Plan(256, 0, (splits, HKV, B), splits, 0)

    def combine(parts):
        big = np.max([m for m, _, _ in parts], 0)
        big = np.where(np.isinf(big), 0.0, big)
        return (big, sum(lv * np.exp2(m - big) for m, lv, _ in parts),
                sum(a * np.exp2(m - big)[:, None] for m, _, a in parts))

    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for hk in range(HKV):
            kc = kp[layer, hk][table[b]].reshape(S, D)
            vc = vp[layer, hk][table[b]].reshape(S, D)
            qr = q[b, hk * G:(hk + 1) * G]
            blocks = []
            for s in range(splits):
                p0, p1 = p1_split_positions(plan, int(lengths[b]), s)
                warps = []
                for w in range(8):
                    t = np.array([x for x in range(p0, p1)
                                  if (x - p0) % P1_TILE // 8 == w], np.int64)
                    if not len(t):
                        warps.append((np.full(G, -np.inf), np.zeros(G),
                                      np.zeros((G, D))))
                        continue
                    sc = (qr @ kc[t].T) * scale
                    m = sc.max(1)
                    p = np.exp2(sc - m[:, None])
                    warps.append((m, p.sum(1), p @ vc[t]))
                m, lv, acc = combine(warps)
                blocks.append((np.where(lv == 0, -np.inf, m), lv, acc))
            _, lv, acc = combine(blocks)
            out[b, hk * G:(hk + 1) * G] = acc / np.where(lv == 0, 1.0,
                                                          lv)[:, None]
    return out


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_p1_split_and_combine_matches_jax_kernel(pools, splits):
    """P1's split over positions and its two combines at D 96, emulated
    in f32, against the JAX P1 on layer 1 (the combine launch runs D / 4
    = 24 threads of 4 columns on the card)."""
    ref = _jax(pools, "f32", LENGTHS, layer=1, dynamic_grid=False)
    got = _p1_split_combine(pools, LENGTHS, 1, splits)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert D % 4 == 0 and not got[0].any()


# P1's plan at D 96: (q dtype, pool dtype, B, H, Hkv, page, max_pages) of
# phase zb's serving decode (Phi-3-mini: 32 kv heads, one query head each),
# its int8 and f32 forms, one row at a long context, a ragged page size
P1_PLAN_SHAPES = [
    (torch.bfloat16, torch.bfloat16, 8, 32, 32, 128, 9),
    (torch.bfloat16, torch.int8, 8, 32, 32, 128, 9),
    (torch.float32, torch.float32, 8, 32, 32, 128, 9),
    (torch.bfloat16, torch.bfloat16, 1, 8, 1, 16, 256),
    (torch.float32, torch.int8, 3, 12, 4, 7, 21),
    (torch.bfloat16, torch.bfloat16, 2, 16, 2, 128, 33),
]
P1_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 1000, 1056, 4096]


@pytest.mark.parametrize("shape", P1_PLAN_SHAPES,
                         ids=lambda s: "-".join(map(str, s[2:])))
def test_p1_plan_gives_every_position_to_one_split(shape):
    """p1_plan at D 96 (csrc/paged_attention.cu's instance sizes): every
    position below a row's length is one split's, in whole 64-position
    tiles; in window mode every live position is one split's; the scratch
    is the combine's (D + 2) floats a query row and split; the ring and
    the window fit shared memory."""
    dt, kv, Bq, Hq, Hk, page, max_pages = shape
    plan = p1_plan(dt, kv, Bq, Hq, Hk, D, page, max_pages)
    assert plan.grid == (plan.splits, Hk, Bq) and plan.threads == 256
    assert plan.scratch == (Bq * Hk * plan.splits * (Hq // Hk) * (D + 2)
                            if plan.splits > 1 else 0)
    for length in [n for n in P1_LENGTHS if n <= page * max_pages]:
        seen = np.zeros(length, np.int64)
        for s in range(plan.splits):
            p0, p1 = p1_split_positions(plan, length, s)
            assert p1 == p0 or p0 % P1_TILE == 0
            seen[p0:p1] += 1
        assert (seen == 1).all(), (length, plan)
    window, sinks = 100, 4
    wplan = p1_plan(dt, kv, Bq, Hq, Hk, D, page, max_pages, window, sinks)
    assert wplan.mode == P1_WINDOW
    for length in [n for n in P1_LENGTHS if n <= page * max_pages]:
        pos = np.arange(length)
        want = (pos < sinks) | (pos >= length - window)
        seen = np.zeros(length, np.int64)
        for s in range(wplan.splits):
            for t0 in p1_window_tiles(wplan, length, s, window, sinks):
                seen[t0:min(t0 + P1_TILE, length)] += 1
        assert (seen[want] == 1).all() and (seen <= 1).all()
    ring = p1_plan(dt, kv, Bq, Hq, Hk, D, page, max_pages, window, sinks,
                   True)
    assert ring.mode == P1_RING
    for p in (plan, wplan, ring):
        assert p.smem_bytes <= 227 * 1024


def test_p1_plan_at_d96_sizes_its_instances():
    """The shared memory of P1's D 96 instances: q (8 x 96 f32) and 8
    warps' rings of 3 stages (8 K and 8 V rows, int8 with their scales,
    a ring with the slots' positions): two blocks an SM for bf16 and int8,
    one for f32 (as at D 128)."""
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    q = 8 * D * 4
    assert p1_plan(bf, bf, 8, 32, 32, D, 128, 9).smem_bytes == \
        q + 8 * 3 * 2 * 8 * D * 2
    assert p1_plan(bf, i8, 8, 32, 32, D, 128, 9).smem_bytes == \
        q + 8 * 3 * (2 * 8 * D + 2 * 8 * 4)
    assert p1_plan(bf, i8, 8, 32, 32, D, 16, 17, 240, 16, True) \
        .smem_bytes == q + 8 * 3 * (2 * 8 * D + 2 * 8 * 4 + 8 * 4)
    assert p1_plan(f32, f32, 8, 32, 32, D, 128, 9).smem_bytes == \
        q + 8 * 3 * 2 * 8 * D * 4
    # 8 x 32 rows: 256 blocks unsplit fill 132 SMs at two an SM
    assert p1_plan(bf, bf, 8, 32, 32, D, 128, 9).splits == 1
    assert p1_plan(bf, bf, 1, 32, 32, D, 128, 9).splits == 8


@pytest.mark.parametrize("D_other", [48, 160, 192, 288, 320, 512])
def test_other_head_dims_are_refused(D_other):
    """P1 and P3 have instances of their own at 32, 64, 80, 96, 128 and
    256; a head dim without one, such as 48, 160 or 192, is taken, planned
    at the width of its ragged instance (the next of 64, 128 and 256) with
    the scratch at the real D; past 256 both refuse it, naming ROADMAP
    Queue 2a."""
    assert PAGED_HEAD_DIMS == (32, 64, 80, 96, 128, 256)
    bf = torch.bfloat16
    for D_ok in PAGED_HEAD_DIMS:
        p1_plan(bf, bf, 8, 16, 8, D_ok, 128, 9)
        p3_plan(bf, bf, 8, 16, 8, 5, D_ok, 128, 9)
    if D_other <= 256:
        W = paged_width(D_other)
        assert W == next(w for w in (64, 128, 256) if D_other <= w)
        got, at_w = (p1_plan(bf, bf, 1, 16, 8, d, 128, 9)
                     for d in (D_other, W))
        assert (got.smem_bytes, got.splits) == (at_w.smem_bytes,
                                                at_w.splits)
        assert got.scratch == 16 * got.splits * (D_other + 2)
        for dt in (bf, torch.float32):
            got, at_w = (p3_plan(dt, dt, 1, 16, 8, 5, d, 128, 9)
                         for d in (D_other, W))
            assert (got.body, got.smem_bytes, got.grid) == (
                at_w.body, at_w.smem_bytes, at_w.grid)
        return
    with pytest.raises(ValueError, match="ROADMAP Queue 2a"):
        p1_plan(bf, bf, 8, 16, 8, D_other, 128, 9)
    with pytest.raises(ValueError, match="ROADMAP Queue 2a"):
        p3_plan(bf, bf, 8, 16, 8, 5, D_other, 128, 9)
    with pytest.raises(ValueError, match="ROADMAP Queue 2a"):
        p3_plan(torch.float32, torch.float32, 8, 16, 8, 5, D_other, 128, 9)


# -- P3 -----------------------------------------------------------------------

STARTS = np.array([0, 5, 8, 13, 30], np.int32)


@pytest.mark.parametrize("kv, G, C", [
    ("f32", 2, 5), ("int8", 2, 5), ("f32", 1, 32), ("int8", 2, 16)],
    ids=["verify-f32", "verify-int8", "prefill-f32-C32", "prefill-int8-C16"])
def test_chunked_matches_jax_kernel(pools, kv, G, C):
    """P3 at D 96: the verify step's decode-shaped chunk (C 5, G 2) and
    prefill-shaped chunks, from 0, in mid-page, on a page boundary and
    after a prefix, lengths = starts + C, layer 1."""
    kp, vp, ks, vs = pools[kv]
    rng = np.random.default_rng(10 * C + G)
    q = rng.standard_normal((B, HKV * G, C, D), dtype=np.float32)
    lengths = STARTS + C
    ref = jax_paged.paged_attention_chunked(
        *(_j(a) for a in (q, kp, vp, pools["table"], lengths, STARTS)),
        interpret=True, k_scales=_j(ks), v_scales=_j(vs), layer=1)
    got = paged_attention_chunked(
        *(_t(a) for a in (q, kp, vp, pools["table"], lengths, STARTS)),
        layer=1, k_scales=_t(ks), v_scales=_t(vs))
    assert got.shape == (B, HKV * G, C, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _p3_split_combine(q, kp, vp, table, lengths, starts, split_len):
    """P3's split over positions and its combine in f32 numpy (layer 1):
    per (b, kv head) and split of ``split_len`` positions the rows' partial
    base-2 softmax, then the combine's rescaling; a row with no live
    position gets zeros."""
    Bq, Hq, C, _ = q.shape
    G = Hq // HKV
    S = table.shape[1] * PAGE
    scale = 1.0 / math.sqrt(D) * math.log2(math.e)
    out = np.zeros(q.shape, np.float32)
    for b in range(Bq):
        for hk in range(HKV):
            kc = kp[1, hk][table[b]].reshape(S, D)
            vc = vp[1, hk][table[b]].reshape(S, D)
            qr = q[b, hk * G:(hk + 1) * G].reshape(G * C, D)
            pos = starts[b] + np.arange(G * C) % C
            parts = []
            for p0 in range(0, S, split_len):
                t = np.arange(p0, min(p0 + split_len, S))
                sc = (qr @ kc[t].T) * scale
                live = (t[None] < lengths[b]) & (t[None] <= pos[:, None])
                sc = np.where(live, sc, -np.inf)
                m = sc.max(1)
                mu = np.where(np.isinf(m), 0.0, m)
                p = np.where(live, np.exp2(sc - mu[:, None]), 0.0)
                parts.append((m, p.sum(1), p @ vc[t]))
            big = np.max([m for m, _, _ in parts], 0)
            big = np.where(np.isinf(big), 0.0, big)
            l_sum = sum(lv * np.exp2(m - big) for m, lv, _ in parts)
            acc = sum(a * np.exp2(m - big)[:, None] for m, _, a in parts)
            o = acc / np.where(l_sum == 0, 1.0, l_sum)[:, None]
            out[b, hk * G:(hk + 1) * G] = o.reshape(G, C, D)
    return out


def test_p3_split_and_combine_matches_jax_kernel(pools):
    """The bf16 body's split of a decode-shaped chunk's positions (the
    verify step's C 5, G 2) into 8, 16 and 64 positions and its combine,
    emulated in f32, against the JAX kernel."""
    kp, vp, _, _ = pools["f32"]
    q = np.random.default_rng(52).standard_normal((B, HKV * 2, 5, D),
                                                  dtype=np.float32)
    lengths = STARTS + 5
    ref = np.asarray(jax_paged.paged_attention_chunked(
        *(_j(a) for a in (q, kp, vp, pools["table"], lengths, STARTS)),
        interpret=True, layer=1))
    for split_len in (8, 16, 64):
        got = _p3_split_combine(q, kp, vp, pools["table"], lengths, STARTS,
                                split_len)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


# P3's plan at D 96: (name, B, Hkv, G, C, page, max_pages, starts,
# lengths) of phase zb (Phi-3-mini: 32 kv heads of one query head; the
# verify step, chunked prefill from 0 and from 768, a ragged batch with a
# length-0 row), and a page size that 64 positions do not hold whole
P3_PLAN_CASES = [
    ("verify", 8, 32, 1, 5, 128, 10, [1051] * 8, [1056] * 8),
    ("prefill from 0", 8, 32, 1, 256, 128, 10, [0] * 8, [256] * 8),
    ("prefill from 768", 8, 32, 1, 256, 128, 10, [768] * 8, [1024] * 8),
    ("ragged page 7", 4, 2, 4, 16, 7, 40, [0, 1, 127, 200], [0, 17, 143,
                                                             216]),
]


@pytest.mark.parametrize("case", P3_PLAN_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_p3_plan_gives_every_position_to_one_split(case, kv):
    """p3_plan at D 96 (the bf16 body's instance sizes: tiles of 64 rows
    in D 128's two 128-byte panels, the last 32 columns unused; int8 rows
    of 96 bytes): decode-shaped chunks split the table's
    span, prefill-shaped ones do not; for every batch row and row tile the
    blocks' position ranges are disjoint and cover each position a row
    attends; the scratch is the combine's."""
    name, Bq, Hk, G, C, page, max_pages, starts, lengths = case
    plan = p3_plan(torch.bfloat16, torch.int8 if kv == "int8"
                   else torch.bfloat16, Bq, Hk * G, Hk, C, D, page,
                   max_pages)
    tile = 64 * 128 * 2
    raw = 64 * D if kv == "int8" else tile
    assert plan.smem_bytes == tile + 3 * 2 * raw + (
        2 * tile + 3 * 2 * 64 * 4 if kv == "int8" else 0) + 1024
    assert plan.smem_bytes * 2 + 2048 <= 228 * 1024   # two blocks an SM
    rows = -(-G * C // 64)
    assert plan.grid == (rows * plan.splits, Hk, Bq)
    assert (plan.splits > 1) == (G * C <= 64 and Bq * Hk < 264)
    assert plan.scratch == (Bq * Hk * plan.splits * G * C * (D + 2)
                            if plan.splits > 1 else 0)
    for b in range(Bq):
        live = {}
        for x in range(plan.grid[0]):
            r0, r_end, p0, p1 = p3_block_positions(plan, C, G, starts[b],
                                                   lengths[b], x)
            for r in range(r0, r_end):
                got = live.setdefault(r, [])
                assert not set(got) & set(range(p0, p1))
                got.extend(range(p0, p1))
        assert sorted(live) == list(range(G * C))
        for r, got in live.items():
            assert set(range(min(lengths[b], starts[b] + r % C + 1))) <= \
                set(got)


def test_p3_f32_plan_at_d96():
    """The f32 body at D 96: Q, K, V and P in f32 shared memory, one
    64-row tile a block, no split."""
    plan = p3_plan(torch.float32, torch.float32, 8, 32, 32, 5, D, 128, 10)
    assert plan.body == "cuda-cores" and plan.splits == 1
    assert plan.smem_bytes == (D * 64 * 3 + 64 * 68 + 2 * 64) * 4
    assert plan.grid == (1, 32, 8)


# -- the llama at head dim 96 -------------------------------------------------

HD96 = dict(vocab=64, d_model=192, n_heads=2, n_kv_heads=1, n_layers=2,
            d_ff=128, seq=64, use_flash_attention=False,
            use_framework_kernels=False)


def _pair(seed, **over):
    """(JAX config, JAX params, port model) on the same weights."""
    jcfg = jllama.LlamaConfig(**{**HD96, **over})
    jparams = jllama.init_params(jcfg, seed=seed)
    model = llama.Llama(llama.LlamaConfig(**{**HD96, **over}), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    assert model.cfg.head_dim == 96
    return jcfg, jparams, model


def _jax_steps(jcfg, jparams, jc, toks):
    """The JAX decode steps (jitted) over toks (B, n) from ``jc``."""
    jstep = jax.jit(lambda p, c, t: jllama.decode_step(p, c, t, jcfg))
    out = []
    for i in range(toks.shape[1]):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, i]))
        out.append(np.asarray(jl))
    return np.stack(out, 1), jc


def _port_steps(model, c, toks):
    out = []
    for i in range(toks.shape[1]):
        lg, c = llama.decode_step(model, c, torch.from_numpy(toks[:, i]))
        out.append(lg.numpy())
    return np.stack(out, 1), c


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8"])
def test_llama_decode_steps_match_jax(kv_dtype):
    """prefill of a 12-token prompt, then 10 decode steps fed greedy
    tokens (the JAX steps' own), logits and pools against the JAX
    package's; int8 as tests/test_torch_serving.py holds it."""
    jcfg, jparams, model = _pair(21, kv_dtype=kv_dtype)
    Bq, page = 2, 16
    prompt = np.random.RandomState(22).randint(0, 64, (Bq, 12)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    jl, jc = jllama.prefill(jparams, jc, jnp.asarray(prompt), jcfg)
    c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    lg, c = llama.prefill(model, c, torch.from_numpy(prompt))
    atol = INT8_ATOL if kv_dtype else LOGIT_ATOL
    rtol = 0 if kv_dtype else LOGIT_RTOL
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=atol,
                               rtol=rtol)
    # greedy: the JAX stream, fed to both
    toks, tok, jstep = [], jnp.argmax(jl, -1).astype(jnp.int32), jax.jit(
        lambda p, c_, t: jllama.decode_step(p, c_, t, jcfg))
    jls, jcs = [], jc
    for _ in range(10):
        toks.append(np.asarray(tok))
        jl, jcs = jstep(jparams, jcs, tok)
        jls.append(np.asarray(jl))
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    toks = np.stack(toks, 1)
    got, c = _port_steps(model, c, toks)
    np.testing.assert_allclose(got, np.stack(jls, 1), atol=atol, rtol=rtol)
    if not kv_dtype:
        np.testing.assert_array_equal(got.argmax(-1),
                                      np.stack(jls, 1).argmax(-1))
    for name in ("k", "v"):
        a, r = getattr(c, name).numpy(), np.asarray(jcs[name])
        if kv_dtype:
            a = a.astype(np.float32) * getattr(c, f"{name}_scales").numpy()[
                ..., None]
            r = r.astype(np.float32) * np.asarray(jcs[f"{name}_scales"])[
                ..., None]
        np.testing.assert_allclose(a, r, atol=atol)
    np.testing.assert_array_equal(c.lengths.numpy(),
                                  np.asarray(jcs["lengths"]))


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8"])
def test_llama_decode_chunk_matches_jax_and_steps(kv_dtype):
    """One decode_chunk of 5 tokens (the verify step) after a 9-token
    prefill against the JAX package's and against 5 of the port's decode
    steps."""
    jcfg, jparams, model = _pair(23, kv_dtype=kv_dtype)
    Bq, C, page = 2, 5, 16
    toks = np.random.RandomState(24).randint(0, 64, (Bq, 14)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    _, jc = jllama.prefill(jparams, jc, jnp.asarray(toks[:, :9]), jcfg)
    jl, jc = jllama.decode_chunk(jparams, jc, jnp.asarray(toks[:, 9:]), jcfg)
    caches = []
    for _ in range(2):
        c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
        _, c = llama.prefill(model, c, torch.from_numpy(toks[:, :9]))
        caches.append(c)
    l1, c1 = llama.decode_chunk(model, caches[0], torch.from_numpy(
        toks[:, 9:]))
    l2, _ = _port_steps(model, caches[1], toks[:, 9:])
    atol = INT8_ATOL if kv_dtype else LOGIT_ATOL
    rtol = 0 if kv_dtype else LOGIT_RTOL
    assert l1.shape == (Bq, C, 64)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(l1.numpy(), l2, atol=atol, rtol=rtol)
    np.testing.assert_array_equal(c1.lengths.numpy(),
                                  np.asarray(jc["lengths"]))


def test_llama_prefill_chunked_matches_jax_and_prefill():
    """Chunks of 8 over S = 21 (a ragged last chunk) against the JAX
    package's and against one batched prefill."""
    jcfg, jparams, model = _pair(25)
    Bq, S, page = 2, 21, 16
    prompt = np.random.RandomState(26).randint(0, 64, (Bq, S)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    jl, jc = jllama.prefill_chunked(jparams, jc, jnp.asarray(prompt), jcfg,
                                    chunk=8)
    c1 = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    l1, c1 = llama.prefill(model, c1, torch.from_numpy(prompt))
    c2 = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    l2, c2 = llama.prefill_chunked(model, c2, torch.from_numpy(prompt),
                                   chunk=8)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c2, name).numpy(),
                                   np.asarray(jc[name]), atol=LOGIT_ATOL)
        np.testing.assert_allclose(getattr(c2, name).numpy(),
                                   getattr(c1, name).numpy(),
                                   atol=LOGIT_ATOL)


def test_llama_speculative_matches_jax():
    """speculative_generate at head dim 96 with a weak draft (another
    seed) and with the target as its own draft, and on an int8 target
    cache: tokens equal the JAX package's and the port's greedy
    ``generate``, acceptance equal the JAX package's (gamma for the
    self-draft)."""
    jcfg, jparams, model = _pair(27)
    _, jdraft, draft = _pair(28)
    prompt = np.random.RandomState(29).randint(0, 64, (2, 6)).astype(
        np.int32)
    want = llama.generate(model, torch.from_numpy(prompt), 8,
                          max_pages=2).numpy()
    ref = jllama.generate(jparams, jnp.asarray(prompt), 8, jcfg, max_pages=2)
    np.testing.assert_array_equal(want, np.asarray(ref))
    for jd, d in ((jdraft, draft), (jparams, model)):
        jtoks, jacc = jllama.speculative_generate(
            jparams, jnp.asarray(prompt), 8, jcfg, jd, jcfg, gamma=3,
            max_pages=2)
        toks, acc = llama.speculative_generate(
            model, torch.from_numpy(prompt), 8, d, gamma=3, max_pages=2)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(toks.numpy(), want)
        assert acc == jacc
    assert acc == 3.0
    j8, _, m8 = _pair(27, kv_dtype="int8")
    jtoks, jacc = jllama.speculative_generate(
        jparams, jnp.asarray(prompt), 8, j8, jdraft, jcfg, gamma=3,
        max_pages=2)
    toks, acc = llama.speculative_generate(
        m8, torch.from_numpy(prompt), 8, draft, gamma=3, max_pages=2)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert acc == jacc


@pytest.mark.parametrize("ring", [False, True], ids=["window", "ring"])
def test_llama_streaming_decode_matches_jax(ring):
    """StreamingLLM at head dim 96 (sinks 16, window 16): 60 decode steps
    from an empty cache of 3 pages of 16, windowed in an unbounded cache or
    on a ring whose 48 slots recycle, logits (and the ring's pos_meta)
    against the JAX package's."""
    jcfg, jparams, model = _pair(31, attn_window=16, attn_sinks=16,
                                 ring_cache=ring)
    toks = np.random.RandomState(32).randint(0, 64, (1, 60)).astype(
        np.int32)
    pages = 3 if ring else 4
    jl, jc = _jax_steps(jcfg, jparams, jllama.init_kv_cache(
        jcfg, 1, pages, 16), toks)
    got, c = _port_steps(model, llama.init_kv_cache(
        model.cfg, 1, pages, 16, "cpu"), toks)
    np.testing.assert_allclose(got, jl, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    if ring:
        np.testing.assert_array_equal(c.pos_meta.numpy(),
                                      np.asarray(jc["pos_meta"]))
    else:
        assert c.pos_meta is None


def test_llama_beam_generate_matches_jax():
    """beam_generate at head dim 96 on the paged allocator: the port's
    beams equal the JAX package's and its scores agree to 1e-5 (as
    tests/test_torch_pages.py holds them at head dim 16); the best beam's
    score is also its tokens' log-prob, recomputed by a forward."""
    jcfg, jparams, model = _pair(33)
    prompt = np.random.RandomState(34).randint(0, 64, 7).astype(np.int32)
    jtoks, jscores = jllama.beam_generate(jparams, jnp.asarray(prompt), 6,
                                          jcfg, beams=3, page=16)
    toks, scores = llama.beam_generate(model, torch.from_numpy(prompt), 6,
                                       beams=3, page=16)
    assert toks.shape == (3, 13)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-5)
    lp = torch.log_softmax(llama.forward(model, toks[:1, :-1].long())[
        0, 6:].float(), -1)
    want = lp.gather(-1, toks[0, 7:, None].long()).sum()
    assert abs(float(scores[0]) - float(want)) < 1e-4
