"""Paged attention at head dims 32 (Pythia-31M's) and 80 (Phi-2's and
H2O-Danube's) in cubecl_tpu_torch against cubecl_tpu: P1 (every position,
window + sinks, the ring, int8 pools, stacked layers, G 4 and G 12, the
split over positions and its combine), P3 (the verify and prefill shapes,
its split), both launch plans at each head dim, and the llama at each head
dim served through ``decode_step`` (an int8 cache among them),
``decode_chunk``, ``prefill_chunked``, ``speculative_generate``,
``beam_generate`` and StreamingLLM's window and ring.

The port runs its plain versions on these CPU tensors (on the card D 32
and 80 launch their own instances of csrc/paged_attention.cu and
csrc/paged_chunked.cu, held to the plain versions by
tests/test_torch_cuda.py); the JAX kernels run in Pallas interpret mode,
on stacked pools (the JAX ring takes layer 1's pool alone). The JAX
results that several tests read are computed once a module
(``functools.lru_cache``). Tolerances are tests/test_torch_paged_d96.py's:
f32 kernels atol 2e-5 / rtol 1e-4, the model's logits atol 3e-5 / rtol
1e-4, the model's int8 cache atol 0.02; greedy tokens equal.
"""

import functools
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
    P1_TILE,
    P1_WINDOW,
    PAGED_HEAD_DIMS,
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
HEAD_DIMS = [32, 80]
B, HKV = 5, 2
L, P, PAGE, MAX_PAGES = 2, 48, 8, 8
# a length-0 row, mid-page, the full capacity, one position, past a tile
LENGTHS = np.array([0, 13, 64, 1, 41], np.int32)


@functools.lru_cache(maxsize=None)
def _pools(D):
    """f32 pools, int8 pools with their scales (quantize_kv of the f32
    ones) and a table whose rows own disjoint pages (as a ring's do)."""
    rng = np.random.default_rng(D)
    kp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    vp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    (k8, ks), (v8, vs) = (quantize_kv(torch.from_numpy(x)) for x in (kp, vp))
    table = rng.permutation(P)[:B * MAX_PAGES].reshape(B, MAX_PAGES)
    return dict(f32=(kp, vp, None, None),
                int8=tuple(t.numpy() for t in (k8, v8, ks, vs)),
                table=table.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _q(D, G):
    return np.random.default_rng(10 * D + G).standard_normal(
        (B, HKV * G, D), dtype=np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port(D, G, kv, lengths, **kw):
    kp, vp, ks, vs = _pools(D)[kv]
    return paged_attention(_t(_q(D, G)), _t(kp), _t(vp),
                           _t(_pools(D)["table"]), _t(lengths),
                           k_scales=_t(ks), v_scales=_t(vs), **kw).numpy()


@functools.lru_cache(maxsize=None)
def _jax(D, G, kv, lengths, layer=None, meta=None, **kw):
    """The JAX P1 on the stacked pools (``layer``) or, for a ring (``meta``
    given), on layer 1's pool; ``lengths`` and ``meta`` as tuples."""
    kp, vp, ks, vs = _pools(D)[kv]
    if layer is None:
        kp, vp = kp[1], vp[1]
        ks, vs = (None, None) if ks is None else (ks[1], vs[1])
        kw["pos_meta"] = jnp.asarray(np.array(meta, np.int32))
    else:
        kw["layer"] = layer
    return np.asarray(jax_paged.paged_attention(
        _j(_q(D, G)), _j(kp), _j(vp), _j(_pools(D)["table"]),
        jnp.asarray(np.array(lengths, np.int32)), k_scales=_j(ks),
        v_scales=_j(vs), interpret=True, **kw))


# -- P1 -----------------------------------------------------------------------

@pytest.mark.parametrize("kv, G, dynamic_grid", [
    ("f32", 4, True), ("int8", 4, False), ("f32", 12, False),
    ("int8", 12, False)], ids=["f32-G4-P2", "int8-G4-P1", "f32-G12-P1",
                               "int8-G12-P1"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_decode_matches_jax_kernel(D, kv, G, dynamic_grid):
    """Every position below the length, layer 1 of the stacked pools, at G
    4 and G 12, on the JAX kernel's dynamic grid (P2) once and its static
    one (P1) otherwise; a length-0 row's zeros."""
    ref = _jax(D, G, kv, tuple(LENGTHS), layer=1, dynamic_grid=dynamic_grid)
    got = _port(D, G, kv, LENGTHS, layer=1)
    assert got.shape == (B, HKV * G, D)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert not got[LENGTHS == 0].any()


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_windowed_matches_jax_kernel(D, kv):
    """Window 20 + sinks 9 (sinks that end inside a page, a window that
    starts inside a tile) at G 4 against the JAX P1, layer 1."""
    ref = _jax(D, 4, kv, tuple(LENGTHS), layer=1, window=20, sinks=9)
    got = _port(D, 4, kv, LENGTHS, layer=1, window=20, sinks=9)
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
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_ring_matches_jax_kernel(D, kv, lengths):
    """Ring positions from pos_meta (sinks 8, window 40 on 64 slots) at G
    4: never-written slots, then recycled ones holding stale positions,
    against the JAX P1 on layer 1's pool; a row with no live position gets
    zeros."""
    lengths = np.array(lengths, np.int32)
    meta = _ring_meta(_pools(D)["table"], lengths, PAGE * MAX_PAGES, 8)
    ref = _jax(D, 4, kv, tuple(lengths),
               meta=tuple(map(tuple, meta.tolist())), window=40, sinks=8)
    got = _port(D, 4, kv, lengths, layer=1, window=40, sinks=8,
                pos_meta=torch.from_numpy(meta))
    live = lengths > 0
    np.testing.assert_allclose(got[live], ref[live], atol=ATOL, rtol=RTOL)
    assert not got[~live].any()


def _p1_split_combine(D, G, lengths, layer, splits):
    """P1's arithmetic in f32 numpy: each split of a (batch row, kv head)
    (p1_split_positions) as 8 warps, each an online softmax over its 8
    positions of every 64-position tile (base 2), the warps combined in
    the block, then the splits by the second launch."""
    q, table = _q(D, G), _pools(D)["table"]
    kp, vp, _, _ = _pools(D)["f32"]
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
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_p1_split_and_combine_matches_jax_kernel(D, splits):
    """P1's split over positions and its two combines, emulated in f32, at
    G 4 against the JAX P1 on layer 1 (the combine launch runs D / 4
    threads of 4 columns on the card: 8 at D 32, 20 at D 80)."""
    ref = _jax(D, 4, "f32", tuple(LENGTHS), layer=1, dynamic_grid=True)
    got = _p1_split_combine(D, 4, LENGTHS, 1, splits)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert D % 4 == 0 and not got[0].any()


# P1's plan: (q dtype, pool dtype, B, H, Hkv, page, max_pages) of phase
# zf's decodes: Phi-2 (32 kv heads of one query head, context 1056) on
# bf16, int8 and f32 pools, H2O-Danube's G 4 at context 4096, D 32 at B 8
# x 16 heads at context 2048, G 12 on one kv head, a ragged G 4 on pages of
# 7 and pages of 1
P1_PLAN_SHAPES = [
    (torch.bfloat16, torch.bfloat16, 8, 32, 32, 128, 9),
    (torch.bfloat16, torch.int8, 8, 32, 32, 128, 9),
    (torch.float32, torch.float32, 8, 32, 32, 128, 9),
    (torch.bfloat16, torch.bfloat16, 8, 32, 8, 128, 33),
    (torch.bfloat16, torch.bfloat16, 8, 16, 16, 128, 16),
    (torch.float32, torch.int8, 4, 12, 1, 128, 16),
    (torch.bfloat16, torch.bfloat16, 5, 8, 2, 7, 40),
    (torch.float32, torch.float32, 3, 8, 4, 1, 300),
]
P1_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 1000, 1056, 2048, 4096]


@pytest.mark.parametrize("shape", P1_PLAN_SHAPES,
                         ids=lambda s: "-".join(map(str, s[2:])))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_p1_plan_gives_every_position_to_one_split(D, shape):
    """p1_plan (csrc/paged_attention.cu's instance sizes): every position
    below a row's length is one split's, in whole 64-position tiles; in
    window mode every live position is one split's; the scratch is the
    combine's (D + 2) floats a query row and split; the full walk, the
    window and the ring fit the 227 KB a block may hold."""
    dt, kv, Bq, Hq, Hk, page, max_pages = shape
    plan = p1_plan(dt, kv, Bq, Hq, Hk, D, page, max_pages)
    assert plan.grid == (plan.splits * plan.groups, Hk, Bq)
    assert plan.groups == -(-(Hq // Hk) // 8) and plan.threads == 256
    assert plan.scratch == (Bq * Hq * plan.splits * (D + 2)
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
    for p in (plan, wplan, ring):
        assert p.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_p1_plan_sizes_its_instances(D):
    """The shared memory of P1's instances: q (8 x D f32) and 8 warps'
    rings of 3 stages (8 K and 8 V rows, int8 with their scales, a ring
    with the slots' positions), or the warps' combine where it is larger;
    two blocks an SM but for f32 pools at D 80 (one, as at D 96)."""
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    q, comb = 8 * D * 4, 8 * 8 * (D + 2) * 4
    assert p1_plan(bf, bf, 8, 32, 32, D, 128, 9).smem_bytes == \
        q + max(8 * 3 * 2 * 8 * D * 2, comb)
    assert p1_plan(bf, i8, 8, 32, 32, D, 128, 9).smem_bytes == \
        q + max(8 * 3 * (2 * 8 * D + 2 * 8 * 4), comb)
    assert p1_plan(bf, i8, 8, 32, 32, D, 16, 17, 240, 16, True) \
        .smem_bytes == q + max(8 * 3 * (2 * 8 * D + 2 * 8 * 4 + 8 * 4), comb)
    f32_plan = p1_plan(f32, f32, 8, 32, 32, D, 128, 9)
    assert f32_plan.smem_bytes == q + 8 * 3 * 2 * 8 * D * 4
    # 8 x 32 rows: 256 blocks unsplit fill 132 SMs at two an SM
    assert p1_plan(bf, bf, 8, 32, 32, D, 128, 9).splits == 1
    assert p1_plan(bf, bf, 1, 32, 32, D, 128, 9).splits == 8
    # f32 at D 80 runs one block an SM: 132 blocks for 32 kv heads of B 1
    assert p1_plan(f32, f32, 1, 32, 32, D, 128, 9).splits == \
        (4 if D == 80 else 8)
    assert D in PAGED_HEAD_DIMS


# -- P3 -----------------------------------------------------------------------

STARTS = np.array([0, 5, 8, 13, 30], np.int32)


@pytest.mark.parametrize("kv, G, C", [
    ("f32", 2, 5), ("int8", 2, 5), ("f32", 1, 32), ("int8", 2, 16)],
    ids=["verify-f32", "verify-int8", "prefill-f32-C32", "prefill-int8-C16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_chunked_matches_jax_kernel(D, kv, G, C):
    """P3: the verify step's decode-shaped chunk (C 5, G 2) and
    prefill-shaped chunks, from 0, in mid-page, on a page boundary and
    after a prefix, lengths = starts + C, layer 1."""
    kp, vp, ks, vs = _pools(D)[kv]
    table = _pools(D)["table"]
    rng = np.random.default_rng(10 * C + G + D)
    q = rng.standard_normal((B, HKV * G, C, D), dtype=np.float32)
    lengths = STARTS + C
    ref = jax_paged.paged_attention_chunked(
        *(_j(a) for a in (q, kp, vp, table, lengths, STARTS)),
        interpret=True, k_scales=_j(ks), v_scales=_j(vs), layer=1)
    got = paged_attention_chunked(
        *(_t(a) for a in (q, kp, vp, table, lengths, STARTS)),
        layer=1, k_scales=_t(ks), v_scales=_t(vs))
    assert got.shape == (B, HKV * G, C, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _p3_split_combine(D, q, lengths, split_len):
    """P3's split over positions and its combine in f32 numpy (layer 1):
    per (b, kv head) and split of ``split_len`` positions the rows' partial
    base-2 softmax, then the combine's rescaling; a row with no live
    position gets zeros."""
    kp, vp, _, _ = _pools(D)["f32"]
    table = _pools(D)["table"]
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
            pos = STARTS[b] + np.arange(G * C) % C
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


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_p3_split_and_combine_matches_jax_kernel(D):
    """The bf16 body's split of a decode-shaped chunk's positions (the
    verify step's C 5, G 2) into 8, 16 and 64 positions and its combine,
    emulated in f32, against the JAX kernel."""
    kp, vp, _, _ = _pools(D)["f32"]
    q = np.random.default_rng(52 + D).standard_normal((B, HKV * 2, 5, D),
                                                      dtype=np.float32)
    lengths = STARTS + 5
    ref = np.asarray(jax_paged.paged_attention_chunked(
        *(_j(a) for a in (q, kp, vp, _pools(D)["table"], lengths, STARTS)),
        interpret=True, layer=1))
    for split_len in (8, 16, 64):
        got = _p3_split_combine(D, q, lengths, split_len)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


# P3's plan: (name, B, Hkv, G, C, page, max_pages, starts, lengths) of
# phase zf: Phi-2's verify step (C 5, decode-shaped: its positions split),
# chunked prefill from 0 and from 768, the G 4 verify step, a ragged G 4
# batch on pages of 7 with a length-0 row
P3_PLAN_CASES = [
    ("verify", 8, 32, 1, 5, 128, 10, [1051] * 8, [1056] * 8),
    ("prefill from 0", 8, 32, 1, 256, 128, 10, [0] * 8, [256] * 8),
    ("prefill from 768", 8, 32, 1, 256, 128, 10, [768] * 8, [1024] * 8),
    ("G4 verify", 8, 8, 4, 5, 128, 33, [4091] * 8, [4096] * 8),
    ("ragged page 7", 4, 2, 4, 16, 7, 40, [0, 1, 127, 200], [0, 17, 143,
                                                             216]),
]


@pytest.mark.parametrize("case", P3_PLAN_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_p3_plan_gives_every_position_to_one_split(D, kv, case):
    """p3_plan (the bf16 body's instance sizes: tiles of 64 rows in D 64's
    one 128-byte panel at D 32 or D 128's two at D 80, the columns past D
    unused; int8 rows of D bytes): decode-shaped chunks split the table's
    span, prefill-shaped ones do not; for every batch row and row tile the
    blocks' position ranges are disjoint and cover each position a row
    attends; the scratch is the combine's."""
    name, Bq, Hk, G, C, page, max_pages, starts, lengths = case
    plan = p3_plan(torch.bfloat16, torch.int8 if kv == "int8"
                   else torch.bfloat16, Bq, Hk * G, Hk, C, D, page,
                   max_pages)
    tile = (64 if D == 32 else 128) * 64 * 2
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


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_p3_f32_plan(D):
    """The f32 body: Q, K, V and P in f32 shared memory, one 64-row tile a
    block, no split."""
    plan = p3_plan(torch.float32, torch.float32, 8, 32, 32, 5, D, 128, 10)
    assert plan.body == "cuda-cores" and plan.splits == 1
    assert plan.smem_bytes == (D * 64 * 3 + 64 * 68 + 2 * 64) * 4
    assert plan.grid == (1, 32, 8)


# -- the llama at head dims 32 and 80 -----------------------------------------

# D 32: 4 query heads on 1 kv head (G 4); D 80: 2 on 1 (G 2)
HEADS = {32: (4, 1), 80: (2, 1)}


# StreamingLLM's options (sinks 16, window 16), unbounded or on a ring
STREAM = {None: {}, "window": dict(attn_window=16, attn_sinks=16),
          "ring": dict(attn_window=16, attn_sinks=16, ring_cache=True)}


# The JAX llama's calls compile once a shape (eager or under jit), and a
# shape compiled for one test serves the next: the tests below share B 2,
# 9-token prompts, pages of 16 and chunks of 5 where they can.
@functools.lru_cache(maxsize=None)
def _pair(D, seed, kv_dtype="", stream=None):
    """(JAX config, JAX params, port model, the JAX decode step jitted) on
    the same weights."""
    nh, nkv = HEADS[D]
    cfg = dict(vocab=64, d_model=nh * D, n_heads=nh, n_kv_heads=nkv,
               n_layers=2, d_ff=128, seq=64, use_flash_attention=False,
               use_framework_kernels=False, kv_dtype=kv_dtype,
               **STREAM[stream])
    jcfg = jllama.LlamaConfig(**cfg)
    jparams = jllama.init_params(jcfg, seed=seed)
    model = llama.Llama(llama.LlamaConfig(**cfg), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    assert model.cfg.head_dim == D
    return jcfg, jparams, model, jax.jit(
        lambda p, c, t: jllama.decode_step(p, c, t, jcfg))


def _port_steps(model, c, toks):
    out = []
    for i in range(toks.shape[1]):
        lg, c = llama.decode_step(model, c, torch.from_numpy(toks[:, i]))
        out.append(lg.numpy())
    return np.stack(out, 1), c


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_llama_decode_steps_match_jax(D, kv_dtype):
    """prefill of a 9-token prompt, then 6 decode steps fed greedy tokens
    (the JAX steps' own), logits and pools against the JAX package's;
    int8 as tests/test_torch_serving.py holds it. The JAX steps run
    eagerly, as speculative_generate's do."""
    jcfg, jparams, model, _ = _pair(D, 21, kv_dtype)
    Bq, page = 2, 16
    prompt = np.random.RandomState(22).randint(0, 64, (Bq, 9)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    jl, jc = jllama.prefill(jparams, jc, jnp.asarray(prompt), jcfg)
    c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    lg, c = llama.prefill(model, c, torch.from_numpy(prompt))
    atol = INT8_ATOL if kv_dtype else LOGIT_ATOL
    rtol = 0 if kv_dtype else LOGIT_RTOL
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=atol,
                               rtol=rtol)
    toks, jls, tok = [], [], jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(6):
        toks.append(np.asarray(tok))
        jl, jc = jllama.decode_step(jparams, jc, tok, jcfg)
        jls.append(np.asarray(jl))
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    got, c = _port_steps(model, c, np.stack(toks, 1))
    np.testing.assert_allclose(got, np.stack(jls, 1), atol=atol, rtol=rtol)
    if not kv_dtype:
        np.testing.assert_array_equal(got.argmax(-1),
                                      np.stack(jls, 1).argmax(-1))
    for name in ("k", "v"):
        a, r = getattr(c, name).numpy(), np.asarray(jc[name])
        if kv_dtype:
            a = a.astype(np.float32) * getattr(c, f"{name}_scales").numpy()[
                ..., None]
            r = r.astype(np.float32) * np.asarray(jc[f"{name}_scales"])[
                ..., None]
        np.testing.assert_allclose(a, r, atol=atol)
    np.testing.assert_array_equal(c.lengths.numpy(),
                                  np.asarray(jc["lengths"]))


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_llama_decode_chunk_and_prefill_chunked_match_jax(D):
    """decode_chunk of 5 tokens (the verify step) after a 9-token prefill
    against the JAX package's and against 5 of the port's decode steps;
    prefill_chunked in chunks of 8 over S 21 (a ragged last chunk) against
    the JAX package's and against one batched prefill."""
    jcfg, jparams, model, _ = _pair(D, 23)
    Bq, C, page = 2, 5, 16
    toks = np.random.RandomState(24).randint(0, 64, (Bq, 21)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    _, jc = jllama.prefill(jparams, jc, jnp.asarray(toks[:, :9]), jcfg)
    jl, jc = jllama.decode_chunk(jparams, jc, jnp.asarray(toks[:, 9:14]),
                                 jcfg)
    caches = []
    for _ in range(2):
        c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
        _, c = llama.prefill(model, c, torch.from_numpy(toks[:, :9]))
        caches.append(c)
    l1, c1 = llama.decode_chunk(model, caches[0], torch.from_numpy(
        toks[:, 9:14]))
    l2, _ = _port_steps(model, caches[1], toks[:, 9:14])
    assert l1.shape == (Bq, C, 64)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_allclose(l1.numpy(), l2, atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(c1.lengths.numpy(),
                                  np.asarray(jc["lengths"]))
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    jl, jc = jllama.prefill_chunked(jparams, jc, jnp.asarray(toks), jcfg,
                                    chunk=8)
    c1 = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    l1, c1 = llama.prefill(model, c1, torch.from_numpy(toks))
    c2 = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    l2, c2 = llama.prefill_chunked(model, c2, torch.from_numpy(toks),
                                   chunk=8)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c2, name).numpy(),
                                   np.asarray(jc[name]), atol=LOGIT_ATOL)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_llama_speculative_matches_jax(D):
    """speculative_generate with a weak draft (another seed), gamma 4 (a
    verify chunk of 5): tokens equal the JAX package's and the port's
    greedy ``generate``, acceptance equal the JAX package's."""
    jcfg, jparams, model, _ = _pair(D, 27)
    _, jdraft, draft, _ = _pair(D, 28)
    prompt = np.random.RandomState(29).randint(0, 64, (2, 9)).astype(
        np.int32)
    want = llama.generate(model, torch.from_numpy(prompt), 8,
                          max_pages=2).numpy()
    jtoks, jacc = jllama.speculative_generate(
        jparams, jnp.asarray(prompt), 8, jcfg, jdraft, jcfg, gamma=4,
        max_pages=2)
    toks, acc = llama.speculative_generate(
        model, torch.from_numpy(prompt), 8, draft, gamma=4, max_pages=2)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(toks.numpy(), want)
    assert acc == jacc


@pytest.mark.parametrize("ring", [False, True], ids=["window", "ring"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_llama_streaming_decode_matches_jax(D, ring):
    """StreamingLLM (sinks 16, window 16): 40 decode steps from an empty
    cache of 3 pages of 16, windowed in an unbounded cache or on a ring
    whose 48 slots recycle, logits (and the ring's pos_meta) against the
    JAX package's."""
    jcfg, jparams, model, jstep = _pair(D, 31, stream="ring" if ring
                                        else "window")
    toks = np.random.RandomState(32).randint(0, 64, (1, 60)).astype(
        np.int32)
    pages = 3 if ring else 4
    jc, jls = jllama.init_kv_cache(jcfg, 1, pages, 16), []
    for i in range(toks.shape[1]):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, i]))
        jls.append(np.asarray(jl))
    got, c = _port_steps(model, llama.init_kv_cache(
        model.cfg, 1, pages, 16, "cpu"), toks)
    np.testing.assert_allclose(got, np.stack(jls, 1), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    if ring:
        np.testing.assert_array_equal(c.pos_meta.numpy(),
                                      np.asarray(jc["pos_meta"]))
    else:
        assert c.pos_meta is None


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_llama_beam_generate_matches_jax(D):
    """beam_generate on the paged allocator: the port's beams equal the
    JAX package's and its scores agree to 1e-5; the best beam's score is
    also its tokens' log-prob, recomputed by a forward."""
    jcfg, jparams, model, _ = _pair(D, 33)
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
