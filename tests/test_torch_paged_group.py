"""Paged attention past 8 query heads a kv head in cubecl_tpu_torch against
cubecl_tpu: P1 at G 9, 12, 16 and 71 (Mistral-Large-2's 12, MiniMax's 16,
Falcon-7B's multi-query 71) on both JAX grids (P2 and P1), in every mode
(every position, window + sinks, the ring), on f32 and int8 pools; P1's row
groups, split over positions and combine emulated in numpy; the plan's
arithmetic (every query row and position to one block); P3 at G 12 and 16;
and the llama at G 12 and 16 served through ``decode_step``,
``decode_chunk``, ``prefill_chunked`` and ``speculative_generate``.

The port runs its plain versions on these CPU tensors (on the card the same
shapes launch csrc/paged_attention.cu's row groups, held to the plain
versions by tests/test_torch_cuda.py); the JAX kernels run in Pallas
interpret mode on stacked pools (the JAX ring takes layer 1's pool alone).
f32 tolerances, summation order only: the kernels atol 2e-5 / rtol 1e-4,
the model's logits atol 3e-5 / rtol 1e-4 (tests/test_torch_serving.py's).
int8 pools given to both sides as the same values and scales take the
kernels' tolerance. Greedy tokens equal.
"""

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
    P1_FULL,
    P1_RING,
    P1_TILE,
    P1_WINDOW,
    P1Plan,
    p1_group_rows,
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
B, L, P, PAGE, MAX_PAGES = 3, 2, 30, 8, 8
# a length-0 row, mid-page, the full capacity
LENGTHS = np.array([0, 13, 64], np.int32)
# (G, Hkv, D): G 9 (one row past 8), Mistral-Large-2's G 12 at D 128,
# G 16 on one kv head, Falcon-7B's multi-query G 71 at D 64
LAYOUTS = [(9, 2, 64), (12, 2, 128), (16, 1, 64), (71, 1, 64)]
LAYOUT_IDS = [f"G{g}-Hkv{h}-D{d}" for g, h, d in LAYOUTS]


@pytest.fixture(scope="module", params=LAYOUTS, ids=LAYOUT_IDS)
def pools(request):
    """q, f32 pools, int8 pools with their scales (quantize_kv of the f32
    ones), and a table whose rows own disjoint pages (as a ring's do)."""
    G, Hkv, D = request.param
    rng = np.random.default_rng(1000 * G + D)
    q = rng.standard_normal((B, Hkv * G, D), dtype=np.float32)
    kp = rng.standard_normal((L, Hkv, P, PAGE, D), dtype=np.float32)
    vp = rng.standard_normal((L, Hkv, P, PAGE, D), dtype=np.float32)
    (k8, ks), (v8, vs) = (quantize_kv(torch.from_numpy(x)) for x in (kp, vp))
    table = rng.permutation(P)[:B * MAX_PAGES].reshape(B, MAX_PAGES)
    return dict(G=G, Hkv=Hkv, D=D, q=q, f32=(kp, vp, None, None),
                int8=tuple(t.numpy() for t in (k8, v8, ks, vs)),
                table=table.astype(np.int32), refs={})


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


def _full_ref(pools, kv, dynamic_grid):
    """The JAX P1 on layer 1, every position below the length, computed
    once a module's layout."""
    key = (kv, dynamic_grid)
    if key not in pools["refs"]:
        pools["refs"][key] = _jax(pools, kv, LENGTHS, layer=1,
                                  dynamic_grid=dynamic_grid)
    return pools["refs"][key]


# -- P1 -----------------------------------------------------------------------

# f32 pools on the JAX P1's static grid, int8 on P2's live work list
GRIDS = {"f32": False, "int8": True}


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_decode_matches_jax_kernel(pools, kv):
    """Every position below the length, layer 1 of the stacked pools, on
    both of the JAX kernel's grids; a length-0 row's zeros."""
    ref = _full_ref(pools, kv, GRIDS[kv])
    got = _port(pools, kv, LENGTHS, layer=1)
    assert got.shape == pools["q"].shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert not got[LENGTHS == 0].any()


def test_windowed_matches_jax_kernel(pools):
    """Window 20 + sinks 9 (sinks that end inside a page, a window that
    starts inside a tile) against the JAX P1: f32 pools on its static grid
    at G 12 and 71, int8 on its live work list at G 9 and 16."""
    kv = "f32" if pools["G"] in (12, 71) else "int8"
    ref = _jax(pools, kv, LENGTHS, layer=1, window=20, sinks=9,
               dynamic_grid=GRIDS[kv])
    got = _port(pools, kv, LENGTHS, layer=1, window=20, sinks=9)
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


def test_ring_matches_jax_kernel(pools):
    """Ring positions from pos_meta (sinks 8, window 40 on 64 slots),
    recycled slots holding stale positions and a row that never wrote,
    against the JAX P1 on layer 1's pool (int8 pools at G 12 and 71, f32
    at G 9 and 16)."""
    kv = "int8" if pools["G"] in (12, 71) else "f32"
    lengths = np.array([0, 70, 130], np.int32)
    meta = _ring_meta(pools["table"], lengths, PAGE * MAX_PAGES, 8)
    ref = _jax(pools, kv, lengths, window=40, sinks=8,
               pos_meta=jnp.asarray(meta))
    got = _port(pools, kv, lengths, layer=1, window=40, sinks=8,
                pos_meta=torch.from_numpy(meta))
    np.testing.assert_allclose(got[1:], ref[1:], atol=ATOL, rtol=RTOL)
    assert not got[0].any()


def _p1_blocks(pools, lengths, layer, splits):
    """P1's arithmetic in f32 numpy at any G: block x of a (batch row, kv
    head) is split x // groups of the positions (p1_split_positions) for
    the query rows of row group x % groups (p1_group_rows), 8 warps each
    an online softmax over its 8 positions of every 64-position tile (base
    2), combined in the block; each block writes its rows' partials, one a
    (split, query row), and the second launch combines a row's splits."""
    G, Hkv, D = pools["G"], pools["Hkv"], pools["D"]
    q, (kp, vp, _, _), table = pools["q"], pools["f32"], pools["table"]
    S = MAX_PAGES * PAGE
    scale = 1.0 / math.sqrt(D) * math.log2(math.e)
    groups = -(-G // 8)
    plan = P1Plan(256, 0, (splits * groups, Hkv, B), splits, 0, P1_FULL,
                  groups)

    def combine(parts):
        big = np.max([m for m, _, _ in parts], 0)
        big = np.where(np.isinf(big), 0.0, big)
        return (big, sum(lv * np.exp2(m - big) for m, lv, _ in parts),
                sum(a * np.exp2(m - big)[:, None] for m, _, a in parts))

    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for hk in range(Hkv):
            kc = kp[layer, hk][table[b]].reshape(S, D)
            vc = vp[layer, hk][table[b]].reshape(S, D)
            part = [[None] * G for _ in range(splits)]
            for x in range(plan.grid[0]):
                s, g0, g1 = x // groups, *p1_group_rows(G, x % groups)
                assert 0 < g1 - g0 <= 8
                qr = q[b, hk * G + g0:hk * G + g1]
                p0, p1 = p1_split_positions(plan, int(lengths[b]), s)
                warps = []
                for w in range(8):
                    t = np.array([i for i in range(p0, p1)
                                  if (i - p0) % P1_TILE // 8 == w], np.int64)
                    if not len(t):
                        warps.append((np.full(g1 - g0, -np.inf),
                                      np.zeros(g1 - g0),
                                      np.zeros((g1 - g0, D))))
                        continue
                    sc = (qr @ kc[t].T) * scale
                    m = sc.max(1)
                    p = np.exp2(sc - m[:, None])
                    warps.append((m, p.sum(1), p @ vc[t]))
                m, lv, acc = combine(warps)
                m = np.where(lv == 0, -np.inf, m)
                for r in range(g1 - g0):
                    assert part[s][g0 + r] is None
                    part[s][g0 + r] = (m[r:r + 1], lv[r:r + 1], acc[r:r + 1])
            for g in range(G):
                _, lv, acc = combine([part[s][g] for s in range(splits)])
                out[b, hk * G + g] = acc[0] / (lv[0] if lv[0] else 1.0)
    return out


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_p1_row_groups_split_and_combine_match_jax_kernel(pools, splits):
    """P1's row groups, its split over positions and its two combines,
    emulated in f32, against the JAX P1 on layer 1."""
    ref = _full_ref(pools, "f32", GRIDS["f32"])
    got = _p1_blocks(pools, LENGTHS, 1, splits)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert not got[0].any()


@pytest.mark.parametrize("G", [9, 10, 12, 16, 17, 24, 48, 64, 65, 71, 96,
                               127])
def test_p1_row_groups_cover_the_rows(G):
    """ceil(G / 8) row groups of at most 8 rows, none empty, in order, that
    cover the kv head's G rows once."""
    groups = -(-G // 8)
    cuts = [p1_group_rows(G, i) for i in range(groups)]
    assert cuts[0][0] == 0 and cuts[-1][1] == G
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert all(0 < g1 - g0 <= 8 for g0, g1 in cuts)


# P1's plan past 8 query heads a kv head: (q dtype, pool dtype, B, H, Hkv,
# D, page, max_pages) of phase zc1's layouts (Mistral-Large-2's serving
# decode, G 16, Falcon-7B's multi-query attention, G 9 on pages of 7, G 12
# on pages of 1) and few (batch row, kv head) pairs with many row groups
P1_GROUP_SHAPES = [
    (torch.bfloat16, torch.bfloat16, 8, 96, 8, 128, 128, 9),
    (torch.bfloat16, torch.int8, 8, 96, 8, 128, 128, 9),
    (torch.float32, torch.float32, 8, 96, 8, 128, 128, 9),
    (torch.bfloat16, torch.bfloat16, 8, 32, 2, 128, 128, 16),
    (torch.bfloat16, torch.bfloat16, 8, 71, 1, 64, 128, 16),
    (torch.float32, torch.int8, 5, 18, 2, 96, 7, 40),
    (torch.bfloat16, torch.bfloat16, 3, 48, 4, 128, 1, 300),
    (torch.bfloat16, torch.bfloat16, 1, 71, 1, 64, 16, 2),
    (torch.float32, torch.float32, 1, 127, 1, 64, 128, 33),
]
P1_LENGTHS = [0, 1, 63, 64, 65, 129, 300, 1056, 2048, 4096]


@pytest.mark.parametrize("shape", P1_GROUP_SHAPES,
                         ids=lambda s: "-".join(map(str, s[2:])))
def test_p1_plan_gives_every_row_and_position_to_one_block(shape):
    """p1_plan past 8 query heads a kv head: the grid is (splits * groups,
    Hkv, B) with groups = ceil(G / 8); the splits count every block of a
    (batch row, kv head) and never exceed its tiles; every (query row,
    position below the length) of a (batch row, kv head) is one block's,
    in full and window mode; the scratch is the combine's (D + 2) floats a
    query row and split; the instance's shared memory is G 8's."""
    dt, kv, Bq, Hq, Hk, D, page, max_pages = shape
    G = Hq // Hk
    for window, sinks, ring in ((0, 0, False), (100, 4, False),
                                (100, 4, True)):
        plan = p1_plan(dt, kv, Bq, Hq, Hk, D, page, max_pages, window,
                       sinks, ring)
        assert plan.mode == (P1_RING if ring else P1_WINDOW if window
                             else P1_FULL)
        assert plan.groups == -(-G // 8)
        assert plan.grid == (plan.splits * plan.groups, Hk, Bq)
        assert plan.smem_bytes == p1_plan(dt, kv, Bq, 8 * Hk, Hk, D, page,
                                          max_pages, window, sinks,
                                          ring).smem_bytes
        assert plan.scratch == (Bq * Hq * plan.splits * (D + 2)
                                if plan.splits > 1 else 0)
        per_sm = 2 if 233472 // (plan.smem_bytes + 1024) >= 2 else 1
        blocks = plan.splits * plan.groups * Bq * Hk
        assert plan.splits == 1 or blocks <= 132 * per_sm
        assert plan.splits <= max(1, -(-page * max_pages // P1_TILE))
        for length in [n for n in P1_LENGTHS if n <= page * max_pages]:
            seen = np.zeros((G, length), np.int64)
            for x in range(plan.grid[0]):
                g0, g1 = p1_group_rows(G, x % plan.groups)
                s = x // plan.groups
                if window and not ring:
                    for t0 in p1_window_tiles(plan, length, s, window,
                                              sinks):
                        seen[g0:g1, t0:min(t0 + P1_TILE, length)] += 1
                else:
                    p0, p1 = p1_split_positions(plan, length, s)
                    seen[g0:g1, p0:p1] += 1
            pos = np.arange(length)
            want = (pos < sinks) | (pos >= length - window) \
                if window and not ring else pos >= 0
            assert (seen[:, want] == 1).all() and (seen <= 1).all(), \
                (length, plan)


def test_p1_plan_at_few_pairs_keeps_splits_within_tiles():
    """Falcon-7B's G 71 on one kv head: B 8 gives 8 pairs x 9 row groups,
    so 264 // 72 = 3 splits; one row at a short context gets no more
    splits than its tiles; G <= 8 plans are as before (one group)."""
    bf = torch.bfloat16
    plan = p1_plan(bf, bf, 8, 71, 1, 64, 128, 16)
    assert (plan.groups, plan.splits, plan.grid) == (9, 3, (27, 1, 8))
    assert p1_plan(bf, bf, 1, 71, 1, 64, 16, 2).splits == 1
    assert p1_plan(bf, bf, 1, 71, 1, 64, 128, 9).splits == 18  # its tiles
    mistral = p1_plan(bf, bf, 8, 96, 8, 128, 128, 9)
    assert (mistral.groups, mistral.splits) == (2, 2)
    g2 = p1_plan(bf, bf, 8, 16, 8, 128, 128, 9)
    assert (g2.groups, g2.splits, g2.grid) == (1, 4, (4, 8, 8))


def test_p1_plan_refuses_a_group_that_does_not_divide():
    """Any H that is a multiple of Hkv is planned; another H raises."""
    bf = torch.bfloat16
    for H, Hkv in ((96, 8), (71, 1), (256, 2), (8, 8)):
        p1_plan(bf, bf, 2, H, Hkv, 128, 16, 4)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        p1_plan(bf, bf, 2, 97, 8, 128, 16, 4)


# -- P3 -----------------------------------------------------------------------

STARTS = np.array([0, 5, 30], np.int32)


@pytest.mark.parametrize("G, kv, C", [(12, "f32", 5), (16, "int8", 16)],
                         ids=["G12-verify-f32", "G16-prefill-int8"])
def test_chunked_matches_jax_kernel(G, kv, C):
    """P3 at G 12 (the verify step's C 5 on 2 kv heads, D 128) and G 16
    (a prefill-shaped chunk of 16 on one kv head, D 64), from 0, in
    mid-page and after a prefix, lengths = starts + C, layer 1."""
    Hkv, D = (2, 128) if G == 12 else (1, 64)
    rng = np.random.default_rng(10 * C + G)
    q = rng.standard_normal((B, Hkv * G, C, D), dtype=np.float32)
    kp = rng.standard_normal((L, Hkv, P, PAGE, D), dtype=np.float32)
    vp = rng.standard_normal((L, Hkv, P, PAGE, D), dtype=np.float32)
    ks = vs = None
    if kv == "int8":
        (kp, ks), (vp, vs) = (tuple(t.numpy() for t in quantize_kv(
            torch.from_numpy(x))) for x in (kp, vp))
    table = rng.permutation(P)[:B * MAX_PAGES].reshape(B, MAX_PAGES)
    table = table.astype(np.int32)
    lengths = STARTS + C
    ref = jax_paged.paged_attention_chunked(
        *(_j(a) for a in (q, kp, vp, table, lengths, STARTS)),
        interpret=True, k_scales=_j(ks), v_scales=_j(vs), layer=1)
    got = paged_attention_chunked(
        *(_t(a) for a in (q, kp, vp, table, lengths, STARTS)),
        layer=1, k_scales=_t(ks), v_scales=_t(vs))
    assert got.shape == (B, Hkv * G, C, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


# P3's plan past 8 query heads a kv head: (name, B, Hkv, G, C, page,
# max_pages, starts, lengths) of phase zc1 (Mistral-Large-2's verify step
# and chunked prefill, G 16, Falcon-7B's G 71)
P3_GROUP_CASES = [
    ("G12 verify", 8, 8, 12, 5, 128, 9, [1051] * 8, [1056] * 8),
    ("G12 prefill from 768", 8, 8, 12, 256, 128, 9, [768] * 8, [1024] * 8),
    ("G16 verify", 8, 2, 16, 5, 128, 17, [2043] * 8, [2048] * 8),
    ("G71 verify", 8, 1, 71, 5, 128, 17, [2043] * 8, [2048] * 8),
]


@pytest.mark.parametrize("case", P3_GROUP_CASES, ids=lambda c: c[0])
def test_p3_plan_gives_every_position_to_one_block(case):
    """p3_plan at G 12, 16 and 71 (bf16 body): 64-row tiles cut the G * C
    rows, a tile that is decode-shaped splits its positions; for every
    batch row and row the blocks' positions are disjoint and cover those
    the row attends."""
    name, Bq, Hk, G, C, page, max_pages, starts, lengths = case
    plan = p3_plan(torch.bfloat16, torch.bfloat16, Bq, Hk * G, Hk, C, 128,
                   page, max_pages)
    rows = -(-G * C // 64)
    assert plan.grid == (rows * plan.splits, Hk, Bq)
    for b in range(Bq):
        seen = np.zeros((G * C, page * max_pages), np.int64)
        for x in range(plan.grid[0]):
            r0, r_end, p0, p1 = p3_block_positions(plan, C, G, starts[b],
                                                   lengths[b], x)
            seen[r0:r_end, p0:p1] += 1
        assert (seen <= 1).all()
        attended = np.arange(page * max_pages)[None] < np.minimum(
            lengths[b], starts[b] + np.arange(G * C) % C + 1)[:, None]
        assert (seen[attended] == 1).all()


# -- the llama past 8 query heads a kv head -----------------------------------

# G 12: 24 heads of 64 on 2 kv heads; G 16: 16 heads on one
GROUPED = {12: dict(n_heads=24, n_kv_heads=2), 16: dict(n_heads=16,
                                                         n_kv_heads=1)}
BASE = dict(vocab=64, n_layers=2, d_ff=128, seq=64, use_flash_attention=False,
            use_framework_kernels=False)


def _pair(G, seed):
    """(JAX config, JAX params, port model) on the same weights."""
    kw = dict(BASE, d_model=64 * GROUPED[G]["n_heads"], **GROUPED[G])
    jcfg = jllama.LlamaConfig(**kw)
    jparams = jllama.init_params(jcfg, seed=seed)
    model = llama.Llama(llama.LlamaConfig(**kw), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    cfg = model.cfg
    assert cfg.head_dim == 64 and cfg.n_heads // cfg.n_kv_heads == G
    return jcfg, jparams, model


@pytest.mark.parametrize("G, verify", [(12, True), (16, False)],
                         ids=["G12", "G16"])
def test_llama_decode_steps_match_jax(G, verify):
    """prefill of a 9-token prompt, 6 decode steps fed the JAX steps' own
    greedy tokens, then (G 12) a decode_chunk of 5, the verify step; G
    16's chunks are test_llama_prefill_chunked_matches_jax's: logits
    against the JAX package's, greedy tokens equal, lengths equal."""
    jcfg, jparams, model = _pair(G, 50 + G)
    Bq, page = 2, 16
    rng = np.random.RandomState(G)
    prompt = rng.randint(0, 64, (Bq, 9)).astype(np.int32)
    chunk = rng.randint(0, 64, (Bq, 5)).astype(np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    jl, jc = jllama.prefill(jparams, jc, jnp.asarray(prompt), jcfg)
    c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    lg, c = llama.prefill(model, c, torch.from_numpy(prompt))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    jstep = jax.jit(lambda p, c_, t: jllama.decode_step(p, c_, t, jcfg))
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(6):
        jl, jc = jstep(jparams, jc, tok)
        lg, c = llama.decode_step(model, c, torch.from_numpy(
            np.asarray(tok)))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        np.testing.assert_array_equal(lg.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    if verify:
        jl5, jc = jllama.decode_chunk(jparams, jc, jnp.asarray(chunk), jcfg)
        l5, c = llama.decode_chunk(model, c, torch.from_numpy(chunk))
        assert l5.shape == (Bq, 5, 64)
        np.testing.assert_allclose(l5.numpy(), np.asarray(jl5),
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(c.lengths.numpy(),
                                  np.asarray(jc["lengths"]))


@pytest.mark.parametrize("G", [16])
def test_llama_prefill_chunked_matches_jax(G):
    """Chunks of 8 over S = 21 (a ragged last chunk, decode_chunk three
    times) against the JAX package's and against the port's one batched
    prefill, at G 16 (G 12's decode_chunk is the decode test's verify
    step)."""
    jcfg, jparams, model = _pair(G, 60 + G)
    Bq, S, page = 2, 21, 16
    prompt = np.random.RandomState(70 + G).randint(0, 64, (Bq, S)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    jl, _ = jllama.prefill_chunked(jparams, jc, jnp.asarray(prompt), jcfg,
                                   chunk=8)
    c1 = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    l1, _ = llama.prefill(model, c1, torch.from_numpy(prompt))
    c2 = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    l2, _ = llama.prefill_chunked(model, c2, torch.from_numpy(prompt),
                                  chunk=8)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)


@pytest.mark.parametrize("G", [12])
def test_llama_speculative_matches_jax(G):
    """speculative_generate at G 12 (Mistral-Large-2's group) with the
    target as its own draft: tokens equal the JAX package's and the port's
    greedy ``generate``, acceptance equal the JAX package's (gamma)."""
    jcfg, jparams, model = _pair(G, 80 + G)
    prompt = np.random.RandomState(90 + G).randint(0, 64, (2, 6)).astype(
        np.int32)
    want = llama.generate(model, torch.from_numpy(prompt), 6,
                          max_pages=2).numpy()
    jtoks, jacc = jllama.speculative_generate(
        jparams, jnp.asarray(prompt), 6, jcfg, jparams, jcfg, gamma=3,
        max_pages=2)
    toks, acc = llama.speculative_generate(
        model, torch.from_numpy(prompt), 6, model, gamma=3, max_pages=2)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(toks.numpy(), want)
    assert acc == jacc == 3.0
