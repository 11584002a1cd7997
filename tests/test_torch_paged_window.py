"""StreamingLLM serving in cubecl_tpu_torch against cubecl_tpu: P1's window +
sinks and ring options, and llama's ``attn_window``, ``attn_sinks`` and
``ring_cache``.

The port's ``paged_attention`` runs its plain version on these CPU tensors;
the JAX P1 runs in Pallas interpret mode (window and ring calls take its
static capacity grid). Windowed calls use stacked pools; the JAX package
takes ring metadata only with a per-layer pool, so ring calls give it layer
1's pool and the port the stacked one with ``layer=1``. The llama configs
are those of ``tests/test_models.py``'s StreamingLLM tests (d 64, 2 query /
1 kv head, 2 layers), with the JAX decode steps jitted. f32 tolerances: the
kernels atol 2e-5 / rtol 1e-4, the model's logits atol 1e-5 / rtol 1e-4
(``tests/test_torch_llama.py``'s), both summation order only; an int8 cache
atol 0.02 (``tests/test_torch_serving.py``'s: a rounding may fall on the
other side of .5).

One deviation is held here: a ring row with no live position gets zeros
in the port, as every other P1 row does; the JAX ring kernel masks with a
finite value there and returns the mean of V over the visited slots
(ROADMAP Queue 3, F14).
"""

import dataclasses
import importlib

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
    p1_plan,
    p1_split_positions,
    p1_window_tiles,
    paged_attention,
    quantize_kv,
)

jax_paged = importlib.import_module("cubecl_tpu.ops.paged_attention")

ATOL, RTOL = 2e-5, 1e-4
LOGIT_ATOL, LOGIT_RTOL = 1e-5, 1e-4
INT8_ATOL = 0.02
B, H, HKV, D = 5, 4, 2, 64
L, P, PAGE, MAX_PAGES = 2, 24, 8, 4
# a length-0 row, mid-page, the full capacity, one position, two pages
LENGTHS = np.array([0, 13, 32, 1, 20], np.int32)
# (window, sinks): sinks without a window (ignored), a window alone, both,
# a window longer than any context, sinks that end inside a page
WINDOWS = [(0, 3), (5, 0), (6, 3), (40, 2), (8, 9)]


@pytest.fixture(scope="module")
def pools():
    """q, f32 pools, int8 pools with scales, and tables whose rows own
    disjoint pages (as a ring's rows do)."""
    rng = np.random.default_rng(19)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    vp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    (k8, ks), (v8, vs) = (quantize_kv(torch.from_numpy(x)) for x in (kp, vp))
    table = rng.permutation(P)[:B * MAX_PAGES].reshape(B, MAX_PAGES)
    return dict(q=q, f32=(kp, vp, None, None),
                int8=tuple(t.numpy() for t in (k8, v8, ks, vs)),
                table=table.astype(np.int32))


def _port(pools, kv, lengths, **kw):
    kp, vp, ks, vs = pools[kv]
    t = {k: None if a is None else torch.from_numpy(np.asarray(a))
         for k, a in dict(q=pools["q"], kp=kp, vp=vp, ks=ks, vs=vs,
                          table=pools["table"], lengths=lengths).items()}
    return paged_attention(t["q"], t["kp"], t["vp"], t["table"],
                           t["lengths"], k_scales=t["ks"], v_scales=t["vs"],
                           **kw).numpy()


def _jax(pools, kv, lengths, layer=None, **kw):
    """The JAX P1 on the stacked pools (``layer``) or, for a ring, on
    layer 1's pool."""
    kp, vp, ks, vs = pools[kv]
    if layer is None:
        kp, vp = kp[1], vp[1]
        ks, vs = (None, None) if ks is None else (ks[1], vs[1])
    else:
        kw["layer"] = layer
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(jax_paged.paged_attention(
        j(pools["q"]), j(kp), j(vp), j(pools["table"]), j(lengths),
        k_scales=j(ks), v_scales=j(vs), interpret=True, **kw))


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("window,sinks", WINDOWS,
                         ids=[f"w{w}-s{s}" for w, s in WINDOWS])
def test_windowed_matches_jax_kernel(pools, kv, window, sinks):
    """Window + sinks on stacked pools, layer 1, against the JAX P1."""
    ref = _jax(pools, kv, LENGTHS, layer=1, window=window, sinks=sinks)
    got = _port(pools, kv, LENGTHS, layer=1, window=window, sinks=sinks)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert not got[LENGTHS == 0].any()


def test_window_masks_what_it_says(pools):
    """The window bites: a row longer than sinks + window differs from
    full attention, a row that fits in it does not, and sinks alone (no
    window) change nothing."""
    full = _port(pools, "f32", LENGTHS, layer=1)
    win = _port(pools, "f32", LENGTHS, layer=1, window=6, sinks=3)
    fits = LENGTHS <= 9
    np.testing.assert_array_equal(win[fits], full[fits])
    assert (np.abs(win[~fits] - full[~fits]).max(axis=(1, 2)) > 1e-3).all()
    np.testing.assert_array_equal(
        _port(pools, "f32", LENGTHS, layer=1, sinks=5), full)


def _ring_meta(table, lengths, capacity, sinks):
    """pos_meta as a ring that decoded each row token by token leaves it:
    position t at table order t below the sinks, else at sinks + (t -
    sinks) % (capacity - sinks), the newest position a slot got; -1 where
    none came."""
    meta = np.full((P, PAGE), -1, np.int32)
    for b, n in enumerate(lengths):
        for t in range(n):
            j = t if t < sinks else sinks + (t - sinks) % (capacity - sinks)
            meta[table[b, j // PAGE], j % PAGE] = t
    return meta


# (lengths, sinks, window): unwrapped rows with never-written (-1) slots;
# rows past the capacity of 32 whose recycled slots hold stale positions,
# masked by the window or (window 0) read as they are
RING_CASES = {
    "fresh": ([0, 13, 32, 1, 20], 8, 16),
    "recycled": ([40, 33, 57, 32, 90], 8, 16),
    "recycled-no-sinks": ([40, 33, 57, 32, 90], 0, 24),
    "recycled-no-window": ([40, 33, 57, 32, 90], 8, 0),
}


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_matches_jax_kernel(pools, kv, case):
    """Ring positions from pos_meta against the JAX P1 with ``pos_meta``
    on layer 1's pool; rows with no live position get zeros (F14)."""
    lengths, sinks, window = RING_CASES[case]
    lengths = np.array(lengths, np.int32)
    meta = _ring_meta(pools["table"], lengths, PAGE * MAX_PAGES, sinks)
    ref = _jax(pools, kv, lengths, window=window, sinks=sinks,
               pos_meta=jnp.asarray(meta))
    got = _port(pools, kv, lengths, layer=1, window=window, sinks=sinks,
                pos_meta=torch.from_numpy(meta))
    live = lengths > 0
    np.testing.assert_allclose(got[live], ref[live], atol=ATOL, rtol=RTOL)
    assert not got[~live].any()


def test_ring_stale_and_unwritten_slots_mask(pools):
    """A ring row attends exactly the slots whose meta is in its window,
    held to a softmax over the positions gathered by hand: a slot marked
    -1, one with a stale position below the window and one with a
    position past the length; a meta all stale gives zeros."""
    q, (kp, vp, _, _), table = pools["q"], pools["f32"], pools["table"]
    lengths = np.array([30, 30, 30, 30, 30], np.int32)
    meta = _ring_meta(table, lengths, 32, 0)
    meta[table[1, 0], 2] = -1          # unwritten
    meta[table[1, 1], 0] = 3           # stale: below the window
    meta[table[1, 2], 1] = 31          # past the length
    meta[table[2]] = 1                 # all stale for row 2
    got = _port(pools, "f32", lengths, layer=1, window=20, sinks=0,
                pos_meta=torch.from_numpy(meta))
    assert not got[2].any()
    slots = meta[table[1]].reshape(-1)
    keep = (slots >= 10) & (slots < 30)
    k = kp[1][:, table[1]].reshape(HKV, -1, D)[:, keep]
    v = vp[1][:, table[1]].reshape(HKV, -1, D)[:, keep]
    for h in range(H):
        s = q[1, h] @ k[h // 2].T / np.sqrt(D)
        p = np.exp(s - s.max())
        np.testing.assert_allclose(got[1, h], p @ v[h // 2] / p.sum(),
                                   atol=ATOL, rtol=RTOL)


# P1's plan in each mode, and the tiles its splits walk: shapes (q dtype,
# pool dtype, B, H, Hkv, D, page, max_pages) of the streaming phases (a
# 4224-position table, a 272-position ring), one row and a card-filling
# batch
PLAN_SHAPES = [
    (torch.bfloat16, torch.bfloat16, 8, 16, 8, 128, 128, 33),
    (torch.bfloat16, torch.int8, 8, 16, 8, 128, 16, 17),
    (torch.float32, torch.float32, 1, 8, 2, 64, 16, 64),
    (torch.float32, torch.float32, 2, 12, 4, 64, 7, 30),
    (torch.bfloat16, torch.bfloat16, 200, 16, 8, 128, 128, 33),
]
PLAN_WINDOWS = [(2000, 4), (240, 16), (1, 0), (100, 0), (64, 64), (7, 130),
                (5000, 3)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "-".join(map(str, s[2:])))
def test_window_plan_gives_every_live_position_to_one_split(shape):
    """p1_window_tiles (the kernel's WindowTiles): for every length up to
    the capacity, the splits walk each tile holding a live position
    (below the sinks or in the window) exactly once and no tile without
    one; the split count is at most the live tiles a row can have."""
    dt, kv, Bp, Hp, Hk, Dp, page, max_pages = shape
    cap = page * max_pages
    for window, sinks in PLAN_WINDOWS:
        plan = p1_plan(dt, kv, Bp, Hp, Hk, Dp, page, max_pages, window,
                       sinks)
        assert plan.mode == P1_WINDOW and plan.grid == (plan.splits, Hk, Bp)
        full = p1_plan(dt, kv, Bp, Hp, Hk, Dp, page, max_pages)
        assert plan.smem_bytes == full.smem_bytes
        assert plan.splits <= full.splits
        most = 0
        for length in sorted({0, 1, 63, 64, 65, sinks, window,
                              sinks + window, sinks + window + 1,
                              cap // 2, cap - 1, cap}):
            if not 0 <= length <= cap:
                continue
            pos = np.arange(length)
            live = (pos < sinks) | (pos >= length - window)
            want = sorted({int(t) // P1_TILE * P1_TILE for t in pos[live]})
            walked = [t for s in range(plan.splits)
                      for t in p1_window_tiles(plan, length, s, window,
                                               sinks)]
            assert walked == want, (length, window, sinks)
            most = max(most, len(walked))
        bound = -(-min(sinks, cap) // P1_TILE) + (window - 1) // P1_TILE + 2
        assert most <= bound and plan.splits <= bound


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "-".join(map(str, s[2:])))
def test_ring_plan_walks_the_written_slots(shape):
    """The ring's plan: the full walk's splits over min(length, capacity)
    table-order slots (p1_split_positions), each slot once; its stages
    carry the slots' positions (8 warps x 3 stages x 8 x 4 bytes more)."""
    dt, kv, Bp, Hp, Hk, Dp, page, max_pages = shape
    cap = page * max_pages
    plan = p1_plan(dt, kv, Bp, Hp, Hk, Dp, page, max_pages, 16, 16, True)
    full = p1_plan(dt, kv, Bp, Hp, Hk, Dp, page, max_pages)
    assert plan.mode == P1_RING and full.mode == P1_FULL
    assert plan.smem_bytes - full.smem_bytes in (0, 8 * 3 * 8 * 4)
    assert plan.splits <= full.splits
    for length in (0, 1, 64, cap - 1, cap, cap + 1, 3 * cap + 17):
        n = min(length, cap)
        seen = np.zeros(n, np.int64)
        for s in range(plan.splits):
            p0, p1 = p1_split_positions(plan, n, s)
            seen[p0:p1] += 1
        assert (seen == 1).all(), (length, plan)


def test_window_plan_splits_from_the_live_tiles():
    """At the streaming phase's shape (B 8 x Hkv 8, bf16 D 128, 33 pages
    of 128): 4 splits, as the full walk; a one-row batch splits its live
    tiles, not the table's; sinks alone keep the full plan."""
    bf = torch.bfloat16
    assert p1_plan(bf, bf, 8, 16, 8, 128, 128, 33, 2000, 4).splits == 4
    assert p1_plan(bf, bf, 1, 16, 8, 128, 128, 33).splits == 33
    assert p1_plan(bf, bf, 1, 16, 8, 128, 128, 33, 256, 4).splits == 6
    assert p1_plan(bf, bf, 1, 16, 8, 128, 128, 33, 0, 4) == \
        p1_plan(bf, bf, 1, 16, 8, 128, 128, 33)


# -- llama: tests/test_models.py's StreamingLLM configs -----------------------

STREAM = dict(vocab=64, d_model=64, n_heads=2, n_kv_heads=1, n_layers=2,
              d_ff=128, seq=64, attn_window=16, attn_sinks=16,
              use_flash_attention=False, use_framework_kernels=False)


def _pair(seed, **over):
    """(JAX config, JAX params, port model) on the same weights."""
    jcfg = jllama.LlamaConfig(**{**STREAM, **over})
    jparams = jllama.init_params(jcfg, seed=seed)
    model = llama.Llama(llama.LlamaConfig(**{**STREAM, **over}), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, model


def _jax_steps(jcfg, jparams, toks, pages, page=16):
    """The JAX decode steps (jitted) over toks (B, n) from an empty cache:
    the logits of every step and the final cache."""
    jstep = jax.jit(lambda p, c, t: jllama.decode_step(p, c, t, jcfg))
    jc = jllama.init_kv_cache(jcfg, toks.shape[0], pages, page)
    out = []
    for i in range(toks.shape[1]):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, i]))
        out.append(np.asarray(jl))
    return np.stack(out, 1), jc


def _port_steps(model, toks, pages, page=16):
    c = llama.init_kv_cache(model.cfg, toks.shape[0], pages, page, "cpu")
    out = []
    for i in range(toks.shape[1]):
        lg, c = llama.decode_step(model, c, torch.from_numpy(toks[:, i]))
        out.append(lg.numpy())
    return np.stack(out, 1), c


@pytest.fixture(scope="module")
def windowed():
    """test_llama_streaming_window_decode's run: 48 windowed steps (sinks
    16, window 16) from an empty 4-page cache, seed 30; and the same
    tokens without the window."""
    jcfg, jparams, model = _pair(30)
    toks = np.random.RandomState(33).randint(0, 64, (1, 48)).astype(np.int32)
    return (model, toks, _jax_steps(jcfg, jparams, toks, 4),
            _jax_steps(dataclasses.replace(jcfg, attn_window=0,
                                           attn_sinks=0), jparams, toks, 4))


def test_windowed_decode_matches_jax(windowed):
    """Every step's logits and the final pools against the JAX package's;
    the window bites once the context passes sinks + window, as in the
    JAX test."""
    model, toks, (jl, jc), (jfull, _) = windowed
    got, c = _port_steps(model, toks, 4)
    np.testing.assert_allclose(got, jl, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc[name]), atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL)
    assert c.pos_meta is None
    np.testing.assert_allclose(got[:, :31], jfull[:, :31], atol=LOGIT_ATOL)
    assert np.abs(got[:, -1] - jfull[:, -1]).max() > 1e-4


@pytest.fixture(scope="module")
def ring():
    """test_llama_ring_cache_bounded_memory's run: 70 steps, seed 40, on
    a ring of 3 pages of 16 (48 slots) and, without the ring, on 8 pages;
    and the same ring with int8 KV."""
    jcfg, jparams, model = _pair(40, ring_cache=True)
    toks = np.random.RandomState(41).randint(0, 64, (1, 70)).astype(np.int32)
    j8 = dataclasses.replace(jcfg, kv_dtype="int8")
    m8 = llama.Llama(dataclasses.replace(model.cfg, kv_dtype="int8"),
                     device="cpu")
    m8.load_state_dict(model.state_dict())
    return (model, m8, toks, _jax_steps(jcfg, jparams, toks, 3),
            _jax_steps(j8, jparams, toks, 3))


def test_ring_decode_matches_jax_past_its_capacity(ring):
    """70 ring steps on 48 slots: logits, pools and pos_meta against the
    JAX package's, and the port's ring against its own unbounded windowed
    cache (8 pages), as the JAX test holds its ring."""
    model, _, toks, (jl, jc), _ = ring
    got, c = _port_steps(model, toks, 3)
    np.testing.assert_allclose(got, jl, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(c.pos_meta.numpy(),
                                  np.asarray(jc["pos_meta"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc[name]), atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL)
    assert c.k.shape[2] == 3 and int(c.lengths[0]) == 70
    unbounded = llama.Llama(dataclasses.replace(model.cfg, ring_cache=False),
                            device="cpu")
    unbounded.load_state_dict(model.state_dict())
    want, cu = _port_steps(unbounded, toks, 8)
    assert cu.pos_meta is None
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_int8_ring_decode_matches_jax(ring):
    """The same ring on int8 KV against the JAX package's int8 ring."""
    _, m8, toks, _, (jl, jc) = ring
    got, c = _port_steps(m8, toks, 3)
    assert c.k.dtype == torch.int8 and c.pos_meta is not None
    np.testing.assert_allclose(got, jl, atol=INT8_ATOL)
    np.testing.assert_array_equal(c.pos_meta.numpy(),
                                  np.asarray(jc["pos_meta"]))


def test_windowed_generate_and_decode_chunk_match_jax():
    """With a window and no ring, ``generate`` is the full-attention
    prefill and windowed decode steps, and ``decode_chunk`` attends the
    whole cache, as the JAX ones: tokens equal, chunk logits within
    tolerance."""
    jcfg, jparams, model = _pair(7, attn_window=8, attn_sinks=4)
    prompt = np.random.RandomState(8).randint(0, 64, (2, 20)).astype(
        np.int32)
    ref = jllama.generate(jparams, jnp.asarray(prompt), 10, jcfg,
                          max_pages=2, page=16)
    got = llama.generate(model, torch.from_numpy(prompt), 10, max_pages=2,
                         page=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    nxt = np.random.RandomState(9).randint(0, 64, (2, 5)).astype(np.int32)
    jc = jllama.init_kv_cache(jcfg, 2, 2, 16)
    _, jc = jllama.prefill(jparams, jc, jnp.asarray(prompt), jcfg)
    jl, jc = jllama.decode_chunk(jparams, jc, jnp.asarray(nxt), jcfg)
    c = llama.init_kv_cache(model.cfg, 2, 2, 16, "cpu")
    _, c = llama.prefill(model, c, torch.from_numpy(prompt))
    lg, c = llama.decode_chunk(model, c, torch.from_numpy(nxt))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)


def test_ring_is_refused_by_the_chunked_paths():
    """A ring decodes token by token: prefill (as the JAX assert),
    decode_chunk, prefill_chunked and speculative_generate refuse it."""
    cfg = llama.LlamaConfig(**{**STREAM, "ring_cache": True})
    model = llama.init_params(cfg, seed=1, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.int32)
    for fn in (llama.prefill, llama.decode_chunk, llama.prefill_chunked):
        c = llama.init_kv_cache(cfg, 1, 3, 16, "cpu")
        with pytest.raises(ValueError, match="ring"):
            fn(model, c, toks)
        assert int(c.lengths[0]) == 0 and (c.pos_meta == -1).all()
    with pytest.raises(ValueError, match="ring"):
        llama.generate(model, toks, 2, max_pages=3, page=16)
    with pytest.raises(ValueError, match="ring"):
        llama.speculative_generate(model, toks, 2, model, max_pages=3,
                                   page=16)


def test_ring_cache_checks():
    """init_kv_cache refuses a ring where the JAX asserts fail (sinks not
    a multiple of the page, capacity below sinks + window + page); a ring
    without a window, or sinks without a window, is a plain cache."""
    cfg = llama.LlamaConfig(**{**STREAM, "ring_cache": True})
    with pytest.raises(ValueError, match="whole pages"):
        llama.init_kv_cache(dataclasses.replace(cfg, attn_sinks=8), 1, 3,
                            16, "cpu")
    with pytest.raises(ValueError, match="cover"):
        llama.init_kv_cache(cfg, 1, 2, 16, "cpu")
    assert llama.init_kv_cache(cfg, 1, 3, 16, "cpu").pos_meta.shape == \
        (3, 16)
    for over in (dict(attn_window=0), dict(attn_window=0, ring_cache=False)):
        c = llama.init_kv_cache(dataclasses.replace(cfg, **over), 1, 2, 16,
                                "cpu")
        assert c.pos_meta is None
