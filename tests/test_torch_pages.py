"""cubecl_tpu_torch.runtime.pages.PageAllocator (the KV block manager of
``csrc/page_pool.cc``) and the paged serving built on it, against
cubecl_tpu's: twins of every test of tests/test_pages.py.

The allocator tests run on the C++ pool; their parity test drives it and
the JAX package's allocator through random scenarios. The model tests use the small config of tests/test_pages.py
(d 64, 2 query / 1 kv head, 2 layers, plain attention) on the same
``params_from_jax`` weights: the port runs its plain versions on the CPU,
the JAX package its Pallas kernels in interpret mode; f32 logits agree to
atol 1e-5 / rtol 1e-5 as there (3e-5 / 1e-4 after a chunked prefill),
tokens are equal and beam scores agree to 1e-5. Beam search is also held
against a recomputing beam search where the prompt ends on a page
boundary, which the JAX package's paged beam search does not get right.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu.ops.paged_attention import paged_attention as jax_paged
from cubecl_tpu.runtime.pages import PageAllocator as JaxPageAllocator
from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.ops.paged_attention import paged_attention
from cubecl_tpu_torch.runtime.pages import PageAllocator

SMALL = dict(vocab=64, d_model=64, n_heads=2, n_kv_heads=1, n_layers=2,
             d_ff=128, seq=32, use_flash_attention=False,
             use_framework_kernels=False)


def _pair(seed, vocab=64):
    jcfg = jllama.LlamaConfig(**{**SMALL, "vocab": vocab})
    jparams = jllama.init_params(jcfg, seed=seed)
    model = llama.Llama(llama.LlamaConfig(**{**SMALL, "vocab": vocab}),
                        device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, model


def test_admit_extend_release():
    a = PageAllocator(8, page_size=128)
    assert a.num_free_pages() == 8
    assert a.admit(1, 300)          # 3 pages
    assert a.seq_page_count(1) == 3
    assert a.num_free_pages() == 5
    assert a.extend(1, 84)          # 384 tokens: still 3 pages
    assert a.seq_page_count(1) == 3
    assert a.extend(1, 1)           # into page 4
    assert a.seq_page_count(1) == 4
    assert a.lengths[1] == 385
    assert a.release(1) == 4
    assert a.num_free_pages() == 8


def test_pool_exhaustion_backpressure():
    a = PageAllocator(2, page_size=128)
    assert a.admit(1, 200)
    assert not a.admit(2, 1)
    assert not a.extend(1, 100)     # would need a third page: refused
    assert a.lengths[1] == 200      # and nothing changed
    a.release(1)
    assert a.admit(2, 1)


def test_fork_shares_pages_refcounted():
    a = PageAllocator(8, page_size=128)
    assert a.admit(7, 256)
    t = a.block_table([7], 2)[0]
    assert a.fork(7, 8)
    assert a.num_free_pages() == 6          # a fork allocates nothing
    assert a.lengths[8] == 256
    assert all(a.refcount(int(pg)) == 2 for pg in t)
    assert a.extend(8, 1)                   # the branch's own fresh page
    assert a.seq_page_count(8) == 3 and a.seq_page_count(7) == 2
    assert a.refcount(int(a.block_table([8], 3)[0][2])) == 1
    assert a.release(7) == 0                # still held by 8
    assert a.num_free_pages() == 5
    assert a.release(8) == 3
    assert a.num_free_pages() == 8


def test_block_table_padding_and_errors():
    a = PageAllocator(8)
    a.admit(1, 128 * 3)
    a.admit(2, 128)
    t = a.block_table([1, 2], 4)
    assert t.shape == (2, 4) and t.dtype == np.int32
    assert len(set(t[0, :3].tolist())) == 3
    assert t[0, 3] == t[0, 2]               # padded with the last page
    assert (t[1, 1:] == t[1, 0]).all()
    with pytest.raises(KeyError):
        a.block_table([99], 4)
    with pytest.raises(KeyError):
        a.block_table([1], 2)               # 3 pages > max_pages
    assert [a.lengths[s] for s in (2, 1)] == [128, 384]


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_native_and_jax_allocators_agree(seed):
    """One interleaved random scenario (admit, extend, fork, unshare,
    release) on the C++ pool and the JAX package's allocator: every answer,
    free count, page count and block table."""
    allocs = [PageAllocator(16, 128), JaxPageAllocator(16, 128)]
    rng = np.random.RandomState(seed)
    live = []
    for _ in range(300):
        op = rng.randint(5)
        if op == 0:
            seq, n = int(rng.randint(100)), int(rng.randint(1, 4))
            oks = {a.admit(seq, n * 128 - 5) for a in allocs}
            assert len(oks) == 1
            if oks.pop():
                live.append(seq)
        elif op == 1 and live:
            seq = live[rng.randint(len(live))]
            assert len({a.extend(seq, 100) for a in allocs}) == 1
        elif op == 2 and live:
            src, dst = live[rng.randint(len(live))], int(rng.randint(100, 200))
            oks = {a.fork(src, dst) for a in allocs}
            assert len(oks) == 1
            if oks.pop():
                live.append(dst)
        elif op == 3 and live:
            seq = live[rng.randint(len(live))]
            try:
                got = {a.unshare_last(seq) for a in allocs}
            except RuntimeError:       # exhausted: each raises alike
                continue
            assert len(got) == 1
        elif op == 4 and live:
            seq = live.pop(rng.randint(len(live)))
            assert len({a.release(seq) for a in allocs}) == 1
        assert len({a.num_free_pages() for a in allocs}) == 1
        for s in live:
            assert len({a.seq_page_count(s) for a in allocs}) == 1
        if live:
            w = max(a.seq_page_count(s) for s in live for a in allocs[:1])
            tabs = [a.block_table(live, w) for a in allocs]
            np.testing.assert_array_equal(tabs[0], tabs[1])


def test_allocator_drives_paged_attention():
    """The allocator's table and lengths feed paged attention: the port's
    result equals the JAX kernel's on the same table (a fork that grows
    its own page included)."""
    Hkv, H, D, page = 2, 4, 128, 128
    a = PageAllocator(8, page)
    assert a.admit(10, 200) and a.admit(11, 128)
    assert a.fork(11, 12) and a.extend(12, 60)
    seqs = [10, 11, 12]
    table = a.block_table(seqs, 3)
    lengths = np.array([a.lengths[s] for s in seqs], np.int32)
    rng = np.random.RandomState(0)
    kp = (rng.randn(1, Hkv, 8, page, D) * .3).astype(np.float32)
    vp = rng.randn(1, Hkv, 8, page, D).astype(np.float32)
    q = (rng.randn(3, H, D) * .3).astype(np.float32)
    ref = jax_paged(*(jnp.asarray(x) for x in (q, kp[0], vp[0], table,
                                                lengths)), interpret=True)
    got = paged_attention(*(torch.from_numpy(x) for x in (q, kp, vp, table,
                                                           lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)


def test_fork_seq_branch_divergence():
    """Twin of test_fork_seq_branch_divergence: decode a 20-token prefix,
    fork in mid-page, feed the branches different tokens. Each branch's
    logits equal an unforked decode of its own stream and the JAX
    package's forked run; the prefix page is shared, the partial one
    copied."""
    jcfg, jparams, model = _pair(0)
    page, table_w, pool_pages = 16, 4, 12
    prefix = [3, 11, 7, 22, 9, 14, 5, 28, 17, 2, 25, 31, 8, 19, 13, 4,
              27, 6, 21, 10]
    branch_a, branch_b = [33, 42, 35], [55, 40, 61]
    jstep = jax.jit(lambda p, c, t: jllama.decode_step(p, c, t, jcfg))

    def set_rows(cache, alloc, seqs, jax_side):
        rows = np.stack([alloc.block_table([s], table_w)[0] for s in seqs])
        lens = np.array([alloc.lengths[s] - 1 for s in seqs], np.int32)
        if jax_side:
            return dict(cache, page_indices=jnp.asarray(rows),
                        lengths=jnp.asarray(lens))
        cache.page_indices = torch.from_numpy(rows)
        cache.lengths = torch.from_numpy(lens)
        return cache

    def forked(jax_side):
        Alloc = JaxPageAllocator if jax_side else PageAllocator
        alloc = Alloc(pool_pages, page)
        assert alloc.admit(-1, 1) and alloc.admit(0, 1)
        if jax_side:
            cache = jllama.init_kv_cache(jcfg, 2, table_w, page=page,
                                         num_pages=pool_pages)
            step, fork = (lambda c, t: jstep(jparams, c, jnp.asarray(t))), \
                jllama.fork_seq
        else:
            cache = llama.init_kv_cache(model.cfg, 2, table_w, page, "cpu",
                                        num_pages=pool_pages)
            step, fork = (lambda c, t: llama.decode_step(
                model, c, torch.tensor(t, dtype=torch.int32))), llama.fork_seq
        for t in prefix:
            cache = set_rows(cache, alloc, [0, -1], jax_side)
            _, cache = step(cache, np.array([t, 0], np.int32))
            assert alloc.extend(0, 1)
        assert alloc.lengths[0] % page != 0
        cache, ok = fork(cache, alloc, 0, 1)
        assert ok
        assert alloc.refcount(int(alloc.block_table([0], 2)[0][0])) == 2
        assert alloc.block_table([0], 2)[0][1] != \
            alloc.block_table([1], 2)[0][1]
        out = []
        for ta, tb in zip(branch_a, branch_b):
            cache = set_rows(cache, alloc, [0, 1], jax_side)
            lg, cache = step(cache, np.array([ta, tb], np.int32))
            out.append(np.asarray(lg))
            assert alloc.extend(0, 1) and alloc.extend(1, 1)
        return np.stack(out, 1)                 # (2, 3, vocab)

    got = forked(False)
    np.testing.assert_allclose(got, forked(True), atol=1e-5, rtol=1e-5)
    for bi, branch in ((0, branch_a), (1, branch_b)):
        alloc = PageAllocator(pool_pages, page)
        assert alloc.admit(-1, 1) and alloc.admit(0, 1)
        cache = llama.init_kv_cache(model.cfg, 2, table_w, page, "cpu",
                                    num_pages=pool_pages)
        for i, t in enumerate(prefix + branch):
            cache = set_rows(cache, alloc, [0, -1], False)
            lg, cache = llama.decode_step(
                model, cache, torch.tensor([t, 0], dtype=torch.int32))
            assert alloc.extend(0, 1)
            if i >= len(prefix):
                np.testing.assert_allclose(lg[0].numpy(),
                                           got[bi, i - len(prefix)],
                                           atol=1e-5, rtol=1e-5)


def test_fork_seq_copies_int8_scales():
    """A mid-page fork on an int8 cache copies the partial page's values
    and scales."""
    cfg = llama.LlamaConfig(**{**SMALL, "kv_dtype": "int8"})
    cache = llama.init_kv_cache(cfg, 2, 2, 4, "cpu", num_pages=6)
    for pool in (cache.k, cache.v, cache.k_scales, cache.v_scales):
        pool.copy_(torch.randn(pool.shape).to(pool.dtype))
    alloc = PageAllocator(6, 4)
    assert alloc.admit(0, 6)
    cache, ok = llama.fork_seq(cache, alloc, 0, 1)
    assert ok
    old, new = alloc.block_table([0, 1], 2)[:, 1]
    assert old != new
    for pool in (cache.k, cache.v, cache.k_scales, cache.v_scales):
        assert torch.equal(pool[:, :, new], pool[:, :, old])


def _recomputed_beams(model, prompt, steps, K):
    """Beam search that recomputes every beam's whole forward pass at each
    step: (tokens (K, S + steps), summed log-probs (K,)), best first."""
    beams = [(prompt.tolist(), 0.0)]
    for _ in range(steps):
        lps = torch.log_softmax(llama.forward(model, torch.tensor(
            [b[0] for b in beams]))[:, -1].float(), -1).numpy()
        flat = (np.array([b[1] for b in beams])[:, None] + lps).ravel()
        top = np.argsort(-flat)[:K]
        V = lps.shape[1]
        beams = [(beams[i // V][0] + [int(i % V)], float(flat[i]))
                 for i in top]
    return (np.array([b[0] for b in beams], np.int32),
            np.array([b[1] for b in beams], np.float32))


def test_beam_generate_matches_jax():
    """Twin of test_beam_generate_matches_recompute_reference: the port's
    paged beam search gives the JAX package's beams, and its scores to
    1e-5; the best beam equals a recomputing beam search's."""
    jcfg, jparams, model = _pair(5, vocab=48)
    prompt = np.array([7, 31, 2, 19, 11], np.int32)
    K, steps = 3, 4
    jtoks, jscores = jllama.beam_generate(jparams, jnp.asarray(prompt),
                                          steps, jcfg, beams=K, page=16)
    toks, scores = llama.beam_generate(model, torch.from_numpy(prompt),
                                       steps, beams=K, page=16)
    assert toks.shape == (K, len(prompt) + steps) and toks.dtype == \
        torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-5)
    rtoks, _ = _recomputed_beams(model, prompt, steps, K)
    assert toks[0].tolist() == rtoks[0].tolist()


@pytest.mark.parametrize("S", [15, 16, 31])
def test_beam_generate_on_page_boundaries(S):
    """Prompts of page - 1, page and 2 page - 1 tokens (page 16): at
    S = page - 1 every beam's first token falls on the last slot of the
    prompt's page, which the allocator counts full when the beams fork.
    Every beam and score equals a recomputing beam search's."""
    _, _, model = _pair(5, vocab=48)
    prompt = np.random.RandomState(S).randint(0, 48, S).astype(np.int32)
    K, steps = 3, 20
    toks, scores = llama.beam_generate(model, torch.from_numpy(prompt),
                                       steps, beams=K, page=16)
    rtoks, rscores = _recomputed_beams(model, prompt, steps, K)
    np.testing.assert_array_equal(toks.numpy(), rtoks)
    np.testing.assert_allclose(scores.numpy(), rscores, atol=1e-5)


def test_prefix_cache_reuse_and_eviction():
    """Released pages registered under chain hashes come back with the
    same ids, a diverging prompt stops at its first new page, and pool
    pressure evicts cached pages."""
    a = PageAllocator(6, page_size=4)
    toks = list(range(11))               # 2 full pages + a partial one
    assert a.admit_cached(1, toks) == 0
    t1 = a.block_table([1], 3)[0].copy()
    a.lengths[1] = 11
    assert a.register_prefix(1, toks) == 2
    assert a.release(1) == 3
    assert a.num_free_pages() == 6
    assert a.admit_cached(2, toks) == 8
    t2 = a.block_table([2], 3)[0]
    assert t2[0] == t1[0] and t2[1] == t1[1]
    assert a.refcount(int(t2[0])) == 1
    assert a.admit_cached(3, toks[:4] + [99, 98, 97, 96, 95]) == 4
    assert a.block_table([3], 3)[0][0] == t1[0]
    assert a.refcount(int(t1[0])) == 2
    a.release(2)
    a.release(3)
    assert a.admit(10, 4 * 6)            # every page: the cache is evicted
    assert a.admit_cached(11, toks) == -1
    a.release(10)
    assert a.admit_cached(12, toks) == 0


def test_prefix_cache_skips_prefill():
    """Twin of test_prefix_cache_skips_prefill: a second request with the
    same 38-token prompt finds 32 tokens cached and prefills only the
    last 6 in chunks of 8; its logits equal a one-shot prefill's and the
    JAX package's."""
    jcfg, jparams, model = _pair(13)
    page, pool_pages, table_w = 16, 8, 4
    prompt = [int(x) for x in np.random.RandomState(21).randint(0, 64, 38)]
    alloc = PageAllocator(pool_pages, page)
    cache = llama.init_kv_cache(model.cfg, 1, table_w, page, "cpu",
                                num_pages=pool_pages)

    def rows(seq, length):
        cache.page_indices = torch.from_numpy(alloc.block_table([seq],
                                                                table_w))
        cache.lengths = torch.tensor([length], dtype=torch.int32)
        return cache

    assert alloc.admit_cached(100, prompt) == 0
    llama.prefill(model, rows(100, 0), torch.tensor([prompt]))
    assert alloc.register_prefix(100, prompt) == 2
    alloc.release(100)
    cached = alloc.admit_cached(200, prompt)
    assert cached == 32
    l2, _ = llama.prefill_chunked(model, rows(200, cached),
                                  torch.tensor([prompt[cached:]]), chunk=8)
    c3 = llama.init_kv_cache(model.cfg, 1, table_w, page, "cpu")
    l3, _ = llama.prefill(model, c3, torch.tensor([prompt]))
    np.testing.assert_allclose(l2.numpy(), l3.numpy(), atol=3e-5, rtol=1e-4)
    jc = jllama.init_kv_cache(jcfg, 1, table_w, page)
    jl, _ = jllama.prefill(jparams, jc, jnp.asarray([prompt], jnp.int32),
                           jcfg)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl), atol=3e-5,
                               rtol=1e-4)
