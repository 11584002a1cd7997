"""Paged attention at head dims without an instance of their own (48, 100,
MPT-30B's 112 and 200) in cubecl_tpu_torch against cubecl_tpu: P1 and P3
on f32 and int8 pools with ragged lengths (a length-0 row among them),
their launch plans at the width of the ragged instance that runs them
(the next of 64, 128 and 256, the scratch at the real D), and the llama at
MPT-30B's head layout (heads of 112, as many kv heads as query heads)
served through ``prefill``, ``decode_step`` and ``decode_chunk``.

The port runs its plain versions on these CPU tensors (on the card these
head dims launch the ragged instances of csrc/paged_ragged.cu and
csrc/paged_chunked.cu, held to the plain versions by
tests/test_torch_cuda.py); the JAX kernels run in Pallas interpret mode.
The JAX results are computed once a module (``functools.lru_cache``).
Tolerances are tests/test_torch_paged_d96.py's: f32 kernels atol 2e-5 /
rtol 1e-4, the model's logits atol 3e-5 / rtol 1e-4; int8 pools hold the
same values in both packages (the port's quantize_kv of one f32 pool), so
the kernels on them are held to the f32 tolerance; greedy tokens equal.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.ops.paged_attention import (
    PAGED_HEAD_DIMS,
    p1_plan,
    p3_plan,
    paged_attention,
    paged_attention_chunked,
    paged_width,
    quantize_kv,
)

jax_paged = importlib.import_module("cubecl_tpu.ops.paged_attention")

ATOL, RTOL = 2e-5, 1e-4
LOGIT_ATOL, LOGIT_RTOL = 3e-5, 1e-4
HEAD_DIMS = [48, 100, 112, 200]
B, HKV, G = 4, 2, 2
L, P, PAGE, MAX_PAGES = 2, 24, 8, 6
# a length-0 row, mid-page, one position, past a 64-position tile
LENGTHS = np.array([0, 13, 1, 41], np.int32)
STARTS = np.array([0, 5, 8, 30], np.int32)


@functools.lru_cache(maxsize=None)
def _pools(D):
    """f32 pools, int8 pools with their scales (quantize_kv of the f32
    ones) and a table."""
    rng = np.random.default_rng(D)
    kp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    vp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    (k8, ks), (v8, vs) = (quantize_kv(torch.from_numpy(x)) for x in (kp, vp))
    table = rng.permutation(P)[:B * MAX_PAGES].reshape(B, MAX_PAGES)
    return dict(f32=(kp, vp, None, None),
                int8=tuple(t.numpy() for t in (k8, v8, ks, vs)),
                table=table.astype(np.int32))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@functools.lru_cache(maxsize=None)
def _q(D, C=None):
    shape = (B, HKV * G, D) if C is None else (B, HKV * G, C, D)
    return np.random.default_rng(7 * D + (C or 0)).standard_normal(
        shape, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_decode(D, kv):
    kp, vp, ks, vs = _pools(D)[kv]
    return np.asarray(jax_paged.paged_attention(
        _j(_q(D)), _j(kp), _j(vp), _j(_pools(D)["table"]), _j(LENGTHS),
        k_scales=_j(ks), v_scales=_j(vs), layer=1, interpret=True))


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_decode_matches_jax_kernel(D, kv):
    """P1 at a head dim with no instance of its own, layer 1 of the
    stacked pools at G 2, against the JAX P1; a length-0 row's zeros."""
    kp, vp, ks, vs = _pools(D)[kv]
    got = paged_attention(_t(_q(D)), _t(kp), _t(vp), _t(_pools(D)["table"]),
                          _t(LENGTHS), layer=1, k_scales=_t(ks),
                          v_scales=_t(vs)).numpy()
    assert got.shape == (B, HKV * G, D)
    np.testing.assert_allclose(got, _jax_decode(D, kv), atol=ATOL, rtol=RTOL)
    assert not got[LENGTHS == 0].any()


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_chunked_matches_jax_kernel(D, kv):
    """P3 at a head dim with no instance of its own: the verify step's
    decode-shaped chunk (C 5, G 2) from 0, in mid-page and after a prefix,
    lengths = starts + C, layer 1, against the JAX kernel."""
    kp, vp, ks, vs = _pools(D)[kv]
    q, table, lengths = _q(D, 5), _pools(D)["table"], STARTS + 5
    ref = jax_paged.paged_attention_chunked(
        *(_j(a) for a in (q, kp, vp, table, lengths, STARTS)),
        interpret=True, k_scales=_j(ks), v_scales=_j(vs), layer=1)
    got = paged_attention_chunked(
        *(_t(a) for a in (q, kp, vp, table, lengths, STARTS)),
        layer=1, k_scales=_t(ks), v_scales=_t(vs))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("D", HEAD_DIMS + [1, 33, 255])
def test_plans_take_the_ragged_width(D):
    """A head dim without an instance runs in the next width of 64, 128 and
    256: its P1 and P3 plans are that width's (shared memory, splits, the
    grid) on every pool and mode, with the scratch at the real D."""
    W = paged_width(D)
    assert D not in PAGED_HEAD_DIMS and W == min(w for w in (64, 128, 256)
                                                 if w >= D)
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    for dt, kv in ((bf, bf), (bf, i8), (f32, f32), (f32, i8)):
        for opts in ((), (100, 4), (100, 4, True)):
            got, at_w = (p1_plan(dt, kv, 1, 24, 2, d, 16, 17, *opts)
                         for d in (D, W))
            assert (got.smem_bytes, got.grid, got.mode, got.groups,
                    got.stages) == (at_w.smem_bytes, at_w.grid, at_w.mode,
                                    at_w.groups, at_w.stages)
            assert got.scratch == 24 * got.splits * (D + 2)
        got, at_w = (p3_plan(dt, kv, 1, 4, 2, 5, d, 16, 17) for d in (D, W))
        assert (got.body, got.smem_bytes, got.grid, got.split_len) == (
            at_w.body, at_w.smem_bytes, at_w.grid, at_w.split_len)
        assert got.scratch == (2 * got.splits * 10 * (D + 2)
                               if got.splits > 1 else 0)


# -- the llama at MPT-30B's head layout ---------------------------------------

# MPT-30B (mosaicml/mpt-30b's config.json: d_model 7168, 64 heads, so
# heads of 112, as many kv heads as query heads), cut to 8 heads and 2
# layers: d_model 896
MPT_HEADS = 8
MPT_D = 112


@functools.lru_cache(maxsize=None)
def _pair(seed):
    """(JAX config, JAX params, port model) on the same weights."""
    cfg = dict(vocab=64, d_model=MPT_HEADS * MPT_D, n_heads=MPT_HEADS,
               n_kv_heads=MPT_HEADS, n_layers=2, d_ff=128, seq=64,
               use_flash_attention=False, use_framework_kernels=False)
    jcfg = jllama.LlamaConfig(**cfg)
    jparams = jllama.init_params(jcfg, seed=seed)
    model = llama.Llama(llama.LlamaConfig(**cfg), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    assert model.cfg.head_dim == MPT_D
    return jcfg, jparams, model


def test_llama_decode_steps_match_jax():
    """prefill of a 9-token prompt, then 5 decode steps fed greedy tokens
    (the JAX steps' own): logits, greedy tokens and the pools against the
    JAX package's."""
    jcfg, jparams, model = _pair(41)
    Bq, page = 2, 16
    prompt = np.random.RandomState(42).randint(0, 64, (Bq, 9)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    jl, jc = jllama.prefill(jparams, jc, jnp.asarray(prompt), jcfg)
    c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    lg, c = llama.prefill(model, c, torch.from_numpy(prompt))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    toks, jls, tok = [], [], jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(5):
        toks.append(np.array(tok))
        jl, jc = jllama.decode_step(jparams, jc, tok, jcfg)
        jls.append(np.asarray(jl))
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    got = []
    for t in toks:
        lg, c = llama.decode_step(model, c, torch.from_numpy(t))
        got.append(lg.numpy())
    got, want = np.stack(got, 1), np.stack(jls, 1)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for name in ("k", "v"):
        assert getattr(c, name).shape[-1] == MPT_D
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc[name]), atol=LOGIT_ATOL)


def test_llama_decode_chunk_matches_jax():
    """decode_chunk of 5 tokens (the verify step) after a 9-token prefill
    against the JAX package's."""
    jcfg, jparams, model = _pair(43)
    Bq, page = 2, 16
    toks = np.random.RandomState(44).randint(0, 64, (Bq, 14)).astype(
        np.int32)
    jc = jllama.init_kv_cache(jcfg, Bq, 2, page)
    _, jc = jllama.prefill(jparams, jc, jnp.asarray(toks[:, :9]), jcfg)
    jl, jc = jllama.decode_chunk(jparams, jc, jnp.asarray(toks[:, 9:]), jcfg)
    c = llama.init_kv_cache(model.cfg, Bq, 2, page, "cpu")
    _, c = llama.prefill(model, c, torch.from_numpy(toks[:, :9]))
    lg, c = llama.decode_chunk(model, c, torch.from_numpy(toks[:, 9:]))
    assert lg.shape == (Bq, 5, 64)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(c.lengths.numpy(),
                                  np.asarray(jc["lengths"]))
