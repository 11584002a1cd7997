"""cubecl_tpu_torch's chunked and int8-KV serving against
cubecl_tpu.models.llama: twins of tests/test_models.py's int8 cache,
decode_chunk, prefill_chunked and sampler tests, each run on the port and
on the JAX package with the same ``params_from_jax`` weights and numpy
inputs (speculative decoding: tests/test_torch_speculative.py).

The small config of those tests (d 64, 2 query / 1 kv head, 2 layers,
``use_flash_attention=False``, ``use_framework_kernels=False``). The port
runs its plain versions on the CPU, the JAX package its Pallas kernels in
interpret mode. Tolerances as the JAX tests state them: f32 logits and
pools atol 3e-5 / rtol 1e-4; an int8 cache within atol 0.02 once
dequantized (a rounding may fall on the other side of .5); greedy tokens
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu_torch.models import llama

SMALL = dict(vocab=64, d_model=64, n_heads=2, n_kv_heads=1, n_layers=2,
             d_ff=128, seq=32, use_flash_attention=False,
             use_framework_kernels=False)
ATOL, RTOL = 3e-5, 1e-4


def _pair(seed, **over):
    """(JAX config, JAX params, port model) on the same weights."""
    jcfg = jllama.LlamaConfig(**{**SMALL, **over})
    jparams = jllama.init_params(jcfg, seed=seed)
    model = llama.Llama(llama.LlamaConfig(**{**SMALL, **over}), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, model


def _dequant(values, scales):
    return np.asarray(values, np.float32) * np.asarray(scales)[..., None]


def test_int8_kv_cache():
    """Twin of test_llama_int8_kv_cache: int8 prefill and token-by-token
    decode against the JAX package's, the port's prefill against its own
    steps, and the int8 cache against the f32 one."""
    jcfg, jparams, model = _pair(4, kv_dtype="int8")
    B, S, page = 2, 20, 16
    prompt = np.random.RandomState(7).randint(0, 64, (B, S)).astype(np.int32)

    jc = jllama.init_kv_cache(jcfg, B, 4, page)
    jl, jc = jllama.prefill(jparams, jc, jnp.asarray(prompt), jcfg)
    cp = llama.init_kv_cache(model.cfg, B, 4, page, "cpu")
    assert cp.k.dtype == torch.int8 and cp.k_scales is not None
    lp, cp = llama.prefill(model, cp, torch.from_numpy(prompt))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), atol=0.02)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _dequant(getattr(cp, name), getattr(cp, f"{name}_scales")),
            _dequant(jc[name], jc[f"{name}_scales"]), atol=0.02)

    jstep = jax.jit(lambda p, c, t: jllama.decode_step(p, c, t, jcfg))
    jq = jllama.init_kv_cache(jcfg, B, 4, page)
    cq = llama.init_kv_cache(model.cfg, B, 4, page, "cpu")
    for t in range(S):
        jlq, jq = jstep(jparams, jq, jnp.asarray(prompt[:, t]))
        lq, cq = llama.decode_step(model, cq, torch.from_numpy(prompt[:, t]))
        np.testing.assert_allclose(lq.numpy(), np.asarray(jlq), atol=0.02)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _dequant(getattr(cq, name), getattr(cq, f"{name}_scales")),
            _dequant(jq[name], jq[f"{name}_scales"]), atol=0.02)
    # the JAX test's own checks, on the port: prefill against the steps
    np.testing.assert_allclose(_dequant(cp.k, cp.k_scales),
                               _dequant(cq.k, cq.k_scales), atol=0.02)
    assert (cp.k != cq.k).float().mean().item() < 0.05
    np.testing.assert_allclose(lp.numpy(), lq.numpy(), atol=0.02)

    c32 = llama.init_kv_cache(dataclasses.replace(model.cfg, kv_dtype=""), B,
                              4, page, "cpu")
    for t in range(S):
        l32, c32 = llama.decode_step(model, c32,
                                     torch.from_numpy(prompt[:, t]))
    assert (lq - l32).abs().max().item() < 0.05


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8"])
def test_decode_chunk_matches_jax_and_steps(kv_dtype):
    """Twin of test_decode_chunk_matches_sequential: one decode_chunk of C
    tokens after a 3-token prefill equals the JAX package's and C of the
    port's decode steps (logits, pools, lengths)."""
    jcfg, jparams, model = _pair(6, kv_dtype=kv_dtype)
    B, C, page = 2, 5, 16
    toks = np.random.RandomState(5).randint(0, 64, (B, 8)).astype(np.int32)

    jc = jllama.init_kv_cache(jcfg, B, 4, page)
    _, jc = jllama.prefill(jparams, jc, jnp.asarray(toks[:, :3]), jcfg)
    jl, jc = jllama.decode_chunk(jparams, jc, jnp.asarray(toks[:, 3:3 + C]),
                                 jcfg)
    caches = []
    for _ in range(2):
        c = llama.init_kv_cache(model.cfg, B, 4, page, "cpu")
        _, c = llama.prefill(model, c, torch.from_numpy(toks[:, :3]))
        caches.append(c)
    c1, c2 = caches
    l1, c1 = llama.decode_chunk(model, c1, torch.from_numpy(toks[:, 3:3 + C]))
    assert l1.shape == (B, C, 64)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    l2 = []
    for i in range(C):
        lg, c2 = llama.decode_step(model, c2, torch.from_numpy(toks[:, 3 + i]))
        l2.append(lg)
    np.testing.assert_allclose(l1.numpy(), torch.stack(l2, 1).numpy(),
                               atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c1, name).numpy().astype(
            np.float32), np.asarray(jc[name], np.float32), atol=ATOL)
        np.testing.assert_allclose(getattr(c1, name).numpy().astype(
            np.float32), getattr(c2, name).numpy().astype(np.float32),
            atol=ATOL)
    np.testing.assert_array_equal(c1.lengths.numpy(),
                                  np.asarray(jc["lengths"]))
    np.testing.assert_array_equal(c1.lengths.numpy(), c2.lengths.numpy())


def test_prefill_chunked_matches_jax_and_prefill():
    """Twin of test_prefill_chunked_matches_prefill: chunks of 8 over
    S = 21 (a ragged last chunk) against the JAX package's and against
    one batched prefill."""
    jcfg, jparams, model = _pair(3)
    B, S, page = 2, 21, 16
    prompt = np.random.RandomState(9).randint(0, 64, (B, S)).astype(np.int32)
    jc = jllama.init_kv_cache(jcfg, B, 4, page)
    jl, jc = jllama.prefill_chunked(jparams, jc, jnp.asarray(prompt), jcfg,
                                    chunk=8)
    c1 = llama.init_kv_cache(model.cfg, B, 4, page, "cpu")
    l1, c1 = llama.prefill(model, c1, torch.from_numpy(prompt))
    c2 = llama.init_kv_cache(model.cfg, B, 4, page, "cpu")
    l2, c2 = llama.prefill_chunked(model, c2, torch.from_numpy(prompt),
                                   chunk=8)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(c2.k.numpy(), np.asarray(jc["k"]), atol=ATOL)
    np.testing.assert_allclose(c2.k.numpy(), c1.k.numpy(), atol=ATOL)
    np.testing.assert_array_equal(c2.lengths.numpy(), c1.lengths.numpy())


def test_sample_logits():
    """Twin of test_sample_logits, with a torch.Generator: argmax at
    temperature 0 and top_k 1, top-k and top-p supports as masks, and every
    token reachable without them (no bit equality with jax.random)."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.1, 0.06, 0.04]]))
    gen = torch.Generator().manual_seed(0)
    assert llama.sample_logits(logits, gen, temperature=0.0).item() == 0
    assert llama.sample_logits(logits, gen, top_k=1).item() == 0
    for kw in (dict(top_k=2), dict(top_p=0.75)):
        seen = {llama.sample_logits(logits, gen, **kw).item()
                for _ in range(60)}
        assert seen == {0, 1}, kw
    counts = np.zeros(5)
    for _ in range(400):
        counts[llama.sample_logits(logits, gen).item()] += 1
    assert counts[0] > counts[2] > 0 and counts.all()
    out = llama.sample_logits(logits.repeat(3, 1), gen, temperature=0.7)
    assert out.shape == (3,) and out.dtype == torch.int32
