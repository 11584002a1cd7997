"""cubecl_tpu_torch.models.llama against cubecl_tpu.models.llama.

A tiny config (d 128, 4 query / 2 kv heads at head_dim 32, 2 layers) with
``use_framework_kernels=False``. The port loads the JAX ``init_params``
through ``params_from_jax``; prompts come from a numpy seed. The port runs
its attention's plain versions on the CPU, the JAX package its Pallas
kernels in interpret mode. f32 logits agree to atol 1e-5 / rtol 1e-4: both
sides round the same f32 math in different orders through two layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu_torch.models import llama

ATOL, RTOL = 1e-5, 1e-4
CFG = dict(vocab=64, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, seq=32, use_framework_kernels=False)
B, S, PAGE, MAX_PAGES = 2, 20, 8, 4


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**CFG)
    jparams = jllama.init_params(jcfg, seed=3)
    model = llama.Llama(llama.LlamaConfig(**CFG))
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, model


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, CFG["vocab"], (B, S),
                                             dtype=np.int32)


def test_forward_logits(models, prompt):
    jcfg, jparams, model = models
    ref = jllama.forward(jparams, jnp.asarray(prompt), jcfg)
    got = llama.forward(model, torch.from_numpy(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_prefill_and_decode_steps(models, prompt):
    """Prefill logits and the k/v pools, then three decode steps fed the
    same tokens: logits and pools after each."""
    jcfg, jparams, model = models
    jc = jllama.init_kv_cache(jcfg, B, MAX_PAGES, PAGE)
    jl, jc = jllama.prefill(jparams, jc, jnp.asarray(prompt), jcfg)
    c = llama.init_kv_cache(model.cfg, B, MAX_PAGES, PAGE)
    lg, c = llama.prefill(model, c, torch.from_numpy(prompt))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc[name]), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(c.lengths.numpy(),
                                  np.asarray(jc["lengths"]))

    toks = np.random.default_rng(1).integers(0, CFG["vocab"], (3, B),
                                             dtype=np.int32)
    for tok in toks:
        jl, jc = jllama.decode_step(jparams, jc, jnp.asarray(tok), jcfg)
        lg, c = llama.decode_step(model, c, torch.from_numpy(tok))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=ATOL, rtol=RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc[name]), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(c.lengths.numpy(),
                                  np.asarray(jc["lengths"]))


def test_generate_tokens_equal_jax(models, prompt):
    jcfg, jparams, model = models
    ref = jllama.generate(jparams, jnp.asarray(prompt), 4, jcfg,
                          max_pages=MAX_PAGES, page=PAGE)
    got = llama.generate(model, torch.from_numpy(prompt), 4,
                         max_pages=MAX_PAGES, page=PAGE)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_prefill_matches_token_by_token():
    """Twin of tests/test_models.py::test_prefill_matches_token_by_token:
    one batched prefill equals S decode steps -- logits, pools, lengths,
    and the greedy continuation. Port only; f32, atol 2e-5 / rtol 1e-5."""
    cfg = llama.LlamaConfig(vocab=64, d_model=64, n_heads=2, n_kv_heads=1,
                            n_layers=2, d_ff=128, seq=32,
                            use_framework_kernels=False)
    model = llama.init_params(cfg, seed=2)
    page = 16                       # S = 20 crosses a page boundary
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32))
    c1 = llama.init_kv_cache(cfg, B, 4, page)
    lg1, c1 = llama.prefill(model, c1, prompt)
    c2 = llama.init_kv_cache(cfg, B, 4, page)
    for t in range(S):
        lg2, c2 = llama.decode_step(model, c2, prompt[:, t])
    np.testing.assert_allclose(lg1.numpy(), lg2.numpy(), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(c1.lengths.numpy(), c2.lengths.numpy())
    for a, b in ((c1.k, c2.k), (c1.v, c2.v)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-5)
    t1 = lg1.argmax(-1).to(torch.int32)
    t2 = lg2.argmax(-1).to(torch.int32)
    for _ in range(3):
        lg1, c1 = llama.decode_step(model, c1, t1)
        lg2, c2 = llama.decode_step(model, c2, t2)
        t1 = lg1.argmax(-1).to(torch.int32)
        t2 = lg2.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(t1.numpy(), t2.numpy())


def test_generate_plain_equals_kernel_route_on_cpu(prompt):
    """On the CPU both routes are the plain versions: kernels=False must
    not change a thing."""
    model = llama.init_params(llama.LlamaConfig(**CFG), seed=5)
    p = torch.from_numpy(prompt)
    np.testing.assert_array_equal(
        llama.generate(model, p, 3, MAX_PAGES, PAGE).numpy(),
        llama.generate(model, p, 3, MAX_PAGES, PAGE, kernels=False).numpy())


@pytest.mark.parametrize("option", [
    dict(use_framework_kernels=True), dict(n_experts=4),
    dict(moe_capacity=8), dict(kv_dtype="int8"), dict(attn_window=16),
    dict(ring_cache=True), dict(remat=True)])
def test_unsupported_options_raise(option):
    cfg = llama.LlamaConfig(**{**CFG, **option})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama.Llama(cfg)


def test_lora_and_capacity_errors(prompt):
    model = llama.init_params(llama.LlamaConfig(**CFG))
    p = torch.from_numpy(prompt)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama.forward(model, p, lora={})
    with pytest.raises(ValueError, match="exceed"):
        llama.generate(model, p, 13, max_pages=4, page=8)   # 20 + 13 > 32
