"""cubecl_tpu_torch.models.llama against cubecl_tpu.models.llama.

A tiny config (d 128, 4 query / 2 kv heads at head_dim 32, 2 layers) with
``use_framework_kernels=False``, and the JAX package's framework-kernel
config of ``tests/test_functional.py:125-127`` (d 128, 1 layer) with
``use_framework_kernels=True``, where RMSNorm is the ``@cube`` kernel
(K0: the torch evaluator on the CPU, Pallas interpret mode in JAX). The
port loads the JAX ``init_params`` through ``params_from_jax``; prompts
come from a numpy seed. The port runs its attention's plain versions on
the CPU, the JAX package its Pallas kernels in interpret mode. f32 logits
agree to atol 1e-5 / rtol 1e-4: both sides round the same f32 math in
different orders through the layers; greedy tokens are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.runtime import CpuRuntime

ATOL, RTOL = 1e-5, 1e-4
CFG = dict(vocab=64, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, seq=32, use_framework_kernels=False)
B, S, PAGE, MAX_PAGES = 2, 20, 8, 4


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**CFG)
    jparams = jllama.init_params(jcfg, seed=3)
    model = llama.Llama(llama.LlamaConfig(**CFG), device="cpu")
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
    c = llama.init_kv_cache(model.cfg, B, MAX_PAGES, PAGE, "cpu")
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
    model = llama.init_params(cfg, seed=2, device="cpu")
    page = 16                       # S = 20 crosses a page boundary
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32))
    c1 = llama.init_kv_cache(cfg, B, 4, page, "cpu")
    lg1, c1 = llama.prefill(model, c1, prompt)
    c2 = llama.init_kv_cache(cfg, B, 4, page, "cpu")
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
    model = llama.init_params(llama.LlamaConfig(**CFG), seed=5, device="cpu")
    p = torch.from_numpy(prompt)
    np.testing.assert_array_equal(
        llama.generate(model, p, 3, MAX_PAGES, PAGE).numpy(),
        llama.generate(model, p, 3, MAX_PAGES, PAGE, kernels=False).numpy())


# ids as before the MoE options (option1, option2) left this list for
# test_moe_options_build
@pytest.mark.parametrize("option", [
    dict(attn_sinks=2), dict(attn_window=16, attn_sinks=4),
    dict(attn_window=16),
    dict(ring_cache=True), dict(attn_window=16, ring_cache=True)],
    ids=["option0", "option3", "option4", "option5", "option6"])
def test_streaming_options_match_jax(option):
    """The StreamingLLM options serve: 36 decode steps from an empty cache
    under each, every step's logits against the JAX package's (jitted).
    Sinks alone and a ring without a window are the plain decode; the
    window bites after 16 (20 with sinks) positions; the ring (3 pages of
    8) recycles its slots after 24."""
    cfg = {**CFG, **option}
    jcfg = jllama.LlamaConfig(**cfg)
    jparams = jllama.init_params(jcfg, seed=3)
    model = llama.Llama(llama.LlamaConfig(**cfg), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    pages = 3 if option.get("attn_window") and option.get("ring_cache") \
        else 5
    toks = np.random.default_rng(4).integers(0, CFG["vocab"], (B, 36),
                                             dtype=np.int32)
    jstep = jax.jit(lambda p, c, t: jllama.decode_step(p, c, t, jcfg))
    jc = jllama.init_kv_cache(jcfg, B, pages, PAGE)
    c = llama.init_kv_cache(model.cfg, B, pages, PAGE, "cpu")
    assert (c.pos_meta is not None) == ("pos_meta" in jc)
    for t in range(toks.shape[1]):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, t]))
        lg, c = llama.decode_step(model, c, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("option", [dict(n_experts=4), dict(moe_capacity=8)],
                         ids=["n_experts", "moe_capacity"])
def test_moe_options_build(option, prompt):
    """The MoE options build (their parity with the JAX package is
    ``tests/test_torch_llama_moe.py``). With ``n_experts == 0``
    ``moe_capacity`` is not read: the model is the dense SwiGLU one, weight
    for weight and logit for logit."""
    model = llama.Llama(llama.LlamaConfig(**{**CFG, **option}), device="cpu")
    dense = llama.init_params(llama.LlamaConfig(**CFG), seed=5, device="cpu")
    names = set(model.state_dict())
    if "n_experts" in option:
        assert model.layers[0].w1.shape == (4, CFG["d_model"], CFG["d_ff"])
        assert model.layers[0].router.shape == (CFG["d_model"], 4)
        return
    assert names == set(dense.state_dict())
    model.load_state_dict(dense.state_dict())
    p = torch.from_numpy(prompt)
    assert torch.equal(llama.forward(model, p), llama.forward(dense, p))


def test_builders_default_to_the_card():
    """Models and caches are built on the card unless asked otherwise
    (checked by signature: nothing is built here)."""
    import inspect

    from cubecl_tpu_torch.models import transformer

    for fn in (llama.init_params, llama.init_kv_cache, llama.Llama,
               llama.LlamaLayer, transformer.init_params,
               transformer.Transformer, transformer.TransformerLayer):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_default_client_raises_without_a_card():
    from cubecl_tpu_torch.runtime import client_for, default_client

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_client()
    assert client_for("cpu") is CpuRuntime.client()


def test_lora_and_capacity_errors(prompt):
    model = llama.init_params(llama.LlamaConfig(**CFG), device="cpu")
    p = torch.from_numpy(prompt)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama.forward(model, p, lora={})
    with pytest.raises(ValueError, match="exceed"):
        llama.generate(model, p, 13, max_pages=4, page=8)   # 20 + 13 > 32


# the framework-kernel config: 8 decode rows and 8 x 16 prefill rows, so
# that every RMSNorm fits the DSL kernel (rows % 8 == 0, d % 128 == 0)
FW = dict(vocab=64, d_model=128, n_heads=2, n_kv_heads=1, n_layers=1,
          d_ff=128, seq=16, use_flash_attention=False)
FW_B, FW_S, FW_STEPS = 8, 16, 4
FW_K0 = 2 * FW["n_layers"] + 1        # K0 launches per forward / step


@pytest.fixture(scope="module")
def fw_models():
    jcfg = jllama.LlamaConfig(**FW)
    assert jcfg.use_framework_kernels       # the JAX default
    jparams = jllama.init_params(jcfg, seed=4)
    model = llama.Llama(llama.LlamaConfig(**FW), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    prompt = np.random.default_rng(4).integers(0, FW["vocab"], (FW_B, FW_S),
                                               dtype=np.int32)
    return jcfg, jparams, model, prompt


def _k0_launches():
    return CpuRuntime.client().server.launches["_rmsnorm_fwd_k"]


def test_framework_forward_logits(fw_models):
    jcfg, jparams, model, prompt = fw_models
    ref = jllama.forward(jparams, jnp.asarray(prompt), jcfg)
    n = _k0_launches()
    got = llama.forward(model, torch.from_numpy(prompt))
    assert _k0_launches() == n + FW_K0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_framework_generate_tokens_equal_jax(fw_models):
    jcfg, jparams, model, prompt = fw_models
    ref = jllama.generate(jparams, jnp.asarray(prompt), FW_STEPS, jcfg,
                          max_pages=MAX_PAGES, page=PAGE)
    n = _k0_launches()
    got = llama.generate(model, torch.from_numpy(prompt), FW_STEPS,
                         max_pages=MAX_PAGES, page=PAGE)
    # one prefill and FW_STEPS decode steps, each 2L+1 RMSNorms on K0
    assert _k0_launches() == n + FW_K0 * (1 + FW_STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_framework_plain_route_matches_kernel(fw_models):
    """kernels=False takes the framework kernel's plain formula (f32,
    one rounding): same logits to f32 summation order, same tokens."""
    _jcfg, _jparams, model, prompt = fw_models
    p = torch.from_numpy(prompt)
    n = _k0_launches()
    plain = llama.forward(model, p, kernels=False)
    assert _k0_launches() == n
    np.testing.assert_allclose(plain.numpy(), llama.forward(model, p).numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(
        llama.generate(model, p, 3, MAX_PAGES, PAGE, kernels=False).numpy(),
        llama.generate(model, p, 3, MAX_PAGES, PAGE).numpy())


def test_params_layout_independent_of_framework_flag():
    """The same JAX parameters load into the model of either flag: the
    flag changes how RMSNorm is computed, not the weights."""
    sds = []
    for flag in (True, False):
        jp = jllama.init_params(
            jllama.LlamaConfig(**{**FW, "use_framework_kernels": flag}),
            seed=4)
        sd = llama.params_from_jax(jax.tree.map(np.asarray, jp))
        model = llama.Llama(llama.LlamaConfig(
            **{**FW, "use_framework_kernels": not flag}), device="cpu")
        model.load_state_dict(sd, strict=True)
        sds.append(sd)
    assert sds[0].keys() == sds[1].keys()
    for k in sds[0]:
        assert torch.equal(sds[0][k], sds[1][k]), k
