"""cubecl_tpu_torch's speculative decoding against
cubecl_tpu.models.llama: twin of tests/test_models.py's
test_speculative_decoding_exact, run on the port and on the JAX package with
the same ``params_from_jax`` weights and numpy prompts (the config of
tests/test_torch_serving.py). The port runs its plain versions on the CPU,
the JAX package its Pallas kernels in interpret mode. Tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu_torch.models import llama

SMALL = dict(vocab=64, d_model=64, n_heads=2, n_kv_heads=1, n_layers=2,
             d_ff=128, seq=32, use_flash_attention=False,
             use_framework_kernels=False)


def _pair(seed, **over):
    """(JAX config, JAX params, port model) on the same weights."""
    jcfg = jllama.LlamaConfig(**{**SMALL, **over})
    jparams = jllama.init_params(jcfg, seed=seed)
    model = llama.Llama(llama.LlamaConfig(**{**SMALL, **over}), device="cpu")
    model.load_state_dict(llama.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, model


def test_speculative_decoding_exact():
    """Twin of test_speculative_decoding_exact: with a weak draft and with
    the target as its own draft, the tokens equal the JAX package's and
    the port's greedy ``generate``, and the mean acceptance equals the JAX
    package's (gamma for the self-draft)."""
    jcfg, jparams, model = _pair(8)
    _, jdraft, draft = _pair(9)
    B, S, steps = 2, 6, 10
    prompt = np.random.RandomState(3).randint(0, 64, (B, S)).astype(np.int32)
    want = llama.generate(model, torch.from_numpy(prompt), steps,
                          max_pages=2).numpy()
    for jd, d in ((jdraft, draft), (jparams, model)):
        jtoks, jacc = jllama.speculative_generate(
            jparams, jnp.asarray(prompt), steps, jcfg, jd, jcfg, gamma=3,
            max_pages=2)
        toks, acc = llama.speculative_generate(
            model, torch.from_numpy(prompt), steps, d, gamma=3, max_pages=2)
        assert toks.dtype == torch.int32
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(toks.numpy(), want)
        assert acc == jacc
    assert acc == 3.0


def test_speculative_int8_target_matches_jax():
    """The verify step on an int8 target cache (decode_chunk's int8 path)
    inside speculative decoding: tokens equal the JAX package's."""
    jcfg, jparams, model = _pair(8, kv_dtype="int8")
    _, jdraft, draft = _pair(9)
    prompt = np.random.RandomState(4).randint(0, 64, (2, 6)).astype(np.int32)
    jtoks, jacc = jllama.speculative_generate(
        jparams, jnp.asarray(prompt), 8, jcfg, jdraft,
        dataclasses.replace(jcfg, kv_dtype=""), gamma=3, max_pages=2)
    toks, acc = llama.speculative_generate(
        model, torch.from_numpy(prompt), 8, draft, gamma=3, max_pages=2)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert acc == jacc
