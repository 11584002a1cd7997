"""The mixture-of-experts llama of cubecl_tpu_torch against
cubecl_tpu.models.llama.

A tiny config (d 128, 4 query / 2 kv heads, 2 layers, 4 experts, top-2)
through its three FFN routes: the dense one (every expert computed and
gated, ``moe_capacity = 0``), and the sparse one (dispatch, E1, combine)
with a roomy capacity (40: no route is dropped) and a tight one (12: routes
are dropped). The port loads the JAX ``init_params`` through
``params_from_jax``; prompts come from a numpy seed. The JAX package runs
E1 and the paged attention kernels in Pallas interpret mode, the port
their plain versions (E1's plain version on the CPU). Both sides attend
with plain softmax in prefill (``use_flash_attention=False``: the flash
route is held in ``tests/test_torch_llama.py``).

f32 logits agree to atol 1e-5 / rtol 1e-4, as the dense llama's: the same
f32 math in other orders; routing is decided by the same f32 logits.
Greedy tokens are equal. One dense-route SGD step: loss to 1e-5 relative,
every gradient to 1e-4 of its max-abs (``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.ops import moe

ATOL, RTOL = 1e-5, 1e-4
CFG = dict(vocab=64, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, seq=32, use_framework_kernels=False,
           use_flash_attention=False, n_experts=4, top_k=2)
ROUTES = {"dense": 0, "roomy": 40, "tight": 12}   # moe_capacity
B, S, PAGE, MAX_PAGES = 2, 20, 8, 4
LR = 1e-3


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module", params=list(ROUTES))
def models(request):
    cfg = dict(CFG, moe_capacity=ROUTES[request.param])
    jcfg = jllama.LlamaConfig(**cfg)
    jparams = jllama.init_params(jcfg, seed=3)
    model = llama.Llama(llama.LlamaConfig(**cfg), device="cpu")
    model.load_state_dict(llama.params_from_jax(_np_tree(jparams)))
    return request.param, jcfg, jparams, model


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, CFG["vocab"], (B, S),
                                             dtype=np.int32)


def test_forward_logits_match_jax(models, prompt):
    route, jcfg, jparams, model = models
    ref = jllama.forward(jparams, jnp.asarray(prompt), jcfg)
    got = llama.forward(model, torch.from_numpy(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    if route != "dense":
        # the first layer's dispatch: the tight capacity drops routes
        x = llama._rmsnorm(model.embed[torch.from_numpy(prompt)],
                           model.layers[0].rms1, model.cfg, True)
        xf = x.reshape(B * S, -1)
        live = moe.moe_dispatch(xf, xf @ model.layers[0].router, 2,
                                model.cfg.moe_capacity)[5]
        assert bool(live.all()) == (route == "roomy")


def test_prefill_decode_step_and_chunk_match_jax(models, prompt):
    """Prefill, two decode steps, then a chunk of three: logits after each
    and the pools at the end."""
    _route, jcfg, jparams, model = models
    jc = jllama.init_kv_cache(jcfg, B, MAX_PAGES, PAGE)
    jl, jc = jllama.prefill(jparams, jc, jnp.asarray(prompt), jcfg)
    c = llama.init_kv_cache(model.cfg, B, MAX_PAGES, PAGE, "cpu")
    lg, c = llama.prefill(model, c, torch.from_numpy(prompt))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    toks = np.random.default_rng(1).integers(0, CFG["vocab"], (2, B),
                                             dtype=np.int32)
    for tok in toks:
        jl, jc = jllama.decode_step(jparams, jc, jnp.asarray(tok), jcfg)
        lg, c = llama.decode_step(model, c, torch.from_numpy(tok))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
    chunk = np.random.default_rng(2).integers(0, CFG["vocab"], (B, 3),
                                              dtype=np.int32)
    jl, jc = jllama.decode_chunk(jparams, jc, jnp.asarray(chunk), jcfg)
    lg, c = llama.decode_chunk(model, c, torch.from_numpy(chunk))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(c, name).numpy(),
                                   np.asarray(jc[name]), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(jc["lengths"]))


def test_generate_tokens_equal_jax(models, prompt):
    _route, jcfg, jparams, model = models
    ref = jllama.generate(jparams, jnp.asarray(prompt), 4, jcfg,
                          max_pages=MAX_PAGES, page=PAGE)
    got = llama.generate(model, torch.from_numpy(prompt), 4,
                         max_pages=MAX_PAGES, page=PAGE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_chunked_and_speculative_serving_equal_generate(models, prompt):
    """Port only: ``prefill_chunked`` gives the one-shot prefill's logits
    (atol 1e-5 / rtol 1e-4, the GEMMs of other heights) where no route is
    dropped; at the tight capacity a chunk of 8 tokens drops other routes
    than the 40-token prompt does, so the logits differ, as in the JAX
    package. ``speculative_generate`` with the model as its own draft gives
    ``generate``'s greedy tokens (its verify chunks of 2 x 3 tokens drop
    nothing)."""
    route, _jcfg, _jparams, model = models
    p = torch.from_numpy(prompt)
    one = llama.prefill(model, llama.init_kv_cache(model.cfg, B, MAX_PAGES,
                                                   PAGE, "cpu"), p)[0]
    chunked = llama.prefill_chunked(
        model, llama.init_kv_cache(model.cfg, B, MAX_PAGES, PAGE, "cpu"), p,
        chunk=8)[0]
    close = np.allclose(chunked.numpy(), one.numpy(), atol=ATOL, rtol=RTOL)
    assert close == (route != "tight")
    want = llama.generate(model, p, 6, max_pages=MAX_PAGES, page=PAGE)
    got, accepted = llama.speculative_generate(model, p, 6, model, gamma=2,
                                               max_pages=MAX_PAGES, page=PAGE)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert accepted == 2.0   # a self-draft agrees everywhere


def test_kernels_false_equals_the_default_on_cpu(models, prompt):
    """On the CPU E1's wrapper runs its plain version: ``kernels=False``
    changes nothing."""
    _route, _jcfg, _jparams, model = models
    p = torch.from_numpy(prompt)
    assert torch.equal(llama.forward(model, p),
                       llama.forward(model, p, kernels=False))


def test_dense_route_train_step_matches_jax(prompt):
    """One SGD step through the dense route: loss, every gradient (router
    and stacked experts included) and the weights after the step."""
    cfg = dict(CFG, moe_capacity=0)
    jcfg = jllama.LlamaConfig(**cfg)
    jparams = jllama.init_params(jcfg, seed=3)
    tokens = np.random.default_rng(4).integers(0, CFG["vocab"], (B, 13),
                                               dtype=np.int32)
    loss, grads = jax.value_and_grad(jllama.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg)
    new, _ = jllama.make_train_step(jcfg, LR)(jparams, jnp.asarray(tokens))
    model = llama.Llama(llama.LlamaConfig(**cfg), device="cpu")
    model.load_state_dict(llama.params_from_jax(_np_tree(jparams)))
    got = llama.make_train_step(model.cfg, LR)(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    ref = llama.params_from_jax(_np_tree(grads))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(p.grad.numpy() - r).max())
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"
    for name, w in llama.params_from_jax(_np_tree(new)).items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   w.numpy(), atol=1e-7, rtol=1e-6)


def test_sparse_route_under_autograd_raises(prompt):
    """E1 has no backward (nor has the JAX kernel): a train step through the
    sparse route raises before it computes anything."""
    model = llama.init_params(llama.LlamaConfig(**CFG, moe_capacity=12),
                              device="cpu")
    step = llama.make_train_step(model.cfg, LR)
    with pytest.raises(NotImplementedError, match="no backward"):
        step(model, torch.from_numpy(prompt))
