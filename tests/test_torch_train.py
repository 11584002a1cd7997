"""Training of cubecl_tpu_torch.models.llama against cubecl_tpu.models.llama.

Two configs, the JAX ``init_params`` loaded through ``params_from_jax`` and
tokens from a numpy seed:

- ``fw``: d 128, 2 query / 1 kv heads (head_dim 64), 2 layers, S = 128,
  ``use_framework_kernels=True``: the JAX side runs its exact flash route
  and both sides their RMSNorm ``@cube`` kernels, forward and backward (the
  port through the torch evaluator, JAX in Pallas interpret mode);
- ``hd32``: the config of ``tests/test_torch_llama.py`` (head_dim 32,
  S = 20, plain RMSNorm): JAX pads to its flash tiles, the port needs no
  padding.

The port's attention runs ``_FlashAttention`` with its plain halves on the
CPU. Loss to 1e-5 relative; every gradient leaf to 1e-4 of its max-abs (the
same f32 math summed in other orders through the layers); the weights after
one step to 1e-6 relative, one f32 rounding of ``p - lr * g`` apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import llama as jllama
from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.runtime import CpuRuntime

LR = 1e-3
CONFIGS = {
    "fw": (dict(vocab=64, d_model=128, n_heads=2, n_kv_heads=1, n_layers=2,
                d_ff=256, seq=129), (2, 129)),
    "hd32": (dict(vocab=64, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
                  d_ff=128, seq=32, use_framework_kernels=False), (2, 21)),
}


def _leaves(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_grads_close(got, ref):
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(got[name] - r).max())
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """The JAX loss, gradients and one step, computed once per config."""
    cfg, shape = CONFIGS[request.param]
    jcfg = jllama.LlamaConfig(**cfg)
    jparams = jllama.init_params(jcfg, seed=3)
    tokens = np.random.default_rng(0).integers(0, cfg["vocab"], shape,
                                               dtype=np.int32)
    loss, grads = jax.value_and_grad(jllama.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg)
    new, step_loss = jllama.make_train_step(jcfg, LR)(jparams,
                                                      jnp.asarray(tokens))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(
        name=request.param, cfg=cfg, tokens=torch.from_numpy(tokens),
        state=llama.params_from_jax(np_tree(jparams)), loss=float(loss),
        grads=_leaves(llama.params_from_jax(np_tree(grads))),
        new=_leaves(llama.params_from_jax(np_tree(new))),
        step_loss=float(step_loss))


def _model(case, **over):
    model = llama.Llama(llama.LlamaConfig(**{**case["cfg"], **over}),
                        device="cpu")
    model.load_state_dict(case["state"])
    return model


def test_loss_and_grads_match_jax(case):
    model = _model(case).requires_grad_(True)
    loss = llama.loss_fn(model, case["tokens"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    assert_grads_close({n: p.grad.numpy()
                        for n, p in model.named_parameters()}, case["grads"])


def test_train_step_matches_jax(case):
    model = _model(case)
    step = llama.make_train_step(model.cfg, LR)
    loss = step(model, case["tokens"])
    assert not loss.requires_grad
    np.testing.assert_allclose(loss.item(), case["step_loss"], rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), case["new"][name],
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    assert_grads_close({n: p.grad.numpy()
                        for n, p in model.named_parameters()}, case["grads"])


def test_remat_matches(case):
    """Twin of tests/test_models.py::test_llama_remat_matches: per-layer
    checkpointing gives the same loss and grads; only memory changes."""
    out = []
    for remat in (False, True):
        model = _model(case, remat=remat).requires_grad_(True)
        loss = llama.loss_fn(model, case["tokens"])
        loss.backward()
        out.append((loss.item(), {n: p.grad for n, p in
                                  model.named_parameters()}))
    assert abs(out[0][0] - out[1][0]) < 1e-6
    for name, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], g, rtol=1e-5, atol=1e-6)


def test_loss_falls_on_repeated_batch(case):
    """Twin of tests/test_models.py::test_llama_forward_and_train."""
    model = _model(case)
    step = llama.make_train_step(model.cfg)
    l1 = step(model, case["tokens"])
    l2 = step(model, case["tokens"])
    assert l2.item() < l1.item()


def test_rmsnorm_kernels_per_step(case):
    """use_framework_kernels: 2L+1 launches of the RMSNorm forward kernel
    and as many of its backward kernel per step, none without the flag;
    with remat the forward kernels run twice."""
    server = CpuRuntime.client().server
    per = 2 * case["cfg"]["n_layers"] + 1 if case["name"] == "fw" else 0
    for remat, fwd in ((False, per), (True, 2 * per - (per > 0))):
        model = _model(case, remat=remat)
        n = dict(server.launches)
        llama.make_train_step(model.cfg)(model, case["tokens"])
        for kernel, want in (("_rmsnorm_fwd_k", fwd),
                             ("_rmsnorm_bwd_k", per)):
            got = server.launches[kernel] - n.get(kernel, 0)
            assert got == want, (kernel, remat, got, want)


def test_serving_keeps_weights_frozen(case):
    """The serving path runs without grad and leaves a fresh model frozen;
    a step needs the config the model was built for."""
    model = _model(case)
    logits = llama.forward(model, case["tokens"])
    assert logits.grad_fn is None
    assert not any(p.requires_grad for p in model.parameters())
    other = llama.LlamaConfig(**{**case["cfg"], "remat": True})
    with pytest.raises(ValueError, match="another config"):
        llama.make_train_step(other)(model, case["tokens"])
