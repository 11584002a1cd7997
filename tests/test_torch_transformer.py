"""Training of cubecl_tpu_torch.models.transformer against
cubecl_tpu.models.transformer.

``TransformerConfig(vocab=64, d_model=128, n_heads=2, n_layers=1,
d_ff=256, seq=17)`` with both routing flags on, tokens (8, 17): the trained
S is 16, so both sides take the plain attention route, while LayerNorm and
GELU take the ``@cube`` kernels forward and backward (the port through the
torch evaluator, JAX through its CPU client). S % 128 == 0 would send the
JAX model to its flash kernel, which cannot run on a CPU (its ``_flash_ctx``
passes no interpret flag); the port's flash route is held against its own
plain route here, and against the JAX kernels op by op in
``tests/test_torch_attention_grad.py``. Tolerances as
``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.models import transformer as jtr
from cubecl_tpu_torch.models import transformer as tr
from cubecl_tpu_torch.runtime import CpuRuntime
from test_torch_train import assert_grads_close

LR = 1e-3
CFG = dict(vocab=64, d_model=128, n_heads=2, n_layers=1, d_ff=256, seq=17)


@pytest.fixture(scope="module")
def ref():
    jcfg = jtr.TransformerConfig(**CFG)
    assert jcfg.use_framework_kernels and jcfg.use_flash_attention
    jparams = jtr.init_params(jcfg, seed=1)
    tokens = np.random.default_rng(2).integers(0, CFG["vocab"], (8, 17),
                                               dtype=np.int32)
    loss, grads = jax.value_and_grad(jtr.loss_fn)(jparams,
                                                  jnp.asarray(tokens), jcfg)
    new, step_loss = jtr.make_train_step(jcfg, LR)(jparams,
                                                   jnp.asarray(tokens))

    def sd(tree):
        return tr.params_from_jax(jax.tree.map(np.asarray, tree))

    return dict(tokens=torch.from_numpy(tokens), state=sd(jparams),
                loss=float(loss), step_loss=float(step_loss),
                grads={k: v.numpy() for k, v in sd(grads).items()},
                new={k: v.numpy() for k, v in sd(new).items()})


def _model(ref, **over):
    model = tr.Transformer(tr.TransformerConfig(**{**CFG, **over}),
                           device="cpu")
    model.load_state_dict(ref["state"])
    return model


def _grads(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def test_loss_and_grads_match_jax(ref):
    server = CpuRuntime.client().server
    n = dict(server.launches)
    model = _model(ref).requires_grad_(True)
    loss = tr.loss_fn(model, ref["tokens"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    assert_grads_close(_grads(model), ref["grads"])
    # LayerNorm 2L+1 and GELU L times, forward and backward, on K0
    for kernel, want in (("_layernorm_fwd_k", 3), ("_layernorm_bwd_k", 3),
                         ("_gelu_fwd_k", 1), ("_gelu_bwd_k", 1)):
        assert server.launches[kernel] - n.get(kernel, 0) == want, kernel


def test_train_step_matches_jax(ref):
    model = _model(ref)
    loss = tr.make_train_step(model.cfg, LR)(model, ref["tokens"])
    np.testing.assert_allclose(loss.item(), ref["step_loss"], rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref["new"][name],
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    assert_grads_close(_grads(model), ref["grads"])


def test_forward_logits_match_jax(ref):
    jcfg = jtr.TransformerConfig(**CFG)
    tokens = ref["tokens"][:, :-1]
    jp = jtr.init_params(jcfg, seed=1)
    want = jtr.forward(jp, jnp.asarray(tokens.numpy()), jcfg)
    got = tr.forward(_model(ref), tokens)
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


def test_loss_falls_on_repeated_batch(ref):
    model = _model(ref)
    step = tr.make_train_step(model.cfg)
    l1 = step(model, ref["tokens"])
    l2 = step(model, ref["tokens"])
    assert l2.item() < l1.item()


def test_flash_route_matches_plain_route():
    """S = 128 takes flash_attention (its autograd Function, plain halves
    on the CPU): loss and grads equal the einsum route's; kernels=False
    (the plain versions of every route) changes nothing either."""
    cfg = dict(CFG, seq=129)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 64, (2, 129), dtype=np.int32))
    out = []
    for flash, kernels in ((True, True), (False, True), (True, False)):
        model = tr.init_params(tr.TransformerConfig(
            **cfg, use_flash_attention=flash), seed=4,
            device="cpu").requires_grad_(True)
        loss = tr.loss_fn(model, tokens, kernels=kernels)
        loss.backward()
        out.append((loss.item(), _grads(model)))
    for loss, grads in out[1:]:
        np.testing.assert_allclose(loss, out[0][0], rtol=1e-5)
        assert_grads_close(grads, out[0][1])


def test_params_from_jax_names_every_leaf(ref):
    model = tr.init_params(tr.TransformerConfig(**CFG), seed=0, device="cpu")
    assert set(ref["state"]) == set(model.state_dict())
