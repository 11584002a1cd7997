"""The gradients of cubecl_tpu_torch.ops.functional's four ops against
jax.grad of cubecl_tpu.ops.functional's custom_vjp ops.

Both sides run their ``@cube`` kernels: the port's forward and backward
through the torch evaluator (K0's CPU twin), the JAX package's through its
CPU client. Inputs of ``tests/test_functional.py`` (16 x 128 f32, a numpy
seed); dx, dg and db at atol 1e-5 / rtol 1e-4, the same f32 math summed in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import functional as JF
from cubecl_tpu_torch.ops import functional as F
from cubecl_tpu_torch.runtime import CpuRuntime

ATOL, RTOL = 1e-5, 1e-4
N_PARAMS = {"gelu": 0, "softmax": 0, "layernorm": 2, "rmsnorm": 1}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(7)
    x = rng.randn(16, 128).astype(np.float32)
    g = (rng.randn(128) * 0.1 + 1.0).astype(np.float32)
    b = (rng.randn(128) * 0.1).astype(np.float32)
    dy = rng.randn(16, 128).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("op", ["gelu", "softmax", "layernorm", "rmsnorm"])
def test_grads_match_jax(data, op):
    x, g, b, dy = data
    args = [x, g, b][:1 + N_PARAMS[op]]
    ref_y, vjp = jax.vjp(getattr(JF, op), *(jnp.asarray(a) for a in args))
    refs = vjp(jnp.asarray(dy))

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    server = CpuRuntime.client().server
    n_fwd = server.launches[f"_{op}_fwd_k"]
    n_bwd = server.launches[f"_{op}_bwd_k"]
    y = getattr(F, op)(*leaves)
    assert server.launches[f"_{op}_fwd_k"] == n_fwd + 1
    y.backward(torch.from_numpy(dy))
    assert server.launches[f"_{op}_bwd_k"] == n_bwd + 1     # dx: one launch
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               atol=ATOL, rtol=RTOL)
    for name, t, ref in zip(["dx", "dg", "db"], leaves, refs):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("op", ["gelu", "softmax", "layernorm", "rmsnorm"])
def test_grads_match_plain_autograd(op):
    """On rows of a 3-d input (the models' (B, S, d)) and a non-contiguous
    upstream gradient, against torch autograd through a plain f64
    formula."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 256, generator=gen)
    g = torch.randn(256, generator=gen) * 0.1 + 1.0
    b = torch.randn(256, generator=gen) * 0.1
    dy = torch.randn(256, 8, 2, generator=gen).transpose(0, 2)
    args = [x, g, b][:1 + N_PARAMS[op]]

    def plain(x, g=None, b=None):
        if op == "gelu":
            return torch.nn.functional.gelu(x)
        if op == "softmax":
            return torch.softmax(x, -1)
        if op == "layernorm":
            return torch.nn.functional.layer_norm(x, (256,), g, b, 1e-5)
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-5) * g

    leaves = [a.clone().requires_grad_() for a in args]
    getattr(F, op)(*leaves).backward(dy)
    refs = [a.double().requires_grad_() for a in args]
    plain(*refs).backward(dy.double())
    for t, r in zip(leaves, refs):
        torch.testing.assert_close(t.grad, r.grad.float(), atol=ATOL,
                                   rtol=RTOL)


def test_param_grads_skipped_when_not_needed(data):
    """A frozen gain gets no gradient and costs no reduction."""
    x, g, _b, dy = data
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(g)
    F.rmsnorm(xt, gt).backward(torch.from_numpy(dy))
    assert xt.grad is not None and gt.grad is None
