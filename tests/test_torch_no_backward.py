"""The hand kernels without a backward refuse autograd, on every device.

E1, C1, P1 and P3 write their outputs through ``data_ptr()`` into a fresh
tensor and have no autograd Function (nor have the JAX kernels, whose
``jax.grad`` fails; S1 has a backward of its own, held by
``tests/test_torch_mamba_train.py``). So each wrapper's kernel route raises
``NotImplementedError`` under grad mode when an input requires grad,
before it looks at the device: the CPU holds the same contract as the
card, where the graph would otherwise be cut silently. The plain routes
(``*_plain``, ``kernels=False``) stay differentiable, and the kernel
routes still run under ``torch.no_grad()``. Small shapes, inputs from a
numpy seed.
"""

import numpy as np
import pytest
import torch

from cubecl_tpu_torch.ops import conv, moe, paged_attention as pa


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _experts(rng):
    counts = torch.tensor([3, 0], dtype=torch.int32)
    return ((lambda x, w: moe.expert_matmul(x, w, counts)),
            (lambda x, w: moe.expert_matmul_plain(x, w, counts)),
            [_t(rng, 2, 4, 16), _t(rng, 2, 16, 8)], "expert_matmul")


def _conv_pairs(rng):
    return ((lambda x, w: conv.conv2d_pairs(x, w)),
            (lambda x, w: conv.conv2d_pairs_plain(
                torch.nn.functional.pad(x, (0, 64 - 8)),
                torch.nn.functional.pad(w, (0, 64 - 8, 0, 64 - 8)),
                8)[..., :8]),
            [_t(rng, 1, 4, 6, 8), _t(rng, 3, 3, 8, 8)], "conv3x3")


def _conv_pairs_packed(rng):
    return ((lambda x, w: conv.conv2d_pairs_packed(x, w, 4)),
            (lambda x, w: conv.conv2d_pairs_plain(
                x.reshape(1, 4, 6, 64), w).reshape(1, 12, 128)),
            [_t(rng, 1, 12, 128), _t(rng, 3, 3, 64, 64)], "conv3x3")


def _paged_inputs(rng):
    # 2 sequences, 4 query heads on 2 kv heads of 16, pages of 4 rows
    kp, vp = _t(rng, 1, 2, 5, 4, 16), _t(rng, 1, 2, 5, 4, 16)
    table = torch.tensor([[0, 2], [4, 1]], dtype=torch.int32)
    lengths = torch.tensor([7, 3], dtype=torch.int32)
    return kp, vp, table, lengths


def _paged(rng):
    kp, vp, table, lengths = _paged_inputs(rng)
    return ((lambda q, k, v: pa.paged_attention(q, k, v, table, lengths)),
            (lambda q, k, v: pa.paged_attention_plain(q, k, v, table,
                                                      lengths)),
            [_t(rng, 2, 4, 16), kp, vp], "paged_attention")


def _paged_chunked(rng):
    kp, vp, table, lengths = _paged_inputs(rng)
    starts = torch.tensor([4, 0], dtype=torch.int32)
    return ((lambda q, k, v: pa.paged_attention_chunked(
                q, k, v, table, lengths, starts)),
            (lambda q, k, v: pa.paged_attention_chunked_plain(
                q, k, v, table, lengths, starts)),
            [_t(rng, 2, 4, 3, 16), kp, vp], "paged_attention_chunked")


ROUTES = {"E1 expert_matmul": _experts,
          "C1 conv2d_pairs": _conv_pairs,
          "C1 conv2d_pairs_packed": _conv_pairs_packed,
          "P1 paged_attention": _paged,
          "P3 paged_attention_chunked": _paged_chunked}


@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_route_refuses_autograd(route):
    kernel, plain, inputs, name = ROUTES[route](np.random.default_rng(11))
    leaves = [t if t.requires_grad else t.clone().requires_grad_()
              for t in inputs]
    with pytest.raises(NotImplementedError, match=name):
        kernel(*leaves)
    # the plain route gives every input a gradient
    out = plain(*leaves)
    grads = torch.autograd.grad(out.float().square().sum(), leaves)
    assert all(g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
               for g in grads)
    # without autograd the kernel route runs (its plain version on the CPU)
    with torch.no_grad():
        assert torch.equal(kernel(*leaves), plain(*leaves))
