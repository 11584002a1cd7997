"""The gradient of cubecl_tpu_torch.ops.attention.flash_attention against
cubecl_tpu.ops.attention.flash_attention (its custom_vjp, Pallas in
interpret mode).

On these CPU tensors the port's ``_FlashAttention`` runs its plain halves
(``flash_attention_plain`` with the base-2 lse, and
``flash_attention_backward_plain``), so this exercises the Function's
wiring: the saved lse, di = rowsum(do * o), the GQA sums. Inputs and the
upstream do come from a numpy seed and cross as numpy arrays. f32, atol
1e-5 / rtol 1e-4: both sides recompute the same f32 probabilities and sum
in different orders (the JAX kernels also fold the scale into q).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import attention as jax_attention
from cubecl_tpu_torch.ops import attention as fa

ATOL, RTOL = 1e-5, 1e-4


def _inputs(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    do = rng.standard_normal((B, H, S, D), dtype=np.float32)
    return q, k, v, do


def _port_grads(q, k, v, do, causal):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_attention(q, k, v, causal)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


def _jax_grads(q, k, v, do, causal):
    """jax.vjp of the JAX flash_attention fed kv heads repeated to H (as
    the JAX models feed it); dk, dv summed back over each group."""
    rep = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return jax_attention.flash_attention(
            q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1),
            causal, None, None, None, True)

    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("H,Hkv,D", [(2, 2, 64), (2, 2, 128), (4, 2, 64)],
                         ids=["d64", "d128", "gqa4on2_d64"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grad_matches_jax(H, Hkv, D, causal):
    q, k, v, do = _inputs(D + H + causal, 1, H, Hkv, 128, D)
    o, grads = _port_grads(q, k, v, do, causal)
    o_ref, refs = _jax_grads(q, k, v, do, causal)
    np.testing.assert_allclose(o, o_ref, atol=ATOL, rtol=RTOL)
    for name, got, ref in zip("qkv", grads, refs):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


def test_plain_lse_matches_jax_kernel():
    """The base-2 lse of ``flash_attention_plain`` is A1's residual (JAX
    broadcasts it over 128 lanes)."""
    q, k, v, _ = _inputs(5, 1, 2, 2, 128, 64)
    _, lse = fa.flash_attention_plain(*(torch.from_numpy(a)
                                        for a in (q, k, v)), True,
                                      return_lse=True)
    _, ref = jax_attention._fwd_call(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), True, 0.125, 128, 128,
                                     True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref)[..., 0],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_plain_matches_autograd(causal, dtype):
    """``flash_attention_backward_plain`` (the kernels' oracle on the card)
    against torch autograd through ``flash_attention_plain``, at a ragged
    S, GQA 6 on 2 and an explicit scale."""
    g = torch.Generator().manual_seed(11)
    q = torch.randn(2, 6, 100, 64, generator=g, dtype=dtype)
    k = torch.randn(2, 2, 100, 64, generator=g, dtype=dtype)
    v = torch.randn(2, 2, 100, 64, generator=g, dtype=dtype)
    do = torch.randn(2, 6, 100, 64, generator=g, dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention_plain(*leaves, causal, 0.2)
    o.backward(do)
    o, lse = fa.flash_attention_plain(q, k, v, causal, 0.2, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 6, 100)
    got = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal, 0.2)
    for name, a, t in zip("qkv", got, leaves):
        assert a.dtype == dtype and a.shape == t.shape
        torch.testing.assert_close(a, t.grad, atol=ATOL, rtol=RTOL,
                                   msg=f"d{name}")


def test_function_only_with_grad_and_never_launches_on_cpu():
    """No grad: the plain forward alone; with grad: the Function, whose
    forward equals the plain one. No kernel counter moves on the CPU."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 2, 40, 64))
    counts = (fa.flash_attention.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
    plain = fa.flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    o = fa.flash_attention(qg, k, v)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    torch.testing.assert_close(o.detach(), plain, atol=0, rtol=0)
    with torch.no_grad():
        assert fa.flash_attention(qg, k, v).grad_fn is None
    o.backward(do)
    assert qg.grad.shape == q.shape
    assert counts == (fa.flash_attention.launches, fa.flash_bwd_dkv.launches,
                      fa.flash_bwd_dq.launches)


def test_backward_kernels_reject_cpu_tensors():
    """The dK/dV and dQ wrappers launch on a card or raise: no fallback."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(4, 1, 2, 2, 16, 64))
    lse = torch.zeros(1, 2, 16)
    for wrapper in (fa.flash_bwd_dkv, fa.flash_bwd_dq):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(q, k, v, do, lse, lse)
        with pytest.raises(ValueError, match="shaped as q"):
            wrapper(q, k, v, do[:, :, :8], lse, lse)
