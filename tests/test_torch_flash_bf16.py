"""The bf16 contract of the port's flash forward, against the JAX kernel.

On the card, bf16 inputs run the tensor-core body of
``csrc/flash_attention.cu``, which rounds P to bf16 for the P.V product,
as the JAX forward ``_fwd_call`` does (``p.astype(v.dtype)`` with f32
accumulation); the JAX kernel also folds the scale into q and rounds that
to bf16. On the CPU the port's forward is its plain version, which keeps
q and P in f32. Both round o to bf16 once.

The tolerance is the card tests' bf16 one, atol 1e-2 / rtol 1e-2: the two
roundings of the reference against none in the plain version must stay
inside it, since the card tests hold the kernel (which rounds P) to the
plain version at that bound. The JAX kernel runs in Pallas interpret mode
on the same numpy-seeded bf16 inputs, fed the repeated kv heads as the JAX
llama feeds it; the port reads kv head h // 2 directly (GQA 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import attention as jax_attention
from cubecl_tpu_torch.ops import attention as fa

ATOL, RTOL = 1e-2, 1e-2
B, H, HKV = 1, 4, 2


def _bf16_inputs(seed, S, D):
    """q (B, H, S, D), k and v (B, HKV, S, D) as bf16 torch tensors."""
    rng = np.random.default_rng(seed)
    shapes = [(B, H, S, D), (B, HKV, S, D), (B, HKV, S, D)]
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(torch.bfloat16) for s in shapes]


def _to_jax(t, rep=1):
    a = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.repeat(a, rep, axis=1) if rep > 1 else a


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [77, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_matches_jax_kernel(causal, S, D):
    q, k, v = _bf16_inputs(S * D + causal, S, D)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal)
    assert fa.flash_attention.launches == before  # the plain version
    assert got.dtype == torch.bfloat16
    ref, _ = jax_attention._fwd_call(
        _to_jax(q), _to_jax(k, H // HKV), _to_jax(v, H // HKV), causal,
        D ** -0.5, 128, 128, True, need_lse=False)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL,
                               rtol=RTOL)
