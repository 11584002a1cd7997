"""cubecl_tpu_torch.ops.attention against cubecl_tpu.ops.attention.

The port's flash function runs its plain version on these CPU tensors; the
JAX kernels run in Pallas interpret mode. Inputs come from a numpy seed and
cross as numpy arrays. f32 throughout, tolerance atol 2e-5 / rtol 1e-4 (as
tests/test_models.py:221): the two sides sum in different orders and the
JAX kernel folds the scale into q, so they agree to f32 rounding only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import attention as jax_attention
from cubecl_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_plain,
)

ATOL, RTOL = 2e-5, 1e-4


def _qkv(seed, B, H, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32)
    return q, k, v


def _port(q, k, v, causal):
    return flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal).numpy()


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_kernel(S, causal):
    """GQA (4 query heads on 2 kv heads) against the JAX kernel fed the
    repeated kv heads, as the JAX llama feeds it. 128-row blocks give the
    S=256 case a 2x2 tile grid with a diagonal and a skipped tile."""
    q, k, v = _qkv(S + causal, 1, 4, 2, S, S, 64)
    ref = jax_attention.flash_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=1),
        jnp.repeat(jnp.asarray(v), 2, axis=1), causal, None, 128, 128, True)
    np.testing.assert_allclose(_port(q, k, v, causal), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_padded(causal):
    """A ragged S=24 at head_dim 32: JAX pads to tiles and masks the
    padded keys; the port needs no padding."""
    q, k, v = _qkv(7, 2, 2, 2, 24, 24, 32)
    ref = jax_attention.flash_attention_padded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, 128,
        128, True)
    np.testing.assert_allclose(_port(q, k, v, causal), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_flash_matches_jax_reference_cross_lengths():
    """Sq != Skv (causal col <= row in absolute positions) and an explicit
    scale, against the JAX package's XLA reference."""
    q, k, v = _qkv(3, 1, 2, 2, 40, 72, 64)
    ref = jax_attention._reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 0.3)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), True, 0.3).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_flash_cpu_takes_plain_version_without_launching():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 2, 1, 16, 16, 64))
    before = flash_attention.launches
    np.testing.assert_array_equal(flash_attention(q, k, v).numpy(),
                                  flash_attention_plain(q, k, v).numpy())
    assert flash_attention.launches == before


def test_flash_other_devices_raise():
    """Only a CPU tensor takes the plain version: anything else launches
    the kernel or raises, with no fallback."""
    q = torch.empty(1, 2, 16, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)


def test_flash_shape_errors():
    q = torch.zeros(1, 3, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
