"""cubecl_tpu_torch.ops.paged_attention against cubecl_tpu's paged decode.

The port's function runs its plain version on these CPU tensors; the JAX
kernels run in Pallas interpret mode, on both of their grids: the live
work list (P2, ``dynamic_grid=True``) and the static capacity grid (P1).
Stacked pool with ``layer=1``, 2 query heads per kv head, page 8, and
lengths that include 0, a mid-page value, a page boundary and the full
capacity. f32, atol 2e-5 / rtol 1e-4: different summation orders only.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
)

# cubecl_tpu.ops re-exports the function under the module's name
jax_paged = importlib.import_module("cubecl_tpu.ops.paged_attention")

ATOL, RTOL = 2e-5, 1e-4
B, H, HKV, D = 4, 4, 2, 64
L, P, PAGE, MAX_PAGES = 2, 20, 8, 4
LENGTHS = np.array([0, 13, 32, 8], np.int32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    vp = rng.standard_normal((L, HKV, P, PAGE, D), dtype=np.float32)
    table = np.stack([rng.permutation(P)[:MAX_PAGES]
                      for _ in range(B)]).astype(np.int32)
    return q, kp, vp, table, LENGTHS


def _port(q, kp, vp, table, lengths, **kw):
    return paged_attention(*(torch.from_numpy(a)
                             for a in (q, kp, vp, table, lengths)),
                           **kw).numpy()


@pytest.mark.parametrize("dynamic_grid", [True, False], ids=["P2", "P1"])
def test_paged_matches_jax_kernel(inputs, dynamic_grid):
    ref = jax_paged.paged_attention(
        *(jnp.asarray(a) for a in inputs), interpret=True, layer=1,
        dynamic_grid=dynamic_grid)
    got = _port(*inputs, layer=1)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert not got[LENGTHS == 0].any()   # length 0: zeros, as the kernels


def test_paged_matches_jax_reference(inputs):
    """The JAX XLA oracle on layer 1's pool. Its length-0 row is a uniform
    softmax over masked scores, not the kernels' zeros: compare the rest."""
    q, kp, vp, table, lengths = inputs
    ref = np.asarray(jax_paged.paged_attention_reference(
        *(jnp.asarray(a) for a in (q, kp[1], vp[1], table, lengths))))
    got = _port(*inputs, layer=1)
    live = lengths > 0
    np.testing.assert_allclose(got[live], ref[live], atol=ATOL, rtol=RTOL)


def test_paged_scale_and_layer(inputs):
    """An explicit sm_scale on layer 0 against the JAX static-grid kernel."""
    ref = jax_paged.paged_attention(
        *(jnp.asarray(a) for a in inputs), sm_scale=0.2, interpret=True,
        layer=0, dynamic_grid=False)
    np.testing.assert_allclose(_port(*inputs, sm_scale=0.2, layer=0),
                               np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_paged_cpu_takes_plain_version_without_launching(inputs):
    ts = [torch.from_numpy(a) for a in inputs]
    before = paged_attention.launches
    np.testing.assert_array_equal(paged_attention(*ts, layer=1).numpy(),
                                  paged_attention_plain(*ts, layer=1).numpy())
    assert paged_attention.launches == before


def test_paged_other_devices_raise(inputs):
    ts = [torch.from_numpy(a).to("meta") for a in inputs]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(*ts)


def test_paged_shape_errors(inputs):
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(ValueError):
        paged_attention(q, kp[0], vp[0], table, lengths)   # per-layer pool
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, table[:2], lengths)
