"""The bf16 contract of the port's flash backward, against the JAX kernels.

On the card, bf16 inputs run the tensor-core bodies of
``csrc/flash_attention_bwd.cu``, which feed p and dS to their products in
bf16 with f32 accumulation, as the JAX kernels do: ``p.astype(do.dtype)``
for dV and ``ds.astype(q.dtype)`` for dK and dQ in ``_bwd_dkv_call`` /
``_bwd_dq_call`` (A3, A4) and in ``_bsp_dkv_call`` / ``_bsp_dq_call`` (A7,
A6), dS taken from the unrounded f32 p. The port's plain versions give
that rounding with ``round_p_ds=True``; the card tests hold the kernels to
them. Here the plain versions with that rounding are held against the JAX
kernels in Pallas interpret mode, on the same numpy-seeded bf16 inputs and
the same residuals (the port's plain lse, base 2, and di = rowsum(dO * o),
broadcast to the JAX kernels' 128 lanes).

The tolerance is the card tests' bf16 one, atol 1e-2 / rtol 1e-2: both
sides round p and dS at the same places and round each gradient to bf16
once; they differ in the order of their f32 sums and, under GQA, in where
the group sum is rounded (the JAX kernels see the kv heads repeated, as the
JAX llama feeds them, and return one bf16 gradient a query head, summed
here in f32; the port sums in f32 and rounds once). The block-sparse masks
leave no row without a live column (F9, ROADMAP Queue 3, where the JAX
backward is not the gradient of the JAX forward).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import attention as jax_attention
from cubecl_tpu_torch.ops import attention as fa

ATOL, RTOL = 1e-2, 1e-2
B = 1


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) \
        .to(torch.bfloat16)


def _jax(t, rep=1):
    a = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.repeat(a, rep, axis=1) if rep > 1 else a


def _lanes(stat):
    """(B, H, S) f32 -> the JAX kernels' (B, H, S, 128) layout."""
    a = jnp.asarray(stat.float().numpy())
    return jnp.broadcast_to(a[..., None], a.shape + (128,))


def _close(got, ref, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _f32(a):
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [63, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_bf16_matches_jax_kernels(causal, S, D):
    """A3 and A4 (GQA 2: H 4 on 2 kv heads) against the rounding plain
    backward."""
    H, Hkv = 4, 2
    rng = np.random.default_rng(S * D + causal)
    q, do = _bf16(rng, (B, H, S, D)), _bf16(rng, (B, H, S, D))
    k, v = _bf16(rng, (B, Hkv, S, D)), _bf16(rng, (B, Hkv, S, D))
    o, lse = fa.flash_attention_plain(q, k, v, causal, return_lse=True)
    di = (do.float() * o.float()).sum(-1)
    dq, dk, dv = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                   causal, round_p_ds=True)
    assert dq.dtype == dk.dtype == torch.bfloat16
    rep, scale = H // Hkv, D ** -0.5
    blk = jax_attention._fit_block(128, S)
    args = (_jax(q), _jax(k, rep), _jax(v, rep), _jax(do), _lanes(lse),
            _lanes(di), causal, scale, blk, blk, True)
    jdk, jdv = jax_attention._bwd_dkv_call(*args)
    jdq = jax_attention._bwd_dq_call(*args)

    def fold(g):  # the transpose of jnp.repeat: one kv head's group sum
        return _f32(g).reshape(B, Hkv, rep, S, D).sum(2)

    _close(dq, _f32(jdq), "dq")
    _close(dk, fold(jdk), "dk")
    _close(dv, fold(jdv), "dv")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,bq,bk", [(63, 21, 63), (200, 100, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bsp_bwd_bf16_matches_jax_kernels(causal, S, bq, bk, D):
    """A6 and A7 on a random block mask (kv tile 0 attended by every q tile,
    so no row is F9's) against the rounding block-sparse plain backward."""
    H = 2
    rng = np.random.default_rng(S + bq + D + causal)
    q, k, v, do = (_bf16(rng, (B, H, S, D)) for _ in range(4))
    n_q, n_kv = S // bq, S // bk
    bm = rng.random((n_q, n_kv)) < 0.5
    bm[:, 0] = True
    o, lse = fa.flash_attention_block_sparse_plain(q, k, v, bm, causal, None,
                                                   bq, bk, return_lse=True)
    di = (do.float() * o.float()).sum(-1)
    dq, dk, dv = fa.flash_attention_block_sparse_backward_plain(
        q, k, v, o, lse, do, bm, causal, None, bq, bk, round_p_ds=True)
    pruned = fa._pruned_mask(bm, causal, bq, bk, n_q, n_kv)
    args = (_jax(q), _jax(k), _jax(v), _jax(do), _lanes(lse), _lanes(di),
            pruned, causal, D ** -0.5, bq, bk, True)
    jdq = jax_attention._bsp_dq_call(*args)
    jdk, jdv = jax_attention._bsp_dkv_call(*args)
    _close(dq, _f32(jdq), "dq")
    _close(dk, _f32(jdk), "dk")
    _close(dv, _f32(jdv), "dv")


def test_round_p_ds_is_off_by_default_and_moves_bf16_only():
    """Off, the plain backward is exact in f32 (its default, the f32
    reference of the card tests); on, it changes bf16 gradients and leaves
    f32 ones alone."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 2, 64, 64), dtype=np.float32)) for _ in range(4))
    for dt in (torch.float32, torch.bfloat16):
        t = [x.to(dt) for x in (q, k, v, do)]
        o, lse = fa.flash_attention_plain(*t[:3], True, return_lse=True)
        exact = fa.flash_attention_backward_plain(*t[:3], o, lse, t[3])
        rounded = fa.flash_attention_backward_plain(*t[:3], o, lse, t[3],
                                                    round_p_ds=True)
        same = [torch.equal(a, b) for a, b in zip(exact, rounded)]
        assert all(same) == (dt == torch.float32), (dt, same)
