"""Block-sparse flash attention in the port against the JAX package's
``flash_attention_block_sparse`` (Pallas in interpret mode, its
``jax.custom_vjp``), on the same numpy inputs, B 1 x H 2 x S 256 x D 64.

On CPU tensors the port's ``_FlashBlockSparse`` runs its plain halves
(``flash_attention_block_sparse_plain`` with the base-2 lse,
``flash_attention_block_sparse_backward_plain``), the references of the A5,
A6 and A7 kernels on the card. Tolerances, f32: the forward within
2e-5 + 1e-4 |ref| elementwise (both compute the same f32 scores and sum in
other orders); each gradient within 1e-4 of its largest magnitude (sums of
up to S products of the forward's probabilities, taken in other orders).

Gradients are compared where no row is fully masked: on such rows (F9,
ROADMAP Queue 3; only block_q != block_k) the JAX backward is not the
gradient of the JAX forward, and the port gives the true gradient
(``test_f9_rows``).

At head dims 32, 80, 96 and 160 (Pythia-31M's, Phi-2's, Phi-3-mini's, and
one between 128 and 256) the port pads D with zeros to 64, 128 or 256, the
kernels' head dims, on the CPU as on the card, and runs D 256 (GPT-J-6B's)
as it is; the JAX kernel takes the real D. Same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import attention as jatt
from cubecl_tpu_torch.ops import attention as fa

B, H, S, D = 1, 2, 256, 64
FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_REL = 1e-4


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, S, D), dtype=np.float32)
                   for _ in range(4))
    return q * 0.5, k * 0.5, v, do


def _mask(seed, n_q, n_kv, density=0.5):
    bm = np.random.default_rng(seed).random((n_q, n_kv)) < density
    for i in range(n_q):  # every q tile attends its diagonal tile
        bm[i, min(i * n_kv // n_q, n_kv - 1)] = True
    return bm


def _port(q, k, v, do, bm, causal, bq, bk):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention_block_sparse(*ts, bm, causal, None, bq, bk)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax(q, k, v, do, bm, causal, bq, bk):
    def f(q, k, v):
        return jatt.flash_attention_block_sparse(q, k, v, bm, causal, None,
                                                 bq, bk, True)

    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close_grads(got, want):
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64)])
def test_block_sparse_matches_jax(causal, bq, bk):
    q, k, v, do = _inputs(bq + bk + causal)
    bm = _mask(bq + causal, S // bq, S // bk)
    if causal and bq != bk:
        # no fully masked row (F9): each q tile attends kv tile 0
        bm[:, 0] = True
    o, grads = _port(q, k, v, do, bm, causal, bq, bk)
    o_ref, refs = _jax(q, k, v, do, bm, causal, bq, bk)
    np.testing.assert_allclose(o, o_ref, **FWD_TOL)
    _close_grads(grads, refs)


def test_empty_kv_column_gets_zero_grads():
    """A kv tile no q tile attends: dk and dv are exactly zero there, as the
    JAX kernel's empty transposed row gives (tests/test_ops.py:887)."""
    q, k, v, do = _inputs(7)
    bm = _mask(3, 4, 4)
    bm[:, 2] = False
    bm[2, 1] = True
    o, grads = _port(q, k, v, do, bm, True, 64, 64)
    o_ref, refs = _jax(q, k, v, do, bm, True, 64, 64)
    np.testing.assert_allclose(o, o_ref, **FWD_TOL)
    _close_grads(grads, refs)
    for g in grads[1:]:
        assert np.all(g[:, :, 128:192] == 0.0)


def test_no_grad_forward_and_lse():
    """Without grad the forward runs alone; with ``return_lse`` the plain
    forward gives the base-2 lse the JAX kernel keeps (lane 0 of its
    (..., 128) broadcast)."""
    q, k, v, _ = _inputs(11)
    bm = _mask(5, 4, 4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with torch.no_grad():
        o = fa.flash_attention_block_sparse(tq, tk, tv, bm, True, None, 64,
                                            64)
    _, lse = fa.flash_attention_block_sparse_plain(tq, tk, tv, bm, True,
                                                   None, 64, 64,
                                                   return_lse=True)
    pruned = bm & (np.arange(4)[None, :] <= np.arange(4)[:, None])
    o_ref, lse_ref = jatt._bsp_fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pruned, True,
        0.125, 64, 64, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               **FWD_TOL)


def test_f9_rows():
    """F9 (ROADMAP Queue 3): bq 128, bk 64, q tile 0 attends only kv tile
    1, so rows 0..63 see only masked columns. The port's forward equals the
    JAX kernel's there (the mean of V over columns 64..127); its gradient
    equals torch.autograd of the plain forward; the JAX gradient differs."""
    q, k, v, do = _inputs(13)
    bm = np.ones((2, 4), bool)
    bm[0] = [False, True, False, False]
    o, grads = _port(q, k, v, do, bm, True, 128, 64)
    o_ref, jgrads = _jax(q, k, v, do, bm, True, 128, 64)
    np.testing.assert_allclose(o, o_ref, **FWD_TOL)
    np.testing.assert_allclose(o[:, :, :64],
                               np.broadcast_to(v[:, :, 64:128].mean(
                                   2, keepdims=True), o[:, :, :64].shape),
                               **FWD_TOL)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fa.flash_attention_block_sparse_plain(*ts, bm, True, None, 128, 64) \
        .backward(torch.from_numpy(do))
    _close_grads(grads, [t.grad.numpy() for t in ts])
    assert np.all(grads[0][:, :, :64] == 0.0)  # nothing flows to their dq
    assert np.abs(jgrads[0][:, :, :64]).max() > 1e-2
    assert np.abs(jgrads[2] - grads[2]).max() > 1.0


def test_build_block_schedule():
    bm = np.array([[1, 0, 1, 1], [0, 1, 0, 0], [0, 0, 0, 0]], bool)
    ids, counts = fa.build_block_schedule(bm, allow_empty=True)
    want_ids, want_counts = jatt.build_block_schedule(bm, allow_empty=True)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(ids, [[0, 2, 3], [1, 1, 1], [0, 0, 0]])
    ids, counts = fa.build_block_schedule(bm[:2])
    want_ids, want_counts = jatt.build_block_schedule(bm[:2])
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(counts, want_counts)
    with pytest.raises(AssertionError, match="at least|>= 1"):
        fa.build_block_schedule(bm)


@pytest.mark.parametrize("block,s", [(512, 256), (2048, 3072), (96, 1021),
                                     (200, 600)])
def test_fit_block(block, s):
    assert fa._fit_block(block, s) == jatt._fit_block(block, s)


def test_asserts_and_shapes():
    q, k, v, _ = _inputs(17)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(AssertionError, match="tile grid"):
        fa.flash_attention_block_sparse(tq, tk, tv, np.ones((2, 2), bool),
                                        True, None, 64, 64)
    bm = np.ones((4, 4), bool)
    bm[1] = False
    with pytest.raises(AssertionError, match=">= 1 kv tile"):
        fa.flash_attention_block_sparse(tq, tk, tv, bm, True, None, 64, 64)
    # causal pruning leaves q tile 0 with nothing: kv tiles 1.. only
    bm = np.ones((4, 4), bool)
    bm[0, 0] = False
    with pytest.raises(AssertionError, match=">= 1 kv tile"):
        fa.flash_attention_block_sparse(tq, tk, tv, bm, True, None, 64, 64)
    with pytest.raises(ValueError, match="as many k/v heads"):
        fa.flash_attention_block_sparse(tq, tk[:, :1], tv[:, :1],
                                        np.ones((4, 4), bool), True, None,
                                        64, 64)


PADDED_DIMS = [32, 80, 96, 160, 256]
# (causal, block_q, block_k): a square causal grid and a non-causal one
# with bq != bk
PADDED_CASES = {"causal64": (True, 64, 64), "full128x64": (False, 128, 64)}


def _inputs_d(seed, D):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, S, D), dtype=np.float32)
                   for _ in range(4))
    return q * 0.5, k * 0.5, v, do


@pytest.mark.parametrize("case", list(PADDED_CASES))
@pytest.mark.parametrize("D", PADDED_DIMS)
def test_padded_head_dims_match_jax(D, case):
    """o and dq, dk, dv at the real D against the JAX kernel; the grads keep
    the input's width, and the no-grad forward gives the same o."""
    causal, bq, bk = PADDED_CASES[case]
    q, k, v, do = _inputs_d(D + bq, D)
    bm = _mask(D + bk, S // bq, S // bk)
    o_ref, refs = _jax(q, k, v, do, bm, causal, bq, bk)
    o, grads = _port(q, k, v, do, bm, causal, bq, bk)
    assert o.shape == (B, H, S, D)
    assert all(g.shape == (B, H, S, D) for g in grads)
    np.testing.assert_allclose(o, o_ref, **FWD_TOL)
    _close_grads(grads, refs)
    with torch.no_grad():
        o2 = fa.flash_attention_block_sparse(
            *(torch.from_numpy(a) for a in (q, k, v)), bm, causal, None, bq,
            bk)
    np.testing.assert_allclose(o2.numpy(), o, rtol=0, atol=1e-6)


@pytest.mark.parametrize("D", PADDED_DIMS)
def test_f9_rows_padded(D):
    """F9's rows after padding: the JAX forward (the mean of V over the
    visited columns, V's zero columns sliced off) and the true gradient,
    autograd of the plain forward at the real D."""
    q, k, v, do = _inputs_d(D, D)
    bm = np.ones((2, 4), bool)
    bm[0] = [False, True, False, False]
    o, grads = _port(q, k, v, do, bm, True, 128, 64)
    o_ref, _ = _jax(q, k, v, do, bm, True, 128, 64)
    np.testing.assert_allclose(o, o_ref, **FWD_TOL)
    np.testing.assert_allclose(o[:, :, :64],
                               np.broadcast_to(v[:, :, 64:128].mean(
                                   2, keepdims=True), o[:, :, :64].shape),
                               **FWD_TOL)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fa.flash_attention_block_sparse_plain(*ts, bm, True, None, 128, 64) \
        .backward(torch.from_numpy(do))
    _close_grads(grads, [t.grad.numpy() for t in ts])
    assert np.all(grads[0][:, :, :64] == 0.0)


@pytest.mark.parametrize("D", [288, 320])
def test_past_128_raises_off_the_cpu(D):
    """D past 256 is not ported to the card (ROADMAP Queue 2a): off the
    CPU the public function and each wrapper raise before any kernel runs
    (meta tensors stand in for the card's); on the CPU the plain versions
    run D as it is."""
    bm = np.ones((2, 2), bool)
    q = torch.empty(1, 2, 256, D, device="meta")
    with pytest.raises(NotImplementedError, match="Queue 2a"):
        fa.flash_attention_block_sparse(q, q, q, bm, True, None, 128, 128)
    with pytest.raises(NotImplementedError, match="Queue 2a"):
        fa.bsp_forward(q, q, q, None, True, D ** -0.5, 128, 128, False)
    qc = torch.from_numpy(np.random.default_rng(D).standard_normal(
        (1, 2, 256, D), dtype=np.float32))
    o = fa.flash_attention_block_sparse(qc, qc, qc, bm, True, None, 128, 128)
    torch.testing.assert_close(o, fa.flash_attention_block_sparse_plain(
        qc, qc, qc, bm, True, None, 128, 128), rtol=0, atol=0)
