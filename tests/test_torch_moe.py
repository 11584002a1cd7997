"""cubecl_tpu_torch.ops.moe against cubecl_tpu.ops.moe.

Inputs from a numpy seed. The JAX kernel E1 (``expert_matmul``) runs in
Pallas interpret mode; the port runs E1's plain version. Only the rows
below ``counts[e]`` are defined and compared, as in
``tests/test_ops.py::test_expert_matmul_and_moe_dispatch``.

Tolerances: f32 atol 1e-5 / rtol 1e-5 (both sides sum the same f32
products in other orders over d = 128); bf16 outputs atol 1e-2 / rtol 1e-2
(both accumulate in f32 and round once to bf16: one bf16 ulp apart).
Dispatch is exact: ranks, slots, experts, counts and the liveness mask
are equal, and the scattered rows are the tokens bit for bit.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import moe as jmoe
from cubecl_tpu_torch.ops import moe

E, CAP, D, F = 4, 256, 128, 256
COUNTS = [256, 130, 0, 17]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_matmul_matches_jax_on_live_rows(dtype):
    rng = np.random.RandomState(6)
    xg = jnp.asarray(rng.randn(E, CAP, D).astype(np.float32) * .2, dtype)
    w = jnp.asarray(rng.randn(E, D, F).astype(np.float32) * .2, dtype)
    counts = np.array(COUNTS, np.int32)
    ref = _np(jmoe.expert_matmul(xg, w, jnp.asarray(counts), bt=128,
                                 interpret=True))
    got = moe.expert_matmul(_torch(xg), _torch(w), torch.from_numpy(counts))
    assert got.shape == (E, CAP, F) and got.dtype == getattr(torch, dtype)
    atol, rtol = TOL[dtype]
    for e, n in enumerate(COUNTS):
        np.testing.assert_allclose(got[e, :n].float().numpy(), ref[e, :n],
                                   atol=atol, rtol=rtol)


def _dispatch_pair(x, logits, k, cap):
    ref = jmoe.moe_dispatch(jnp.asarray(x), jnp.asarray(logits), k, cap)
    got = moe.moe_dispatch(_torch(x), _torch(logits), k, cap)
    return [np.asarray(r) for r in ref], got


def _assert_dispatch_equal(ref, got):
    xg, gates, slot, expert, counts, live = ref
    np.testing.assert_array_equal(got[2].numpy(), slot)
    np.testing.assert_array_equal(got[3].numpy(), expert)
    np.testing.assert_array_equal(got[4].numpy(), counts)
    np.testing.assert_array_equal(got[5].numpy(), live)
    assert got[4].dtype == torch.int32
    # the scattered tokens are copies: equal bit for bit
    np.testing.assert_array_equal(got[0].float().numpy(), _np(xg))
    atol, rtol = TOL["float32" if gates.dtype == np.float32 else "bfloat16"]
    np.testing.assert_allclose(got[1].float().numpy(), _np(gates), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("cap", [64, 9], ids=["roomy", "dropping"])
def test_moe_dispatch_matches_jax(cap):
    rng = np.random.RandomState(1)
    T, d, n_exp, k = 48, 16, 4, 2
    x = rng.randn(T, d).astype(np.float32)
    logits = rng.randn(T, n_exp).astype(np.float32)
    ref, got = _dispatch_pair(x, logits, k, cap)
    _assert_dispatch_equal(ref, got)
    assert got[5].all() == (cap == 64)


def test_moe_dispatch_breaks_bf16_ties_as_jax():
    """bf16 router logits from a handful of values tie often: top-k must
    keep the lower expert index first, as jax.lax.top_k does (torch.topk
    promises no order among equals)."""
    rng = np.random.RandomState(2)
    T, d, n_exp, k = 64, 8, 8, 2
    x = jnp.asarray(rng.randn(T, d), jnp.bfloat16)
    logits = jnp.asarray(rng.randint(-2, 3, (T, n_exp)) * 0.5, jnp.bfloat16)
    ref, got = _dispatch_pair(x, logits, k, 12)
    tied = (np.sort(_np(logits), -1)[:, -k - 1:] ==
            np.sort(_np(logits), -1)[:, -k:][:, :1]).sum(-1) > 1
    assert tied.sum() > T // 4   # the case really ties
    _assert_dispatch_equal(ref, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_matches_jax_with_drops_and_nan(dtype):
    """A tight capacity drops routes; every row of yg past an expert's
    count holds NaN (a kernel's undefined rows): both sides mask them."""
    rng = np.random.RandomState(4)
    T, d, n_exp, k, cap, f = 40, 16, 4, 2, 12, 24
    x = jnp.asarray(rng.randn(T, d), dtype)
    logits = jnp.asarray(rng.randn(T, n_exp), dtype)
    xg, gates, slot, expert, counts, live = jmoe.moe_dispatch(x, logits, k,
                                                              cap)
    assert not bool(live.all())
    yg = rng.randn(n_exp, cap, f).astype(np.float32)
    dead = np.arange(cap)[None, :] >= np.asarray(counts)[:, None]
    yg[dead] = np.nan
    yg = jnp.asarray(yg, dtype)
    ref = _np(jmoe.moe_combine(yg, gates, slot, expert, live))
    got = moe.moe_combine(*(_torch(t) for t in (yg, gates, slot, expert,
                                                live)))
    assert np.isfinite(ref).all() and torch.isfinite(got.float()).all()
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol,
                               rtol=rtol)


def test_dispatch_matmul_combine_round_trip():
    """With identity experts the sparse FFN gives back each token mixed by
    its renormalized live gates (port only, f32)."""
    rng = np.random.RandomState(5)
    T, d, n_exp, k = 30, 16, 4, 2
    x = torch.from_numpy(rng.randn(T, d).astype(np.float32))
    logits = torch.from_numpy(rng.randn(T, n_exp).astype(np.float32))
    xg, gates, slot, expert, counts, live = moe.moe_dispatch(x, logits, k, 9)
    eye = torch.eye(d).expand(n_exp, d, d).contiguous()
    y = moe.moe_combine(moe.expert_matmul(xg, eye, counts), gates, slot,
                        expert, live)
    kept = live.any(-1)
    torch.testing.assert_close(y[kept], x[kept], atol=1e-6, rtol=1e-6)
    assert not y[~kept].any()


def test_expert_kernel_refuses_what_it_does_not_take():
    """On CUDA tensors the wrapper checks before it launches; the checks
    that need no card run on meta tensors here. A shape the tile does not
    divide raises ValueError naming it."""
    meta = dict(device="meta")
    counts = torch.empty(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match=r"\(d, f\) = \(128, 100\)"):
        moe.expert_matmul(torch.empty(2, 8, 128, **meta),
                          torch.empty(2, 128, 100, **meta), counts)
    with pytest.raises(ValueError, match="int32 counts"):
        moe.expert_matmul(torch.empty(2, 8, 128, **meta),
                          torch.empty(2, 128, 128, **meta),
                          counts.to(torch.int64))
    with pytest.raises(ValueError, match="one dtype"):
        moe.expert_matmul(torch.empty(2, 8, 128, **meta),
                          torch.empty(2, 128, 128, dtype=torch.bfloat16,
                                      **meta), counts)


def test_expert_tiles_match_the_cuda_source():
    """The wrapper's tile table is the one csrc/expert_matmul.cu builds: the
    bf16 tiles (128 x 128 and the wide 128 x 256) stage 128 bytes of K (64
    elements) on the wgmma body, and d need only be a multiple of 32 there
    (a half stage is zero-filled)."""
    import os
    import re

    path = os.path.join(os.path.dirname(moe.__file__), "..", "csrc",
                        "expert_matmul.cu")
    src = open(path).read()

    def consts(prefix, names):
        return tuple(int(re.search(rf"{prefix}_{n} = (\d+)", src).group(1))
                     for n in names)

    bm, bn, bkb, wide = consts("WG", ("BM", "BN", "BKB", "WIDE_BN"))
    assert moe.EXPERT_TILES[torch.bfloat16] == (bm, bn, bkb // 2)
    assert moe.EXPERT_WIDE_BN == wide
    assert moe.EXPERT_K_UNIT == {torch.bfloat16: 32, torch.float32: 16}
    assert "wgmma_gemm<BF16" in src
    assert moe.EXPERT_TILES[torch.float32] == consts("FMA", ("BM", "BN",
                                                            "BK"))
