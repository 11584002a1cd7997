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


# P1's launch plan (p1_plan) and its split over positions: shapes (q
# dtype, pool dtype, B, H, Hkv, D, page, max_pages) of the serving decode
# (B 8 and 16), the d768 model, one row, a card-filling batch, and page
# sizes that a 64-position tile holds whole or not
P1_PLAN_SHAPES = [
    (torch.bfloat16, torch.bfloat16, 8, 16, 8, 128, 128, 9),
    (torch.bfloat16, torch.int8, 16, 16, 8, 128, 128, 16),
    (torch.float32, torch.float32, 16, 12, 4, 64, 128, 4),
    (torch.float32, torch.int8, 1, 8, 1, 128, 16, 256),
    (torch.bfloat16, torch.bfloat16, 2, 16, 8, 128, 16, 256),
    (torch.float32, torch.float32, 6, 6, 2, 128, 7, 21),
    (torch.bfloat16, torch.bfloat16, 40, 16, 8, 64, 16, 8),
]
P1_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 1000, 1056, 4096]


@pytest.mark.parametrize("shape", P1_PLAN_SHAPES,
                         ids=lambda s: "-".join(map(str, s[2:])))
def test_p1_plan_gives_every_position_to_one_split(shape):
    """p1_split_positions (the kernel's cut of a row on the device): the
    splits of a row of any length up to the table's capacity take [0,
    length) once, in whole 64-position tiles (the last cut at the
    length); a length-0 row has no position, a row shorter than a tile
    one split."""
    from cubecl_tpu_torch.ops.paged_attention import (P1_TILE, p1_plan,
                                                      p1_split_positions)

    dt, kv, B, H, Hkv, D, page, max_pages = shape
    plan = p1_plan(dt, kv, B, H, Hkv, D, page, max_pages)
    assert plan.grid == (plan.splits, Hkv, B)
    for length in [n for n in P1_LENGTHS if n <= page * max_pages]:
        seen = np.zeros(length, np.int64)
        live = 0
        for s in range(plan.splits):
            p0, p1 = p1_split_positions(plan, length, s)
            assert 0 <= p0 <= p1 <= length
            if p1 > p0:
                live += 1
                assert p0 % P1_TILE == 0
                assert (p1 - p0) % P1_TILE == 0 or p1 == length
                seen[p0:p1] += 1
        assert (seen == 1).all(), (length, plan)
        tiles = -(-length // P1_TILE)
        per = -(-tiles // plan.splits)  # tiles a split
        assert live == (-(-tiles // per) if tiles else 0)
        if 0 < length < P1_TILE:
            assert live == 1


def test_p1_plan_splits_only_where_the_rows_leave_the_card_idle():
    """One split where B * Hkv fills the 132 SMs at two blocks an SM (one
    where a block's shared memory holds one an SM, f32 D 128); else
    enough splits to fill them once, at most the table's tiles."""
    from cubecl_tpu_torch.ops.paged_attention import (P1_SMS, P1_SM_SMEM,
                                                      p1_plan)

    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert p1_plan(bf, bf, 8, 16, 8, 128, 128, 9).splits == 4
    assert p1_plan(bf, i8, 8, 16, 8, 128, 128, 9).splits == 4
    assert p1_plan(bf, bf, 16, 16, 8, 128, 128, 16).splits == 2
    assert p1_plan(f32, f32, 16, 12, 4, 64, 128, 4).splits == 4
    assert p1_plan(bf, bf, 1, 32, 8, 128, 16, 4096).splits == 33
    assert p1_plan(bf, bf, 2, 4, 2, 64, 8, 4).splits == 1  # one tile
    for dt, kv, D in ((bf, bf, 128), (bf, i8, 128), (f32, f32, 64),
                      (f32, f32, 128), (bf, bf, 64)):
        plan = p1_plan(dt, kv, 1, 8, 8, D, 128, 64)
        assert plan.smem_bytes <= 227 * 1024
        per_sm = 2 if P1_SM_SMEM // (plan.smem_bytes + 1024) >= 2 else 1
        assert per_sm == (1 if (dt, D) == (f32, 128) else 2)
        fill = P1_SMS * per_sm
        for B in (fill // 8, fill // 8 + 1, 100):
            assert p1_plan(dt, kv, B, 8, 8, D, 128, 64).splits == 1
        assert p1_plan(dt, kv, fill // 16, 8, 8, D, 128, 64).splits == 2


@pytest.mark.parametrize("shape", P1_PLAN_SHAPES,
                         ids=lambda s: "-".join(map(str, s[2:])))
def test_p1_plan_scratch_fits_the_combine(shape):
    """The partial sums the wrapper allocates are the combine's layout:
    (D + 2) floats per (batch row, kv head, split, query row), none
    without a split."""
    from cubecl_tpu_torch.ops.paged_attention import p1_plan

    dt, kv, B, H, Hkv, D, page, max_pages = shape
    plan = p1_plan(dt, kv, B, H, Hkv, D, page, max_pages)
    want = B * Hkv * plan.splits * (H // Hkv) * (D + 2)
    assert plan.scratch == (want if plan.splits > 1 else 0)
    assert plan.threads == 256 and plan.smem_bytes <= 227 * 1024


def _p1_split_combine(q, kp, vp, table, lengths, layer, splits):
    """P1's arithmetic in f32 numpy: each split of a (batch row, kv head)
    (p1_split_positions) as 8 warps, each an online softmax over its 8
    positions of every 64-position tile (base 2), the warps combined in
    the block, then the splits by the second launch."""
    from cubecl_tpu_torch.ops.paged_attention import P1Plan, p1_split_positions

    Bq, H, Dq = q.shape
    Hkv, Pn, page = kp.shape[1], kp.shape[2], kp.shape[3]
    G = H // Hkv
    idx = np.clip(table, 0, Pn - 1)
    S = idx.shape[1] * page
    scale = 1.0 / np.sqrt(Dq) * np.log2(np.e)
    plan = P1Plan(256, 0, (splits, Hkv, Bq), splits, 0)

    def combine(parts):
        big = np.max([m for m, _, _ in parts], 0)
        big = np.where(np.isinf(big), 0.0, big)
        return (big if len(parts) else None,
                sum(lv * np.exp2(m - big) for m, lv, _ in parts),
                sum(a * np.exp2(m - big)[:, None] for m, _, a in parts))

    out = np.zeros(q.shape, np.float32)
    for b in range(Bq):
        for hk in range(Hkv):
            kc = kp[layer, hk][idx[b]].reshape(S, Dq)
            vc = vp[layer, hk][idx[b]].reshape(S, Dq)
            qr = q[b, hk * G:(hk + 1) * G]
            blocks = []
            for s in range(splits):
                p0, p1 = p1_split_positions(plan, int(lengths[b]), s)
                warps = []
                for w in range(8):
                    t = np.array([x for x in range(p0, p1)
                                  if (x - p0) % 64 // 8 == w], np.int64)
                    if not len(t):
                        warps.append((np.full(G, -np.inf),
                                      np.zeros(G), np.zeros((G, Dq))))
                        continue
                    sc = (qr @ kc[t].T) * scale
                    m = sc.max(1)
                    p = np.exp2(sc - m[:, None])
                    warps.append((m, p.sum(1), p @ vc[t]))
                m, lv, acc = combine(warps)
                blocks.append((np.where(lv == 0, -np.inf, m), lv, acc))
            _, lv, acc = combine(blocks)
            out[b, hk * G:(hk + 1) * G] = acc / np.where(lv == 0, 1.0,
                                                          lv)[:, None]
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_p1_split_and_combine_matches_jax_kernel(splits):
    """P1's split over positions, its warps' online softmaxes and the two
    combines, emulated in f32, against the JAX P1 (interpret mode) on a
    table of 192 positions: lengths 0, 1, 63, 64, 65, 130 and 192, in 1,
    2, 3 and 5 splits (the plan's own here: 3)."""
    from cubecl_tpu_torch.ops.paged_attention import p1_plan

    rng = np.random.default_rng(40 + splits)
    Bq, Hq, Hk, Dq, Lq, Pq, page, max_pages = 7, 4, 2, 64, 2, 30, 8, 24
    q = rng.standard_normal((Bq, Hq, Dq), dtype=np.float32)
    kp = rng.standard_normal((Lq, Hk, Pq, page, Dq), dtype=np.float32)
    vp = rng.standard_normal((Lq, Hk, Pq, page, Dq), dtype=np.float32)
    table = np.stack([rng.permutation(Pq)[:max_pages]
                      for _ in range(Bq)]).astype(np.int32)
    lengths = np.array([0, 1, 63, 64, 65, 130, 192], np.int32)
    ref = jax_paged.paged_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lengths)),
        interpret=True, layer=1, dynamic_grid=False)
    got = _p1_split_combine(q, kp, vp, table, lengths, 1, splits)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert not got[0].any()
    assert p1_plan(torch.float32, torch.float32, Bq, Hq, Hk, Dq, page,
                   max_pages).splits == 3
