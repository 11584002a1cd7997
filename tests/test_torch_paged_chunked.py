"""cubecl_tpu_torch.ops.paged_attention's chunked attention (P3), int8 KV
in decode attention (P1) and ``quantize_kv``, against cubecl_tpu's.

The port's functions run their plain versions on these CPU tensors; the
JAX kernels run in Pallas interpret mode. Stacked pools of 3 layers read
at layer 2 (layer 1 for int8), page 8, 4 rows whose chunks start at 0, in
mid-page, on a page boundary and in mid-page again, so that the lengths
(start + C, as P3 requires) are ragged. f32 inputs, atol 1e-5 / rtol 1e-4:
the two sides sum in different orders.
"""

import dataclasses
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu_torch.ops.paged_attention import (
    p3_block_positions,
    p3_plan,
    paged_attention,
    paged_attention_chunked,
    paged_attention_chunked_plain,
    paged_attention_plain,
    quantize_kv,
)

jax_paged = importlib.import_module("cubecl_tpu.ops.paged_attention")

ATOL, RTOL = 1e-5, 1e-4
B, HKV, D = 4, 2, 64
L, P, PAGE, MAX_PAGES = 3, 24, 8, 4
STARTS = np.array([0, 5, 8, 13], np.int32)


def _pools(rng, quant):
    """(k, v, k_scales, v_scales) as numpy: f32 pools, or int8 pools with
    positive f32 scales of the size quantize_kv gives N(0, 1) rows."""
    shape = (L, HKV, P, PAGE, D)
    if not quant:
        return (rng.standard_normal(shape, dtype=np.float32),
                rng.standard_normal(shape, dtype=np.float32), None, None)
    k, v = (rng.integers(-127, 128, shape, dtype=np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.03, shape[:4]).astype(np.float32)
              for _ in range(2))
    return k, v, ks, vs


def _table(rng):
    return np.stack([rng.permutation(P)[:MAX_PAGES]
                     for _ in range(B)]).astype(np.int32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# every pool type meets each G and each C (the full product adds nothing:
# the kernel's rows are g * C + i either way)
@pytest.mark.parametrize("quant, G, C", [
    (False, 1, 1), (False, 2, 5), (False, 2, 16),
    (True, 1, 5), (True, 2, 1), (True, 1, 16)],
    ids=["f32-G1-C1", "f32-G2-C5", "f32-G2-C16", "int8-G1-C5", "int8-G2-C1",
         "int8-G1-C16"])
def test_chunked_matches_jax_kernel(quant, G, C):
    rng = np.random.default_rng(100 * C + 10 * G + quant)
    k, v, ks, vs = _pools(rng, quant)
    q = rng.standard_normal((B, HKV * G, C, D), dtype=np.float32)
    table = _table(rng)
    lengths = STARTS + C
    layer = 1 if quant else 2
    ref = jax_paged.paged_attention_chunked(
        *(jnp.asarray(a) for a in (q, k, v, table, lengths, STARTS)),
        interpret=True, k_scales=_j(ks), v_scales=_j(vs), layer=layer)
    got = paged_attention_chunked(
        *(torch.from_numpy(a) for a in (q, k, v, table, lengths, STARTS)),
        layer=layer, k_scales=_t(ks), v_scales=_t(vs))
    assert got.shape == (B, HKV * G, C, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_chunked_masks_lengths_and_empty_rows():
    """The port also masks t < lengths (P3 assumes lengths = starts + C):
    against a numpy oracle with lengths below starts + C, a row of length
    0 (zeros) and a row whose first tokens see nothing past its length."""
    rng = np.random.default_rng(7)
    C, G = 5, 2
    k, v, _, _ = _pools(rng, False)
    q = rng.standard_normal((B, HKV * G, C, D), dtype=np.float32)
    table = _table(rng)
    starts = np.array([0, 5, 8, 3], np.int32)
    lengths = np.array([0, 7, 13, 30], np.int32)
    got = paged_attention_chunked_plain(
        *(torch.from_numpy(a) for a in (q, k, v, table, lengths, starts)),
        layer=2).numpy()
    assert not got[0].any()
    kc = k[2][:, table].reshape(HKV, B, -1, D)
    vc = v[2][:, table].reshape(HKV, B, -1, D)
    for b in range(1, B):
        for h in range(HKV * G):
            for i in range(C):
                n = min(starts[b] + i + 1, lengths[b])
                s = q[b, h, i] @ kc[h // G, b, :n].T / np.sqrt(D)
                p = np.exp(s - s.max())
                ref = (p / p.sum()) @ vc[h // G, b, :n]
                np.testing.assert_allclose(got[b, h, i], ref, atol=ATOL,
                                           rtol=RTOL)


@pytest.mark.parametrize("dynamic_grid", [True, False], ids=["P2", "P1"])
def test_int8_decode_matches_jax_kernel(dynamic_grid):
    """P1 with int8 pools and scales against the JAX kernel on both of its
    grids; lengths 0, mid-page, a page boundary and the full table."""
    rng = np.random.default_rng(3)
    k, v, ks, vs = _pools(rng, True)
    q = rng.standard_normal((B, 2 * HKV, D), dtype=np.float32)
    table = _table(rng)
    lengths = np.array([0, 13, 16, 32], np.int32)
    ref = jax_paged.paged_attention(
        *(jnp.asarray(a) for a in (q, k, v, table, lengths)),
        interpret=True, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        layer=1, dynamic_grid=dynamic_grid)
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q, k, v, table, lengths)),
                          layer=1, k_scales=_t(ks), v_scales=_t(vs)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert not got[0].any()


def test_quantize_kv_matches_jax():
    """int8 values equal but for +-1 on at most 0.1% of the entries (an f32
    quotient on the other side of .5), scales within 1e-7 relative."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((HKV, P, PAGE, D), dtype=np.float32)
    x[0, 0, 0] = 0.0                                  # amax 0: scale 1
    jq, js = (np.asarray(a) for a in jax_paged.quantize_kv(jnp.asarray(x)))
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-7, atol=0)
    assert s[0, 0, 0] == 1.0 and not q[0, 0, 0].any()
    diff = np.abs(q.numpy().astype(np.int32) - jq.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_quantize_kv_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, s = quantize_kv(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


def test_page_ids_are_clamped():
    """Table entries outside [0, P) read the nearest pool page (the JAX
    scale gather wraps -1 to the last page instead)."""
    rng = np.random.default_rng(9)
    k, v, ks, vs = (torch.from_numpy(a) for a in _pools(rng, True))
    q = torch.from_numpy(rng.standard_normal((1, HKV, D), dtype=np.float32))
    lengths = torch.tensor([2 * PAGE], dtype=torch.int32)
    bad = torch.tensor([[-1, P + 3]], dtype=torch.int32)
    good = torch.tensor([[0, P - 1]], dtype=torch.int32)
    got, want = (paged_attention_plain(q, k, v, t, lengths, layer=0,
                                       k_scales=ks, v_scales=vs)
                 for t in (bad, good))
    assert torch.equal(got, want)


def test_cpu_takes_plain_versions_without_launching():
    rng = np.random.default_rng(1)
    k, v, ks, vs = (torch.from_numpy(a) for a in _pools(rng, True))
    q = torch.from_numpy(rng.standard_normal((B, HKV, 3, D),
                                             dtype=np.float32))
    table = torch.from_numpy(_table(rng))
    starts = torch.from_numpy(STARTS)
    n = (paged_attention_chunked.launches, paged_attention.launches,
         paged_attention.int8_launches)
    args = (q, k, v, table, starts + 3, starts)
    assert torch.equal(
        paged_attention_chunked(*args, layer=1, k_scales=ks, v_scales=vs),
        paged_attention_chunked_plain(*args, layer=1, k_scales=ks,
                                      v_scales=vs))
    paged_attention(q[:, :, 0], k, v, table, starts + 1, k_scales=ks,
                    v_scales=vs)
    assert (paged_attention_chunked.launches, paged_attention.launches,
            paged_attention.int8_launches) == n


def test_other_devices_and_bad_arguments_raise():
    rng = np.random.default_rng(2)
    k, v, ks, vs = (torch.from_numpy(a) for a in _pools(rng, True))
    q = torch.zeros(B, HKV, 2, D)
    table = torch.from_numpy(_table(rng))
    starts = torch.from_numpy(STARTS)
    meta = [t.to("meta") for t in (q, k, v, table, starts + 2, starts, ks,
                                   vs)]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_chunked(*meta[:6], k_scales=meta[6],
                                v_scales=meta[7])
    with pytest.raises(ValueError, match="scales"):
        paged_attention_chunked(q, k, v, table, starts + 2, starts)
    with pytest.raises(ValueError, match="scales"):
        paged_attention(q[:, :, 0], k, v, table, starts, k_scales=ks)
    with pytest.raises(ValueError):
        paged_attention_chunked(q, k, v, table, starts[:2] + 2, starts,
                                k_scales=ks, v_scales=vs)


# (name, B, Hkv, G, C, D, page, max_pages, starts, lengths): the ragged and
# length-0 rows of test_chunked_masks_lengths_and_empty_rows, and
# chip_smoke.py's phase i shapes (the verify step, the ragged batch with a
# length-0 row, a prefill chunk), page sizes that do not divide 64 included
P3_PLAN_CASES = [
    ("masks", 4, 2, 2, 5, 64, 8, 4, [0, 5, 8, 3], [0, 7, 13, 30]),
    ("masks page 7", 4, 2, 2, 5, 64, 7, 5, [0, 5, 8, 3], [0, 7, 13, 30]),
    ("verify", 8, 8, 2, 5, 128, 128, 9, [1051] * 8, [1056] * 8),
    ("ragged", 8, 8, 2, 16, 128, 128, 8, [0, 1, 127, 128, 500, 1000, 640, 3],
     [0, 17, 143, 144, 510, 1016, 656, 10]),
    ("ragged page 48", 8, 8, 2, 16, 128, 48, 22,
     [0, 1, 127, 128, 500, 1000, 640, 3],
     [0, 17, 143, 144, 510, 1016, 656, 10]),
    ("prefill", 8, 8, 2, 256, 128, 128, 9, [768] * 8, [1024] * 8),
]


@pytest.mark.parametrize("case", P3_PLAN_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_p3_plan_gives_every_position_to_one_split(case, kv):
    """P3's bf16 plan (csrc/paged_chunked.cu's tc_plan, repeated by
    ops/paged_attention.py's p3_plan): decode-shaped chunks (G*C <= 64)
    split the table's span into equal multiples of 64 positions, enough
    for 264 blocks (132 SMs twice), prefill-shaped ones do not split; for
    every batch row and row tile the blocks' position ranges are disjoint
    and their union is [0, the tile's last live position], so each
    position a row attends (t < length, t <= start + i) is some one
    block's, and a length-0 row's blocks have none."""
    name, B, Hkv, G, C, D, page, max_pages, starts, lengths = case
    plan = p3_plan(torch.bfloat16, torch.int8 if kv == "int8"
                   else torch.bfloat16, B, Hkv * G, Hkv, C, D, page,
                   max_pages)
    rows = -(-G * C // 64)
    assert plan.body == "wgmma" and plan.threads == 128
    assert plan.grid == (rows * plan.splits, Hkv, B)
    assert plan.smem_bytes <= 227 * 1024
    assert plan.split_len % 64 == 0
    assert plan.splits * plan.split_len >= page * max_pages
    if G * C <= 64 and B * Hkv < 264:
        assert B * Hkv * plan.splits >= 264 or plan.split_len == 64
        assert plan.scratch == (B * Hkv * plan.splits * G * C * (D + 2)
                                if plan.splits > 1 else 0)
    else:
        assert plan.splits == 1 and plan.scratch == 0
    for b in range(B):
        live = {}
        for x in range(plan.grid[0]):
            r0, r_end, p0, p1 = p3_block_positions(plan, C, G, starts[b],
                                                   lengths[b], x)
            for r in range(r0, r_end):
                got = live.setdefault(r, [])
                assert not set(got) & set(range(p0, p1))
                got.extend(range(p0, p1))
        assert sorted(live) == list(range(G * C))
        for r, got in live.items():
            want = range(min(lengths[b], starts[b] + r % C + 1))
            assert set(want) <= set(got), (b, r)
            if lengths[b] == 0:
                assert not got


def _split_combine(q, k, v, table, lengths, starts, layer, ks, vs,
                   split_len):
    """P3's split over positions and its combine, emulated in f32 numpy:
    per (b, kv head) and split of ``split_len`` positions, the rows'
    partial base-2 softmax (m, l over the unscaled p, acc = (p . V scale)
    V), then the combine's rescaling by 2^(m - max m) (a split without a
    live position adds 0; a row without one gets zeros)."""
    Bq, H, C, Dq = q.shape
    Hkv, Pn, page = k.shape[1], k.shape[2], k.shape[3]
    G = H // Hkv
    idx = np.clip(table, 0, Pn - 1)
    S = idx.shape[1] * page
    scale = 1.0 / math.sqrt(Dq) * math.log2(math.e)
    out = np.zeros(q.shape, np.float32)
    for b in range(Bq):
        for hk in range(Hkv):
            kc = k[layer, hk][idx[b]].reshape(S, Dq).astype(np.float32)
            vc = v[layer, hk][idx[b]].reshape(S, Dq).astype(np.float32)
            ksc = np.ones(S, np.float32) if ks is None \
                else ks[layer, hk][idx[b]].reshape(S)
            vsc = np.ones(S, np.float32) if vs is None \
                else vs[layer, hk][idx[b]].reshape(S)
            qr = q[b, hk * G:(hk + 1) * G].reshape(G * C, Dq)
            pos = starts[b] + np.arange(G * C) % C
            parts = []
            for p0 in range(0, S, split_len):
                t = np.arange(p0, min(p0 + split_len, S))
                sc = (qr @ kc[t].T) * scale * ksc[t]
                live = (t[None] < lengths[b]) & (t[None] <= pos[:, None])
                sc = np.where(live, sc, -np.inf)
                m = sc.max(1)
                mu = np.where(np.isinf(m), 0.0, m)
                p = np.where(live, np.exp2(sc - mu[:, None]), 0.0)
                parts.append((m, p.sum(1), (p * vsc[t]) @ vc[t]))
            big = np.max([m for m, _, _ in parts], 0)
            big = np.where(np.isinf(big), 0.0, big)
            l_sum = sum(l * np.exp2(m - big) for m, l, _ in parts)
            acc = sum(a * np.exp2(m - big)[:, None] for m, _, a in parts)
            o = acc / np.where(l_sum == 0, 1.0, l_sum)[:, None]
            out[b, hk * G:(hk + 1) * G] = o.reshape(G, C, Dq)
    return out


@pytest.mark.parametrize("split_len", [8, 16, 64])
@pytest.mark.parametrize("quant, G, C", [
    (False, 1, 1), (False, 2, 5), (False, 2, 16),
    (True, 1, 5), (True, 2, 1), (True, 1, 16)],
    ids=["f32-G1-C1", "f32-G2-C5", "f32-G2-C16", "int8-G1-C5", "int8-G2-C1",
         "int8-G1-C16"])
def test_p3_split_and_combine_matches_jax_kernel(quant, G, C, split_len):
    """The bf16 body's split over positions and its combine
    (paged_chunked_combine_kernel), emulated in f32 on the cases of
    test_chunked_matches_jax_kernel with the table's 32 positions in 4, 2
    and 1 splits, against the JAX kernel (interpret mode): the combine of
    partial softmaxes is the softmax of the whole range."""
    rng = np.random.default_rng(100 * C + 10 * G + quant)
    k, v, ks, vs = _pools(rng, quant)
    q = rng.standard_normal((B, HKV * G, C, D), dtype=np.float32)
    table = _table(rng)
    lengths = STARTS + C
    layer = 1 if quant else 2
    ref = jax_paged.paged_attention_chunked(
        *(jnp.asarray(a) for a in (q, k, v, table, lengths, STARTS)),
        interpret=True, k_scales=_j(ks), v_scales=_j(vs), layer=layer)
    got = _split_combine(q, k, v, table, lengths, STARTS, layer, ks, vs,
                         split_len)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)
    # the plan's own split length at these shapes: one split of 64
    plan = p3_plan(torch.bfloat16, torch.int8 if quant else torch.bfloat16,
                   B, HKV * G, HKV, C, D, PAGE, MAX_PAGES)
    assert (plan.splits, plan.split_len) == (1, 64)
    assert dataclasses.replace(plan, splits=4, split_len=8).splits == 4
