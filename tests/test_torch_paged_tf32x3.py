"""P3's f32 body (csrc/paged_chunked.cu's paged_chunked_tf32x3_kernel)
emulated in torch on the CPU and held against the JAX package's
``paged_attention_chunked`` in Pallas interpret mode.

The emulation is the kernel's own arithmetic: the blocks of ``p3_plan``
(64 of the G*C rows of one batch row and kv head, the positions of one
split, ``p3_block_positions``), each walking its positions in steps of 32
with the online softmax (base 2, the m == -inf and l == 0 guards); every
product of f32 operands three TF32 products (tests/test_torch_flash_tf32x3's
``split``), int8 pools two (their values are exact in tf32: the small half
of K and V is zero), each group of 32 terms summed from zero and then
added in f32 (S panel by panel of 32 columns of D, P V a step at a time);
the int8 scales on the score and probability columns; the splits' partial
sums (acc, m, l) combined as paged_combine.cuh does. The cases cross head
dims with an instance (32, 80: three 32-column panels, the last half
zeros; 256) and a ragged one (112, in the width-128 instance), f32 and
int8 pools, pages of 1, 7 and 16 (a step of 32 positions crosses pages)
and verify-shaped (G*C = 10 rows, the positions split) and
prefill-shaped (G*C = 80 rows, two row tiles, no split) chunks. f32's
tolerance (atol 2e-5, rtol 1e-4). The JAX results are computed once
(``functools.lru_cache``). On the card the kernel is held to the plain
version by tests/test_torch_cuda.py.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu_torch.ops.paged_attention import (
    p3_block_positions,
    p3_plan,
    paged_width,
    quantize_kv,
)
from test_torch_flash_tf32x3 import LOG2E, PANEL, STEP, mm3, split

jax_paged = importlib.import_module("cubecl_tpu.ops.paged_attention")

F32_TOL = dict(atol=2e-5, rtol=1e-4)
B, HKV, G, L, LAYER = 2, 2, 2, 2, 1
CONTEXT = 200  # positions a table row addresses at least
# (C, starts): the verify step's 5 tokens from 0 and after 150 cached
# positions; a prefill chunk of 40 from 0 and from 130
SHAPES = {"verify": (5, (0, 150)), "prefill": (40, (0, 130))}


def scores(a, b, products):
    """a @ b^T over D, each panel of 32 columns' part summed from zero and
    added in f32."""
    s = None
    for p in range(0, a.shape[-1], PANEL):
        part = mm3(a[..., p:p + PANEL], b[..., p:p + PANEL].T, products)
        s = part if s is None else s + part
    return s


def mm(a, b, products):
    """a @ b over 32 terms or fewer: three TF32 products, or with b exact
    in tf32 (int8 values) the two that its zero small half leaves."""
    if products == 3:
        return mm3(a, b)
    (ab, as_), (bb, bs) = split(a), split(b)
    assert not bs.any()
    return as_ @ bb + ab @ bb


def emu_p3(q, kp, vp, table, lengths, starts, ks=None, vs=None):
    """o (B, H, C, D) of paged_chunked_tf32x3_kernel and, where the plan
    splits the positions, paged_combine_kernel."""
    Bq, H, C, D = q.shape
    _, Hkv, P, page, _ = kp.shape
    Gq = H // Hkv
    quant = ks is not None
    products = 2 if quant else 3
    max_pages = table.shape[1]
    plan = p3_plan(torch.float32, torch.int8 if quant else torch.float32,
                   Bq, H, Hkv, C, D, page, max_pages)
    scale_log2 = np.float32(D ** -0.5 * LOG2E)
    o = torch.zeros_like(q)
    pid = table.clamp(0, P - 1).long()
    for b in range(Bq):
        start, length = int(starts[b]), int(lengths[b])
        for hk in range(Hkv):
            # the row's positions through the table: (positions, D)
            kr = kp[LAYER, hk][pid[b]].reshape(-1, D).float()
            vr = vp[LAYER, hk][pid[b]].reshape(-1, D).float()
            kscale = vscale = None
            if quant:
                kscale = ks[LAYER, hk][pid[b]].reshape(-1)
                vscale = vs[LAYER, hk][pid[b]].reshape(-1)
            qg = q[b, hk * Gq:(hk + 1) * Gq].reshape(Gq * C, D)
            parts = {}
            for x in range(plan.grid[0]):
                r0, r_end, p0, p1 = p3_block_positions(plan, C, Gq, start,
                                                       length, x)
                rows = torch.arange(r0, r_end)
                qpos = start + rows % C
                m = torch.full((len(rows),), -torch.inf)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), D)
                for k0 in range(p0, p1, STEP):
                    t = torch.arange(k0, min(k0 + STEP, p1))
                    s = scores(qg[rows], kr[t], products) * scale_log2
                    if quant:
                        s = s * kscale[t]
                    live = (t[None, :] < length) & (t[None, :] <= qpos[:, None])
                    s = torch.where(live, s, -torch.inf)
                    m_new = torch.maximum(m, s.amax(-1))
                    m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
                    alpha = torch.exp2(m - m_use)
                    p = torch.exp2(s - m_use[:, None])
                    l = l * alpha + p.sum(-1)
                    m = m_new
                    if quant:
                        p = p * vscale[t]
                    acc = acc * alpha[:, None] + mm(p, vr[t], products)
                parts.setdefault(r0, []).append((rows, acc, m, l))
            for splits in parts.values():
                rows = splits[0][0]
                if plan.splits == 1:
                    _, acc, _, l = splits[0]
                else:  # paged_combine_kernel
                    mx = torch.stack([sp[2] for sp in splits]).amax(0)
                    m_use = torch.where(mx == -torch.inf, 0.0, mx)
                    l = torch.zeros(len(rows))
                    acc = torch.zeros(len(rows), D)
                    for _, a, ms, ls in splits:
                        w = torch.exp2(ms - m_use)
                        l = l + ls * w
                        acc = acc + a * w[:, None]
                out = acc / torch.where(l == 0, 1.0, l)[:, None]
                o[b, hk * Gq:(hk + 1) * Gq].view(Gq * C, D)[rows] = out
    return o, plan


@functools.lru_cache(maxsize=None)
def _inputs(D, page):
    """f32 pools, int8 pools with their scales (quantize_kv of the f32
    ones) and a table of a row's pages shuffled over the pool."""
    rng = np.random.default_rng(D * 31 + page)
    max_pages = -(-CONTEXT // page) + 1
    P = B * max_pages + 3
    shape = (L, HKV, P, page, D)
    kp, vp = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    (k8, ks), (v8, vs) = (quantize_kv(torch.from_numpy(x)) for x in (kp, vp))
    table = rng.permutation(P)[:B * max_pages].reshape(B, max_pages)
    return dict(f32=(kp, vp, None, None),
                int8=tuple(t.numpy() for t in (k8, v8, ks, vs)),
                table=table.astype(np.int32))


def _q(D, C):
    return np.random.default_rng(7 * D + C).standard_normal(
        (B, HKV * G, C, D), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_ref(D, kv, page, shape):
    kp, vp, ks, vs = _inputs(D, page)[kv]
    C, starts = SHAPES[shape]
    starts = np.asarray(starts, np.int32)
    args = (_q(D, C), kp, vp, _inputs(D, page)["table"], starts + C, starts)
    ref = jax_paged.paged_attention_chunked(
        *(jnp.asarray(a) for a in args), interpret=True,
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs), layer=LAYER)
    return args, (ks, vs), np.asarray(ref)


# every head dim on both pools and both shapes, the pages in turn
CASES = [(D, kv, (1, 7, 16)[i % 3], shape)
         for i, (D, kv, shape) in enumerate(
             (D, kv, shape) for D in (32, 80, 112, 256)
             for kv in ("f32", "int8") for shape in SHAPES)]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"D{c[0]}-{c[1]}-page{c[2]}-{c[3]}")
def test_p3_tf32x3_emulation_matches_jax(case):
    D, kv, page, shape = case
    args, (ks, vs), ref = _jax_ref(*case)
    got, plan = emu_p3(*(torch.from_numpy(a) for a in args),
                       *(None if x is None else torch.from_numpy(x)
                         for x in (ks, vs)))
    assert plan.body == "tf32x3"
    # the verify step's 10 rows split their positions; the prefill's 80
    # rows are two row tiles, unsplit
    assert (plan.splits > 1) == (shape == "verify")
    assert plan.grid[0] == (plan.splits if shape == "verify" else 2)
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("D", [32, 64, 80, 96, 112, 128, 200, 256])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_p3_tf32x3_plan_fits_the_card(D, quant):
    """The f32 body's plan: one warpgroup, the bf16 body's grid and splits,
    the shared memory of TfSmem at the instance's width in 32-column
    panels (D 80 at 96; 112 and 200 in their ragged widths' 128 and 256):
    two blocks an SM wherever a raw slot leaves room, and under the card's
    232,448 bytes at D 256 with f32 pools."""
    f32 = torch.float32
    plan = p3_plan(f32, torch.int8 if quant else f32, 8, 16, 16, 5, D, 16,
                   40)
    bf16 = p3_plan(torch.bfloat16, torch.int8 if quant else torch.bfloat16,
                   8, 16, 16, 5, D, 16, 40)
    assert (plan.body, plan.threads) == ("tf32x3", 128)
    assert (plan.grid, plan.splits, plan.split_len, plan.scratch) == \
        (bf16.grid, bf16.splits, bf16.split_len, bf16.scratch)
    W = -(-paged_width(D) // 32) * 32
    q_tile, step = 64 * W * 4, 32 * W * 4 * (1 if quant else 2)
    slot = 32 * (W * (1 if quant else 4) + 16) + (128 if quant else 0)
    slots = (plan.smem_bytes - q_tile - step - 1024) / slot
    assert slots == int(slots) and 1 <= slots <= 3
    if not quant and W == 256:
        assert plan.smem_bytes == 231936 <= 232448 and slots == 3
    else:
        assert plan.smem_bytes <= 115712  # two blocks an SM


def test_int8_values_have_no_small_half():
    """int8 pool values (|v| <= 127, seven bits) are exact in tf32: their
    small half is zero, so the int8 body's two products equal three."""
    x = torch.arange(-128, 128, dtype=torch.float32)
    big, small = split(x)
    assert torch.equal(big, x) and not small.any()
