"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip on a host without a CUDA device (as the CPU
test run) and run on the H100 with

    python -m pytest -o addopts="" -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(``-o addopts=""`` drops the JAX package's pytest plugin: the card's host
has no JAX). Tolerances: f32 atol 2e-5 / rtol 1e-4 (summation order only);
bf16 atol 1e-2 / rtol 1e-2, one bf16 rounding (2^-8 relative) of the
output apart. The DSL kernels (K0) are held against the torch evaluator run
on the card, which rounds at the same ops, at the same tolerances.
"""

import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

from cubecl_tpu_torch.frontend import (ABSOLUTE_POS, CUBE_POS_X, UNIT_POS,
                                       ArrayArg, MutSlice, SharedMemory,
                                       Slice, cube, sync_cube)
from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.ops import functional as F
from cubecl_tpu_torch.ops import gelu as G
from cubecl_tpu_torch.ops import normalization as N
from cubecl_tpu_torch.ir.types import i32
from cubecl_tpu_torch.runtime import CudaRuntime, eval_client
from cubecl_tpu_torch.models import transformer
from cubecl_tpu_torch.ops import attention as fa
from cubecl_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_plain,
)
from cubecl_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_chunked,
    paged_attention_chunked_plain,
    paged_attention_plain,
    quantize_kv,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2),
       # one f16 rounding (2^-11 relative) of sums of order 1
       torch.float16: (1e-3, 1e-3)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    atol, rtol = TOL[ref.dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol)


# The flash backward kernels against the exact plain backward (f32 inputs
# as float64 copies, ``_plain_bwd``): bf16
# rounds p and dS for their products as the JAX kernels do, and that
# rounding alone can pass TOL (dv under GQA, where a kv head sums several
# heads' rounded p). This bound sits above the largest atol that
# chip_smoke.py's phase-d sweep reads at rtol 1e-2; f32 rounds nothing.
EXACT_BWD_TOL = {torch.float32: TOL[torch.float32],
                 torch.bfloat16: (2e-2, 1e-2)}


def _plain_bwd(q, k, v, o, lse, do, *args, **kw):
    """``flash_attention_backward_plain`` as the kernels' reference: f32
    inputs go in as float64 copies (exact where a kv head's gradient sums
    many terms, which f32's own rounding is not) and the grads come back
    in f32; other dtypes as they are."""
    if q.dtype != torch.float32:
        return fa.flash_attention_backward_plain(q, k, v, o, lse, do, *args,
                                                 **kw)
    grads = fa.flash_attention_backward_plain(
        *(t.double() for t in (q, k, v, o, lse, do)), *args, **kw)
    return tuple(g.float() for g in grads)


def _close_bwd(got, rounded, exact):
    """A gradient of the flash backward kernels: within TOL of the plain
    backward that rounds p and dS as the kernels do (``round_p_ds=True``),
    and within EXACT_BWD_TOL of the exact one."""
    _close(got, rounded)
    atol, rtol = EXACT_BWD_TOL[exact.dtype]
    torch.testing.assert_close(got.float(), exact.float(), atol=atol,
                               rtol=rtol)


# sequence lengths around the kernels' 64-row tiles (the bf16 body's
# 128-row blocks, TMA's zero-filled rows past S), a ragged one and the
# training length
FLASH_S = [1, 63, 64, 65, 77, 127, 128, 200, 1021]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", FLASH_S)
def test_flash_kernel_matches_plain(dev, dtype, D, causal, S):
    """o, and the forward's lse, against the plain version: bf16 runs the
    tensor-core body (P rounded to bf16, inside the bf16 tolerance), f32
    the CUDA-core one."""
    g = torch.Generator(device=dev).manual_seed(S + D)
    q = torch.randn(2, 6, S, D, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 2, S, D, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 2, S, D, generator=g, device=dev).to(dtype)
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    _close(got, flash_attention_plain(q, k, v, causal))
    o, lse = fa._flash_forward(q, k, v, causal, None, True)
    assert torch.equal(o, got)
    _, lse_ref = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv", [(200, 200), (40, 72), (100, 37),
                                    (130, 300)])
def test_flash_kernel_gqa_and_cross_lengths(dev, dtype, D, G, causal, Sq,
                                            Skv):
    """Flash's GQA groups of 1, 2 and 8 query heads a kv head (A1 reads kv
    head h // G for any G; P1's and P3's groups past 8 are the grouped
    paged tests'), and Sq != Skv (causal: col <= row in absolute
    positions): o and lse against plain."""
    g = torch.Generator(device=dev).manual_seed(Sq * Skv + G)
    q = torch.randn(2, 8, Sq, D, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 8 // G, Skv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 8 // G, Skv, D, generator=g, device=dev).to(dtype)
    n = flash_attention.launches
    o, lse = fa._flash_forward(q, k, v, causal, None, True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, return_lse=True)
    _close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=1e-4)


def test_flash_f32_runs_the_tf32x3_body(dev):
    """The f32 instances are the 3xTF32 body (csrc/flash_tf32.cuh: three
    TF32 wgmma products a k8 step, where one TF32 product keeps about three
    decimal digits): causal S 200 holds f32's tolerance, o and lse."""
    g = torch.Generator(device=dev).manual_seed(200)
    q = torch.randn(2, 6, 200, 128, generator=g, device=dev)
    k = torch.randn(2, 2, 200, 128, generator=g, device=dev)
    v = torch.randn(2, 2, 200, 128, generator=g, device=dev)
    n = flash_attention.launches
    o, lse = fa._flash_forward(q, k, v, True, None, True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    o_ref, lse_ref = flash_attention_plain(q, k, v, True, return_lse=True)
    torch.testing.assert_close(o, o_ref, atol=TOL[torch.float32][0],
                               rtol=TOL[torch.float32][1])
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=1e-4)


# -- the f32 forward and dK/dV as three TF32 products (csrc/flash_tf32.cuh)
# held to the exact plain forward and backward at f32's tolerance: every
# head dim the kernels are built at and the padded ones, the dense, masked
# and block-sparse schedules, GQA groups of 1, 3 and 8 at S 1021, many
# launches of one input, and q and k of a larger magnitude

TF32X3_GROUPS = {1: (8, 8), 3: (6, 2), 8: (8, 1)}  # G: (H, Hkv)


def _tf32x3_inputs(dev, seed, H, Hkv, S, D, qk_scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(2, H, S, D, generator=g, device=dev)
             for _ in range(2))
    k, v = (torch.randn(2, Hkv, S, D, generator=g, device=dev)
            for _ in range(2))
    return q * qk_scale, k * qk_scale, v, do


def _tf32x3_run(q, k, v, do, causal, mask=None):
    """A1's forward (o, lse) and A3's dK/dV on the f32 inputs at their head
    dim, padded with zeros to the kernels' (the scale from the real D),
    dense or masked: o, lse, dk, dv sliced back to D."""
    D = q.shape[-1]
    Dp = next(d for d in fa.KERNEL_HEAD_DIMS if D <= d)
    qp, kp, vp, dop = (torch.nn.functional.pad(t, (0, Dp - D))
                       for t in (q, k, v, do))
    scale = D ** -0.5
    if mask is None:
        o, lse = fa._flash_forward(qp, kp, vp, causal, scale, True)
    else:
        o, lse = fa.masked_forward(qp, kp, vp, mask, causal, scale, True)
    di = (dop * o).sum(-1)
    if mask is None:
        dk, dv = fa.flash_bwd_dkv(qp, kp, vp, dop, lse, di, causal, scale)
    else:
        dk, dv = fa.masked_dkv(qp, kp, vp, dop, lse, di, mask, causal, scale)
    return o[..., :D], lse, dk[..., :D], dv[..., :D]


def _tf32x3_check(q, k, v, do, causal, got, opts=None):
    """o, lse, dk and dv against the exact plain versions at f32's
    tolerance (the backward on the kernel's own o and lse)."""
    opts = opts or {}
    o, lse, dk, dv = got
    scale = q.shape[-1] ** -0.5
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, scale,
                                           return_lse=True, **opts)
    _close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=1e-4)
    _, dk_ref, dv_ref = _plain_bwd(q, k, v, o, lse, do, causal, scale,
                                   **opts)
    _close(dk, dk_ref)
    _close(dv, dv_ref)


@pytest.mark.parametrize("D", [64, 128, 256, 80, 96, 192])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_flash_tf32x3_dense_matches_plain(dev, D, causal, G):
    """The dense schedule at S 1021 (a ragged last tile and step), kv
    groups of 1, 3 and 8 query heads, D 64, 128, 256 and padded from 80,
    96 and 192; one launch each of the forward and dK/dV."""
    H, Hkv = TF32X3_GROUPS[G]
    q, k, v, do = _tf32x3_inputs(dev, D + G + causal, H, Hkv, 1021, D)
    n = (flash_attention.launches, fa.flash_bwd_dkv.launches)
    got = _tf32x3_run(q, k, v, do, causal)
    torch.cuda.synchronize()
    assert (flash_attention.launches, fa.flash_bwd_dkv.launches) == \
        (n[0] + 1, n[1] + 1)
    _tf32x3_check(q, k, v, do, causal, got)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("option", ["kv_len", "window", "segments"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tf32x3_masked_matches_plain(dev, D, option, causal):
    """The masked schedule (A1's and A3's options) at S 1021, 3 query heads
    a kv head: keys past kv_len 900, a band of 300 (and 100 to the right
    when not causal), packed documents of 20 to 90 rows (a tile's rows in
    several); one launch each."""
    q, k, v, do = _tf32x3_inputs(dev, D + len(option) + causal, 6, 2, 1021,
                                 D)
    g = torch.Generator(device=dev).manual_seed(D)
    opts = {"kv_len": dict(kv_len=900),
            "window": dict(window=(300, 0 if causal else 100)),
            "segments": dict(seg=(_doc_ids(g, dev, 2, 1021),) * 2)}[option]
    mask = fa._Mask.of(q, k, **opts)
    n = (fa.masked_forward.launches, fa.masked_dkv.launches)
    got = _tf32x3_run(q, k, v, do, causal, mask)
    torch.cuda.synchronize()
    assert (fa.masked_forward.launches, fa.masked_dkv.launches) == \
        (n[0] + 1, n[1] + 1)
    _tf32x3_check(q, k, v, do, causal, got, mask.plain())


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk,mask", [(128, 64, "f9"), (64, 64, "holed")],
                         ids=["f9_128x64", "holed64"])
def test_flash_tf32x3_block_sparse_matches_plain(dev, D, causal, bq, bk,
                                                 mask):
    """The block-sparse schedules at S 1024 (A5 and A7 in f32): F9's rows
    (bq 128 > bk 64, q tile 0 attends kv tile 1 only: p = 1/n for dV) and
    a kv tile nobody attends (dk = dv = 0 exactly)."""
    S = 1024
    g = torch.Generator(device=dev).manual_seed(D + bq + causal)
    q, k, v, do = (torch.randn(2, 3, S, D, generator=g, device=dev)
                   for _ in range(4))
    bm = {"f9": _f9_mask, "holed": _holed_mask}[mask](S // bq, S // bk)
    pruned = fa._pruned_mask(bm, causal, bq, bk, S // bq, S // bk)
    sched = fa._schedule(pruned, bq, bk, dev)
    scale = D ** -0.5
    n = (fa.bsp_forward.launches, fa.bsp_dkv.launches)
    o, lse = fa.bsp_forward(q, k, v, sched, causal, scale, bq, bk, True)
    di = (do * o).sum(-1)
    dk, dv = fa.bsp_dkv(q, k, v, do, lse, di, sched, causal, scale, bq, bk)
    torch.cuda.synchronize()
    assert (fa.bsp_forward.launches, fa.bsp_dkv.launches) == \
        (n[0] + 1, n[1] + 1)
    o_ref, lse_ref = fa.flash_attention_block_sparse_plain(
        q, k, v, bm, causal, None, bq, bk, return_lse=True)
    _close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=1e-4)
    _, dk_ref, dv_ref = fa.flash_attention_block_sparse_backward_plain(
        q, k, v, o, lse, do, bm, causal, None, bq, bk)
    _close(dk, dk_ref)
    _close(dv, dv_ref)
    for ki in np.nonzero(~pruned.any(0))[0]:
        assert not dk[:, :, ki * bk:(ki + 1) * bk].any()
        assert not dv[:, :, ki * bk:(ki + 1) * bk].any()


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("schedule", ["dense", "masked"])
def test_flash_tf32x3_every_launch_of_many_agrees(dev, D, schedule):
    """200 launches each of the f32 forward and dK/dV on one input (causal
    S 1021, 3 query heads a kv head; masked: a band of 300) give the first
    launch's outputs bit for bit, which hold the plain versions: a race
    shows in a few launches of many, not in one."""
    q, k, v, do = _tf32x3_inputs(dev, D, 6, 2, 1021, D)
    opts = {} if schedule == "dense" else dict(window=(300, 0))
    mask = fa._Mask.of(q, k, **opts) if opts else None
    first = _tf32x3_run(q, k, v, do, True, mask)
    _tf32x3_check(q, k, v, do, True, first, opts)
    differ = 0
    for _ in range(200):
        again = _tf32x3_run(q, k, v, do, True, mask)
        differ += not all(torch.equal(a, b) for a, b in zip(again, first))
    assert differ == 0, f"{differ} of 200 launches differ"


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 8])
def test_flash_tf32x3_large_magnitude_holds_f32(dev, D, G):
    """q and k of N(0, 4) entries (scores 4 times the unit case's, a
    softmax that magnifies an error of the scores as much): the 3xTF32
    forward and dK/dV still hold f32's tolerance against the exact plain
    versions (the backward's in float64), where one TF32 product misses
    it at any magnitude (tests/test_torch_flash_tf32x3.py)."""
    H, Hkv = TF32X3_GROUPS[G]
    q, k, v, do = _tf32x3_inputs(dev, 3 * D + G, H, Hkv, 512, D, 2.0)
    _tf32x3_check(q, k, v, do, True, _tf32x3_run(q, k, v, do, True))


# P1's table layouts: (B or None for the test's own, page, max_pages,
# lengths): the first test's batch (a few splits of one tile), one and two
# rows at context 4096 (tens of splits), and ragged lengths around a tile
# on pages of 128 and of 16
P1_LAYOUTS = {
    "page16": (None, 16, 5, [0, 1, 15, 16, 17, 80]),
    "B1-ctx4096": (1, 128, 32, [4096]),
    "B2-ctx4096-page16": (2, 16, 256, [4096, 4001]),
    "ragged-page128": (8, 128, 2, [0, 1, 63, 64, 65, 127, 128, 129]),
    "ragged-page16": (8, 16, 16, [0, 1, 63, 64, 65, 127, 128, 129]),
}


def _p1_table(g, dev, layout, B):
    """(B, page, max_pages, P, table, lengths) of a P1 layout."""
    b, page, max_pages, lengths = P1_LAYOUTS[layout]
    B = b or B
    lengths = lengths[:B]
    P = B * max_pages + 3
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages]
    table = table.view(B, max_pages).to(torch.int32)
    return (B, page, max_pages, P, table,
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("layout", list(P1_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_paged_kernel_matches_plain(dev, dtype, D, G, layout):
    """P1 against its plain version on each of P1_LAYOUTS: the positions
    split over blocks as p1_plan says (many splits at B 1 and 2) and the
    splits combined, a length-0 row's zeros."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(G * D + len(layout))
    Hkv, L = 2, 3
    B, page, max_pages, P, table, lengths = _p1_table(g, dev, layout, 6)
    plan = pa.p1_plan(dtype, dtype, B, Hkv * G, Hkv, D, page, max_pages)
    assert plan.splits > (8 if layout.endswith("ctx4096") else 1)
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(dtype)
    kp = torch.randn(L, Hkv, P, page, D, generator=g, device=dev).to(dtype)
    vp = torch.randn(L, Hkv, P, page, D, generator=g, device=dev).to(dtype)
    n = paged_attention.launches
    got = paged_attention(q, kp, vp, table, lengths, layer=2)
    torch.cuda.synchronize()
    assert paged_attention.launches == n + 1
    _close(got, paged_attention_plain(q, kp, vp, table, lengths, layer=2))
    if 0 in lengths.tolist():
        assert not got[lengths.tolist().index(0)].any()


def test_generate_kernels_match_plain(dev):
    cfg = llama.LlamaConfig(vocab=128, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512,
                            use_framework_kernels=False)
    model = llama.init_params(cfg, seed=0, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 70), dtype=np.int32)).to(dev)
    got = llama.generate(model, prompt, 8, max_pages=3, page=32)
    ref = llama.generate(model, prompt, 8, max_pages=3, page=32,
                         kernels=False)
    assert torch.equal(got, ref)


def _dsl_launches(client, dev, dtype):
    """The slice's DSL launches on one client; returns their outputs."""
    g = torch.Generator(device=dev).manual_seed(3)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = {}
    x = rn(1000)
    o = client.create(torch.zeros_like(x))
    G.launch_gelu(client, client.create(x), o, checked=True)
    out["gelu checked"] = o.tensor
    hc = client.create(x)  # one tensor as both buffers: no __restrict__
    G.launch_gelu(client, hc, hc, checked=True)
    out["gelu checked in place"] = hc.tensor
    hx = client.create(rn(1 << 14))
    o = client.create(torch.zeros_like(hx.tensor))
    G.launch_gelu(client, hx, o)
    out["gelu exact"] = o.tensor
    G.launch_gelu(client, hx, hx)
    out["gelu in place"] = hx.tensor
    for rows, row in ((4, 1024), (64, 512)):
        hx = client.create(rn(rows, row))
        gb = [client.create(rn(row)) for _ in range(2)]
        for name in ("softmax", "normalize", "layernorm"):
            o = client.create(torch.zeros_like(hx.tensor))
            if name == "softmax":
                N.launch_softmax(client, hx, o, rows, row)
            elif name == "normalize":
                N.launch_normalize(client, hx, o, rows, row, eps=1e-6)
            else:
                N.launch_layernorm(client, hx, *gb, o, rows, row)
            out[f"{name} {rows}x{row}"] = o.tensor
        N.launch_softmax(client, hx, hx, rows, row)
        out[f"softmax in place {rows}x{row}"] = hx.tensor
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dsl_kernels_match_evaluator(dev, dtype):
    """Every gelu / normalization path, printed and built by K0, against
    the torch evaluator on the same card and inputs."""
    cu = CudaRuntime.client()
    n = cu.server.launch_count
    got = _dsl_launches(cu, dev, dtype)
    assert cu.server.launch_count == n + len(got)
    want = _dsl_launches(eval_client(dev), dev, dtype)
    torch.cuda.synchronize()
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["gelu", "softmax", "layernorm", "rmsnorm"])
def test_functional_kernels_match_evaluator(dev, op, dtype):
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(64, 512, generator=g, device=dev).to(dtype)
    w = torch.randn(512, generator=g, device=dev).to(dtype)
    args = {"gelu": (x,), "softmax": (x,), "layernorm": (x, w, w),
            "rmsnorm": (x, w)}[op]
    server = CudaRuntime.client().server
    n = server.launches[f"_{op}_fwd_k"]
    got = getattr(F, op)(*args)
    torch.cuda.synchronize()
    assert server.launches[f"_{op}_fwd_k"] == n + 1
    cpu = getattr(F, op)(*(a.cpu() for a in args))  # the torch evaluator
    _close(got.cpu(), cpu)


def test_generate_framework_kernels_match_plain(dev):
    """use_framework_kernels=True: RMSNorm on K0, f32, greedy tokens equal
    to the plain route's, 2L+1 K0 launches per step."""
    cfg = llama.LlamaConfig(vocab=128, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512)
    model = llama.init_params(cfg, seed=0, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 64), dtype=np.int32)).to(dev)
    server = CudaRuntime.client().server
    n = server.launches["_rmsnorm_fwd_k"]
    got = llama.generate(model, prompt, 6, max_pages=3, page=32)
    assert server.launches["_rmsnorm_fwd_k"] == n + 7 * (2 * cfg.n_layers + 1)
    ref = llama.generate(model, prompt, 6, max_pages=3, page=32,
                         kernels=False)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", FLASH_S)
def test_flash_backward_kernels_match_plain(dev, dtype, D, causal, S):
    """dq, dk, dv of the autograd Function (forward kernel with lse, dK/dV
    and dQ kernels) against flash_attention_backward_plain on the kernel's
    own o and lse, by ``_close_bwd`` (bf16: the kernels round p and dS as
    the JAX kernels do); the lse against the plain logsumexp."""
    g = torch.Generator(device=dev).manual_seed(S * D + causal)
    q, do = (torch.randn(2, 6, S, D, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 2, S, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    o = flash_attention(*leaves, causal)
    o.backward(do)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == \
        (n[0] + 1, n[1] + 1)
    o2, lse = fa._flash_forward(q, k, v, causal, None, True)
    assert torch.equal(o2, o.detach())
    _, lse_ref = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=1e-4)
    rounded = _plain_bwd(q, k, v, o2, lse, do, causal, round_p_ds=True)
    exact = _plain_bwd(q, k, v, o2, lse, do, causal)
    for t, r, e in zip(leaves, rounded, exact):
        _close_bwd(t.grad, r, e)


def _bwd_bf16_inputs(dev, seed, H, Hkv, Sq, Skv, D):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(2, H, Sq, D, generator=g, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(2, Hkv, Skv, D, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


def _bwd_kernels_vs_plain(q, k, v, do, causal):
    """dq, dk, dv of the bf16 dK/dV and dQ kernels (one launch each, on the
    forward kernel's o and lse), held by ``_close_bwd`` against the plain
    backward that rounds p and dS to bf16 as the JAX kernels do and the
    exact f32 one; a second call is bit-identical (no atomics)."""
    o, lse = fa._flash_forward(q, k, v, causal, None, True)
    di = (do.float() * o.float()).sum(-1)
    n = (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, di, causal)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == \
        (n[0] + 1, n[1] + 1)
    rounded = _plain_bwd(q, k, v, o, lse, do, causal, round_p_ds=True)
    exact = _plain_bwd(q, k, v, o, lse, do, causal)
    for t, r, e in zip((dq, dk, dv), rounded, exact):
        _close_bwd(t, r, e)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, di, causal)
    dq2 = fa.flash_bwd_dq(q, k, v, do, lse, di, causal)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("S", FLASH_S)
def test_flash_backward_bf16_kernels_round_as_jax(dev, D, causal, G, S):
    """The tensor-core bodies of A3 and A4 at every FLASH_S and flash's
    GQA groups of 1, 2 and 8 query heads a kv head (any G divides the
    heads the same way; P1's and P3's groups past 8 are the grouped paged
    tests'); D 256 runs the wide bodies (one 64-row tile a block)."""
    _bwd_kernels_vs_plain(*_bwd_bf16_inputs(dev, S * G + D, 8, 8 // G, S,
                                            S, D), causal)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv", [(40, 72), (100, 37), (130, 300),
                                    (1, 200), (200, 1)])
def test_flash_backward_bf16_kernels_cross_lengths(dev, D, causal, Sq, Skv):
    """Sq != Skv (causal: col <= row in absolute positions; kv tiles no
    query sees get zero dk, dv)."""
    _bwd_kernels_vs_plain(*_bwd_bf16_inputs(dev, Sq * Skv + D, 4, 2, Sq,
                                            Skv, D), causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["gelu", "softmax", "layernorm", "rmsnorm"])
def test_functional_backward_kernels_match_evaluator(dev, op, dtype):
    """dx of each op's backward kernel against the torch evaluator on the
    card; dg, db (plain reductions) against the same."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(64, 512, generator=g, device=dev).to(dtype)
    w = torch.randn(512, generator=g, device=dev).to(dtype)
    dy = torch.randn(64, 512, generator=g, device=dev).to(dtype)
    args = {"gelu": (x,), "softmax": (x,), "layernorm": (x, w, w),
            "rmsnorm": (x, w)}[op]
    server = CudaRuntime.client().server
    n = server.launches[f"_{op}_bwd_k"]
    leaves = [a.clone().requires_grad_() for a in args]
    getattr(F, op)(*leaves).backward(dy)
    torch.cuda.synchronize()
    assert server.launches[f"_{op}_bwd_k"] == n + 1
    ev = [a.clone().requires_grad_() for a in args]
    getattr(F, op)(*ev, client=eval_client(dev)).backward(dy)
    for t, r in zip(leaves, ev):
        _close(t.grad, r.grad)


def test_train_step_kernels_match_plain(dev):
    """One llama and one transformer SGD step, f32, with the kernels and
    with their plain versions from the same weights: loss, every gradient
    and the updated weights."""
    for mod, cfg, shape in (
            (llama, llama.LlamaConfig(vocab=128, d_model=256, n_heads=4,
                                      n_kv_heads=2, n_layers=2, d_ff=512,
                                      seq=129), (4, 129)),
            (transformer, transformer.TransformerConfig(
                vocab=128, d_model=256, n_heads=2, n_layers=2, d_ff=512,
                seq=129), (4, 129))):
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, shape, dtype=np.int32)).to(dev)
        models = []
        for kernels in (True, False):
            model = mod.init_params(cfg, seed=0, device=dev)
            loss = mod.make_train_step(cfg, 1e-2, kernels=kernels)(model,
                                                                  tokens)
            models.append((loss, model))
        (lk, mk), (lp, mp) = models
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=0)
        for (name, a), b in zip(mk.named_parameters(), mp.parameters()):
            tol = 1e-4 * b.grad.abs().max().item()
            assert (a.grad - b.grad).abs().max().item() <= tol, name
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _int8_pools(g, dev, shape):
    """int8 pools and their f32 scales, from N(0, 1) pools."""
    kq, ks = quantize_kv(torch.randn(shape, generator=g, device=dev))
    vq, vs = quantize_kv(torch.randn(shape, generator=g, device=dev))
    return kq, vq, ks, vs


@pytest.mark.parametrize("layout", list(P1_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 2, 2, 64), (3, 4, 8, 128),
                                   (5, 2, 1, 96), (4, 2, 4, 96),
                                   (5, 2, 1, 80), (4, 2, 4, 80),
                                   (6, 2, 2, 32), (3, 4, 8, 32)],
                         ids=["B6-Hkv2-G2-D64", "B3-Hkv4-G8-D128",
                              "B5-Hkv2-G1-D96", "B4-Hkv2-G4-D96",
                              "B5-Hkv2-G1-D80", "B4-Hkv2-G4-D80",
                              "B6-Hkv2-G2-D32", "B3-Hkv4-G8-D32"])
def test_paged_int8_kernel_matches_plain(dev, dtype, shape, layout):
    """P1 on int8 pools: lengths 0, 1, mid-page, a page boundary and past
    it, and the other P1_LAYOUTS (splits over positions, each position's
    scales copied with its rows), against the plain version on the same
    int8 pools and scales."""
    B, Hkv, G, D = shape
    g = torch.Generator(device=dev).manual_seed(B * D + len(layout))
    L = 3
    B, page, max_pages, P, table, lengths = _p1_table(g, dev, layout, B)
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(dtype)
    kq, vq, ks, vs = _int8_pools(g, dev, (L, Hkv, P, page, D))
    n = (paged_attention.launches, paged_attention.int8_launches)
    got = paged_attention(q, kq, vq, table, lengths, layer=1, k_scales=ks,
                          v_scales=vs)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.int8_launches) == \
        (n[0] + 1, n[1] + 1)
    _close(got, paged_attention_plain(q, kq, vq, table, lengths, layer=1,
                                      k_scales=ks, v_scales=vs))
    if 0 in lengths.tolist():
        assert not got[lengths.tolist().index(0)].any()


# P1 at chip_smoke.py's shapes (phases 4, j, 6: B, Hkv, G, D, max_pages,
# lengths, q dtype, int8 pools), page 128: the serving decode (4 splits of
# 17 tiles), its int8 form, the KV-bound decode (2 splits of 16), a
# ragged batch with a length-0 row, the d768 f32 model (G 3, D 64)
P1_REPEAT_CASES = {
    "serving bf16": (8, 8, 2, 128, 9, [1056] * 8, torch.bfloat16, False),
    "serving int8": (8, 8, 2, 128, 9, [1056] * 8, torch.bfloat16, True),
    "KV-bound bf16": (16, 8, 2, 128, 16, [2048] * 16, torch.bfloat16, False),
    "ragged int8": (8, 8, 2, 128, 8, [0, 1, 127, 128, 129, 1000, 640, 1024],
                    torch.bfloat16, True),
    "d768 f32": (16, 4, 3, 64, 4, [400] * 16, torch.float32, False),
    # phase zb's Phi-3-mini decode: 32 kv heads of one query head, D 96
    "phi3 bf16": (8, 32, 1, 96, 9, [1056] * 8, torch.bfloat16, False),
    "phi3 int8": (8, 32, 1, 96, 9, [1056] * 8, torch.bfloat16, True),
    # phase zc's row groups: Mistral-Large-2's decode (G 12: 2 groups of 6
    # rows), Falcon-7B's multi-query G 71 (9 groups, 3 splits)
    "mistral-large-2 bf16": (8, 8, 12, 128, 9, [1056] * 8, torch.bfloat16,
                             False),
    "falcon G71 int8": (8, 1, 71, 64, 16, [2048] * 8, torch.bfloat16, True),
    # phase zf's decodes: Phi-2 (D 80, 32 kv heads of one query head),
    # H2O-Danube (D 80, G 4), D 32 at B 8 x 16 heads
    "phi-2 bf16": (8, 32, 1, 80, 9, [1056] * 8, torch.bfloat16, False),
    "phi-2 int8": (8, 32, 1, 80, 9, [1056] * 8, torch.bfloat16, True),
    "danube G4 f32": (8, 8, 4, 80, 32, [4096] * 8, torch.float32, False),
    "D32 bf16": (8, 16, 1, 32, 16, [2048] * 8, torch.bfloat16, False),
    "D32 int8": (8, 16, 1, 32, 16, [2048] * 8, torch.bfloat16, True),
}
P1_LAUNCHES = 200


@pytest.mark.parametrize("case", list(P1_REPEAT_CASES))
def test_paged_every_launch_of_many_agrees(dev, case):
    """P1 at phase 4/j/6's shapes: a race in a warp's cp.async ring (a
    stage refilled before every lane read it, a copy read before it
    landed), in the block's combine of its warps or in the splits'
    partial sums shows in a few launches of many, not in one. The first
    launch within TOL of plain, each of P1_LAUNCHES launches equal to it
    bit for bit (the kernel's sums run in one order)."""
    B, Hkv, G, D, max_pages, lengths, dt, quant = P1_REPEAT_CASES[case]
    g = torch.Generator(device=dev).manual_seed(len(case))
    L, page = 2, 128
    P = B * max_pages + 5
    shape = (L, Hkv, P, page, D)
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(dt)
    if quant:
        kp, vp, ks, vs = _int8_pools(g, dev, shape)
    else:
        kp, vp = (torch.randn(shape, generator=g, device=dev).to(dt)
                  for _ in range(2))
        ks = vs = None
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages]
    table = table.view(B, max_pages).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    first = paged_attention(q, kp, vp, table, ln, layer=1, k_scales=ks,
                            v_scales=vs)
    _close(first, paged_attention_plain(q, kp, vp, table, ln, layer=1,
                                        k_scales=ks, v_scales=vs))
    bad = torch.zeros(P1_LAUNCHES, dtype=torch.int64, device=dev)
    for i in range(P1_LAUNCHES):
        got = paged_attention(q, kp, vp, table, ln, layer=1, k_scales=ks,
                              v_scales=vs)
        bad[i] = (got != first).sum()
    bad = bad.cpu()
    assert not bad.any(), (f"{int((bad > 0).sum())} of {P1_LAUNCHES} "
                           f"launches differ, {int(bad.sum())} elements")


def test_paged_kernel_plan_matches_the_kernel(dev):
    """The launch plans ops/paged_attention.py sizes P1's scratch with
    (p1_plan) are the built kernel's (csrc/paged_attention.cu's
    cubecl_paged_decode_plan), per q dtype, pool dtype, shape and options
    (window, sinks, ring)."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    for dt in (torch.float32, torch.bfloat16):
        for kv in (dt, torch.int8):
            for B, H, Hkv, D, page, max_pages in [
                    (8, 16, 8, 128, 128, 9), (16, 16, 8, 128, 128, 16),
                    (16, 12, 4, 64, 128, 4), (1, 8, 1, 128, 16, 256),
                    (2, 16, 8, 128, 16, 256), (6, 6, 2, 128, 7, 21),
                    (40, 16, 8, 64, 16, 8), (300, 16, 8, 128, 128, 9),
                    (3, 32, 4, 64, 1, 5), (8, 16, 8, 128, 128, 33),
                    (8, 16, 8, 128, 16, 17), (8, 32, 32, 96, 128, 9),
                    (1, 32, 32, 96, 128, 33), (5, 8, 2, 96, 7, 21),
                    (2, 16, 2, 96, 16, 256), (8, 32, 32, 80, 128, 9),
                    (8, 32, 8, 80, 128, 32), (1, 32, 32, 80, 128, 33),
                    (5, 8, 2, 80, 7, 21), (2, 16, 2, 80, 16, 256),
                    (8, 16, 16, 32, 128, 16), (8, 8, 8, 32, 128, 9),
                    (5, 8, 2, 32, 7, 21), (1, 8, 1, 32, 16, 256),
                    (3, 6, 3, 32, 1, 300)]:
                for opts in [(0, 0, False), (2000, 4, False),
                             (240, 16, False), (1, 0, False),
                             (7, 130, False), (0, 9, False),
                             (240, 16, True), (0, 0, True)]:
                    args = (dt, kv, B, H, Hkv, D, page, max_pages, *opts)
                    assert pa.p1_kernel_plan(*args) == pa.p1_plan(*args), \
                        args


# P1's StreamingLLM layouts: (B, Hkv, page, max_pages, lengths, window,
# sinks). A row at context 4160 in 33 splits with its window starting
# inside a tile (the streaming phase's, one row); pages of 16 with sinks
# and a window that end and start inside tiles; 40 rows x 8 kv heads, one
# split
P1_WINDOWED = {
    "B1-ctx4160-w2000-s4": (1, 2, 128, 33, [4160], 2000, 4),
    "B3-page16-w100-s20": (3, 2, 16, 64, [1000, 37, 0], 100, 20),
    "B40-one-split": (40, 8, 128, 4, [5 + 12 * b for b in range(40)], 256,
                      4),
}
# P1's ring layouts: (B, Hkv, page, max_pages, lengths, window, sinks), the
# streaming phase's ring (sinks 16, window 240, 17 pages of 16)
P1_RINGS = {
    "B1-many-splits": (1, 2, 16, 17, [1000], 240, 16),
    "B4": (4, 2, 16, 17, [0, 100, 272, 999], 240, 16),
    "B40-one-split": (40, 8, 16, 17, [7 * b for b in range(40)], 240, 16),
}


def _stream_pools(g, dev, dtype, quant, B, Hkv, G, D, page, max_pages):
    L = 2
    P = B * max_pages + 3
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(dtype)
    if quant:
        kp, vp, ks, vs = _int8_pools(g, dev, (L, Hkv, P, page, D))
    else:
        kp, vp = (torch.randn(L, Hkv, P, page, D, generator=g,
                              device=dev).to(dtype) for _ in range(2))
        ks = vs = None
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages]
    return q, kp, vp, ks, vs, table.view(B, max_pages).to(torch.int32)


def _ring_meta(table, lengths, page, sinks):
    """pos_meta (P, page) of a ring that decoded each row token by token:
    position t at table order t below the sinks, else at sinks + (t -
    sinks) % (capacity - sinks); -1 where nothing came."""
    tab = table.cpu().numpy()
    cap = tab.shape[1] * page
    meta = np.full((int(tab.max()) + 4, page), -1, np.int32)
    for b, n in enumerate(lengths):
        for t in range(n):
            j = t if t < sinks else sinks + (t - sinks) % (cap - sinks)
            meta[tab[b, j // page], j % page] = t
    return meta


@pytest.mark.parametrize("layout", list(P1_WINDOWED))
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
def test_paged_window_kernel_matches_plain(dev, D, dtype, quant, layout):
    """P1 with window + sinks (paged_window_kernel) against its plain
    version: its live tiles split over blocks (one split at 40 rows x 8
    kv heads), windows and sinks that start and end inside tiles, a
    length-0 row's zeros; one launch, counted among the windowed ones."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    B, Hkv, page, max_pages, lengths, window, sinks = P1_WINDOWED[layout]
    g = torch.Generator(device=dev).manual_seed(D + len(layout))
    q, kp, vp, ks, vs, table = _stream_pools(g, dev, dtype, quant, B, Hkv,
                                             2, D, page, max_pages)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    plan = pa.p1_plan(dtype, kp.dtype, B, Hkv * 2, Hkv, D, page, max_pages,
                      window, sinks)
    assert plan.mode == pa.P1_WINDOW
    assert (plan.splits == 1) == (B == 40)
    n = (paged_attention.launches, paged_attention.window_launches,
         paged_attention.ring_launches)
    kw = dict(layer=1, k_scales=ks, v_scales=vs, window=window, sinks=sinks)
    got = paged_attention(q, kp, vp, table, ln, **kw)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.window_launches,
            paged_attention.ring_launches) == (n[0] + 1, n[1] + 1, n[2])
    _close(got, paged_attention_plain(q, kp, vp, table, ln, **kw))
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


@pytest.mark.parametrize("layout", list(P1_RINGS))
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 80, 96, 128])
def test_paged_ring_kernel_matches_plain(dev, D, dtype, quant, layout):
    """P1 on a ring (paged_ring_kernel) against its plain version: slots
    recycled past the capacity, slots never written (-1), a row whose meta
    is all stale (zeros) and a length-0 row; one launch, counted among the
    ring's."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    B, Hkv, page, max_pages, lengths, window, sinks = P1_RINGS[layout]
    g = torch.Generator(device=dev).manual_seed(D + 3 * len(layout))
    q, kp, vp, ks, vs, table = _stream_pools(g, dev, dtype, quant, B, Hkv,
                                             2, D, page, max_pages)
    meta = _ring_meta(table, lengths, page, sinks)[:kp.shape[2]]
    stale = lengths.index(max(lengths))
    if B > 1:   # one row's every slot stale: below its window, past sinks
        meta[table[stale].cpu().numpy()] = sinks
    meta = torch.from_numpy(meta).to(dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    plan = pa.p1_plan(dtype, kp.dtype, B, Hkv * 2, Hkv, D, page, max_pages,
                      window, sinks, True)
    assert plan.mode == pa.P1_RING
    assert (plan.splits == 1) == (B == 40)
    n = (paged_attention.launches, paged_attention.window_launches,
         paged_attention.ring_launches)
    kw = dict(layer=1, k_scales=ks, v_scales=vs, window=window, sinks=sinks,
              pos_meta=meta)
    got = paged_attention(q, kp, vp, table, ln, **kw)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.window_launches,
            paged_attention.ring_launches) == (n[0] + 1, n[1], n[2] + 1)
    want = paged_attention_plain(q, kp, vp, table, ln, **kw)
    _close(got, want)
    if B > 1:
        assert not got[stale].any() and not want[stale].any()
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


@pytest.mark.parametrize("D", [288, 320, 512])
def test_paged_other_head_dims_are_refused(dev, D):
    """A head dim past 256 is refused on the card (every D up to 256 runs,
    in its own instance or a ragged one): both wrappers raise before any
    launch, naming ROADMAP Queue 2a, and the built plan entries return an
    error (cudaErrorInvalidValue)."""
    from cubecl_tpu_torch.ops import paged_attention as pa
    from cubecl_tpu_torch.utils import native

    bf = torch.bfloat16
    q = torch.zeros(2, 4, D, device=dev, dtype=bf)
    kp = torch.zeros(1, 2, 4, 16, D, device=dev, dtype=bf)
    table = torch.arange(4, device=dev, dtype=torch.int32).view(2, 2)
    ln = torch.tensor([3, 20], device=dev, dtype=torch.int32)
    n = (paged_attention.launches, paged_attention_chunked.launches)
    with pytest.raises(ValueError, match="Queue 2a"):
        paged_attention(q, kp, kp, table, ln)
    with pytest.raises(ValueError, match="Queue 2a"):
        paged_attention_chunked(q[:, :, None], kp, kp, table, ln, ln - 1)
    assert (paged_attention.launches, paged_attention_chunked.launches) == n
    lib = native.kernels()
    plan = (ctypes.c_int * 10)()
    assert lib.cubecl_paged_decode_plan(
        1, 1, 2, 4, 2, D, 16, 2, 0, 0, 0,
        ctypes.cast(plan, ctypes.c_void_p)) != 0
    assert lib.cubecl_paged_chunked_plan(
        1, 1, 2, 4, 2, 1, D, 16, 2, ctypes.cast(plan, ctypes.c_void_p)) != 0


# P1 and P3 at head dims with no instance of their own, run by the ragged
# instances of the next width of 64, 128 and 256: 1 and 33 (rows of an odd
# number of bf16 or int8 elements: plain loads), 48, 100 (bf16 rows of 200
# bytes: 8-byte copies; int8 of 100: 4-byte), MPT-30B's 112, 160, 192, 200
# and 255 (the widest, f32 pools at 256's one stage a warp)
RAGGED_D = [1, 33, 48, 100, 112, 160, 192, 200, 255]
# (B, Hkv, G, page, max_pages, lengths, window, sinks): positions split
# over blocks and combined, a length-0 row, a row at the table's capacity;
# G 12 on pages of 7 (the row groups of the grouped kernel). On a ring a
# row's length is its length plus half the capacity (a length 0 stays 0),
# so that its slots recycle
RAGGED_P1 = {
    "G2-page16": (4, 2, 2, 16, 17, [0, 100, 200, 272], 240, 16),
    "G12-page7": (5, 1, 12, 7, 40, [0, 7, 70, 129, 280], 50, 9),
}


@pytest.mark.parametrize("layout", list(RAGGED_P1))
@pytest.mark.parametrize("mode", ["full", "window", "ring"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("D", RAGGED_D)
def test_paged_ragged_head_dims_match_plain(dev, D, kind, mode, layout):
    """P1 at a head dim without an instance of its own (paged_ragged.cu) in
    every mode and on every pool against its plain version: the pools,
    q and o at the real D, no copy of a pool; the plan is the built
    kernel's; one launch, counted in its mode; a length-0 row's zeros."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    B, Hkv, G, page, max_pages, lengths, window, sinks = RAGGED_P1[layout]
    if mode == "ring":
        lengths = [n + page * max_pages // 2 if n else 0 for n in lengths]
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(D * G + len(mode))
    q, kp, vp, ks, vs, table = _stream_pools(g, dev, dtype, kind == "int8",
                                             B, Hkv, G, D, page, max_pages)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(layer=1, k_scales=ks, v_scales=vs)
    if mode != "full":
        kw.update(window=window, sinks=sinks)
    if mode == "ring":
        kw["pos_meta"] = torch.from_numpy(_ring_meta(
            table, lengths, page, sinks)[:kp.shape[2]]).to(dev)
    args = (dtype, kp.dtype, B, Hkv * G, Hkv, D, page, max_pages,
            kw.get("window", 0), kw.get("sinks", 0), mode == "ring")
    assert pa.p1_kernel_plan(*args) == pa.p1_plan(*args)
    n = (paged_attention.launches, paged_attention.window_launches,
         paged_attention.ring_launches, paged_attention.grouped_launches)
    got = paged_attention(q, kp, vp, table, ln, **kw)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.window_launches,
            paged_attention.ring_launches,
            paged_attention.grouped_launches) == (
        n[0] + 1, n[1] + (mode == "window"), n[2] + (mode == "ring"),
        n[3] + (G > 8))
    assert got.shape == q.shape
    _close(got, paged_attention_plain(q, kp, vp, table, ln, **kw))
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


@pytest.mark.parametrize("shape", [(4, 2, 2, 5, 7), (2, 2, 3, 70, 16)],
                         ids=["verify-page7", "C70-page16"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("D", RAGGED_D)
def test_paged_chunked_ragged_head_dims_match_plain(dev, D, kind, shape):
    """P3 at a head dim without an instance of its own (the ragged
    instances of paged_chunked.cu) on every pool against its plain
    version: the decode-shaped chunk with its positions split and
    combined, the C 70 chunk in 4 row tiles; a length-0 row's zeros; the
    plan is the built kernel's; one launch."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    B, Hkv, G, C, page = shape
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    max_pages = -(-128 // page) + 2
    g = torch.Generator(device=dev).manual_seed(C * D + len(kind))
    _, kp, vp, ks, vs, table = _stream_pools(g, dev, dtype, kind == "int8",
                                             B, Hkv, G, D, page, max_pages)
    q = torch.randn(B, Hkv * G, C, D, generator=g, device=dev).to(dtype)
    args = (dtype, kp.dtype, B, Hkv * G, Hkv, C, D, page, max_pages)
    assert pa.p3_kernel_plan(*args) == pa.p3_plan(*args)
    for starts, lengths in (([0, 7, 16, 40][:B], None),
                            ([0, 9, 3, 20][:B], [0, 12, 30, 25][:B])):
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        ln = st + C if lengths is None else torch.tensor(
            lengths, dtype=torch.int32, device=dev)
        n = paged_attention_chunked.launches
        got = paged_attention_chunked(q, kp, vp, table, ln, st, layer=1,
                                      k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        assert paged_attention_chunked.launches == n + 1
        _close(got, paged_attention_chunked_plain(
            q, kp, vp, table, ln, st, layer=1, k_scales=ks, v_scales=vs))
        if lengths is not None:
            assert not got[0].any()


# P1's plain-decode parameters as before the StreamingLLM kernels came
# beside them (cu++filt names a template's parameter types T1, T2)
P1_MODE0_PARAMS = ("(const T1 *, const T2 *, const T2 *, const float *, "
                   "const float *, const int *, const int *, T1 *, float *, "
                   "int, int, int, int, int, int, int, float, int)")


def test_paged_plain_decode_plan_and_symbols_unchanged(dev):
    """The plain decode keeps its plan (the serving, KV-bound and d768
    shapes' splits and scratch, mode 0) and its kernels: the library holds
    paged_decode_kernel<T, TK, D> for the 24 (q, pools, D) instances (D
    32, 64, 80, 96, 128 and 256) with their parameters unchanged, beside
    24 paged_window_kernel and 24 paged_ring_kernel instances (cuobjdump,
    demangled by cu++filt)."""
    import os
    import re
    import subprocess

    from cubecl_tpu_torch.ops import paged_attention as pa
    from cubecl_tpu_torch.utils import native

    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    for args, splits, scratch in [
            ((bf, bf, 8, 16, 8, 128, 128, 9), 4, 8 * 16 * 4 * 130),
            ((bf, i8, 8, 16, 8, 128, 128, 9), 4, 8 * 16 * 4 * 130),
            ((bf, bf, 16, 16, 8, 128, 128, 16), 2, 16 * 16 * 2 * 130),
            ((f32, f32, 16, 12, 4, 64, 128, 4), 4, 16 * 12 * 4 * 66)]:
        plan = pa.p1_kernel_plan(*args)
        assert (plan.splits, plan.scratch, plan.mode) == (splits, scratch, 0)
        assert plan == pa.p1_plan(*args)
    path = native.build().path
    bindir = os.path.dirname(native.find_nvcc())
    sass = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    names = sorted(set(re.findall(
        r"Function : (\S*paged_(?:decode|window|ring)_kernel\S*)", sass)))
    demangled = subprocess.run([os.path.join(bindir, "cu++filt")],
                               input="\n".join(names), capture_output=True,
                               text=True, check=True,
                               timeout=60).stdout.splitlines()
    by_kernel = {}
    for d in demangled:   # spaces out; "float const*" as "const float*"
        d = re.sub(r"(\w+)const\*", r"const\1*", re.sub(r"\s+", "", d))
        k = re.search(r"(paged_(?:decode|window|ring)_kernel)<", d).group(1)
        by_kernel.setdefault(k, []).append(d)
    assert {k: len(v) for k, v in by_kernel.items()} == {
        "paged_decode_kernel": 24, "paged_window_kernel": 24,
        "paged_ring_kernel": 24}
    params = re.sub(r"\s+", "", P1_MODE0_PARAMS)
    for d in by_kernel["paged_decode_kernel"]:
        assert d.endswith(">" + params), (d, params)
    for T, TK in (("float", "float"), ("float", "signedchar"),
                  ("__nv_bfloat16", "__nv_bfloat16"),
                  ("__nv_bfloat16", "signedchar")):
        for D in (32, 64, 80, 96, 128, 256):  # maybe (int)64
            want = rf"paged_decode_kernel<{T},{TK},(\(int\))?{D}>\("
            assert any(re.search(want, d)
                       for d in by_kernel["paged_decode_kernel"]), \
                (want, by_kernel["paged_decode_kernel"])


# P1 past 8 query heads a kv head (row groups of at most 8 rows, a block
# each): (B, Hkv, G, D, page, max_pages, lengths, window, sinks). G 9 at
# D 96, ragged with a length-0 row on pages of 7; Mistral-Large-2's G 12
# at D 128 on pages of 1; G 16 at D 128, one row at context 4096 (many
# splits); Falcon-7B's multi-query G 71 at D 64, 8 rows (3 splits of 9
# row groups)
P1_GROUPED = {
    "G9-D96-page7": (5, 2, 9, 96, 7, 40, [0, 7, 70, 129, 280], 50, 9),
    "G12-D128-page1": (3, 2, 12, 128, 1, 300, [0, 150, 300], 64, 3),
    "G16-D128-B1-ctx4096": (1, 2, 16, 128, 128, 32, [4096], 2000, 4),
    "G71-D64": (8, 1, 71, 64, 128, 16, [2048, 1, 64, 65, 700, 1500, 2000,
                                         2047], 256, 4),
    # G 12 on one kv head at D 80 and D 32, ragged with a length-0 row
    "G12-D80": (4, 1, 12, 80, 128, 16, [0, 100, 1024, 2048], 512, 4),
    "G12-D32-page7": (5, 2, 12, 32, 7, 40, [0, 7, 70, 129, 280], 50, 9),
}


@pytest.mark.parametrize("layout", list(P1_GROUPED))
@pytest.mark.parametrize("mode", ["full", "window", "ring"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_paged_grouped_kernel_matches_plain(dev, kind, mode, layout):
    """P1 past 8 query heads a kv head in every mode and on every pool
    against its plain version: the row groups' blocks (p1_plan's groups)
    and their split over positions combined into one output a query row,
    a length-0 row's zeros; the call's plan is the built kernel's; one
    launch, counted in its mode."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    B, Hkv, G, D, page, max_pages, lengths, window, sinks = \
        P1_GROUPED[layout]
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(G * D + len(mode))
    q, kp, vp, ks, vs, table = _stream_pools(g, dev, dtype, kind == "int8",
                                             B, Hkv, G, D, page, max_pages)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(layer=1, k_scales=ks, v_scales=vs)
    if mode != "full":
        kw.update(window=window, sinks=sinks)
    if mode == "ring":
        kw["pos_meta"] = torch.from_numpy(_ring_meta(
            table, lengths, page, sinks)[:kp.shape[2]]).to(dev)
    args = (dtype, kp.dtype, B, Hkv * G, Hkv, D, page, max_pages,
            kw.get("window", 0), kw.get("sinks", 0), mode == "ring")
    plan = pa.p1_plan(*args)
    assert plan.groups == -(-G // 8) and plan.grid[0] == \
        plan.splits * plan.groups
    assert pa.p1_kernel_plan(*args) == plan
    n = (paged_attention.launches, paged_attention.window_launches,
         paged_attention.ring_launches)
    got = paged_attention(q, kp, vp, table, ln, **kw)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.window_launches,
            paged_attention.ring_launches) == (
        n[0] + 1, n[1] + (mode == "window"), n[2] + (mode == "ring"))
    _close(got, paged_attention_plain(q, kp, vp, table, ln, **kw))
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


def test_paged_grouped_plan_matches_the_kernel(dev):
    """P1's plans past 8 query heads a kv head (G 9, 12, 16, 71 and 127;
    the row groups, the splits that count them, the scratch) are the built
    kernel's, per q dtype, pool dtype, shape and options."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    for dt in (torch.float32, torch.bfloat16):
        for kv in (dt, torch.int8):
            for B, H, Hkv, D, page, max_pages in [
                    (8, 96, 8, 128, 128, 9), (8, 32, 2, 128, 128, 16),
                    (8, 71, 1, 64, 128, 16), (5, 18, 2, 96, 7, 40),
                    (3, 24, 2, 128, 1, 300), (1, 71, 1, 64, 16, 2),
                    (1, 127, 1, 64, 128, 33), (40, 96, 8, 128, 16, 8),
                    (2, 32, 2, 96, 16, 256), (4, 12, 1, 80, 128, 16),
                    (5, 18, 2, 80, 7, 40), (4, 12, 1, 32, 128, 16),
                    (3, 24, 2, 32, 1, 300)]:
                for opts in [(0, 0, False), (2000, 4, False),
                             (240, 16, False), (240, 16, True),
                             (0, 0, True)]:
                    args = (dt, kv, B, H, Hkv, D, page, max_pages, *opts)
                    assert pa.p1_kernel_plan(*args) == pa.p1_plan(*args), \
                        args


# P3 past 8 query heads a kv head: (B, Hkv, G, C, D, page, max_pages,
# starts, lengths or None for starts + C): Mistral-Large-2's verify step
# (G 12: 60 rows, one tile, positions split) and a prefill chunk from 0
# (G 12 x 70 tokens: 14 row tiles); Falcon-7B's verify step (G 71 x 5:
# 355 rows in 6 tiles) with a length-0 row
P3_GROUPED = {
    "G12-verify": (4, 2, 12, 5, 128, 16, 20, [0, 7, 16, 40], None),
    "G12-C70": (2, 2, 12, 70, 128, 16, 10, [0, 9], None),
    "G71-verify": (4, 1, 71, 5, 64, 128, 3, [0, 100, 251, 3],
                   [0, 105, 256, 8]),
    "G12-verify-D80": (4, 2, 12, 5, 80, 16, 20, [0, 7, 16, 40], None),
    "G12-verify-D32": (4, 2, 12, 5, 32, 16, 20, [0, 7, 16, 40], None),
}


@pytest.mark.parametrize("case", list(P3_GROUPED))
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_paged_chunked_grouped_kernel_matches_plain(dev, kind, case):
    """P3 at G 12 and 71 against its plain version on every pool: the G *
    C rows cut into 64-row tiles, decode-shaped tiles with their
    positions split; the plan is the built kernel's; one launch."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    B, Hkv, G, C, D, page, max_pages, starts, lengths = P3_GROUPED[case]
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(G * C + len(kind))
    q, kp, vp, ks, vs, table = _stream_pools(g, dev, dtype, kind == "int8",
                                             B, Hkv, G, D, page, max_pages)
    q = torch.randn(B, Hkv * G, C, D, generator=g, device=dev).to(dtype)
    args = (dtype, kp.dtype, B, Hkv * G, Hkv, C, D, page, max_pages)
    assert pa.p3_kernel_plan(*args) == pa.p3_plan(*args)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = st + C if lengths is None else torch.tensor(
        lengths, dtype=torch.int32, device=dev)
    n = paged_attention_chunked.launches
    got = paged_attention_chunked(q, kp, vp, table, ln, st, layer=1,
                                  k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert paged_attention_chunked.launches == n + 1
    _close(got, paged_attention_chunked_plain(q, kp, vp, table, ln, st,
                                              layer=1, k_scales=ks,
                                              v_scales=vs))
    if lengths is not None:
        assert not got[0].any()


@pytest.mark.parametrize("page", [16, 7, 48, 128])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2, 2, 5, 64), (2, 2, 3, 70, 128),
                                   (4, 2, 2, 5, 96), (2, 2, 3, 70, 96),
                                   (4, 2, 2, 5, 80), (2, 2, 3, 70, 80),
                                   (4, 2, 2, 5, 32), (2, 2, 3, 70, 32)],
                         ids=["B4-Hkv2-G2-C5-D64", "B2-Hkv2-G3-C70-D128",
                              "B4-Hkv2-G2-C5-D96", "B2-Hkv2-G3-C70-D96",
                              "B4-Hkv2-G2-C5-D80", "B2-Hkv2-G3-C70-D80",
                              "B4-Hkv2-G2-C5-D32", "B2-Hkv2-G3-C70-D32"])
def test_paged_chunked_kernel_matches_plain(dev, quant, dtype, shape, page):
    """P3: chunks starting at 0, in mid-page and on a page boundary, one
    row of length 0 (zeros) and one whose length stops inside its chunk,
    against the plain version, at page sizes that 64 positions hold whole
    or not (7, 48) and that hold 64 (128). bf16 runs the wgmma body: the
    decode-shaped chunk (10 rows) with its positions in several splits
    and the combine (p3_plan), the C 70 chunk's 210 rows in 4 row tiles
    without a split; f32 the CUDA-core body."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    B, Hkv, G, C, D = shape
    g = torch.Generator(device=dev).manual_seed(C * D + quant + page)
    L, max_pages = 2, -(-128 // page) + 2  # at least 128 positions a row
    P = B * max_pages + 3
    plan = pa.p3_plan(dtype, torch.int8 if quant else dtype, B, Hkv * G,
                      Hkv, C, D, page, max_pages)
    assert plan.body == ("wgmma" if dtype == torch.bfloat16
                         else "cuda-cores")
    if dtype == torch.bfloat16:
        assert (plan.splits > 1) == (G * C <= 64)
    q = torch.randn(B, Hkv * G, C, D, generator=g, device=dev).to(dtype)
    if quant:
        kp, vp, ks, vs = _int8_pools(g, dev, (L, Hkv, P, page, D))
    else:
        kp, vp = (torch.randn(L, Hkv, P, page, D, generator=g,
                              device=dev).to(dtype) for _ in range(2))
        ks = vs = None
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages]
    table = table.view(B, max_pages).to(torch.int32)
    for starts, lengths in (([0, 7, 16, 40][:B], None),
                            ([0, 9, 3, 20][:B], [0, 12, 30, 25][:B])):
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        ln = st + C if lengths is None else torch.tensor(
            lengths, dtype=torch.int32, device=dev)
        n = paged_attention_chunked.launches
        got = paged_attention_chunked(q, kp, vp, table, ln, st, layer=1,
                                      k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        assert paged_attention_chunked.launches == n + 1
        _close(got, paged_attention_chunked_plain(
            q, kp, vp, table, ln, st, layer=1, k_scales=ks, v_scales=vs))
        if lengths is not None:
            assert not got[0].any()


# (B, Hkv, G, C, D, max_pages, starts, lengths or None for starts + C):
# chip_smoke.py's phase i bf16 shapes, page 128: the verify step (its
# positions in 6 splits of 3 stages), a ragged batch with a length-0 row
# (4 splits), a prefill chunk from 768 (8 row tiles, up to 16 stages)
P3_REPEAT_CASES = {
    "verify": (8, 8, 2, 5, 128, 9, [1051] * 8, None),
    "ragged": (8, 8, 2, 16, 128, 8, [0, 1, 127, 128, 500, 1000, 640, 3],
               [0, 17, 143, 144, 510, 1016, 656, 10]),
    "prefill start 768": (8, 8, 2, 256, 128, 9, [768] * 8, None),
    # phase zb's Phi-3-mini shapes, D 96: the verify step (2 splits),
    # chunked prefill from 768
    "phi3 verify": (8, 32, 1, 5, 96, 10, [1051] * 8, None),
    "phi3 prefill start 768": (8, 32, 1, 256, 96, 10, [768] * 8, None),
    # phase zf's Phi-2 (D 80) and D 32 shapes
    "phi-2 verify": (8, 32, 1, 5, 80, 10, [1051] * 8, None),
    "phi-2 prefill start 768": (8, 32, 1, 256, 80, 10, [768] * 8, None),
    "D32 verify": (8, 16, 1, 5, 32, 17, [2043] * 8, None),
    "D32 prefill start 768": (8, 16, 1, 256, 32, 10, [768] * 8, None),
}
P3_LAUNCHES = 200


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", list(P3_REPEAT_CASES))
def test_paged_chunked_every_launch_of_many_agrees(dev, case, quant):
    """P3's wgmma body at phase i's shapes: a race in its ring of cp.async
    stages (a stage refilled before every warp read it, a copy read
    before it landed) or in the split's partial sums shows in a few
    launches of many, not in one. The first launch within TOL of plain,
    each of P3_LAUNCHES launches equal to it bit for bit (the kernel's
    sums run in one order)."""
    B, Hkv, G, C, D, max_pages, starts, lengths = P3_REPEAT_CASES[case]
    g = torch.Generator(device=dev).manual_seed(len(case) + quant)
    L, page = 2, 128
    P = B * max_pages + 5
    shape = (L, Hkv, P, page, D)
    q = torch.randn(B, Hkv * G, C, D, generator=g,
                    device=dev).to(torch.bfloat16)
    if quant:
        kp, vp, ks, vs = _int8_pools(g, dev, shape)
    else:
        kp, vp = (torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        ks = vs = None
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages]
    table = table.view(B, max_pages).to(torch.int32)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = st + C if lengths is None else torch.tensor(
        lengths, dtype=torch.int32, device=dev)
    first = paged_attention_chunked(q, kp, vp, table, ln, st, layer=1,
                                    k_scales=ks, v_scales=vs)
    _close(first, paged_attention_chunked_plain(
        q, kp, vp, table, ln, st, layer=1, k_scales=ks, v_scales=vs))
    bad = torch.zeros(P3_LAUNCHES, dtype=torch.int64, device=dev)
    for i in range(P3_LAUNCHES):
        got = paged_attention_chunked(q, kp, vp, table, ln, st, layer=1,
                                      k_scales=ks, v_scales=vs)
        bad[i] = (got != first).sum()
    bad = bad.cpu()
    assert not bad.any(), (f"{int((bad > 0).sum())} of {P3_LAUNCHES} "
                           f"launches differ, {int(bad.sum())} elements")


def test_paged_chunked_plan_matches_the_kernel(dev):
    """The launch plans ops/paged_attention.py sizes P3's scratch with
    (p3_plan) are the built kernel's (csrc/paged_chunked.cu's
    cubecl_paged_chunked_plan), per q dtype, pool dtype and shape."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    for dt in (torch.float32, torch.bfloat16):
        for kv in (dt, torch.int8):
            for B, H, Hkv, C, D, page, max_pages in [
                    (8, 16, 8, 5, 128, 128, 9), (8, 16, 8, 256, 128, 128, 9),
                    (8, 16, 8, 16, 128, 128, 8), (16, 12, 4, 5, 64, 128, 4),
                    (4, 4, 2, 5, 64, 7, 21), (2, 6, 2, 70, 128, 16, 10),
                    (1, 32, 8, 1, 128, 16, 4096), (300, 16, 8, 5, 64, 128, 9),
                    (8, 32, 32, 5, 96, 128, 10), (8, 32, 32, 256, 96, 128, 10),
                    (4, 4, 2, 16, 96, 7, 40), (1, 8, 1, 1, 96, 16, 4096),
                    (8, 32, 32, 5, 80, 128, 10), (8, 32, 32, 256, 80, 128, 10),
                    (8, 32, 8, 5, 80, 128, 33), (4, 8, 2, 16, 80, 7, 40),
                    (8, 16, 16, 5, 32, 128, 17), (8, 8, 8, 256, 32, 128, 10),
                    (4, 8, 2, 16, 32, 7, 40), (1, 8, 1, 1, 32, 16, 4096)]:
                assert pa.p3_kernel_plan(dt, kv, B, H, Hkv, C, D, page,
                                         max_pages) \
                    == pa.p3_plan(dt, kv, B, H, Hkv, C, D, page, max_pages), \
                    (dt, kv, B, H, Hkv, C, D, page, max_pages)


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8"])
def test_chunked_serving_kernels_match_plain(dev, kv_dtype):
    """prefill_chunked, decode steps and speculative decoding (self-draft)
    with the kernels against the plain versions, f32: equal tokens; logits
    to f32 summation order, and on an int8 cache to 1e-3, where a K/V value
    quantized from a slightly other f32 number may land one int8 step
    away."""
    cfg = llama.LlamaConfig(vocab=128, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, kv_dtype=kv_dtype,
                            use_framework_kernels=False)
    model = llama.init_params(cfg, seed=0, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 70), dtype=np.int32)).to(dev)
    out = []
    for kernels in (True, False):
        n = paged_attention_chunked.launches
        c = llama.init_kv_cache(cfg, 3, 4, 32, dev)
        lg, c = llama.prefill_chunked(model, c, prompt, chunk=32,
                                      kernels=kernels)
        assert paged_attention_chunked.launches == n + (
            3 * cfg.n_layers if kernels else 0)
        toks, acc = llama.speculative_generate(model, prompt, 6, model,
                                               gamma=3, max_pages=4,
                                               page=32, kernels=kernels)
        out.append((lg, toks, acc))
    (lk, tk, ak), (lp, tp, ap) = out
    tol = 1e-3 if kv_dtype else 2e-5
    torch.testing.assert_close(lk, lp, atol=tol, rtol=max(tol, 1e-4))
    assert torch.equal(tk, tp) and ak == ap == 3.0
    assert torch.equal(tk, llama.generate(model, prompt, 6, max_pages=4,
                                          page=32))


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8"])
def test_serving_at_head_dim_96_matches_plain(dev, kv_dtype):
    """The llama at head dim 96 (Phi-3-mini's; d 384, 4/2 heads) served on
    the D 96 instances, f32: prefill_chunked (P3 prefill-shaped), decode
    steps and the speculative verify (P1, P3 decode-shaped), beam search
    (P1 on the forked beams' pages), then 120
    windowed decode steps and 120 on a ring of 96 slots (P1's options),
    each launch counted, against the plain versions fed the same tokens:
    equal tokens and beams, logits and beam scores as
    test_chunked_serving_kernels_match_plain holds logits."""
    cfg = llama.LlamaConfig(vocab=128, d_model=384, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, kv_dtype=kv_dtype,
                            use_framework_kernels=False)
    assert cfg.head_dim == 96
    model = llama.init_params(cfg, seed=5, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (3, 70), dtype=np.int32)).to(dev)
    streaming = (dict(attn_window=24, attn_sinks=8), 4), \
        (dict(attn_window=24, attn_sinks=32, ring_cache=True), 3)
    out, fed = [], []
    for kernels in (True, False):
        n = (paged_attention_chunked.launches, paged_attention.launches)
        c = llama.init_kv_cache(cfg, 3, 4, 32, dev)
        lg, c = llama.prefill_chunked(model, c, prompt, chunk=32,
                                      kernels=kernels)
        toks, acc = llama.speculative_generate(model, prompt, 6, model,
                                               gamma=3, max_pages=4,
                                               page=32, kernels=kernels)
        ran = (paged_attention_chunked.launches - n[0],
               paged_attention.launches - n[1])
        assert all(ran) if kernels else ran == (0, 0)
        n1 = paged_attention.launches
        beams = llama.beam_generate(model, prompt[0], 6, beams=3, page=32,
                                    kernels=kernels)
        # P1 once a layer for each of the 5 decode steps after the prefill
        assert paged_attention.launches - n1 == (10 if kernels else 0)
        streams = []
        for i, (over, pages) in enumerate(streaming):
            m = llama.Llama(dataclasses.replace(cfg, **over), device=dev)
            m.load_state_dict(model.state_dict())
            sc = llama.init_kv_cache(m.cfg, 3, pages, 32, dev)
            w = (paged_attention.window_launches,
                 paged_attention.ring_launches)
            tok, lgs, feed = prompt[:, 0], [], []
            for t in range(120):   # greedy; the plain run fed its tokens
                tok = tok if kernels else fed[i][:, t]
                feed.append(tok)
                lg_t, sc = llama.decode_step(m, sc, tok, kernels=kernels)
                lgs.append(lg_t)
                tok = lg_t.argmax(-1).to(torch.int32)
            if kernels:
                fed.append(torch.stack(feed, 1))
            got = (paged_attention.window_launches - w[0],
                   paged_attention.ring_launches - w[1])
            want = (0, 0) if not kernels else \
                (0, 240) if over.get("ring_cache") else (240, 0)
            assert got == want, (over, got)
            streams.append(torch.stack(lgs, 1))
        out.append((lg, toks, acc, streams, beams))
    (lk, tk, ak, sk, bk), (lp, tp, ap, sp, bp) = out
    tol = 1e-3 if kv_dtype else 2e-5
    torch.testing.assert_close(lk, lp, atol=tol, rtol=max(tol, 1e-4))
    assert torch.equal(tk, tp) and ak == ap == 3.0
    assert torch.equal(bk[0], bp[0])
    torch.testing.assert_close(bk[1], bp[1], atol=tol, rtol=max(tol, 1e-4))
    for a, b in zip(sk, sp):
        torch.testing.assert_close(a, b, atol=tol, rtol=max(tol, 1e-4))


# -- slice 5: the matmul kernel (M1/M2), its tuner, K0 cmma ---------------

_MM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2, "int8": torch.int8}


def _mm_operand(g, dev, dtype, shape, K):
    if dtype == "int8":
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)
    # N(0, K^-1/2) entries: sums of K products are N(0, 1)
    return (torch.randn(shape, generator=g, device=dev)
            * K ** -0.25).to(_MM_DTYPES[dtype])


@pytest.mark.parametrize("b_transposed", [False, True])
@pytest.mark.parametrize("dtype", list(_MM_DTYPES))
def test_matmul_kernel_matches_plain(dev, dtype, b_transposed):
    """Every built tile of M1 against plain, per dtype and B layout:
    int8 -> int32 exact; float operands to f32 summation order (f32 out,
    f32 operands as three TF32 products) and one rounding (bf16 out; f16
    out for 16-bit operands). M2 (host scales) and M1 scaled (device
    scales) on the first tile, and on every tile for 16-bit and f32
    operands (the wgmma bodies of csrc/matmul.cu, each of whose instances
    256^3 runs)."""
    from cubecl_tpu_torch.ops import matmul as mm

    g = torch.Generator(device=dev).manual_seed(len(dtype))
    M, N, K = 256, 256, 256
    a = _mm_operand(g, dev, dtype, (M, K), K)
    b = _mm_operand(g, dev, dtype, (N, K) if b_transposed else (K, N), K)
    sixteen = mm._itemsize(dtype) == 2
    outs = (torch.int32, torch.float32) if dtype == "int8" else \
        (torch.float32, torch.bfloat16, torch.float16) if sixteen else \
        (torch.float32, torch.bfloat16)
    tiles = mm._tile_candidates(M, N, K, mm._itemsize(dtype))
    assert tiles
    if sixteen:
        assert sorted(tiles) == sorted(mm.kernel_tiles(2))
    for od in outs:
        want = mm.matmul_plain(a, b, od, b_transposed)
        for tile in tiles:
            o = torch.empty(M, N, device=dev, dtype=od)
            n = mm.matmul_pallas.launches
            mm._gemm(a, b, o, tile, b_transposed, counter=mm.matmul_pallas)
            torch.cuda.synchronize()
            assert mm.matmul_pallas.launches == n + 1
            if od == torch.int32:
                assert torch.equal(o, want), tile
            else:
                _close(o, want)
    if dtype == "float32":
        assert sorted(tiles) == sorted(mm.kernel_tiles(4))
    for tile in tiles if mm._itemsize(dtype) != 1 else tiles[:1]:
        o = torch.empty(M, N, device=dev)
        mm._gemm(a, b, o, tile, b_transposed, 4.0, 0.5,
                 counter=mm.matmul_scaled)
        _close(o, mm.matmul_plain(a, b, torch.float32, b_transposed, 2.0))
        sa = torch.tensor([0.5], device=dev)
        sb = torch.tensor([0.25], device=dev)
        mm._gemm(a, b, o, tile, b_transposed, sa, sb,
                 counter=mm.matmul_pallas)
        _close(o, mm.matmul_plain(a, b, torch.float32, b_transposed,
                                  sa[0] * sb[0]))


@pytest.mark.parametrize("K", [160, 640], ids=["half_stage", "ten_stages"])
@pytest.mark.parametrize("b_transposed", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_matmul16_wgmma_every_tile(dev, dtype, b_transposed, K):
    """The 16-bit body (csrc/matmul.cu on csrc/wgmma_gemm.cuh): every tile
    instance in both B layouts (B as (K, N) read through the wgmma
    transpose bit), the three epilogues and the three float outputs,
    against plain, at M 512 x N 768 (persistent blocks walking several
    tiles each for the small tiles: 48 of 64 x 128) and a K whose last
    stage of 64 is half past K (zero-filled by the tensor maps) or ten
    stages deep (more than the ring holds)."""
    from cubecl_tpu_torch.ops import matmul as mm

    g = torch.Generator(device=dev).manual_seed(K + len(dtype))
    M, N = 512, 768
    a = _mm_operand(g, dev, dtype, (M, K), K)
    b = _mm_operand(g, dev, dtype, (N, K) if b_transposed else (K, N), K)
    tiles = mm._tile_candidates(M, N, K, 2)
    assert sorted(tiles) == sorted(mm.kernel_tiles(2))
    wants = {od: mm.matmul_plain(a, b, od, b_transposed)
             for od in (torch.float32, torch.bfloat16, torch.float16)}
    want_m2 = mm.matmul_plain(a, b, torch.bfloat16, b_transposed, 0.125)
    sa = torch.tensor([0.5], device=dev)
    sb = torch.tensor([0.25], device=dev)
    want_m1s = mm.matmul_plain(a, b, torch.float16, b_transposed,
                               sa[0] * sb[0])
    for tile in tiles:
        for od, want in wants.items():
            o = torch.full((M, N), float("nan"), device=dev, dtype=od)
            mm._gemm(a, b, o, tile, b_transposed, counter=mm.matmul_pallas)
            _close(o, want)
        o = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
        mm._gemm(a, b, o, tile, b_transposed, 0.5, 0.25,
                 counter=mm.matmul_scaled)
        _close(o, want_m2)
        o = torch.empty(M, N, device=dev, dtype=torch.float16)
        mm._gemm(a, b, o, tile, b_transposed, sa, sb,
                 counter=mm.matmul_pallas)
        _close(o, want_m1s)


@pytest.mark.parametrize("K", [40, 640], ids=["partial_stage",
                                               "twenty_stages"])
@pytest.mark.parametrize("b_transposed", [False, True])
def test_matmul_tf32x3_every_tile(dev, b_transposed, K):
    """The f32 body (csrc/matmul.cu's gemm_tf32x3_kernel on
    csrc/wgmma_gemm.cuh: three TF32 products a k8 step): every tile
    instance in both B layouts (B as (K, N) transposed into a scratch in
    the call), the three epilogues and the three float outputs, against
    plain in full f32 at f32's 2e-5 / 1e-4, at M 512 x N 768 (persistent
    blocks walking several tiles each) and a K whose last stage of 32 is
    a quarter full (zero-filled by the tensor maps) or twenty stages deep
    (more than the ring holds); then a shape only the 64 x 64 tile takes
    (M 192 x N 320, K 72), as the CUDA-core body took it."""
    from cubecl_tpu_torch.ops import matmul as mm

    g = torch.Generator(device=dev).manual_seed(K + 5)
    M, N = 512, 768
    a = _mm_operand(g, dev, "float32", (M, K), K)
    b = _mm_operand(g, dev, "float32", (N, K) if b_transposed else (K, N), K)
    tiles = mm._tile_candidates(M, N, K, 4)
    assert sorted(tiles) == sorted(mm.kernel_tiles(4))
    wants = {od: mm.matmul_plain(a, b, od, b_transposed)
             for od in (torch.float32, torch.bfloat16, torch.float16)}
    want_m2 = mm.matmul_plain(a, b, torch.bfloat16, b_transposed, 0.125)
    sa = torch.tensor([0.5], device=dev)
    sb = torch.tensor([0.25], device=dev)
    want_m1s = mm.matmul_plain(a, b, torch.float32, b_transposed,
                               sa[0] * sb[0])
    for tile in tiles:
        for od, want in wants.items():
            o = torch.full((M, N), float("nan"), device=dev, dtype=od)
            mm._gemm(a, b, o, tile, b_transposed, counter=mm.matmul_pallas)
            _close(o, want)
        o = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
        mm._gemm(a, b, o, tile, b_transposed, 0.5, 0.25,
                 counter=mm.matmul_scaled)
        _close(o, want_m2)
        o = torch.empty(M, N, device=dev)
        mm._gemm(a, b, o, tile, b_transposed, sa, sb,
                 counter=mm.matmul_pallas)
        _close(o, want_m1s)
    M, N, K = 192, 320, 72
    a = _mm_operand(g, dev, "float32", (M, K), K)
    b = _mm_operand(g, dev, "float32", (N, K) if b_transposed else (K, N), K)
    assert mm._tile_candidates(M, N, K, 4) == [(64, 64, 32)]
    o = torch.full((M, N), float("nan"), device=dev)
    mm._gemm(a, b, o, (64, 64, 32), b_transposed, counter=mm.matmul_pallas)
    _close(o, mm.matmul_plain(a, b, torch.float32, b_transposed))


def _f32_bits(dev, *bits):
    return torch.from_numpy(np.array(bits, np.uint32).view(np.float32)).to(
        dev)


def _non_finite_operands(dev, M, N, K, seed):
    """f32 operands, A (M, K) and B (K, N), N(0, K^-1/2) but for rows of A
    and columns of B that hold a NaN made by 0 / 0 on the card, NaNs whose
    bits a rounding by integer addition would carry into the exponent or
    the sign (0x7f800001, 0xffffffff, 0xffc00000), +inf, -inf, and both
    infinities in one row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = _mm_operand(g, dev, "float32", (M, K), K)
    b = _mm_operand(g, dev, "float32", (K, N), K)
    zero = torch.zeros((), device=dev)
    inf = float("inf")
    odd = _f32_bits(dev, 0x7F800001, 0xFFFFFFFF, 0xFFC00000)
    a[1, 3] = zero / zero
    a[2, 5], a[3, 7], a[70, 40] = odd
    a[4, 9], a[5, K - 1], a[13, 1], a[13, 2] = inf, -inf, inf, -inf
    b[3, 6] = zero / zero
    b[0, 12], b[K - 1, 65], b[17, 100] = odd
    b[13, 8], b[2, 10], b[6, 14], b[7, 14] = inf, -inf, inf, -inf
    return a, b


def _non_finite_agree(o, want):
    """The 3xTF32 routes on non-finite operands: NaN wherever the f32
    product is NaN, finite and within TOL wherever it is finite, and an
    infinity of its sign or NaN wherever it is infinite (the cross terms
    inf . small: csrc/hopper.cuh, tf32_split)."""
    nan, inf, fin = want.isnan(), want.isinf(), want.isfinite()
    assert nan.any() and inf.any() and fin.any()
    assert bool(o[nan].isnan().all()), "a NaN of the f32 product was lost"
    assert torch.equal(o.isfinite(), fin)
    assert bool((o[inf].isnan() | (o[inf] == want[inf])).all())
    _close(o[fin], want[fin])


@pytest.mark.parametrize("b_transposed", [False, True])
def test_matmul_tf32x3_non_finite_operands(dev, b_transposed):
    """M1's f32 body, every tile in both B layouts, on operands holding
    NaN and infinities (``_non_finite_operands``) against plain f32 on an
    output first filled with zeros: the split leaves a NaN or an infinity
    as it is, so NaN propagates as in an f32 product."""
    from cubecl_tpu_torch.ops import matmul as mm

    M, N, K = 256, 384, 96
    a, b = _non_finite_operands(dev, M, N, K, seed=11)
    if b_transposed:
        b = b.t().contiguous()
    want = mm.matmul_plain(a, b, torch.float32, b_transposed)
    for tile in mm._tile_candidates(M, N, K, 4):
        o = torch.zeros(M, N, device=dev)
        mm._gemm(a, b, o, tile, b_transposed, counter=mm.matmul_pallas)
        _non_finite_agree(o, want)


def test_cmma_f32_non_finite_operands(dev):
    """K0's f32 cmma (the 3xTF32 route) on operands holding NaN and
    infinities (``_non_finite_operands``), against plain f32 on an output
    first filled with zeros."""
    from cubecl_tpu_torch.ops import matmul as mm

    M, N, K = 256, 256, 128
    a, b = _non_finite_operands(dev, M, N, K, seed=12)
    c = CudaRuntime.client()
    o = c.empty((M * N,), "float32")
    o.tensor.zero_()
    mm.matmul_cmma(c, c.create(a.reshape(-1)), c.create(b.reshape(-1)), o,
                   M, N, K)
    torch.cuda.synchronize()
    assert "mapping=cmma-wgmma-tf32x3 " in c.server.last_launched.source
    _non_finite_agree(o.tensor.view(M, N),
                      mm.matmul_plain(a, b, torch.float32))


def _top_of_range_operands(dev, M, N, K, seed):
    """F12's operands: f32 A (M, K), N(0, K^-1/2) but for rows at the top
    of f32's range (FLT_MAX whole, values just under it, the least value
    that rounding to tf32 takes to infinity, -FLT_MAX), and B (K, N) small
    and positive (|N(0, 1)| 1e-30), so every product and sum is finite and
    the top rows' outputs are of order 1e10."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = _mm_operand(g, dev, "float32", (M, K), K)
    b = torch.randn(K, N, generator=g, device=dev).abs() * 1e-30
    top = float(np.finfo(np.float32).max)
    near = float(np.nextafter(np.float32(top), np.float32(0)))
    a[0, :] = top
    a[1, ::3] = near
    a[2, 5], a[3, 7] = (2 - 2.0 ** -11) * 2.0 ** 127, -top
    return a, b


@pytest.mark.parametrize("b_transposed", [False, True])
def test_matmul_tf32x3_top_of_range_stays_finite(dev, b_transposed):
    """F12: M1's f32 body, every tile in both B layouts, on finite
    operands at the top of f32's range (``_top_of_range_operands``): the
    f32 product, finite, within TOL (big truncated to tf32 stays finite;
    rounded to nearest it was an infinity and the cross terms NaN)."""
    from cubecl_tpu_torch.ops import matmul as mm

    M, N, K = 256, 384, 96
    a, b = _top_of_range_operands(dev, M, N, K, seed=14)
    if b_transposed:
        b = b.t().contiguous()
    want = mm.matmul_plain(a, b, torch.float32, b_transposed)
    assert bool(want.isfinite().all()) and want.abs().max() > 1e9
    for tile in mm._tile_candidates(M, N, K, 4):
        o = torch.zeros(M, N, device=dev)
        mm._gemm(a, b, o, tile, b_transposed, counter=mm.matmul_pallas)
        assert bool(o.isfinite().all()), tile
        _close(o, want)


def test_cmma_f32_top_of_range_stays_finite(dev):
    """F12: K0's f32 cmma (the 3xTF32 route) on finite operands at the
    top of f32's range (``_top_of_range_operands``): finite, within TOL
    of plain f32."""
    from cubecl_tpu_torch.ops import matmul as mm

    M, N, K = 256, 256, 128
    a, b = _top_of_range_operands(dev, M, N, K, seed=15)
    c = CudaRuntime.client()
    o = c.empty((M * N,), "float32")
    o.tensor.zero_()
    mm.matmul_cmma(c, c.create(a.reshape(-1)), c.create(b.reshape(-1)), o,
                   M, N, K)
    torch.cuda.synchronize()
    assert "mapping=cmma-wgmma-tf32x3 " in c.server.last_launched.source
    want = mm.matmul_plain(a, b, torch.float32)
    assert bool(want.isfinite().all())
    assert bool(o.tensor.isfinite().all())
    _close(o.tensor.view(M, N), want)


@pytest.mark.parametrize("b_transposed", [False, True])
@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2", "int8"])
def test_matmul8_wgmma_every_tile(dev, dtype, b_transposed):
    """The 8-bit body (csrc/matmul8.cu): every tile instance in both B
    layouts against plain at a shape both tiles divide, K five stages
    deep: int8 -> int32 exact, fp8 -> f32 at f32's tolerance (summation
    order only), and M2's host-scaled bf16 output within one bf16
    rounding. B as (K, N) goes through the byte transpose in the call."""
    from cubecl_tpu_torch.ops import matmul as mm

    g = torch.Generator(device=dev).manual_seed(7 + len(dtype))
    M, N, K = 512, 384, 640
    a = _mm_operand(g, dev, dtype, (M, K), K)
    b = _mm_operand(g, dev, dtype, (N, K) if b_transposed else (K, N), K)
    tiles = mm._tile_candidates(M, N, K, 1)
    assert sorted(tiles) == sorted(mm.kernel_tiles(1))
    od = torch.int32 if dtype == "int8" else torch.float32
    want = mm.matmul_plain(a, b, od, b_transposed)
    want_m2 = mm.matmul_plain(a, b, torch.bfloat16, b_transposed, 0.125)
    for tile in tiles:
        o = torch.empty(M, N, device=dev, dtype=od)
        mm._gemm(a, b, o, tile, b_transposed, counter=mm.matmul_pallas)
        o2 = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
        n = mm.matmul_scaled.launches
        mm._gemm(a, b, o2, tile, b_transposed, 0.5, 0.25,
                 counter=mm.matmul_scaled)
        torch.cuda.synchronize()
        assert mm.matmul_scaled.launches == n + 1
        if od == torch.int32:
            assert torch.equal(o, want), tile
        else:
            _close(o, want)
        _close(o2, want_m2)


FP8_LAUNCHES = 400


@pytest.mark.parametrize("b_transposed", [False, True])
@pytest.mark.parametrize("tile", [(128, 128, 128), (256, 128, 128)])
def test_matmul8_fp8_every_launch_of_many_agrees(dev, tile, b_transposed):
    """A race between the fp8 body's consumers and its producer shows in a
    few launches of many, not in one: before the consumers fenced their
    reads of a stage ahead of releasing it (csrc/wgmma_gemm.cuh), the
    producer's next copy overwrote A rows an ldmatrix had not read in 1-2%
    of the 256 x 128 tile's launches at the llama FFN shape on the H100.
    FP8_LAUNCHES launches at that shape, each held against plain at f32's
    tolerance."""
    from cubecl_tpu_torch.ops import matmul as mm

    assert tile in mm.kernel_tiles(1)
    g = torch.Generator(device=dev).manual_seed(11)
    M, N, K = 8192, 5632, 2048
    a = _mm_operand(g, dev, "float8_e4m3fn", (M, K), K)
    b = _mm_operand(g, dev, "float8_e4m3fn",
                    (N, K) if b_transposed else (K, N), K)
    want = mm.matmul_plain(a, b, torch.float32, b_transposed)
    atol, rtol = TOL[torch.float32]
    lim = atol + rtol * want.abs()
    o = torch.empty_like(want)
    bad = torch.zeros(FP8_LAUNCHES, dtype=torch.int64, device=dev)
    for i in range(FP8_LAUNCHES):
        mm._gemm(a, b, o, tile, b_transposed, counter=mm.matmul_pallas)
        bad[i] = ((o - want).abs() > lim).sum()
    bad = bad.cpu()
    assert not bad.any(), (f"{int((bad > 0).sum())} of {FP8_LAUNCHES} "
                           f"launches wrong, {int(bad.sum())} elements")


def _kernels_run(fn):
    """The names of the CUDA kernels that ``fn()`` launches (torch.profiler
    on the card)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def test_matmul_bodies_by_entry_point(dev, monkeypatch):
    """Which library entry and which kernel body each GEMM reaches: 16-bit
    operands csrc/matmul.cu's cubecl_matmul and its wgmma body
    (gemm16_wgmma_kernel), f32 the same entry's 3xTF32 wgmma body
    (gemm_tf32x3_kernel, after f32_transpose_kernel for B given as (K,
    N)), 8-bit ones csrc/matmul8.cu's cubecl_matmul8
    (gemm8_wgmma_kernel), E1 csrc/expert_matmul.cu's cubecl_expert_matmul,
    bf16 on its wgmma body (expert_wgmma_kernel), f32 on the CUDA cores
    (expert_fma_kernel). cubecl_matmul refuses 8-bit operands
    (cudaErrorInvalidValue), and no kernel of these launches is an
    mma.sync body."""
    from cubecl_tpu_torch.ops import matmul as mm
    from cubecl_tpu_torch.ops import moe
    from cubecl_tpu_torch.utils import native

    lib = native.kernels()
    calls = []
    for name in ("cubecl_matmul", "cubecl_matmul8", "cubecl_expert_matmul"):
        fn = getattr(lib, name)
        monkeypatch.setattr(lib, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    g = torch.Generator(device=dev).manual_seed(3)
    for dtype, want, body in [
            ("bfloat16", "cubecl_matmul", "gemm16_wgmma_kernel"),
            ("float16", "cubecl_matmul", "gemm16_wgmma_kernel"),
            ("float32", "cubecl_matmul", "gemm_tf32x3_kernel"),
            ("float8_e4m3fn", "cubecl_matmul8", "gemm8_wgmma_kernel"),
            ("int8", "cubecl_matmul8", "gemm8_wgmma_kernel")]:
        a = _mm_operand(g, dev, dtype, (256, 256), 256)
        b = _mm_operand(g, dev, dtype, (256, 256), 256)
        o = torch.empty(256, 256, device=dev,
                        dtype=torch.int32 if dtype == "int8"
                        else torch.float32)
        for tile in mm._tile_candidates(256, 256, 256, mm._itemsize(dtype)):
            calls.clear()
            ran = _kernels_run(lambda: mm._gemm(a, b, o, tile, False,
                                                counter=mm.matmul_pallas))
            assert calls == [want], (dtype, calls)
            assert any(body in k for k in ran), (dtype, tile, ran)
            assert not any("mma_gemm_kernel" in k or "fma_gemm" in k
                           for k in ran), ran
            assert any("f32_transpose_kernel" in k for k in ran) == (
                dtype == "float32"), ran
    for dtype, body in [(torch.bfloat16, "expert_wgmma_kernel"),
                        (torch.float32, "expert_fma_kernel")]:
        xg = torch.zeros(2, 64, 256, dtype=dtype, device=dev)
        w = torch.zeros(2, 256, 128, dtype=dtype, device=dev)
        calls.clear()
        ran = _kernels_run(lambda: moe.expert_matmul(
            xg, w, torch.tensor([64, 3], dtype=torch.int32, device=dev)))
        assert calls == ["cubecl_expert_matmul"]
        assert any(body in k for k in ran), (dtype, ran)
        assert not any("expert_mma_kernel" in k for k in ran), ran
    a8 = torch.zeros(256, 256, dtype=torch.float8_e4m3fn, device=dev)
    o = torch.empty(256, 256, device=dev)
    torch.cuda.synchronize()
    rc = lib.cubecl_matmul(a8.data_ptr(), a8.data_ptr(), o.data_ptr(), None,
                           None, None, native.DTYPE_CODES[a8.dtype],
                           native.DTYPE_CODES[o.dtype], 256, 256, 256, 128,
                           128, 128, 1, 0, 1.0,
                           torch.cuda.current_stream().cuda_stream)
    assert rc == 1  # cudaErrorInvalidValue: no 8-bit instance there


def test_matmul_graph_replay_equals_eager(dev):
    """A captured M1 launch, replayed as a CUDA graph, writes what the
    eager launch writes; the capture counts its warm launch only (not the
    recording), and a replay does not count as a launch."""
    from cubecl_tpu_torch.ops import matmul as mm

    c = CudaRuntime.client()
    g = torch.Generator(device=dev).manual_seed(1)
    a = c.create(_mm_operand(g, dev, "bfloat16", (512, 256), 256))
    b = c.create(_mm_operand(g, dev, "bfloat16", (256, 512), 256))
    eager, o = c.empty((512, 512), "float32"), c.empty((512, 512), "float32")
    mm.matmul_pallas(c, a, b, eager, 512, 512, 256)
    n = mm.matmul_pallas.launches
    graph = c.capture(mm.matmul_pallas, c, a, b, o, 512, 512, 256)
    assert mm.matmul_pallas.launches == n + 1
    n += 1
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert mm.matmul_pallas.launches == n
    assert torch.equal(o.tensor, eager.tensor)


def test_matmul_tuner_on_the_card(dev, monkeypatch, tmp_path):
    """matmul_autotuned on the card: every candidate timed through its
    CUDA graph (finite, positive, not below half the roofline bound), the
    winner one of them, the output the plain version's."""
    from cubecl_tpu_torch.ops import matmul as mm

    monkeypatch.setenv("CUBECL_ENVIRONMENT_ROOT", str(tmp_path))
    c = CudaRuntime.client()
    g = torch.Generator(device=dev).manual_seed(2)
    m, n, k = 1024, 768, 512
    a = c.create(_mm_operand(g, dev, "bfloat16", (m, k), k))
    b = c.create(_mm_operand(g, dev, "bfloat16", (k, n), k))
    o = c.empty((m, n), "float32")
    best = mm.autotune_best_tile(c, a, b, o, m, n, k)
    key = mm._tune_key(m, n, k, "bfloat16", "float32")
    times = mm._matmul_tuner.tuner_for(
        c, key, mm.matmul_tunables(m, n, k, "bfloat16", "float32")
    ).cache.timings(key)
    bound = 2 * m * n * k / 989e12
    assert times and all(math.isfinite(t) and t > 0.5 * bound
                         for t in times.values())
    assert f"t{best[0]}x{best[1]}x{best[2]}" in times
    _close(o.tensor, mm.matmul_plain(a.tensor, b.tensor, torch.float32))


CMMA_SHAPES = [(256, 256, 128), (4096, 1024, 2048)]
CMMA_16 = [torch.bfloat16, torch.float16]


def _cmma_operands(dev, dtype, M, N, K, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = (torch.randn(M, K, generator=g, device=dev) * K ** -0.25).to(dtype)
    b = (torch.randn(K, N, generator=g, device=dev) * K ** -0.25).to(dtype)
    return a, b


@pytest.mark.parametrize("shape", CMMA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32] + CMMA_16)
def test_cmma_kernel_matches_evaluator(dev, dtype, shape):
    """K0 cmma (``matmul_cmma``) against the torch evaluator on the card
    and against plain, at f32 (the 3xTF32 route at the tk-32 plan: three
    TF32 ``wgmma`` a k8 step from the split K-major operand fragments)
    and bf16/f16 (the tensor-core route at the tk-64 plan: ``wgmma`` from
    the swizzled operand fragments), the accumulator in registers, f32 out
    at TOL's 2e-5/1e-4 for all three."""
    from cubecl_tpu_torch.ops import matmul as mm

    M, N, K = shape
    a, b = _cmma_operands(dev, dtype, M, N, K)
    outs = []
    for c in (CudaRuntime.client(), eval_client(dev)):
        o = c.empty((M * N,), "float32")
        mm.matmul_cmma(c, c.create(a.reshape(-1)), c.create(b.reshape(-1)),
                       o, M, N, K)
        outs.append(o.tensor.view(M, N))
    torch.cuda.synchronize()
    src = CudaRuntime.client().server.last_launched.source
    f32 = dtype == torch.float32
    assert ("mapping=cmma-wgmma-tf32x3 " in src) == f32
    assert ("mapping=cmma-wgmma " in src) == (not f32)
    assert mm._cmma_plan(M, N, K, dtype.itemsize, 128) == (
        128, 128, 32 if f32 else 64)
    _close(outs[0], outs[1])
    _close(outs[0], mm.matmul_plain(a, b, torch.float32))


@pytest.mark.parametrize("shape", [(512, 512, 512), (4096, 1024, 2048),
                                   (4096, 4096, 4096)])
@pytest.mark.parametrize("dtype", CMMA_16)
def test_cmma_16_bit_every_launch_of_many_agrees(dev, dtype, shape):
    """The tensor-core route in 200 launches, each held to plain on an
    output first filled with NaN: a race between the copies of the ring
    and the products that read it (F11's kind) shows in few launches of
    many, not in one."""
    from cubecl_tpu_torch.ops import matmul as mm

    M, N, K = shape
    a, b = _cmma_operands(dev, dtype, M, N, K, seed=M + K)
    want = mm.matmul_plain(a, b, torch.float32)
    c = CudaRuntime.client()
    ha, hb = c.create(a.reshape(-1)), c.create(b.reshape(-1))
    o = c.empty((M * N,), "float32")
    atol, rtol = TOL[torch.float32]
    bad = []
    for i in range(200):
        o.tensor.fill_(float("nan"))
        mm.matmul_cmma(c, ha, hb, o, M, N, K)
        err = (o.tensor.view(M, N) - want).abs()
        if not bool((err <= atol + rtol * want.abs()).all()):
            bad.append(i)
    torch.cuda.synchronize()
    assert not bad, f"launches {bad} disagree with plain"


@pytest.mark.parametrize("dtype", CMMA_16)
def test_cmma_16_bit_sass_issues_hgmma(dev, dtype, tmp_path):
    """The K0 cmma library of a 16-bit ``matmul_cmma`` issues HGMMA (the
    SASS of ``wgmma``) and no FFMA in ``cuobjdump -sass``, and ptxas
    spills nothing (its source built again with the K0 flags: the library
    may be an earlier build's, which kept no log)."""
    import os
    import subprocess

    from cubecl_tpu_torch.backend.cuda.build import NVCC_FLAGS
    from cubecl_tpu_torch.ops import matmul as mm
    from cubecl_tpu_torch.utils.native import find_nvcc

    M = N = K = 512
    a, b = _cmma_operands(dev, dtype, M, N, K)
    c = CudaRuntime.client()
    mm.matmul_cmma(c, c.create(a.reshape(-1)), c.create(b.reshape(-1)),
                   c.empty((M * N,), "float32"), M, N, K)
    torch.cuda.synchronize()
    build = c.server.last_launched.fn.build
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    assert "HGMMA" in sass and "FFMA" not in sass
    log = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o",
                          str(tmp_path / "again.so"), build.source_path],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert "0 bytes spill stores, 0 bytes spill loads" in log.stdout + \
        log.stderr


@pytest.mark.parametrize("shape", [(512, 512, 512), (4096, 1024, 2048)])
def test_cmma_f32_every_launch_of_many_agrees(dev, shape):
    """The 3xTF32 route in 200 launches, each held to plain (full f32) at
    f32's 2e-5/1e-4 on an output first filled with NaN: its ring is filled
    by stores issued while the previous step's products run, so a missing
    barrier or fence would show in few launches of many."""
    from cubecl_tpu_torch.ops import matmul as mm

    M, N, K = shape
    a, b = _cmma_operands(dev, torch.float32, M, N, K, seed=M + K + 1)
    want = mm.matmul_plain(a, b, torch.float32)
    c = CudaRuntime.client()
    ha, hb = c.create(a.reshape(-1)), c.create(b.reshape(-1))
    o = c.empty((M * N,), "float32")
    atol, rtol = TOL[torch.float32]
    bad = []
    for i in range(200):
        o.tensor.fill_(float("nan"))
        mm.matmul_cmma(c, ha, hb, o, M, N, K)
        err = (o.tensor.view(M, N) - want).abs()
        if not bool((err <= atol + rtol * want.abs()).all()):
            bad.append(i)
    torch.cuda.synchronize()
    assert "mapping=cmma-wgmma-tf32x3" in c.server.last_launched.source
    assert not bad, f"launches {bad} disagree with plain"


def test_cmma_f32_sass_issues_tf32_hgmma(dev, tmp_path):
    """The K0 cmma library of an f32 ``matmul_cmma`` issues HGMMA with
    TF32 operands (the SASS of ``wgmma`` .tf32) and no FFMA in ``cuobjdump
    -sass`` (no product runs on the CUDA cores), and ptxas spills nothing
    (its source built again with the K0 flags)."""
    import os
    import subprocess

    from cubecl_tpu_torch.backend.cuda.build import NVCC_FLAGS
    from cubecl_tpu_torch.ops import matmul as mm
    from cubecl_tpu_torch.utils.native import find_nvcc

    M = N = K = 512
    a, b = _cmma_operands(dev, torch.float32, M, N, K)
    c = CudaRuntime.client()
    mm.matmul_cmma(c, c.create(a.reshape(-1)), c.create(b.reshape(-1)),
                   c.empty((M * N,), "float32"), M, N, K)
    torch.cuda.synchronize()
    build = c.server.last_launched.fn.build
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    gmma = [ln for ln in sass.splitlines() if "HGMMA" in ln]
    assert gmma and all("TF32" in ln for ln in gmma), gmma[:4]
    assert "FFMA" not in sass
    log = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o",
                          str(tmp_path / "again.so"), build.source_path],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert "0 bytes spill stores, 0 bytes spill loads" in log.stdout + \
        log.stderr


@pytest.mark.parametrize("name", ["loaded", "c_not_d"])
def test_cmma_shared_memory_accumulator_on_the_card(dev, name):
    """The tensor-core route with its accumulator in shared memory (a
    loaded accumulator; a C other than D): A B + C on 64 x 64 x 64 bf16
    fragments in a cube of one warpgroup, against the evaluator on the
    card and against the f32 product (small integers: exact)."""
    from test_torch_dsl_printer import ACC_KERNELS, acc_args

    g = torch.Generator(device=dev).manual_seed(7)
    a, b, cc = (torch.randint(-3, 4, (4096,), generator=g, device=dev)
                .float() for _ in range(3))
    k = ACC_KERNELS[name]
    outs = []
    for c in (CudaRuntime.client(), eval_client(dev)):
        o = c.empty((4096,), "float32")
        k.launch_unchecked(c, 1, 128, *acc_args(
            c.create(a.bfloat16()), c.create(b.bfloat16()), c.create(cc), o))
        outs.append(o.tensor.view(64, 64))
    torch.cuda.synchronize()
    assert "mapping=cmma-wgmma" in CudaRuntime.client().server.last_launched \
        .source
    want = a.view(64, 64) @ b.view(64, 64) + (
        cc.view(64, 64) if name == "loaded" else 0.25)
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)


@pytest.mark.parametrize("n", [1 << 16, 4096 * 4096, 8 * 1009,
                               4096 * 4096 + 8 * 1009])
def test_quant_kernels_match_plain(dev, n):
    """The K0 quantize kernels on the card (one per-tensor scale: the two
    passes over many cubes; at 4096^2, 1024 cubes each, and at ragged
    sizes whose last chunk is cut short) give the evaluator's int8 values
    and scales and the plain version's, bit for bit, with the absmax in
    the first and in the last chunk too; two launches a call."""
    from cubecl_tpu_torch.std.quant import QuantScheme
    from cubecl_tpu_torch.std.quant_kernels import quantize, quantize_plain

    x = torch.randn(n, generator=torch.Generator(device=dev)
                    .manual_seed(4), device=dev) * 3
    cu = CudaRuntime.client()
    for spike in (None, (0, -50.0), (n - 1, 60.0)):
        if spike is not None:
            x[spike[0]] = spike[1]
        cu.server.reset_counts()
        got = [quantize(c, c.create(x), QuantScheme())
               for c in (cu, eval_client(dev))]
        torch.cuda.synchronize()
        assert dict(cu.server.launches) == {"quantize_tensor_absmax": 1,
                                            "quantize_tensor_values": 1}
        pv, ps = quantize_plain(x, QuantScheme())
        for want in (got[1], (pv, ps)):
            v, s = (t if isinstance(t, torch.Tensor) else t.tensor
                    for t in want)
            assert torch.equal(got[0][0].tensor, v)
            assert torch.equal(got[0][1].tensor, s)


@pytest.mark.parametrize("n,block", [
    (4096 * 4096, 4096), (4096 * 4096, 2048), (2048 * 1001, 2048),
    (8072 * 37, 8072), (4096 * 4096, None), (4096 * 4096 + 8 * 1009, None)],
    ids=["4096^2-4096", "4096^2-2048", "ragged-2048", "lines-of-1-8072",
         "tensor-4096^2", "tensor-ragged"])
def test_quant_block_and_dequantize_kernels_match_plain(dev, n, block):
    """The block quantize (a cube a block, the planes' maxima through a
    shared array; ragged: 1001 blocks of 2048, blocks of 8072 that the
    units' last step overruns) and the dequantize at both levels (one
    launch of ``dequantize_chunk_kernel`` over chunks cut at the tensor's
    end) give the evaluator's bits and the plain version's, with the
    absmax in a block's first and last element and an all-zero block;
    one launch a call, counted by kernel name."""
    from cubecl_tpu_torch.std.quant import QuantLevel, QuantScheme
    from cubecl_tpu_torch.std.quant_kernels import (dequantize,
                                                    dequantize_plain,
                                                    quantize, quantize_plain)

    scheme = QuantScheme() if block is None else QuantScheme(
        level=QuantLevel.BLOCK, block_size=block)
    x = torch.randn(n, generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev) * 3
    if block is not None:
        x[block] = -50.0
        x[3 * block - 1] = 60.0
        x[4 * block:5 * block] = 0
    cu, ev = CudaRuntime.client(), eval_client(dev)
    cu.server.reset_counts()
    vals, scales = quantize(cu, cu.create(x), scheme)
    torch.cuda.synchronize()
    if block is not None:
        assert dict(cu.server.launches) == {"quantize_block_kernel": 1}
        assert scales.tensor[4].item() == np.float32(1e-12)
    pv, ps = quantize_plain(x, scheme)
    ev_v, ev_s = quantize(ev, ev.create(x), scheme)
    for want in ((pv, ps), (ev_v.tensor, ev_s.tensor)):
        assert torch.equal(vals.tensor, want[0])
        assert torch.equal(scales.tensor, want[1])
    cu.server.reset_counts()
    back = dequantize(cu, vals, scales, scheme)
    torch.cuda.synchronize()
    assert dict(cu.server.launches) == {"dequantize_chunk_kernel": 1}
    assert torch.equal(back.tensor, dequantize_plain(pv, ps, scheme))
    assert torch.equal(back.tensor, dequantize(
        ev, ev.create(vals.tensor), ev.create(scales.tensor), scheme).tensor)


@cube
def _shared_lines(x: Slice, out: MutSlice, units: int):
    sh = SharedMemory.new(i32, units, 4)
    first = SharedMemory.new(i32, 1, 4)
    i = CUBE_POS_X * units + UNIT_POS
    sh[UNIT_POS] = x[i]
    if UNIT_POS == 0:
        first[0] = x[i] * 3
    sync_cube()
    out[i] = sh[units - 1 - UNIT_POS] + sh[UNIT_POS] + first[0]


@pytest.mark.parametrize("cubes,units", [(5, 32), (1000, 256)])
def test_shared_arrays_match_the_evaluator(dev, cubes, units):
    """K0's shared arrays on the card (static ``__shared__``, each cube its
    own): a cube's lines reversed through one array and its first unit's
    line through another, across a barrier, equal the evaluator's and
    torch's."""
    n = cubes * units * 4
    x = torch.randint(-1000, 1000, (n,), generator=torch.Generator(
        device=dev).manual_seed(9), device=dev, dtype=torch.int32)
    outs = []
    for c in (CudaRuntime.client(), eval_client(dev)):
        o = c.empty((n,), "int32")
        _shared_lines.launch_unchecked(
            c, cubes, units, ArrayArg(c.create(x), line_size=4),
            ArrayArg(o, line_size=4, mutable=True), units)
        outs.append(o.tensor)
    torch.cuda.synchronize()
    lines = x.view(cubes, units, 4)
    want = (lines.flip(1) + lines + 3 * lines[:, :1]).reshape(-1)
    assert "__shared__" in CudaRuntime.client().server.last_launched.source
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)


# -- slice 6: R1, K0's block_reduce and reinterpret, reductions, fusion ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,br", [(1 << 14, 512), (128 * 1000, 64),
                                  (128 * 24, 8), (1 << 22, 4096)])
def test_reduce_native_kernel_matches_plain(dev, dtype, n, br):
    """R1 (csrc/reduce.cu) at the JAX test's (n, block_rows) and a larger
    n: within 1e-5 * sum|x| of the float64 sum and of the plain version,
    one counted launch a call, the same bits on a second call (no
    atomics)."""
    from cubecl_tpu_torch.ops import reduce as R

    c = CudaRuntime.client()
    g = torch.Generator(device=dev).manual_seed(n + br)
    x = torch.randn(n, generator=g, device=dev).to(dtype)
    k = R.reduce_sum_native.launches
    got = R.reduce_sum_native(c, c.create(x), block_rows=br).tensor
    torch.cuda.synchronize()
    assert R.reduce_sum_native.launches == k + 1
    assert got.dtype == torch.float32 and got.shape == (1,)
    scale = x.double().abs().sum().item()
    assert abs(got.double().item() - x.double().sum().item()) <= 1e-5 * scale
    plain = R.reduce_sum_native_plain(x)
    assert abs(got.item() - plain.item()) <= 1e-5 * scale
    again = R.reduce_sum_native(c, c.create(x), block_rows=br).tensor
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_native_grid_stride(dev, dtype):
    """R1 with more chunks than blocks: 128 * 8 * 2048 elements at
    block_rows 8 make 2048 chunks over 1024 blocks, two a block. Zero-mean
    input against the float64 sum at 1e-8 * sum|x| (about 0.017, above f32
    rounding here and below one dropped 1024-element chunk's sum, whose
    standard deviation is 32)."""
    from cubecl_tpu_torch.ops import reduce as R

    n, br = 128 * 8 * 2048, 8
    assert -(-n // (br * 128)) > R.MAX_BLOCKS
    c = CudaRuntime.client()
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev).to(dtype)
    got = R.reduce_sum_native(c, c.create(x), block_rows=br).tensor
    torch.cuda.synchronize()
    xd = x.double()
    assert abs(got.double().item() - xd.sum().item()) <= \
        1e-8 * xd.abs().sum().item()


def test_reduce_native_graph_replay_equals_eager(dev):
    """A captured R1 call allocates nothing in the graph (the wrapper
    allocated its workspace before), replays to the eager bits, and
    counts its warm launch only."""
    from cubecl_tpu_torch.ops import reduce as R

    c = CudaRuntime.client()
    x = c.create(torch.randn(1 << 20, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev))
    eager = R.reduce_sum_native(c, x, block_rows=1024).tensor.clone()
    k = R.reduce_sum_native.launches
    outs = []
    graph = c.capture(lambda: outs.append(R.reduce_sum_native(
        c, x, block_rows=1024)))
    assert R.reduce_sum_native.launches == k + 1
    outs[0].tensor.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert R.reduce_sum_native.launches == k + 1
    assert torch.equal(outs[0].tensor, eager)


@cube
def _block_kinds_k(inp: Slice, out: MutSlice, lines: int):
    out[CUBE_POS_X * 4] = inp.block_sum(CUBE_POS_X * lines, lines)
    out[CUBE_POS_X * 4 + 1] = inp.block_max(CUBE_POS_X * lines, lines)
    out[CUBE_POS_X * 4 + 2] = inp.block_min(CUBE_POS_X * lines, lines)
    out[CUBE_POS_X * 4 + 3] = inp.block_prod(CUBE_POS_X * lines, lines)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cd", [1, 8, 32, 256])
def test_block_reduce_matches_evaluator(dev, dtype, cd):
    """mem.block_reduce printed by K0 (sum, max, min, prod over each
    cube's window, in cubes of 1, 8, 32 and 256 units) against the torch
    evaluator on the card; reduce_sum_blockwise against it and the
    float64 sum."""
    from cubecl_tpu_torch.ops import reduce as R

    g = torch.Generator(device=dev).manual_seed(cd)
    x = (torch.rand(6 * 40 * 4, generator=g, device=dev) * 0.04 + 0.98) \
        .to(dtype)
    outs = []
    for c in (CudaRuntime.client(), eval_client(dev)):
        o = c.empty((24,), str(dtype).replace("torch.", ""))
        _block_kinds_k.launch_unchecked(c, 6, cd, ArrayArg(c.create(x),
                                                           line_size=4),
                                        ArrayArg(o, mutable=True), 40)
        outs.append(o.tensor)
    torch.cuda.synchronize()
    got, want = outs[0].view(6, 4), outs[1].view(6, 4)
    _close(got[:, 1:3], want[:, 1:3])
    assert torch.equal(got[:, 1:3], want[:, 1:3])  # max, min: exact
    _close(got[:, 0], want[:, 0])
    torch.testing.assert_close(got[:, 3].float(), want[:, 3].float(),
                               rtol=1e-4 if dtype == torch.float32
                               else 1e-2, atol=0)
    xs = torch.randn(1 << 18, generator=g, device=dev).to(dtype)
    sums = [R.reduce_sum_blockwise(c, c.create(xs), cubes=32).tensor
            for c in (CudaRuntime.client(), eval_client(dev))]
    torch.cuda.synchronize()
    scale = xs.double().abs().sum().item()
    for s in sums:
        assert abs(s.double().item() - xs.double().sum().item()) <= \
            1e-5 * scale
    if cd != 256:
        return
    # 64M in the split plan: 32 windows of 32 sub-windows each, on
    # 1024 cubes of 256 units, the same bits on a second call. f32 within
    # 1e-8 * sum|x| (chip_smoke.py's SUM_TOL) of the float64 sum; bf16
    # within the 1e-5 above, as block_sum returns the buffer's type: each
    # bf16 partial is rounded, by half an ulp, at most 2^-8 of it. So each
    # of the 1024 sub-partials is held too: to the float64 sum of its
    # sub-window and to the evaluator's partial at the same plan on the
    # card, within that rounding and 1e-6 * sum|x| of the sub-window (a
    # dropped line of 128 or a doubled cube is far outside it); and the
    # fold to the float64 sum of the partials, within 1e-6 * sum|p|
    big = torch.randn(64 << 20, generator=g, device=dev).to(dtype)
    c, ev = CudaRuntime.client(), eval_client(dev)
    h = c.create(big)
    first = R.reduce_sum_blockwise(c, h, cubes=32).tensor.clone()
    again = R.reduce_sum_blockwise(c, h, cubes=32).tensor
    windows, split, lines = R.block_plan((64 << 20) // 128, 128, 32)
    assert (windows, split, lines) == (32, 32, 512)
    parts = []
    for cl, hh in ((c, h), (ev, ev.create(big))):
        p = cl.empty((windows * split,), "float32")
        R.reduce_block_partial.launch_unchecked(
            cl, windows * split, R.BLOCK_UNITS, ArrayArg(hh, line_size=128),
            ArrayArg(p, mutable=True), lines)
        parts.append(p.tensor.double())
    torch.cuda.synchronize()
    part = [k for k in c.server._cache.values()
            if k.name == "reduce_block_partial" and k.grid == (1024, 1, 1)]
    assert part and part[0].block == (256, 1, 1)
    bd = big.double()
    assert abs(first.double().item() - bd.sum().item()) <= \
        (1e-8 if dtype == torch.float32 else 1e-5) * bd.abs().sum().item()
    assert torch.equal(first, again)
    got, want_ev = parts
    sub = bd.view(windows * split, -1)
    rnd = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    lim = 1e-6 * sub.abs().sum(1)
    assert ((got - sub.sum(1)).abs() <= rnd * got.abs() + lim).all()
    assert ((got - want_ev).abs()
            <= rnd * (got.abs() + want_ev.abs()) + lim).all()
    assert abs(first.double().item() - got.sum().item()) <= \
        1e-6 * got.abs().sum().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_routes_match_evaluator(dev, dtype):
    """reduce_sum, reduce_max and reduce_mean (the 8-unit K0 tree) on the
    card against the torch evaluator on the card; max exact."""
    from cubecl_tpu_torch.ops import reduce as R

    x = torch.randn(1 << 20, generator=torch.Generator(device=dev)
                    .manual_seed(6), device=dev).to(dtype)
    res = []
    for c in (CudaRuntime.client(), eval_client(dev)):
        h = c.create(x)
        res.append([f(c, h).tensor for f in (R.reduce_sum, R.reduce_max,
                                             R.reduce_mean)])
    torch.cuda.synchronize()
    (s, m, mu), (es, em, emu) = res
    scale = x.double().abs().sum().item()
    assert abs(s.item() - es.item()) <= 1e-5 * scale
    assert torch.equal(m, em) and m.item() == x.max().item()
    assert abs(mu.item() - emu.item()) <= 1e-5 * scale / x.numel()


def test_reduce_autotuned_on_the_card(dev, monkeypatch, tmp_path):
    """reduce_sum_autotuned: each of the ten candidates timed through its
    CUDA graph (finite, not below half the bytes bound), the winner's sum
    within 1e-5 * sum|x|, and a second call runs the winner untimed."""
    from cubecl_tpu_torch.ops import reduce as R
    from cubecl_tpu_torch.tune import Tuner

    monkeypatch.setenv("CUBECL_ENVIRONMENT_ROOT", str(tmp_path))
    c = CudaRuntime.client()
    n = 1 << 22
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev)
    h = c.create(x)
    got = R.reduce_sum_autotuned(c, h).tensor
    torch.cuda.synchronize()
    scale = x.double().abs().sum().item()
    assert abs(got.double().item() - x.double().sum().item()) <= 1e-5 * scale
    key = str(("sum", n, "float32"))
    tuner = next(t for (_f, k, _c), t in R._sum_tuner._tuners.items()
                 if k == key)
    times = tuner.cache.timings(key)
    assert len(times) == 10 and all(
        math.isfinite(t) and t > 0.5 * n * 4 / 3.35e12
        for t in times.values())
    monkeypatch.setattr(Tuner, "_tune", None)
    again = R.reduce_sum_autotuned(c, h).tensor
    torch.cuda.synchronize()
    assert torch.equal(again, got)


def test_fused_chain_matches_evaluator(dev):
    """launch_fused for relu((a + b) * c) and add -> gelu on the card: one
    K0 launch each, against the evaluator on the card and plain."""
    from cubecl_tpu_torch.ops import fusion as FU

    g = torch.Generator(device=dev).manual_seed(8)
    xs = [torch.randn(1 << 16, generator=g, device=dev) for _ in range(3)]
    for ops, k, plain in ((["add", "mul", "relu"], 3,
                           torch.relu((xs[0] + xs[1]) * xs[2])),
                          (["add", "gelu"], 2, torch.nn.functional.gelu(
                              xs[0] + xs[1]))):
        outs = []
        for c in (CudaRuntime.client(), eval_client(dev)):
            o = c.empty((1 << 16,), "float32")
            n = c.server.launches["fused_chain"]
            FU.launch_fused(c, [c.create(t) for t in xs[:k]], o, ops)
            assert c.server.launches["fused_chain"] == n + 1
            outs.append(o.tensor)
        torch.cuda.synchronize()
        _close(outs[0], outs[1])
        _close(outs[0], plain)


def test_std_kernels_on_the_card(dev):
    """into_contiguous through _copy_permuted on a strided 3-D view,
    identity, and reinterpret_slice (f32 bits as i32 and as u8) on K0."""
    from cubecl_tpu_torch import std as S
    from cubecl_tpu_torch.ir.types import i32, u8
    from cubecl_tpu_torch.std.misc import reinterpret_slice

    c = CudaRuntime.client()
    x = torch.arange(4 * 6 * 5, dtype=torch.float32, device=dev)
    t = S.TensorHandle(c.create(x), (4, 3, 5), strides=(30, 10, 1))
    got = S.into_contiguous(c, t)
    want = x.view(4, 6, 5)[:, ::2, :].reshape(-1)
    eye = S.identity(c, 33)
    torch.cuda.synchronize()
    assert torch.equal(got.handle.tensor, want)
    assert torch.equal(eye.tensor.view(33, 33), torch.eye(33, device=dev))

    @cube
    def as_i32(inp: Slice, out: MutSlice):
        v = reinterpret_slice(inp, i32)
        out[ABSOLUTE_POS] = v[ABSOLUTE_POS]

    @cube
    def as_u8(inp: Slice, out: MutSlice):
        v = reinterpret_slice(inp, u8)
        out[ABSOLUTE_POS] = v[ABSOLUTE_POS]

    f = torch.randn(256, generator=torch.Generator(device=dev)
                    .manual_seed(9), device=dev)
    oi = c.empty((256,), "int32")
    as_i32.launch_unchecked(c, 1, 256, ArrayArg(c.create(f)),
                            ArrayArg(oi, mutable=True))
    ou = c.empty((1024,), "uint8")
    as_u8.launch_unchecked(c, 1, 256, ArrayArg(c.create(f)),
                           ArrayArg(ou, line_size=4, mutable=True))
    torch.cuda.synchronize()
    assert torch.equal(oi.tensor, f.view(torch.int32))
    assert torch.equal(ou.tensor, f.view(torch.uint8))


# -- E1 (csrc/expert_matmul.cu) and S1 (csrc/selective_scan.cu) ---------------


# E1's card cases: (E, cap, d, f, counts)
_E1_CASES = {
    # counts of cap, 0, a ragged count and one row; a capacity of 200 is
    # no multiple of either tile
    "ragged_cap": (4, 200, 256, 384, [200, 0, 130, 1]),
    "cap256": (4, 256, 256, 384, [256, 0, 130, 1]),
    # a decode step's few live rows, at the decode shape's capacity, and a
    # d that leaves a zero-filled half stage of K
    "decode": (4, 2560, 96, 384, [2, 0, 3, 1]),
    # eight experts with every row live: enough tiles for the wide
    # 128 x 256 tile (f a multiple of 256)
    "all_at_cap": (8, 2048, 256, 1024, [2048] * 8),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(_E1_CASES))
def test_expert_matmul_kernel_matches_plain(dev, dtype, case):
    """Live rows only (the rest are undefined), for each of _E1_CASES."""
    from cubecl_tpu_torch.ops import moe

    E, cap, d, f, counts = _E1_CASES[case]
    g = torch.Generator(device=dev).manual_seed(cap)
    xg = (torch.randn(E, cap, d, generator=g, device=dev) * .2).to(dtype)
    w = (torch.randn(E, d, f, generator=g, device=dev) * .2).to(dtype)
    c = torch.tensor(counts, dtype=torch.int32, device=dev)
    n = moe.expert_matmul.launches
    got = moe.expert_matmul(xg, w, c)
    torch.cuda.synchronize()
    assert moe.expert_matmul.launches == n + 1
    assert got.shape == (E, cap, f) and got.dtype == dtype
    ref = moe.expert_matmul_plain(xg, w, c)
    for e, k in enumerate(counts):
        _close(got[e, :k], ref[e, :k])


def test_expert_matmul_wide_and_narrow_tiles_on_ragged_counts(dev):
    """The bf16 kernel's two tiles on ragged counts: the same inputs with
    f 1024 (its live tiles fill the card: the wide 128 x 256 tile) and
    f 384 (no multiple of 256: 128 x 128), live rows against plain; a d of
    96 leaves a zero-filled half stage."""
    from cubecl_tpu_torch.ops import moe

    g = torch.Generator(device=dev).manual_seed(11)
    counts = [2000, 0, 1999, 2560, 1, 130, 2048, 777]
    c = torch.tensor(counts, dtype=torch.int32, device=dev)
    xg = (torch.randn(8, 2560, 96, generator=g, device=dev) * .2).to(
        torch.bfloat16)
    for f in (1024, 384):
        w = (torch.randn(8, 96, f, generator=g, device=dev) * .2).to(
            torch.bfloat16)
        got = moe.expert_matmul(xg, w, c)
        ref = moe.expert_matmul_plain(xg, w, c)
        for e, k in enumerate(counts):
            _close(got[e, :k], ref[e, :k])


def test_expert_matmul_never_syncs_with_the_host(dev):
    """E1's path reads the counts on the device only: under
    torch.cuda.set_sync_debug_mode("error") a call that synchronized with
    the host would raise. Both dtypes; the weights' tensor map is then
    taken from the kernel's cache on the second call."""
    from cubecl_tpu_torch.ops import moe

    g = torch.Generator(device=dev).manual_seed(5)
    for dtype in (torch.bfloat16, torch.float32):
        xg = (torch.randn(4, 256, 256, generator=g, device=dev) * .2).to(
            dtype)
        w = (torch.randn(4, 256, 384, generator=g, device=dev) * .2).to(
            dtype)
        c = torch.tensor([256, 0, 130, 1], dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [moe.expert_matmul(xg, w, c) for _ in range(2)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref = moe.expert_matmul_plain(xg, w, c)
        for got in outs:
            for e, k in enumerate([256, 0, 130, 1]):
                _close(got[e, :k], ref[e, :k])


def test_expert_matmul_kernel_refuses_other_shapes(dev):
    from cubecl_tpu_torch.ops import moe

    xg = torch.zeros(2, 64, 256, dtype=torch.bfloat16, device=dev)
    counts = torch.tensor([64, 3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=r"\(d, f\) = \(256, 200\)"):
        moe.expert_matmul(xg, torch.zeros(2, 256, 200, dtype=torch.bfloat16,
                                          device=dev), counts)
    with pytest.raises(ValueError, match=r"\(d, f\) = \(72, 128\)"):
        moe.expert_matmul(xg[..., :72].contiguous(),
                          torch.zeros(2, 72, 128, dtype=torch.bfloat16,
                                      device=dev), counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,DN", [(1, 1, 128), (2, 37, 100), (3, 64, 33),
                                    (1, 300, 4099)])
def test_selective_scan_kernel_matches_plain(dev, dtype, B, L, DN):
    from cubecl_tpu_torch.ops import ssm

    g = torch.Generator(device=dev).manual_seed(L * DN)
    af = (torch.exp(-torch.rand(B, L, DN, generator=g, device=dev)) * .9
          ).to(dtype)
    uf = (torch.randn(B, L, DN, generator=g, device=dev) * .1).to(dtype)
    n = ssm.scan_chunked_core.launches
    got = ssm.scan_chunked_core(af, uf)
    torch.cuda.synchronize()
    assert ssm.scan_chunked_core.launches == n + 1
    assert got.dtype == dtype
    _close(got, ssm.scan_chunked_core_plain(af, uf))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,DN", [(1, 1, 128), (2, 37, 100), (3, 64, 33),
                                    (1, 300, 4099), (2, 8, 24576)])
def test_selective_scan_backward_kernel_matches_plain(dev, dtype, B, L, DN):
    """S1's reverse scan (``scan_bwd_kernel``) against
    ``scan_chunked_core_backward_plain`` on the kernel forward's own h, and
    through the autograd Function of ``scan_chunked_core``: one forward
    and one backward launch, the grads the wrapper's."""
    from cubecl_tpu_torch.ops import ssm

    g = torch.Generator(device=dev).manual_seed(L * DN + 1)
    af = (torch.exp(-torch.rand(B, L, DN, generator=g, device=dev)) * .9
          ).to(dtype)
    uf = (torch.randn(B, L, DN, generator=g, device=dev) * .1).to(dtype)
    dh = (torch.randn(B, L, DN, generator=g, device=dev) * .1).to(dtype)
    h = ssm.scan_chunked_core(af, uf)
    n = ssm.scan_chunked_core_backward.launches
    da, du = ssm.scan_chunked_core_backward(af, h, dh)
    torch.cuda.synchronize()
    assert ssm.scan_chunked_core_backward.launches == n + 1
    assert da.dtype == du.dtype == dtype
    ref_da, ref_du = ssm.scan_chunked_core_backward_plain(af, h, dh)
    _close(da, ref_da)
    _close(du, ref_du)
    assert not da[:, 0].any()
    leaves = [t.clone().requires_grad_() for t in (af, uf)]
    n = (ssm.scan_chunked_core.launches,
         ssm.scan_chunked_core_backward.launches)
    out = ssm.scan_chunked_core(*leaves)
    out.backward(dh)
    torch.cuda.synchronize()
    assert (ssm.scan_chunked_core.launches,
            ssm.scan_chunked_core_backward.launches) == (n[0] + 1, n[1] + 1)
    assert torch.equal(out.detach(), h)
    assert torch.equal(leaves[0].grad, da)
    assert torch.equal(leaves[1].grad, du)


def test_selective_scan_backward_refuses_other_inputs(dev):
    from cubecl_tpu_torch.ops import ssm

    af = torch.rand(2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        ssm.scan_chunked_core_backward(af, af, af.double())
    with pytest.raises(ValueError, match="one shape"):
        ssm.scan_chunked_core_backward(af, af, af[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        ssm.scan_chunked_core_backward(af, af.transpose(1, 2).contiguous()
                                       .transpose(1, 2), af)


def test_moe_llama_forward_on_the_card(dev):
    """The sparse route through E1 (3 launches a layer) against its plain
    version, and against the dense route where no route is dropped (f32:
    the same math in other orders)."""
    from cubecl_tpu_torch.ops import moe

    cfg = llama.LlamaConfig(vocab=128, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, n_experts=4,
                            moe_capacity=192, use_framework_kernels=False)
    model = llama.init_params(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 64), dtype=np.int32)).to(dev)
    n = moe.expert_matmul.launches
    got = llama.forward(model, tokens)
    torch.cuda.synchronize()
    assert moe.expert_matmul.launches == n + 3 * cfg.n_layers
    _close(got, llama.forward(model, tokens, kernels=False))
    model.cfg = dataclasses.replace(cfg, moe_capacity=0)
    _close(got, llama.forward(model, tokens))


def test_mamba_forward_on_the_card(dev):
    """scan_impl "auto" on the card runs S1 (one launch a layer): against
    the plain version and the doubling scan; decode against forward."""
    from cubecl_tpu_torch.models import mamba
    from cubecl_tpu_torch.ops import ssm

    cfg = mamba.MambaConfig(vocab=97, d_model=64, n_layers=3, seq=40)
    model = mamba.init_params(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40), dtype=np.int32)).to(dev)
    n = ssm.scan_chunked_core.launches
    got = mamba.forward(model, tokens)
    torch.cuda.synchronize()
    assert ssm.scan_chunked_core.launches == n + cfg.n_layers
    _close(got, mamba.forward(model, tokens, kernels=False))
    model.cfg = mamba.MambaConfig(vocab=97, d_model=64, n_layers=3, seq=40,
                                  scan_impl="assoc")
    _close(got, mamba.forward(model, tokens))
    state = mamba.decode_init(cfg, 2, device=dev)
    for t in range(8):
        lg, state = mamba.decode_step(model, state, tokens[:, t])
        torch.testing.assert_close(lg, got[:, t], atol=2e-4, rtol=1e-3)


def test_mamba_trains_on_the_card(dev):
    """``make_train_step`` at scan_impl "auto" on the card: S1 and its
    backward once a layer a step; the loss and grads of the kernel route
    against S1's plain halves (f32 train-step bound: 1e-5 of the loss, 1e-4
    of each grad's max-abs) and against the doubling scan under autograd;
    three steps on one batch lower the loss."""
    from cubecl_tpu_torch.models import mamba
    from cubecl_tpu_torch.ops import ssm

    cfg = mamba.MambaConfig(vocab=97, d_model=64, n_layers=3, seq=40)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 41), dtype=np.int32)).to(dev)
    runs = {}
    for name, impl, kernels in (("kernels", "auto", True),
                                ("plain", "auto", False),
                                ("assoc", "assoc", True)):
        model = mamba.init_params(dataclasses.replace(cfg, scan_impl=impl),
                                  seed=0, device=dev).requires_grad_(True)
        n = (ssm.scan_chunked_core.launches,
             ssm.scan_chunked_core_backward.launches)
        loss = mamba.loss_fn(model, tokens, kernels=kernels)
        loss.backward()
        torch.cuda.synchronize()
        launched = (ssm.scan_chunked_core.launches - n[0],
                    ssm.scan_chunked_core_backward.launches - n[1])
        want = (cfg.n_layers,) * 2 if name == "kernels" else (0, 0)
        assert launched == want, (name, launched)
        runs[name] = (loss.item(), {k: p.grad for k, p in
                                    model.named_parameters()})
    loss, grads = runs["kernels"]
    for other in ("plain", "assoc"):
        ref_loss, ref_grads = runs[other]
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), other
        for k, r in ref_grads.items():
            err = float((grads[k] - r).abs().max())
            assert err <= 1e-4 * float(r.abs().max()), (other, k, err)
    model = mamba.init_params(cfg, seed=0, device=dev)
    step = mamba.make_train_step(cfg, 0.05)
    n = ssm.scan_chunked_core_backward.launches
    losses = [step(model, tokens).item() for _ in range(3)]
    assert ssm.scan_chunked_core_backward.launches == n + 3 * cfg.n_layers
    assert losses[0] > losses[1] > losses[2], losses


# -- A5, A6, A7 (the block-sparse schedules of csrc/flash_tiles.cuh) and C1
# (csrc/conv3x3.cu)


def _band_mask(n_q, n_kv):
    """The local band i-1..i plus the global tile 0 (BigBird-style)."""
    bm = np.zeros((n_q, n_kv), bool)
    for i in range(n_q):
        j = i * n_kv // n_q
        bm[i, max(0, j - 1):j + 1] = True
        bm[i, 0] = True
    return bm


def _holed_mask(n_q, n_kv):
    """Random tiles, the diagonal, and kv tile 1 attended by nobody."""
    bm = np.random.default_rng(n_q * n_kv).random((n_q, n_kv)) < 0.4
    for i in range(n_q):
        bm[i, i * n_kv // n_q] = True
    bm[:, 1] = False
    bm[:, 0] = True
    return bm


def _f9_mask(n_q, n_kv):
    """q tile 0 attends only kv tile 1: with bq > bk its first rows see
    nothing live (ROADMAP Queue 3, F9)."""
    bm = np.ones((n_q, n_kv), bool)
    bm[0] = False
    bm[0, 1] = True
    return bm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bq,bk,mask", [
    (512, 128, 128, _band_mask), (480, 96, 160, _band_mask),
    (512, 64, 64, _holed_mask), (512, 128, 64, _f9_mask),
    (384, 200, 100, _holed_mask)],
    ids=["band128", "ragged96x160", "holed64", "f9_128x64", "fit200x100"])
def test_block_sparse_kernels_match_plain(dev, dtype, D, causal, S, bq, bk,
                                         mask):
    """A5 (o, lse), and A6 and A7 through the autograd Function, against
    the plain forward and backward on the kernel's own o and lse; a kv tile
    nobody attends gets dk = dv = 0 exactly."""
    g = torch.Generator(device=dev).manual_seed(S + bq + D)
    q, k, v, do = (torch.randn(2, 3, S, D, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    bq_, bk_ = fa._fit_block(bq, S), fa._fit_block(bk, S)
    bm = mask(S // bq_, S // bk_)
    n = (fa.bsp_forward.launches, fa.bsp_dq.launches, fa.bsp_dkv.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_block_sparse(*leaves, bm, causal, None, bq, bk)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.bsp_forward.launches, fa.bsp_dq.launches,
            fa.bsp_dkv.launches) == tuple(c + 1 for c in n)
    pruned = fa._pruned_mask(bm, causal, bq_, bk_, S // bq_, S // bk_)
    sched = fa._schedule(pruned, bq_, bk_, dev)
    o, lse = fa.bsp_forward(q, k, v, sched, causal, D ** -0.5, bq_, bk_,
                            True)
    o_ref, lse_ref = fa.flash_attention_block_sparse_plain(
        q, k, v, bm, causal, None, bq, bk, return_lse=True)
    _close(o, o_ref)
    assert torch.equal(out.detach(), o)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=1e-4)
    refs = fa.flash_attention_block_sparse_backward_plain(
        q, k, v, o, lse, do, bm, causal, None, bq, bk)
    for t, r in zip(leaves, refs):
        _close(t.grad, r)
    dead = ~pruned.any(0)
    for ki in np.nonzero(dead)[0]:
        for t in leaves[1:]:
            assert not t.grad[:, :, ki * bk_:(ki + 1) * bk_].any()


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bq,bk,mask", [
    (512, 128, 128, _band_mask), (512, 64, 64, _holed_mask),
    (512, 128, 64, _f9_mask), (384, 200, 100, _holed_mask)],
    ids=["band128", "holed64", "f9_128x64", "fit200x100"])
def test_block_sparse_backward_bf16_rounds_as_jax(dev, D, causal, S, bq, bk,
                                                  mask):
    """A6 and A7 in bf16 (the tensor-core bodies on the block-sparse
    schedules) by ``_close_bwd`` against the plain backward that rounds p
    and dS to bf16 and the exact one, on the plain forward's o and lse; a
    kv tile nobody attends gets dk = dv = 0 and F9's rows dq = 0, exactly;
    a second call is bit-identical."""
    g = torch.Generator(device=dev).manual_seed(S + bq + bk + D + causal)
    q, k, v, do = (torch.randn(2, 3, S, D, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    bq_, bk_ = fa._fit_block(bq, S), fa._fit_block(bk, S)
    bm = mask(S // bq_, S // bk_)
    pruned = fa._pruned_mask(bm, causal, bq_, bk_, S // bq_, S // bk_)
    sched = fa._schedule(pruned, bq_, bk_, dev)
    o, lse = fa.flash_attention_block_sparse_plain(
        q, k, v, bm, causal, None, bq, bk, return_lse=True)
    di = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, di, sched, causal, D ** -0.5, bq_, bk_)
    n = (fa.bsp_dq.launches, fa.bsp_dkv.launches)
    dq = fa.bsp_dq(*args)
    dk, dv = fa.bsp_dkv(*args)
    torch.cuda.synchronize()
    assert (fa.bsp_dq.launches, fa.bsp_dkv.launches) == (n[0] + 1, n[1] + 1)
    rounded, exact = (fa.flash_attention_block_sparse_backward_plain(
        q, k, v, o, lse, do, bm, causal, None, bq, bk, round_p_ds=rnd)
        for rnd in (True, False))
    for t, r, e in zip((dq, dk, dv), rounded, exact):
        _close_bwd(t, r, e)
    for ki in np.nonzero(~pruned.any(0))[0]:
        assert not dk[:, :, ki * bk_:(ki + 1) * bk_].any()
        assert not dv[:, :, ki * bk_:(ki + 1) * bk_].any()
    if mask is _f9_mask and causal:  # rows 0..bk-1 see no live column
        assert not dq[:, :, :bk_].any()
    dq2 = fa.bsp_dq(*args)
    dk2, dv2 = fa.bsp_dkv(*args)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 80, 96, 160, 192])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bq,bk,mask", [
    (512, 128, 128, _band_mask), (512, 64, 64, _holed_mask),
    (512, 128, 64, _f9_mask)], ids=["band128", "holed64", "f9_128x64"])
def test_block_sparse_padded_head_dims_match_plain(dev, dtype, D, causal, S,
                                                   bq, bk, mask):
    """A5, A6 and A7 at D 32, 80, 96, 160 and 192, padded with zeros to
    64, 128 or 256 outside the autograd Function: one launch each, o and
    the grads at the
    real D against the plain forward and backward there; a kv tile nobody
    attends gets dk = dv = 0 exactly."""
    g = torch.Generator(device=dev).manual_seed(S + bq + D + causal)
    q, k, v, do = (torch.randn(2, 3, S, D, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    bm = mask(S // bq, S // bk)
    n = (fa.bsp_forward.launches, fa.bsp_dq.launches, fa.bsp_dkv.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_block_sparse(*leaves, bm, causal, None, bq, bk)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.bsp_forward.launches, fa.bsp_dq.launches,
            fa.bsp_dkv.launches) == tuple(c + 1 for c in n)
    assert out.shape == q.shape and all(t.grad.shape == q.shape
                                        for t in leaves)
    o_ref, lse_ref = fa.flash_attention_block_sparse_plain(
        q, k, v, bm, causal, None, bq, bk, return_lse=True)
    _close(out.detach(), o_ref)
    refs = fa.flash_attention_block_sparse_backward_plain(
        q, k, v, o_ref, lse_ref, do, bm, causal, None, bq, bk)
    for t, r in zip(leaves, refs):
        _close(t.grad, r)
    pruned = fa._pruned_mask(bm, causal, bq, bk, S // bq, S // bk)
    for ki in np.nonzero(~pruned.any(0))[0]:
        for t in leaves[1:]:
            assert not t.grad[:, :, ki * bk:(ki + 1) * bk].any()
    with torch.no_grad():
        again = fa.flash_attention_block_sparse(q, k, v, bm, causal, None,
                                                bq, bk)
    assert torch.equal(again, out.detach())


def test_block_sparse_refuses_other_shapes(dev):
    """Other k/v head counts raise; any D up to 256 runs (padded to 64, 128
    or 256); D past 256 raises naming ROADMAP Queue 2a, and the wrappers
    take only the built head dims 64, 128 and 256."""
    q = torch.zeros(1, 4, 256, 64, device=dev)
    kv = torch.zeros(1, 2, 256, 64, device=dev)
    with pytest.raises(ValueError, match="as many k/v heads"):
        fa.flash_attention_block_sparse(q, kv, kv, np.ones((2, 2), bool),
                                        True, None, 128, 128)
    q32 = torch.zeros(1, 2, 256, 32, device=dev)
    assert fa.flash_attention_block_sparse(
        q32, q32, q32, np.ones((2, 2), bool), True, None, 128,
        128).shape == q32.shape
    sched = fa._schedule(np.ones((2, 2), bool), 128, 128, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.bsp_forward(q32, q32, q32, sched, True, 32 ** -0.5, 128, 128,
                       False)
    for D in (129, 192, 256):
        qd = torch.zeros(1, 2, 256, D, device=dev)
        assert fa.flash_attention_block_sparse(
            qd, qd, qd, np.ones((2, 2), bool), True, None, 128,
            128).shape == qd.shape
    for D in (288, 320):
        qd = torch.zeros(1, 2, 256, D, device=dev)
        with pytest.raises(NotImplementedError, match="Queue 2a"):
            fa.flash_attention_block_sparse(
                qd, qd, qd, np.ones((2, 2), bool), True, None, 128, 128)
        with pytest.raises(NotImplementedError, match="Queue 2a"):
            fa.bsp_forward(qd, qd, qd, sched, True, D ** -0.5, 128, 128,
                           False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,k", [(2, 8, 8, 64, 64), (1, 6, 10, 32, 48),
                                       (3, 5, 130, 64, 17), (1, 1, 2, 3, 64),
                                       (2, 56, 56, 64, 64),
                                       (2, 56, 56, 3, 64),
                                       (2, 56, 56, 32, 64),
                                       (3, 1, 56, 64, 64),
                                       (1, 7, 400, 64, 64)])
def test_conv3x3_kernel_matches_plain(dev, dtype, n, h, w, c, k):
    """C1 on the packed layout against its plain version: input lanes
    c..63 hold garbage that must not reach the output, output lanes k..63
    are exact zeros. bf16 (the wgmma body): 56 columns make 448-pixel
    tiles of 7 m64 blocks (the second consumer takes 3), H 56 = 7 tiles of
    8 rows, H 1 a one-row tile whose halo rows are both padding, W 400 two
    column blocks of 134, cin 3 and 32 the tensor map's channel extent.
    f32 (three TF32 products on wgmma): W 56 makes 2-row tiles of 112
    pixels (one m64 block a consumer), W 130 two column blocks of 65, W
    400 five of 80 (one-row tiles), H 1 a tile whose halo rows are both
    padding, 6 x 10 one m64 block (the second consumer only walks the
    weight ring), cin 3 and 32 a channel extent inside the first or at
    the end of the first of the pixel's two 32-channel boxes."""
    from cubecl_tpu_torch.ops import conv

    g = torch.Generator(device=dev).manual_seed(n * h * w + c)
    x = (torch.randn(n, h, w, c, generator=g, device=dev) * .1).to(dtype)
    wgt = torch.randn(3, 3, c, k, generator=g, device=dev) * .1
    xp = conv.pack_pairs(x)
    xp.view(n, h, w, 64)[..., c:] = 1e4
    before = conv.conv2d_pairs_packed.launches
    got = conv.conv2d_pairs_packed(xp, wgt, h)
    torch.cuda.synchronize()
    assert conv.conv2d_pairs_packed.launches == before + 1
    assert got.shape == xp.shape and got.dtype == dtype
    ref = conv.conv2d_pairs_plain(xp.view(n, h, w, 64),
                                  conv._pad_weights(wgt, dtype), c)
    _close(got.view(n, h, w, 64), ref)
    assert not got.view(n, h, w, 64)[..., k:].any()


@pytest.mark.parametrize("case", ["top_of_range", "non_finite"])
def test_conv3x3_f32_extreme_inputs(dev, case):
    """C1's f32 body (3xTF32) on inputs at the top of f32's range (F12:
    FLT_MAX, values just under it, -FLT_MAX, weights ~1e-31 so every sum
    is finite): finite and within TOL of plain f32; and on inputs holding
    NaN (0 / 0 and NaNs whose bits a rounding by integer addition would
    carry into the exponent or the sign) and infinities: NaN wherever the
    plain f32 conv is NaN, finite and within TOL wherever it is finite,
    NaN or an infinity of its sign wherever it is infinite, as M1's and
    K0's non_finite tests hold them."""
    from cubecl_tpu_torch.ops import conv

    n, h, w = 2, 8, 10
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(n, h, w, 64, generator=g, device=dev) * .1
    wgt = torch.randn(3, 3, 64, 64, generator=g, device=dev) * .1
    if case == "top_of_range":
        top = float(np.finfo(np.float32).max)
        x[0, 3, 4, :] = top
        x[1, 0, 0, 5] = -top
        x[1, 7, 9, ::2] = float(np.nextafter(np.float32(top),
                                             np.float32(0)))
        x[0, 5, 0, 7] = (2 - 2.0 ** -11) * 2.0 ** 127
        wgt = wgt.abs() * 1e-30
    else:
        zero = torch.zeros((), device=dev)
        x[0, 1, 1, 3] = zero / zero
        x[0, 4, 6, 10], x[1, 2, 2, 20], x[1, 6, 7, 30] = _f32_bits(
            dev, 0x7F800001, 0xFFFFFFFF, 0xFFC00000)
        x[0, 6, 2, 40], x[1, 5, 9, 50] = float("inf"), -float("inf")
        x[1, 0, 4, 60] = float("inf")
    got = conv.conv3x3(x, wgt)
    torch.cuda.synchronize()
    want = conv.conv2d_pairs_plain(x, wgt)
    if case == "top_of_range":
        assert bool(want.isfinite().all()) and want.abs().max() > 1e6
        assert bool(got.isfinite().all())
        _close(got, want)
    else:
        _non_finite_agree(got, want)


def test_conv3x3_plan_matches_the_kernel(dev):
    """The launch plans ops/conv.py validates C1's launches with are the
    built kernel's (csrc/conv3x3.cu's cubecl_conv3x3_plan), per dtype and
    shape."""
    from cubecl_tpu_torch.ops import conv

    for dtype in conv.C1_DTYPES:
        for n, h, w in [(32, 56, 56), (1, 6, 10), (3, 5, 130), (1, 1, 2),
                        (3, 1, 56), (1, 7, 400), (16, 28, 28), (600, 8, 8)]:
            assert conv.c1_kernel_plan(dtype, n, h, w) \
                == conv.c1_plan(dtype, n, h, w), (dtype, n, h, w)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64, 3, 3, 64),
                                   (2, 8, 8, 128, 2, 2, 128)],
                         ids=["pairs", "im2col"])
def test_conv_autotuned_on_the_card(dev, monkeypatch, tmp_path, shape):
    """conv2d_autotuned tunes native (cuDNN) against C1 or im2col on M1
    (the matmul tuning inside the conv tuner's capture) and its result
    matches F.conv2d in f32 (TF32 off)."""
    from cubecl_tpu_torch.ops import conv

    monkeypatch.setenv("CUBECL_ENVIRONMENT_ROOT", str(tmp_path))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n, h, w, c, r, s, k = shape
    g = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn(n, h, w, c, generator=g, device=dev) * .1
    wgt = torch.randn(r, s, c, k, generator=g, device=dev) * .1
    client = CudaRuntime.client()
    hx, hw = client.create(x.reshape(-1)), client.create(wgt.reshape(-1))
    got = conv.conv2d_autotuned(client, hx, hw, n, h, w, c, r, s, k)
    ref = conv.conv2d_native(x, wgt)
    _close(got.tensor.view(ref.shape), ref)
    got = conv._conv_pairs_task(client, hx, hw, n, h, w, c, k) \
        if shape[4] == 3 else conv.conv2d_im2col(client, hx, hw, n, h, w, c,
                                                  r, s, k)
    _close(got.tensor.view(ref.shape), ref)


# -- K0's warp lines (a unit on a warp, backend/cuda/printer.py) --------------

# bf16 K0 kernels that compute op by op in bf16 (the normalization bodies
# on bf16 buffers, gelu) against plain formulas in f32 rounded once: a few
# bf16 ulps apart, as chip_smoke.py's CHAIN_TOL. Against the evaluator,
# which rounds at the same ops, such a chain still rounds its bf16 row sums
# from sums taken in another order: one ulp of a variance, say, moves every
# element of the row, and where the final add cancels (layernorm's + b)
# that is a few ulps of the addends, so these are held at CHAIN_TOL too
CHAIN_TOL = (3e-2, 3e-2)
_BF16_CHAINS = {"gelu fwd", "softmax fwd", "gelu bwd", "softmax bwd",
                "softmax_lines", "softmax_lines_inplace", "layernorm_lines",
                "normalize_lines"}
_BF16, _F32 = torch.bfloat16, torch.float32
# (rows, D, dtype): the smallest warp lines (f32 128, bf16 256, one chunk
# a lane), decode's 8 rows and phase f's ragged 8 x 1023, the llama's
# width, a bf16 row of 384 (two chunks' room a lane, the second partly
# past the row: no 16-byte branch) and the widest row the ops take
WARP_SHAPES = [(8, 128, _F32), (8184, 128, _F32), (8, 256, _BF16),
               (8184, 256, _BF16), (8184, 2048, _BF16), (64, 384, _BF16),
               (8, 16384, _F32), (64, 16384, _BF16)]
_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _p_softmax(x, *_):
    xf = x.float()
    e = torch.exp(xf - xf.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def _p_layernorm(x, g, b, *_):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * g.float()
            + b.float()).to(x.dtype)


def _p_rmsnorm(x, g, *_):
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-5)
            * g.float()).to(x.dtype)


def _p_gelu(x, *_):
    xf = x.float()
    return (xf * (torch.erf(xf * _INV_SQRT2) + 1.0) * 0.5).to(x.dtype)


def _p_normalize(x, *_):
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().sum(-1, keepdim=True) + 1e-6)) \
        .to(x.dtype)


def _p_backward(op):
    """dx of ``op`` by f32 autograd, for x, g, b, dy (y for softmax)."""
    def f(x, g, b, dy):
        leaf = x.float().requires_grad_()
        fn = {"gelu": lambda t: _p_gelu(t), "softmax": lambda t: t,
              "layernorm": lambda t: _p_layernorm(t, g.float(), b.float()),
              "rmsnorm": lambda t: _p_rmsnorm(t, g.float())}[op]
        if op == "softmax":  # dx from y: (dy - sum(y dy)) y
            yf, dyf = x.float(), dy.float()
            return ((dyf - (yf * dyf).sum(-1, keepdim=True)) * yf).to(x.dtype)
        (dx,) = torch.autograd.grad(fn(leaf), leaf, dy.float())
        return dx.to(x.dtype)
    return f


def _clone_at_offset(t):
    """A copy of contiguous ``t`` at the same offset from 16 bytes."""
    off = t.data_ptr() % 16 // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


def _lines(launch):
    """A ``normalization.launch_*`` wide path on a client, its buffers the
    tensors themselves (no aligned copy): the output tensor (in place: the
    input's)."""
    from cubecl_tpu_torch.runtime.handle import Handle

    def run(c, x, g, b, dy, inplace=False):
        rows, row = x.shape
        hx = Handle(_clone_at_offset(x) if inplace else x)
        ho = hx if inplace else Handle(torch.empty_like(x))
        if launch == "layernorm":
            N.launch_layernorm(c, hx, Handle(g), Handle(b), ho, rows, row)
        elif launch == "normalize":
            N.launch_normalize(c, hx, ho, rows, row, eps=1e-6)
        else:
            N.launch_softmax(c, hx, ho, rows, row)
        return ho.tensor
    return run


# name -> (kernel the path launches, launch(client, x, g, b, dy), plain);
# the backward kernels are launched as the Functions launch them
WARP_OPS = {
    "gelu fwd": ("_gelu_fwd_k", lambda c, x, g, b, dy: F.gelu(x, client=c),
                 _p_gelu),
    "softmax fwd": ("_softmax_fwd_k",
                    lambda c, x, g, b, dy: F.softmax(x, client=c), _p_softmax),
    "layernorm fwd": ("_layernorm_fwd_k", lambda c, x, g, b, dy: F.layernorm(
        x, g, b, client=c), _p_layernorm),
    "rmsnorm fwd": ("_rmsnorm_fwd_k", lambda c, x, g, b, dy: F.rmsnorm(
        x, g, client=c), _p_rmsnorm),
    "gelu bwd": ("_gelu_bwd_k", lambda c, x, g, b, dy: F._rows(
        F._gelu_bwd_k, x, [x, dy], client=c), _p_backward("gelu")),
    "softmax bwd": ("_softmax_bwd_k", lambda c, x, g, b, dy: F._rows(
        F._softmax_bwd_k, x, [x, dy], client=c), _p_backward("softmax")),
    "layernorm bwd": ("_layernorm_bwd_k", lambda c, x, g, b, dy: F._rows(
        F._layernorm_bwd_k, x, [x, g, dy], (1.0 / x.shape[-1], 1e-5), c),
        _p_backward("layernorm")),
    "rmsnorm bwd": ("_rmsnorm_bwd_k", lambda c, x, g, b, dy: F._rows(
        F._rmsnorm_bwd_k, x, [x, g, dy], (1.0 / x.shape[-1], 1e-5), c),
        _p_backward("rmsnorm")),
    "softmax_lines": ("softmax_lines", _lines("softmax"), _p_softmax),
    "softmax_lines_inplace": ("softmax_lines_inplace",
                              lambda c, x, g, b, dy: _lines("softmax")(
                                  c, x, g, b, dy, inplace=True), _p_softmax),
    "layernorm_lines": ("layernorm_lines", _lines("layernorm"), _p_layernorm),
    "normalize_lines": ("normalize_lines", _lines("normalize"),
                        _p_normalize),
}


def _warp_inputs(dev, rows, D, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    x = rn(rows, D)
    return x, rn(D), rn(D), rn(rows, D)


def _warp_lined(server, name, D):
    """Was a warp-lined build of kernel ``name`` over lines of D made?"""
    return any(k.name == name and "mapping=warp-lines" in k.source
               and f" * {D} + " in k.source for k in server._cache.values())


@pytest.mark.parametrize("shape", WARP_SHAPES,
                         ids=[f"{r}x{d}-{str(t)[6:]}" for r, d, t in WARP_SHAPES])
@pytest.mark.parametrize("op", list(WARP_OPS))
def test_warp_lined_kernels_match_evaluator_and_plain(dev, op, shape):
    """Each warp-lined K0 kernel, as its path launches it, against the
    torch evaluator on the card (TOL; CHAIN_TOL for the bf16 chains) and
    its plain formula (TOL in f32, CHAIN_TOL in bf16): one launch, printed
    with ``mapping=warp-lines``."""
    rows, D, dtype = shape
    name, launch, plain = WARP_OPS[op]
    x, g, b, dy = _warp_inputs(dev, rows, D, dtype, 11)
    if op == "softmax bwd":
        x = torch.softmax(x.float(), -1).to(dtype)
    cu = CudaRuntime.client()
    n = cu.server.launches[name]
    got = launch(cu, x, g, b, dy)
    torch.cuda.synchronize()
    assert cu.server.launches[name] == n + 1
    assert _warp_lined(cu.server, name, D)
    ev = launch(eval_client(dev), x, g, b, dy)
    if dtype == _BF16 and op in _BF16_CHAINS:
        torch.testing.assert_close(got.float(), ev.float(), atol=CHAIN_TOL[0],
                                   rtol=CHAIN_TOL[1])
    else:
        _close(got, ev)
    want = plain(x, g, b, dy)
    atol, rtol = CHAIN_TOL if dtype == _BF16 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("shape", [(64, 256, _BF16), (64, 128, _F32),
                                   (8, 2048, _BF16)],
                         ids=["64x256-bf16", "64x128-f32", "8x2048-bf16"])
@pytest.mark.parametrize("op", list(WARP_OPS))
def test_warp_lines_scalar_branch_equals_the_vector_one(dev, op, shape):
    """The same launch on a view one element off 16-byte alignment takes
    the kernel's element-by-element branch: the same elements in the same
    order a lane, so its output equals the aligned launch's bit for bit."""
    rows, D, dtype = shape
    name, launch, _plain = WARP_OPS[op]
    x, g, b, dy = _warp_inputs(dev, rows, D, dtype, 12)
    if op == "softmax bwd":
        x = torch.softmax(x.float(), -1).to(dtype)
    offs = []
    for t in (x, dy):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        buf[1:].copy_(t.reshape(-1))
        offs.append(buf[1:].view(t.shape))
    assert offs[0].data_ptr() % 16 and offs[0].is_contiguous()
    cu = CudaRuntime.client()
    aligned = launch(cu, x, g, b, dy)
    off = launch(cu, offs[0], g, b, offs[1])
    torch.cuda.synchronize()
    assert torch.equal(off, aligned)


def test_warp_lined_aliased_launches(dev):
    """One tensor passed as a warp-lined kernel's input and output (the
    buffers lose ``__restrict__``, the line is read into the lane's array
    before the store): gelu over rows and a fused chain written into its
    first input, each against the evaluator."""
    from cubecl_tpu_torch.ops import fusion as FU

    g = torch.Generator(device=dev).manual_seed(13)
    outs = []
    for c in (CudaRuntime.client(), eval_client(dev)):
        x = torch.randn(8184, 2048, generator=g, device=dev).to(_BF16)
        F._apply_rows(F._gelu_fwd_k, x, [(x, False), (x, True)], client=c)
        a, b = (torch.randn(1 << 20, generator=g, device=dev)
                for _ in range(2))
        ha = c.create(a)
        FU.launch_fused(c, [ha, c.create(b)], ha, ["add", "relu"])
        outs.append((x, ha.tensor))
        g.manual_seed(13)
    torch.cuda.synchronize()
    cu = CudaRuntime.client().server
    assert _warp_lined(cu, "_gelu_fwd_k", 2048)
    # of a, b and out, only b (not aliased) keeps __restrict__
    assert any(k.name == "fused_chain" and "mapping=warp-lines" in k.source
               and k.source.count("__restrict__") == 1
               for k in cu._cache.values())
    for got, want in zip(*outs):
        _close(got, want)


# -- A1, A3, A4 with their options (the masked schedule of
# csrc/flash_tiles.cuh) and A8's window; the four public functions


def _doc_ids(g, dev, B, S, lo=20, hi=90, pad=16):
    """Segment ids of packed documents: lengths uniform in [lo, hi) until S
    is full, the last ``pad`` positions the padding id -1."""
    ids = torch.empty(B, S, dtype=torch.int32)
    for b in range(B):
        pos, doc = 0, 0
        while pos < S:
            n = int(torch.randint(lo, hi, (1,), generator=g,
                                  device=dev).item())
            ids[b, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    ids[:, S - pad:] = -1
    return ids.to(dev)


def _options(g, dev, option, causal, B, Sq, Skv):
    """The options of one case, as ``_Mask.of`` takes them."""
    if option == "kv_len":
        return dict(kv_len=Skv - 70)
    if option == "segments":
        return dict(seg=(_doc_ids(g, dev, B, Sq),) * 2)
    if option == "window":
        return dict(window=(70, 0 if causal else 30))
    if option == "all":
        return dict(kv_len=Skv - 40, seg=(_doc_ids(g, dev, B, Sq),) * 2,
                    window=(100, 0 if causal else 50))
    return dict(window=(20, 10))  # "f16": Sq > Skv, rows from 150 see none


def _pad_d(t, D):
    Dp = next(d for d in fa.KERNEL_HEAD_DIMS if D <= d)
    return torch.nn.functional.pad(t, (0, Dp - D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("option", ["kv_len", "segments", "window", "all",
                                    "f16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_option_kernels_match_plain(dev, dtype, D, option, causal):
    """The masked forward (o, lse), dK/dV and dQ kernels, one launch each
    through the autograd Function (D 32 and 96 padded to 64 and 128 as
    ``flash_attention_padded`` pads them; D 256 the wide and sliced bodies
    of A3/A4), against the plain versions with
    the same options on the kernel's own o and lse, by ``_close_bwd``; F16's
    rows get o = 0, lse = 0 and pass nothing back; a second call is
    bit-identical."""
    Sq, Skv = (300, 130) if option == "f16" else (200, 200)
    g = torch.Generator(device=dev).manual_seed(Sq + D + causal)
    q, do = (torch.randn(2, 4, Sq, D, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 2, Skv, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    mask = fa._Mask.of(q, k, **_options(g, dev, option, causal, 2, Sq, Skv))
    scale = D ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n = (fa.masked_forward.launches, fa.masked_dkv.launches,
         fa.masked_dq.launches, flash_attention.launches)
    out = fa._padded_attend(*leaves, causal, scale, mask)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.masked_forward.launches, fa.masked_dkv.launches,
            fa.masked_dq.launches, flash_attention.launches) == \
        (n[0] + 1, n[1] + 1, n[2] + 1, n[3])
    o, lse = fa.masked_forward(*(_pad_d(t, D) for t in (q, k, v)), mask,
                               causal, scale, True)
    o = o[..., :D]
    assert torch.equal(o, out.detach())
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, scale,
                                           return_lse=True, **mask.plain())
    _close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=1e-4)
    rounded, exact = (_plain_bwd(
        q, k, v, o, lse, do, causal, scale, round_p_ds=rnd, **mask.plain())
        for rnd in (True, False))
    for t, r, e in zip(leaves, rounded, exact):
        _close_bwd(t.grad, r, e)
    if option == "f16":
        assert not o[:, :, 150:].any() and not lse[:, :, 150:].any()
        assert not leaves[0].grad[:, :, 150:].any()
    out2 = fa._padded_attend(*leaves, causal, scale, mask)
    grads = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    out2.backward(do)
    assert torch.equal(out2, out)
    for t, g1 in zip(leaves, grads):
        assert torch.equal(t.grad, g1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_option_functions_run_the_kernels(dev, dtype):
    """The four public functions and ``flash_attention(kv_len=...)`` on
    CUDA tensors: the masked kernels for the options (the packed window at
    D 32 and 64 too), the dense ones where there is none (the padded
    function at D 96), each against its plain version, forward and
    backward."""
    g = torch.Generator(device=dev).manual_seed(5)

    def qkv(D, S=256, H=4, Hkv=2):
        q, do = (torch.randn(2, H, S, D, generator=g, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(2, Hkv, S, D, generator=g, device=dev)
                .to(dtype) for _ in range(2))
        return q, k, v, do

    seg = _doc_ids(g, dev, 2, 256)
    cases = [
        ("kv_len", 128, lambda *t: fa.flash_attention(*t, True,
                                                      kv_len=200),
         dict(kv_len=200), True),
        ("segmented", 64, lambda *t: fa.flash_attention_segmented(
            *t, seg), dict(seg=(seg, seg)), True),
        ("local", 128, lambda *t: fa.flash_attention_local(*t, 64, 0),
         dict(window=(64, 0)), True),
        ("packed d32", 32, lambda *t: fa.flash_attention_packed(
            *t, True, window=(64, 0)), dict(window=(64, 0)), True),
        ("packed d64", 64, lambda *t: fa.flash_attention_packed(
            *t, True, window=(32, 0)), dict(window=(32, 0)), True),
        ("padded d96", 96, lambda *t: fa.flash_attention_padded(*t),
         {}, False)]
    for name, D, fn, opts, masked in cases:
        q, k, v, do = qkv(D)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        counts = lambda: (fa.masked_forward.launches,  # noqa: E731
                          fa.masked_dkv.launches, fa.masked_dq.launches,
                          flash_attention.launches, fa.flash_bwd_dkv.launches,
                          fa.flash_bwd_dq.launches)
        n = counts()
        out = fn(*leaves)
        out.backward(do)
        torch.cuda.synchronize()
        want = (1, 1, 1, 0, 0, 0) if masked else (0, 0, 0, 1, 1, 1)
        assert tuple(a - b for a, b in zip(counts(), n)) == want, name
        ref = flash_attention_plain(q, k, v, True, **opts)
        _close(out.detach(), ref)
        o, lse = flash_attention_plain(q, k, v, True, return_lse=True,
                                       **opts)
        exact = _plain_bwd(q, k, v, o, lse, do, True, **opts)
        atol, rtol = EXACT_BWD_TOL[dtype]
        for t, e in zip(leaves, exact):
            torch.testing.assert_close(t.grad.float(), e.float(), atol=atol,
                                       rtol=rtol, msg=name)
        with torch.no_grad():
            n = counts()
            torch.testing.assert_close(fn(q, k, v), out.detach())
            assert counts()[0] + counts()[3] == n[0] + n[3] + 1, name


def test_flash_padded_past_128_raises(dev):
    """Past 128 both halves are built (padded to 256): a pass under grad
    at D 160 runs A1, A3 and A4 once each; past 256 nothing is built, and
    a pass with or without grad raises before any launch (ROADMAP Queue
    2a)."""
    q = torch.zeros(1, 2, 64, 160, device=dev, requires_grad=True)
    n = (flash_attention.launches, fa.flash_bwd_dkv.launches,
         fa.flash_bwd_dq.launches)
    fa.flash_attention_padded(q, q, q).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    for grad in (False, True):
        q = torch.zeros(1, 2, 64, 288, device=dev, requires_grad=grad)
        with pytest.raises(NotImplementedError, match="Queue 2a"):
            fa.flash_attention_padded(q, q, q)
    assert flash_attention.launches == n[0] + 1


@pytest.mark.parametrize("hd,heads", [(96, 2), (32, 4), (256, 2)])
def test_train_step_at_other_head_dims_matches_plain(dev, hd, heads):
    """A llama SGD step, f32, at head dim 96 (the padded route), 32 (the
    packed route) and 256 (the exact route: A3/A4's sliced bodies), with
    the kernels and with the plain versions: loss, gradients and weights,
    as test_train_step_kernels_match_plain; the dense kernels ran once a
    layer each way."""
    cfg = llama.LlamaConfig(vocab=128, d_model=hd * heads, n_heads=heads,
                            n_kv_heads=heads // 2, n_layers=2, d_ff=256,
                            seq=129)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 129), dtype=np.int32)).to(dev)
    models = []
    n = (flash_attention.launches, fa.flash_bwd_dkv.launches)
    for kernels in (True, False):
        model = llama.init_params(cfg, seed=0, device=dev)
        loss = llama.make_train_step(cfg, 1e-2, kernels=kernels)(model,
                                                                 tokens)
        models.append((loss, model))
    assert (flash_attention.launches, fa.flash_bwd_dkv.launches) == \
        (n[0] + 2, n[1] + 2)
    (lk, mk), (lp, mp) = models
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=0)
    for (name, a), b in zip(mk.named_parameters(), mp.parameters()):
        tol = 1e-4 * b.grad.abs().max().item()
        assert (a.grad - b.grad).abs().max().item() <= tol, name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# -- head dim 256: A1's forward, P1, P3 (GPT-J-6B's, Qwen3-Next's) ----------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 65, 128, 200, 1021])
@pytest.mark.parametrize("G", [1, 8])
def test_flash_d256_kernel_matches_plain(dev, dtype, causal, S, G):
    """A1's forward at D 256 (bf16: 2 K/V stages, P V as two m64n128k16;
    f32: the CUDA-core body) against the plain version, o and lse, at GQA
    1 and 8 and lengths around the 64-row tiles; one launch."""
    g = torch.Generator(device=dev).manual_seed(S + G)
    q = torch.randn(2, 8, S, 256, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 8 // G, S, 256, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 8 // G, S, 256, generator=g, device=dev).to(dtype)
    n = flash_attention.launches
    o, lse = fa._flash_forward(q, k, v, causal, None, True)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, return_lse=True)
    _close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=1e-4)
    with torch.no_grad():
        assert torch.equal(flash_attention(q, k, v, causal), o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("option", ["kv_len", "window", "segments",
                                    "padded 192", "padded 160"])
def test_flash_d256_options_match_plain(dev, dtype, option):
    """A1's masked instances at D 256 (kv_len, a window, segment ids) and
    the padded route from D 192 and 160, through the public functions
    under no_grad, against the plain version; one masked launch (or one
    dense launch for the padded route)."""
    g = torch.Generator(device=dev).manual_seed(len(option))
    D = int(option.split()[1]) if option.startswith("padded") else 256
    q = torch.randn(2, 8, 300, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(2, 2, 300, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    n = (fa.masked_forward.launches, flash_attention.launches)
    with torch.no_grad():
        if option == "kv_len":
            got, opts = flash_attention(q, k, v, kv_len=230), dict(
                kv_len=230)
        elif option == "window":
            got, opts = fa.flash_attention_local(q, k, v, 70), dict(
                window=(70, 0))
        elif option == "segments":
            ids = torch.arange(300, device=dev).div(97, rounding_mode="floor")
            ids = ids.expand(2, 300).to(torch.int32).contiguous()
            got = fa.flash_attention_segmented(q, k, v, ids)
            opts = dict(seg=(ids, ids))
        else:
            got, opts = fa.flash_attention_padded(q, k, v), {}
    torch.cuda.synchronize()
    masked = bool(opts)
    assert (fa.masked_forward.launches - n[0],
            flash_attention.launches - n[1]) == (int(masked), 1 - masked)
    _close(got, flash_attention_plain(q, k, v, True, **opts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dq", [192, 160])
def test_flash_d256_padded_grads_match_plain(dev, dtype, Dq):
    """flash_attention_padded under grad from D 192 and 160: padded to 256
    for A1, A3 and A4 (one dense launch each), the grads sliced back to Dq
    through autograd, held by ``_close_bwd`` against the plain backwards
    at the real D on the kernel's own o and lse."""
    g = torch.Generator(device=dev).manual_seed(Dq)
    q, do = (torch.randn(2, 8, 300, Dq, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 2, 300, Dq, generator=g, device=dev).to(dtype)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n = (flash_attention.launches, fa.flash_bwd_dkv.launches,
         fa.flash_bwd_dq.launches)
    out = fa.flash_attention_padded(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    scale = Dq ** -0.5
    o, lse = fa._flash_forward(*(_pad_d(t, Dq) for t in (q, k, v)), True,
                               scale, True)
    o = o[..., :Dq]
    assert torch.equal(o, out.detach())
    rounded, exact = (_plain_bwd(
        q, k, v, o, lse, do, True, scale, round_p_ds=rnd)
        for rnd in (True, False))
    for t, r, e in zip(leaves, rounded, exact):
        assert t.grad.shape == t.shape
        _close_bwd(t.grad, r, e)


def test_flash_d256_refuses_grad_at_the_forward(dev):
    """Under grad at D 256 the Function no longer refuses: a pass launches
    A1, A3 and A4 once each (the backward's D 256 instances). The refusal
    at the forward moved past 256 (D 384), before any launch."""
    q = torch.randn(1, 2, 64, 256, device=dev, requires_grad=True)
    n = (flash_attention.launches, fa.flash_bwd_dkv.launches,
         fa.flash_bwd_dq.launches)
    flash_attention(q, q, q).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    assert torch.isfinite(q.grad).all()
    q = torch.zeros(1, 2, 64, 384, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="Queue 2a"):
        flash_attention(q, q, q)
    assert flash_attention.launches == n[0] + 1


# P1 at D 256: (B, Hkv, G, page, max_pages, lengths, window, sinks):
# GPT-J's decode (16 kv heads of one query head), Qwen3-Next's (G 8) at
# context 4096, G 12 (the grouped kernel), ragged with a length-0 row on
# pages of 7, pages of 1
P1_D256 = {
    "gpt-j": (8, 16, 1, 128, 9, [1056, 1, 64, 65, 500, 1000, 0, 1100],
              512, 4),
    "qwen3-next-ctx4096": (2, 2, 8, 128, 33, [4096, 3001], 2000, 4),
    "G12": (3, 1, 12, 16, 40, [640, 0, 301], 100, 9),
    "G4-page7": (5, 2, 4, 7, 40, [0, 7, 70, 129, 280], 50, 9),
    "G2-page1": (3, 4, 2, 1, 300, [0, 150, 300], 64, 3),
}


@pytest.mark.parametrize("layout", list(P1_D256))
@pytest.mark.parametrize("mode", ["full", "window", "ring"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_paged_d256_kernel_matches_plain(dev, kind, mode, layout):
    """P1 at D 256 in every mode and on every pool (f32: one stage a
    warp), the grouped kernel past 8 query heads a kv head, against its
    plain version; the plan is the built kernel's; one launch, counted in
    its mode; a length-0 row's zeros."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    B, Hkv, G, page, max_pages, lengths, window, sinks = P1_D256[layout]
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(G + page + len(mode))
    q, kp, vp, ks, vs, table = _stream_pools(g, dev, dtype, kind == "int8",
                                             B, Hkv, G, 256, page, max_pages)
    if mode == "ring":  # a ring past its capacity: its slots recycled
        lengths = [n + page * max_pages // 2 if n else 0 for n in lengths]
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(layer=1, k_scales=ks, v_scales=vs)
    if mode != "full":
        kw.update(window=window, sinks=sinks)
    if mode == "ring":
        kw["pos_meta"] = torch.from_numpy(_ring_meta(
            table, lengths, page, sinks)[:kp.shape[2]]).to(dev)
    args = (dtype, kp.dtype, B, Hkv * G, Hkv, 256, page, max_pages,
            kw.get("window", 0), kw.get("sinks", 0), mode == "ring")
    plan = pa.p1_plan(*args)
    assert pa.p1_kernel_plan(*args) == plan
    assert plan.stages == (1 if kind == "f32" else 3)
    n = (paged_attention.launches, paged_attention.window_launches,
         paged_attention.ring_launches, paged_attention.grouped_launches)
    got = paged_attention(q, kp, vp, table, ln, **kw)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.window_launches,
            paged_attention.ring_launches,
            paged_attention.grouped_launches) == (
        n[0] + 1, n[1] + (mode == "window"), n[2] + (mode == "ring"),
        n[3] + (G > 8))
    _close(got, paged_attention_plain(q, kp, vp, table, ln, **kw))
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


# P3 at D 256: (B, Hkv, G, C, page, max_pages, starts, lengths or None
# for starts + C): GPT-J's verify step (positions split) and a prefill
# chunk from 768; Qwen3-Next's verify step (G 8: 40 rows); a ragged batch
# with a length-0 row on pages of 7; G 12 x C 70 (14 row tiles)
P3_D256 = {
    "gpt-j-verify": (8, 16, 1, 5, 128, 9, [1051] * 8, None),
    "gpt-j-C256-from-768": (2, 16, 1, 256, 128, 9, [768, 0], None),
    "qwen3-next-verify": (4, 2, 8, 5, 128, 33, [4091, 7, 100, 2000], None),
    "ragged-page7": (4, 2, 4, 16, 7, 40, [0, 1, 127, 200],
                     [0, 17, 143, 216]),
    "G12-C70": (2, 2, 12, 70, 16, 10, [0, 9], None),
}


@pytest.mark.parametrize("case", list(P3_D256))
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_paged_chunked_d256_kernel_matches_plain(dev, kind, case):
    """P3 at D 256 against its plain version on every pool: the bf16
    body's four panels, decode-shaped tiles with their positions split
    (each tile's P V from zero, 64 columns at a time), prefill-shaped
    ones as two m64n128k16 a step; f32 the CUDA-core body; the plan is
    the built kernel's; one launch."""
    from cubecl_tpu_torch.ops import paged_attention as pa

    B, Hkv, G, C, page, max_pages, starts, lengths = P3_D256[case]
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(G * C + len(kind))
    _, kp, vp, ks, vs, table = _stream_pools(g, dev, dtype, kind == "int8",
                                             B, Hkv, G, 256, page, max_pages)
    q = torch.randn(B, Hkv * G, C, 256, generator=g, device=dev).to(dtype)
    args = (dtype, kp.dtype, B, Hkv * G, Hkv, C, 256, page, max_pages)
    assert pa.p3_kernel_plan(*args) == pa.p3_plan(*args)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = st + C if lengths is None else torch.tensor(
        lengths, dtype=torch.int32, device=dev)
    n = paged_attention_chunked.launches
    got = paged_attention_chunked(q, kp, vp, table, ln, st, layer=1,
                                  k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert paged_attention_chunked.launches == n + 1
    _close(got, paged_attention_chunked_plain(q, kp, vp, table, ln, st,
                                              layer=1, k_scales=ks,
                                              v_scales=vs))
    if lengths is not None:
        assert not got[0].any()


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32", "int8"])
def test_serving_at_head_dim_256_matches_plain(dev, kv_dtype):
    """The llama at head dim 256 (d 512, 2 heads on 1 kv head) served on
    the D 256 instances, f32: prefill (A1), prefill_chunked (P3
    prefill-shaped), decode steps and the speculative verify (P1, P3
    decode-shaped), greedy generate, against the plain versions: equal
    tokens, logits as test_chunked_serving_kernels_match_plain holds
    them."""
    cfg = llama.LlamaConfig(vocab=128, d_model=512, n_heads=2, n_kv_heads=1,
                            n_layers=2, d_ff=512, kv_dtype=kv_dtype,
                            use_framework_kernels=False)
    assert cfg.head_dim == 256
    model = llama.init_params(cfg, seed=7, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (3, 70), dtype=np.int32)).to(dev)
    out = []
    for kernels in (True, False):
        n = (flash_attention.launches, paged_attention_chunked.launches,
             paged_attention.launches)
        c = llama.init_kv_cache(cfg, 3, 4, 32, dev)
        lp, c = llama.prefill(model, c, prompt, kernels=kernels)
        c = llama.init_kv_cache(cfg, 3, 4, 32, dev)
        lg, c = llama.prefill_chunked(model, c, prompt, chunk=32,
                                      kernels=kernels)
        toks, acc = llama.speculative_generate(model, prompt, 6, model,
                                               gamma=3, max_pages=4,
                                               page=32, kernels=kernels)
        ran = (flash_attention.launches - n[0],
               paged_attention_chunked.launches - n[1],
               paged_attention.launches - n[2])
        assert all(ran) if kernels else ran == (0, 0, 0)
        out.append((lp, lg, toks, acc))
    (pk, lk, tk, ak), (pp, lp, tp, ap) = out
    tol = 1e-3 if kv_dtype else 2e-5
    torch.testing.assert_close(pk, pp, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(lk, lp, atol=tol, rtol=max(tol, 1e-4))
    assert torch.equal(tk, tp) and ak == ap == 3.0
    assert torch.equal(tk, llama.generate(model, prompt, 6, max_pages=4,
                                          page=32))
