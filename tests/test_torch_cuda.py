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

import numpy as np
import pytest
import torch

from cubecl_tpu_torch.models import llama
from cubecl_tpu_torch.ops import functional as F
from cubecl_tpu_torch.ops import gelu as G
from cubecl_tpu_torch.ops import normalization as N
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
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 77, 200])
def test_flash_kernel_matches_plain(dev, dtype, D, causal, S):
    g = torch.Generator(device=dev).manual_seed(S + D)
    q = torch.randn(2, 6, S, D, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 2, S, D, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 2, S, D, generator=g, device=dev).to(dtype)
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    _close(got, flash_attention_plain(q, k, v, causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_paged_kernel_matches_plain(dev, dtype, D, G):
    g = torch.Generator(device=dev).manual_seed(G * D)
    B, Hkv, L, page, max_pages = 6, 2, 3, 16, 5
    P = B * max_pages + 3
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(dtype)
    kp = torch.randn(L, Hkv, P, page, D, generator=g, device=dev).to(dtype)
    vp = torch.randn(L, Hkv, P, page, D, generator=g, device=dev).to(dtype)
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages]
    table = table.view(B, max_pages).to(torch.int32)
    lengths = torch.tensor([0, 1, 15, 16, 17, 80], dtype=torch.int32,
                           device=dev)
    n = paged_attention.launches
    got = paged_attention(q, kp, vp, table, lengths, layer=2)
    torch.cuda.synchronize()
    assert paged_attention.launches == n + 1
    _close(got, paged_attention_plain(q, kp, vp, table, lengths, layer=2))
    assert not got[0].any()


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
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 77, 200])
def test_flash_backward_kernels_match_plain(dev, dtype, D, causal, S):
    """dq, dk, dv of the autograd Function (forward kernel with lse, dK/dV
    and dQ kernels) against flash_attention_backward_plain on the kernel's
    own o and lse; the lse against the plain logsumexp."""
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
    ref = fa.flash_attention_backward_plain(q, k, v, o2, lse, do, causal)
    for t, r in zip(leaves, ref):
        _close(t.grad, r)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 2, 2, 64), (3, 4, 8, 128)],
                         ids=["B6-Hkv2-G2-D64", "B3-Hkv4-G8-D128"])
def test_paged_int8_kernel_matches_plain(dev, dtype, shape):
    """P1 on int8 pools: lengths 0, 1, mid-page, a page boundary and past
    it, against the plain version on the same int8 pools and scales."""
    B, Hkv, G, D = shape
    g = torch.Generator(device=dev).manual_seed(B * D)
    L, page, max_pages = 3, 16, 5
    P = B * max_pages + 3
    q = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(dtype)
    kq, vq, ks, vs = _int8_pools(g, dev, (L, Hkv, P, page, D))
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages]
    table = table.view(B, max_pages).to(torch.int32)
    lengths = torch.tensor([0, 1, 15, 16, 17, 80][:B], dtype=torch.int32,
                           device=dev)
    n = (paged_attention.launches, paged_attention.int8_launches)
    got = paged_attention(q, kq, vq, table, lengths, layer=1, k_scales=ks,
                          v_scales=vs)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.int8_launches) == \
        (n[0] + 1, n[1] + 1)
    _close(got, paged_attention_plain(q, kq, vq, table, lengths, layer=1,
                                      k_scales=ks, v_scales=vs))
    assert not got[0].any()


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2, 2, 5, 64), (2, 2, 3, 70, 128)],
                         ids=["B4-Hkv2-G2-C5-D64", "B2-Hkv2-G3-C70-D128"])
def test_paged_chunked_kernel_matches_plain(dev, quant, dtype, shape):
    """P3: chunks starting at 0, in mid-page and on a page boundary, one
    row of length 0 and one whose length stops inside its chunk, against
    the plain version."""
    B, Hkv, G, C, D = shape
    g = torch.Generator(device=dev).manual_seed(C * D + quant)
    L, page, max_pages = 2, 16, 10
    P = B * max_pages + 3
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
