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

import math

import numpy as np
import pytest
import torch

from cubecl_tpu_torch.frontend import (ABSOLUTE_POS, CUBE_POS_X, ArrayArg,
                                       MutSlice, Slice, cube)
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
    int8 -> int32 exact; float operands to f32 summation order (f32 out)
    and one bf16 rounding (bf16 out); M2 (host scales) and M1 scaled
    (device scales) on the first tile."""
    from cubecl_tpu_torch.ops import matmul as mm

    g = torch.Generator(device=dev).manual_seed(len(dtype))
    M, N, K = 256, 256, 256
    a = _mm_operand(g, dev, dtype, (M, K), K)
    b = _mm_operand(g, dev, dtype, (N, K) if b_transposed else (K, N), K)
    outs = (torch.int32, torch.float32) if dtype == "int8" else \
        (torch.float32, torch.bfloat16)
    tiles = mm._tile_candidates(M, N, K, mm._itemsize(dtype))
    assert tiles
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
    o = torch.empty(M, N, device=dev)
    mm._gemm(a, b, o, tiles[0], b_transposed, 4.0, 0.5,
             counter=mm.matmul_scaled)
    _close(o, mm.matmul_plain(a, b, torch.float32, b_transposed, 2.0))
    sa = torch.tensor([0.5], device=dev)
    sb = torch.tensor([0.25], device=dev)
    mm._gemm(a, b, o, tiles[0], b_transposed, sa, sb,
             counter=mm.matmul_pallas)
    _close(o, mm.matmul_plain(a, b, torch.float32, b_transposed,
                              sa[0] * sb[0]))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cmma_kernel_matches_evaluator(dev, dtype):
    """K0 cmma (matmul_cmma: fragments in shared memory) against the torch
    evaluator on the card and against plain."""
    from cubecl_tpu_torch.ops import matmul as mm

    g = torch.Generator(device=dev).manual_seed(3)
    M, N, K = 256, 256, 128
    a = (torch.randn(M, K, generator=g, device=dev) * K ** -0.25).to(dtype)
    b = (torch.randn(K, N, generator=g, device=dev) * K ** -0.25).to(dtype)
    outs = []
    for c in (CudaRuntime.client(), eval_client(dev)):
        o = c.empty((M * N,), "float32")
        mm.matmul_cmma(c, c.create(a.reshape(-1)), c.create(b.reshape(-1)),
                       o, M, N, K)
        outs.append(o.tensor.view(M, N))
    torch.cuda.synchronize()
    _close(outs[0], outs[1])
    _close(outs[0], mm.matmul_plain(a, b, torch.float32))


def test_quant_kernels_match_plain(dev):
    """The K0 quantize kernel on the card gives the evaluator's int8
    values and scales, bit for bit."""
    from cubecl_tpu_torch.std.quant import QuantScheme
    from cubecl_tpu_torch.std.quant_kernels import quantize

    x = torch.randn(1 << 16, generator=torch.Generator(device=dev)
                    .manual_seed(4), device=dev) * 3
    got = [quantize(c, c.create(x), QuantScheme())
           for c in (CudaRuntime.client(), eval_client(dev))]
    torch.cuda.synchronize()
    assert torch.equal(got[0][0].tensor, got[1][0].tensor)
    assert torch.equal(got[0][1].tensor, got[1][1].tensor)


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
