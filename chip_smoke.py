#!/usr/bin/env python3
"""Smoke test of cubecl_tpu_torch on one CUDA card (an H100).

Builds the port's CUDA kernels (the hand-written ones of
``cubecl_tpu_torch/csrc`` and the ``@cube`` kernels K0 prints, one nvcc per
source, all started together), holds each against its plain PyTorch
version at the shapes of the serving and training paths, drives llama
serving (``generate``) and training (``make_train_step``) at the full width
of the repo's largest llama, trains a GPT-2-small-width transformer, and
checks smaller f32 configs end to end against the plain versions.

    python3 chip_smoke.py          # from the repository root; one card

Phases (lines before the last): 1 device, 2 build, 3 flash vs plain,
4 paged vs plain, 5 serve at full width, 6 serve exactness; then K0:
a the DSL kernels at BASELINE sizes, and RMSNorm at every shape phases b
and c give it, against the torch evaluator on the card and a plain
formula, b serve at full width with RMSNorm through K0
(``use_framework_kernels=True``), c serve exactness with it (which fails
if b or c launched a K0 kernel that phase a did not check). Then
training: d the flash backward kernels (dK/dV, dQ) and the forward's lse
against the plain backward, e the K0 backward kernels (and the forwards
at the train shapes) against the torch evaluator and plain formulas, and
the Functions' dg/db against plain autograd, f train llama 0.77B bf16 at
B 8 x S 1024 (ms/step, peak memory, launches per step, a profiled step,
one step with remat), g train exactness, a d768 f32 step with the kernels
against one with the plain versions, h train the transformer at GPT-2
small's widths (phases f-h fail on a K0 kernel id that a and e did not
hold). Then the serving slice of chunks, int8 KV and pages: i the chunked
paged-attention kernel (P3) against plain at the verify, chunked-prefill,
d768, ragged and int8 shapes, j paged decode on int8 pools against plain
and the KV-bound decode (B 16, context 2048) on bf16 against int8 pools,
k the 0.77B bf16 llama through ``prefill_chunked``, ``decode_chunk``,
``speculative_generate`` (a self-draft and a d768 draft), an int8 cache
and continuous batching with prefix caching on the ``PageAllocator``,
each with its kernel launches checked, l the same paths on the d768 f32
llama against the plain versions (and each batched request against its
solo run). Then the autotuned matmul (BASELINE config 4): m the matmul
kernel (M1; M1 with device scales; M2 with host scales) against plain at
4096^3 and the llama FFN projection 8192 x 2048 x 5632, for bf16, f32,
fp8 e4m3/e5m2 and int8 (exact) operands and both B layouts, every tile
instance checked, n ``matmul_autotuned`` at bf16 and e4m3 4096^3 and the
llama shape, each tuned through captured CUDA graphs timed by CUDA events
into a fresh sqlite store (``CUBECL_ENVIRONMENT_ROOT`` in a temp dir),
the store read back by a second call and by a new tuner, one tune with
checks, the headline TFLOP/s, ``matmul_scaled`` and ``matmul_quantized``,
o ``matmul_cmma`` through K0 with cmma printed (f32 512^3, bf16 512^3
and 4096^3) against plain and the evaluator, and the K0 quant kernels
against plain, bit for bit. Then reductions and comptime fusion (BASELINE
configs 2 and 5): p at 64M f32 ``reduce_sum_autotuned`` (R1, the
``block_sum`` route and the K0 tree, tuned into the temp store, then a
second call untimed), ``reduce_sum``, ``reduce_max``, ``reduce_mean`` and
``reduce_sum_blockwise``, each against the float64 sum or torch's max and
the K0 routes against the evaluator; R1 (``csrc/reduce.cu``) at 64M f32
and bf16 and 128 x 1000 against plain, beside its bound and ``torch.sum``;
block max/min exact; ``sum_things``' four variants and the book's
reduction progression; q ``launch_fused`` for relu((a+b)*c) and
add -> gelu on 16M f32 (one K0 launch each) against the evaluator and
plain, ``into_contiguous`` of a strided 3-D view and ``identity(4096)``;
r ``ThroughputCache``'s four runners measured into the temp store and read
back. Each kernel's line gives its time beside its
bound (bytes over 3.35 TB/s or operations over the dtype's peak) and,
where one PyTorch call computes the same function, that call's time. Then a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero before the last line; without a CUDA device
(or without the package beside it) the script exits non-zero and prints no
result. Imports only torch, numpy and cubecl_tpu_torch.
"""

import atexit
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as TF

# |kernel - plain| <= ATOL + RTOL * |plain|, elementwise.
# f32: the kernels and the plain versions (cuBLAS in full f32, TF32 off) sum
# in different orders; as tests/test_models.py:221.
# bf16: both compute in f32 from the same bf16 inputs and round the output
# once to bf16, so they may differ by one bf16 ulp (2^-8 relative).
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# serve exactness (phase 6, f32, 8 layers): prefill logits within LOGIT_TOL;
# a greedy token may differ only where the top-2 logit gap is below it
LOGIT_TOL = 1e-4
# K0 kernels computing in bf16 op by op (the normalization kernels on bf16
# buffers) against a plain formula computed in f32 and rounded once: a few
# bf16 ulps apart
CHAIN_TOL = (3e-2, 3e-2)
INV_SQRT2 = 1.0 / math.sqrt(2.0)
# the H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W):
# bf16/f16, fp8 and int8 on the tensor cores, f32 off them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float8_e4m3fn: 1979e12, torch.float8_e5m2: 1979e12,
              torch.int8: 1979e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# phase k, the 0.77B bf16 llama served by two paths that round in other
# places (chunked against one-shot prefill, decode_chunk against decode
# steps, whose projections are GEMMs of other heights): some ten bf16
# roundings a layer (2^-9 relative each) over 16 layers move a value by a
# few percent of its scale (sqrt(160) * 2^-9 ~ 2.5%), and logits reach
# |4|. Exactness is phase l's, in f32. A greedy choice may flip only where
# the top-2 logit gap is below twice the logit tolerance.
BF16_PATH_TOL = (1e-1, 5e-2)
BF16_GAP = 0.2


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, ref, what, tol=None):
    """Max abs error of got vs ref; fails outside ``tol`` (default TOL of
    ref's dtype)."""
    atol, rtol = tol or TOL[ref.dtype]
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite kernel output")
    err = (g - r).abs()
    bad = err > atol + rtol * r.abs()
    if bad.any():
        fail(f"{what}: {int(bad.sum())} elements outside atol {atol} rtol "
             f"{rtol}, max abs err {err.max().item()}")
    return err.max().item()


def ptxas_summary(log):
    """(kernel<dtype, D>, registers, spill line) per compiled entry."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+([A-Za-z_]+_kernel)I(13__nv_bfloat16|f)"
                          r"(S\d*_|[af])?Li(\d+)E", m.group(1))
            name = (f"{k.group(1)}<{'f32' if k.group(2) == 'f' else 'bf16'}"
                    f"{', int8 KV' if k.group(3) == 'a' else ''}, "
                    f"{k.group(4)}>" if k else m.group(1))
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


# the rmsnorm launches of phases b and c, as llama's _rmsnorm makes them:
# prefill (B, S, D) and decode (B, D) of the 0.77B bf16 serve and of the
# d768 f32 one
K0_SERVE_SHAPES = [((8, 1024, 2048), torch.bfloat16),
                   ((8, 2048), torch.bfloat16),
                   ((16, 384, 768), torch.float32),
                   ((16, 768), torch.float32)]
RMS_EPS = 1e-5  # LlamaConfig.rms_eps
# SGD step of the train phases f and h: the JAX default 1e-3 moves bf16
# weights of 0.02 by less than their rounding step, so the loss barely moves
TRAIN_LR = 0.1
# the K0 launches of phases f-h, as the models make them: (shape, dtype, op)
# for the forward and the backward kernel of each
K0_TRAIN_SHAPES = [((8, 1023, 2048), torch.bfloat16, "rmsnorm"),   # f
                   ((4, 384, 768), torch.float32, "rmsnorm"),      # g
                   ((8, 1024, 768), torch.bfloat16, "layernorm"),  # h
                   ((8, 1024, 3072), torch.bfloat16, "gelu")]      # h
# phase d: (name, B, H, Hkv, S, D, dtype, causal)
FLASH_BWD_CASES = [("train", 8, 16, 8, 1023, 128, torch.bfloat16, True),
                   ("d768", 2, 12, 4, 384, 64, torch.float32, True),
                   ("ragged", 2, 16, 8, 1021, 128, torch.bfloat16, True),
                   ("non-causal", 2, 8, 8, 512, 64, torch.bfloat16, False)]


def compile_only(client):
    """A client over ``client``'s server whose launches compile and run
    nothing: each traces, prints and starts the nvcc of its kernel. Phase 2
    drives every launch of phase a through it, so that all K0 builds run
    at once; ``wait_builds`` then waits for them."""
    from cubecl_tpu_torch.runtime import ComputeClient

    class CompileOnly(ComputeClient):
        def launch(self, task, buffers, scalars=()):
            self.server.compile_kernel(task)

    return CompileOnly(client.server)


def _plain_softmax(x):
    xf = x.float()
    e = torch.exp(xf - xf.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def _plain_layernorm(x, g, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float()
            + b.float()).to(x.dtype)


def _plain_normalize(x, eps):
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().sum(-1, keepdim=True) + eps)) \
        .to(x.dtype)


def _plain_gelu(x):
    xf = x.float()
    return (xf * (torch.erf(xf * INV_SQRT2) + 1.0) * 0.5).to(x.dtype)


def _plain_rmsnorm(x, g, eps=1e-5):
    xf = x.float()
    ms = xf.square().sum(-1, keepdim=True) * (1.0 / x.shape[-1])
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)


def grad_call(fn, inputs, dy):
    """A call that runs the autograd backward of ``fn(*inputs)`` for
    ``dy`` (the forward runs once, here): the backward of a library call,
    timed as its ``library_ms``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    y = fn(*leaves)
    return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)


def elementwise_bound(n, elem, moved, flops_per_elem):
    """Bound of a row-wise K0 kernel over ``n`` elements of ``elem`` bytes
    that moves ``moved`` such tensors and computes in f32."""
    return bound_ms(flops_per_elem * n, moved * n * elem, torch.float32)


def dsl_cases(dev, gen):
    """Phase a's launches. Each case: ``prepare(client)`` makes its
    buffers on a client and returns the launch (a closure returning the
    output tensor); ``plain()`` is the plain PyTorch formula."""
    from cubecl_tpu_torch.ops import functional as F
    from cubecl_tpu_torch.ops import gelu as G
    from cubecl_tpu_torch.ops import normalization as N

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = []

    def gelu_case(what, x, checked, inplace):
        def prepare(c):
            hx = c.create(x)
            ho = hx if inplace else c.create(torch.empty_like(x))
            return lambda: (G.launch_gelu(c, hx, ho, checked=checked),
                            ho.tensor)[1]
        cases.append(dict(name=what, prepare=prepare,
                          plain=lambda: _plain_gelu(x), tol=None))

    gelu_case("gelu exact f32 1M", rn(1 << 20), False, False)
    gelu_case("gelu checked f32 1M (ragged: 10^6)", rn(10**6), True, False)
    gelu_case("gelu in-place f32 1M", rn(1 << 20), False, True)

    def norm_case(op, x, dtype, inplace=False):
        rows, row = x.shape
        g, b = rn(row, dtype=dtype), rn(row, dtype=dtype)

        def prepare(c):
            hx = c.create(x)
            ho = hx if inplace else c.create(torch.empty_like(x))
            hg, hb = c.create(g), c.create(b)

            def launch():
                if op == "softmax":
                    N.launch_softmax(c, hx, ho, rows, row)
                elif op == "normalize":
                    N.launch_normalize(c, hx, ho, rows, row, eps=1e-6)
                else:
                    N.launch_layernorm(c, hx, hg, hb, ho, rows, row)
                return ho.tensor
            return launch

        plain = {"softmax": lambda: _plain_softmax(x),
                 "normalize": lambda: _plain_normalize(x, 1e-6),
                 "layernorm": lambda: _plain_layernorm(x, g, b)}[op]
        path = "rows" if rows % 8 else "lines"
        name = (f"{op}{' in-place' if inplace else ''} {path} "
                f"{str(dtype)[6:]} {rows}x{row}")
        cases.append(dict(name=name, prepare=prepare, plain=plain,
                          tol=CHAIN_TOL if dtype == torch.bfloat16
                          else None))

    for op in ("softmax", "normalize", "layernorm"):
        norm_case(op, rn(4, 1024), torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        x = rn(8192, 2048, dtype=dtype)
        for op in ("softmax", "normalize", "layernorm"):
            norm_case(op, x, dtype)
    norm_case("softmax", rn(8192, 2048), torch.float32, inplace=True)

    x = rn(8192, 2048, dtype=torch.bfloat16)
    g = rn(2048, dtype=torch.bfloat16)
    b = rn(2048, dtype=torch.bfloat16)
    fn = {"gelu": ((x,), lambda: _plain_gelu(x)),
          "softmax": ((x,), lambda: _plain_softmax(x)),
          "layernorm": ((x, g, b), lambda: _plain_layernorm(x, g, b)),
          "rmsnorm": ((x, g), lambda: _plain_rmsnorm(x, g))}
    for op, (args, plain) in fn.items():
        def prepare(c, op=op, args=args):
            return lambda: getattr(F, op)(*args, client=c)
        cases.append(dict(name=f"{op} fwd bf16 8192x2048", prepare=prepare,
                          plain=plain, tol=None))
    cases[-1]["library"] = lambda: TF.rms_norm(x, (2048,), g, RMS_EPS)
    for shape, dtype in K0_SERVE_SHAPES:
        # own names: the plain lambdas above read x and g when called
        xs, gs = rn(*shape, dtype=dtype), rn(shape[-1], dtype=dtype)

        def prepare(c, xs=xs, gs=gs):
            return lambda: F.rmsnorm(xs, gs, RMS_EPS, client=c)
        cases.append(dict(
            name=f"rmsnorm fwd {'bf16' if dtype == torch.bfloat16 else 'f32'}"
                 f" {'x'.join(map(str, shape))} (llama serve)", prepare=prepare,
            plain=lambda xs=xs, gs=gs: _plain_rmsnorm(xs, gs, RMS_EPS),
            tol=None, library=lambda xs=xs, gs=gs: TF.rms_norm(
                xs, (xs.shape[-1],), gs, RMS_EPS)))
    return cases


def run_case(case, cu, ev, card, phase="a"):
    """Phase a (or e), one case: the K0 kernel against the torch evaluator
    on the card and against the plain formula; kernel and plain times."""
    what = f"K0 {case['name']}"
    got = case["prepare"](cu)()
    want = case["prepare"](ev)()
    torch.cuda.synchronize()
    err_ev = compare(got, want, f"{what} vs evaluator")
    err = compare(got, case["plain"](), f"{what} vs plain", case["tol"])
    launch = case["prepare"](cu)
    ms = cuda_ms(launch)
    plain_ms = cuda_ms(case["plain"])
    lib_ms = cuda_ms(case["library"]) if "library" in case else None
    tol = case["tol"] or TOL[got.dtype]
    lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    print(f"phase {phase} {what}: max abs err {err} vs plain (atol/rtol {tol}), "
          f"{err_ev} vs the torch evaluator (atol/rtol {TOL[got.dtype]}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib} [{card}]",
          flush=True)
    return {"name": case["name"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms}


def k0_ptxas(cu):
    """'kernel: stack/spill bytes' of each K0 build, from ptxas -v."""
    out = []
    for c in cu.server._cache.values():
        if not hasattr(c.fn, "build"):  # a hand-written kernel's task
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      c.fn.build.log)
        if m:
            out.append(f"{c.name} {m.group(1)}/{m.group(2)}")
    return ", ".join(sorted(set(out)))


def serve_k0(llama, fa, pa, cu, dev, card):
    """Phase b: phase 5's serve with ``use_framework_kernels=True``: every
    RMSNorm (2L+1 per step) is the K0 kernel."""
    cfg = llama.LlamaConfig(vocab=8192, d_model=2048, n_heads=16,
                            n_kv_heads=8, n_layers=16, d_ff=5632, seq=1024,
                            dtype="bfloat16", use_framework_kernels=True)
    model = llama.init_params(cfg, seed=0, device=dev)
    B, S, steps, page = 8, 1024, 64, 128
    max_pages = math.ceil((S + steps) / page)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    pa.paged_attention.launches = 0
    cu.server.reset_counts()
    t0 = time.perf_counter()
    toks = llama.generate(model, prompt, steps, max_pages, page)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    per = 2 * cfg.n_layers + 1
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_attention": pa.paged_attention.launches,
                "_rmsnorm_fwd_k": cu.server.launches["_rmsnorm_fwd_k"]}
    want = {"flash_attention": cfg.n_layers,
            "paged_attention": cfg.n_layers * steps,
            "_rmsnorm_fwd_k": per * (1 + steps)}
    if launches != want or cu.server.launch_count != want["_rmsnorm_fwd_k"]:
        fail(f"serve K0: kernel launches {launches} (all K0: "
             f"{dict(cu.server.launches)}), want {want}")
    if toks.shape != (B, steps) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        fail(f"serve K0: bad tokens {toks.shape} {toks.dtype}")

    cache = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = llama.prefill(model, cache, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if not torch.isfinite(logits.float()).all():
        fail("serve K0: non-finite prefill logits")
    tok = logits.argmax(-1).to(torch.int32)
    again = [tok]
    n0 = cu.server.launch_count
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = llama.decode_step(model, cache, tok)
        tok = logits.argmax(-1).to(torch.int32)
        again.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    per_step = (cu.server.launch_count - n0) / steps
    if not torch.equal(torch.stack(again[:steps], 1), toks):
        fail("serve K0: the warm re-run gave other tokens than generate")
    print(f"phase b serve llama 0.77B bf16 with use_framework_kernels=True "
          f"(RMSNorm on K0): {B} requests x {S} prompt + {steps} greedy "
          f"steps; generate {gen_s:.3f} s cold; launches {launches}; warm "
          f"prefill {prefill_s:.4f} s ({B * S / prefill_s:.0f} prompt "
          f"tok/s), decode {B * steps / decode_s:.1f} tok/s "
          f"({1e3 * decode_s / steps:.3f} ms/step), {per_step:.0f} K0 "
          f"launches per decode step [{card}]", flush=True)
    return {"launches": launches["_rmsnorm_fwd_k"]}


def exactness(llama, dev, framework):
    """Phases 6 and c (bench.py:604-609): a d768 f32 llama served with the
    kernels and with their plain versions; prefill logits within
    LOGIT_TOL, greedy tokens equal but at near-ties. Returns the line."""
    cfg = llama.LlamaConfig(vocab=8192, d_model=768, n_heads=12, n_kv_heads=4,
                            n_layers=8, d_ff=2048, seq=512,
                            use_framework_kernels=framework)
    model = llama.init_params(cfg, seed=1, device=dev)
    B, S, steps, page = 16, 384, 32, 128
    max_pages = math.ceil((S + steps) / page)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)

    def serve(kernels):
        cache = llama.init_kv_cache(cfg, B, max_pages, page, dev)
        logits, cache = llama.prefill(model, cache, prompt, kernels=kernels)
        first = logits
        toks, step_logits = [], []
        for _ in range(steps):
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok)
            step_logits.append(logits)
            logits, cache = llama.decode_step(model, cache, tok,
                                              kernels=kernels)
        return first, torch.stack(toks, 1), torch.stack(step_logits, 1)

    k_first, k_toks, k_logits = serve(True)
    p_first, p_toks, p_logits = serve(False)
    torch.cuda.synchronize()
    logit_err = (k_first - p_first).abs().max().item()
    if not torch.isfinite(k_first).all() or logit_err > LOGIT_TOL:
        fail(f"exactness: prefill logits differ by {logit_err} > {LOGIT_TOL}")
    flips = []
    for b in range(B):
        diff = (k_toks[b] != p_toks[b]).nonzero()
        if len(diff):
            i = int(diff[0])
            top2 = k_logits[b, i].topk(2).values
            gap = (top2[0] - top2[1]).item()
            if gap >= LOGIT_TOL:
                fail(f"exactness: row {b} step {i} tokens differ with a "
                     f"top-2 gap of {gap} >= {LOGIT_TOL}")
            flips.append((b, i, gap))
    same = int((k_toks == p_toks).all(1).sum())
    return (f"exactness llama d768 f32 (8 layers, 12/4 heads, "
            f"use_framework_kernels={framework}): {B} requests x {S} prompt "
            f"+ {steps} steps, kernels vs plain on the card: prefill logits "
            f"max abs err {logit_err} (tol {LOGIT_TOL}); {same}/{B} token "
            f"rows equal; near-tie flips {flips}")


def _plain_rmsnorm_bwd(x, g, dy, eps=RMS_EPS):
    xf, dyg = x.float(), dy.float() * g.float()
    istd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    c = (dyg * xf).mean(-1, keepdim=True)
    return (istd * dyg - xf * (c * istd ** 3)).to(x.dtype)


def _plain_layernorm_bwd(x, g, dy, eps=1e-5):
    xf, dyg = x.float(), dy.float() * g.float()
    xc = xf - xf.mean(-1, keepdim=True)
    istd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    a = dyg.mean(-1, keepdim=True)
    c = (dyg * xc).mean(-1, keepdim=True)
    return (istd * (dyg - a - xc * (c * istd * istd))).to(x.dtype)


def _plain_gelu_bwd(x, dy):
    xf = x.float()
    cdf = (torch.erf(xf * INV_SQRT2) + 1.0) * 0.5
    pdf = torch.exp(-0.5 * xf * xf) / math.sqrt(2.0 * math.pi)
    return (dy.float() * (cdf + xf * pdf)).to(x.dtype)


def _plain_softmax_bwd(y, dy):
    yf, dyf = y.float(), dy.float()
    return ((dyf - (yf * dyf).sum(-1, keepdim=True)) * yf).to(y.dtype)


_DT_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float8_e4m3fn: "e4m3",
              torch.float8_e5m2: "e5m2", torch.int8: "int8",
              torch.int32: "int32"}


def _dt(dtype):
    return _DT_NAMES[dtype]


def bwd_cases(dev, gen):
    """Phase e's launches, in the case form of ``dsl_cases``: the forward
    and the backward kernel of every K0 op that phases f-h launch, at the
    shapes they launch them, and ``_softmax_bwd_k`` (no model uses it) at
    8192 x 2048. The backward kernel is launched as the Functions launch it
    (``F._rows``); the Functions themselves are checked in
    ``param_grad_checks``."""
    from cubecl_tpu_torch.ops import functional as F

    def rn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = []
    for shape, dt, op in K0_TRAIN_SHAPES:
        x, dy = rn(*shape, dtype=dt), rn(*shape, dtype=dt)
        g, b = rn(shape[-1], dtype=dt), rn(shape[-1], dtype=dt)
        inv_n = 1.0 / shape[-1]
        fwd = {"rmsnorm": (lambda c, x=x, g=g: F.rmsnorm(x, g, RMS_EPS,
                                                         client=c),
                           lambda x=x, g=g: _plain_rmsnorm(x, g, RMS_EPS)),
               "layernorm": (lambda c, x=x, g=g, b=b: F.layernorm(
                   x, g, b, client=c), lambda x=x, g=g, b=b:
                   _plain_layernorm(x, g, b)),
               "gelu": (lambda c, x=x: F.gelu(x, client=c),
                        lambda x=x: _plain_gelu(x))}[op]
        bwd = {"rmsnorm": (lambda c, x=x, g=g, dy=dy, n=inv_n: F._rows(
                   F._rmsnorm_bwd_k, x, [x, g, dy], (n, RMS_EPS), c),
                   lambda x=x, g=g, dy=dy: _plain_rmsnorm_bwd(x, g, dy)),
               "layernorm": (lambda c, x=x, g=g, dy=dy, n=inv_n: F._rows(
                   F._layernorm_bwd_k, x, [x, g, dy], (n, 1e-5), c),
                   lambda x=x, g=g, dy=dy: _plain_layernorm_bwd(x, g, dy)),
               "gelu": (lambda c, x=x, dy=dy: F._rows(
                   F._gelu_bwd_k, x, [x, dy], client=c),
                   lambda x=x, dy=dy: _plain_gelu_bwd(x, dy))}[op]
        size = "x".join(map(str, shape))
        # gelu computes in the storage dtype op by op (no f32 cast)
        chain = CHAIN_TOL if op == "gelu" and dt == torch.bfloat16 else None
        lib_fwd, lib_args = {
            "rmsnorm": (lambda x, g, n=shape[-1]: TF.rms_norm(
                x, (n,), g, RMS_EPS), (x, g)),
            "layernorm": (lambda x, g, b, n=shape[-1]: TF.layer_norm(
                x, (n,), g, b, 1e-5), (x, g, b)),
            "gelu": (lambda x: TF.gelu(x, approximate="none"), (x,))}[op]
        library = {"fwd": lambda f=lib_fwd, a=lib_args: f(*a),
                   "bwd": grad_call(lib_fwd, lib_args, dy)}
        for kind, (launch, plain) in (("fwd", fwd), ("bwd", bwd)):
            cases.append(dict(
                name=f"_{op}_{kind}_k {_dt(dt)} {size}", op=op, kind=kind,
                prepare=lambda c, launch=launch: (lambda: launch(c)),
                plain=plain, tol=chain, library=library[kind]))
    for dt in (torch.float32, torch.bfloat16):
        z = rn(8192, 2048, dtype=torch.float32)
        y = torch.softmax(z, -1).to(dt)
        dy = rn(8192, 2048, dtype=dt)
        cases.append(dict(
            name=f"_softmax_bwd_k {_dt(dt)} 8192x2048", op="softmax",
            kind="bwd", prepare=lambda c, y=y, dy=dy: (lambda: F._rows(
                F._softmax_bwd_k, y, [y, dy], client=c)),
            plain=lambda y=y, dy=dy: _plain_softmax_bwd(y, dy),
            tol=CHAIN_TOL if dt == torch.bfloat16 else None,
            library=grad_call(lambda z: torch.softmax(z, -1), (z.to(dt),),
                              dy)))
    return cases


def param_grad_checks(dev, gen, card):
    """Phase e: the norms' Functions on the card (forward kernel, backward
    kernel, dg/db reductions) against plain autograd in f32 on the same
    inputs; dx must equal the backward kernel's direct launch bit for
    bit."""
    from cubecl_tpu_torch.ops import functional as F

    for shape, dt, op in K0_TRAIN_SHAPES:
        if op == "gelu":
            continue
        x, dy = (torch.randn(shape, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        g, b = (torch.randn(shape[-1], generator=gen, device=dev).to(dt)
                for _ in range(2))
        args = (x, g, b) if op == "layernorm" else (x, g)
        leaves = [a.clone().requires_grad_() for a in args]
        getattr(F, op)(*leaves).backward(dy)
        refs = [a.float().requires_grad_() for a in args]
        plain = (lambda x, g, b: torch.nn.functional.layer_norm(
            x, (shape[-1],), g, b, 1e-5)) if op == "layernorm" else \
            (lambda x, g: x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                          + RMS_EPS) * g)
        plain(*refs).backward(dy.float())
        kern = F._layernorm_bwd_k if op == "layernorm" else F._rmsnorm_bwd_k
        dx = F._rows(kern, x, [x, g, dy], (1.0 / shape[-1],
                                           1e-5 if op == "layernorm"
                                           else RMS_EPS))
        torch.cuda.synchronize()
        if not torch.equal(leaves[0].grad, dx):
            fail(f"phase e {op}: the Function's dx is not the backward "
                 "kernel's")
        what = f"phase e {op} {_dt(dt)} {'x'.join(map(str, shape))}"
        errs = [compare(t.grad, r.grad.to(dt), f"{what} d{n}")
                for n, t, r in zip(("g", "b"), leaves[1:], refs[1:])]
        print(f"{what} Function dg/db vs plain f32 autograd: max abs err "
              f"{errs} (atol/rtol {TOL[dt]}); dx equal to the backward "
              f"kernel's launch [{card}]", flush=True)


def flash_backward(fa, dev, gen, card):
    """Phase d: the forward kernel's lse, the dK/dV and dQ kernels against
    the plain backward on the same (q, k, v, o, lse, do), and the autograd
    Function against both kernels; CUDA-event times."""
    rows = {}
    for name, B, H, Hkv, S, D, dt, causal in FLASH_BWD_CASES:
        q, do = (torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dt)
                for _ in range(2))
        what = (f"flash bwd {name} {_dt(dt)} B{B} H{H}/{Hkv} S{S} D{D} "
                f"{'causal' if causal else 'non-causal'}")
        o, lse = fa._flash_forward(q, k, v, causal, None, True)
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal,
                                                  return_lse=True)
        torch.cuda.synchronize()
        err_o = compare(o, o_ref, f"{what}: o")
        err_lse = compare(lse, lse_ref, f"{what}: lse")
        di = (do.float() * o.float()).sum(-1)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, di, causal)
        ref = fa.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        err = [compare(a, r, f"{what}: d{n}")
               for n, a, r in zip("qkv", (dq, dk, dv), ref)]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.flash_attention(*leaves, causal).backward(do)
        if not all(torch.equal(t.grad, a)
                   for t, a in zip(leaves, (dq, dk, dv))):
            fail(f"{what}: the autograd Function's grads are not the "
                 "kernels'")
        del ref, leaves
        fwd_ms = cuda_ms(lambda: fa._flash_forward(q, k, v, causal, None,
                                                   True))
        dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di,
                                                  causal))
        dq_ms = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, di,
                                                causal))
        plain_ms = cuda_ms(lambda: fa.flash_attention_backward_plain(
            q, k, v, o, lse, do, causal), iters=5, warmup=1)
        lib_ms = cuda_ms(grad_call(
            lambda q, k, v: TF.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), (q, k, v), do))
        print(f"phase d {what}: max abs err o {err_o}, lse {err_lse}, dq "
              f"{err[0]}, dk {err[1]}, dv {err[2]} (atol/rtol {TOL[dt]}; "
              f"lse {TOL[torch.float32]}); kernels: forward with lse "
              f"{fwd_ms:.4f} ms, dK/dV {dkv_ms:.4f} ms, dQ {dq_ms:.4f} ms; "
              f"plain backward {plain_ms:.4f} ms, SDPA's backward "
              f"{lib_ms:.4f} ms [{card}]", flush=True)
        lse_bytes = 8 * B * H * S           # lse and di, f32
        elem = torch.finfo(dt).bits // 8
        rows[name] = dict(
            dq_err=err[0], dkv_err=max(err[1:]), fwd_ms=fwd_ms,
            dkv_ms=dkv_ms, dq_ms=dq_ms, plain_ms=plain_ms, library_ms=lib_ms,
            dkv_bound=flash_bound(B, H, Hkv, S, S, D, dt, causal, 4,
                                  elem * D * 2 * B * Hkv * S + lse_bytes),
            dq_bound=flash_bound(B, H, Hkv, S, S, D, dt, causal, 3,
                                 elem * D * B * H * S + lse_bytes))
    return rows


def _reset_counts(fa, cu):
    fa.flash_attention.launches = 0
    fa.flash_bwd_dkv.launches = 0
    fa.flash_bwd_dq.launches = 0
    cu.server.reset_counts()


def _launches(fa, cu, k0_names):
    out = {"flash_attention": fa.flash_attention.launches,
           "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
           "flash_bwd_dq": fa.flash_bwd_dq.launches}
    out.update({n: cu.server.launches[n] for n in k0_names})
    return out


def _train(step, model, tokens, n):
    """``n`` steps on one batch: losses and host seconds per step (each
    ends in the loss's device-to-host copy)."""
    losses, secs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(step(model, tokens).item())
        secs.append(time.perf_counter() - t0)
    return losses, secs


def profile_step(step, model, tokens):
    """One step under torch.profiler: (wall ms, device busy ms, ms by
    kernel group, the five kernels of group "other" that take longest), or
    None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, tokens).item()
        wall = time.perf_counter() - t0
    groups, other = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = e.name
        key = ("flash dK/dV" if "flash_bwd_dkv" in n else
               "flash dQ" if "flash_bwd_dq" in n else
               "flash forward" if "flash_fwd" in n else
               "paged chunked (P3)" if "paged_chunked" in n else
               "paged decode (P1)" if "paged_decode" in n else
               "K0 @cube" if re.search(r"_(rmsnorm|layernorm|gelu)_", n) else
               "GEMM" if re.search(r"gemm|nvjet|xmma|cutlass|sm90", n, re.I)
               else "other")
        ms = e.time_range.elapsed_us() / 1e3
        groups[key] = groups.get(key, 0.0) + ms
        if key == "other":
            other[n[:60]] = other.get(n[:60], 0.0) + ms
    if not groups:
        return None
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    return wall * 1e3, sum(groups.values()), groups, top


def train_llama(llama, fa, cu, dev, card):
    """Phase f (bench.py:541-545): SGD steps of the 0.77B bf16 llama on one
    repeated batch; the launches of every kernel of the path, counted from 0
    over the timed steps; one profiled step; one step with remat from the
    same initial weights."""
    cfg = llama.LlamaConfig(vocab=8192, d_model=2048, n_heads=16,
                            n_kv_heads=8, n_layers=16, d_ff=5632, seq=1024,
                            dtype="bfloat16", use_framework_kernels=True)
    B, S, steps, L = 8, 1024, 5, cfg.n_layers
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    model = llama.init_params(cfg, seed=0, device=dev)
    step = llama.make_train_step(cfg, TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k0 = ("_rmsnorm_fwd_k", "_rmsnorm_bwd_k")
    _reset_counts(fa, cu)
    losses, secs = _train(step, model, tokens, steps)
    launches = _launches(fa, cu, k0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per = 2 * L + 1
    want = {"flash_attention": L * steps, "flash_bwd_dkv": L * steps,
            "flash_bwd_dq": L * steps, "_rmsnorm_fwd_k": per * steps,
            "_rmsnorm_bwd_k": per * steps}
    if launches != want or cu.server.launch_count != 2 * per * steps:
        fail(f"train llama: kernel launches {launches} (all K0: "
             f"{dict(cu.server.launches)}), want {want}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train llama: losses {losses} are not finite and falling")
    ms = 1e3 * statistics.median(secs[1:])
    prof = profile_step(step, model, tokens)
    print(f"phase f train llama 0.77B bf16 (d2048, 16 layers, 16/8 heads, "
          f"use_framework_kernels=True, no remat): B {B} x S {S} tokens, "
          f"SGD lr {TRAIN_LR}, {steps} steps on one batch: losses {losses}; "
          f"{ms:.2f} ms/step warm (median of steps 2-{steps}; step 1 "
          f"{1e3 * secs[0]:.2f} ms), {B * (S - 1) / ms * 1e3:.0f} tok/s; "
          f"peak memory {peak:.2f} GiB; launches per step "
          f"{ {k: v // steps for k, v in launches.items()} } [{card}]",
          flush=True)
    if prof is None:
        print("phase f profile: the trace holds no device time; device "
              "busy share not measured", flush=True)
    else:
        wall, busy, groups, top = prof
        print(f"phase f profile of one step: wall {wall:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%, idle "
              f"{100 - 100 * busy / wall:.1f}%); device ms by group "
              f"{ {k: round(v, 3) for k, v in sorted(groups.items())} }; "
              f"longest in other: { {k: round(v, 3) for k, v in top} } "
              f"[{card}]", flush=True)
    del model, step
    torch.cuda.empty_cache()
    cfg_r = dataclasses.replace(cfg, remat=True)
    model = llama.init_params(cfg_r, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (loss_r,), (sec_r,) = _train(llama.make_train_step(cfg_r, TRAIN_LR),
                                 model, tokens, 1)
    peak_r = torch.cuda.max_memory_allocated() / 2**30
    if abs(loss_r - losses[0]) > 1e-6 * abs(losses[0]):
        fail(f"train llama: the remat step's loss {loss_r} is not the first "
             f"step's {losses[0]}")
    print(f"phase f remat=True: one step from the same weights, loss "
          f"{loss_r} (no remat {losses[0]}), {1e3 * sec_r:.2f} ms, peak "
          f"memory {peak_r:.2f} GiB [{card}]", flush=True)
    del model
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items()}


def train_exactness(llama, dev, framework):
    """Phase g (bench.py:604-609): one SGD step of the d768 f32 llama at
    B 4 x S 384 with the kernels and one with their plain versions, from
    the same weights: loss to 1e-5 relative, every gradient and updated
    weight to 1e-4 of its max-abs. Returns the line."""
    cfg = llama.LlamaConfig(vocab=8192, d_model=768, n_heads=12, n_kv_heads=4,
                            n_layers=8, d_ff=2048, seq=512,
                            use_framework_kernels=framework)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (4, 385), dtype=np.int32)).to(dev)
    runs = []
    for kernels in (True, False):
        model = llama.init_params(cfg, seed=1, device=dev)
        loss = llama.make_train_step(cfg, 1e-3, kernels=kernels)(model,
                                                                 tokens)
        runs.append((loss.item(), dict(model.named_parameters())))
    (lk, pk), (lp, pp) = runs
    if abs(lk - lp) > 1e-5 * abs(lp):
        fail(f"train exactness: loss {lk} with kernels, {lp} plain")
    worst = {"grad": 0.0, "weight": 0.0}
    for name, p in pp.items():
        for what, a, b in (("grad", pk[name].grad, p.grad),
                           ("weight", pk[name], p)):
            rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            if rel > 1e-4:
                fail(f"train exactness: {name} {what} differs by {rel} of "
                     "its max-abs (> 1e-4)")
            worst[what] = max(worst[what], rel)
    return (f"train exactness llama d768 f32 (8 layers, 12/4 heads, "
            f"use_framework_kernels={framework}): B 4 x S 384, one SGD step "
            f"with the kernels and one with the plain versions: loss {lk} "
            f"vs {lp} (rel {abs(lk - lp) / abs(lp):.2e}, tol 1e-5); worst "
            f"gradient {worst['grad']:.2e} and updated weight "
            f"{worst['weight']:.2e} of their max-abs (tol 1e-4)")


def train_transformer(fa, cu, dev, card):
    """Phase h: SGD steps of the transformer at GPT-2 small's widths
    (openai-community/gpt2 config.json: n_embd 768, n_head 12, n_layer 12,
    n_positions 1024, vocab 50257; d_ff 3072), bf16, B 8 x S 1024: flash
    with head_dim 64, LayerNorm and GELU on K0 forward and backward."""
    from cubecl_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(
        vocab=50257, d_model=768, n_heads=12, n_layers=12, d_ff=3072,
        seq=1025, dtype="bfloat16")
    B, steps, L = 8, 4, cfg.n_layers
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, cfg.seq), dtype=np.int32)).to(dev)
    model = transformer.init_params(cfg, seed=2, device=dev)
    step = transformer.make_train_step(cfg, TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k0 = ("_layernorm_fwd_k", "_layernorm_bwd_k", "_gelu_fwd_k",
          "_gelu_bwd_k")
    _reset_counts(fa, cu)
    losses, secs = _train(step, model, tokens, steps)
    launches = _launches(fa, cu, k0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"flash_attention": L * steps, "flash_bwd_dkv": L * steps,
            "flash_bwd_dq": L * steps,
            "_layernorm_fwd_k": (2 * L + 1) * steps,
            "_layernorm_bwd_k": (2 * L + 1) * steps,
            "_gelu_fwd_k": L * steps, "_gelu_bwd_k": L * steps}
    if launches != want or cu.server.launch_count != sum(
            want[k] for k in k0):
        fail(f"train transformer: kernel launches {launches} (all K0: "
             f"{dict(cu.server.launches)}), want {want}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train transformer: losses {losses} are not finite and "
             "falling")
    ms = 1e3 * statistics.median(secs[1:])
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase h train transformer {n_params / 1e6:.1f}M bf16 (GPT-2 "
          f"small widths: d768, 12 layers, 12 heads, d_ff 3072, vocab "
          f"50257): B {B} x S {cfg.seq - 1}, SGD lr {TRAIN_LR}, {steps} "
          f"steps on one batch: losses {losses}; {ms:.2f} ms/step warm "
          f"(median of steps 2-{steps}), peak memory {peak:.2f} GiB; "
          f"launches per step { {k: v // steps for k, v in launches.items()} }"
          f" [{card}]", flush=True)
    del model, step
    torch.cuda.empty_cache()
    return launches


def bound_ms(flops, nbytes, dtype):
    """The least time the card could take for ``flops`` operations of
    ``dtype`` and ``nbytes`` moved (each input byte read once, each output
    byte written once): (ms, the term that bounds it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def flash_bound(B, H, Hkv, Sq, Sk, D, dtype, causal, products=2,
                extra_bytes=0):
    """Bound of an attention call over (B, H, Sq, D) queries and (B, Hkv,
    Sk, D) keys and values, of ``products`` matrix products per live
    (query, key) pair and head: the forward's two, or the dK/dV kernel's
    four and the dQ kernel's three. Bytes: q, k, v and o (or the grads in
    their place), plus ``extra_bytes``."""
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * D * (2 * B * H * Sq + 2 * B * Hkv * Sk) + extra_bytes
    return bound_ms(2 * products * D * B * H * pairs, nbytes, dtype)


def paged_bound(q_dtype, kv_elem, D, H, Hkv, n_live, kv_live, quant,
                rows):
    """Bound of paged attention. ``n_live``: per query row (of every batch
    row), the positions it attends; ``kv_live``: per batch row, the
    positions its kv heads read. Two products per (query row, position,
    head); bytes: q and o (``rows`` query tokens of H heads), the live K
    and V of each kv head, their int8 scales."""
    flops = 4 * D * H * sum(n_live)
    elem = torch.finfo(q_dtype).bits // 8
    kv = sum(kv_live) * Hkv * (2 * D * kv_elem + (8 if quant else 0))
    return bound_ms(flops, 2 * rows * H * D * elem + kv, q_dtype)


def chunked_live(starts, lengths, C):
    """(positions attended per query token, positions read per row) of
    paged_attention_chunked."""
    n = [max(0, min(ln, st + i + 1)) for st, ln in zip(starts, lengths)
         for i in range(C)]
    return n, [max(0, min(ln, st + C)) for st, ln in zip(starts, lengths)]


def int8_pools(shape, dev, gen):
    """int8 K and V pools with their scales, quantized from N(0, 1) pools
    one layer at a time."""
    from cubecl_tpu_torch.ops.paged_attention import quantize_kv

    kq = torch.empty(shape, dtype=torch.int8, device=dev)
    vq = torch.empty_like(kq)
    ks = torch.empty(shape[:4], device=dev)
    vs = torch.empty_like(ks)
    for layer in range(shape[0]):
        for vals, scales in ((kq, ks), (vq, vs)):
            vals[layer], scales[layer] = quantize_kv(torch.randn(
                shape[1:], generator=gen, device=dev))
    return kq, vq, ks, vs


# phase i: (name, B, L, Hkv, G, C, D, max_pages, starts, lengths or None
# for starts + C, dtype, int8 pools); page 128
CHUNKED_CASES = [
    ("verify", 8, 16, 8, 2, 5, 128, 9, [1051] * 8, None, torch.bfloat16,
     False),
    ("prefill start 0", 8, 16, 8, 2, 256, 128, 9, [0] * 8, None,
     torch.bfloat16, False),
    ("prefill start 768", 8, 16, 8, 2, 256, 128, 9, [768] * 8, None,
     torch.bfloat16, False),
    ("d768", 16, 8, 4, 3, 5, 64, 4, [395] * 16, None, torch.float32, False),
    ("ragged", 8, 4, 8, 2, 16, 128, 8, [0, 1, 127, 128, 500, 1000, 640, 3],
     [0, 17, 143, 144, 510, 1016, 656, 10], torch.bfloat16, False),
    ("verify int8", 8, 16, 8, 2, 5, 128, 9, [1051] * 8, None,
     torch.bfloat16, True),
    ("prefill int8 start 768", 8, 16, 8, 2, 256, 128, 9, [768] * 8, None,
     torch.bfloat16, True),
]
NO_LIBRARY_PAGED = ("no single PyTorch call attends through a block "
                    "table: SDPA needs the pages gathered first")


def chunked_vs_plain(pa, dev, gen, card):
    """Phase i: P3 against its plain version at the shapes of the slice's
    path (the speculative verify step, chunked prefill, the d768 config,
    a ragged batch with a length-0 row, int8 pools); CUDA-event times,
    each launch on the next layer of the pool, as the layers of a step
    walk it."""
    page, rows = 128, {}
    for (name, B, L, Hkv, G, C, D, max_pages, starts, lengths, dt,
         quant) in CHUNKED_CASES:
        lengths = lengths or [s + C for s in starts]
        P = B * max_pages + 5
        shape = (L, Hkv, P, page, D)
        q = torch.randn(B, Hkv * G, C, D, generator=gen, device=dev).to(dt)
        if quant:
            kp, vp, ks, vs = int8_pools(shape, dev, gen)
        else:
            kp, vp = (torch.randn(shape, generator=gen, device=dev).to(dt)
                      for _ in range(2))
            ks = vs = None
        table = torch.randperm(P, generator=gen, device=dev)[:B * max_pages]
        table = table.view(B, max_pages).to(torch.int32)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        sc = dict(k_scales=ks, v_scales=vs)
        got = pa.paged_attention_chunked(q, kp, vp, table, ln, st,
                                         layer=L - 1, **sc)
        torch.cuda.synchronize()
        what = (f"P3 {name} {_dt(dt)} q{'/int8 KV' if quant else ''} B{B} "
                f"Hkv{Hkv} G{G} C{C} D{D} page{page} layer{L - 1}/{L}")
        err = compare(got, pa.paged_attention_chunked_plain(
            q, kp, vp, table, ln, st, layer=L - 1, **sc), what)
        if 0 in lengths and got[lengths.index(0)].any():
            fail(f"{what}: a length-0 row is not zero")
        layers = iter(range(10**9))
        ms = cuda_ms(lambda: pa.paged_attention_chunked(
            q, kp, vp, table, ln, st, layer=next(layers) % L, **sc),
            iters=32)
        plain_ms = cuda_ms(lambda: pa.paged_attention_chunked_plain(
            q, kp, vp, table, ln, st, layer=next(layers) % L, **sc),
            iters=8, warmup=1)
        n_live, kv_live = chunked_live(starts, lengths, C)
        bms, by = paged_bound(dt, 1 if quant else kp.element_size(), D,
                              Hkv * G, Hkv, n_live, kv_live, quant, B * C)
        print(f"phase i {what}: max abs err {err} (atol/rtol {TOL[dt]}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}; {100 * bms / ms:.1f}% of it) [{card}]",
              flush=True)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by)
        del q, kp, vp, ks, vs
    torch.cuda.empty_cache()
    return rows


def paged_int8(pa, dev, gen, card):
    """Phase j: P1 on int8 pools against its plain version (a ragged batch
    and the serving shape), then the KV-bound decode of ROADMAP Queue 1
    item 8: the 0.77B llama's widths (16 layers, 8 kv heads, hd 128, 2
    query heads per kv head), B 16 at context 2048, bf16 pools against
    int8 pools; kernel µs and GB/s of KV read."""
    page, rows = 128, {}
    for name, B, L, Hkv, G, D, max_pages, lengths, quant in [
            ("ragged int8", 8, 4, 8, 2, 128, 8,
             [0, 1, 127, 128, 129, 1000, 640, 1024], True),
            ("serving int8", 8, 16, 8, 2, 128, 9, [1056] * 8, True),
            ("KV-bound bf16", 16, 16, 8, 2, 128, 16, [2048] * 16, False),
            ("KV-bound int8", 16, 16, 8, 2, 128, 16, [2048] * 16, True)]:
        P = B * max_pages + 5
        shape = (L, Hkv, P, page, D)
        q = torch.randn(B, Hkv * G, D, generator=gen,
                        device=dev).to(torch.bfloat16)
        if quant:
            kp, vp, ks, vs = int8_pools(shape, dev, gen)
        else:
            kp, vp = (torch.randn(shape, generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
            ks = vs = None
        table = torch.randperm(P, generator=gen, device=dev)[:B * max_pages]
        table = table.view(B, max_pages).to(torch.int32)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        sc = dict(k_scales=ks, v_scales=vs)
        got = pa.paged_attention(q, kp, vp, table, ln, layer=L - 1, **sc)
        torch.cuda.synchronize()
        what = (f"P1 {name} pools, bf16 q B{B} Hkv{Hkv} G{G} D{D} "
                f"page{page} layer{L - 1}/{L}")
        err = compare(got, pa.paged_attention_plain(
            q, kp, vp, table, ln, layer=L - 1, **sc), what)
        if 0 in lengths and got[lengths.index(0)].any():
            fail(f"{what}: a length-0 row is not zero")
        layers = iter(range(10**9))
        ms = cuda_ms(lambda: pa.paged_attention(
            q, kp, vp, table, ln, layer=next(layers) % L, **sc), iters=32)
        plain_ms = cuda_ms(lambda: pa.paged_attention_plain(
            q, kp, vp, table, ln, layer=next(layers) % L, **sc), iters=8,
            warmup=1)
        bms, by = paged_bound(torch.bfloat16, kp.element_size(), D, Hkv * G,
                              Hkv, [max(x, 0) for x in lengths], lengths,
                              quant, B)
        kv_gb = sum(lengths) * Hkv * (2 * D * kp.element_size()
                                      + (8 if quant else 0)) / 1e9
        print(f"phase j {what}: max abs err {err} (atol/rtol "
              f"{TOL[torch.bfloat16]}); kernel {1e3 * ms:.1f} µs "
              f"({kv_gb / ms * 1e3:.0f} GB/s of KV), plain {plain_ms:.4f} "
              f"ms, bound {1e3 * bms:.1f} µs ({by}; {100 * bms / ms:.1f}% "
              f"of it) [{card}]", flush=True)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by,
                          kv_gb_per_s=kv_gb / ms * 1e3)
        del q, kp, vp, ks, vs
    torch.cuda.empty_cache()
    return rows


def greedy_ref(llama, model, prompt, steps, max_pages, page, kernels=True):
    """``generate``'s greedy run, written out to keep the logits: tokens
    (B, steps) and the f32 logits (B, steps, vocab) each was taken from."""
    cache = llama.init_kv_cache(model.cfg, prompt.shape[0], max_pages, page,
                                prompt.device)
    logits, cache = llama.prefill(model, cache, prompt, kernels=kernels)
    toks, lgs = [], []
    for _ in range(steps):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        lgs.append(logits.float())
        logits, cache = llama.decode_step(model, cache, tok, kernels=kernels)
    return torch.stack(toks, 1), torch.stack(lgs, 1)


def teacher_forced_verify(llama, model, cache, want, want_logits, C, what,
                          tol):
    """The verify step on the greedy stream: ``want``'s tokens go through
    ``decode_chunk`` C at a time on ``cache`` (the prompt's prefill), and
    the logits after each token are held against ``want_logits`` at the
    next step (computed by ``decode_step``), whatever the top-2 gaps.
    Returns the max abs error."""
    steps, err = want.shape[1], 0.0
    for s0 in range(0, steps, C):
        logits, cache = llama.decode_chunk(model, cache, want[:, s0:s0 + C])
        n = min(C, steps - 1 - s0)
        if n > 0:
            err = max(err, compare(logits[:, :n],
                                   want_logits[:, s0 + 1:s0 + 1 + n],
                                   f"{what} at steps {s0 + 1}..{s0 + n}",
                                   tol))
    return err


def tie_prefix(got, want, want_logits, gap_tol, what):
    """Tokens ``got`` must equal ``want`` in each row up to the row's first
    step whose top-2 logit gap (in ``want_logits``) is below ``gap_tol``,
    where another rounding may flip the greedy choice. Returns per row the
    length of that prefix and the steps where the tokens agree from the
    start."""
    top2 = want_logits.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < gap_tol
    prefix, agree = [], []
    for b in range(want.shape[0]):
        ties = near[b].nonzero()
        n = int(ties[0]) if len(ties) else want.shape[1]
        diff = (got[b] != want[b]).nonzero()
        first = int(diff[0]) if len(diff) else want.shape[1]
        if first < n:
            fail(f"{what}: row {b} differs at step {first}, before its "
                 f"first near tie at step {n} (gap tolerance {gap_tol})")
        prefix.append(n)
        agree.append(first)
    return prefix, agree


def recording(llama, name, log):
    """Wrap ``llama.<name>`` so that each call appends (args, result) to
    ``log``; returns the function that undoes it."""
    orig = getattr(llama, name)

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        log.append((args, out))
        return out

    setattr(llama, name, wrapped)
    return lambda: setattr(llama, name, orig)


def speculative_checked(llama, pa, fa, model, draft, prompt, steps, gamma,
                        max_pages, page, want, want_logits, gap_tol,
                        self_draft, what, kernels=True):
    """``speculative_generate`` timed, its tokens held against ``want``
    (the greedy stream, up to each row's first near tie), its kernel
    launches against what the rounds it ran must launch, and, for a
    self-draft, every rejection against the verify logits: the target's
    logit of the rejected proposal within ``gap_tol`` of its top logit.
    Returns (tokens, acceptance, seconds, rounds, stats)."""
    verify, drafts = [], []
    undo = [recording(llama, "decode_chunk", verify),
            recording(llama, "decode_step", drafts)]
    fa.flash_attention.launches = pa.paged_attention.launches = 0
    pa.paged_attention_chunked.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, acc = llama.speculative_generate(
            model, prompt, steps, draft, gamma, max_pages, page,
            kernels=kernels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    L, Ld = model.cfg.n_layers, draft.cfg.n_layers
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_attention": pa.paged_attention.launches,
                "paged_attention_chunked":
                    pa.paged_attention_chunked.launches}
    want_n = ({"flash_attention": L + Ld,
               "paged_attention": Ld * len(drafts),
               "paged_attention_chunked": L * len(verify)} if kernels
              else dict.fromkeys(launches, 0))
    if launches != want_n:
        fail(f"{what}: kernel launches {launches}, want {want_n}")
    if toks.shape != want.shape:
        fail(f"{what}: tokens {tuple(toks.shape)}, want {tuple(want.shape)}")
    prefix, _ = tie_prefix(toks, want, want_logits, gap_tol, what)
    rejections, gaps = 0, []
    for (args, (logits, _)) in verify:
        chunk = args[2]
        props, tstar = chunk[:, 1:], logits.argmax(-1)[:, :gamma]
        for b in range(chunk.shape[0]):
            miss = (props[b] != tstar[b]).nonzero()
            if len(miss):
                i = int(miss[0])
                lg = logits[b, i].float()
                gaps.append((lg.max() - lg[props[b, i].long()]).item())
                rejections += 1
    if self_draft and any(g >= gap_tol for g in gaps):
        fail(f"{what}: the self-draft had proposals rejected at logit gaps "
             f"{sorted(gaps)[-3:]} >= {gap_tol}")
    return toks, acc, secs, len(verify), dict(
        launches=launches, prefix_min=min(prefix),
        prefix_mean=sum(prefix) / len(prefix), rejections=rejections,
        max_rejection_gap=max(gaps, default=0.0))


def continuous_batching(llama, model, requests, slots, num_pages, page,
                        table_w, dev, chunk=256, kernels=True):
    """Serve ``requests`` (prompt token lists with the number of tokens to
    generate) through ``slots`` batch rows over ``num_pages`` pages, as a
    vLLM-style server does on the port: a request waits for a free slot and
    for pages (a stall); on admission ``PageAllocator.admit_cached``
    attaches the cached full pages of its prompt and ``prefill_chunked``
    runs only the rest, after which the prompt's full pages are
    registered; the decode steps batch every slot (empty ones parked on a
    page of their own); a row that needs a page the pool does not have is
    preempted (its pages released, the request requeued first, its prompt
    and tokens so far recomputed on return). Returns (generated tokens per
    request, stats)."""
    from cubecl_tpu_torch.runtime.pages import PageAllocator

    alloc = PageAllocator(num_pages, page)
    assert alloc.admit(-1, 1)                   # the parking page
    park = alloc.block_table([-1], table_w)[0]
    cache = llama.init_kv_cache(model.cfg, slots, table_w, page, dev,
                                num_pages=num_pages)
    out = [[] for _ in requests]
    todo, slot = list(range(len(requests))), [None] * slots
    st = dict(steps=0, stalls=0, preemptions=0, prefill_chunks=0,
              prefill_tokens=0, cached_tokens=0)
    finished = 0

    def finish(s):
        nonlocal finished
        alloc.release(slot[s])
        slot[s] = None
        finished += 1

    while finished < len(requests):
        for s in range(slots):
            if slot[s] is not None or not todo:
                continue
            rid = todo[0]
            prompt, _ = requests[rid]
            toks = prompt + out[rid]
            cached = alloc.admit_cached(rid, toks)
            if cached < 0:
                st["stalls"] += 1
                break
            todo.pop(0)
            if cached >= len(toks):
                fail(f"continuous batching: request {rid} is cached whole")
            one = llama.KVCache(
                cache.k, cache.v,
                torch.from_numpy(alloc.block_table([rid], table_w)).to(dev),
                torch.tensor([cached], dtype=torch.int32, device=dev), page,
                cache.k_scales, cache.v_scales)
            suffix = torch.tensor([toks[cached:]], dtype=torch.int32,
                                  device=dev)
            logits, _ = llama.prefill_chunked(model, one, suffix, chunk,
                                              kernels=kernels)
            alloc.register_prefix(rid, prompt)
            st["prefill_chunks"] += -(-suffix.shape[1] // chunk)
            st["prefill_tokens"] += suffix.shape[1]
            st["cached_tokens"] += cached
            out[rid].append(int(logits.argmax(-1)))
            slot[s] = rid
            if len(out[rid]) == requests[rid][1]:
                finish(s)
        for s in range(slots):      # the page of the token each row writes
            if slot[s] is not None and not alloc.extend(slot[s], 1):
                alloc.release(slot[s])
                todo.insert(0, slot[s])
                slot[s] = None
                st["preemptions"] += 1
        active = [s for s in range(slots) if slot[s] is not None]
        if not active:
            if todo and st["stalls"] > 10 * len(requests) + 100:
                fail("continuous batching: the pool cannot hold a request")
            continue
        cache.page_indices = torch.from_numpy(np.stack([
            park if r is None else alloc.block_table([r], table_w)[0]
            for r in slot])).to(dev)
        cache.lengths = torch.tensor(
            [0 if r is None else alloc.lengths[r] - 1 for r in slot],
            dtype=torch.int32, device=dev)
        feed = torch.tensor([0 if r is None else out[r][-1] for r in slot],
                            dtype=torch.int32, device=dev)
        logits, cache = llama.decode_step(model, cache, feed, kernels=kernels)
        st["steps"] += 1
        nxt = logits.argmax(-1).tolist()
        for s in active:
            out[slot[s]].append(nxt[s])
            if len(out[slot[s]]) == requests[slot[s]][1]:
                finish(s)
    alloc.release(-1)
    st["free_pages_end"] = alloc.num_free_pages()
    if st["free_pages_end"] != num_pages:
        fail(f"continuous batching: {st['free_pages_end']} of {num_pages} "
             "pages free at the end")
    return out, st


def cb_requests(rng, vocab, n, prefix_len, suffix_max, new_min, new_max):
    """``n`` requests sharing one ``prefix_len``-token prefix, with ragged
    suffixes (1 to ``suffix_max`` tokens) and generation lengths."""
    prefix = rng.integers(0, vocab, prefix_len).tolist()
    return [(prefix + rng.integers(0, vocab, int(rng.integers(
        1, suffix_max + 1))).tolist(), int(rng.integers(new_min, new_max + 1)))
            for _ in range(n)]


def serve_slice(llama, pa, fa, dev, card):
    """Phase k: the slice's path on the 0.77B bf16 llama (phase 5's widths
    and weights): chunked prefill, speculative decoding with two drafts,
    decode_chunk against decode steps, int8 KV serving and continuous
    batching with prefix caching, each with its kernel launches checked."""
    cfg = llama.LlamaConfig(vocab=8192, d_model=2048, n_heads=16,
                            n_kv_heads=8, n_layers=16, d_ff=5632, seq=1024,
                            dtype="bfloat16", use_framework_kernels=False)
    L = cfg.n_layers
    model = llama.init_params(cfg, seed=0, device=dev)
    B, S, steps, page, gamma = 8, 1024, 64, 128, 4
    max_pages = 12            # 1536 positions: the speculative rounds' slack
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    out = {}

    def reset():
        fa.flash_attention.launches = pa.paged_attention.launches = 0
        pa.paged_attention.int8_launches = 0
        pa.paged_attention_chunked.launches = 0

    def counts():
        return {"flash_attention": fa.flash_attention.launches,
                "paged_attention": pa.paged_attention.launches,
                "paged_attention_int8": pa.paged_attention.int8_launches,
                "paged_attention_chunked":
                    pa.paged_attention_chunked.launches}

    def check(what, want):
        got = counts()
        want = {k: want.get(k, 0) for k in got}
        if got != want:
            fail(f"{what}: kernel launches {got}, want {want}")
        return got

    # -- chunked prefill against the one-shot prefill
    c1 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    llama.prefill_chunked(model, c1, prompt, 256)           # warm
    c1 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_chunk, c1 = llama.prefill_chunked(model, c1, prompt, 256)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    n_chunked = check("phase k chunked prefill",
                      {"paged_attention_chunked": L * S // 256})
    c2 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_one, c2 = llama.prefill(model, c2, prompt)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    err_l = compare(l_chunk, l_one, "phase k chunked prefill logits",
                    BF16_PATH_TOL)
    err_c = max(compare(getattr(c1, n), getattr(c2, n),
                        f"phase k chunked prefill cache {n}", BF16_PATH_TOL)
                for n in ("k", "v"))
    print(f"phase k chunked prefill llama 0.77B bf16: {B} x {S} prompt in "
          f"chunks of 256, {chunk_s:.4f} s ({B * S / chunk_s:.0f} prompt "
          f"tok/s) against the one-shot prefill's {one_s:.4f} s; last "
          f"logits max abs err {err_l}, caches {err_c} (atol/rtol "
          f"{BF16_PATH_TOL}); launches {n_chunked} [{card}]", flush=True)
    out["chunked_prefill"] = dict(s=chunk_s, one_shot_s=one_s,
                                  logit_err=err_l, cache_err=err_c,
                                  launches=n_chunked)
    del c1, c2

    # -- decode_chunk against C decode steps, after the prompt
    c1 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    _, c1 = llama.prefill(model, c1, prompt)
    c2 = dataclasses.replace(c1, k=c1.k.clone(), v=c1.v.clone())
    nxt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, gamma + 1), dtype=np.int32)).to(dev)
    reset()
    l_chunk, c1 = llama.decode_chunk(model, c1, nxt)
    check("phase k decode_chunk", {"paged_attention_chunked": L})
    l_steps = []
    for i in range(gamma + 1):
        lg, c2 = llama.decode_step(model, c2, nxt[:, i])
        l_steps.append(lg)
    err = compare(l_chunk, torch.stack(l_steps, 1),
                  "phase k decode_chunk vs decode steps", BF16_PATH_TOL)
    print(f"phase k decode_chunk of {gamma + 1} tokens after the {S}-token "
          f"prompt vs {gamma + 1} decode steps: logits max abs err {err} "
          f"(atol/rtol {BF16_PATH_TOL}) [{card}]", flush=True)
    out["decode_chunk_err"] = err
    for name, fn in (
            ("verify step (decode_chunk of 5)",
             lambda m, t: llama.decode_chunk(m, c1, t)[0].float().sum()),
            ("decode step", lambda m, t: llama.decode_step(
                m, c2, t[:, 0])[0].float().sum())):
        prof = profile_step(fn, model, nxt)
        if prof is None:
            print(f"phase k profile of one {name}: the trace holds no device "
                  "time; not measured", flush=True)
            continue
        wall, busy, groups, _ = prof
        print(f"phase k profile of one {name}, B {B} at context {S + 5}: "
              f"wall {wall:.2f} ms, device busy {busy:.2f} ms (idle "
              f"{100 - 100 * busy / wall:.1f}%); device ms by group "
              f"{ {k: round(v, 3) for k, v in sorted(groups.items())} } "
              f"[{card}]", flush=True)
    del c1, c2

    # -- the greedy reference; the verify step fed its tokens
    want, want_logits = greedy_ref(llama, model, prompt, steps, max_pages,
                                   page)
    c1 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    _, c1 = llama.prefill(model, c1, prompt)
    reset()
    err_tf = teacher_forced_verify(llama, model, c1, want, want_logits,
                                   gamma + 1, "phase k teacher-forced verify",
                                   BF16_PATH_TOL)
    del c1
    check("phase k teacher-forced verify",
          {"paged_attention_chunked": L * -(-steps // (gamma + 1))})
    print(f"phase k teacher-forced verify: generate's {steps} tokens fed "
          f"through decode_chunk in chunks of {gamma + 1} after the "
          f"{S}-token prompt; every position's logits against the decode "
          f"steps': max abs err {err_tf} (atol/rtol {BF16_PATH_TOL}) "
          f"[{card}]", flush=True)
    out["teacher_forced_err"] = err_tf

    # -- speculative decoding with two drafts
    draft_cfg = llama.LlamaConfig(vocab=8192, d_model=768, n_heads=12,
                                  n_kv_heads=4, n_layers=8, d_ff=2048,
                                  dtype="bfloat16",
                                  use_framework_kernels=False)
    spec = {}
    for name, draft in (("self-draft", model),
                        ("d768 draft", llama.init_params(draft_cfg, seed=3,
                                                         device=dev))):
        what = f"phase k speculative {name}"
        toks, acc, secs, rounds, st = speculative_checked(
            llama, pa, fa, model, draft, prompt, steps, gamma, max_pages,
            page, want, want_logits, BF16_GAP, name == "self-draft", what)
        print(f"{what}: {B} x {steps} tokens, gamma {gamma}: {rounds} "
              f"rounds in {secs:.3f} s ({B * steps / secs:.1f} tok/s), mean "
              f"acceptance {acc:.3f} of {gamma}; {st['rejections']} "
              f"rejections (largest logit gap {st['max_rejection_gap']:.4f}, "
              f"tolerance {BF16_GAP}); tokens equal generate's up to the "
              f"first near tie (prefix {st['prefix_min']}..{steps} steps, "
              f"mean {st['prefix_mean']:.1f}); launches {st['launches']} "
              f"[{card}]", flush=True)
        spec[name] = dict(tok_s=B * steps / secs, acceptance=acc,
                          rounds=rounds, **st)
    out["speculative"] = spec

    # -- int8 KV: the same weights fed generate's tokens
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    m8 = llama.Llama(cfg8, device=dev)
    m8.load_state_dict(model.state_dict())
    c8 = llama.init_kv_cache(cfg8, B, max_pages, page, dev)
    reset()
    logits, c8 = llama.prefill(m8, c8, prompt)
    diffs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        diffs.append((logits.float() - want_logits[:, i]).abs().max())
        logits, c8 = llama.decode_step(m8, c8, want[:, i])
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t0
    n8 = check("phase k int8 serve", {
        "flash_attention": L, "paged_attention": L * steps,
        "paged_attention_int8": L * steps})
    q = torch.randn(B, cfg.n_heads, cfg.head_dim, generator=torch.Generator(
        device=dev).manual_seed(8), device=dev).to(torch.bfloat16)
    sc = dict(k_scales=c8.k_scales, v_scales=c8.v_scales)
    err8 = max(compare(
        pa.paged_attention(q, c8.k, c8.v, c8.page_indices, c8.lengths,
                           layer=li, **sc),
        pa.paged_attention_plain(q, c8.k, c8.v, c8.page_indices, c8.lengths,
                                 layer=li, **sc),
        f"phase k int8 cache layer {li}") for li in range(L))
    dmax = max(d.item() for d in diffs)
    print(f"phase k int8 KV serve llama 0.77B: {B} x {S} prompt + {steps} "
          f"steps fed generate's tokens, {1e3 * int8_s / steps:.3f} ms/step "
          f"({B * steps / int8_s:.1f} tok/s); launches {n8}; P1 kernel vs "
          f"plain on the final int8 cache, every layer: max abs err {err8}; "
          f"logits against the bf16 cache's: max abs diff {dmax:.4f} (step "
          f"1 {diffs[0].item():.4f}, step {steps} {diffs[-1].item():.4f}) "
          f"[{card}]", flush=True)
    out["int8"] = dict(ms_step=1e3 * int8_s / steps, kernel_err=err8,
                       logit_diff=dmax, launches=n8)
    del m8, c8

    # -- continuous batching with prefix caching
    rng = np.random.default_rng(10)
    reqs = cb_requests(rng, cfg.vocab, 16, 512, 200, 16, 64)
    slots, num_pages, table_w = 8, 14, 7
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, st = continuous_batching(llama, model, reqs, slots, num_pages,
                                   page, table_w, dev)
    torch.cuda.synchronize()
    cb_s = time.perf_counter() - t0
    ncb = check("phase k continuous batching", {
        "paged_attention": L * st["steps"],
        "paged_attention_chunked": L * st["prefill_chunks"]})
    n_tok = sum(len(t) for t in toks)
    if [len(t) for t in toks] != [n for _, n in reqs]:
        fail("continuous batching: a request got the wrong token count")
    if not st["stalls"] or not st["preemptions"]:
        fail(f"continuous batching: the pool did not force stalls and a "
             f"preemption ({st})")
    print(f"phase k continuous batching llama 0.77B bf16: 16 requests "
          f"sharing a 512-token prefix (suffixes 1-200, 16-64 new tokens) "
          f"through {slots} slots over {num_pages} pages of {page}: {n_tok} "
          f"tokens in {cb_s:.3f} s ({n_tok / cb_s:.1f} tok/s); {st} "
          f"(pages free at the end {st['free_pages_end']}/{num_pages}); "
          f"launches {ncb} [{card}]", flush=True)
    out["cb"] = dict(tok_s=n_tok / cb_s, launches=ncb, **st)
    del model
    torch.cuda.empty_cache()
    return out


def slice_exactness(llama, pa, fa, dev, card):
    """Phase l: the slice's path on the d768 f32 llama, kernels against
    the plain versions: speculative decoding (self and weak draft) against
    plain greedy tokens, chunked prefill against the plain one-shot
    prefill, beam search against its plain route, and each request of a
    continuous batch against its solo plain run. A token may differ only
    where the plain run's top-2 logit gap is below LOGIT_TOL."""
    cfg = llama.LlamaConfig(vocab=8192, d_model=768, n_heads=12,
                            n_kv_heads=4, n_layers=8, d_ff=2048, seq=512,
                            use_framework_kernels=False)
    model = llama.init_params(cfg, seed=1, device=dev)
    B, S, steps, page, gamma, max_pages = 8, 256, 32, 128, 4, 4
    prompt = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    want, want_logits = greedy_ref(llama, model, prompt, steps, max_pages,
                                   page, kernels=False)
    lines = []
    weak = llama.init_params(dataclasses.replace(cfg, n_layers=2), seed=4,
                             device=dev)
    for name, draft in (("self-draft", model), ("2-layer draft", weak)):
        _, acc, _, rounds, st = speculative_checked(
            llama, pa, fa, model, draft, prompt, steps, gamma, max_pages,
            page, want, want_logits, LOGIT_TOL, name == "self-draft",
            f"phase l speculative {name}")
        lines.append(f"speculative {name}: acceptance {acc:.3f} over "
                     f"{rounds} rounds, {st['rejections']} rejections, tokens "
                     f"equal plain greedy's up to the first near tie "
                     f"(prefix {st['prefix_min']}..{steps})")

    c1 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    l1, c1 = llama.prefill_chunked(model, c1, prompt, 96)
    c2 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    l2, c2 = llama.prefill(model, c2, prompt, kernels=False)
    err = (l1 - l2).abs().max().item()
    if err > LOGIT_TOL:
        fail(f"phase l prefill_chunked logits differ by {err} > {LOGIT_TOL}")
    errc = max(compare(getattr(c1, n), getattr(c2, n),
                       f"phase l prefill_chunked cache {n}")
               for n in ("k", "v"))
    lines.append(f"prefill_chunked (chunks of 96) vs plain one-shot "
                 f"prefill: logits max abs err {err} (tol {LOGIT_TOL}), "
                 f"caches {errc}")
    del c1, c2

    # a prompt of page - 1 tokens: the beams' first tokens share the last
    # slot of the prompt's page when they fork
    for bs in (100, page - 1):
        bprompt = prompt[0, :bs]
        tk, sk = llama.beam_generate(model, bprompt, 16, beams=4)
        tp, sp = llama.beam_generate(model, bprompt, 16, beams=4,
                                     kernels=False)
        serr = (sk - sp).abs().max().item()
        if not torch.equal(tk, tp) or serr > LOGIT_TOL:
            fail(f"phase l beam_generate {bs} + 16: kernels vs plain route "
                 f"tokens equal {torch.equal(tk, tp)}, scores differ by "
                 f"{serr}")
        # every beam's score is its tokens' log-prob, recomputed whole
        with torch.no_grad():
            lps = torch.log_softmax(llama.forward(model, tk[:, :-1].long())[
                :, bs - 1:].float(), -1)
        rs = lps.gather(-1, tk[:, bs:, None].long())[..., 0].sum(-1)
        rerr = (sk.to(dev) - rs).abs().max().item()
        if rerr > 16 * LOGIT_TOL:
            fail(f"phase l beam_generate {bs} + 16: scores differ from the "
                 f"recomputed log-probs by {rerr} > {16 * LOGIT_TOL}")
        lines.append(f"beam_generate (4 beams, {bs} + 16 tokens): tokens "
                     f"equal to the plain route's, scores max abs err "
                     f"{serr}, {rerr} from the beams' recomputed log-probs")

    rng = np.random.default_rng(12)
    reqs = cb_requests(rng, cfg.vocab, 12, 256, 90, 6, 20)
    toks, st = continuous_batching(llama, model, reqs, 4, 10, 64, 6, dev,
                                   chunk=64)
    pre = []
    for r, (p, n) in enumerate(reqs):
        w, wl = greedy_ref(llama, model, torch.tensor([p], dtype=torch.int32,
                                                      device=dev), n, 6, 64,
                           kernels=False)
        pre += tie_prefix(torch.tensor([toks[r]], device=dev), w, wl,
                          LOGIT_TOL, f"phase l continuous batching request "
                          f"{r}")[0]
    lines.append(f"continuous batching (12 requests, 256-token shared "
                 f"prefix, 4 slots, 10 pages of 64): {st}; every request's "
                 f"tokens equal its solo plain run up to the first near tie "
                 f"({sum(p == n for p, (_, n) in zip(pre, reqs))}/12 whole)")
    del model, weak
    torch.cuda.empty_cache()
    return "exactness llama d768 f32, kernels vs plain: " + "; ".join(lines)


# -- the matmul slice (phases m-o) -------------------------------------------

# the slice's shapes: BASELINE config 4's 4096^3 (M = N = K = MM_S) and
# the 0.77B llama's FFN up-projection at its training batch (B 8 x S 1024
# tokens, d 2048 -> d_ff 5632), (M, N, K)
MM_S = 4096
MM_FFN = (8192, 5632, 2048)
# phase m's shapes, (name, M, N, K)
MM_SHAPES = [(f"{MM_S}^3", MM_S, MM_S, MM_S),
             ("llama FFN 8192x2048x5632", *MM_FFN)]
# phase m's cases: (operands, output, B given as (N, K), epilogue: None,
# "device" scales (M1 scaled, the quantized route) or "host" scales (M2))
MM_CASES = [
    (torch.bfloat16, torch.bfloat16, False, None),
    (torch.bfloat16, torch.float32, False, None),
    (torch.bfloat16, torch.bfloat16, True, None),
    (torch.float32, torch.float32, False, None),
    (torch.float32, torch.bfloat16, True, None),
    (torch.float8_e4m3fn, torch.float32, False, None),
    (torch.float8_e4m3fn, torch.float32, True, None),
    (torch.float8_e5m2, torch.float32, False, None),
    (torch.float8_e5m2, torch.float32, True, None),
    (torch.int8, torch.int32, False, None),
    (torch.int8, torch.int32, True, None),
    (torch.int8, torch.float32, False, "device"),  # matmul_quantized's
    (torch.int8, torch.float32, True, "device"),
    (torch.float8_e4m3fn, torch.bfloat16, True, "host"),
]
MM_SCALES = (0.5, 0.25)  # sa, sb of the scaled epilogues; sa * sb exact
# phase o: matmul_cmma's (operands, M = N = K), as examples/matmul.py
CMMA_CASES = [(torch.float32, 512), (torch.bfloat16, 512),
              (torch.bfloat16, 4096)]
QUANT_N = 4096 * 4096  # matmul_quantized's operands at 4096^2
QUANT_BLOCK = 4096


def mm_compile_only(mm, qk, co):
    """Phase 2: start the nvcc of every K0 kernel of phases n and o
    (``matmul_cmma`` at CMMA_CASES, the quant kernels at 4096^2) through
    the compile-only client ``co``."""
    from cubecl_tpu_torch.std.quant import QuantLevel, QuantScheme

    for dt, S in CMMA_CASES:
        name = str(dt).replace("torch.", "")
        mm.matmul_cmma(co, co.empty((S * S,), name), co.empty((S * S,), name),
                       co.empty((S * S,), "float32"), S, S, S)
    x = co.empty((QUANT_N,), "float32")
    for scheme in (QuantScheme(), QuantScheme(level=QuantLevel.BLOCK,
                                              block_size=QUANT_BLOCK)):
        vals, scales = qk.quantize(co, x, scheme)
        qk.dequantize(co, vals, scales, scheme)
    S = MM_S  # phase n's matmul_quantized, on 2-D handles
    mm.matmul_quantized(co, *(co.empty((S, S), "float32") for _ in range(3)),
                        S, S, S)


def mm_operand(gen, dev, dtype, shape, K):
    """N(0, K^-1/2) entries, so that a sum of K products is ~N(0, 1), in
    ``dtype``; int8 uniform over its whole range."""
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)
    return (torch.randn(shape, generator=gen, device=dev)
            * K ** -0.25).to(dtype)


def mm_bound(M, N, K, in_dt, out_dt):
    """2MNK operations at the operands' peak; a and b read once, the
    output written once."""
    nbytes = (M * K + K * N) * in_dt.itemsize + M * N * out_dt.itemsize
    return bound_ms(2 * M * N * K, nbytes, in_dt)


def mm_library(a, b, out_dt, bt, epilogue):
    """(one PyTorch call computing the case's function on the same
    operands, its name), or (None, why there is none). Timed only."""
    bb = b.t() if bt else b
    if epilogue is None and a.dtype == torch.float32 \
            and out_dt == torch.float32:
        return (lambda: torch.matmul(a, bb)), "torch.matmul (TF32 off)"
    if epilogue is None and a.dtype == torch.bfloat16:
        if out_dt == torch.bfloat16:
            return (lambda: torch.matmul(a, bb)), "torch.matmul"
        return (lambda: torch.mm(a, bb, out_dtype=out_dt)), \
            "torch.mm(out_dtype=float32)"
    if a.dtype == torch.float8_e4m3fn and bt and epilogue != "device":
        # cuBLASLt's fp8 GEMM wants B column-major: B given as (N, K)
        sa, sb = (torch.tensor(s if epilogue else 1.0, device=a.device)
                  for s in MM_SCALES)
        return (lambda: torch._scaled_mm(a, bb, scale_a=sa, scale_b=sb,
                                         out_dtype=out_dt)), \
            "torch._scaled_mm"
    if epilogue is None and a.dtype == torch.int8:
        return (lambda: torch._int_mm(a, bb)), "torch._int_mm"
    return None, "none: no one call computes this"


def _ranked(times, unit):
    """'tile: time, ...' fastest first, each time times ``unit``."""
    return ", ".join(f"{t}: {v * unit:.4f}" for t, v in
                     sorted(times.items(), key=lambda kv: kv[1]))


def _mm_what(sname, in_dt, out_dt, bt, epilogue):
    kern = "M2" if epilogue == "host" else "M1"
    scaled = {"device": " x sa*sb (device scalars)",
              "host": " x sa*sb (host floats)"}.get(epilogue, "")
    return (f"{kern} {sname} {_dt(in_dt)} B as {'(N, K)' if bt else '(K, N)'}"
            f" -> {_dt(out_dt)}{scaled}")


def matmul_vs_plain(mm, dev, gen, card):
    """Phase m: the matmul kernel (M1, its device-scaled form, and M2)
    against its plain version at phase m's shapes, by dtype and B layout,
    every tile instance that divides the shape checked; the fastest
    tile's time beside the bound, the plain version's and one library
    call's. int8 -> int32 must be exact."""
    rows = []
    for sname, M, N, K in MM_SHAPES:
        for in_dt, out_dt, bt, epi in MM_CASES:
            a = mm_operand(gen, dev, in_dt, (M, K), K)
            b = mm_operand(gen, dev, in_dt, (N, K) if bt else (K, N), K)
            if epi == "device":
                sa, sb = (torch.tensor([s], device=dev) for s in MM_SCALES)
                scale = sa[0] * sb[0]
            elif epi == "host":
                sa, sb = MM_SCALES
                scale = sa * sb
            else:
                sa = sb = scale = None
            counter = mm.matmul_scaled if epi == "host" else mm.matmul_pallas
            what = _mm_what(sname, in_dt, out_dt, bt, epi)
            want = mm.matmul_plain(a, b, out_dt, bt, scale)
            o = torch.empty(M, N, device=dev, dtype=out_dt)
            times, err = {}, 0.0
            tiles = mm._tile_candidates(M, N, K, in_dt.itemsize)
            for tile in tiles:
                def run(t=tile):
                    mm._gemm(a, b, o, t, bt, sa, sb, counter=counter)
                o.zero_()
                run()
                torch.cuda.synchronize()
                if out_dt == torch.int32:
                    if not torch.equal(o, want):
                        fail(f"phase m {what} tile {tile}: not exact, "
                             f"{int((o != want).sum())} elements differ")
                else:
                    err = max(err, compare(o, want, f"{what} tile {tile}"))
                times[tile] = cuda_ms(run, iters=10, warmup=2)
            best = min(times, key=times.get)
            plain_ms = cuda_ms(lambda: mm.matmul_plain(a, b, out_dt, bt,
                                                       scale),
                               iters=5, warmup=1)
            lib, lib_name = mm_library(a, b, out_dt, bt, epi)
            lib_ms = cuda_ms(lib, iters=10) if lib else None
            bms, by = mm_bound(M, N, K, in_dt, out_dt)
            ms = times[best]
            lib_txt = f"{lib_name} {lib_ms:.4f} ms" if lib else lib_name
            agree = "exact" if out_dt == torch.int32 else \
                f"max abs err {err}"
            print(f"phase m {what}: {len(tiles)} tiles {agree} vs plain; "
                  f"fastest {best}: {ms:.4f} ms "
                  f"({2 * M * N * K / ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * bms / ms:.1f}% of the bound {bms:.4f} ms, {by}); "
                  f"tiles {_ranked(times, 1.0)} ms; plain {plain_ms:.4f} ms; "
                  f"library {lib_txt} [{card}]", flush=True)
            rows.append(dict(case=what, tile=list(best), max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, library=lib_name,
                             library_ms=lib_ms))
            del a, b, o, want
        torch.cuda.empty_cache()
    return rows


def _no_tune(*args, **kwargs):
    fail("phase n: a key already tuned (in memory or in the store) was "
         "timed again")


def autotuned_path(mm, cu, dev, gen, card):
    """Phase n: the slice's main path through the entry points a user
    calls (``examples/matmul.py``, ``bench.py``'s matmul rows):
    ``autotune_top_tiles`` (``matmul_autotuned``) at bf16 4096^3 (the
    headline), fp8 e4m3 4096^3 and the llama FFN projection, each tuned on
    first use through captured CUDA graphs timed by CUDA events into the
    fresh sqlite store; ``matmul_scaled`` (M2) on fp8 weights given as
    (N, K); ``matmul_quantized`` (the K0 quantize kernels, then M1 with
    device scales) at 4096^2 f32. The counts are zeroed just before and
    read just after. Then: a second call and a new ``LocalTuner`` run the
    stored winner without timing, and one tune with ``checks=True``
    cross-validates every candidate."""
    from cubecl_tpu_torch.runtime.config import cache_root
    from cubecl_tpu_torch.tune import LocalTuner, Tuner

    S, e4m3 = MM_S, torch.float8_e4m3fn
    fm, fn, fk = MM_FFN
    x = mm_operand(gen, dev, torch.float32, (S, S), S)
    y = mm_operand(gen, dev, torch.float32, (S, S), S)
    head = f"bf16 {S}^3"
    keys = [(head, x.bfloat16(), y.bfloat16(), S, S, S),
            (f"e4m3 {S}^3", x.to(e4m3), y.to(e4m3), S, S, S),
            (f"llama FFN bf16 {fm}x{fk}x{fn}",
             mm_operand(gen, dev, torch.bfloat16, (fm, fk), fk),
             mm_operand(gen, dev, torch.bfloat16, (fk, fn), fk), fm, fn, fk)]
    handles = [(name, cu.create(a), cu.create(b),
                cu.empty((m, n), "bfloat16"), m, n, k)
               for name, a, b, m, n, k in keys]
    a8, w8 = x.to(e4m3), y.t().contiguous().to(e4m3)  # weights as (N, K)
    m2 = (cu.create(a8), cu.create(w8), cu.empty((S, S), "bfloat16"))
    q = (cu.create(x), cu.create(y), cu.empty((S, S), "float32"))
    torch.cuda.synchronize()

    mm.matmul_pallas.launches = 0
    mm.matmul_scaled.launches = 0
    cu.server.reset_counts()
    t_path = time.perf_counter()
    tuned = []
    for name, a, b, o, m, n, k in handles:
        t0 = time.perf_counter()
        top = mm.autotune_top_tiles(cu, a, b, o, m, n, k, top=8)
        torch.cuda.synchronize()
        tuned.append((top, time.perf_counter() - t0))
    mm.matmul_scaled(cu, *m2, S, S, S, *MM_SCALES, b_transposed=True)
    t0 = time.perf_counter()
    mm.matmul_quantized(cu, *q, S, S, S)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    path_s = time.perf_counter() - t_path
    launches = {"matmul_pallas": mm.matmul_pallas.launches,
                "matmul_scaled": mm.matmul_scaled.launches,
                "quantize_block_kernel":
                    cu.server.launches["quantize_block_kernel"]}
    if not all(launches.values()):
        fail(f"phase n: a kernel of the path never launched: {launches} "
             f"(server: {dict(cu.server.launches)})")

    store = os.path.join(cache_root(), "store.sqlite")
    if not store.startswith(os.environ["CUBECL_ENVIRONMENT_ROOT"]) \
            or not os.path.exists(store):
        fail(f"phase n: the tune store is not in the fresh root: {store}")
    out = {"launches": launches, "keys": {}}
    for (name, a, b, o, m, n, k), (top, tune_s) in zip(handles, tuned):
        in_dt = str(a.dtype).replace("torch.", "")
        key = mm._tune_key(m, n, k, in_dt, "bfloat16")
        tuner = mm._matmul_tuner.tuner_for(
            cu, key, mm.matmul_tunables(m, n, k, in_dt, "bfloat16"))
        times = tuner.cache.timings(key)
        cands = mm._tile_candidates(m, n, k, a.tensor.element_size())
        if len(times) != len(cands) or not all(
                math.isfinite(t) and t > 0 for t in times.values()):
            fail(f"phase n {name}: timed {times}, candidates {cands}")
        err = compare(o.tensor, mm.matmul_plain(a.tensor, b.tensor,
                                                torch.bfloat16),
                      f"phase n matmul_autotuned {name}")
        bms, by = mm_bound(m, n, k, a.dtype, torch.bfloat16)
        best = top[0]
        win = times[f"t{best[0]}x{best[1]}x{best[2]}"] * 1e3
        print(f"phase n matmul_autotuned {name} -> bf16: tuned in "
              f"{tune_s:.2f} s ({len(times)} candidates, each captured as a "
              f"CUDA graph, CUDA-event median of replays): "
              f"{_ranked(times, 1e3)} ms; shortlist {top[:3]}; winner {best} {win:.4f} ms = "
              f"{2 * m * n * k / win / 1e9:.1f} TFLOP/s, "
              f"{100 * bms / win:.1f}% of the bound {bms:.4f} ms ({by}); "
              f"max abs err {err} vs plain [{card}]", flush=True)
        out["keys"][name] = dict(tile=list(best), tune_s=tune_s,
                                 graph_ms=win, max_abs_err=err,
                                 candidates_ms={t: v * 1e3 for t, v in
                                                times.items()})

    # the store: a second call runs the winner without timing, and so
    # does a new LocalTuner, which loads the entry from sqlite
    tune = Tuner._tune
    Tuner._tune = _no_tune
    try:
        fresh = LocalTuner("matmul")
        for name, a, b, o, m, n, k in handles:
            in_dt = str(a.dtype).replace("torch.", "")
            key = mm._tune_key(m, n, k, in_dt, "bfloat16")
            ts = mm.matmul_tunables(m, n, k, in_dt, "bfloat16")
            n0 = mm.matmul_pallas.launches
            mm.matmul_autotuned(cu, a, b, o, m, n, k)
            fresh.execute(cu, ts, cu, a, b, o)
            torch.cuda.synchronize()
            want = mm._matmul_tuner.tuner_for(cu, key, ts).cache.get(key)
            if mm.matmul_pallas.launches != n0 + 2 or \
                    fresh.tuner_for(cu, key, ts).cache.get(key) != want:
                fail(f"phase n {name}: the stored winner did not run alone "
                     f"({mm.matmul_pallas.launches - n0} launches)")
    finally:
        Tuner._tune = tune
    name, a, b, o, m, n, k = handles[0]
    chk = Tuner(mm.matmul_tunables(m, n, k, "bfloat16", "bfloat16"), cu,
                checks=True)
    chk.cache.store = None
    chk.cache.mem.clear()
    t0 = time.perf_counter()
    chk.execute(cu, a, b, o)
    torch.cuda.synchronize()
    chk_s = time.perf_counter() - t0
    if chk.check_failures:
        fail(f"phase n checks: {chk.check_failures}")
    print(f"phase n tune store {os.path.relpath(store, os.environ['CUBECL_ENVIRONMENT_ROOT'])}"
          f" ({os.path.getsize(store)} bytes) under a fresh "
          f"CUBECL_ENVIRONMENT_ROOT: a second matmul_autotuned call and a "
          f"new LocalTuner ran each stored winner with no timing; checks="
          f"True cross-validated all {len(chk.tunables.tunables)} "
          f"{head} candidates in {chk_s:.2f} s", flush=True)

    # the headline (bench.py's bf16_4096_matmul_pct_mxu_peak), per call of
    # the entry point and per launch of the winner's kernel
    _, a, b, o, m, n, k = handles[0]
    best = tuple(out["keys"][head]["tile"])
    call_ms = cuda_ms(lambda: mm.matmul_autotuned(cu, a, b, o, m, n, k))
    ms = cuda_ms(lambda: mm._gemm(a.tensor, b.tensor, o.tensor, best, False,
                                  counter=mm.matmul_pallas))
    plain_ms = cuda_ms(lambda: mm.matmul_plain(a.tensor, b.tensor,
                                               torch.bfloat16), iters=5)
    lib_ms = cuda_ms(lambda: torch.matmul(a.tensor, b.tensor))
    bms, by = mm_bound(m, n, k, torch.bfloat16, torch.bfloat16)
    tflops = 2 * m * n * k / ms / 1e9
    print(f"phase n headline {head} -> bf16, tile {best}: kernel "
          f"{ms:.4f} ms = {tflops:.1f} TFLOP/s = {100 * tflops / 989:.1f}% "
          f"of 989 TFLOP/s; matmul_autotuned per call {call_ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms; torch.matmul {lib_ms:.4f} ms "
          f"({2 * m * n * k / lib_ms / 1e9:.1f} TFLOP/s); bound {bms:.4f} "
          f"ms ({by}) [{card}]", flush=True)
    out["matmul"] = dict(max_abs_err=out["keys"][head]["max_abs_err"],
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bms, bound_by=by, per_call_ms=call_ms,
                         tflops=tflops, pct_of_989=100 * tflops / 989,
                         tile=list(best))

    # M2 on fp8 weights
    scale = MM_SCALES[0] * MM_SCALES[1]
    err = compare(m2[2].tensor, mm.matmul_plain(a8, w8, torch.bfloat16, True,
                                                scale),
                  f"phase n matmul_scaled e4m3 {S}^3")
    ms = cuda_ms(lambda: mm.matmul_scaled(cu, *m2, S, S, S, *MM_SCALES,
                                          b_transposed=True))
    plain_ms = cuda_ms(lambda: mm.matmul_plain(a8, w8, torch.bfloat16, True,
                                               scale), iters=5)
    lib, lib_name = mm_library(a8, w8, torch.bfloat16, True, "host")
    lib_ms = cuda_ms(lib)
    bms, by = mm_bound(S, S, S, e4m3, torch.bfloat16)
    print(f"phase n matmul_scaled (M2) e4m3 {S}^3, weights (N, K), x "
          f"{MM_SCALES[0]} x {MM_SCALES[1]} -> bf16: max abs err {err}; "
          f"kernel {ms:.4f} ms ({2 * S ** 3 / ms / 1e9:.1f} TFLOP/s); plain "
          f"{plain_ms:.4f} ms; {lib_name} {lib_ms:.4f} ms; bound {bms:.4f} "
          f"ms ({by}) [{card}]", flush=True)
    out["matmul_scaled"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=bms, bound_by=by)

    # the quantized route: quantization noise, as the JAX test's bound
    ref = mm.matmul_plain(x, y, torch.float32)
    rel = ((q[2].tensor - ref).abs().max() / ref.abs().max()).item()
    if not rel < 3e-2:
        fail(f"phase n matmul_quantized: relative error {rel} >= 3e-2")
    print(f"phase n matmul_quantized f32 {S}^2 (K0 per-tensor int8 "
          f"quantize of a and b, M1 int8 -> int32 with the dequant scale "
          f"in its epilogue): max relative error {rel} (bound 3e-2), one "
          f"call {quant_s:.3f} s; the path took {path_s:.2f} s; launches "
          f"{launches} [{card}]", flush=True)
    out["quantized_rel_err"] = rel
    return out


def cmma_and_quant(mm, qk, cu, ev, dev, gen, card):
    """Phase o: ``examples/matmul.py``'s DSL path, ``matmul_cmma`` through
    K0 with cmma printed as CUDA C++ (fragments in shared memory), at
    CMMA_CASES, each against plain and against the torch evaluator on the
    card (the counts zeroed before the three calls, read after); then the
    K0 quant kernels of phase n against their plain versions, bit for
    bit, and the block-level ones against the evaluator."""
    from cubecl_tpu_torch.std.quant import QuantLevel, QuantScheme

    ops = [(dt, S, mm_operand(gen, dev, dt, (S, S), S),
            mm_operand(gen, dev, dt, (S, S), S)) for dt, S in CMMA_CASES]
    hs = [(cu.create(a.reshape(-1)), cu.create(b.reshape(-1)),
           cu.empty((S * S,), "float32")) for _, S, a, b in ops]
    torch.cuda.synchronize()
    cu.server.reset_counts()
    for (_, S, _, _), h in zip(ops, hs):
        mm.matmul_cmma(cu, *h, S, S, S)
    torch.cuda.synchronize()
    launches = dict(cu.server.launches)
    if launches != {"matmul_cmma_nd_kernel": len(CMMA_CASES)}:
        fail(f"phase o: launches {launches}, want "
             f"{len(CMMA_CASES)} of matmul_cmma_nd_kernel")
    row = None
    for (dt, S, a, b), h in zip(ops, hs):
        what = f"matmul_cmma {_dt(dt)} {S}^3 -> f32"
        e = [ev.create(a.reshape(-1)), ev.create(b.reshape(-1)),
             ev.empty((S * S,), "float32")]
        mm.matmul_cmma(ev, *e, S, S, S)
        got = h[2].tensor.view(S, S)
        want = mm.matmul_plain(a, b, torch.float32)
        err = compare(got, want, f"phase o {what} vs plain")
        err_ev = compare(got, e[2].tensor.view(S, S),
                         f"phase o {what} vs the evaluator")
        iters = 3 if S > 1024 else 10
        ms = cuda_ms(lambda: mm.matmul_cmma(cu, *h, S, S, S), iters=iters,
                     warmup=1)
        plain_ms = cuda_ms(lambda: mm.matmul_plain(a, b, torch.float32),
                           iters=iters)
        lib_name = "torch.matmul (TF32 off)" if dt == torch.float32 else \
            "torch.mm(out_dtype=float32)"
        lib_ms = cuda_ms((lambda: torch.matmul(a, b)) if dt == torch.float32
                         else (lambda: torch.mm(a, b,
                                                out_dtype=torch.float32)))
        bms, by = mm_bound(S, S, S, dt, torch.float32)
        tm, tn, tk = mm._cmma_plan(S, S, S, dt.itemsize, 128)
        print(f"phase o K0 {what} (fragments {tm}x{tn}x{tk}, "
              f"{mm.CMMA_CUBE_DIM} units a cube): max abs err {err} vs plain, "
              f"{err_ev} vs the torch evaluator (atol/rtol "
              f"{TOL[torch.float32]}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}) [{card}]", flush=True)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library=lib_name, bound_ms=bms,
                   bound_by=by, shape=f"{_dt(dt)} {S}^3 -> f32")
        del e
    out = {"k0_cmma": dict(row, launches=launches["matmul_cmma_nd_kernel"])}

    x = torch.randn(QUANT_N, generator=gen, device=dev) * 3
    xh = cu.create(x)
    for scheme in (QuantScheme(), QuantScheme(level=QuantLevel.BLOCK,
                                              block_size=QUANT_BLOCK)):
        level = scheme.level.value
        vals, scales = qk.quantize(cu, xh, scheme)
        back = qk.dequantize(cu, vals, scales, scheme)
        pv, ps = qk.quantize_plain(x, scheme)
        torch.cuda.synchronize()
        differ = {k: int((t != p).sum()) for k, t, p in (
            ("values", vals.tensor, pv), ("scales", scales.tensor, ps),
            ("dequantized", back.tensor,
             qk.dequantize_plain(pv, ps, scheme)))}
        if any(differ.values()):
            fail(f"phase o K0 quantize/dequantize {level}: elements that "
                 f"differ from the plain version's bits: {differ}")
        if scheme.level == QuantLevel.BLOCK:
            ev_v, ev_s = qk.quantize(ev, ev.create(x), scheme)
            differ = {k: int((t != e).sum()) for k, t, e in (
                ("values", vals.tensor, ev_v.tensor),
                ("scales", scales.tensor, ev_s.tensor))}
            if any(differ.values()):
                fail(f"phase o K0 quantize block: elements that differ from "
                     f"the evaluator's bits: {differ}")
        iters = 2 if scheme.level == QuantLevel.TENSOR else 10
        ms = cuda_ms(lambda: qk.quantize(cu, xh, scheme), iters=iters,
                     warmup=1)
        plain_ms = cuda_ms(lambda: qk.quantize_plain(x, scheme))
        n_blocks = ps.numel()
        bms, by = bound_ms(2 * QUANT_N, QUANT_N * 5 + 4 * n_blocks,
                           torch.float32)
        also = " and the evaluator's" if n_blocks > 1 else ""
        print(f"phase o K0 quantize_block_kernel {level} f32 4096^2 -> int8"
              f" ({n_blocks} scales): values and scales equal the plain "
              f"version's bits{also}, dequantize_block_kernel's output the "
              f"plain version's; quantize {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]",
              flush=True)
        if scheme.level == QuantLevel.TENSOR:
            out["k0_quantize"] = dict(max_abs_err=0.0, ms=ms,
                                      plain_ms=plain_ms, bound_ms=bms,
                                      bound_by=by)
        else:
            out["k0_quantize_block"] = dict(ms=ms, plain_ms=plain_ms,
                                            bound_ms=bms)
    return out


# -- reductions and comptime fusion (phases p-r) -----------------------------

# BASELINE config 2: sums over 64M elements; R1 also at the JAX test's
# 128 x 1000 (one ragged block)
RED_N = 64 << 20
RED_SMALL = 128 * 1000
NATIVE_BRS = (512, 1024, 2048, 4096)  # reduce_sum_autotuned's native_br*
BLOCK_CUBES = 32                      # reduce_sum_blockwise's default
FUSE_N = 16 << 20                     # phase q: launch_fused on 16M f32
FUSE_CASES = [(("add", "mul", "relu"), 3), (("add", "gelu"), 2)]
# phase q: into_contiguous of every other row of (64, 512, 512) f32, and
# identity(4096)
CONTIG_SRC, CONTIG_VIEW = (64, 512, 512), (64, 256, 512)
CONTIG_STRIDES = (512 * 512, 2 * 512, 1)
EYE_N = 4096
# the whole-array sums of phase p against the float64 sum, on zero-mean
# input: |err| <= SUM_TOL * sum|x|. At 64M that is about 0.54, some 800x
# R1's f32 rounding and 20x the block_sum route's (H100 runs), while one
# dropped block partial (131072 elements, standard deviation 362) or one
# thread's share (512 elements, 23) moves the sum far past it
SUM_TOL = 1e-8
# reduce_block_partial's 2M-element windows against torch's f32 window
# sums: 8 threads fold a window, each through 262144 serial f32 additions,
# so the limit is 1e-6 * sum|x| of a window (about 1.7); one dropped
# 128-element line moves a window's sum by 11 (one standard deviation)
BLOCK_TOL = 1e-6
# R1 with more chunks than blocks (its grid-stride step): 64M f32 at
# block_rows 8 is 65536 chunks over 1024 blocks
STRIDE_BR = 8


def red_compile_only(R, FU, S, ex_sum, ex_prog, T, co, block_extremes):
    """Phase 2: start the nvcc of every K0 kernel of phases p-r through the
    compile-only client ``co`` (the wrappers' own launches on handles of
    the phases' shapes, so that the kernel ids are the phases')."""
    x = co.empty((RED_N,), "float32")
    for bc in (16, 32, 64):
        R.reduce_sum_blockwise(co, x, cubes=bc)
    for tc in (256, 512, 1024):
        R.reduce_sum(co, x, target_cubes=tc)
    R.reduce_max(co, x)
    block_extremes.launch_unchecked(
        co, BLOCK_CUBES, 256, array_arg(x, 128), array_arg(co.empty(
            (2 * BLOCK_CUBES,), "float32"), 1, True),
        RED_N // 128 // BLOCK_CUBES)
    for ops, k in FUSE_CASES:
        FU.launch_fused(co, [co.empty((FUSE_N,), "float32")] * k,
                        co.empty((FUSE_N,), "float32"), list(ops))
    src = S.TensorHandle(co.empty((math.prod(CONTIG_SRC),), "float32"),
                         CONTIG_VIEW, CONTIG_STRIDES)
    S.into_contiguous(co, src)
    S.identity(co, EYE_N)
    i, o = co.empty((ex_sum.N,), "float32"), co.empty((ex_sum.N,), "float32")
    for run in ex_sum.variants(co, i, o).values():
        run()
    rows, cols, nr, nc = ex_prog.BOOK
    h, out = co.empty((rows * cols,), "float32"), co.empty((rows,), "float32")
    hn, outn = co.empty((nr * nc,), "float32"), co.empty((nr,), "float32")
    for k, cc, cd, args in ex_prog.stages(h, out, hn, outn, rows, cols, nr,
                                          nc).values():
        k.launch_unchecked(co, cc, cd, *args)
    n = 1 << 24
    T._fma_chain.launch_unchecked(
        co, n // (T.FMA_LINE * T.FMA_CUBE), T.FMA_CUBE,
        array_arg(co.empty((n,), "float32"), T.FMA_LINE, True), T.FMA_CHAIN)
    T._add_one.launch_unchecked(co, 4, 256, array_arg(co.empty((1024,),
                                                           "float32"),
                                                  1, True))


def array_arg(h, line=1, mutable=None):
    from cubecl_tpu_torch.frontend import ArrayArg

    return ArrayArg(h, line_size=line, mutable=mutable)


def make_block_extremes():
    """A K0 kernel of phase p: ``block_max`` and ``block_min`` of each
    cube's window, one pair of values per cube."""
    from cubecl_tpu_torch.frontend import CUBE_POS_X, MutSlice, Slice, cube

    @cube
    def block_extremes(inp: Slice, out: MutSlice, lines: int):
        out[CUBE_POS_X * 2] = inp.block_max(CUBE_POS_X * lines, lines)
        out[CUBE_POS_X * 2 + 1] = inp.block_min(CUBE_POS_X * lines, lines)

    return block_extremes


def _no_measure(*args, **kwargs):
    fail("phase r: a peak already in the store was measured again")


def _tuned_winner(R, key):
    tuner = next(t for (_f, k, _c), t in R._sum_tuner._tuners.items()
                 if k == str(key))
    return tuner.cache.mem[str(key)][1], tuner.cache.timings(key)


def reduction_path(R, cu):
    """Phase p's main path at 64M f32, with every count zeroed just before
    and read just after: ``reduce_sum_autotuned`` (tuned on first use into
    the temp store: each candidate's launches captured as a CUDA graph and
    timed by CUDA events), a second call that runs the stored winner
    untimed, ``reduce_sum``, ``reduce_max``, ``reduce_mean`` and
    ``reduce_sum_blockwise``. Returns the inputs, results and counts."""
    from cubecl_tpu_torch.tune import Tuner

    g = torch.Generator(device=cu.device).manual_seed(61)
    x = torch.randn(RED_N, generator=g, device=cu.device)
    h = cu.create(x)
    torch.cuda.synchronize()
    R.reduce_sum_native.launches = 0
    cu.server.reset_counts()
    t0 = time.perf_counter()
    tuned = R.reduce_sum_autotuned(cu, h).tensor.clone()
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tune = Tuner._tune
    Tuner._tune = _no_tune
    try:
        again = R.reduce_sum_autotuned(cu, h).tensor.clone()
    finally:
        Tuner._tune = tune
    res = {"sum": R.reduce_sum(cu, h).tensor, "max": R.reduce_max(cu, h)
           .tensor, "mean": R.reduce_mean(cu, h).tensor,
           "blockwise": R.reduce_sum_blockwise(cu, h).tensor}
    torch.cuda.synchronize()
    launches = {"reduce_native": R.reduce_sum_native.launches,
                **{k: cu.server.launches[k] for k in (
                    "reduce_block_partial", "reduce_sum_partial",
                    "reduce_final_sum", "reduce_max_partial",
                    "reduce_final_max")}}
    if not all(launches.values()):
        fail(f"phase p: a kernel of the path never launched: {launches}")
    if not torch.equal(again, tuned):
        fail(f"phase p: the stored winner gave {again.item()}, the tuned "
             f"call {tuned.item()}")
    return dict(x=x, h=h, tuned=tuned, res=res, launches=launches,
                tune_s=tune_s)


def reductions(R, ex_sum, ex_prog, cu, ev, dev, gen, card, block_extremes):
    """Phase p (BASELINE config 2): the path of ``reduction_path``, each
    result against the float64 sum (or torch's max, exact) and the K0
    routes against the torch evaluator on the card; R1 at 64M f32 and
    bf16 and at 128 x 1000 against its plain version, timed beside its
    bound and ``torch.sum(x, dtype=torch.float32)``; the K0 routes' times;
    block max/min exact; sum_things' four variants and the book's
    reduction progression (512 x 8192, naive at 256 x 4096)."""
    p = reduction_path(R, cu)
    x, h = p["x"], p["h"]
    x64 = x.double()
    ref, scale = x64.sum().item(), x64.abs().sum().item()
    key = ("sum", RED_N, "float32")
    winner, times = _tuned_winner(R, key)
    if len(times) != 10 or not all(math.isfinite(t) and t > 0
                                   for t in times.values()):
        fail(f"phase p reduce_sum_autotuned timed {times}")
    for what, v in (("reduce_sum_autotuned", p["tuned"]),
                    ("reduce_sum", p["res"]["sum"]),
                    ("reduce_sum_blockwise", p["res"]["blockwise"])):
        if abs(v.double().item() - ref) > SUM_TOL * scale:
            fail(f"phase p {what} 64M f32: {v.item()} vs the float64 sum "
                 f"{ref} (tolerance {SUM_TOL} * {scale})")
    if p["res"]["max"].item() != x.max().item():
        fail(f"phase p reduce_max: {p['res']['max'].item()} != "
             f"{x.max().item()}")
    if abs(p["res"]["mean"].double().item() - ref / RED_N) > \
            SUM_TOL * scale / RED_N:
        fail(f"phase p reduce_mean: {p['res']['mean'].item()}")
    # the K0 routes against the torch evaluator on the card
    eh = ev.create(x)
    evs = {"sum": R.reduce_sum(ev, eh).tensor, "max": R.reduce_max(ev, eh)
           .tensor, "blockwise": R.reduce_sum_blockwise(ev, eh).tensor}
    torch.cuda.synchronize()
    if not torch.equal(evs["max"], p["res"]["max"]):
        fail("phase p reduce_max: kernel and evaluator differ")
    for k in ("sum", "blockwise"):
        if abs(evs[k].item() - p["res"][k].item()) > SUM_TOL * scale:
            fail(f"phase p {k}: kernel {p['res'][k].item()} vs evaluator "
                 f"{evs[k].item()}")
    neg = cu.create(-x)
    mn = -R.reduce_max(cu, neg).tensor
    win = RED_N // BLOCK_CUBES
    ext = cu.empty((2 * BLOCK_CUBES,), "float32")
    block_extremes.launch_unchecked(cu, BLOCK_CUBES, 256, array_arg(h, 128),
                                    array_arg(ext, 1, True), win // 128)
    torch.cuda.synchronize()
    xw = x.view(BLOCK_CUBES, win)
    if mn.item() != x.min().item() or not torch.equal(
            ext.tensor.view(BLOCK_CUBES, 2),
            torch.stack([xw.amax(1), xw.amin(1)], 1)):
        fail("phase p: min or the block max/min are not exact")
    print(f"phase p reductions 64M f32 (path): reduce_sum_autotuned tuned "
          f"in {p['tune_s']:.2f} s over {len(times)} candidates, each a "
          f"CUDA graph timed by CUDA events: {_ranked(times, 1e3)} ms; "
          f"winner {winner}; a second call ran it untimed; sums within "
          f"{SUM_TOL} * sum|x| of the float64 sum, reduce_max and -max(-x) "
          f"and block_max/block_min exact; K0 routes vs the torch evaluator "
          f"on the card: sum {abs(evs['sum'].item() - p['res']['sum'].item())}"
          f", blockwise {abs(evs['blockwise'].item() - p['res']['blockwise'].item())}"
          f"; launches {p['launches']} [{card}]", flush=True)

    # R1 against plain, the bound and torch.sum
    r1 = {}
    best_br = int(winner[len("native_br"):]) if winner.startswith(
        "native_br") else 4096
    for name, xs in (("f32 64M", x), ("bf16 64M", x.bfloat16()),
                     ("f32 128x1000", torch.randn(RED_SMALL, generator=gen,
                                                  device=dev))):
        n = xs.numel()
        hs = cu.create(xs)
        got = R.reduce_sum_native(cu, hs, block_rows=best_br).tensor
        plain = R.reduce_sum_native_plain(xs)
        torch.cuda.synchronize()
        xd = xs.double()
        err64 = abs(got.double().item() - xd.sum().item())
        lim = SUM_TOL * xd.abs().sum().item()
        err = abs(got.item() - plain.item())
        if err64 > lim or err > lim:
            fail(f"phase p R1 {name}: {got.item()}, float64 sum "
                 f"{xd.sum().item()}, plain {plain.item()} (limit {lim})")
        br_ms = {}
        for br in NATIVE_BRS:
            k = R._build_reduce_native(n, br, xs.dtype)
            part = torch.empty(R._native_blocks(n, br), device=dev)
            o = torch.empty(1, device=dev)
            br_ms[br] = cuda_ms(lambda: k.fn([xs, part, o]), iters=50)
        ms = br_ms[best_br]
        plain_ms = cuda_ms(lambda: R.reduce_sum_native_plain(xs), iters=20)
        lib_ms = cuda_ms(lambda: torch.sum(xs, dtype=torch.float32), iters=50)
        bms, by = bound_ms(n, n * xs.element_size(), torch.float32)
        gbs = n * xs.element_size() / ms / 1e6
        print(f"phase p R1 reduce_native {name} (block_rows {best_br}): "
              f"{got.item()} vs the float64 sum {xd.sum().item()} (err "
              f"{err64}, limit {lim}), vs plain {err}; kernel {ms:.4f} ms = "
              f"{gbs:.0f} GB/s, {100 * bms / ms:.1f}% of the bound "
              f"{bms:.4f} ms ({by}); by block_rows "
              f"{', '.join(f'{b}: {t:.4f}' for b, t in br_ms.items())} ms; "
              f"plain {plain_ms:.4f} ms; torch.sum(dtype=float32) "
              f"{lib_ms:.4f} ms [{card}]", flush=True)
        r1[name] = dict(max_abs_err=err, err_vs_float64=err64, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                        bound_by=by, gb_per_s=gbs, block_rows=best_br,
                        ms_by_block_rows=br_ms)
        del hs
    chunks = RED_N // (STRIDE_BR * 128)
    got = R.reduce_sum_native(cu, h, block_rows=STRIDE_BR).tensor
    torch.cuda.synchronize()
    err64 = abs(got.double().item() - ref)
    if chunks <= R.MAX_BLOCKS or err64 > SUM_TOL * scale:
        fail(f"phase p R1 grid-stride ({chunks} chunks): {got.item()} vs "
             f"the float64 sum {ref} (limit {SUM_TOL * scale})")
    print(f"phase p R1 reduce_native f32 64M at block_rows {STRIDE_BR}: "
          f"{chunks} chunks over {R.MAX_BLOCKS} blocks, err {err64} vs the "
          f"float64 sum (limit {SUM_TOL * scale}) [{card}]", flush=True)

    # the K0 routes: times (each call as a user makes it: its output and
    # partials allocated, two launches)
    routes = {}
    for name, fn, plain in (
            ("reduce_sum", lambda: R.reduce_sum(cu, h), lambda: x.sum()),
            ("reduce_max", lambda: R.reduce_max(cu, h), lambda: x.max()),
            ("reduce_sum_blockwise", lambda: R.reduce_sum_blockwise(cu, h),
             lambda: x.view(BLOCK_CUBES, -1).sum(1).sum())):
        routes[name] = dict(ms=cuda_ms(fn, iters=5, warmup=1),
                            plain_ms=cuda_ms(plain, iters=20))
    # a call through the tuner, and the winner's route called directly,
    # alternated five times (the host's speed drifts): the difference of
    # the medians is the tuner's host work per call
    wins, directs = [], []
    for _ in range(5):
        wins.append(cuda_ms(lambda: R.reduce_sum_autotuned(cu, h), iters=50))
        directs.append(cuda_ms(lambda: R.reduce_sum_native(
            cu, h, block_rows=best_br), iters=50))
    win_ms, direct_ms = statistics.median(wins), statistics.median(directs)
    bms, by = bound_ms(RED_N, RED_N * 4, torch.float32)
    # reduce_block_partial alone: one block_sum per cube over its window
    part = cu.empty((BLOCK_CUBES,), "float32")
    blk = lambda: R.reduce_block_partial.launch_unchecked(  # noqa: E731
        cu, BLOCK_CUBES, R.CD, array_arg(h, 128), array_arg(part, 1, True),
        win // 128)
    blk()
    eparts = ev.empty((BLOCK_CUBES,), "float32")
    R.reduce_block_partial.launch_unchecked(
        ev, BLOCK_CUBES, R.CD, array_arg(eh, 128), array_arg(eparts, 1, True),
        win // 128)
    plain_parts = xw.sum(1)
    torch.cuda.synchronize()
    blk_err = (part.tensor - plain_parts).abs().max().item()
    blk_lim = BLOCK_TOL * xw.abs().sum(1).min().item()
    if blk_err > blk_lim or \
            (part.tensor - eparts.tensor).abs().max().item() > blk_lim:
        fail(f"phase p reduce_block_partial: max abs err {blk_err}")
    blk_ms = cuda_ms(blk, iters=5, warmup=1)
    blk_plain = cuda_ms(lambda: xw.sum(1), iters=20)
    blk_lib = cuda_ms(lambda: torch.sum(xw, dim=1), iters=20)
    print(f"phase p K0 routes 64M f32 (cubes of {R.CD} units): "
          + "; ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f})"
                      for k, v in routes.items())
          + f"; reduce_block_partial alone ({BLOCK_CUBES} cubes): "
          f"{blk_ms:.4f} ms, max abs err {blk_err} vs plain, torch.sum(dim=1)"
          f" {blk_lib:.4f} ms; reduce_sum_autotuned per call ({winner}) "
          f"{win_ms:.4f} ms, reduce_sum_native(block_rows={best_br}) per "
          f"call {direct_ms:.4f} ms (medians of 5 alternated; "
          f"{min(wins):.4f}-{max(wins):.4f}, {min(directs):.4f}-"
          f"{max(directs):.4f}); bound {bms:.4f} ms ({by}) [{card}]",
          flush=True)
    block = dict(max_abs_err=blk_err, ms=blk_ms, plain_ms=blk_plain,
                 library_ms=blk_lib, bound_ms=bms, bound_by=by,
                 launches=p["launches"]["reduce_block_partial"])

    # examples/sum_things.py's four variants
    data = torch.arange(ex_sum.N, dtype=torch.float32, device=dev)
    sums = {}
    for name in ("basic", "subgroup", "trait:plane", "trait:basic"):
        i, o = cu.create(data), cu.empty((ex_sum.N,), "float32")
        run = ex_sum.variants(cu, i, o)[name]
        run()
        torch.cuda.synchronize()
        if o.tensor[0].item() != data.sum().item():
            fail(f"phase p sum_things {name}: {o.tensor.tolist()}")
        sums[name] = cuda_ms(run, iters=20)
    # examples/reduction_progression.py at the book's shape
    rows, cols, nr, nc = ex_prog.BOOK
    xm = torch.rand(rows, cols, generator=gen, device=dev)
    xn = xm[:nr, :nc].contiguous()
    hm, hn = cu.create(xm.reshape(-1)), cu.create(xn.reshape(-1))
    out, outn = cu.empty((rows,), "float32"), cu.empty((nr,), "float32")
    stage_ms = {}
    for name, (k, cc, cd, args) in ex_prog.stages(
            hm, out, hn, outn, rows, cols, nr, nc).items():
        def run(k=k, cc=cc, cd=cd, args=args):
            k.launch_unchecked(cu, cc, cd, *args)
        run()
        torch.cuda.synchronize()
        want = (xn if name == "naive" else xm).double().sum(1)
        got = args[1].handle.tensor.double()
        if ((got - want).abs() > 1e-4 * want.abs()).any():
            fail(f"phase p reduction_progression {name}: max abs err "
                 f"{(got - want).abs().max().item()}")
        naive = name == "naive"
        t = cuda_ms(run, iters=2 if naive else 10, warmup=1)
        # the naive stage runs on a quarter of the elements: scaled, as
        # the script scales it
        stage_ms[name] = t * (rows * cols) / (nr * nc) if naive else t
    base = stage_ms["naive"]
    print(f"phase p sum_things (8 f32, one cube of 8): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items())
          + f"; reduction_progression {rows}x{cols} f32 -> [{rows}] "
          f"(naive at {nr}x{nc}, scaled): "
          + ", ".join(f"{k} {v:.4f} ms ({base / v:.1f}x)"
                      for k, v in stage_ms.items())
          + f" [{card}]", flush=True)
    return dict(r1=r1, block=block, launches=p["launches"], winner=winner,
                candidates_ms={k: v * 1e3 for k, v in times.items()},
                tune_s=p["tune_s"], routes=routes, progression=stage_ms,
                sum_things=sums)


def fusion_and_std(FU, S, cu, ev, dev, gen, card):
    """Phase q (BASELINE config 5): ``launch_fused`` for relu((a+b)*c) and
    add -> gelu on 16M f32, exactly one K0 launch each, against the torch
    evaluator on the card and plain, timed beside the bytes bound; then
    ``into_contiguous`` of a strided 3-D view (``_copy_permuted``) and
    ``identity(4096)`` against plain. Counts zeroed before the path's
    launches, read after."""
    ins = [torch.randn(FUSE_N, generator=gen, device=dev) for _ in range(3)]
    hs = [cu.create(t) for t in ins]
    outs = [cu.empty((FUSE_N,), "float32") for _ in FUSE_CASES]
    src = torch.randn(math.prod(CONTIG_SRC), generator=gen, device=dev)
    th = S.TensorHandle(cu.create(src), CONTIG_VIEW, CONTIG_STRIDES)
    torch.cuda.synchronize()
    cu.server.reset_counts()
    for (ops, k), o in zip(FUSE_CASES, outs):
        FU.launch_fused(cu, hs[:k], o, list(ops))
    dense = S.into_contiguous(cu, th)
    eye = S.identity(cu, EYE_N)
    torch.cuda.synchronize()
    launches = dict(cu.server.launches)
    want = {"fused_chain": len(FUSE_CASES), "_copy_permuted": 1,
            "_identity_kernel": 1}
    if launches != want:
        fail(f"phase q: launches {launches}, want {want}")
    a, b, c = ins
    plains = [lambda: torch.relu((a + b) * c), lambda: _plain_gelu(a + b)]
    rows = {}
    for (ops, k), o, plain in zip(FUSE_CASES, outs, plains):
        what = " -> ".join(ops)
        eo = ev.empty((FUSE_N,), "float32")
        FU.launch_fused(ev, [ev.create(t) for t in ins[:k]], eo, list(ops))
        torch.cuda.synchronize()
        err_ev = compare(o.tensor, eo.tensor, f"phase q {what} vs evaluator")
        err = compare(o.tensor, plain(), f"phase q {what} vs plain")
        ms = cuda_ms(lambda: FU.launch_fused(cu, hs[:k], o, list(ops)))
        plain_ms = cuda_ms(plain)
        bms, by = bound_ms(len(ops) * FUSE_N, (k + 1) * FUSE_N * 4,
                           torch.float32)
        print(f"phase q K0 fused_chain {what} f32 16M (one launch): max abs "
              f"err {err} vs plain, {err_ev} vs the torch evaluator; kernel "
              f"{ms:.4f} ms ({(k + 1) * FUSE_N * 4 / ms / 1e6:.0f} GB/s), "
              f"plain {plain_ms:.4f} ms (eager torch ops), bound {bms:.4f} "
              f"ms ({by}); no one PyTorch call computes it [{card}]",
              flush=True)
        rows[what] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, library_ms=None)
    view = src.view(CONTIG_SRC)[:, ::2, :]
    if not torch.equal(dense.handle.tensor, view.reshape(-1)) or \
            not torch.equal(eye.tensor.view(EYE_N, EYE_N),
                            torch.eye(EYE_N, device=dev)):
        fail("phase q: into_contiguous or identity differs from plain")
    n = math.prod(CONTIG_VIEW)
    c_ms = cuda_ms(lambda: S.into_contiguous(cu, th), iters=10)
    c_plain = cuda_ms(lambda: view.contiguous(), iters=10)
    c_b, c_by = bound_ms(0, 2 * n * 4, torch.float32)
    e_ms = cuda_ms(lambda: S.identity(cu, EYE_N), iters=10)
    e_plain = cuda_ms(lambda: torch.eye(EYE_N, device=dev), iters=10)
    e_b, e_by = bound_ms(0, EYE_N * EYE_N * 4, torch.float32)
    print(f"phase q into_contiguous {CONTIG_VIEW} view of {CONTIG_SRC} f32 "
          f"(strides {CONTIG_STRIDES}, _copy_permuted on K0): equal to "
          f"plain; {c_ms:.4f} ms, .contiguous() {c_plain:.4f} ms, bound "
          f"{c_b:.4f} ms ({c_by}); identity({EYE_N}) (_identity_kernel): "
          f"equal to torch.eye; {e_ms:.4f} ms, torch.eye {e_plain:.4f} ms, "
          f"bound {e_b:.4f} ms ({e_by}) [{card}]", flush=True)
    return dict(rows=rows, launches=launches,
                contiguous=dict(ms=c_ms, plain_ms=c_plain, bound_ms=c_b),
                identity=dict(ms=e_ms, plain_ms=e_plain, bound_ms=e_b))


def throughput(S, T, cu, card):
    """Phase r: ``ThroughputCache`` on the card: each runner measures once
    into the temp store, then a new cache reads every peak back without
    measuring."""
    cu.server.reset_counts()
    t0 = time.perf_counter()
    peaks = S.ThroughputCache(cu).all()
    took = time.perf_counter() - t0
    launches = dict(cu.server.launches)
    if not launches.get("_fma_chain") or not launches.get("_add_one"):
        fail(f"phase r: the K0 runners did not launch: {launches}")
    modes = T.ThroughputCache.MODES
    T.ThroughputCache.MODES = {m: _no_measure for m in modes}
    try:
        back = S.ThroughputCache(cu).all()
    finally:
        T.ThroughputCache.MODES = modes
    if back != peaks or not all(math.isfinite(v) and v > 0
                                for v in peaks.values()):
        fail(f"phase r: measured {peaks}, read back {back}")
    print(f"phase r ThroughputCache ({took:.2f} s, stored and read back): "
          f"memory {peaks['memory'] / 1e9:.0f} GB/s "
          f"({100 * peaks['memory'] / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s); "
          f"compute_cmma bf16 {peaks['compute_cmma'] / 1e12:.1f} TFLOP/s "
          f"({100 * peaks['compute_cmma'] / 989e12:.1f}% of 989); "
          f"compute_direct f32 FMA {peaks['compute_direct'] / 1e12:.1f} "
          f"TFLOP/s ({100 * peaks['compute_direct'] / 67e12:.1f}% of 67); "
          f"launch {peaks['launch'] * 1e6:.2f} us [{card}]", flush=True)
    return peaks


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # phase n tunes into a fresh store, removed at exit
    tune_root = tempfile.mkdtemp(prefix="cubecl_tune_")
    atexit.register(shutil.rmtree, tune_root, True)
    os.environ["CUBECL_ENVIRONMENT_ROOT"] = tune_root
    from cubecl_tpu_torch.models import llama
    from cubecl_tpu_torch.ops import attention as fa
    from cubecl_tpu_torch.ops import matmul as mm
    from cubecl_tpu_torch.ops import paged_attention as pa
    from cubecl_tpu_torch import std as cstd
    from cubecl_tpu_torch.examples import reduction_progression as ex_prog
    from cubecl_tpu_torch.examples import sum_things as ex_sum
    from cubecl_tpu_torch.ops import fusion as FU
    from cubecl_tpu_torch.ops import reduce as R
    from cubecl_tpu_torch.std import quant_kernels as qk
    from cubecl_tpu_torch.std import throughput as T
    from cubecl_tpu_torch.utils import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- phase 1: device ----------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([native.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(card)
    print(f"phase 1 device: {kind} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; {nvcc}",
          flush=True)

    from cubecl_tpu_torch.backend.cuda.printer import CudaCompiler
    from cubecl_tpu_torch.runtime import (CudaRuntime, default_client,
                                          eval_client)

    cu = CudaRuntime.client()
    if default_client() is not cu or not isinstance(cu.server.compiler,
                                                    CudaCompiler):
        fail("the default client is not the CUDA one")
    ev = eval_client(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = dsl_cases(dev, torch.Generator(device=dev).manual_seed(2))
    train_cases = bwd_cases(dev, torch.Generator(device=dev).manual_seed(6))

    # -- phase 2: build -----------------------------------------------------
    # K0's kernels are traced and printed, and their nvcc processes started,
    # by phase a's and e's launches on a compile-only client (they cover
    # every K0 kernel that phases b, c and f-h launch); csrc builds while
    # they compile
    t0 = time.perf_counter()
    co = compile_only(cu)
    for c in cases + train_cases:
        c["prepare"](co)()
    mm_compile_only(mm, qk, co)
    block_extremes = make_block_extremes()
    red_compile_only(R, FU, cstd, ex_sum, ex_prog, T, co, block_extremes)
    build = native.build()
    native.kernels()
    cu.server.wait_builds()
    build_wall = time.perf_counter() - t0
    summary = ptxas_summary(build.log)
    regs = "; ".join(f"{n}: {r} regs, {s}" for n, r, s in summary
                     if "gemm_kernel" not in n)
    gemm = [(r, s) for n, r, s in summary if "gemm_kernel" in n]
    spills = sorted({s for _, s in gemm if not s.startswith(
        "0 bytes stack frame, 0 bytes spill stores")})
    print(f"phase 2 build: {build.seconds:.1f} s nvcc -> "
          f"{os.path.relpath(build.path)}; ptxas: {regs}; matmul: "
          f"{len(gemm)} tile instances, {min(r for r, _ in gemm)}-"
          f"{max(r for r, _ in gemm)} registers, stack or spills in "
          f"{sum(1 for _, s in gemm if s in spills)} ({'; '.join(spills)})",
          flush=True)
    n_k0 = sum(hasattr(c.fn, "build") for c in cu.server._cache.values())
    print(f"phase 2 build K0: {n_k0} @cube kernels "
          f"printed and built by nvcc in parallel with csrc, "
          f"{build_wall:.1f} s wall for all, {cu.server.build_seconds():.1f}"
          f" s of nvcc summed; ptxas stack/spill per kernel: "
          f"{k0_ptxas(cu)}", flush=True)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- phase 3: flash vs plain --------------------------------------------
    flash_rows = []
    for B, H, Hkv, S, D, dt in [(8, 16, 8, 1024, 128, torch.bfloat16),
                                (2, 12, 4, 384, 64, torch.float32),
                                (2, 16, 8, 1021, 128, torch.bfloat16)]:
        q, k, v = (randn(B, H, S, D, dtype=dt), randn(B, Hkv, S, D, dtype=dt),
                   randn(B, Hkv, S, D, dtype=dt))
        got = fa.flash_attention(q, k, v, True)
        torch.cuda.synchronize()
        what = f"flash {str(dt)[6:]} B{B} H{H}/{Hkv} S{S} D{D} causal"
        err = compare(got, fa.flash_attention_plain(q, k, v, True), what)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                           iters=10)
        lib_ms = cuda_ms(lambda: TF.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        bms, by = flash_bound(B, H, Hkv, S, S, D, dt, True)
        flash_rows.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bms, bound_by=by))
        print(f"phase 3 {what}: max abs err {err} (atol/rtol {TOL[dt]}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]",
              flush=True)

    # -- phase 4: paged vs plain --------------------------------------------
    paged_rows = []
    for name, B, L, Hkv, G, D, page, max_pages, lengths, dt in [
            ("ragged", 8, 4, 8, 2, 128, 128, 8,
             [0, 1, 127, 128, 129, 1000, 640, 1024], torch.bfloat16),
            ("serving", 8, 16, 8, 2, 128, 128, 9, [1056] * 8, torch.bfloat16),
            ("d768", 16, 8, 4, 3, 64, 128, 4, [400] * 16, torch.float32)]:
        P = B * max_pages + 5
        q = randn(B, Hkv * G, D, dtype=dt)
        kp = randn(L, Hkv, P, page, D, dtype=dt)
        vp = randn(L, Hkv, P, page, D, dtype=dt)
        table = torch.randperm(P, generator=gen, device=dev)[:B * max_pages]
        table = table.view(B, max_pages).to(torch.int32)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = pa.paged_attention(q, kp, vp, table, ln, layer=L - 1)
        torch.cuda.synchronize()
        what = (f"paged {name} {str(dt)[6:]} B{B} Hkv{Hkv} G{G} D{D} "
                f"page{page} layer{L - 1}/{L}")
        err = compare(got, pa.paged_attention_plain(q, kp, vp, table, ln,
                                                    layer=L - 1), what)
        if 0 in lengths and got[lengths.index(0)].any():
            fail(f"{what}: a length-0 row is not zero")
        # rotate over the layers, so that each launch finds its pages cold
        # in L2, as a decode step that walks all layers does
        layers = iter(range(10**9))
        ms = cuda_ms(lambda: pa.paged_attention(
            q, kp, vp, table, ln, layer=next(layers) % L), iters=32)
        plain_ms = cuda_ms(lambda: pa.paged_attention_plain(
            q, kp, vp, table, ln, layer=next(layers) % L), iters=16)
        bms, by = paged_bound(dt, kp.element_size(), D, Hkv * G, Hkv,
                              [max(x, 0) for x in lengths], lengths, False, B)
        paged_rows.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bms, bound_by=by))
        print(f"phase 4 {what}: max abs err {err} (atol/rtol {TOL[dt]}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}) [{card}]", flush=True)
    del q, kp, vp

    # -- phase 5: serve at full width (bench.py:541-545) --------------------
    cfg = llama.LlamaConfig(vocab=8192, d_model=2048, n_heads=16,
                            n_kv_heads=8, n_layers=16, d_ff=5632, seq=1024,
                            dtype="bfloat16", use_framework_kernels=False)
    model = llama.init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    B, S, steps, page = 8, 1024, 64, 128
    max_pages = math.ceil((S + steps) / page)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    toks = llama.generate(model, prompt, steps, max_pages, page)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_attention": pa.paged_attention.launches}
    want = {"flash_attention": cfg.n_layers,
            "paged_attention": cfg.n_layers * steps}
    if launches != want:
        fail(f"serve: kernel launches {launches}, want {want}")
    if toks.shape != (B, steps) or toks.dtype != torch.int32 \
            or not ((toks >= 0) & (toks < cfg.vocab)).all():
        fail(f"serve: bad tokens {toks.shape} {toks.dtype}")

    # warm re-run, timed in its two phases; it must reproduce the tokens
    cache = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = llama.prefill(model, cache, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if not torch.isfinite(logits.float()).all():
        fail("serve: non-finite prefill logits")
    tok = logits.argmax(-1).to(torch.int32)
    again = [tok]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = llama.decode_step(model, cache, tok)
        tok = logits.argmax(-1).to(torch.int32)
        again.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not torch.equal(torch.stack(again[:steps], 1), toks):
        fail("serve: the warm re-run gave other tokens than generate")
    print(f"phase 5 serve llama {n_params / 1e9:.3f}B bf16 (d2048, 16 "
          f"layers, 16/8 heads): {B} requests x {S} prompt + {steps} greedy "
          f"steps; generate {gen_s:.3f} s cold; launches {launches}; warm "
          f"prefill {prefill_s:.4f} s ({B * S / prefill_s:.0f} prompt tok/s), "
          f"decode {B * steps / decode_s:.1f} tok/s "
          f"({1e3 * decode_s / steps:.3f} ms/step) [{card}]", flush=True)
    del model, cache, logits

    # -- phase 6: serve exactness, kernels vs plain (bench.py:604-609) ------
    print(f"phase 6 {exactness(llama, dev, False)}", flush=True)

    # -- phase a: the DSL kernels (K0) at BASELINE sizes --------------------
    k0_rows = []
    for c in cases:
        k0_rows.append(run_case(c, cu, ev, card))
    checked = set(cu.server._cache)

    # -- phase b: serve at full width with RMSNorm on K0 --------------------
    k0_serve = serve_k0(llama, fa, pa, cu, dev, card)

    # -- phase c: serve exactness with RMSNorm on K0 ------------------------
    print(f"phase c {exactness(llama, dev, True)}", flush=True)
    unchecked = set(cu.server._cache) - checked
    if unchecked:
        fail(f"phases b/c launched K0 kernels that phase a did not hold "
             f"against plain: {sorted(unchecked)}")

    bc_launches = dict(cu.server.launches)

    # -- phase d: flash backward kernels vs plain ---------------------------
    bwd_rows = flash_backward(fa, dev, gen, card)

    # -- phase e: the K0 backward kernels at the train shapes ---------------
    e_rows = {c["name"]: run_case(c, cu, ev, card, "e") for c in train_cases}
    param_grad_checks(dev, gen, card)
    checked = set(cu.server._cache)

    # -- phase f: train llama 0.77B bf16 at full width ----------------------
    f_launches = train_llama(llama, fa, cu, dev, card)

    # -- phase g: train exactness, kernels vs plain -------------------------
    for framework in (True, False):
        print(f"phase g {train_exactness(llama, dev, framework)} [{card}]",
              flush=True)

    # -- phase h: train the transformer (GPT-2 small widths) ----------------
    h_launches = train_transformer(fa, cu, dev, card)
    unchecked = set(cu.server._cache) - checked
    if unchecked:
        fail(f"phases f-h launched K0 kernels that phases a and e did not "
             f"hold against plain: {sorted(unchecked)}")

    # -- phase i: the chunked paged-attention kernel (P3) against plain ------
    i_rows = chunked_vs_plain(pa, dev, gen, card)

    # -- phase j: paged decode on int8 pools against plain; KV-bound decode -
    j_rows = paged_int8(pa, dev, gen, card)

    # -- phase k: the slice's path at full width (llama 0.77B bf16) ---------
    k_out = serve_slice(llama, pa, fa, dev, card)

    # -- phase l: the slice's exactness in f32 (d768), kernels vs plain -----
    print(f"phase l {slice_exactness(llama, pa, fa, dev, card)} [{card}]",
          flush=True)

    # -- phase m: the matmul kernel (M1, M2) against plain, by dtype --------
    m_rows = matmul_vs_plain(mm, dev, gen, card)

    # -- phase n: the autotuned matmul path (BASELINE config 4) -------------
    n_out = autotuned_path(mm, cu, dev, gen, card)

    # -- phase o: K0 cmma (matmul_cmma) and the K0 quant kernels ------------
    o_out = cmma_and_quant(mm, qk, cu, ev, dev, gen, card)
    torch.cuda.empty_cache()

    # -- phase p: reductions (BASELINE config 2) -----------------------------
    p_out = reductions(R, ex_sum, ex_prog, cu, ev, dev, gen, card,
                       block_extremes)
    torch.cuda.empty_cache()

    # -- phase q: comptime fusion (config 5), into_contiguous, identity -----
    q_out = fusion_and_std(FU, cstd, cu, ev, dev, gen, card)
    torch.cuda.empty_cache()

    # -- phase r: the throughput runners, stored and read back ---------------
    throughput(cstd, T, cu, card)

    def row(name, source, replaces, n, r, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": library_ms, **extra}

    def k0_row(name, r, n, elem, moved, flops, **extra):
        bms, by = elementwise_bound(n, elem, moved, flops)
        return row(name, "cubecl_tpu_torch/ops/functional.py (printed by "
                   "cubecl_tpu_torch/backend/cuda/printer.py)",
                   "cubecl_tpu/backend/pallas/emitter.py:48", extra.pop(
                       "launches"), dict(r, bound_ms=bms, bound_by=by),
                   r["library_ms"], **extra)

    train = bwd_rows["train"]
    sdpa_bwd = "the autograd backward of F.scaled_dot_product_attention " \
               "(dq, dk and dv together)"
    rms = next(r for r in k0_rows if r["name"] == "rmsnorm fwd bf16 8192x2048")
    rms_dec = next(r for r in k0_rows
                   if r["name"] == "rmsnorm fwd bf16 8x2048 (llama serve)")
    p3_launches = {
        "chunked_prefill": k_out["chunked_prefill"]["launches"][
            "paged_attention_chunked"],
        **{f"speculative_{k}": v["launches"]["paged_attention_chunked"]
           for k, v in k_out["speculative"].items()},
        "continuous_batching": k_out["cb"]["launches"][
            "paged_attention_chunked"]}
    e = lambda case: e_rows[case]  # noqa: E731
    print(json.dumps({"kernels": [
        row("flash_attention", "cubecl_tpu_torch/csrc/flash_attention.cu",
            "cubecl_tpu/ops/attention.py:76", launches["flash_attention"],
            flash_rows[0], flash_rows[0]["library_ms"],
            library="F.scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True)",
            shape="bf16 B8 H16/8 S1024 D128 causal"),
        row("paged_attention", "cubecl_tpu_torch/csrc/paged_attention.cu",
            "cubecl_tpu/ops/paged_attention.py:247",
            launches["paged_attention"], paged_rows[1], None,
            library=NO_LIBRARY_PAGED,
            shape="bf16 B8 Hkv8 G2 D128 context 1056, 16-layer pool"),
        row("paged_attention_int8", "cubecl_tpu_torch/csrc/paged_attention.cu",
            "cubecl_tpu/ops/paged_attention.py:247",
            k_out["int8"]["launches"]["paged_attention_int8"],
            j_rows["serving int8"], None, library=NO_LIBRARY_PAGED,
            shape="int8 KV, bf16 q, B8 Hkv8 G2 D128 context 1056",
            kv_bound_b16_ctx2048={k: {f: j_rows[k][f] for f in (
                "ms", "bound_ms", "kv_gb_per_s")} for k in (
                "KV-bound bf16", "KV-bound int8")}),
        row("paged_attention_chunked",
            "cubecl_tpu_torch/csrc/paged_chunked.cu",
            "cubecl_tpu/ops/paged_attention.py:675",
            sum(p3_launches.values()), i_rows["verify"], None,
            library=NO_LIBRARY_PAGED,
            shape="verify: bf16 B8 Hkv8 G2 C5 D128 context 1056",
            launches_by_path=p3_launches,
            **{name.replace(" ", "_"): {f: i_rows[name][f] for f in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
               for name in ("prefill start 0", "prefill start 768",
                            "verify int8", "prefill int8 start 768")}),
        k0_row("k0_cube_kernels", dict(rms), 8192 * 2048, 2, 2, 4,
               launches=k0_serve["launches"],
               library="F.rms_norm",
               main_path_kernel="_rmsnorm_fwd_k (llama RMSNorm, prefill "
                                "8x1024 rows of 2048 bf16)",
               decode_8x2048={k: rms_dec[k] for k in
                              ("max_abs_err", "ms", "plain_ms",
                               "library_ms")},
               cube_kernels_compiled=sorted(
                   {k.name for k in cu.server._cache.values()
                    if hasattr(k.fn, "build")}),
               cube_kernel_launches_phases_b_c=bc_launches,
               cube_kernel_launches_phases_f_h={
                   k: v for k, v in {**f_launches, **h_launches}.items()
                   if k.endswith("_k")},
               softmax_bwd_8192x2048={
                   "note": "_softmax_bwd_k: held in phase e; no model path "
                           "launches it; library: the autograd backward "
                           "of torch.softmax",
                   **{dt: {k: e(f"_softmax_bwd_k {dt} 8192x2048")[k]
                           for k in ("max_abs_err", "ms", "plain_ms",
                                     "library_ms")}
                      for dt in ("f32", "bf16")}},
               build_s=round(build_wall, 3)),
        row("flash_attention_bwd_dkv",
            "cubecl_tpu_torch/csrc/flash_attention_bwd.cu",
            "cubecl_tpu/ops/attention.py:469", f_launches["flash_bwd_dkv"],
            dict(max_abs_err=train["dkv_err"], ms=train["dkv_ms"],
                 plain_ms=train["plain_ms"], bound_ms=train["dkv_bound"][0],
                 bound_by=train["dkv_bound"][1]), train["library_ms"],
            plain_ms_is="the whole plain backward (dq, dk, dv)",
            library=sdpa_bwd, shape="bf16 B8 H16/8 S1023 D128 causal"),
        row("flash_attention_bwd_dq",
            "cubecl_tpu_torch/csrc/flash_attention_bwd.cu",
            "cubecl_tpu/ops/attention.py:660", f_launches["flash_bwd_dq"],
            dict(max_abs_err=train["dq_err"], ms=train["dq_ms"],
                 plain_ms=train["plain_ms"], bound_ms=train["dq_bound"][0],
                 bound_by=train["dq_bound"][1]), train["library_ms"],
            plain_ms_is="the whole plain backward (dq, dk, dv)",
            library=sdpa_bwd, shape="bf16 B8 H16/8 S1023 D128 causal"),
        k0_row("_rmsnorm_bwd_k", e("_rmsnorm_bwd_k bf16 8x1023x2048"),
               8 * 1023 * 2048, 2, 3, 8,
               launches=f_launches["_rmsnorm_bwd_k"],
               library="the autograd backward of F.rms_norm (dx and dg)",
               shape="bf16 8x1023x2048"),
        k0_row("_layernorm_bwd_k", e("_layernorm_bwd_k bf16 8x1024x768"),
               8 * 1024 * 768, 2, 3, 10,
               launches=h_launches["_layernorm_bwd_k"],
               library="the autograd backward of F.layer_norm (dx, dg, db)",
               shape="bf16 8x1024x768"),
        k0_row("_gelu_bwd_k", e("_gelu_bwd_k bf16 8x1024x3072"),
               8 * 1024 * 3072, 2, 3, 20,
               launches=h_launches["_gelu_bwd_k"],
               library="the autograd backward of F.gelu(approximate="
                       "'none')", shape="bf16 8x1024x3072"),
        row("matmul", "cubecl_tpu_torch/csrc/matmul.cu",
            "cubecl_tpu/ops/matmul.py:43", n_out["launches"]["matmul_pallas"],
            n_out["matmul"], n_out["matmul"]["library_ms"],
            library="torch.matmul",
            shape="bf16 4096^3 -> bf16, matmul_autotuned's winner",
            **{k: n_out["matmul"][k] for k in ("tile", "tflops",
                                               "pct_of_989", "per_call_ms")},
            autotuned={k: {f: v[f] for f in ("tile", "tune_s", "graph_ms")}
                       for k, v in n_out["keys"].items()},
            quantized_rel_err=n_out["quantized_rel_err"],
            by_case=m_rows),
        row("matmul_scaled", "cubecl_tpu_torch/csrc/matmul.cu",
            "cubecl_tpu/ops/matmul.py:477",
            n_out["launches"]["matmul_scaled"], n_out["matmul_scaled"],
            n_out["matmul_scaled"]["library_ms"], library="torch._scaled_mm",
            shape="e4m3 4096^3, B as (N, K), x sa*sb -> bf16"),
        row("k0_cmma", "cubecl_tpu_torch/ops/matmul.py (matmul_cmma_nd_"
            "kernel, printed by cubecl_tpu_torch/backend/cuda/printer.py)",
            "cubecl_tpu/backend/pallas/emitter.py:48",
            o_out["k0_cmma"]["launches"], o_out["k0_cmma"],
            o_out["k0_cmma"]["library_ms"],
            library=o_out["k0_cmma"]["library"],
            shape=o_out["k0_cmma"]["shape"]),
        row("k0_quantize", "cubecl_tpu_torch/std/quant_kernels.py "
            "(quantize_block_kernel, printed by "
            "cubecl_tpu_torch/backend/cuda/printer.py)",
            "cubecl_tpu/backend/pallas/emitter.py:48",
            n_out["launches"]["quantize_block_kernel"], o_out["k0_quantize"],
            None, library="none: no one call takes a tensor's absmax scale "
                          "and quantizes with it",
            shape="f32 4096^2 -> int8, one per-tensor scale",
            block_4096=o_out["k0_quantize_block"]),
        row("reduce_native", "cubecl_tpu_torch/csrc/reduce.cu",
            "cubecl_tpu/ops/reduce.py:219", p_out["launches"]["reduce_native"],
            p_out["r1"]["f32 64M"], p_out["r1"]["f32 64M"]["library_ms"],
            library="torch.sum(x, dtype=torch.float32)",
            shape="f32 64M -> f32 (BASELINE config 2)",
            **{k: p_out["r1"]["f32 64M"][k] for k in (
                "gb_per_s", "block_rows", "ms_by_block_rows")},
            bf16_64M=p_out["r1"]["bf16 64M"],
            f32_128x1000=p_out["r1"]["f32 128x1000"],
            reduce_sum_autotuned=dict(winner=p_out["winner"],
                                      tune_s=p_out["tune_s"],
                                      candidates_ms=p_out["candidates_ms"])),
        row("k0_block_reduce", "cubecl_tpu_torch/ops/reduce.py "
            "(reduce_block_partial: mem.block_reduce, printed by "
            "cubecl_tpu_torch/backend/cuda/printer.py)",
            "cubecl_tpu/backend/pallas/emitter.py:48",
            p_out["block"]["launches"], p_out["block"],
            p_out["block"]["library_ms"], library="torch.sum(x, dim=1)",
            shape=f"f32 64M as {BLOCK_CUBES} windows, cubes of 8 units",
            k0_routes_64M=p_out["routes"],
            reduction_progression_ms=p_out["progression"],
            sum_things_ms=p_out["sum_things"],
            path_launches=p_out["launches"]),
        row("k0_fused_chain", "cubecl_tpu_torch/ops/fusion.py (fused_chain, "
            "printed by cubecl_tpu_torch/backend/cuda/printer.py)",
            "cubecl_tpu/backend/pallas/emitter.py:48",
            q_out["launches"]["fused_chain"],
            q_out["rows"]["add -> mul -> relu"], None,
            library="none: no one PyTorch call computes relu((a+b)*c)",
            shape="relu((a+b)*c), f32 16M",
            add_gelu=q_out["rows"]["add -> gelu"],
            into_contiguous=q_out["contiguous"],
            identity=q_out["identity"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
