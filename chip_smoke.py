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
hold). Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``.
Any failed phase exits non-zero before the last line; without a CUDA device
(or without the package beside it) the script exits non-zero and prints no
result. Imports only torch, numpy and cubecl_tpu_torch.
"""

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

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
            k = re.search(r"\d+([A-Za-z_]+_kernel)I(13__nv_bfloat16|f)Li(\d+)E",
                          m.group(1))
            name = (f"{k.group(1)}<{'f32' if k.group(2) == 'f' else 'bf16'}, "
                    f"{k.group(3)}>" if k else m.group(1))
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
    for shape, dtype in K0_SERVE_SHAPES:
        # own names: the plain lambdas above read x and g when called
        xs, gs = rn(*shape, dtype=dtype), rn(shape[-1], dtype=dtype)

        def prepare(c, xs=xs, gs=gs):
            return lambda: F.rmsnorm(xs, gs, RMS_EPS, client=c)
        cases.append(dict(
            name=f"rmsnorm fwd {'bf16' if dtype == torch.bfloat16 else 'f32'}"
                 f" {'x'.join(map(str, shape))} (llama serve)", prepare=prepare,
            plain=lambda xs=xs, gs=gs: _plain_rmsnorm(xs, gs, RMS_EPS),
            tol=None))
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
    tol = case["tol"] or TOL[got.dtype]
    print(f"phase {phase} {what}: max abs err {err} vs plain (atol/rtol {tol}), "
          f"{err_ev} vs the torch evaluator (atol/rtol {TOL[got.dtype]}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]",
          flush=True)
    return {"name": case["name"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def k0_ptxas(cu):
    """'kernel: stack/spill bytes' of each K0 build, from ptxas -v."""
    out = []
    for c in cu.server._cache.values():
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


def _dt(dtype):
    return "bf16" if dtype == torch.bfloat16 else "f32"


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
        for kind, (launch, plain) in (("fwd", fwd), ("bwd", bwd)):
            cases.append(dict(
                name=f"_{op}_{kind}_k {_dt(dt)} {size}", op=op, kind=kind,
                prepare=lambda c, launch=launch: (lambda: launch(c)),
                plain=plain, tol=chain))
    for dt in (torch.float32, torch.bfloat16):
        y = torch.softmax(rn(8192, 2048, dtype=torch.float32), -1).to(dt)
        dy = rn(8192, 2048, dtype=dt)
        cases.append(dict(
            name=f"_softmax_bwd_k {_dt(dt)} 8192x2048", op="softmax",
            kind="bwd", prepare=lambda c, y=y, dy=dy: (lambda: F._rows(
                F._softmax_bwd_k, y, [y, dy], client=c)),
            plain=lambda y=y, dy=dy: _plain_softmax_bwd(y, dy),
            tol=CHAIN_TOL if dt == torch.bfloat16 else None))
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
        print(f"phase d {what}: max abs err o {err_o}, lse {err_lse}, dq "
              f"{err[0]}, dk {err[1]}, dv {err[2]} (atol/rtol {TOL[dt]}; "
              f"lse {TOL[torch.float32]}); kernels: forward with lse "
              f"{fwd_ms:.4f} ms, dK/dV {dkv_ms:.4f} ms, dQ {dq_ms:.4f} ms; "
              f"plain backward {plain_ms:.4f} ms [{card}]", flush=True)
        rows[name] = dict(dq_err=err[0], dkv_err=max(err[1:]), fwd_ms=fwd_ms,
                          dkv_ms=dkv_ms, dq_ms=dq_ms, plain_ms=plain_ms)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from cubecl_tpu_torch.models import llama
    from cubecl_tpu_torch.ops import attention as fa
    from cubecl_tpu_torch.ops import paged_attention as pa
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
    build = native.build()
    native.kernels()
    cu.server.wait_builds()
    build_wall = time.perf_counter() - t0
    regs = "; ".join(f"{n}: {r} regs, {s}" for n, r, s in
                     ptxas_summary(build.log))
    print(f"phase 2 build: {build.seconds:.1f} s nvcc -> "
          f"{os.path.relpath(build.path)}; ptxas: {regs}", flush=True)
    print(f"phase 2 build K0: {cu.server.compile_count} @cube kernels "
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
        flash_rows.append((err, ms, plain_ms))
        print(f"phase 3 {what}: max abs err {err} (atol/rtol {TOL[dt]}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]",
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
        paged_rows.append((err, ms, plain_ms))
        print(f"phase 4 {what}: max abs err {err} (atol/rtol {TOL[dt]}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]",
              flush=True)
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

    def row(name, source, replaces, rows):
        err, ms, plain_ms = rows[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    train = bwd_rows["train"]

    def k0_bwd_row(op, case, count):
        r = e_rows[case]
        return {"name": f"_{op}_bwd_k", "route": "cuda",
                "source": "cubecl_tpu_torch/ops/functional.py (printed by "
                          "cubecl_tpu_torch/backend/cuda/printer.py)",
                "replaces": "cubecl_tpu/backend/pallas/emitter.py:48",
                "launches": count, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "shape": case.split(" ", 1)[1]}

    rms = next(r for r in k0_rows if r["name"] == "rmsnorm fwd bf16 8192x2048")
    rms_dec = next(r for r in k0_rows
                   if r["name"] == "rmsnorm fwd bf16 8x2048 (llama serve)")
    print(json.dumps({"kernels": [
        row("flash_attention", "cubecl_tpu_torch/csrc/flash_attention.cu",
            "cubecl_tpu/ops/attention.py:76", flash_rows),
        row("paged_attention", "cubecl_tpu_torch/csrc/paged_attention.cu",
            "cubecl_tpu/ops/paged_attention.py:247", paged_rows[1:]),
        {"name": "k0_cube_kernels", "route": "cuda",
         "source": "cubecl_tpu_torch/backend/cuda/printer.py",
         "replaces": "cubecl_tpu/backend/pallas/emitter.py:48",
         "launches": k0_serve["launches"],
         "max_abs_err": rms["max_abs_err"], "ms": rms["ms"],
         "plain_ms": rms["plain_ms"],
         "main_path_kernel": "_rmsnorm_fwd_k (llama RMSNorm, prefill "
                             "8x1024 rows of 2048 bf16)",
         "decode_8x2048": {k: rms_dec[k] for k in
                           ("max_abs_err", "ms", "plain_ms")},
         "cube_kernels_compiled": sorted(
             {k.name for k in cu.server._cache.values()}),
         "cube_kernel_launches_phases_b_c": bc_launches,
         "cube_kernel_launches_phases_f_h": {
             k: v for k, v in {**f_launches, **h_launches}.items()
             if k.endswith("_k")},
         "softmax_bwd_8192x2048": {
             "note": "_softmax_bwd_k: held in phase e; no model path "
                     "launches it",
             **{dt: {k: e_rows[f"_softmax_bwd_k {dt} 8192x2048"][k]
                     for k in ("max_abs_err", "ms", "plain_ms")}
                for dt in ("f32", "bf16")}},
         "build_s": round(build_wall, 3)},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "cubecl_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "cubecl_tpu/ops/attention.py:469",
         "launches": f_launches["flash_bwd_dkv"],
         "max_abs_err": train["dkv_err"], "ms": train["dkv_ms"],
         "plain_ms": train["plain_ms"],
         "plain_ms_is": "the whole plain backward (dq, dk, dv)",
         "shape": "bf16 B8 H16/8 S1023 D128 causal"},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "cubecl_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": "cubecl_tpu/ops/attention.py:660",
         "launches": f_launches["flash_bwd_dq"],
         "max_abs_err": train["dq_err"], "ms": train["dq_ms"],
         "plain_ms": train["plain_ms"],
         "plain_ms_is": "the whole plain backward (dq, dk, dv)",
         "shape": "bf16 B8 H16/8 S1023 D128 causal"},
        k0_bwd_row("rmsnorm", "_rmsnorm_bwd_k bf16 8x1023x2048",
                   f_launches["_rmsnorm_bwd_k"]),
        k0_bwd_row("layernorm", "_layernorm_bwd_k bf16 8x1024x768",
                   h_launches["_layernorm_bwd_k"]),
        k0_bwd_row("gelu", "_gelu_bwd_k bf16 8x1024x3072",
                   h_launches["_gelu_bwd_k"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
