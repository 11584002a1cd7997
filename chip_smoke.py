#!/usr/bin/env python3
"""Smoke test of cubecl_tpu_torch on one CUDA card (an H100).

Builds the port's CUDA kernels from ``cubecl_tpu_torch/csrc``, holds each
against its plain PyTorch version at the shapes of the serving path, drives
llama serving (``generate``) at the full width of the repo's largest llama,
and checks a smaller f32 config end to end against the plain versions.

    python3 chip_smoke.py          # from the repository root; one card

Phases (one line each, before the last): 1 device, 2 build, 3 flash vs
plain, 4 paged vs plain, 5 serve at full width, 6 serve exactness. Then a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero before the last line; without a CUDA device
(or without the package beside it) the script exits non-zero and prints no
result. Imports only torch, numpy and cubecl_tpu_torch.
"""

import json
import math
import os
import re
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


def compare(got, ref, what):
    """Max abs error of got vs ref; fails outside TOL of ref's dtype."""
    atol, rtol = TOL[ref.dtype]
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

    # -- phase 2: build -----------------------------------------------------
    build = native.build()
    native.kernels()
    regs = "; ".join(f"{n}: {r} regs, {s}" for n, r, s in
                     ptxas_summary(build.log))
    print(f"phase 2 build: {build.seconds:.1f} s nvcc -> "
          f"{os.path.relpath(build.path)}; ptxas: {regs}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)

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
    cfg = llama.LlamaConfig(vocab=8192, d_model=768, n_heads=12, n_kv_heads=4,
                            n_layers=8, d_ff=2048, seq=512,
                            use_framework_kernels=False)
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
    print(f"phase 6 exactness llama d768 f32 (8 layers, 12/4 heads): {B} "
          f"requests x {S} prompt + {steps} steps, kernels vs plain on the "
          f"card: prefill logits max abs err {logit_err} (tol {LOGIT_TOL}); "
          f"{same}/{B} token rows equal; near-tie flips {flips}", flush=True)

    def row(name, source, replaces, rows):
        err, ms, plain_ms = rows[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    print(json.dumps({"kernels": [
        row("flash_attention", "cubecl_tpu_torch/csrc/flash_attention.cu",
            "cubecl_tpu/ops/attention.py:76", flash_rows),
        row("paged_attention", "cubecl_tpu_torch/csrc/paged_attention.cu",
            "cubecl_tpu/ops/paged_attention.py:247", paged_rows[1:]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
