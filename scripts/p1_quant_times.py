#!/usr/bin/env python3
"""Device times of the paged decode attention (P1) and of K0's quantize
kernels on one CUDA card, and the serving paths that run P1, measured
alike for two checkouts.

    python3 scripts/p1_quant_times.py [--tree DIR] [--no-serve]

Imports ``cubecl_tpu_torch`` from DIR (default: the checkout this script
is in), so that an older checkout's kernels are timed by the same method
as this one's; the method and the shapes are ``chip_smoke.py``'s of this
checkout. For P1: phase 4's cases (the 0.77B llama's serving decode, B 8
x Hkv 8 x G 2 x D 128 at context 1056 in bf16, a ragged batch with a
length-0 row, the d768 f32 model: G 3, D 64) and phase j's (the serving
decode on int8 pools, a ragged int8 batch, the KV-bound decode B 16 at
context 2048 on bf16 and on int8 pools): its device time with a cold L2
(``cold_ms``: each call after a read of 1 GiB), its time back to back
with each launch on the next layer of the pool (``cuda_ms``), the
position splits where the tree's ops have ``p1_plan``, its bound (bytes
over 3.35 TB/s) and the worst error against plain as a share of ``TOL``;
no library call computes it. For K0's quantize at f32 4096^2 (phase o):
one per-tensor scale and 4096 block scales, each call's cold device time
and time back to back, the bound (one read of x and one write of the
values) and the two-read floor, each launch's K0 kernel names, the
values and scales against ``quantize_plain`` bit for bit, the per-tensor
dequantize's cold time, ``matmul_quantized`` at 4096^3 (phase n's
call: two quantizes, then M1 int8) back to back, and, where the tree
has the two passes, each pass alone beside a pass 1 of ``block_max``
and ``block_min``. Then, unless
``--no-serve``, the 0.77B bf16 llama's decode (phase 5: 8 x 1024 prompt,
64 greedy steps, ms a step on the host clock) and phase k (``serve_slice``:
chunked prefill, speculative decoding, int8 KV and continuous batching,
launches checked) on the tree's modules. Prints the card
(``nvidia-smi``) and one JSON line; needs a card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, B, L, Hkv, G, D, max_pages, lengths, q dtype, int8 pools), page 128
P1_CASES = [
    ("serving bf16", 8, 16, 8, 2, 128, 9, [1056] * 8, torch.bfloat16, False),
    ("ragged bf16", 8, 4, 8, 2, 128, 8, [0, 1, 127, 128, 129, 1000, 640,
                                         1024], torch.bfloat16, False),
    ("d768 f32", 16, 8, 4, 3, 64, 4, [400] * 16, torch.float32, False),
    ("serving int8", 8, 16, 8, 2, 128, 9, [1056] * 8, torch.bfloat16, True),
    ("ragged int8", 8, 4, 8, 2, 128, 8, [0, 1, 127, 128, 129, 1000, 640,
                                         1024], torch.bfloat16, True),
    ("KV-bound bf16", 16, 16, 8, 2, 128, 16, [2048] * 16, torch.bfloat16,
     False),
    ("KV-bound int8", 16, 16, 8, 2, 128, 16, [2048] * 16, torch.bfloat16,
     True),
]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _margin(cs, got, want):
    """The worst |got - want| as a share of TOL of want's dtype."""
    atol, rtol = cs.TOL[want.dtype]
    g, w = got.float(), want.float()
    return ((g - w).abs() / (atol + rtol * w.abs())).max().item()


def p1_times(cs, pa, dev, gen, card):
    out, page = {}, 128
    for name, B, L, Hkv, G, D, max_pages, lengths, dt, quant in P1_CASES:
        P = B * max_pages + 5
        shape = (L, Hkv, P, page, D)
        q = torch.randn(B, Hkv * G, D, generator=gen, device=dev).to(dt)
        if quant:
            kp, vp, ks, vs = cs.int8_pools(shape, dev, gen)
        else:
            kp, vp = (torch.randn(shape, generator=gen, device=dev).to(dt)
                      for _ in range(2))
            ks = vs = None
        table = torch.randperm(P, generator=gen, device=dev)[:B * max_pages]
        table = table.view(B, max_pages).to(torch.int32)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        sc = dict(k_scales=ks, v_scales=vs)
        got = pa.paged_attention(q, kp, vp, table, ln, layer=L - 1, **sc)
        want = pa.paged_attention_plain(q, kp, vp, table, ln, layer=L - 1,
                                        **sc)
        cs.compare(got, want, f"P1 {name}")
        layers = iter(range(10**9))
        ms = cs.cuda_ms(lambda: pa.paged_attention(
            q, kp, vp, table, ln, layer=next(layers) % L, **sc), iters=32)
        cold = cs.cold_ms(lambda: pa.paged_attention(
            q, kp, vp, table, ln, layer=L - 1, **sc))
        splits = pa.p1_plan(dt, kp.dtype, B, Hkv * G, Hkv, D, page,
                            max_pages).splits \
            if hasattr(pa, "p1_plan") else 1
        bms, by = cs.paged_bound(dt, kp.element_size(), D, Hkv * G, Hkv,
                                 [max(x, 0) for x in lengths], lengths,
                                 quant, B)
        out[name] = dict(cold_ms=cold, ms=ms, bound_ms=bms, bound_by=by,
                         splits=splits,
                         worst_err_over_tol=_margin(cs, got, want))
        print(f"P1 {name}: cold L2 {cold:.4f} ms, back to back {ms:.4f} ms "
              f"({splits} splits); bound {bms:.4f} ms ({by}, "
              f"{100 * bms / cold:.1f}% of it cold); worst |err| / "
              f"tolerance {out[name]['worst_err_over_tol']:.3f}; library "
              f"none [{card}]", flush=True)
        del q, kp, vp, ks, vs, got, want
    torch.cuda.empty_cache()
    return out


def quant_times(cs, qk, mm, cu, dev, gen, card):
    from cubecl_tpu_torch.std.quant import QuantLevel, QuantScheme

    out = {}
    n = cs.QUANT_N
    x = torch.randn(n, generator=gen, device=dev) * 3
    xh = cu.create(x)
    for scheme in (QuantScheme(), QuantScheme(level=QuantLevel.BLOCK,
                                              block_size=cs.QUANT_BLOCK)):
        level = scheme.level.value
        cu.server.reset_counts()
        vals, scales = qk.quantize(cu, xh, scheme)  # builds its kernels
        torch.cuda.synchronize()
        launches = dict(cu.server.launches)
        t0 = time.perf_counter()
        qk.quantize(cu, xh, scheme)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        pv, ps = qk.quantize_plain(x, scheme)
        differ = int((vals.tensor != pv).sum() + (scales.tensor != ps).sum())
        if differ:
            cs.fail(f"quantize {level}: {differ} elements differ from the "
                    f"plain version's bits")
        run = lambda scheme=scheme: qk.quantize(cu, xh, scheme)  # noqa: E731
        iters = 3 if warm_s > 0.01 else 20  # a one-cube pass takes ~0.1 s
        cold = cs.cold_ms(run, iters=iters)
        ms = cs.cuda_ms(run, iters=iters, warmup=1)
        deq = cs.cold_ms(lambda: qk.dequantize(cu, vals, scales, scheme),
                         iters=3 if scheme.level == QuantLevel.TENSOR
                         else 20)
        n_scales = ps.numel()
        bms, by = cs.bound_ms(2 * n, 5 * n + 4 * n_scales, torch.float32)
        floor = cs.bound_ms(2 * n, 9 * n + 4 * n_scales, torch.float32)[0]
        out[level] = dict(cold_ms=cold, ms=ms, bound_ms=bms, bound_by=by,
                          two_read_floor_ms=floor, launches=launches,
                          dequantize_cold_ms=deq)
        print(f"K0 quantize {level} f32 4096^2 ({n_scales} scales, "
              f"launches {launches}): cold L2 {cold:.4f} ms, back to back "
              f"{ms:.4f} ms; bound {bms:.4f} ms ({by}, {100 * bms / cold:.1f}"
              f"% of it), two reads of x {floor:.4f} ms; values and scales "
              f"the plain version's bits; dequantize cold {deq:.4f} ms "
              f"[{card}]", flush=True)
        del vals, scales, pv, ps
    S = cs.MM_S
    a, b = (torch.randn(S, S, generator=gen, device=dev) for _ in range(2))
    hs = (cu.create(a), cu.create(b), cu.empty((S, S), "float32"))
    mm.matmul_quantized(cu, *hs, S, S, S)  # builds its kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mm.matmul_quantized(cu, *hs, S, S, S)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    call = cs.cuda_ms(lambda: mm.matmul_quantized(cu, *hs, S, S, S),
                      iters=3 if warm_s > 0.05 else 10, warmup=1)
    out["matmul_quantized_ms"] = call
    print(f"matmul_quantized f32 {S}^3 (two per-tensor quantizes, M1 int8): "
          f"{call:.4f} ms a call back to back [{card}]", flush=True)
    return out


def pass1_times(cs, qk, cu, dev, gen, card):
    """The per-tensor quantize's passes alone at f32 4096^2, cold L2: the
    tree's pass 1, a pass 1 of ``Slice.block_max`` and ``block_min``
    over 1024 cubes of 256 units (defined here), and pass 2."""
    from cubecl_tpu_torch.frontend import (CUBE_POS_X, ArrayArg, MutSlice,
                                           Slice, abs_, cube, max_)
    from cubecl_tpu_torch.runtime.base import CubeCount, CubeDim

    @cube
    def absmax_blocks(x: Slice, partials: MutSlice, lines: int):
        hi = x.block_max(CUBE_POS_X * lines, lines)
        lo = x.block_min(CUBE_POS_X * lines, lines)
        partials[CUBE_POS_X] = max_(abs_(hi), abs_(lo))

    n = cs.QUANT_N
    x = torch.randn(n, generator=gen, device=dev) * 3
    xh = cu.create(x)
    (c1, it1), (c2, it2) = qk.tensor_plan(n)
    p1 = cu.empty((c1,), "float32")
    p2 = cu.empty((1024,), "float32")
    vals, sc = cu.empty((n,), "int8"), cu.empty((1,), "float32")
    lines = n // qk.TENSOR_LINE // 1024
    runs = {
        "pass 1, the tree's": lambda: qk.quantize_tensor_absmax
        .launch_unchecked(cu, CubeCount(c1), CubeDim.new_1d(qk.TENSOR_PLANE),
                          ArrayArg(xh, line_size=qk.TENSOR_LINE),
                          ArrayArg(p1, mutable=True), it1,
                          n // qk.TENSOR_LINE),
        "pass 1, block_max + block_min, 1024 x 256": lambda: absmax_blocks
        .launch_unchecked(cu, CubeCount(1024), CubeDim.new_1d(256),
                          ArrayArg(xh, line_size=qk.TENSOR_LINE),
                          ArrayArg(p2, mutable=True), lines),
        "pass 2": lambda: qk.quantize_tensor_values.launch_unchecked(
            cu, CubeCount(c2), CubeDim.new_1d(qk.TENSOR_UNITS),
            ArrayArg(xh, line_size=qk.TENSOR_LINE), ArrayArg(p1),
            ArrayArg(vals, line_size=qk.TENSOR_LINE, mutable=True),
            ArrayArg(sc, mutable=True), it2, n // qk.TENSOR_LINE, 127.0)}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    amax = x.abs().max()
    if p1.tensor.max() != amax or p2.tensor.max() != amax:
        cs.fail("pass 1 two ways: a partial max is not max |x|")
    out = {}
    for name, run in runs.items():
        out[name] = cs.cold_ms(run)
        print(f"K0 quantize {name}, f32 4096^2: cold L2 {out[name]:.4f} ms "
              f"[{card}]", flush=True)
    return out


def serve_decode(cs, llama, pa, dev, card):
    """Phase 5's decode: the 0.77B bf16 llama, 8 x 1024 prompt, 64
    greedy steps; ms a step on the host clock (a warm run after one
    ``generate``), P1 launches checked."""
    cfg = llama.LlamaConfig(vocab=8192, d_model=2048, n_heads=16,
                            n_kv_heads=8, n_layers=16, d_ff=5632, seq=1024,
                            dtype="bfloat16", use_framework_kernels=False)
    model = llama.init_params(cfg, seed=0, device=dev)
    B, S, steps, page = 8, 1024, 64, 128
    max_pages = -(-(S + steps) // page)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    pa.paged_attention.launches = 0
    toks = llama.generate(model, prompt, steps, max_pages, page)
    torch.cuda.synchronize()
    if pa.paged_attention.launches != cfg.n_layers * steps:
        cs.fail(f"decode: {pa.paged_attention.launches} P1 launches")
    cache = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    logits, cache = llama.prefill(model, cache, prompt)
    tok = logits.argmax(-1).to(torch.int32)
    again = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = llama.decode_step(model, cache, tok)
        tok = logits.argmax(-1).to(torch.int32)
        again.append(tok)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    if not torch.equal(torch.stack(again[:steps], 1), toks):
        cs.fail("decode: the warm run gave other tokens than generate")
    print(f"decode 0.77B bf16 8 x 1024 + {steps}: {step_ms:.3f} ms a step "
          f"[{card}]", flush=True)
    del model, cache
    torch.cuda.empty_cache()
    return step_ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--no-serve", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if not torch.cuda.is_available():
        print("p1_quant_times: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, tree)
    from cubecl_tpu_torch.models import llama
    from cubecl_tpu_torch.ops import attention as fa
    from cubecl_tpu_torch.ops import matmul as mm
    from cubecl_tpu_torch.ops import paged_attention as pa
    from cubecl_tpu_torch.runtime import CudaRuntime
    from cubecl_tpu_torch.std import quant_kernels as qk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device=dev).manual_seed(17)
    cu = CudaRuntime.client()
    out = {"tree": tree, "card": card,
           "p1": p1_times(cs, pa, dev, gen, card),
           "quant": quant_times(cs, qk, mm, cu, dev, gen, card)}
    if hasattr(qk, "tensor_plan"):
        out["quant_passes"] = pass1_times(cs, qk, cu, dev, gen, card)
    if not args.no_serve:
        out["decode_ms_a_step"] = serve_decode(cs, llama, pa, dev, card)
        k = cs.serve_slice(llama, pa, fa, dev, card)
        out["serve"] = {
            "chunked_prefill_s": k["chunked_prefill"]["s"],
            "speculative_tok_s": {n: v["tok_s"]
                                  for n, v in k["speculative"].items()},
            "int8_ms_a_step": k["int8"]["ms_step"],
            "continuous_batching_tok_s": k["cb"]["tok_s"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
