#!/usr/bin/env python3
"""How close P1 (paged decode) and P3 (a decode-shaped chunk) come to an
f64 attention, and what phase k's teacher-forced verify reads with the
decode steps' attention from P1, its plain version and the f64 one, on
one CUDA card.

    python3 scripts/p1_accuracy.py [--tree DIR]

Imports ``cubecl_tpu_torch`` from DIR (default: the checkout this script
is in); the phase-k helpers and tolerances are ``chip_smoke.py``'s of
this checkout.

1. At the serving shape (B 8, Hkv 8, G 2, D 128, context 1029, bf16
   pools N(0, 1), pages of 128), three draws of q: the share of bf16
   outputs of P1, of P3 on a chunk of 5 tokens ending at 1029, and of
   their plain f32 versions that are not the f64 attention rounded to
   bf16.
2. Phase k's teacher-forced verify (``chip_smoke.serve_slice``'s: the
   0.77B bf16 llama, 8 x 1024 prompt, 64 greedy steps, ``decode_chunk``
   of 5 on the greedy stream against the decode steps' logits), with the
   decode steps' attention taken from the kernel, from
   ``paged_attention_plain`` and from an f64 attention: each one's max abs
   logit error and its worst excess over ``BF16_PATH_TOL``'s atol + rtol
   |ref| (positive: the check fails).

Prints the card (``nvidia-smi``) and one JSON line; needs a card.
"""

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_accuracy", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def f64_attention(pa, q, k_pages, v_pages, page_indices, lengths, starts=None,
                  sm_scale=None, layer=0, k_scales=None, v_scales=None):
    """Decode (q (B, H, D)) or chunk (q (B, H, C, D), ``starts``)
    attention through the table in f64 (pools of q's dtype), rounded once
    to q's dtype."""
    if k_scales is not None or v_scales is not None:
        raise ValueError("f64_attention takes pools of q's dtype")
    chunk = q.dim() == 4
    B, H, D = q.shape[0], q.shape[1], q.shape[-1]
    C = q.shape[2] if chunk else 1
    Hkv = k_pages.shape[1]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    k = pa._gather(k_pages, None, layer, page_indices).double()
    v = pa._gather(v_pages, None, layer, page_indices).double()
    S = k.shape[2]
    s = torch.matmul(q.reshape(B, Hkv, G * C, D).double(),
                     k.transpose(-1, -2)) * scale
    t = torch.arange(S, device=q.device)
    qpos = (starts.long().view(B, 1) if chunk else lengths.long().view(B, 1)
            - 1) + torch.arange(C, device=q.device)
    live = (t <= qpos[..., None]) & (t < lengths.long().view(B, 1, 1))
    s = s.view(B, Hkv, G, C, S).masked_fill(~live.view(B, 1, 1, C, S),
                                             -math.inf)
    p = torch.softmax(s, -1).nan_to_num(0.0).view(B, Hkv, G * C, S)
    return torch.matmul(p, v).view(q.shape).to(q.dtype)


def rounding_shares(pa, dev, card):
    g = torch.Generator(device=dev).manual_seed(5)
    B, Hkv, G, D, page, max_pages, L, C = 8, 8, 2, 128, 128, 12, 2, 5
    P = B * max_pages + 3
    kp, vp = (torch.randn(L, Hkv, P, page, D, generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    table = torch.randperm(P, generator=g, device=dev)[:B * max_pages]
    table = table.view(B, max_pages).to(torch.int32)
    ln = torch.full((B,), 1029, dtype=torch.int32, device=dev)
    st = ln - C
    out = {k: [] for k in ("P1", "P1 plain", "P3", "P3 plain")}
    for _ in range(3):
        q1 = torch.randn(B, Hkv * G, D, generator=g, device=dev).to(
            torch.bfloat16)
        q3 = torch.randn(B, Hkv * G, C, D, generator=g, device=dev).to(
            torch.bfloat16)
        want1 = f64_attention(pa, q1, kp, vp, table, ln, layer=1)
        want3 = f64_attention(pa, q3, kp, vp, table, ln, st, layer=1)
        for name, got, want in (
                ("P1", pa.paged_attention(q1, kp, vp, table, ln, layer=1),
                 want1),
                ("P1 plain", pa.paged_attention_plain(q1, kp, vp, table, ln,
                                                      layer=1), want1),
                ("P3", pa.paged_attention_chunked(q3, kp, vp, table, ln, st,
                                                  layer=1), want3),
                ("P3 plain", pa.paged_attention_chunked_plain(
                    q3, kp, vp, table, ln, st, layer=1), want3)):
            out[name].append(100 * (got != want).double().mean().item())
    for name, shares in out.items():
        print(f"{name}: bf16 outputs not the f64 attention rounded, per "
              f"draw: {', '.join(f'{x:.3f}%' for x in shares)} [{card}]",
              flush=True)
    return out


def teacher_forced(cs, llama, pa, dev, card):
    cfg = llama.LlamaConfig(vocab=8192, d_model=2048, n_heads=16,
                            n_kv_heads=8, n_layers=16, d_ff=5632, seq=1024,
                            dtype="bfloat16", use_framework_kernels=False)
    model = llama.init_params(cfg, seed=0, device=dev)
    B, S, steps, page, gamma, max_pages = 8, 1024, 64, 128, 4, 12
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    atol, rtol = cs.BF16_PATH_TOL
    kernel = llama.paged_attention
    out = {}
    for name, attend in (
            ("kernel", kernel), ("plain f32", pa.paged_attention_plain),
            ("f64", lambda *a, **k: f64_attention(pa, *a, **k))):
        llama.paged_attention = attend
        try:
            want, want_logits = cs.greedy_ref(llama, model, prompt, steps,
                                              max_pages, page)
        finally:
            llama.paged_attention = kernel
        cache = llama.init_kv_cache(cfg, B, max_pages, page, dev)
        _, cache = llama.prefill(model, cache, prompt)
        worst, excess = 0.0, -math.inf
        for s0 in range(0, steps, gamma + 1):
            logits, cache = llama.decode_chunk(model, cache,
                                               want[:, s0:s0 + gamma + 1])
            n = min(gamma + 1, steps - 1 - s0)
            if n > 0:
                ref = want_logits[:, s0 + 1:s0 + 1 + n]
                err = (logits[:, :n].float() - ref).abs()
                worst = max(worst, err.max().item())
                excess = max(excess, (err - atol - rtol * ref.abs())
                             .max().item())
        out[name] = dict(max_abs_err=worst, excess=excess)
        verdict = "fails" if excess > 0 else "passes"
        print(f"teacher-forced verify, decode steps' attention from "
              f"{name}: max abs err {worst:.4f}, worst excess over atol + "
              f"rtol |ref| {excess:+.4f} ({verdict}) [{card}]", flush=True)
        del cache
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if not torch.cuda.is_available():
        print("p1_accuracy: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, tree)
    from cubecl_tpu_torch.models import llama
    from cubecl_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    out = {"tree": tree, "card": card,
           "rounding_shares_percent": rounding_shares(pa, dev, card),
           "teacher_forced": teacher_forced(cs, llama, pa, dev, card)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
