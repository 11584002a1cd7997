#!/usr/bin/env python3
"""Device times of the chunked paged attention (P3) and of C1's f32 body
on one CUDA card, and the serving path that runs P3, measured alike for
two checkouts.

    python3 scripts/p3_c1_times.py [--tree DIR] [--no-serve] [--no-c1]
                                   [--cases i|zb|f32]

Imports ``cubecl_tpu_torch`` from DIR (default: the checkout this script
is in), so that an older checkout's kernels are timed by the same method
as this one's; the method and the cases are ``chip_smoke.py``'s of this
checkout. For P3: every row of ``CHUNKED_CASES`` (phase i: the verify
step, chunked prefill from 0 and from 768, the d768 f32 case, a ragged
batch with a length-0 row, int8 verify and prefill), or with ``--cases
zb`` the bf16-q rows of ``ZB_P3`` (phase zb1: head dim 96 on bf16 and
int8 pools, the verify step, chunked prefill from 0 and from 768 at
Phi-3-mini's widths, a ragged G 4 batch on pages of 7), or with ``--cases
f32`` the f32-q rows (``F32_CASES``: the verify step and chunked prefill
from 768 at the d768 config's D 64, Phi-2's D 80, MPT-30B's D 112 and
GPT-J-6B's D 256, on f32 pools, and the verify steps again on int8 pools),
its device time with
a cold L2 (``cold_ms``: each call after a read of 1 GiB), its time back to
back with each launch on the next layer of the pool (``cuda_ms``), its
bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, the larger)
and the worst error against plain as a share of ``TOL``; no library call
computes it. For C1 f32: phase y's (32, 56, 56, 64) -> 64 and (1, 6, 10,
32) -> 48 (garbage in the padded input lanes), its cold device time and
its time back to back beside ``F.conv2d`` on channels_last with TF32 off
(cuDNN) timed both ways, its bound (three TF32 products at 495 TFLOP/s)
and the worst error as a share of ``TOL``. Then, unless ``--no-serve``,
phase k (``serve_slice``: the 0.77B bf16 llama's chunked prefill,
speculative decoding and continuous batching, launches checked) on the
tree's modules: its chunked prefill seconds, speculative tok/s and
continuous-batching tok/s (host clock; the steps are host-bound). With
``--no-serve --no-c1`` only DIR's ``paged_chunked.cu`` (and
``flash_attention.cu``, which holds the error strings) is built. Prints
the card (``nvidia-smi``) and one JSON line; needs a card.
"""

import argparse
import glob
import importlib.util
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as TF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C1_F32_CASES = [("f32 32x56x56x64->64", (32, 56, 56, 64, 64)),
                ("f32 1x6x10x32->48", (1, 6, 10, 32, 48))]


def f32_cases(cs):
    """The f32-q P3 rows of chip_smoke.py's phases i, zf1, zh2 and zd1
    (f32 pools), and their verify steps on int8 pools."""
    rows = [c for c in cs.CHUNKED_CASES if c[0] == "d768"]
    for table, names in (
            (cs.ZF_P3[cs.D80], ("phi-2 verify f32",
                                "phi-2 prefill start 768 f32")),
            (cs.ZH_P3[cs.D112], ("mpt-30b verify f32",
                                 "mpt-30b prefill start 768 f32")),
            (cs.ZD_P3, ("gpt-j verify f32", "gpt-j prefill start 768 f32"))):
        rows += [c for c in table if c[0] in names]
    rows += [(c[0].replace(" f32", "") + " int8 pools", *c[1:-1], True)
             for c in list(rows) if "verify" in c[0]]
    return rows


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


def p3_times(cs, pa, dev, gen, card, cases):
    out = {}
    for (name, B, L, Hkv, G, C, D, page, max_pages, starts, lengths, dt,
         quant) in cases:
        lengths = lengths or [s + C for s in starts]
        P = B * max_pages + 5
        q = torch.randn(B, Hkv * G, C, D, generator=gen, device=dev).to(dt)
        kp, vp, ks, vs = cs.kv_pools("int8" if quant else cs._dt(dt),
                                     (L, Hkv, P, page, D), dev, gen)
        table = torch.randperm(P, generator=gen, device=dev)[:B * max_pages]
        table = table.view(B, max_pages).to(torch.int32)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        sc = dict(k_scales=ks, v_scales=vs)
        got = pa.paged_attention_chunked(q, kp, vp, table, ln, st,
                                         layer=L - 1, **sc)
        want = pa.paged_attention_chunked_plain(q, kp, vp, table, ln, st,
                                                layer=L - 1, **sc)
        cs.compare(got, want, f"P3 {name}")
        layers = iter(range(10**9))
        ms = cs.cuda_ms(lambda: pa.paged_attention_chunked(
            q, kp, vp, table, ln, st, layer=next(layers) % L, **sc),
            iters=32)
        cold = cs.cold_ms(lambda: pa.paged_attention_chunked(
            q, kp, vp, table, ln, st, layer=L - 1, **sc))
        n_live, kv_live = cs.chunked_live(starts, lengths, C)
        bms, by = cs.paged_bound(dt, 1 if quant else kp.element_size(), D,
                                 Hkv * G, Hkv, n_live, kv_live, quant, B * C)
        out[name] = dict(cold_ms=cold, ms=ms, bound_ms=bms, bound_by=by,
                         worst_err_over_tol=_margin(cs, got, want))
        print(f"P3 {name}: cold L2 {cold:.4f} ms, back to back {ms:.4f} ms; "
              f"bound {bms:.4f} ms ({by}); worst |err| / tolerance "
              f"{out[name]['worst_err_over_tol']:.3f}; library none "
              f"[{card}]", flush=True)
        del q, kp, vp, ks, vs, got, want
    torch.cuda.empty_cache()
    return out


def c1_times(cs, conv, dev, gen, card):
    out = {}
    for name, (n, h, w, c, k) in C1_F32_CASES:
        x = torch.randn(n, h, w, c, generator=gen, device=dev) * .1
        wgt = torch.randn(3, 3, c, k, generator=gen, device=dev) * .1
        xp = conv.pack_pairs(x)
        xp.view(n, h, w, 64)[..., c:] = 1e4  # must not reach the output
        x64 = xp.view(n, h, w, 64)
        wd = conv._pad_weights(wgt, torch.float32)
        got = conv.conv3x3(x64, wd, c)
        want = conv.conv2d_pairs_plain(x64, wd, c)
        cs.compare(got, want, f"C1 {name}")
        ms = cs.cuda_ms(lambda: conv.conv3x3(x64, wd, c))
        cold = cs.cold_ms(lambda: conv.conv3x3(x64, wd, c))
        xcl = x.permute(0, 3, 1, 2)  # NHWC memory: channels_last
        wcl = wgt.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        lib = cs.cuda_ms(lambda: TF.conv2d(xcl, wcl, padding=1))
        lib_cold = cs.cold_ms(lambda: TF.conv2d(xcl, wcl, padding=1))
        bms, by = cs.bound_ms(2 * n * h * w * 9 * c * k,
                              4 * (n * h * w * (c + 64) + 9 * c * k),
                              torch.float32, products=True)
        out[name] = dict(cold_ms=cold, ms=ms, library_ms=lib,
                         library_cold_ms=lib_cold, bound_ms=bms, bound_by=by,
                         worst_err_over_tol=_margin(cs, got, want))
        print(f"C1 {name}: cold L2 {cold:.4f} ms, back to back {ms:.4f} ms; "
              f"F.conv2d (cuDNN, TF32 off) cold {lib_cold:.4f} ms, back to "
              f"back {lib:.4f} ms; bound {bms:.4f} ms ({by}); worst |err| / "
              f"tolerance {out[name]['worst_err_over_tol']:.3f} [{card}]",
              flush=True)
        del x, wgt, xp, x64, got, want, xcl
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--no-serve", action="store_true")
    ap.add_argument("--no-c1", action="store_true")
    ap.add_argument("--cases", choices=("i", "zb", "f32"), default="i")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if not torch.cuda.is_available():
        print("p3_c1_times: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, tree)
    from cubecl_tpu_torch.models import llama
    from cubecl_tpu_torch.ops import attention as fa
    from cubecl_tpu_torch.ops import conv
    from cubecl_tpu_torch.ops import paged_attention as pa
    from cubecl_tpu_torch.utils import native

    if args.no_serve and args.no_c1:
        csrc = native.CSRC_DIR
        native._sources = lambda: (
            [os.path.join(csrc, f) for f in ("flash_attention.cu",
                                             "paged_chunked.cu")],
            sorted(glob.glob(os.path.join(csrc, "*.cuh"))))
        native._SIGNATURES = {k: v for k, v in native._SIGNATURES.items()
                              if "chunked" in k}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = {"i": lambda: cs.CHUNKED_CASES,
             "zb": lambda: [c for c in cs.ZB_P3 if c[-2] == torch.bfloat16],
             "f32": lambda: f32_cases(cs)}[args.cases]()
    out = {"tree": tree, "card": card,
           "p3": p3_times(cs, pa, dev, gen, card, cases)}
    if not args.no_c1:
        out["c1_f32"] = c1_times(cs, conv, dev, gen, card)
    if not args.no_serve:
        k = cs.serve_slice(llama, pa, fa, dev, card)
        out["serve"] = {
            "chunked_prefill_s": k["chunked_prefill"]["s"],
            "one_shot_prefill_s": k["chunked_prefill"]["one_shot_s"],
            "speculative_tok_s": {n: v["tok_s"]
                                  for n, v in k["speculative"].items()},
            "continuous_batching_tok_s": k["cb"]["tok_s"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
