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

Phases (lines before the last): 1 device, 2 build (failing unless every
bf16 instance of the flash forward, dK/dV and dQ kernels, dense,
block-sparse and masked at D 64, 128 and 256, C1's bf16 body, every 8-bit GEMM
instance and the K0 bf16/f16 cmma kernels issue wgmma: HGMMA in
``cuobjdump -sass``, IGMMA for the int8 GEMM; their registers and
spills; P1's plain, window, ring, grouped and ragged kernels spilling
nothing),
3 flash
vs plain (with
TFLOP/s; bf16 D 128 at the llama's prefill and training lengths, f32 D 64,
bf16 D 64 at GPT-2's widths), 4 paged decode (P1: positions split over
blocks, a cp.async ring per warp) vs plain, back to back and with a cold
L2, 5 serve at full width, 6 serve exactness; then K0:
a the DSL kernels at BASELINE sizes, and RMSNorm at every shape phases b
and c give it, against the torch evaluator on the card and a plain
formula, b serve at full width with RMSNorm through K0
(``use_framework_kernels=True``), c serve exactness with it (which fails
if b or c launched a K0 kernel that phase a did not check). Then
training: d the flash backward kernels (dK/dV, dQ; bf16 on the tensor
cores) and the forward's lse against the plain backward that rounds p
and dS to bf16 as the kernels do and the exact one (``EXACT_BWD_TOL``),
two calls bit-identical, their TFLOP/s, at the llama's widths, GPT-2's
(head_dim 64) and with 8 query heads a kv head, and bf16 over the card
tests' grid of lengths, kv groups and head dims, e the K0
backward kernels (and the forwards
at the train shapes) against the torch evaluator and plain formulas, and
the Functions' dg/db against plain autograd, f train llama 0.77B bf16 at
B 8 x S 1024 (ms/step, peak memory, launches per step, a profiled step,
one step with remat), g train exactness, a d768 f32 step with the kernels
against one with the plain versions, h train the transformer at GPT-2
small's widths (phases f-h fail on a K0 kernel id that a and e did not
hold). Then the serving slice of chunks, int8 KV and pages: i the chunked
paged-attention kernel (P3: bf16 q on wgmma with its positions split where
the chunk is decode-shaped, f32 on the CUDA cores; its launch plans held to
the kernel's) against plain at the verify, chunked-prefill, d768, ragged
and int8 shapes, j paged decode on int8 pools against plain
and the KV-bound decode (B 16, context 2048) on bf16 against int8 pools,
k the 0.77B bf16 llama through ``prefill_chunked``, ``decode_chunk``,
``speculative_generate`` (a self-draft and a d768 draft), an int8 cache
and continuous batching with prefix caching on the ``PageAllocator``,
each with its kernel launches checked, l the same paths on the d768 f32
llama against the plain versions (and each batched request against its
solo run). Then the autotuned matmul (BASELINE config 4): m the matmul
kernel (M1; M1 with device scales; M2 with host scales, B as (N, K) and
as the JAX reference's (K, N)) against plain at 4096^3 and the llama FFN
projection 8192 x 2048 x 5632, for bf16, f16, f32, fp8 e4m3/e5m2 and
int8 (exact) operands and both B layouts, every tile instance checked,
each case's body named (16-bit: ``csrc/matmul.cu`` on wgmma; 8-bit:
``csrc/matmul8.cu`` on wgmma; f32 on the CUDA cores) and the mma.sync
times before it beside, n ``matmul_autotuned`` at bf16 and e4m3 4096^3 and the
llama shape, each tuned through captured CUDA graphs timed by CUDA events
into a fresh sqlite store (``CUBECL_ENVIRONMENT_ROOT`` in a temp dir),
the store read back by a second call and by a new tuner, one tune with
checks, the headline TFLOP/s, ``matmul_scaled`` and ``matmul_quantized``,
o ``matmul_cmma`` through K0 with cmma printed (f32 512^3 on FMA, bf16
512^3 and 4096^3 and f16 4096^3 on the tensor-core route, each 16-bit
case in 25 launches) against plain and the evaluator, and the K0 quant kernels
(one per-tensor scale: two passes over many cubes; block scales: a cube
a block; the dequantize at both levels: many cubes) against plain and
the evaluator, bit for bit, their launches and cold-L2 times. Then
reductions and comptime fusion (BASELINE
configs 2 and 5): p at 64M f32 ``reduce_sum_autotuned`` (R1, the
``block_sum`` route and the K0 tree, tuned into the temp store, then a
second call untimed), ``reduce_sum``, ``reduce_max``, ``reduce_mean`` and
``reduce_sum_blockwise``, each against the float64 sum or torch's max and
the K0 routes against the evaluator, ``reduce_block_partial`` at the
blockwise plan (32 windows split over cubes of 256 units); R1 (``csrc/reduce.cu``) at 64M f32
and bf16 and 128 x 1000 against plain, beside its bound and ``torch.sum``;
block max/min exact; ``sum_things``' four variants and the book's
reduction progression; q ``launch_fused`` for relu((a+b)*c) and
add -> gelu on 16M f32 (one K0 launch each) against the evaluator and
plain, ``into_contiguous`` of a strided 3-D view and ``identity(4096)``;
r ``ThroughputCache``'s four runners measured into the temp store and read
back. Then sparse MoE and Mamba serving: s the expert GEMM (E1,
``csrc/expert_matmul.cu``) against plain on the live rows at the 0.77B MoE
prefill shape with a router's counts, bench.py's skewed counts, a decode
step's 16 live rows in the gate/up and the down projection, f32 at d768
and counts of 0 and cap over a ragged capacity, beside ``torch.bmm`` over
all rows, with a call's host time back to back and the mma.sync times
before its wgmma body; t the 0.77B llama with 8
experts, top-2 and capacity 2560 through ``generate`` (8 x 1024 + 64 steps,
3120 E1 launches checked), its prefill logits against the dense route's;
u the selective scan (S1, ``csrc/selective_scan.cu``) against plain at
Mamba-130M's (8, 2048, 24576), bench.py's (8, 2048, 16384), B 1 x L 1 and
a DN no multiple of 32; v Mamba at Mamba-130M's widths (24 layers, f32):
``forward`` at B 8 x L 2048 (24 S1 launches checked) and 32 teacher-forced
``decode_step``s against it; w f32 exactness: the d768 llama with 4
experts, sparse on E1 against its plain version and the dense route
through ``prefill``, ``decode_step`` and ``decode_chunk``, and Mamba at 4
layers, S1 against plain and the doubling scan. Then the last four TPU
kernels: x block-sparse flash attention (A5, A6, A7 on the block-sparse
schedules of ``csrc/flash_tiles.cuh``) at the 0.77B llama's attention widths,
B 1 x H 16 x S 8192 x D 128 bf16, block 512, the band i-1..i plus global
tile 0, causal: forward and backward through autograd (one launch each,
counted from 0), each kernel against plain on its own o and lse, its time,
bound and SDPA's with the element mask; at S 1024 f32 D64 non-causal, a
random mask with a kv tile nobody attends (dk = dv = 0) and bq 128 x bk 64
(F9's rows); A1, A3 and A4 re-timed beside their earlier times; y the
small-channel 3x3 conv (C1, ``csrc/conv3x3.cu``: bf16 on wgmma, f32 on
wgmma as three TF32 products; its launch plans held to the kernel's) against
plain at
ResNet-50's conv2_x (32, 56, 56, 64) -> 64 in bf16 and f32 and at (1, 6,
10, 32) -> 48 with garbage in the padded lanes, beside ``F.conv2d``, each
also timed as device time with a cold L2; the
three-layer packed stack of the ``examples/conv_pairs`` twin (3 C1
launches, counted from 0) against F.conv2d + ReLU; ``conv2d_autotuned`` at
(32, 56, 56, 64) -> 64 (native against pairs) and (16, 28, 28, 256) -> 256
(native against im2col on M1), each candidate's time and the winner.
Then StreamingLLM serving: z1 the 0.77B bf16 llama with sinks 4 and
window 2000 (streaming-llm's defaults) through ``generate``, B 8 x a
4096-token prompt (full-attention prefill) and 64 windowed decode steps
(P1's window kernel, 1024 launches checked), tokens against the plain
path's under the BF16_GAP rule, one windowed P1 call against plain on bf16
and int8 pools, timed back to back and with a cold L2 beside the same call
with window 0; z2 the same model on a ring of 17 pages of 16 (sinks 16,
window 240), 320 steps from an empty cache (5120 ring launches), its
logits against the same tokens through an unbounded windowed cache, one
ring call against plain; z3 the d768 f32 llama windowed and on a ring,
kernels against the plain versions and the ring against the unbounded
cache within LOGIT_TOL. Then flash attention's options (A1/A3/A4 on the
masked schedule of ``csrc/flash_tiles.cuh``, A8's window): za1
Mistral-7B's sliding window (32/8 heads, D 128, window 4096) at B 1 x S
8192 bf16 through ``flash_attention_local``, za2 packed documents (lengths
256-2048 from the seed, 128 padding positions) at the 0.77B llama's
attention widths, B 4 x S 8192 bf16, through
``flash_attention_segmented``, za3 ``flash_attention_packed`` at D 32
with a window (B 8 x H 16 x S 2048), ``flash_attention(kv_len=...)`` and
every option through the f32 bodies: each forward and backward through
autograd (one launch of each masked kernel, counted from 0), each kernel
against plain (on a subset of heads where the plain scores of all would
not fit), the bf16 cases timed beside the dense causal kernels, their
bounds over the live pairs and SDPA with the element mask; the
``examples/attention`` twin; za4 the llama at Phi-3-mini's widths (head
dim 96 through ``flash_attention_padded``, 32 layers, bf16) trained at B
4 x S 1024 and one step at S 1000, A1/A3/A4 launches checked, then f32
exactness at full width with 2 layers (loss, grads, weights, prefill
logits) against the plain route. Then serving at head dim 96 (phase zb):
zb1 P1's D 96 instances (every position, window + sinks, the ring) on
bf16, int8 and f32 pools and P3's (the verify step, chunked prefill from
0 and 768) against plain at Phi-3-mini's attention widths (B 8 x 32 kv
heads), G 4 and 8, pages of 16, 7 and 1, ragged rows and a length-0 row,
each plan held to the built kernel's, every case timed (cold L2) beside
the D 128 instance at the same B, Hkv and context, by phase j's and
phase i's harnesses; zb2 the llama at Phi-3-mini's widths (32 layers,
bf16) served through ``generate`` (8 x 1024 + 32 steps),
``prefill_chunked``, a verify ``decode_chunk``, ``speculative_generate``
(a self-draft and a d768 draft of head dim 96), ``beam_generate``, an
int8 cache, windowed and ring decode, each path's P1 and P3 launches
counted from 0; zb3 its f32 exactness at 2 layers (decode steps, a
verify chunk, chunked prefill, windowed and ring steps, beam search)
against the plain route within LOGIT_TOL, greedy tokens and beams equal.
Then P1 past 8 query heads a kv head (phase zc): zc1 P1's row groups
(every position, window + sinks, the ring) on bf16, int8 and f32 pools
against plain at Mistral-Large-2's decode (B 8 x 8 kv heads x G 12, D
128), G 16, Falcon-7B's multi-query G 71 (D 64), G 9 at D 96 on pages of
7 and G 12 on pages of 1, each plan held to the built kernel's, every case
timed (cold L2) beside the same call at G 2 (the same K/V bytes), and P3
at G 12 (the verify step, chunked prefill from 0 and 768), 16 and 71;
zc2 the llama at Mistral-Large-2's widths (8 of its 88 layers, bf16,
11.5B parameters) served through ``generate`` (8 x 1024 + 32 steps),
``prefill_chunked``, a verify ``decode_chunk``, ``speculative_generate``
with a self-draft and an int8 cache, each path's P1 (every launch
grouped) and P3 launches counted from 0; zc3 its f32 exactness at 2
layers (decode steps, a verify chunk, chunked prefill) against the plain
route within LOGIT_TOL, greedy tokens equal. Then head dim 256 (phase
zd): zd1 A1's forward (bf16 and f32, GPT-J-6B's and Qwen3-Next's
prefill, a ragged S 1021, padded from D 192 and 160, kv_len and a
window; SDPA timed beside bf16), P1 in every mode on bf16, int8 and f32
pools (G 1, 8 and 12, ragged rows on pages of 7, pages of 1) and P3 (the
verify step, chunked prefill from 0 and 768) against plain, each timed
(cold L2) beside the same call at D 128; zd2 the llama at GPT-J-6B's
widths (28 layers, bf16) served through zb2's paths but the d768 draft;
zd3 its f32 exactness at 2 layers. Then training at head dim 256 (phase
ze): ze1 A3 and A4 at D 256 (bf16 and f32, GPT-J-6B's and Qwen3-Next's
training shapes, a ragged S 1021, cross lengths, non-causal, padded from
D 192 and 160, kv_len, a window and packed documents) through autograd
and alone against both plain backwards, each timed (cold L2) beside the
same call at D 128, SDPA's backward and the bound; ze2 the llama at
GPT-J-6B's widths trained at full depth (28 layers, bf16, B 4 x S 1024,
then a ragged S 1000), A1, A3, A4 and K0's RMSNorm counted from 0; ze3
its f32 exactness at 2 layers. Then head dims 80 and 32 (phase zf): zf1
P1 in every mode on bf16, int8 and f32 pools (Phi-2's decode, B 8 x 32
kv heads of 80; H2O-Danube's G 4 at context 4096; D 32 at B 8 x 16
heads; G 12 on one kv head, G 4 ragged on pages of 7, pages of 1) and
P3 (the verify step, chunked prefill from 0 and 768, a G 4 verify step,
a ragged batch on pages of 7) at both head dims against plain, each
timed (cold L2) beside the same call at D 96 (for 80) or D 64 (for 32);
zf2 the llama at Phi-2's widths (32 layers, bf16) and zf3 at
Pythia-31M's (6 layers) served through zd2's paths; zf4 the f32
exactness of both at 2 layers. Then Mamba trained and A5-A7 padded (phase
zg): zg1 S1's backward (the reverse scan) against its plain version at
phase u's shapes in f32 and bf16, timed with a cold L2; zg2 Mamba at
Mamba-130M's widths (24 layers, f32) trained by ``make_train_step`` at B
2 x L 2048 (loss falling each step, S1 and its backward once a layer a
step counted from 0, one step profiled); zg3 its f32 exactness at 4
layers against S1's plain halves and the doubling scan; zg4 A5-A7 at
Phi-2's 32 heads of 80 (B 1 x S 8192, bf16, band mask at block 512)
padded to D 128, beside the bounds at D 80 and 128 and SDPA, then S 1024
cases at D 32, 80 and 96. Then every head dim up to 256 (phase zh): zh1
A5-A7 at D 256 at GPT-J-6B's 16 heads (B 1 x S 8192, bf16, the band mask
at block 512) against plain, timed with a cold L2 beside D 128, the
bounds and SDPA, then S 1024 cases at D 256, 160 and 192 (F9's rows
among them); zh2 P1 in every mode on every pool and P3 at head dims
without an instance of their own (MPT-30B's 112, and 48, 100, 160, 192,
200) against plain, timed beside their ragged width's instance; zh3 the
llama at MPT-30B's widths (8 of 48 layers, 64 heads of 112) served
through zd2's paths, every P1 and P3 launch a ragged instance's; zh4 its
f32 exactness at 2 layers. In zb2, zc2, zd2, zf2, zf3 and zh3 speculative
decoding's tokens and the self-draft's rejections are held to twice the
verify step's measured logit difference from the decode steps (the
derivation is ``serve_at_widths``'). Each kernel's
line gives its time beside its bound (bytes over 3.35 TB/s or operations
over the dtype's peak) and,
where one PyTorch call computes the same function, that call's time. A K0
kernel's time in phases a, e and q is its device time with a cold L2
(``cold_ms``), printed beside a call's time back to back (host included),
with the printer's mapping: "warp-lines" (a unit on a warp, 16-byte
chunks a lane where the buffers are aligned) or "thread"; phase 2 lists
the built K0 kernels by mapping, and phases f and h profile a step (K0's
share of device time). Then a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero before the last line; without a CUDA device
(or without the package beside it) the script exits non-zero and prints no
result. Imports only torch, numpy and cubecl_tpu_torch.
"""

import atexit
import copy
import dataclasses
import glob
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
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2),
       # one f16 rounding (2^-11 relative) of sums of order 1
       torch.float16: (1e-3, 1e-3)}
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
# TF32 on the tensor cores (the same data sheet). An f32 matrix product
# holds f32's tolerance as three TF32 products (3xTF32, as csrc/
# wgmma_gemm.cuh and K0's cmma run it), so its operations are bounded by
# the lesser of the CUDA cores' time and three times the TF32 time
PEAK_TF32_FLOPS = 495e12
TF32_PRODUCTS = 3
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


def cold_ms(fn, iters=20):
    """Median device time of one call of ``fn`` with a cold L2: each call
    follows a read of 1 GiB, which evicts the 50 MB L2 and hides the
    call's host time (the call is enqueued while the read runs), between
    CUDA events around the call alone. The buffer is freed on return."""
    flush = torch.empty(256 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


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


# The flash backward kernels round p and dS to the inputs' dtype for their
# products, as the JAX kernels do, and are held at TOL to the plain backward
# that rounds so. Against the exact plain backward the rounding alone can
# pass TOL in bf16 (dv under GQA: a kv head sums several heads' rounded p),
# so there they are held to this fixed bound, set above the largest atol
# that phase d's sweep reads (PERF.md); in f32 the rounding is the identity.
EXACT_BWD_TOL = {torch.float32: TOL[torch.float32],
                 torch.bfloat16: (2e-2, 1e-2)}


def atol_needed(got, ref, rtol):
    """The least atol with |got - ref| <= atol + rtol * |ref| everywhere."""
    g, r = got.float(), ref.float()
    return max(((g - r).abs() - rtol * r.abs()).max().item(), 0.0)


def plain_bwd(fa, q, k, v, o, lse, do, *args, **kw):
    """``fa.flash_attention_backward_plain`` as the kernels' reference:
    f32 inputs go in as float64 copies (an exact reference where a kv
    head's gradient sums many terms: in f32 its own rounding was 3.27e-5
    off a dV element at Qwen3-Next's G 8 x S 4096, past f32's tolerance)
    and the grads come back in f32; other dtypes as they are."""
    if q.dtype != torch.float32:
        return fa.flash_attention_backward_plain(q, k, v, o, lse, do, *args,
                                                 **kw)
    grads = fa.flash_attention_backward_plain(
        *(t.double() for t in (q, k, v, o, lse, do)), *args, **kw)
    return tuple(g.float() for g in grads)


def compare_bwd(got, rounded, exact, what):
    """A gradient of the flash backward kernels: within TOL of the plain
    backward that rounds p and dS as the kernels do (``rounded``), and
    within EXACT_BWD_TOL of the exact one. Returns the max abs errors
    against ``rounded`` and ``exact``, and the atol (at EXACT_BWD_TOL's
    rtol) that the kernel and the rounding plain version each need against
    the exact one."""
    err_r = compare(got, rounded, f"{what} against the rounding plain")
    tol = EXACT_BWD_TOL[exact.dtype]
    err = compare(got, exact, f"{what} against the exact plain", tol)
    return err_r, err, (atol_needed(got, exact, tol[1]),
                        atol_needed(rounded, exact, tol[1]))


def a4_f32_rows(bwd_rows, ze):
    """The kernels line's f32 dQ (flash_bwd_dq_tf32x3_kernel) at the d768
    train shape (phase d) and GPT-J-6B's (phase ze1): the cold-L2 time, its
    bound (three TF32 products where they bound) and SDPA's f32 backward
    (dq, dk and dv together, TF32 off)."""
    d = bwd_rows["d768"]
    g = ze["a34"]["dq"]["gpt-j train f32"]
    return {
        "d768 B2 H12/4 S384 D64 causal (phase d)": dict(
            ms=d["dq_cold_ms"], bound_ms=d["dq_bound"][0],
            bound_by=d["dq_bound"][1], library_ms=d["library_ms"],
            max_abs_err=d["dq_err"]),
        "gpt-j train B8 H16/16 S1024 D256 causal (phase ze1)": dict(
            ms=g["ms"], bound_ms=g["bound_ms"], bound_by=g["bound_by"],
            library_ms=g["library_ms"], max_abs_err=g["max_abs_err"]),
        "ms_is": "device time with a cold L2",
        "library": "the autograd backward of F.scaled_dot_product_attention "
                   "in f32 with TF32 off (dq, dk and dv together)"}


def p3_f32_rows(i_rows, zd, zf, zh):
    """The kernels line's f32 P3 (paged_chunked_tf32x3_kernel) at the
    d768 verify step (phase i), Phi-2's, MPT-30B's and GPT-J-6B's verify
    and prefill shapes (phases zf1, zh2, zd1): cold-L2 time, bound,
    splits."""
    cases = {"d768 verify D64 (phase i)": i_rows["d768"]}
    for label, table, name in (
            ("phi-2 D80 (phase zf1)", zf["p3 d80"], "phi-2 verify f32"),
            ("phi-2 D80 prefill from 768 (phase zf1)", zf["p3 d80"],
             "phi-2 prefill start 768 f32"),
            ("mpt-30b D112 (phase zh2)", zh["p3 d112"], "mpt-30b verify f32"),
            ("mpt-30b D112 prefill from 768 (phase zh2)", zh["p3 d112"],
             "mpt-30b prefill start 768 f32"),
            ("gpt-j D256 (phase zd1)", zd["p3"], "gpt-j verify f32"),
            ("gpt-j D256 prefill from 768 (phase zd1)", zd["p3"],
             "gpt-j prefill start 768 f32")):
        cases[label] = table[name]
    return {k: {f: v[f] for f in ("max_abs_err", "ms", "cold_ms",
                                  "bound_ms", "bound_by", "splits")}
            for k, v in cases.items()}


def kernel_name(mangled):
    """A compiled csrc kernel's readable name: kernel<dtype, D, ...>."""
    k = re.search(r"\d+([A-Za-z_]+_kernel)I(13__nv_bfloat16|f)"
                  r"(S\d*_|[af])?Li(\d+)E", mangled)
    g = re.search(r"(gemm8_wgmma_kernel)INS\d*_\d+(E4M3|E5M2|S8)ELi(\d+)"
                  r"ELi(\d+)E", mangled)
    g16 = re.search(r"(gemm16_wgmma_kernel)INS\d*_\d+(BF16|F16)ELi(\d+)"
                    r"ELi(\d+)ELb([01])E", mangled)
    g32 = re.search(r"(gemm_tf32x3_kernel)ILi(\d+)ELi(\d+)E", mangled)
    p3 = re.search(r"(paged_chunked_wgmma(?:_ragged)?_kernel)ILi(\d+)"
                   r"ELb([01])E", mangled)
    p1g = re.search(r"(paged_grouped_kernel)ILi(\d)E(13__nv_bfloat16|f)"
                    r"(S\d*_|[af])?Li(\d+)E", mangled)
    p1r = re.search(r"(paged_ragged_kernel)ILi(\d)ELb([01])E"
                    r"(13__nv_bfloat16|f)(S\d*_|[af])?Li(\d+)E", mangled)
    fx = re.search(r"(flash_(?:fwd|bwd_dkv)_tf32x3_kernel)IfLi(\d+)E",
                   mangled)
    fq = re.search(r"(flash_bwd_dq_tf32x3_kernel)ILi(\d+)ELi(\d)E", mangled)
    p3f = re.search(r"(paged_chunked_tf32x3(?:_ragged)?_kernel)ILi(\d+)"
                    r"ELb([01])E", mangled)
    if fq:
        return (f"{fq.group(1)}<f32, {fq.group(2)}, {fq.group(3)} q tile"
                f"{'s' if fq.group(3) != '1' else ''}"
                f"{', block-sparse' if 'Sparse' in mangled else ''}"
                f"{', masked' if 'Masked' in mangled else ''}>")
    if p3f:
        int8 = ", int8 KV" if p3f.group(3) == "1" else ""
        width = "width " if "ragged" in p3f.group(1) else ""
        return f"{p3f.group(1)}<f32{int8}, {width}{p3f.group(2)}>"
    if fx:
        return (f"{fx.group(1)}<f32, {fx.group(2)}"
                f"{', block-sparse' if 'Sparse' in mangled else ''}"
                f"{', masked' if 'Masked' in mangled else ''}>")
    if "conv3x3_wgmma_kernel" in mangled:
        return "conv3x3_wgmma_kernel<bf16>"
    for name in ("conv3x3_tf32x3_kernel", "conv3x3_split_weights_kernel"):
        if name in mangled:
            return f"{name}<f32>"
    if p3:
        int8 = ", int8 KV" if p3.group(3) == "1" else ""
        width = "width " if "ragged" in p3.group(1) else ""
        return f"{p3.group(1)}<bf16{int8}, {width}{p3.group(2)}>"
    if p1g:
        mode = ("full", "window", "ring")[int(p1g.group(2))]
        return (f"{p1g.group(1)}<{mode}, "
                f"{'f32' if p1g.group(3) == 'f' else 'bf16'}"
                f"{', int8 KV' if p1g.group(4) == 'a' else ''}, "
                f"{p1g.group(5)}>")
    if p1r:
        mode = ("full", "window", "ring")[int(p1r.group(2))]
        return (f"{p1r.group(1)}<{mode}, "
                f"{'grouped, ' if p1r.group(3) == '1' else ''}"
                f"{'f32' if p1r.group(4) == 'f' else 'bf16'}"
                f"{', int8 KV' if p1r.group(5) == 'a' else ''}, "
                f"width {p1r.group(6)}>")
    if "expert_wgmma_kernel" in mangled:
        return "expert_wgmma_kernel<bf16>"
    if g16:
        return (f"{g16.group(1)}<{g16.group(2).lower()}, {g16.group(3)}, "
                f"{g16.group(4)}, B {'(K, N)' if g16.group(5) == '1' else '(N, K)'}>")
    if g32:
        return f"{g32.group(1)}<{g32.group(2)}, {g32.group(3)}>"
    if g:
        return (f"{g.group(1)}<{g.group(2).lower()}, {g.group(3)}, "
                f"{g.group(4)}>")
    for name in ("byte_transpose_kernel", "f32_transpose_kernel"):
        if name in mangled:
            return name
    if k:
        return (f"{k.group(1)}<{'f32' if k.group(2) == 'f' else 'bf16'}"
                f"{', int8 KV' if k.group(3) == 'a' else ''}, {k.group(4)}"
                f"{', block-sparse' if 'Sparse' in mangled else ''}"
                f"{', masked' if 'Masked' in mangled else ''}>")
    return mangled


def ptxas_summary(log):
    """(kernel<dtype, D>, registers, spill line) per compiled entry."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def sass_of(nvcc, so):
    """The built library's SASS (cuobjdump -sass)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def flash_sass(sass, summary):
    """Phase 2: the flash instances (forward, dK/dV, dQ) in the built
    library's SASS: (name, HGMMA count, registers, spill line) each. Fails
    unless every instance of each of the three kernels, bf16 and f32 (the
    3xTF32 bodies), issues wgmma (HGMMA), each covering D 64, 128 and 256
    on the dense, the block-sparse and the masked (the options') schedule
    (f32 dQ with two q tiles a block at D 128 and one at D 64 and 256),
    the D 256 ones and every f32 dQ spilling nothing (where a fresh
    build's ptxas log reports them)."""
    regs = {n: (r, sp) for n, r, sp in summary}
    kinds = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    tensor_core = [(k, dt) for k in kinds for dt in ("bf16", "f32")]
    rows, covered = [], {kd: set() for kd in tensor_core}
    dq_tiles = set()
    for chunk in sass.split("Function : ")[1:]:
        mangled = chunk.split("\n", 1)[0].strip()
        kind = next((k for k in kinds if k in mangled), None)
        if kind is None:
            continue
        name = kernel_name(mangled)
        n = chunk.count("HGMMA")
        r, sp = regs.get(name, (None, "not in the ptxas log"))
        rows.append((name, n, r, sp))
        if (", 256" in name or "dq_tf32x3" in name) and r is not None \
                and not sp.startswith("0 bytes stack frame, 0 bytes spill "
                                      "stores"):
            fail(f"phase 2: {name} spills or keeps a stack frame: {sp}")
        dt = "bf16" if "<bf16" in name else "f32" if "tf32x3" in name \
            else None
        if dt is not None:
            if n == 0:
                fail(f"phase 2: {name} issues no HGMMA (wgmma)")
            sched = ("block-sparse" if "block-sparse" in name
                     else "masked" if "masked" in name else "dense")
            d = re.search(r", (\d+)", name).group(1)
            covered[(kind, dt)].add((d, sched))
            if "dq_tf32x3" in name:
                dq_tiles.add((d, sched, re.search(r"(\d) q tile",
                                                  name).group(1)))
    want = {(d, sp) for d in ("64", "128", "256")
            for sp in ("dense", "block-sparse", "masked")}
    for (kind, dt), got in covered.items():
        if got != want:
            fail(f"phase 2: {dt} {kind} instances with HGMMA cover "
                 f"{sorted(got)}, want {sorted(want)}")
    want_dq = {(d, sp, "2" if d == "128" else "1") for d, sp in want}
    if dq_tiles != want_dq:
        fail(f"phase 2: f32 dQ instances {sorted(dq_tiles)}, want "
             f"{sorted(want_dq)}")
    return rows


# the 8-bit GEMM's instances (csrc/matmul8.cu's CUBECL_WG_TILES by operand
# type) and the wgmma SASS each must issue: HGMMA for fp8 (run as f16 on
# the 16-bit wgmma), IGMMA (the SASS of wgmma .s8) for int8
GEMM8_SASS = {"e4m3": "HGMMA", "e5m2": "HGMMA", "s8": "IGMMA"}
# the 16-bit GEMM's instances (csrc/matmul.cu's CUBECL_WG16_TILES by
# operand type and B layout), each HGMMA
GEMM16_TYPES = ("bf16", "f16")
B_LAYOUTS = ("(K, N)", "(N, K)")


def wgmma_body_sass(sass, summary, tiles8, tiles16, tiles32):
    """Phase 2: C1's bf16 and f32 (3xTF32) bodies, E1's bf16 body, P3's
    bf16 and f32 (3xTF32) bodies (D 32, 64, 80, 96, 128 and 256, pools of
    q's dtype and int8; the ragged instances at the widths 64, 128 and
    256) and
    every 8-, 16-bit and f32 GEMM instance in the SASS: (name, wgmma
    count, registers, spill line) each. Fails unless each issues HGMMA
    (each 8-bit GEMM instance its GEMM8_SASS instruction), C1 f32 and P3
    spill nothing (where a fresh build's ptxas log reports them), and the
    instances are exactly ``tiles8`` (ops/matmul.py's ``kernel_tiles(1)``)
    for each of the three 8-bit types, ``tiles16`` (``kernel_tiles(2)``)
    for bf16 and f16 in both B layouts and ``tiles32``
    (``kernel_tiles(4)``) for f32."""
    regs = {n: (r, sp) for n, r, sp in summary}
    rows, got = [], set()
    for chunk in sass.split("Function : ")[1:]:
        mangled = chunk.split("\n", 1)[0].strip()
        if not any(k in mangled for k in (
                "conv3x3_wgmma_kernel", "gemm8_wgmma_kernel",
                "gemm16_wgmma_kernel", "expert_wgmma_kernel",
                "gemm_tf32x3_kernel", "conv3x3_tf32x3_kernel",
                "paged_chunked_wgmma_kernel",
                "paged_chunked_wgmma_ragged_kernel",
                "paged_chunked_tf32x3_kernel",
                "paged_chunked_tf32x3_ragged_kernel")):
            continue
        name = kernel_name(mangled)
        m8 = re.search(r"gemm8_wgmma_kernel<(\w+), (\d+), (\d+)>", name)
        m16 = re.search(r"gemm16_wgmma_kernel<(\w+), (\d+), (\d+), "
                        r"B (.+)>", name)
        m32 = re.search(r"gemm_tf32x3_kernel<(\d+), (\d+)>", name)
        mp3 = re.search(r"paged_chunked_(wgmma|tf32x3)_(ragged_)?kernel<"
                        r"(?:bf16|f32)(, int8 KV)?, (?:width )?(\d+)>", name)
        want = GEMM8_SASS[m8.group(1)] if m8 else "HGMMA"
        n = chunk.count(want)
        r, sp = regs.get(name, (None, "not in the ptxas log"))
        rows.append((name, f"{n} {want}", r, sp))
        if n == 0:
            fail(f"phase 2: {name} issues no {want} (wgmma)")
        # (a library reused from an earlier build has no ptxas log)
        if (mp3 or "conv3x3_tf32x3" in name) and r is not None \
                and not sp.startswith("0 bytes stack frame, 0 bytes spill "
                                      "stores"):
            fail(f"phase 2: {name} spills or keeps a stack frame: {sp}")
        if mp3:
            got.add((f"p3{' f32' if mp3.group(1) == 'tf32x3' else ''}"
                     f"{' ragged' if mp3.group(2) else ''}",
                     int(mp3.group(4)), bool(mp3.group(3))))
        elif "conv3x3_tf32x3" in name:
            got.add("conv3x3 f32")
        elif m8:
            got.add((m8.group(1), int(m8.group(2)), int(m8.group(3))))
        elif m16:
            got.add((m16.group(1), int(m16.group(2)), int(m16.group(3)),
                     m16.group(4)))
        elif m32:
            got.add(("f32", int(m32.group(1)), int(m32.group(2))))
        else:
            got.add(name.split("_wgmma")[0])
    want = {(t, bm, bn) for t in GEMM8_SASS for bm, bn, _ in tiles8} | {
        (t, bm, bn, lay) for t in GEMM16_TYPES for bm, bn, _ in tiles16
        for lay in B_LAYOUTS} | {("f32", bm, bn) for bm, bn, _ in tiles32} \
        | {"conv3x3", "conv3x3 f32", "expert"} \
        | {(p3, d, q) for p3 in ("p3", "p3 f32")
           for d in (32, 64, 80, 96, 128, 256) for q in (False, True)} \
        | {(p3, d, q) for p3 in ("p3 ragged", "p3 f32 ragged")
           for d in (64, 128, 256) for q in (False, True)}
    if got != want:
        fail(f"phase 2: wgmma instances {sorted(map(str, got))}, want "
             f"{sorted(map(str, want))}")
    return rows


def attn_flops(B, H, Sq, Sk, D, causal):
    """Operations of a flash forward: two products of 2 D a live pair."""
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    return 4 * D * B * H * pairs


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
# phase d: (name, B, H, Hkv, S, D, dtype, causal); "gpt2" is phase h's
# attention (head_dim 64)
FLASH_BWD_CASES = [("train", 8, 16, 8, 1023, 128, torch.bfloat16, True),
                   ("d768", 2, 12, 4, 384, 64, torch.float32, True),
                   ("ragged", 2, 16, 8, 1021, 128, torch.bfloat16, True),
                   ("non-causal", 2, 8, 8, 512, 64, torch.bfloat16, False),
                   ("gpt2", 8, 12, 12, 1024, 64, torch.bfloat16, True),
                   ("gqa8", 2, 8, 1, 1021, 128, torch.bfloat16, True)]
# phase d's sweep: the card tests' lengths around the 64-row tiles (the
# bf16 bodies' 128-row blocks, rows past S), a ragged one and the training
# length
BWD_SWEEP_S = [1, 63, 64, 65, 77, 127, 128, 200, 1021]
# The flash backward's numbers before its bf16 bodies ran on the tensor
# cores (both dtypes on the CUDA cores), taken by this script on an H100
# 80GB HBM3 at 700 W: ms of A3 and A4 at phase d's "train" row, of A6 and
# A7 at phase x's main shape, and phase f's and h's ms/step. Printed
# beside this run's.
CUDA_CORE_BWD_MS = {"A3": 3.0899, "A4": 2.6739, "A6": 5.4057, "A7": 8.0546,
                    "train llama": 221.44, "train transformer": 106.79}


# The f32 flash bodies before they ran on the tensor cores (A1's CUDA-core
# flash_fwd_kernel, A3's flash_bwd_dkv_kernel and, at D 256,
# flash_bwd_dkv_sliced_kernel), taken by this script on an H100 80GB HBM3
# at 700 W (an earlier run): phase d's d768 row back to back (forward with
# lse, dK/dV), and the cold-L2 times of phase zd1's A1 and phase ze1's A3
# f32 cases by case name (D 128 at the same shape beside them). Printed
# beside this run's.
CUDA_CORE_F32_MS = {
    "d": {"A1": 0.0770, "A3": 0.2311},
    "zd1": {"gpt-j prefill": (3.0082, 1.5596),
            "qwen3-next prefill": (10.9001, 5.7876),
            "ragged S1021": (2.9989, 1.5549), "padded D192": (3.3922, 1.5711),
            "padded D160": (3.3363, 1.5551), "kv_len 900": (3.3765, 1.5331),
            "window 1024": (5.6328, 2.5536)},
    "ze1": {"gpt-j train": (10.7284, 3.0082),
            "qwen3-next train": (48.2031, 15.5069),
            "ragged S1021": (10.6965, 2.9914),
            "cross Sq512 Skv1024": (3.1609, 0.9311),
            "non-causal": (5.0255, 1.3762), "padded D192": (10.7126, 2.9884),
            "padded D160": (10.7982, 3.0126), "kv_len 900": (10.7157, 2.8762),
            "window 1024": (20.9930, 5.3790), "segments": (17.0585, 5.5424)}}
# A4's f32 dQ on the CUDA cores (flash_bwd_dq_kernel, flash_bwd_dq_sliced_
# kernel) with a cold L2, on an H100 80GB HBM3 at 700 W, on the tree before
# the dQ ran as three TF32 products: phase d's d768 row as
# scripts/flash_f32_times.py took it, phase ze1's cases (D 256 or the
# case's D, the same call at D 128) as this script's phase ze1 took them;
# PERF.md names the runs. Printed beside this run's, nowhere else
CUDA_CORE_DQ_MS = {
    "d": {"d768": 0.1007},
    "ze1": {"gpt-j train": (4.7209, 2.4270),
            "qwen3-next train": (17.0468, 8.5224),
            "ragged S1021": (4.6274, 2.4162),
            "cross Sq512 Skv1024": (1.4260, 0.7264),
            "non-causal": (2.1963, 1.1124), "padded D192": (4.6562, 2.3965),
            "padded D160": (4.6571, 2.3872), "kv_len 900": (4.6965, 2.2362),
            "window 1024": (7.3311, 3.5377), "segments": (5.6212, 2.7682)}}


# The entry points of the f32 bodies whose launches phase by phase this
# script counts (F32_LAUNCHES, by the value of the entry's ``dtype``
# parameter: csrc/common.cuh's kF32 is 0): A1's forward, A3's dK/dV, A4's
# dQ on their three schedules, E1 and P3. The wrappers' own counts are
# untouched.
F32_ENTRIES = {
    "A1": ("cubecl_flash_fwd", "cubecl_flash_masked_fwd",
           "cubecl_flash_bsp_fwd"),
    "A3": ("cubecl_flash_bwd_dkv", "cubecl_flash_masked_dkv",
           "cubecl_flash_bsp_dkv"),
    "A4": ("cubecl_flash_bwd_dq", "cubecl_flash_masked_dq",
           "cubecl_flash_bsp_dq"),
    "E1": ("cubecl_expert_matmul",),
    "P3": ("cubecl_paged_chunked",)}
F32_LAUNCHES = {body: {} for body in F32_ENTRIES}
PHASE = {"now": "1"}  # main sets it as each phase starts


def dtype_place(native, name):
    """The place of the ``dtype`` parameter of entry point ``name``, read by
    its name from the ``extern "C"`` declaration in csrc; fails unless the
    declaration has as many parameters as ``native._SIGNATURES`` binds."""
    for path in sorted(glob.glob(os.path.join(native.CSRC_DIR, "*.cu"))):
        with open(path) as f:
            m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                          f.read())
        if m:
            params = [re.split(r"[\s*]+", p.strip())[-1]
                      for p in m.group(1).split(",")]
            if len(params) != len(native._SIGNATURES[name]):
                raise RuntimeError(
                    f"{name}: {len(params)} parameters in {path}, "
                    f"{len(native._SIGNATURES[name])} bound in native.py")
            return params.index("dtype")
    raise RuntimeError(f"{name}: no extern \"C\" declaration in csrc")


def count_f32_launches(native):
    """Wrap the built library's entry points of F32_ENTRIES so that each
    call with an f32 dtype adds one to F32_LAUNCHES[body][the current
    phase]."""
    lib = native.kernels()
    for body, entries in F32_ENTRIES.items():
        for name in entries:
            def counted(*args, _fn=getattr(lib, name),
                        _at=dtype_place(native, name), _body=body):
                if args[_at] == 0:
                    n = F32_LAUNCHES[_body]
                    n[PHASE["now"]] = n.get(PHASE["now"], 0) + 1
                return _fn(*args)
            setattr(lib, name, counted)


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


# operations an element of the row-wise K0 kernels (their IR's arithmetic,
# erf and exp counted as one each), for their bounds
K0_OPS = {"gelu": 8, "softmax": 5, "normalize": 3, "layernorm": 7,
          "rmsnorm": 4, "gelu bwd": 20, "softmax bwd": 4,
          "layernorm bwd": 10, "rmsnorm bwd": 8}


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
                          plain=lambda: _plain_gelu(x), tol=None,
                          bound=(x.numel(), 4, 2, K0_OPS["gelu"])))

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
                          else None,
                          bound=(x.numel(), x.element_size(), 2,
                                 K0_OPS[op])))

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
                          plain=plain, tol=None,
                          bound=(x.numel(), 2, 2, K0_OPS[op])))
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
                xs, (xs.shape[-1],), gs, RMS_EPS),
            bound=(xs.numel(), xs.element_size(), 2, K0_OPS["rmsnorm"])))
    return cases


def k0_mapping(compiled):
    """(mapping, 16-byte branch) of a built K0 kernel, read from its
    printed source: "warp-lines" (a unit on a warp) or "thread" (a unit on
    a thread), and whether it moves 16-byte chunks where aligned."""
    src = compiled.source
    return ("warp-lines" if "mapping=warp-lines" in src else "thread",
            "if (cc_aligned)" in src)


def run_case(case, cu, ev, card, phase="a"):
    """Phase a (or e), one case: the K0 kernel against the torch evaluator
    on the card and against the plain formula; kernel and plain times,
    the bound of its bytes and operations (``case["bound"]``: elements,
    bytes an element, tensors moved, operations an element) and the
    kernel's mapping."""
    what = f"K0 {case['name']}"
    got = case["prepare"](cu)()
    mapping, vec16 = k0_mapping(cu.server.last_launched)
    want = case["prepare"](ev)()
    torch.cuda.synchronize()
    err_ev = compare(got, want, f"{what} vs evaluator")
    err = compare(got, case["plain"](), f"{what} vs plain", case["tol"])
    launch = case["prepare"](cu)
    ms = cold_ms(launch)
    call_ms = cuda_ms(launch)
    plain_ms = cuda_ms(case["plain"])
    lib_ms = cold_ms(case["library"]) if "library" in case else None
    tol = case["tol"] or TOL[got.dtype]
    lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
    bms, by = elementwise_bound(*case["bound"])
    print(f"phase {phase} {what}: max abs err {err} vs plain (atol/rtol {tol}), "
          f"{err_ev} vs the torch evaluator (atol/rtol {TOL[got.dtype]}); "
          f"kernel {ms:.4f} ms (cold L2; a call back to back {call_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms{lib}, bound {bms:.4f} ms ({by}); "
          f"mapping {mapping}{', 16-byte branch' if vec16 else ''} [{card}]",
          flush=True)
    return {"name": case["name"], "max_abs_err": err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bms,
            "bound_by": by, "mapping": mapping, "vector_16_byte": vec16}


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


# The d768 f32 llama's prefill (phase 6: B 16 x S 384) and training step
# (phase g: B 4 x S 384), use_framework_kernels=False, on the CUDA-core f32
# flash bodies: the medians of scripts/flash_f32_times.py's two runs of
# the parent checkout in one call (f32_prefill_ms, f32_step_ms; host
# clock), H100 80GB HBM3 at 700 W. Printed beside this run's.
CUDA_CORE_F32_E2E_MS = {"prefill": (20.676, 20.892), "step": (43.063, 49.870)}
F32_LLAMA = dict(vocab=8192, d_model=768, n_heads=12, n_kv_heads=4,
                 n_layers=8, d_ff=2048, seq=512)
E2E_REPS = 5  # timed calls of f32_prefill_ms and f32_step_ms


def f32_prefill_ms(llama, dev):
    """Median host-clock ms (each call synchronised, on a fresh cache) of
    ``llama.prefill`` with the kernels on phase 6's d768 f32 llama at B 16
    x S 384 (no framework kernels), after a warm call."""
    cfg = llama.LlamaConfig(**F32_LLAMA, use_framework_kernels=False)
    model = llama.init_params(cfg, seed=1, device=dev)
    B, S, page = 16, 384, 128
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)

    def once():
        cache = llama.init_kv_cache(cfg, B, math.ceil((S + 32) / page), page,
                                    dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            llama.prefill(model, cache, prompt, kernels=True)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    once()
    return statistics.median(once() for _ in range(E2E_REPS))


def f32_step_ms(llama, dev):
    """Median host-clock ms (each step synchronised) of one
    ``make_train_step`` step with the kernels on phase g's d768 f32 llama
    at B 4 x S 384 (no framework kernels), after two warm steps."""
    cfg = llama.LlamaConfig(**F32_LLAMA, use_framework_kernels=False)
    model = llama.init_params(cfg, seed=1, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (4, 385), dtype=np.int32)).to(dev)
    step = llama.make_train_step(cfg, 1e-3, kernels=True)

    def once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, tokens)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    once()
    once()
    return statistics.median(once() for _ in range(E2E_REPS))


def _e2e_beside(what, ms):
    """This run's f32 prefill or step time beside the CUDA-core bodies'."""
    lo, hi = CUDA_CORE_F32_E2E_MS[what]
    return (f"{ms:.3f} ms (median of {E2E_REPS}, host clock; on the "
            f"CUDA-core f32 "
            f"flash bodies {lo:.3f}-{hi:.3f} ms, constants of this script "
            f"from an earlier run)")


def exactness(llama, dev, framework):
    """Phases 6 and c (bench.py:604-609): a d768 f32 llama served with the
    kernels and with their plain versions; prefill logits within
    LOGIT_TOL, greedy tokens equal but at near-ties; without the framework
    kernels (phase 6) the prefill's time (f32_prefill_ms). Returns the
    line."""
    cfg = llama.LlamaConfig(**F32_LLAMA, use_framework_kernels=framework)
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
    del model
    timed = ("" if framework else "; the f32 prefill with the kernels "
             + _e2e_beside("prefill", f32_prefill_ms(llama, dev)))
    return (f"exactness llama d768 f32 (8 layers, 12/4 heads, "
            f"use_framework_kernels={framework}): {B} requests x {S} prompt "
            f"+ {steps} steps, kernels vs plain on the card: prefill logits "
            f"max abs err {logit_err} (tol {LOGIT_TOL}); {same}/{B} token "
            f"rows equal; near-tie flips {flips}{timed}")


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
                plain=plain, tol=chain, library=library[kind],
                bound=(x.numel(), x.element_size(), 2 if kind == "fwd"
                       else 3, K0_OPS[op if kind == "fwd" else op + " bwd"])))
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
            bound=(y.numel(), y.element_size(), 3, K0_OPS["softmax bwd"]),
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
        exact, rounded = (plain_bwd(
            fa, q, k, v, o, lse, do, causal, round_p_ds=rnd)
            for rnd in (False, True))
        torch.cuda.synchronize()
        err_r, err, need = zip(*(compare_bwd(a, r, e, f"{what}: d{n}")
                                for n, a, r, e in zip("qkv", (dq, dk, dv),
                                                      rounded, exact)))
        again = (fa.flash_bwd_dq(q, k, v, do, lse, di, causal),
                 *fa.flash_bwd_dkv(q, k, v, do, lse, di, causal))
        if not all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))):
            fail(f"{what}: a second call of the kernels differs")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.flash_attention(*leaves, causal).backward(do)
        if not all(torch.equal(t.grad, a)
                   for t, a in zip(leaves, (dq, dk, dv))):
            fail(f"{what}: the autograd Function's grads are not the "
                 "kernels'")
        del exact, rounded, leaves
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
        # the kernels' own products: s, dP, dV, dK (dK/dV) and s, dP, dQ
        pair_flops = 2 * D * B * H * (S * (S + 1) // 2 if causal else S * S)
        tf = {"dK/dV": 4 * pair_flops / dkv_ms / 1e9,
              "dQ": 3 * pair_flops / dq_ms / 1e9,
              "both": 7 * pair_flops / (dkv_ms + dq_ms) / 1e9}
        was = (f" (on the CUDA cores, a constant of this script from an "
               f"earlier run: dK/dV {CUDA_CORE_BWD_MS['A3']:.4f}, dQ "
               f"{CUDA_CORE_BWD_MS['A4']:.4f} ms)" if name == "train"
               else "")
        lse_bytes = 8 * B * H * S           # lse and di, f32
        elem = torch.finfo(dt).bits // 8
        dkv_bound = flash_bound(B, H, Hkv, S, S, D, dt, causal, 4,
                                elem * D * 2 * B * Hkv * S + lse_bytes)
        dq_bound = flash_bound(B, H, Hkv, S, S, D, dt, causal, 3,
                               elem * D * B * H * S + lse_bytes)
        f32 = {}
        if dt == torch.float32:
            # the 3xTF32 forward and dK/dV with a cold L2, their shares of
            # the bounds, SDPA's forward in f32 (TF32 off)
            fwd_bound = flash_bound(B, H, Hkv, S, S, D, dt, causal)
            f32 = dict(
                fwd_cold_ms=cold_ms(lambda: fa._flash_forward(
                    q, k, v, causal, None, True)),
                dkv_cold_ms=cold_ms(lambda: fa.flash_bwd_dkv(
                    q, k, v, do, lse, di, causal)),
                dq_cold_ms=cold_ms(lambda: fa.flash_bwd_dq(
                    q, k, v, do, lse, di, causal)),
                library_fwd_ms=cuda_ms(
                    lambda: TF.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True)),
                fwd_bound=fwd_bound)
            fc, dc = f32["fwd_cold_ms"], f32["dkv_cold_ms"]
            qc = f32["dq_cold_ms"]
            was = (f"; the 3xTF32 bodies with a cold L2: forward {fc:.4f} "
                   f"ms ({100 * fwd_bound[0] / fc:.1f}% of its bound "
                   f"{fwd_bound[0]:.4f}, {fwd_bound[1]}), dK/dV {dc:.4f} ms "
                   f"({100 * dkv_bound[0] / dc:.1f}% of "
                   f"{dkv_bound[0]:.4f}), dQ {qc:.4f} ms "
                   f"({100 * dq_bound[0] / qc:.1f}% of {dq_bound[0]:.4f}); "
                   f"on the CUDA cores, constants of this script from an "
                   f"earlier run, back to back: forward "
                   f"{CUDA_CORE_F32_MS['d']['A1']:.4f}, dK/dV "
                   f"{CUDA_CORE_F32_MS['d']['A3']:.4f} ms, dQ with a cold "
                   f"L2 {CUDA_CORE_DQ_MS['d']['d768']:.4f} ms; SDPA's f32 "
                   f"forward {f32['library_fwd_ms']:.4f} ms")
        print(f"phase d {what}: max abs err o {err_o}, lse {err_lse} "
              f"(atol/rtol {TOL[dt]}; lse {TOL[torch.float32]}); against "
              f"the plain backward that rounds p and dS as the kernels do: "
              f"dq {err_r[0]}, dk {err_r[1]}, dv {err_r[2]} (atol/rtol "
              f"{TOL[dt]}); against the exact plain backward: dq {err[0]}, "
              f"dk {err[1]}, dv {err[2]} (atol/rtol {EXACT_BWD_TOL[dt]}; "
              f"the atol each needs there at that rtol, kernel and "
              f"rounding plain: dq {need[0]}, dk {need[1]}, dv {need[2]}); "
              f"two calls bit-identical; kernels: forward with "
              f"lse {fwd_ms:.4f} ms, dK/dV {dkv_ms:.4f} ms, dQ {dq_ms:.4f} "
              f"ms{was}; TFLOP/s dK/dV {tf['dK/dV']:.1f}, dQ {tf['dQ']:.1f},"
              f" both {tf['both']:.1f}; plain backward {plain_ms:.4f} ms, "
              f"SDPA's backward {lib_ms:.4f} ms [{card}]", flush=True)
        rows[name] = dict(
            dq_err=err[0], dkv_err=max(err[1:]), dq_err_rounded=err_r[0],
            dkv_err_rounded=max(err_r[1:]), atol_vs_exact=dict(
                zip(("dq", "dk", "dv"), need)), fwd_ms=fwd_ms,
            dkv_ms=dkv_ms, dq_ms=dq_ms, plain_ms=plain_ms, library_ms=lib_ms,
            tflops=tf, dkv_bound=dkv_bound, dq_bound=dq_bound, **f32)
    return rows


# phase d's f32 dQ instances (flash_bwd_dq_tf32x3_kernel): B 2, S 1021
# (S 1024 block-sparse), causal, 18 query heads, 3 a kv head (block-sparse:
# 9 heads of one kv head each)
A4_F32_H = 18
A4_F32_S = 1021


def a4_f32_instances(fa, dev, gen, card):
    """Phase d: every instance of the f32 dQ body (D 64, 128, 256; dense,
    masked with a band of 300, block-sparse with F9's rows at bq 128, bk
    64; two q tiles a block at D 128) launched once on its forward's o and
    lse and held to the plain backward on float64 copies at f32's
    tolerance."""
    errs = {}
    for D in (64, 128, 256):
        for sched in ("dense", "masked", "block-sparse"):
            S = A4_F32_S + 3 if sched == "block-sparse" else A4_F32_S
            H, Hkv = ((A4_F32_H // 2,) * 2 if sched == "block-sparse"
                      else (A4_F32_H, A4_F32_H // 3))
            q, do = (torch.randn(2, H, S, D, generator=gen, device=dev)
                     for _ in range(2))
            k, v = (torch.randn(2, Hkv, S, D, generator=gen,
                                device=dev) for _ in range(2))
            scale = D ** -0.5
            what = f"phase d f32 dQ {sched} D{D} B2 H{H}/{Hkv} S{S} causal"
            if sched == "block-sparse":
                bq, bk = 128, 64
                bm = bsp_mask("f9", S // bq, S // bk)
                sched_t = fa._schedule(fa._pruned_mask(
                    bm, True, bq, bk, S // bq, S // bk), bq, bk, dev)
                o, lse = fa.bsp_forward(q, k, v, sched_t, True, scale,
                                        bq, bk, True)
                di = (do * o).sum(-1)
                n0 = fa.bsp_dq.launches
                dq = fa.bsp_dq(q, k, v, do, lse, di, sched_t, True,
                               scale, bq, bk)
                n = fa.bsp_dq.launches - n0
                ref = fa.flash_attention_block_sparse_backward_plain(
                    *(t.double() for t in (q, k, v, o, lse, do)), bm,
                    True, None, bq, bk)[0].float()
            else:
                mask = fa._Mask.of(q, k, window=(300, 0)) \
                    if sched == "masked" else None
                counter = fa.masked_dq if mask else fa.flash_bwd_dq
                if mask is None:
                    o, lse = fa._flash_forward(q, k, v, True, scale, True)
                else:
                    o, lse = fa.masked_forward(q, k, v, mask, True, scale,
                                               True)
                di = (do * o).sum(-1)
                n0 = counter.launches
                dq = (fa.flash_bwd_dq(q, k, v, do, lse, di, True, scale)
                      if mask is None else fa.masked_dq(
                          q, k, v, do, lse, di, mask, True, scale))
                n = counter.launches - n0
                ref = plain_bwd(fa, q, k, v, o, lse, do, True, scale,
                                **({} if mask is None
                                   else mask.plain()))[0]
            torch.cuda.synchronize()
            if n != 1:
                fail(f"{what}: the kernel did not launch once")
            errs[f"{sched} D{D}"] = compare(dq, ref, what)
            del q, k, v, do, o, lse, di, dq, ref
    torch.cuda.empty_cache()
    print(f"phase d f32 dQ (3xTF32) on every instance, one launch each "
          f"against the plain backward on float64 copies (atol/rtol "
          f"{TOL[torch.float32]}): max abs err {errs} [{card}]", flush=True)
    return errs


def flash_backward_sweep(fa, dev, gen, card):
    """Phase d: the bf16 dK/dV and dQ kernels against both plain backwards
    over the card tests' grid: B2 with 8 query heads in kv groups of 1, 2
    and 8 and with 6 in groups of 3, every length of ``BWD_SWEEP_S``, D 64,
    128 and 256, causal or not. Prints the largest atol (at EXACT_BWD_TOL's
    rtol) that the kernels and the rounding plain version need against the
    exact plain backward, with the case."""
    worst = {"kernels": (0.0, ""), "rounding plain": (0.0, "")}
    dt = torch.bfloat16
    for S in BWD_SWEEP_S:
        for H, Hkv in ((8, 8), (8, 4), (8, 1), (6, 2)):
            for D in (64, 128, 256):
                for causal in (True, False):
                    q, do = (torch.randn(2, H, S, D, generator=gen,
                                         device=dev).to(dt) for _ in range(2))
                    k, v = (torch.randn(2, Hkv, S, D, generator=gen,
                                        device=dev).to(dt) for _ in range(2))
                    o, lse = fa._flash_forward(q, k, v, causal, None, True)
                    di = (do.float() * o.float()).sum(-1)
                    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, causal)
                    dq = fa.flash_bwd_dq(q, k, v, do, lse, di, causal)
                    exact, rounded = (plain_bwd(
                        fa, q, k, v, o, lse, do, causal, round_p_ds=rnd)
                        for rnd in (False, True))
                    case = (f"H{H}/{Hkv} S{S} D{D} "
                            f"{'causal' if causal else 'non-causal'}")
                    for n, a, r, e in zip("qkv", (dq, dk, dv), rounded,
                                          exact):
                        _, _, need = compare_bwd(
                            a, r, e, f"phase d sweep {case}: d{n}")
                        for who, x in zip(worst, need):
                            if x > worst[who][0]:
                                worst[who] = (x, f"d{n} {case}")
    print(f"phase d sweep of the bf16 backward, {len(BWD_SWEEP_S) * 24} "
          f"cases (B2, H 8/8, 8/4, 8/1, 6/2, S {BWD_SWEEP_S}, D 64, 128 "
          f"and 256, causal or not): all within atol/rtol {TOL[dt]} of the "
          f"rounding plain backward and {EXACT_BWD_TOL[dt]} of the exact "
          f"one; largest atol needed against the exact one at rtol "
          f"{EXACT_BWD_TOL[dt][1]}: kernels {worst['kernels'][0]} "
          f"({worst['kernels'][1]}), rounding plain "
          f"{worst['rounding plain'][0]} ({worst['rounding plain'][1]}) "
          f"[{card}]", flush=True)
    return worst


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
               "paged decode (P1)" if re.search(
                   r"paged_(decode|window|ring|grouped|ragged)_kernel", n) else
               "K0 @cube" if re.search(r"_(rmsnorm|layernorm|gelu|softmax)_"
                                       r"(fwd|bwd)_k", n) else
               "S1 backward" if "scan_bwd_kernel" in n else
               "S1 forward" if "scan_kernel<" in n else
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
          f"{1e3 * secs[0]:.2f} ms; with the backward on the CUDA cores, "
          f"a constant of this script from an earlier run, "
          f"{CUDA_CORE_BWD_MS['train llama']} ms/step), "
          f"{B * (S - 1) / ms * 1e3:.0f} tok/s; "
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
    k0_share = None if prof is None else dict(
        k0_ms=prof[2].get("K0 @cube", 0.0), busy_ms=prof[1],
        share_of_busy=prof[2].get("K0 @cube", 0.0) / prof[1],
        step_wall_ms=prof[0])
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
    return {k: v for k, v in launches.items()}, k0_share


def train_exactness(llama, dev, framework):
    """Phase g (bench.py:604-609): one SGD step of the d768 f32 llama at
    B 4 x S 384 with the kernels and one with their plain versions, from
    the same weights: loss to 1e-5 relative, every gradient and updated
    weight to 1e-4 of its max-abs; without the framework kernels the
    step's time (f32_step_ms). Returns the line."""
    cfg = llama.LlamaConfig(**F32_LLAMA, use_framework_kernels=framework)
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
    del runs, pk, pp
    timed = ("" if framework else "; one f32 step with the kernels "
             + _e2e_beside("step", f32_step_ms(llama, dev)))
    return (f"train exactness llama d768 f32 (8 layers, 12/4 heads, "
            f"use_framework_kernels={framework}): B 4 x S 384, one SGD step "
            f"with the kernels and one with the plain versions: loss {lk} "
            f"vs {lp} (rel {abs(lk - lp) / abs(lp):.2e}, tol 1e-5); worst "
            f"gradient {worst['grad']:.2e} and updated weight "
            f"{worst['weight']:.2e} of their max-abs (tol 1e-4){timed}")


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
          f"(median of steps 2-{steps}; with the backward on the CUDA "
          f"cores, a constant of this script from an earlier run, "
          f"{CUDA_CORE_BWD_MS['train transformer']} ms/step), peak memory "
          f"{peak:.2f} GiB; "
          f"launches per step { {k: v // steps for k, v in launches.items()} }"
          f" [{card}]", flush=True)
    prof = profile_step(step, model, tokens)
    if prof is None:
        print("phase h profile: the trace holds no device time; device "
              "busy share not measured", flush=True)
    else:
        wall, busy, groups, top = prof
        print(f"phase h profile of one step: wall {wall:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%, idle "
              f"{100 - 100 * busy / wall:.1f}%); device ms by group "
              f"{ {k: round(v, 3) for k, v in sorted(groups.items())} }; "
              f"longest in other: { {k: round(v, 3) for k, v in top} } "
              f"[{card}]", flush=True)
    del model, step
    torch.cuda.empty_cache()
    return launches


def bound_ms(flops, nbytes, dtype, products=False):
    """The least time the card could take for ``flops`` operations of
    ``dtype`` and ``nbytes`` moved (each input byte read once, each output
    byte written once): (ms, the term that bounds it). ``products``: the
    operations are matrix products, which in f32 may run as three TF32
    products (the lesser time of the two, "operations, 3xTF32" when the
    TF32 term bounds)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    ops = "operations"
    if products and dtype == torch.float32:
        t_tf32 = TF32_PRODUCTS * flops / PEAK_TF32_FLOPS
        if t_tf32 < t_ops:
            t_ops, ops = t_tf32, "operations, 3xTF32"
    return 1e3 * max(t_ops, t_bytes), (ops if t_ops > t_bytes else "bytes")


def flash_bound(B, H, Hkv, Sq, Sk, D, dtype, causal, products=2,
                extra_bytes=0, pairs=None):
    """Bound of an attention call over (B, H, Sq, D) queries and (B, Hkv,
    Sk, D) keys and values, of ``products`` matrix products per live
    (query, key) pair and head: the forward's two, or the dK/dV kernel's
    four and the dQ kernel's three. ``pairs``: the live pairs of a batch
    row and head where a mask other than ``causal`` sets them (then ``Sk``
    counts only the keys some live pair reads). Bytes: q, k, v and o (or
    the grads in their place), plus ``extra_bytes``."""
    if pairs is None:
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * D * (2 * B * H * Sq + 2 * B * Hkv * Sk) + extra_bytes
    return bound_ms(2 * products * D * B * H * pairs, nbytes, dtype,
                    products=True)


def paged_bound(q_dtype, kv_elem, D, H, Hkv, n_live, kv_live, quant,
                rows, extra_bytes=0):
    """Bound of paged attention. ``n_live``: per query row (of every batch
    row), the positions it attends; ``kv_live``: per batch row, the
    positions its kv heads read. Two products per (query row, position,
    head); bytes: q and o (``rows`` query tokens of H heads), the live K
    and V of each kv head, their int8 scales, ``extra_bytes`` (a ring's
    positions)."""
    flops = 4 * D * H * sum(n_live)
    elem = torch.finfo(q_dtype).bits // 8
    kv = sum(kv_live) * Hkv * (2 * D * kv_elem + (8 if quant else 0))
    return bound_ms(flops, 2 * rows * H * D * elem + kv + extra_bytes,
                    q_dtype, products=True)


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


# phase i: (name, B, L, Hkv, G, C, D, page, max_pages, starts, lengths or
# None for starts + C, dtype, int8 pools)
CHUNKED_CASES = [
    ("verify", 8, 16, 8, 2, 5, 128, 128, 9, [1051] * 8, None, torch.bfloat16,
     False),
    ("prefill start 0", 8, 16, 8, 2, 256, 128, 128, 9, [0] * 8, None,
     torch.bfloat16, False),
    ("prefill start 768", 8, 16, 8, 2, 256, 128, 128, 9, [768] * 8, None,
     torch.bfloat16, False),
    ("d768", 16, 8, 4, 3, 5, 64, 128, 4, [395] * 16, None, torch.float32,
     False),
    ("ragged", 8, 4, 8, 2, 16, 128, 128, 8, [0, 1, 127, 128, 500, 1000, 640,
                                             3],
     [0, 17, 143, 144, 510, 1016, 656, 10], torch.bfloat16, False),
    ("verify int8", 8, 16, 8, 2, 5, 128, 128, 9, [1051] * 8, None,
     torch.bfloat16, True),
    ("prefill int8 start 768", 8, 16, 8, 2, 256, 128, 128, 9, [768] * 8, None,
     torch.bfloat16, True),
]
P1_SYMBOLS = ("paged_decode_kernel<T, TK, D> (positions split over blocks, "
              "a cp.async ring per warp through the table), then "
              "paged_combine_kernel<T, D> where the positions are split (a "
              "second launch a call, counted as one)")
NO_LIBRARY_PAGED = ("no single PyTorch call attends through a block "
                    "table: SDPA needs the pages gathered first")
# P3's times before its bf16 body ran on the tensor cores (the CUDA-core
# body for every dtype), taken by this script on an H100 80GB HBM3 at 700
# W; printed beside this run's
CUDA_CORE_P3_MS = {"verify": 0.179, "prefill start 0": 0.182,
                   "prefill start 768": 0.826, "verify int8": 0.160}


# phase i's f32 P3 instances (paged_chunked_tf32x3_kernel): every head dim
# with an instance and three ragged ones (in the widths 64, 128, 256), f32
# and int8 pools; a verify-shaped chunk (G 2 x C 5, its positions split) on
# pages of 7 and a prefill-shaped one (G 3 x C 70: 4 row tiles, no split)
# on pages of 16: (B, Hkv, G, C, page, max_pages, starts, lengths or None)
P3_F32_SHAPES = {"verify": (4, 2, 2, 5, 7, 40, [0, 37, 100, 250],
                            [0, 42, 105, 255]),
                 "prefill": (2, 2, 3, 70, 16, 20, [0, 40], None)}
P3_F32_DIMS = (32, 64, 80, 96, 128, 256, 48, 112, 200)


def p3_f32_instances(pa, dev, gen, card):
    """Phase i: every instance of P3's f32 body, one launch a case of
    P3_F32_SHAPES on f32 and int8 pools at P3_F32_DIMS, its plan the built
    kernel's (split where decode-shaped), held to the plain version at
    f32's tolerance; a length-0 row's zeros."""
    errs = {}
    for D in P3_F32_DIMS:
        for quant in (False, True):
            for shape, (B, Hkv, G, C, page, mp, starts, lengths) in \
                    P3_F32_SHAPES.items():
                kv_dt = torch.int8 if quant else torch.float32
                args = (torch.float32, kv_dt, B, Hkv * G, Hkv, C, D, page, mp)
                plan = pa.p3_plan(*args)
                what = (f"phase i f32 P3 {shape} D{D} "
                        f"{'int8' if quant else 'f32'} pools B{B} Hkv{Hkv} "
                        f"G{G} C{C} page{page}")
                if pa.p3_kernel_plan(*args) != plan or \
                        plan.body != "tf32x3" or \
                        (plan.splits > 1) != (shape == "verify"):
                    fail(f"{what}: plan {plan} (the kernel's "
                         f"{pa.p3_kernel_plan(*args)})")
                P = B * mp + 3
                q = torch.randn(B, Hkv * G, C, D, generator=gen, device=dev)
                kp, vp, ks, vs = kv_pools("int8" if quant else "f32",
                                          (2, Hkv, P, page, D), dev, gen)
                table = torch.randperm(P, generator=gen, device=dev)[
                    :B * mp].view(B, mp).to(torch.int32)
                st = torch.tensor(starts, dtype=torch.int32, device=dev)
                ln = st + C if lengths is None else torch.tensor(
                    lengths, dtype=torch.int32, device=dev)
                n0 = pa.paged_attention_chunked.launches
                got = pa.paged_attention_chunked(q, kp, vp, table, ln, st,
                                                 layer=1, k_scales=ks,
                                                 v_scales=vs)
                torch.cuda.synchronize()
                if pa.paged_attention_chunked.launches != n0 + 1:
                    fail(f"{what}: the kernel did not launch once")
                errs[f"{shape} D{D} {'int8' if quant else 'f32'}"] = compare(
                    got, pa.paged_attention_chunked_plain(
                        q, kp, vp, table, ln, st, layer=1, k_scales=ks,
                        v_scales=vs), what)
                if lengths is not None and got[0].any():
                    fail(f"{what}: a length-0 row is not zero")
    print(f"phase i f32 P3 (3xTF32) on every instance, one launch a case "
          f"against plain (atol/rtol {TOL[torch.float32]}): max abs err "
          f"{errs} [{card}]", flush=True)
    return errs


def chunked_vs_plain(pa, dev, gen, card, phase="i", cases=CHUNKED_CASES,
                     beside=None):
    """P3 against its plain version, one case (CHUNKED_CASES' columns) a
    row; phase i at the shapes of the slice's path (the speculative verify
    step, chunked prefill, the d768 config, a ragged batch with a length-0
    row, int8 pools). One launch counted; CUDA-event times, each launch on
    the next layer of the pool, as the layers of a step walk it, and
    device times with a cold L2; each case's launch plan (body, position
    splits) in ops/paged_attention.py held to the built kernel's. With
    ``beside`` (a head dim), also the cold-L2 time of that D's instance at
    the same shape (``d{beside}_cold_ms``). No library call computes the
    function (NO_LIBRARY_PAGED)."""
    rows = {}
    for (name, B, L, Hkv, G, C, D, page, max_pages, starts, lengths, dt,
         quant) in cases:
        lengths = lengths or [s + C for s in starts]
        kv_dt = torch.int8 if quant else dt
        plan = pa.p3_plan(dt, kv_dt, B, Hkv * G, Hkv, C, D, page, max_pages)
        if pa.p3_kernel_plan(dt, kv_dt, B, Hkv * G, Hkv, C, D, page,
                             max_pages) != plan:
            fail(f"phase {phase} {name}: P3's launch plan in "
                 f"ops/paged_attention.py {plan} is not the kernel's")
        P = B * max_pages + 5
        q = torch.randn(B, Hkv * G, C, D, generator=gen, device=dev).to(dt)
        kind = "int8" if quant else _dt(dt)
        kp, vp, ks, vs = kv_pools(kind, (L, Hkv, P, page, D), dev, gen)
        table = torch.randperm(P, generator=gen, device=dev)[:B * max_pages]
        table = table.view(B, max_pages).to(torch.int32)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        sc = dict(k_scales=ks, v_scales=vs)
        n0 = pa.paged_attention_chunked.launches
        got = pa.paged_attention_chunked(q, kp, vp, table, ln, st,
                                         layer=L - 1, **sc)
        torch.cuda.synchronize()
        what = (f"P3 {name} {_dt(dt)} q{'/int8 KV' if quant else ''} B{B} "
                f"Hkv{Hkv} G{G} C{C} D{D} page{page} layer{L - 1}/{L}")
        if pa.paged_attention_chunked.launches != n0 + 1:
            fail(f"phase {phase} {what}: the kernel did not launch once")
        err = compare(got, pa.paged_attention_chunked_plain(
            q, kp, vp, table, ln, st, layer=L - 1, **sc), what)
        if 0 in lengths and got[lengths.index(0)].any():
            fail(f"{what}: a length-0 row is not zero")
        layers = iter(range(10**9))
        ms = cuda_ms(lambda: pa.paged_attention_chunked(
            q, kp, vp, table, ln, st, layer=next(layers) % L, **sc),
            iters=32)
        cold = cold_ms(lambda: pa.paged_attention_chunked(
            q, kp, vp, table, ln, st, layer=L - 1, **sc))
        plain_ms = cuda_ms(lambda: pa.paged_attention_chunked_plain(
            q, kp, vp, table, ln, st, layer=next(layers) % L, **sc),
            iters=8, warmup=1)
        n_live, kv_live = chunked_live(starts, lengths, C)
        bms, by = paged_bound(dt, kp.element_size(), D, Hkv * G, Hkv,
                              n_live, kv_live, quant, B * C)
        row = rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, body=plan.body,
                                splits=plan.splits, cold_ms=cold)
        del q, kp, vp, ks, vs
        if beside:
            q = torch.randn(B, Hkv * G, C, beside, generator=gen,
                            device=dev).to(dt)
            kp, vp, ks, vs = kv_pools(kind, (2, Hkv, P, page, beside), dev,
                                      gen)
            row[f"d{beside}_cold_ms"] = cold_ms(
                lambda: pa.paged_attention_chunked(
                    q, kp, vp, table, ln, st, layer=1, k_scales=ks,
                    v_scales=vs))
            del q, kp, vp, ks, vs
        before = CUDA_CORE_P3_MS.get(name) if D == 128 else None
        print(f"phase {phase} {what} [body {plan.body}, {plan.splits} "
              f"position split(s) of {plan.split_len}, grid {plan.grid}"
              f"{', a combine launch' if plan.splits > 1 else ''}]: max abs "
              f"err {err} (atol/rtol {TOL[dt]}); kernel {ms:.4f} ms"
              + (f" (CUDA cores before: {before} ms)" if before
                 and plan.body == "wgmma" else "")
              + f", device time with a cold L2 {cold:.4f} ms"
              + (f" (D {beside} at the same shape: "
                 f"{row[f'd{beside}_cold_ms']:.4f} ms)" if beside else "")
              + f", plain {plain_ms:.4f} ms, library none, bound {bms:.4f} "
              f"ms ({by}; {100 * bms / ms:.1f}% of it) [{card}]", flush=True)
    torch.cuda.empty_cache()
    return rows


# q and pool dtypes of each pool kind
KV_KINDS = {"bf16": (torch.bfloat16, torch.bfloat16),
            "int8": (torch.bfloat16, torch.int8),
            "f32": (torch.float32, torch.float32)}
# phase j, P1 on int8 pools (a ragged batch, the serving shape) and the
# KV-bound decode of ROADMAP Queue 1 item 8 (the 0.77B llama's widths: 16
# layers, 8 kv heads of 128, 2 query heads a kv head, B 16 at context
# 2048) on bf16 and int8 pools: (name, B, L, Hkv, G, D, page, max_pages,
# lengths, pool kind, mode, window, sinks); mode "full", "window" (window
# + sinks) or "ring" (the table's pages a ring, pos_meta from ring_meta)
J_CASES = [
    ("ragged int8", 8, 4, 8, 2, 128, 128, 8,
     [0, 1, 127, 128, 129, 1000, 640, 1024], "int8", "full", 0, 0),
    ("serving int8", 8, 16, 8, 2, 128, 128, 9, [1056] * 8, "int8", "full",
     0, 0),
    ("KV-bound bf16", 16, 16, 8, 2, 128, 128, 16, [2048] * 16, "bf16",
     "full", 0, 0),
    ("KV-bound int8", 16, 16, 8, 2, 128, 128, 16, [2048] * 16, "int8",
     "full", 0, 0)]


def kv_pools(kind, shape, dev, gen):
    """(k, v, k_scales, v_scales) of pool kind ``kind``: N(0, 1) pools in
    its dtype, or int8 quantized from them with their scales."""
    if kind == "int8":
        return int8_pools(shape, dev, gen)
    dt = KV_KINDS[kind][1]
    return (*(torch.randn(shape, generator=gen, device=dev).to(dt)
              for _ in range(2)), None, None)


def _p1_counts(pa):
    f = pa.paged_attention
    return (f.launches, f.int8_launches, f.window_launches, f.ring_launches,
            f.grouped_launches)


def p1_vs_plain(pa, dev, gen, card, phase, cases, beside=None,
                beside_group=None):
    """P1 against its plain version, one case (J_CASES' columns) a row: the
    call's launch counted in its mode, a length-0 row's zeros, the launch
    plan in ops/paged_attention.py held to the built kernel's; CUDA-event
    times back to back (each launch on the next layer, as a decode step's
    layers walk the pool) and with a cold L2, plain's time, the bound on
    the positions the call attends and the GB/s of K/V read. With
    ``beside`` (a head dim), also the cold-L2 time of that D's instance at
    the same B, Hkv, context and mode (``d{beside}_cold_ms``); with
    ``beside_group`` (a group), that of the same call at that many query
    heads a kv head, which reads the same K/V bytes
    (``g{beside_group}_cold_ms``)."""
    rows = {}
    for (name, B, L, Hkv, G, D, page, max_pages, lengths, kind, mode, window,
         sinks) in cases:
        qdt, kdt = KV_KINDS[kind]
        quant, ring = kind == "int8", mode == "ring"
        P, cap = B * max_pages + 5, page * max_pages
        table = torch.randperm(P, generator=gen, device=dev)[:B * max_pages]
        table = table.view(B, max_pages).to(torch.int32)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        opts = {} if mode == "full" else dict(window=window, sinks=sinks)
        if ring:
            opts["pos_meta"] = ring_meta(table, lengths, page, sinks, P)
        args = (qdt, kdt, B, Hkv * G, Hkv, D, page, max_pages, window, sinks,
                ring)
        plan = pa.p1_plan(*args)
        what = (f"P1 {name} D{D} {kind} pools, {_dt(qdt)} q, B{B} Hkv{Hkv} "
                f"G{G} page{page} x{max_pages} layer{L - 1}/{L} {mode}"
                + (f" (window {window}, sinks {sinks})" if opts else ""))
        if pa.p1_kernel_plan(*args) != plan:
            fail(f"phase {phase} {what}: p1_plan {plan} is not the kernel's")
        q = torch.randn(B, Hkv * G, D, generator=gen, device=dev).to(qdt)
        kp, vp, ks, vs = kv_pools(kind, (L, Hkv, P, page, D), dev, gen)
        sc = dict(k_scales=ks, v_scales=vs, **opts)
        n0 = _p1_counts(pa)
        got = pa.paged_attention(q, kp, vp, table, ln, layer=L - 1, **sc)
        torch.cuda.synchronize()
        want_n = (n0[0] + 1, n0[1] + quant, n0[2] + (mode == "window"),
                  n0[3] + ring, n0[4] + (G > 8))
        if _p1_counts(pa) != want_n:
            fail(f"phase {phase} {what}: launches {_p1_counts(pa)}, want "
                 f"{want_n}")
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
        cold = cold_ms(lambda: pa.paged_attention(q, kp, vp, table, ln,
                                                  layer=L - 1, **sc))
        live = pa._live(table.long(), ln, cap, opts.get("window", 0), sinks,
                        opts.get("pos_meta")).sum(1).tolist()
        bms, by = paged_bound(qdt, kp.element_size(), D, Hkv * G, Hkv, live,
                              live, quant, B, 4 * sum(
                                  min(n, cap) for n in lengths) if ring else 0)
        kv_gb = sum(live) * Hkv * (2 * D * kp.element_size()
                                   + (8 if quant else 0)) / 1e9
        row = rows[name] = dict(
            max_abs_err=err, ms=ms, cold_ms=cold, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, kv_gb_per_s=kv_gb / ms * 1e3,
            kv_gb_per_s_cold=kv_gb / cold * 1e3, splits=plan.splits)
        del q, kp, vp, ks, vs
        if beside:
            q = torch.randn(B, Hkv * G, beside, generator=gen,
                            device=dev).to(qdt)
            kp, vp, ks, vs = kv_pools(kind, (2, Hkv, P, page, beside), dev,
                                      gen)
            row[f"d{beside}_cold_ms"] = cold_ms(lambda: pa.paged_attention(
                q, kp, vp, table, ln, layer=1, k_scales=ks, v_scales=vs,
                **opts))
            del q, kp, vp, ks, vs
        g_key = f"g{beside_group}_cold_ms"
        if beside_group:
            q = torch.randn(B, Hkv * beside_group, D, generator=gen,
                            device=dev).to(qdt)
            kp, vp, ks, vs = kv_pools(kind, (2, Hkv, P, page, D), dev, gen)
            row[g_key] = cold_ms(lambda: pa.paged_attention(
                q, kp, vp, table, ln, layer=1, k_scales=ks, v_scales=vs,
                **opts))
            row["groups"] = plan.groups
            del q, kp, vp, ks, vs
        print(f"phase {phase} {what}: max abs err {err} (atol/rtol "
              f"{TOL[qdt]}); kernel {1e3 * ms:.1f} µs back to back "
              f"({kv_gb / ms * 1e3:.0f} GB/s of KV), {1e3 * cold:.1f} µs cold "
              f"L2 ({kv_gb / cold * 1e3:.0f} GB/s; {plan.splits} position "
              f"splits)" + (f", D {beside} at the same B, Hkv and context "
                            f"{1e3 * row[f'd{beside}_cold_ms']:.1f} µs cold"
                            if beside else "")
              + (f" ({plan.groups} row groups); G {beside_group} at the "
                 f"same B, Hkv, D and context (the same K/V bytes) "
                 f"{1e3 * row[g_key]:.1f} µs cold" if beside_group else "")
              + f"; plain {plain_ms:.4f} ms, bound {1e3 * bms:.1f} µs ({by}; "
              f"{100 * bms / cold:.1f}% of it cold) [{card}]", flush=True)
    torch.cuda.empty_cache()
    return rows


def _paged_counts(fa, pa):
    return {"flash_attention": fa.flash_attention.launches,
            "paged_attention": pa.paged_attention.launches,
            "paged_attention_int8": pa.paged_attention.int8_launches,
            "paged_attention_window": pa.paged_attention.window_launches,
            "paged_attention_ring": pa.paged_attention.ring_launches,
            "paged_attention_grouped": pa.paged_attention.grouped_launches,
            "paged_attention_ragged": pa.paged_attention.ragged_launches,
            "paged_attention_chunked": pa.paged_attention_chunked.launches,
            "paged_attention_chunked_ragged":
                pa.paged_attention_chunked.ragged_launches}


def _reset_paged(fa, pa):
    fa.flash_attention.launches = pa.paged_attention.launches = 0
    pa.paged_attention.int8_launches = 0
    pa.paged_attention.window_launches = 0
    pa.paged_attention.ring_launches = 0
    pa.paged_attention.grouped_launches = 0
    pa.paged_attention.ragged_launches = 0
    pa.paged_attention_chunked.launches = 0
    pa.paged_attention_chunked.ragged_launches = 0


def _check_paged(fa, pa, what, want):
    """The launches since the last reset: each kernel's count as ``want``
    says (0 where it says nothing)."""
    got = _paged_counts(fa, pa)
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        fail(f"{what}: kernel launches {got}, want {want}")
    return got


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
    (the greedy stream, up to each row's first near tie: a top-2 gap below
    ``gap_tol``), its kernel launches against what the rounds it ran must
    launch, and, for a self-draft, every rejection against the verify
    logits: the target's logit of the rejected proposal within ``gap_tol``
    of its top logit. Returns (tokens, acceptance, seconds, rounds,
    stats)."""
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

    # -- chunked prefill against the one-shot prefill
    c1 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    llama.prefill_chunked(model, c1, prompt, 256)           # warm
    c1 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    _reset_paged(fa, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_chunk, c1 = llama.prefill_chunked(model, c1, prompt, 256)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    n_chunked = _check_paged(fa, pa, "phase k chunked prefill",
                             {"paged_attention_chunked": L * S // 256})
    c2 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_one, c2 = llama.prefill(model, c2, prompt)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    err_l = compare(l_chunk, l_one, "phase k chunked prefill logits",
                    BF16_PATH_TOL)
    # The caches are held to those of the same prompt in one chunk of S
    # (P3 both): the chunked path's page writes and chunk offsets. The
    # one-shot prefill's caches come from A1, whose bf16 body rounds
    # elsewhere than P3 (tensor cores, P in bf16); through 16 bf16 layers
    # of random weights any such difference grows to the layers' rounding
    # noise (with P kept to 16 bits the tail is the same within 20%), so
    # that distance is reported, and the last logits above hold A1
    # against P3.
    c3 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    _, c3 = llama.prefill_chunked(model, c3, prompt, S)
    err_c = max(compare(getattr(c1, n), getattr(c3, n),
                        f"phase k chunked prefill cache {n} against one "
                        f"chunk", BF16_PATH_TOL) for n in ("k", "v"))
    dist_c = max((getattr(c1, n).float() - getattr(c2, n).float()).abs()
                 .max().item() for n in ("k", "v"))
    print(f"phase k chunked prefill llama 0.77B bf16: {B} x {S} prompt in "
          f"chunks of 256, {chunk_s:.4f} s ({B * S / chunk_s:.0f} prompt "
          f"tok/s) against the one-shot prefill's {one_s:.4f} s; last "
          f"logits max abs err {err_l}, caches against one chunk {err_c} "
          f"(atol/rtol {BF16_PATH_TOL}); caches against the one-shot "
          f"prefill's (A1) max abs diff {dist_c}; launches {n_chunked} "
          f"[{card}]", flush=True)
    out["chunked_prefill"] = dict(s=chunk_s, one_shot_s=one_s,
                                  logit_err=err_l, cache_err=err_c,
                                  cache_diff_one_shot=dist_c,
                                  launches=n_chunked)
    del c1, c2, c3

    # -- decode_chunk against C decode steps, after the prompt
    c1 = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    _, c1 = llama.prefill(model, c1, prompt)
    c2 = dataclasses.replace(c1, k=c1.k.clone(), v=c1.v.clone())
    nxt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, gamma + 1), dtype=np.int32)).to(dev)
    _reset_paged(fa, pa)
    l_chunk, c1 = llama.decode_chunk(model, c1, nxt)
    _check_paged(fa, pa, "phase k decode_chunk",
                 {"paged_attention_chunked": L})
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
    _reset_paged(fa, pa)
    err_tf = teacher_forced_verify(llama, model, c1, want, want_logits,
                                   gamma + 1, "phase k teacher-forced verify",
                                   BF16_PATH_TOL)
    del c1
    _check_paged(fa, pa, "phase k teacher-forced verify",
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
    _reset_paged(fa, pa)
    logits, c8 = llama.prefill(m8, c8, prompt)
    diffs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        diffs.append((logits.float() - want_logits[:, i]).abs().max())
        logits, c8 = llama.decode_step(m8, c8, want[:, i])
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t0
    n8 = _check_paged(fa, pa, "phase k int8 serve", {
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
    _reset_paged(fa, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, st = continuous_batching(llama, model, reqs, slots, num_pages,
                                   page, table_w, dev)
    torch.cuda.synchronize()
    cb_s = time.perf_counter() - t0
    ncb = _check_paged(fa, pa, "phase k continuous batching", {
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
    (torch.float16, torch.float16, False, None),
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
    (torch.float8_e4m3fn, torch.bfloat16, False, "host"),  # the JAX layout
]
MM_SCALES = (0.5, 0.25)  # sa, sb of the scaled epilogues; sa * sb exact
# The GEMM's times before its 8-bit and 16-bit operands ran on
# wgmma (all types on mma.sync with two cp.async stages, csrc/matmul.cu),
# taken by this script on an H100 80GB HBM3 at 700 W (phase m's fastest
# tile at 4096^3, unless the key names another shape; phase n's M2);
# printed beside this run's (the kernels line carries only this run's
# numbers). M2 with B as (K, N) had no case then, nor f16 -> f16.
MMA_SYNC_MS = {"M2 e4m3 B (N, K) -> bf16": 0.499,
               "M1 e4m3 B (N, K) -> f32": 0.484,
               "M1 int8 B (N, K) -> int32": 0.2405,
               "M1 bf16 B (K, N) -> bf16": 0.4735,
               "M1 bf16 llama FFN B (K, N) -> bf16": 0.663}
# phase o: matmul_cmma's (operands, M = N = K), as examples/matmul.py; the
# 16-bit cases run on the printer's tensor-core route, f32 on its 3xTF32
# route (three TF32 products a k8 step)
CMMA_CASES = [(torch.float32, 512), (torch.bfloat16, 512),
              (torch.bfloat16, 4096), (torch.float16, 4096),
              (torch.float32, 4096)]
CMMA_16 = (torch.bfloat16, torch.float16)


def cmma_route(dtype):
    """The printed mapping of ``matmul_cmma`` on ``dtype`` operands."""
    return "cmma-wgmma" if dtype in CMMA_16 else "cmma-wgmma-tf32x3"


def printed_route(source):
    """The cmma route a printed K0 source names: the tensor-core mapping,
    or "fma"."""
    m = re.search(r"mapping=(cmma-wgmma\S*)", source)
    return m.group(1) if m else "fma"
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
    """2MNK operations at the operands' peak (f32: the lesser of the CUDA
    cores' and three TF32 products'); a and b read once, the output
    written once."""
    nbytes = (M * K + K * N) * in_dt.itemsize + M * N * out_dt.itemsize
    return bound_ms(2 * M * N * K, nbytes, in_dt, products=True)


def mm_library(a, b, out_dt, bt, epilogue):
    """(one PyTorch call computing the case's function on the same
    operands, its name), or (None, why there is none). Timed only."""
    bb = b.t() if bt else b
    if epilogue is None and a.dtype == torch.float32 \
            and out_dt == torch.float32:
        return (lambda: torch.matmul(a, bb)), "torch.matmul (TF32 off)"
    if epilogue is None and a.dtype in (torch.bfloat16, torch.float16):
        if out_dt == a.dtype:
            return (lambda: torch.matmul(a, bb)), "torch.matmul"
        return (lambda: torch.mm(a, bb, out_dtype=out_dt)), \
            "torch.mm(out_dtype=float32)"
    if a.dtype == torch.float8_e4m3fn and not bt:
        return None, ("none: torch._scaled_mm wants B column-major, "
                      "(N, K) in memory")
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


def mm_body(in_dt):
    """The GEMM body that runs ``in_dt`` operands."""
    if in_dt.itemsize == 1:
        return ("wgmma " + ("s8" if in_dt == torch.int8 else "f16 (fp8 as "
                            "exact f16)") + ", csrc/matmul8.cu")
    if in_dt == torch.float32:
        return ("wgmma tf32, three products a k8 step (3xTF32) + TMA, "
                "persistent, csrc/matmul.cu on csrc/wgmma_gemm.cuh")
    return (f"wgmma {_dt(in_dt)} + TMA, persistent, csrc/matmul.cu on "
            f"csrc/wgmma_gemm.cuh")


def _mm_what(sname, in_dt, out_dt, bt, epilogue):
    kern = "M2" if epilogue == "host" else "M1"
    scaled = {"device": " x sa*sb (device scalars)",
              "host": " x sa*sb (host floats)"}.get(epilogue, "")
    return (f"{kern} {sname} {_dt(in_dt)} B as {'(N, K)' if bt else '(K, N)'}"
            f" -> {_dt(out_dt)}{scaled}")


# launches of each phase-m tile held to plain after the first: a race
# between a kernel's warps shows in a few launches of many (the fp8 body's
# stage release once failed 1-2% of its 256 x 128 launches)
MM_REPEATS = 24


def disagreeing_launches(run, out, want, n, mask=None):
    """Of ``n`` launches of ``run`` into ``out``, those whose ``out``
    disagrees with ``want`` (exactly for int32, else outside TOL; NaN
    disagrees) where ``mask`` holds, counted on the device: (launches,
    elements)."""
    if want.dtype == torch.int32:
        lim = None
    else:
        atol, rtol = TOL[want.dtype]
        wf = want.float()
        lim = atol + rtol * wf.abs()
    bad = torch.zeros(n, dtype=torch.int64, device=out.device)
    for i in range(n):
        run()
        b = (out != want) if lim is None else \
            ~((out.float() - wf).abs() <= lim)
        bad[i] = (b if mask is None else b & mask).sum()
    bad = bad.cpu()
    return int((bad > 0).sum()), int(bad.sum())


def repeats_agree(run, o, want, what):
    """MM_REPEATS more launches of ``run`` into ``o``, each held to
    ``want`` as the first was; fails if any launch disagrees."""
    nbad, nel = disagreeing_launches(run, o, want, MM_REPEATS)
    if nbad:
        fail(f"{what}: {nbad} of {MM_REPEATS} repeated launches disagree "
             f"with plain ({nel} elements)")


def matmul_vs_plain(mm, dev, gen, card):
    """Phase m: the matmul kernel (M1, its device-scaled form, and M2)
    against its plain version at phase m's shapes, by dtype and B layout,
    every tile instance that divides the shape checked, in its first
    launch and MM_REPEATS more; the fastest
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
                repeats_agree(run, o, want, f"phase m {what} tile {tile}")
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
            shape_key = "" if (M, N, K) == (MM_S,) * 3 else (
                " llama FFN" if (M, N, K) == MM_FFN else None)
            before = MMA_SYNC_MS.get(
                f"{'M2' if epi == 'host' else 'M1'} {_dt(in_dt)}{shape_key} B "
                f"{'(N, K)' if bt else '(K, N)'} -> {_dt(out_dt)}") \
                if shape_key is not None and epi != "device" else None
            if before is not None:
                lib_txt += f"; mma.sync before: {before} ms"
            print(f"phase m {what} [{mm_body(in_dt)}]: {len(tiles)} tiles "
                  f"{agree} vs plain; "
                  f"fastest {best}: {ms:.4f} ms "
                  f"({2 * M * N * K / ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * bms / ms:.1f}% of the bound {bms:.4f} ms, {by}); "
                  f"tiles {_ranked(times, 1.0)} ms; plain {plain_ms:.4f} ms; "
                  f"library {lib_txt} [{card}]", flush=True)
            rows.append(dict(case=what, body=mm_body(in_dt),
                             tile=list(best), max_abs_err=err,
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
    headline), fp8 e4m3 4096^3, the llama FFN projection and f32 4096^3
    (the 3xTF32 body), each tuned on first use through captured CUDA
    graphs timed by CUDA events into the fresh sqlite store, each key's
    launches counted; ``matmul_scaled`` (M2) on fp8 weights given as
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
             mm_operand(gen, dev, torch.bfloat16, (fk, fn), fk), fm, fn, fk),
            (f"f32 {S}^3", x, y, S, S, S)]
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
    tuned, key_launches = [], {}
    for name, a, b, o, m, n, k in handles:
        t0 = time.perf_counter()
        n0 = mm.matmul_pallas.launches
        top = mm.autotune_top_tiles(cu, a, b, o, m, n, k, top=8)
        torch.cuda.synchronize()
        tuned.append((top, time.perf_counter() - t0))
        key_launches[name] = mm.matmul_pallas.launches - n0
    mm.matmul_scaled(cu, *m2, S, S, S, *MM_SCALES, b_transposed=True)
    t0 = time.perf_counter()
    mm.matmul_quantized(cu, *q, S, S, S)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    path_s = time.perf_counter() - t_path
    launches = {"matmul_pallas": mm.matmul_pallas.launches,
                "matmul_pallas f32 (3xTF32)": key_launches[f"f32 {S}^3"],
                "matmul_scaled": mm.matmul_scaled.launches,
                **{k: cu.server.launches[k] for k in (
                    "quantize_tensor_absmax", "quantize_tensor_values")}}
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


def cmma_sass(cu, nvcc):
    """Phase 2: each ``matmul_cmma_nd_kernel`` built for phase o, its
    route (the printed ``mapping``), the HGMMA (``wgmma``) in its SASS,
    and ptxas' registers and spills: (operand type, route, HGMMA count,
    registers, spill line) each. Fails unless every bf16/f16 kernel is on
    the tensor-core route, every f32 one on the 3xTF32 route, and every
    kernel issues HGMMA."""
    rows = []
    want = {"__nv_bfloat16": "cmma-wgmma", "__half": "cmma-wgmma",
            "float": "cmma-wgmma-tf32x3"}
    for c in cu.server._cache.values():
        if c.name != "matmul_cmma_nd_kernel" or not hasattr(c.fn, "build"):
            continue
        elem = re.search(r"const (\w+)\* __restrict__ b0", c.source).group(1)
        route = printed_route(c.source)
        n = sass_of(nvcc, c.fn.build.path).count("HGMMA")
        regs = re.search(r"Used (\d+) registers", c.fn.build.log)
        spill = re.search(r"\d+ bytes stack frame, \d+ bytes spill stores, "
                          r"\d+ bytes spill loads", c.fn.build.log)
        if route != want.get(elem):
            fail(f"phase 2: a {elem} matmul_cmma kernel printed the {route} "
                 f"route, want {want.get(elem)}")
        if not n:
            fail(f"phase 2: a {elem} matmul_cmma kernel issues no HGMMA")
        rows.append((elem, route, n, int(regs.group(1)) if regs else None,
                     spill.group(0) if spill else "no spill line"))
    if {r[0] for r in rows} != set(want):
        fail(f"phase 2: matmul_cmma kernels of {sorted({r[0] for r in rows})}"
             f", want {sorted(want)}")
    return rows


def cmma_and_quant(mm, qk, cu, ev, dev, gen, card):
    """Phase o: ``examples/matmul.py``'s DSL path, ``matmul_cmma`` through
    K0 with cmma printed as CUDA C++ (bf16 and f16 on the tensor-core
    route: ``wgmma`` from the swizzled operand fragments, a pipelined K
    loop, the accumulator in registers; f32 on the same route as three
    TF32 products a k8 step, its operands split into big and small tf32
    halves), at CMMA_CASES, each against plain and against the torch
    evaluator on the card (the counts zeroed before each case's call, read
    after), each case in MM_REPEATS more launches; then the K0 quantize
    and dequantize at both levels against their plain versions and the
    evaluator, bit for bit, each call's launches counted."""
    from cubecl_tpu_torch.std.quant import QuantLevel, QuantScheme

    ops = [(dt, S, mm_operand(gen, dev, dt, (S, S), S),
            mm_operand(gen, dev, dt, (S, S), S)) for dt, S in CMMA_CASES]
    hs = [(cu.create(a.reshape(-1)), cu.create(b.reshape(-1)),
           cu.empty((S * S,), "float32")) for _, S, a, b in ops]
    torch.cuda.synchronize()
    # each case's launches, counted from 0 around its one call
    launches = []
    for (_, S, _, _), h in zip(ops, hs):
        cu.server.reset_counts()
        mm.matmul_cmma(cu, *h, S, S, S)
        torch.cuda.synchronize()
        launches.append(dict(cu.server.launches))
        if launches[-1] != {"matmul_cmma_nd_kernel": 1}:
            fail(f"phase o: launches {launches[-1]} at {S}^3, want one "
                 "of matmul_cmma_nd_kernel")
    rows = {}
    for (dt, S, a, b), h, n in zip(ops, hs, launches):
        what = f"matmul_cmma {_dt(dt)} {S}^3 -> f32"
        e = [ev.create(a.reshape(-1)), ev.create(b.reshape(-1)),
             ev.empty((S * S,), "float32")]
        mm.matmul_cmma(ev, *e, S, S, S)
        got = h[2].tensor.view(S, S)
        want = mm.matmul_plain(a, b, torch.float32)
        err = compare(got, want, f"phase o {what} vs plain")
        err_ev = compare(got, e[2].tensor.view(S, S),
                         f"phase o {what} vs the evaluator")
        run = lambda h=h, S=S: mm.matmul_cmma(cu, *h, S, S, S)  # noqa: E731
        repeats_agree(run, got, want, f"phase o {what}")
        iters = 3 if S > 1024 else 10
        ms = cuda_ms(run, iters=iters, warmup=1)
        route = printed_route(cu.server.last_launched.source)
        if route != cmma_route(dt):
            fail(f"phase o {what}: printed the {route} route, want "
                 f"{cmma_route(dt)}")
        cold = cold_ms(run, iters=iters)
        plain_ms = cuda_ms(lambda: mm.matmul_plain(a, b, torch.float32),
                           iters=iters)
        lib_name = "torch.matmul (TF32 off)" if dt == torch.float32 else \
            "torch.mm(out_dtype=float32)"
        lib = (lambda: torch.matmul(a, b)) if dt == torch.float32 else \
            (lambda: torch.mm(a, b, out_dtype=torch.float32))
        lib_ms, lib_cold = cuda_ms(lib), cold_ms(lib, iters=iters)
        bms, by = mm_bound(S, S, S, dt, torch.float32)
        tm, tn, tk = mm._cmma_plan(S, S, S, dt.itemsize, 128)
        print(f"phase o K0 {what} (route {route}, fragments {tm}x{tn}x{tk}, "
              f"{mm.CMMA_CUBE_DIM} units a cube): max abs err {err} vs plain, "
              f"{err_ev} vs the torch evaluator (atol/rtol "
              f"{TOL[torch.float32]}), {MM_REPEATS} more launches agree"
              f"; kernel {ms:.4f} ms back to back, {cold:.4f} ms cold L2 "
              f"({2 * S ** 3 / cold / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms ({lib_cold:.4f}"
              f" cold L2), bound {bms:.4f} ms ({by}) [{card}]", flush=True)
        rows[f"{_dt(dt)} {S}^3"] = dict(
            max_abs_err=err, ms=cold, call_ms=ms, plain_ms=plain_ms,
            library_ms=lib_cold, library=lib_name, bound_ms=bms, bound_by=by,
            route=route, fragments=f"{tm}x{tn}x{tk}",
            launches=n["matmul_cmma_nd_kernel"],
            shape=f"{_dt(dt)} {S}^3 -> f32 (ms: cold L2)")
        del e
    out = {"k0_cmma": dict(rows[f"bf16 {MM_S}^3"], by_case=rows),
           "k0_cmma_f16": dict(rows[f"f16 {MM_S}^3"]),
           "k0_cmma_f32": dict(rows[f"f32 {MM_S}^3"])}

    x = torch.randn(QUANT_N, generator=gen, device=dev) * 3
    xh = cu.create(x)
    want_launches = {QuantLevel.TENSOR: {"quantize_tensor_absmax": 1,
                                         "quantize_tensor_values": 1},
                     QuantLevel.BLOCK: {"quantize_block_kernel": 1}}
    deq_launches = {"dequantize_chunk_kernel": 1}
    for scheme in (QuantScheme(), QuantScheme(level=QuantLevel.BLOCK,
                                              block_size=QUANT_BLOCK)):
        level = scheme.level.value
        cu.server.reset_counts()
        vals, scales = qk.quantize(cu, xh, scheme)
        torch.cuda.synchronize()
        n_launch = dict(cu.server.launches)
        if n_launch != want_launches[scheme.level]:
            fail(f"phase o K0 quantize {level}: launches {n_launch}, want "
                 f"{want_launches[scheme.level]}")
        cu.server.reset_counts()
        back = qk.dequantize(cu, vals, scales, scheme)
        torch.cuda.synchronize()
        d_launch = dict(cu.server.launches)
        if d_launch != deq_launches:
            fail(f"phase o K0 dequantize {level}: launches {d_launch}, want "
                 f"{deq_launches}")
        pv, ps = qk.quantize_plain(x, scheme)
        plain_back = qk.dequantize_plain(pv, ps, scheme)
        torch.cuda.synchronize()
        differ = {k: int((t != p).sum()) for k, t, p in (
            ("values", vals.tensor, pv), ("scales", scales.tensor, ps),
            ("dequantized", back.tensor, plain_back))}
        if any(differ.values()):
            fail(f"phase o K0 quantize/dequantize {level}: elements that "
                 f"differ from the plain version's bits: {differ}")
        ev_v, ev_s = qk.quantize(ev, ev.create(x), scheme)
        ev_back = qk.dequantize(ev, ev.create(vals.tensor),
                                ev.create(scales.tensor), scheme)
        differ = {k: int((t != e).sum()) for k, t, e in (
            ("values", vals.tensor, ev_v.tensor),
            ("scales", scales.tensor, ev_s.tensor),
            ("dequantized", back.tensor, ev_back.tensor))}
        if any(differ.values()):
            fail(f"phase o K0 quantize/dequantize {level}: elements that "
                 f"differ from the evaluator's bits: {differ}")
        del ev_v, ev_s, ev_back
        deq_err = (back.tensor - plain_back).abs().max().item()
        run = lambda scheme=scheme: qk.quantize(cu, xh, scheme)  # noqa: E731
        ms = cuda_ms(run, iters=10, warmup=1)
        cold = cold_ms(run)
        plain_ms = cuda_ms(lambda: qk.quantize_plain(x, scheme))
        tensor = scheme.level == QuantLevel.TENSOR
        deq = lambda scheme=scheme: qk.dequantize(  # noqa: E731
            cu, vals, scales, scheme)
        deq_cold, deq_ms = cold_ms(deq), cuda_ms(deq, iters=10, warmup=1)
        deq_plain = cuda_ms(lambda: qk.dequantize_plain(pv, ps, scheme))
        n_blocks = ps.numel()
        block = QUANT_N // n_blocks
        deq_lib = cold_ms(lambda: torch.mul(pv.view(-1, block),
                                            ps.view(-1, 1)))
        bms, by = bound_ms(2 * QUANT_N, QUANT_N * 5 + 4 * n_blocks,
                           torch.float32)
        deq_bms, deq_by = bound_ms(QUANT_N, QUANT_N * 5 + 4 * n_blocks,
                                   torch.float32)
        # two passes read x twice: the floor without L2 hits
        floor_ms = bound_ms(2 * QUANT_N, QUANT_N * 9 + 4 * n_blocks,
                            torch.float32)[0]
        kern = ("quantize_tensor_absmax + quantize_tensor_values (two "
                "passes over many cubes)" if tensor else
                "quantize_block_kernel (a cube of "
                f"{qk.block_plan(QUANT_N, QUANT_N // n_blocks)[1]} units a "
                "block)")
        print(f"phase o K0 {kern} {level} f32 4096^2 -> int8 ({n_blocks} "
              f"scales): launches {n_launch}; values and scales equal the "
              f"plain version's and the evaluator's bits; quantize "
              f"{cold:.4f} ms cold L2, {ms:.4f} ms back to back, plain "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}; "
              f"{100 * bms / cold:.1f}% of it; two reads of x "
              f"{floor_ms:.4f}) [{card}]", flush=True)
        print(f"phase o K0 dequantize_chunk_kernel {level} int8 4096^2 -> "
              f"f32 ({n_blocks} scales, {qk.dequantize_plan(QUANT_N)[0]} "
              f"cubes of {qk.DEQ_UNITS} units): launches {d_launch}; the "
              f"plain version's and the evaluator's bits; {deq_cold:.4f} ms "
              f"cold L2, {deq_ms:.4f} ms back to back, plain "
              f"{deq_plain:.4f} ms, torch.mul {deq_lib:.4f} ms cold L2, "
              f"bound {deq_bms:.4f} ms ({deq_by}; "
              f"{100 * deq_bms / deq_cold:.1f}% of it) [{card}]", flush=True)
        row = dict(max_abs_err=0.0, ms=cold, call_ms=ms, plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by, two_read_floor_ms=floor_ms,
                   launches_a_call=n_launch, dequantize_cold_ms=deq_cold,
                   shape=f"f32 4096^2 -> int8, {n_blocks} scales (ms: cold "
                         f"L2)")
        out["k0_quantize" if tensor else "k0_quantize_block"] = row
        out["k0_dequantize" if tensor else "k0_dequantize_block"] = dict(
            max_abs_err=deq_err, ms=deq_cold, call_ms=deq_ms,
            plain_ms=deq_plain, library_ms=deq_lib,
            library="torch.mul(values.view(-1, block), scales.view(-1, 1))",
            bound_ms=deq_bms, bound_by=deq_by,
            launches=d_launch["dequantize_chunk_kernel"],
            shape=f"int8 4096^2 -> f32, {n_blocks} scales (ms: cold L2)")
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
# sums, a window's sum the f32 sum of its sub-partials: the limit is 1e-6 *
# sum|x| of a window (about 1.7), and each sub-partial against the
# evaluator's 1e-6 * sum|x| of its sub-window (about 0.05; 256 threads fold
# 65536 elements, 256 serial f32 additions each); one dropped 128-element
# line moves a sum by 11 (one standard deviation)
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
        # device time with a cold L2 and the host's time hidden (back to
        # back, a small case measures the launch path: two launches
        # through ctypes against torch.sum's one)
        k = R._build_reduce_native(n, best_br, xs.dtype)
        part = torch.empty(R._native_blocks(n, best_br), device=dev)
        o = torch.empty(1, device=dev)
        cold = cold_ms(lambda: k.fn([xs, part, o]))
        lib_cold = cold_ms(lambda: torch.sum(xs, dtype=torch.float32))
        bms, by = bound_ms(n, n * xs.element_size(), torch.float32)
        gbs = n * xs.element_size() / ms / 1e6
        print(f"phase p R1 reduce_native {name} (block_rows {best_br}): "
              f"{got.item()} vs the float64 sum {xd.sum().item()} (err "
              f"{err64}, limit {lim}), vs plain {err}; kernel {ms:.4f} ms = "
              f"{gbs:.0f} GB/s, {100 * bms / ms:.1f}% of the bound "
              f"{bms:.4f} ms ({by}); by block_rows "
              f"{', '.join(f'{b}: {t:.4f}' for b, t in br_ms.items())} ms; "
              f"plain {plain_ms:.4f} ms; torch.sum(dtype=float32) "
              f"{lib_ms:.4f} ms; cold L2 (device time, host hidden): kernel "
              f"{cold:.4f} ms, torch.sum {lib_cold:.4f} ms [{card}]",
              flush=True)
        r1[name] = dict(max_abs_err=err, err_vs_float64=err64, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                        bound_by=by, gb_per_s=gbs, block_rows=best_br,
                        ms_by_block_rows=br_ms, device_ms_cold_l2=cold,
                        library_ms_cold_l2=lib_cold)
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
    # reduce_block_partial alone at reduce_sum_blockwise's plan: each of
    # the BLOCK_CUBES windows split over cubes of R.BLOCK_UNITS units, one
    # block_sum per cube over its sub-window; a window's sum is the f32 sum
    # of its sub-partials
    windows, split, sub = R.block_plan(RED_N // 128, 128, BLOCK_CUBES)
    parts = windows * split
    part = cu.empty((parts,), "float32")
    blk = lambda: R.reduce_block_partial.launch_unchecked(  # noqa: E731
        cu, parts, R.BLOCK_UNITS, array_arg(h, 128), array_arg(part, 1, True),
        sub)
    blk()
    eparts = ev.empty((parts,), "float32")
    R.reduce_block_partial.launch_unchecked(
        ev, parts, R.BLOCK_UNITS, array_arg(eh, 128),
        array_arg(eparts, 1, True), sub)
    plain_parts = xw.sum(1)
    torch.cuda.synchronize()
    if windows != BLOCK_CUBES:
        fail(f"phase p reduce_block_partial: plan {windows, split, sub}")
    blk_err = (part.tensor.view(windows, split).sum(1)
               - plain_parts).abs().max().item()
    blk_lim = BLOCK_TOL * xw.abs().sum(1).min().item()
    sub_lim = BLOCK_TOL * x.view(parts, -1).abs().sum(1).min().item()
    if blk_err > blk_lim or \
            (part.tensor - eparts.tensor).abs().max().item() > sub_lim:
        fail(f"phase p reduce_block_partial: max abs err {blk_err}")
    blk_ms = cuda_ms(blk, iters=5, warmup=1)
    blk_cold = cold_ms(blk)
    fold_cold = cold_ms(lambda: R.reduce_sum_blockwise(cu, h))
    blk_plain = cuda_ms(lambda: xw.sum(1), iters=20)
    blk_lib = cold_ms(lambda: torch.sum(xw, dim=1))
    print(f"phase p K0 routes 64M f32 (reduce_sum and reduce_max on cubes "
          f"of {R.CD} units, reduce_sum_blockwise on {parts} of "
          f"{R.BLOCK_UNITS}): "
          + "; ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f})"
                      for k, v in routes.items())
          + f"; reduce_block_partial alone: {BLOCK_CUBES} windows of "
          f"{win} elements, each split over {split} cubes of "
          f"{R.BLOCK_UNITS} units (a sub-window {sub} lines of 128, "
          f"{sub * 128} elements): {blk_ms:.4f} ms back to back, "
          f"{blk_cold:.4f} ms cold L2, with reduce_final_sum's fold "
          f"{fold_cold:.4f} ms cold L2, windows' max abs err {blk_err} vs "
          f"plain (limit {blk_lim}), torch.sum(dim=1)"
          f" {blk_lib:.4f} ms cold L2; reduce_sum_autotuned per call "
          f"({winner}) "
          f"{win_ms:.4f} ms, reduce_sum_native(block_rows={best_br}) per "
          f"call {direct_ms:.4f} ms (medians of 5 alternated; "
          f"{min(wins):.4f}-{max(wins):.4f}, {min(directs):.4f}-"
          f"{max(directs):.4f}); bound {bms:.4f} ms ({by}) [{card}]",
          flush=True)
    block = dict(max_abs_err=blk_err, ms=blk_cold, call_ms=blk_ms,
                 with_fold_ms=fold_cold, plain_ms=blk_plain,
                 library_ms=blk_lib, bound_ms=bms, bound_by=by,
                 plan=dict(windows=windows, cubes=parts,
                           units=R.BLOCK_UNITS, sub_window_lines=sub),
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
    maps = []
    for (ops, k), o in zip(FUSE_CASES, outs):
        FU.launch_fused(cu, hs[:k], o, list(ops))
        maps.append(k0_mapping(cu.server.last_launched))
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
    for (ops, k), o, plain, (mapping, vec16) in zip(FUSE_CASES, outs, plains,
                                                    maps):
        what = " -> ".join(ops)
        eo = ev.empty((FUSE_N,), "float32")
        FU.launch_fused(ev, [ev.create(t) for t in ins[:k]], eo, list(ops))
        torch.cuda.synchronize()
        err_ev = compare(o.tensor, eo.tensor, f"phase q {what} vs evaluator")
        err = compare(o.tensor, plain(), f"phase q {what} vs plain")
        ms = cold_ms(lambda: FU.launch_fused(cu, hs[:k], o, list(ops)))
        call_ms = cuda_ms(lambda: FU.launch_fused(cu, hs[:k], o, list(ops)))
        plain_ms = cuda_ms(plain)
        bms, by = bound_ms(len(ops) * FUSE_N, (k + 1) * FUSE_N * 4,
                           torch.float32)
        print(f"phase q K0 fused_chain {what} f32 16M (one launch): max abs "
              f"err {err} vs plain, {err_ev} vs the torch evaluator; kernel "
              f"{ms:.4f} ms ({(k + 1) * FUSE_N * 4 / ms / 1e6:.0f} GB/s; cold "
              f"L2; a call back to back {call_ms:.4f} ms), "
              f"plain {plain_ms:.4f} ms (eager torch ops), bound {bms:.4f} "
              f"ms ({by}); no one PyTorch call computes it; mapping "
              f"{mapping}{', 16-byte branch' if vec16 else ''} [{card}]",
              flush=True)
        rows[what] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=None,
                          mapping=mapping, vector_16_byte=vec16)
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
    S.into_contiguous(cu, th)
    c_map = k0_mapping(cu.server.last_launched)[0]
    S.identity(cu, EYE_N)
    e_map = k0_mapping(cu.server.last_launched)[0]
    print(f"phase q into_contiguous {CONTIG_VIEW} view of {CONTIG_SRC} f32 "
          f"(strides {CONTIG_STRIDES}, _copy_permuted on K0): equal to "
          f"plain; {c_ms:.4f} ms, .contiguous() {c_plain:.4f} ms, bound "
          f"{c_b:.4f} ms ({c_by}); identity({EYE_N}) (_identity_kernel): "
          f"equal to torch.eye; {e_ms:.4f} ms, torch.eye {e_plain:.4f} ms, "
          f"bound {e_b:.4f} ms ({e_by}); mappings {c_map}, {e_map} [{card}]",
          flush=True)
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


# -- phases s-w: the sparse-MoE llama (E1) and Mamba (S1) ---------------------

# phase t: the 0.77B llama of phase 5 with 8 experts, top-2 (the JAX
# default), moe_capacity 1.25 x T·k/E for 8 x 1024 prompt tokens
MOE_CFG = dict(vocab=8192, d_model=2048, n_heads=16, n_kv_heads=8,
               n_layers=16, d_ff=5632, seq=1024, dtype="bfloat16",
               use_framework_kernels=False, n_experts=8, top_k=2,
               moe_capacity=2560)
MOE_B, MOE_S, MOE_STEPS, MOE_PAGE = 8, 1024, 64, 128
# phase s: bench.py's skewed expert counts (bench.py:404-406)
SKEW_COUNTS = [2048, 1536, 1024, 512, 256, 128, 128, 64]
# phases v and w: Mamba-130M's published widths (state-spaces/mamba-130m
# config.json: d_model 768, n_layer 24, vocab 50277 padded to a multiple of
# 8, d_state 16, d_conv 4, expand 2), f32 as the JAX family
MAMBA_130M = dict(vocab=50280, d_model=768, n_layers=24, d_state=16,
                  d_conv=4, expand=2, seq=2048)
MAMBA_B, MAMBA_L, MAMBA_DECODE = 8, 2048, 32
# phase u: (name, B, L, DN); the slice's (8, 2048, d_inner 1536 x 16) and
# bench.py's (bench.py:387), one step, and a DN no multiple of 32
SCAN_CASES = [("mamba-130m", 8, 2048, 1536 * 16), ("bench", 8, 2048, 16384),
              ("B1 L1", 1, 1, 24576), ("ragged", 3, 777, 1000)]
# Mamba decode against its forward at the same positions: a recurrent step
# against a scan, f32 summed in other orders through 24 layers; the JAX
# package's own serving contract (tests/test_models.py:787-809)
DECODE_TOL = (2e-4, 1e-3)
NO_LIBRARY_SCAN = ("none: no one PyTorch call computes a first-order linear "
                   "recurrence (torch.cumsum and torch.cumprod do not compose "
                   "a decay with an input)")
DENSE_EQUIVALENT = "torch.bmm over all E·cap rows (dense equivalent)"
E1_MAIN = "prefill bf16 E8 cap2560 d2048 f5632"   # the kernels line's shape
# phase s: (name, E, cap, d, f, dtype, counts), counts a list or the number
# of tokens a random top-2 router sends through moe_dispatch
E1_CASES = [
    (E1_MAIN, 8, 2560, 2048, 5632, torch.bfloat16, MOE_B * MOE_S),
    ("skewed bf16 E8 cap2048 d4096 f4096", 8, 2048, 4096, 4096,
     torch.bfloat16, SKEW_COUNTS),
    ("decode bf16 E8 cap2560 d2048 f5632", 8, 2560, 2048, 5632,
     torch.bfloat16, MOE_B),
    # phase t's third E1 launch a layer: the down projection of a decode step
    ("decode_down bf16 E8 cap2560 d5632 f2048", 8, 2560, 5632, 2048,
     torch.bfloat16, MOE_B),
    ("f32 E4 cap2048 d768 f2048", 4, 2048, 768, 2048, torch.float32, 2048),
    ("counts cap/0/130/1 bf16 E4 cap200 d256 f384", 4, 200, 256, 384,
     torch.bfloat16, [200, 0, 130, 1]),
]
# E1's times before its bf16 body ran on wgmma (mma.sync with two cp.async
# stages, csrc/mma_tile.cuh), taken by this script on an H100 80GB HBM3 at
# 700 W (phase s); printed beside this run's (the kernels line carries only
# this run's numbers). The decode down projection had no case then.
E1_MMA_SYNC_MS = {E1_MAIN: 1.677,
                  "skewed bf16 E8 cap2048 d4096 f4096": 0.831,
                  "decode bf16 E8 cap2560 d2048 f5632": 0.2355}
# back-to-back calls that time E1's host cost
E1_HOST_CALLS = 200
# phase w: the d768 f32 llama (bench.py:604-609) with 4 experts, top-2, a
# capacity of every prompt token; (B, S, decode steps, chunk, page); and
# Mamba-130M's widths at 4 layers, (B, L)
W_LLAMA = dict(vocab=8192, d_model=768, n_heads=12, n_kv_heads=4, n_layers=8,
               d_ff=2048, seq=512, n_experts=4, top_k=2,
               use_framework_kernels=False)
W_SERVE = (8, 256, 8, 4, 128)
W_MAMBA = (4, 1024)


def expert_bound(counts, cap, d, f, dtype):
    """Bound of E1 on these counts: two operations per live row and
    (d, f) pair; bytes: the live rows of xg and out and the weights of
    every expert with a live row."""
    live = [min(max(c, 0), cap) for c in counts]
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * (sum(live) * (d + f) + sum(1 for n in live if n) * d * f)
    return bound_ms(2 * sum(live) * d * f, nbytes, dtype, products=True)


def routed(moe, gen, dev, T, E, cap, d, dtype):
    """Capacity-grouped tokens and the counts a router gives: T random
    tokens through a random (d, E) router, top-2, ``moe_dispatch``.
    Returns (xg, counts, routes dropped)."""
    x = torch.randn(T, d, generator=gen, device=dev).to(dtype)
    router = (torch.randn(d, E, generator=gen, device=dev) * 0.02).to(dtype)
    xg, _g, _s, _e, counts, live = moe.moe_dispatch(x, x @ router, 2, cap)
    return xg, counts, int((~live).sum())


def experts_vs_plain(moe, dev, gen, card):
    """Phase s: E1 against ``expert_matmul_plain`` on the live rows, each
    case of E1_CASES with its time, bound, plain time and the
    dense-equivalent ``torch.bmm``."""
    rows = {}
    for name, E, cap, d, f, dtype, spec in E1_CASES:
        if isinstance(spec, int):
            xg, counts, drops = routed(moe, gen, dev, spec, E, cap, d, dtype)
        else:
            xg = (torch.randn(E, cap, d, generator=gen, device=dev)
                  * .1).to(dtype)
            counts = torch.tensor(spec, dtype=torch.int32, device=dev)
            drops = 0
        w = (torch.randn(E, d, f, generator=gen, device=dev) * .02).to(dtype)
        got = moe.expert_matmul(xg, w, counts)
        torch.cuda.synchronize()
        ref = moe.expert_matmul_plain(xg, w, counts)
        cl = counts.tolist()
        err = max([compare(got[e, :n], ref[e, :n], f"E1 {name} expert {e}")
                   for e, n in enumerate(cl) if n] + [0.0])
        del got, ref
        big = cap * d * f > 1 << 30
        ms = cuda_ms(lambda: moe.expert_matmul(xg, w, counts))
        plain_ms = cuda_ms(lambda: moe.expert_matmul_plain(xg, w, counts),
                           iters=3 if big else 10, warmup=1)
        lib_ms = cuda_ms(lambda: torch.bmm(xg, w))
        bms, by = expert_bound(cl, cap, d, f, dtype)
        # host time: E1_HOST_CALLS calls enqueued back to back, the host's
        # clock read before the queue drains and after
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(E1_HOST_CALLS):
            moe.expert_matmul(xg, w, counts)
        host_ms = 1e3 * (time.perf_counter() - t0) / E1_HOST_CALLS
        torch.cuda.synchronize()
        b2b_ms = 1e3 * (time.perf_counter() - t0) / E1_HOST_CALLS
        before = E1_MMA_SYNC_MS.get(name)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bms, bound_by=by,
                          counts=cl, routes_dropped=drops,
                          host_ms_per_call=host_ms,
                          back_to_back_ms_per_call=b2b_ms)
        print(f"phase s E1 {name}: counts {cl} ({drops} routes dropped), max "
              f"abs err {err} (atol/rtol {TOL[dtype]}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, {DENSE_EQUIVALENT} {lib_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of it); "
              f"host {host_ms:.4f} ms a call, {b2b_ms:.4f} ms a call back to "
              f"back against {ms:.4f} of device time"
              f"{f'; mma.sync before: {before} ms' if before else ''} "
              f"[{card}]", flush=True)
        del xg, w, counts
    torch.cuda.empty_cache()
    return rows


def serve_moe(llama, moe, fa, pa, dev, card):
    """Phase t: the 0.77B MoE llama (bf16, 8 experts, top-2, capacity
    2560) through ``generate``: 8 x 1024 prompt and 64 greedy steps on the
    sparse route, 3 E1 launches a layer per forward (3 x 16 x 65); a warm
    re-run timed in its two phases; the sparse route against the dense one
    (``moe_capacity = 0``) layer by layer on untied tokens, and end to end
    where no router logit tied; the routes the capacity dropped."""
    cfg = llama.LlamaConfig(**MOE_CFG)
    model = llama.init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    B, S, steps, page = MOE_B, MOE_S, MOE_STEPS, MOE_PAGE
    max_pages = math.ceil((S + steps) / page)
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    moe.expert_matmul.launches = 0
    fa.flash_attention.launches = 0
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    toks = llama.generate(model, prompt, steps, max_pages, page)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {"expert_matmul": moe.expert_matmul.launches,
                "flash_attention": fa.flash_attention.launches,
                "paged_attention": pa.paged_attention.launches}
    want = {"expert_matmul": 3 * cfg.n_layers * (steps + 1),
            "flash_attention": cfg.n_layers,
            "paged_attention": cfg.n_layers * steps}
    if launches != want:
        fail(f"phase t: kernel launches {launches}, want {want}")
    if toks.shape != (B, steps) or not ((toks >= 0)
                                        & (toks < cfg.vocab)).all():
        fail(f"phase t: bad tokens {toks.shape} {toks.dtype}")

    # warm re-run, timed in its two phases; the prefill's dispatches are
    # recorded to count the routes the capacity dropped
    log = []
    undo = recording(llama, "moe_dispatch", log)
    cache = llama.init_kv_cache(cfg, B, max_pages, page, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        logits, cache = llama.prefill(model, cache, prompt)
        torch.cuda.synchronize()
    finally:
        undo()
    prefill_s = time.perf_counter() - t0
    dropped = int(sum(int((~out[5]).sum()) for _args, out in log))
    sparse = logits.float()
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
        fail("phase t: the warm re-run gave other tokens than generate")
    del cache

    # the sparse route against the dense one, layer by layer on the sparse
    # prefill's own FFN inputs: where a token's k-th and (k+1)-th bf16 router
    # logits tie, the dense route keeps both (the JAX semantics), so tied
    # tokens are counted and left out; within a layer the two routes round
    # otherwise by a few bf16 ulps (CHAIN_TOL); a token with a dropped
    # route is left out too
    k, ties, layer_err = cfg.top_k, 0, 0.0
    for li, (args, dispatched) in enumerate(log):
        xf, router_logits = args[0], args[1]
        vals = moe.top_k_stable(router_logits, k + 1)[0]
        untied = vals[:, k - 1] != vals[:, k]
        ties += int((~untied).sum())
        keep = untied & dispatched[5].all(-1)
        layer = model.layers[li]
        layer_err = max(layer_err, compare(
            llama._moe_sparse(xf, layer, cfg, True)[keep],
            llama._moe_dense(xf, layer, cfg)[keep],
            f"phase t: layer {li} sparse against dense FFN", CHAIN_TOL))
    del log
    # end to end: each tie perturbs a token's residual stream by a third
    # expert, which 16 random bf16 layers carry far past rounding, so the
    # prefill logits are held at BF16_PATH_TOL only where no token tied
    # and no route was dropped
    model.cfg = dataclasses.replace(cfg, moe_capacity=0)
    dense = llama.prefill(model, llama.init_kv_cache(model.cfg, B, max_pages,
                                                     page, dev), prompt)[0]
    if ties == 0 and dropped == 0:
        err = compare(sparse, dense.float(), "phase t: sparse against dense "
                      "prefill logits", BF16_PATH_TOL)
    else:
        err = (sparse - dense.float()).abs().max().item()
    held = (f"held at {BF16_PATH_TOL}" if ties + dropped == 0 else
            "not held: ties or drops")
    out = dict(launches=launches, prefill_s=prefill_s,
               decode_ms=1e3 * decode_s / steps,
               decode_tok_s=B * steps / decode_s, dropped=dropped,
               ties=ties, layer_err=layer_err, sparse_vs_dense_err=err)
    print(f"phase t serve MoE llama {n_params / 1e9:.3f}B bf16 (d2048, 16 "
          f"layers, 8 experts top-2, capacity {cfg.moe_capacity}): {B} "
          f"requests x {S} prompt + {steps} greedy steps; generate "
          f"{gen_s:.3f} s cold; launches {launches}; warm prefill "
          f"{prefill_s:.4f} s ({B * S / prefill_s:.0f} prompt tok/s), decode "
          f"{out['decode_tok_s']:.1f} tok/s ({out['decode_ms']:.3f} ms/step); "
          f"sparse against dense FFN, layer by layer on untied tokens, max "
          f"abs err {layer_err} (atol/rtol {CHAIN_TOL}); {ties} of "
          f"{B * S * cfg.n_layers} token-layers tied at the k-th router "
          f"logit; prefill logits sparse against dense max abs err {err} "
          f"({held}); {dropped} of {2 * B * S * cfg.n_layers} prefill routes dropped "
          f"by the capacity [{card}]", flush=True)
    del model, logits, dense, sparse
    torch.cuda.empty_cache()
    return out


def scan_vs_plain(ssm, dev, gen, card):
    """Phase u: S1 against ``scan_chunked_core_plain`` (f32), with its time,
    bound (3 array passes) and plain time; no library call computes it."""
    rows = {}
    for name, B, L, DN in SCAN_CASES:
        af = torch.exp(-torch.rand(B, L, DN, generator=gen, device=dev)) * .9
        uf = torch.randn(B, L, DN, generator=gen, device=dev) * .1
        got = ssm.scan_chunked_core(af, uf)
        torch.cuda.synchronize()
        what = f"S1 {name} f32 ({B}, {L}, {DN})"
        err = compare(got, ssm.scan_chunked_core_plain(af, uf), what)
        ms = cuda_ms(lambda: ssm.scan_chunked_core(af, uf))
        plain_ms = cuda_ms(lambda: ssm.scan_chunked_core_plain(af, uf),
                           iters=2 if L > 1 else 10, warmup=1)
        bms, by = bound_ms(2 * B * L * DN, 3 * B * L * DN * 4, torch.float32)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by,
                          gb_per_s=3 * B * L * DN * 4 / ms / 1e6)
        print(f"phase u {what}: max abs err {err} (atol/rtol "
              f"{TOL[torch.float32]}); kernel {ms:.4f} ms "
              f"({rows[name]['gb_per_s']:.0f} GB/s), plain {plain_ms:.4f} ms,"
              f" bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of it); "
              f"library: none [{card}]", flush=True)
        del af, uf, got
    torch.cuda.empty_cache()
    return rows


def serve_mamba(mamba, ssm, dev, card):
    """Phase v: Mamba at Mamba-130M's widths, f32: ``forward`` at B 8 x L
    2048 through S1 (one launch a layer, 24), timed warm; then 32
    ``decode_step``s teacher-forced on the prompt, their logits held
    against the forward's at the same positions (DECODE_TOL)."""
    cfg = mamba.MambaConfig(**MAMBA_130M)
    model = mamba.init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    B, L = MAMBA_B, MAMBA_L
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (B, L), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    ssm.scan_chunked_core.launches = 0
    torch.cuda.reset_peak_memory_stats()
    logits = mamba.forward(model, tokens)
    torch.cuda.synchronize()
    launches = ssm.scan_chunked_core.launches
    if launches != cfg.n_layers:
        fail(f"phase v: {launches} S1 launches in forward, want "
             f"{cfg.n_layers}")
    if logits.shape != (B, L, cfg.vocab) or not torch.isfinite(logits).all():
        fail(f"phase v: bad logits {tuple(logits.shape)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    again = mamba.forward(model, tokens)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    if not torch.equal(again, logits):
        fail("phase v: a second forward gave other logits")
    del again
    state = mamba.decode_init(cfg, B, device=dev)
    step_logits = []
    t0 = time.perf_counter()
    for t in range(MAMBA_DECODE):
        lg, state = mamba.decode_step(model, state, tokens[:, t])
        step_logits.append(lg)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    err = max(compare(lg, logits[:, t], f"phase v: decode step {t} against "
                      "forward", DECODE_TOL)
              for t, lg in enumerate(step_logits))
    out = dict(launches=launches, forward_s=fwd_s, tok_s=B * L / fwd_s,
               decode_ms=1e3 * dec_s / MAMBA_DECODE, decode_err=err,
               peak_gib=peak)
    print(f"phase v Mamba {n_params / 1e6:.1f}M f32 (Mamba-130M widths: "
          f"d768, 24 layers, d_state 16, expand 2, vocab {cfg.vocab}): "
          f"forward B{B} x L{L} {fwd_s:.4f} s warm ({out['tok_s']:.0f} tok/s)"
          f", {launches} S1 launches, peak {peak:.2f} GiB; {MAMBA_DECODE} "
          f"teacher-forced decode steps {out['decode_ms']:.3f} ms/step, "
          f"logits against forward max abs err {err} (atol/rtol "
          f"{DECODE_TOL}) [{card}]", flush=True)
    del model, logits, state, step_logits
    torch.cuda.empty_cache()
    return out


def moe_exactness(llama, fa, dev, card):
    """Phase w (llama): the d768 f32 llama (bench.py:604-609) with 4
    experts, top-2 and a capacity of every prompt token (no route can be
    dropped): the sparse route on E1, its plain version and the dense route
    through ``prefill``, 8 teacher-forced ``decode_step``s and a
    ``decode_chunk`` of 4, logits within LOGIT_TOL; each route's greedy
    tokens equal the kernels' up to a near tie."""
    B, S, steps, C, page = W_SERVE
    cfg = llama.LlamaConfig(**W_LLAMA, moe_capacity=B * S)
    model = llama.init_params(cfg, seed=3, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    max_pages = math.ceil((S + steps + C) / page)
    feed = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (B, steps + C), dtype=np.int32)).to(dev)

    def serve(kernels):
        cache = llama.init_kv_cache(cfg, B, max_pages, page, dev)
        lg, cache = llama.prefill(model, cache, prompt, kernels=kernels)
        out = [lg[:, None]]
        for t in range(steps):
            lg, cache = llama.decode_step(model, cache, feed[:, t],
                                          kernels=kernels)
            out.append(lg[:, None])
        out.append(llama.decode_chunk(model, cache, feed[:, steps:],
                                      kernels=kernels)[0])
        return torch.cat(out, 1).float()             # (B, 1 + steps + C, V)

    fa.flash_attention.launches = 0
    kern = serve(True)
    hd64_launches = fa.flash_attention.launches
    plain = serve(False)
    model.cfg = dataclasses.replace(cfg, moe_capacity=0)
    dense = serve(True)
    torch.cuda.synchronize()
    errs = {}
    for name, ref in (("plain E1", plain), ("dense route", dense)):
        errs[name] = compare(kern, ref, f"phase w: sparse on E1 against "
                             f"{name}", (LOGIT_TOL, 0.0))
        tie_prefix(ref.argmax(-1), kern.argmax(-1), kern, LOGIT_TOL,
                   f"phase w: greedy tokens against {name}")
    print(f"phase w MoE llama d768 f32 (8 layers, 4 experts top-2, capacity "
          f"{cfg.moe_capacity}): {B} x {S} prefill, {steps} decode steps and "
          f"a chunk of {C}, sparse on E1 against plain E1 max abs err "
          f"{errs['plain E1']}, against the dense route {errs['dense route']}"
          f" (tol {LOGIT_TOL}); greedy tokens equal up to near ties; "
          f"{hd64_launches} flash launches at head_dim 64 (A8) [{card}]",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return dict(errs, hd64_flash_launches=hd64_launches)


def mamba_exactness(mamba, dev, card):
    """Phase w (Mamba): Mamba-130M's widths at 4 layers, f32, W_MAMBA:
    ``forward`` with S1 against S1's plain version (the same recurrence,
    one fused multiply-add apart) and against the doubling scan."""
    cfg = mamba.MambaConfig(**dict(MAMBA_130M, n_layers=4))
    model = mamba.init_params(cfg, seed=4, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, W_MAMBA, dtype=np.int32)).to(dev)
    kern = mamba.forward(model, tokens)
    plain = mamba.forward(model, tokens, kernels=False)
    model.cfg = dataclasses.replace(cfg, scan_impl="assoc")
    assoc = mamba.forward(model, tokens)
    torch.cuda.synchronize()
    e_plain = compare(kern, plain, "phase w: Mamba S1 against plain")
    # the doubling scan associates the recurrence otherwise: DECODE_TOL
    e_assoc = compare(kern, assoc, "phase w: Mamba S1 against the doubling "
                      "scan", DECODE_TOL)
    print(f"phase w Mamba-130M widths, 4 layers, f32, B{W_MAMBA[0]} x L"
          f"{W_MAMBA[1]}: S1 against "
          f"plain max abs err {e_plain} (atol/rtol {TOL[torch.float32]}), "
          f"against the doubling scan {e_assoc} (atol/rtol {DECODE_TOL}) "
          f"[{card}]", flush=True)
    del model, kern, plain, assoc
    torch.cuda.empty_cache()
    return dict(plain=e_plain, assoc=e_assoc)



# -- phases x-y: block-sparse attention (A5-A7) and the small-channel conv (C1)

# phase x: the 0.77B llama's attention widths (16 heads of 128), long-context
# training at B 1 x S 8192 with the JAX default block 512, causal
BSP_MAIN = dict(B=1, H=16, S=8192, D=128, dtype=torch.bfloat16, block=512)
# then at S 1024: (name, H, D, dtype, causal, block_q, block_k, mask)
BSP_CASES = [
    ("f32 D64 non-causal band", 16, 64, torch.float32, False, 128, 128,
     "band"),
    ("bf16 random block 128, kv tile 3 empty", 16, 128, torch.bfloat16, True,
     128, 128, "holed"),
    ("bf16 bq 128 x bk 64, F9 rows", 16, 128, torch.bfloat16, True, 128, 64,
     "f9"),
]
# phase y: ResNet-50's conv2_x 3x3 (bench.py:366-370) and bench.py:348's
# fat-channel conv
CONV_MAIN = (32, 56, 56, 64, 64)
CONV_FAT = (16, 28, 28, 256, 256)
STACK_TOL = 0.15  # examples/conv_pairs.py's bound on the bf16 stack
# C1's times before its bodies ran on wgmma (both dtypes on the f32 CUDA
# cores), taken by this script on an H100 80GB HBM3 at 700 W; printed
# beside this run's
CUDA_CORE_C1_MS = {"bf16 32x56x56x64->64": 0.3694,
                   "f32 32x56x56x64->64": 0.3769,
                   "bf16 1x6x10x32->48": 0.042, "stack": 1.16}
LIB_CONV_TOL = {torch.float32: (1e-4, 1e-3)}


def bsp_mask(kind, n_q, n_kv):
    """Block masks of phase x: "band" (examples/attention.py's BigBird
    style: the band i-1..i and the global tile 0), "holed" (random tiles,
    the diagonal, tile 0, and kv tile 3 attended by no q tile) and "f9"
    (q tile 0 attends only kv tile 1: with bq > bk its first rows see no
    live column, ROADMAP Queue 3 F9)."""
    bm = np.zeros((n_q, n_kv), bool)
    if kind == "band":
        for i in range(n_q):
            j = i * n_kv // n_q
            bm[i, max(0, j - 1):j + 1] = True
            bm[i, 0] = True
    elif kind == "holed":
        bm = np.random.default_rng(3).random((n_q, n_kv)) < 0.3
        for i in range(n_q):
            bm[i, i * n_kv // n_q] = True
        bm[:, 0] = True
        bm[:, 3] = False
    else:
        bm[:] = True
        bm[0] = False
        bm[0, 1] = True
    return bm


def live_pairs(bm, bq, bk, causal):
    """(row, column) pairs of one head whose score is live: in an active
    tile of the pruned mask and, if causal, col <= row."""
    if not causal:
        return int(bm.sum()) * bq * bk
    total = 0
    for qi, ki in zip(*np.nonzero(bm)):
        rows = np.arange(qi * bq, (qi + 1) * bq)
        total += int(np.clip(rows - ki * bk + 1, 0, bk).sum())
    return total


def bsp_bounds(pairs, B, H, S, D, dtype):
    """Bounds of A5, A6, A7 on these live pairs: 2, 3 and 4 matrix products
    a pair and head; bytes: q, k, v and o, (q, k, v, do) -> dq, (q, k, v,
    do) -> (dk, dv), each (B, H, S, D), and the f32 (B, H, S) lse (and di)."""
    elem = torch.finfo(dtype).bits // 8
    t = elem * B * H * S * D
    st = 4 * B * H * S
    return {"fwd": bound_ms(4 * D * pairs * B * H, 4 * t + st, dtype, True),
            "dq": bound_ms(6 * D * pairs * B * H, 5 * t + 2 * st, dtype,
                           True),
            "dkv": bound_ms(8 * D * pairs * B * H, 6 * t + 2 * st, dtype,
                            True)}


def _bsp_launches(fa):
    return {"bsp_forward": fa.bsp_forward.launches,
            "bsp_dq": fa.bsp_dq.launches, "bsp_dkv": fa.bsp_dkv.launches}


def bsp_case(fa, dev, gen, card, name, B, H, S, D, dt, causal, bq, bk, kind,
             timed, phase="x", beside=None):
    """One block-sparse case: forward and backward through autograd (A5,
    A6, A7 once each, counted from 0), then each kernel against the plain
    version on the kernel's own o and lse; with ``timed`` each kernel's
    time, the plain versions' and SDPA's with the element mask as a bool
    (1, 1, S, S) ``attn_mask`` (it does the dense work). A D the kernels
    are not built at runs padded with zeros to the next of
    ``fa.SPARSE_HEAD_DIMS``, as ``flash_attention_block_sparse`` pads it:
    the kernels are called on the padded tensors and their outputs sliced
    to D; plain versions and SDPA run at the real D, and the bounds are
    given at both. With ``beside`` (a head dim) or in f32, and ``timed``,
    each kernel also with a cold L2 (``cold_ms``) and its share of the
    bound; with ``beside``, beside the same call at that D
    (``d{beside}_cold_ms``)."""
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
                   for _ in range(4))
    Dp = next(d for d in fa.SPARSE_HEAD_DIMS if D <= d)
    qp, kp, vp, dop = (TF.pad(t, (0, Dp - D)) if Dp != D else t
                       for t in (q, k, v, do))
    bq_, bk_ = fa._fit_block(bq, S), fa._fit_block(bk, S)
    bm = bsp_mask(kind, S // bq_, S // bk_)
    what = (f"{name}: {_dt(dt)} B{B} H{H} S{S} D{D}"
            f"{f' (padded to {Dp})' if Dp != D else ''} blocks {bq_}x{bk_} "
            f"{'causal' if causal else 'non-causal'}")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.bsp_forward.launches = fa.bsp_dq.launches = fa.bsp_dkv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fa.flash_attention_block_sparse(*leaves, bm, causal, None, bq, bk)
    out.backward(do)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = _bsp_launches(fa)
    if launches != {"bsp_forward": 1, "bsp_dq": 1, "bsp_dkv": 1}:
        fail(f"phase {phase} {what}: kernel launches {launches}, want one "
             "each")
    pruned = fa._pruned_mask(bm, causal, bq_, bk_, S // bq_, S // bk_)
    sched = fa._schedule(pruned, bq_, bk_, dev)
    scale = D ** -0.5
    o_p, lse = fa.bsp_forward(qp, kp, vp, sched, causal, scale, bq_, bk_,
                              True)
    o = o_p[..., :D]
    o_ref, lse_ref = fa.flash_attention_block_sparse_plain(
        q, k, v, bm, causal, None, bq, bk, return_lse=True)
    torch.cuda.synchronize()
    err_o = compare(o, o_ref, f"phase {phase} {what}: o")
    err_lse = compare(lse, lse_ref, f"phase {phase} {what}: lse",
                      TOL[torch.float32])
    if not torch.equal(out.detach(), o):
        fail(f"phase {phase} {what}: the autograd forward is not A5's")
    # di as the autograd Function takes it, from the padded do and o
    di = (dop.float() * o_p.float()).sum(-1)
    dq = fa.bsp_dq(qp, kp, vp, dop, lse, di, sched, causal, scale, bq_,
                   bk_)[..., :D]
    dk, dv = (t[..., :D] for t in fa.bsp_dkv(qp, kp, vp, dop, lse, di, sched,
                                             causal, scale, bq_, bk_))
    exact, rounded = (fa.flash_attention_block_sparse_backward_plain(
        q, k, v, o, lse, do, bm, causal, None, bq, bk, round_p_ds=rnd)
        for rnd in (False, True))
    torch.cuda.synchronize()
    err_r, err, need = zip(*(compare_bwd(a, r, e,
                                         f"phase {phase} {what}: d{n}")
                             for n, a, r, e in zip("qkv", (dq, dk, dv),
                                                   rounded, exact)))
    if not all(torch.equal(t.grad, a) for t, a in zip(leaves, (dq, dk, dv))):
        fail(f"phase {phase} {what}: the autograd Function's grads are not "
             "the kernels'")
    empty = np.nonzero(~pruned.any(0))[0]
    for ki in empty:
        if dk[:, :, ki * bk_:(ki + 1) * bk_].any() \
                or dv[:, :, ki * bk_:(ki + 1) * bk_].any():
            fail(f"phase {phase} {what}: kv tile {ki}, attended by no q "
                 "tile, has non-zero dk or dv")
    f9 = ""
    if kind == "f9":  # rows 0..bk-1 see only masked columns: the mean of V
        mean = v[:, :, bk_:2 * bk_].float().mean(2, keepdim=True)
        e9 = compare(o[:, :, :bk_], mean.expand(B, H, bk_, D).to(dt),
                     f"phase {phase} {what}: F9 rows against the mean of V")
        if dq[:, :, :bk_].any():
            fail(f"phase {phase} {what}: F9 rows have a non-zero dq")
        f9 = f"; F9 rows: o = mean of V over their columns ({e9}), dq = 0"
    row = dict(max_abs_err=max(err_o, *err), o_err=err_o, lse_err=err_lse,
               dq_err=err[0], dkv_err=max(err[1:]), dq_err_rounded=err_r[0],
               dkv_err_rounded=max(err_r[1:]), launches=launches,
               path_s=path_s, mask_tiles=int(pruned.sum()),
               empty_kv_tiles=len(empty), head_dim=D, kernel_head_dim=Dp)
    msg = ""
    if timed:
        pairs = live_pairs(pruned, bq_, bk_, causal)
        bounds = bsp_bounds(pairs, B, H, S, D, dt)
        padded = bsp_bounds(pairs, B, H, S, Dp, dt)
        row.update(
            live_pairs_per_head=pairs,
            fwd_ms=cuda_ms(lambda: fa.bsp_forward(qp, kp, vp, sched, causal,
                                                  scale, bq_, bk_, True)),
            dq_ms=cuda_ms(lambda: fa.bsp_dq(qp, kp, vp, dop, lse, di, sched,
                                            causal, scale, bq_, bk_)),
            dkv_ms=cuda_ms(lambda: fa.bsp_dkv(qp, kp, vp, dop, lse, di,
                                              sched, causal, scale, bq_,
                                              bk_)),
            plain_fwd_ms=cuda_ms(
                lambda: fa.flash_attention_block_sparse_plain(
                    q, k, v, bm, causal, None, bq, bk, return_lse=True),
                iters=5, warmup=1),
            plain_bwd_ms=cuda_ms(
                lambda: fa.flash_attention_block_sparse_backward_plain(
                    q, k, v, o, lse, do, bm, causal, None, bq, bk),
                iters=5, warmup=1),
            bounds={k_: dict(zip(("bound_ms", "bound_by"), b))
                    for k_, b in bounds.items()})
        if Dp != D:
            row["bounds_at_padded_d"] = {
                k_: dict(zip(("bound_ms", "bound_by"), b))
                for k_, b in padded.items()}
        el = np.kron(pruned, np.ones((bq_, bk_), bool))
        if causal:
            el &= np.tril(np.ones((S, S), bool))
        el = torch.from_numpy(el).to(dev)[None, None]
        sdpa = lambda q_, k_, v_: TF.scaled_dot_product_attention(  # noqa
            q_, k_, v_, attn_mask=el)
        row["library_fwd_ms"] = cuda_ms(lambda: sdpa(q, k, v))
        row["library_bwd_ms"] = cuda_ms(grad_call(sdpa, (q, k, v), do))
        del el
        if beside or dt == torch.float32:
            def three(q_, k_, v_, do_, lse_, di_, sc_):
                return {"fwd": cold_ms(lambda: fa.bsp_forward(
                            q_, k_, v_, sched, causal, sc_, bq_, bk_, True)),
                        "dq": cold_ms(lambda: fa.bsp_dq(
                            q_, k_, v_, do_, lse_, di_, sched, causal, sc_,
                            bq_, bk_)),
                        "dkv": cold_ms(lambda: fa.bsp_dkv(
                            q_, k_, v_, do_, lse_, di_, sched, causal, sc_,
                            bq_, bk_))}

            row["cold_ms"] = three(qp, kp, vp, dop, lse, di, scale)
        if beside:
            qb, kb, vb, dob = (torch.randn(B, H, S, beside, generator=gen,
                                           device=dev).to(dt)
                               for _ in range(4))
            ob, lseb = fa.bsp_forward(qb, kb, vb, sched, causal,
                                      beside ** -0.5, bq_, bk_, True)
            row[f"d{beside}_cold_ms"] = three(
                qb, kb, vb, dob, lseb, (dob.float() * ob.float()).sum(-1),
                beside ** -0.5)
            del qb, kb, vb, dob, ob, lseb

        def bound(what_):
            b = f"bound {bounds[what_][0]:.4f}"
            if Dp != D:
                b += f", at D {Dp} {padded[what_][0]:.4f}"
            return b

        msg = (f"; live pairs a head {pairs}; A5 {row['fwd_ms']:.4f} ms "
               f"({bound('fwd')}, {bounds['fwd'][1]}), A6 "
               f"{row['dq_ms']:.4f} ms ({bound('dq')}"
               + (f"; on the CUDA cores, a constant from an earlier run, "
                  f"{CUDA_CORE_BWD_MS['A6']}" if phase == "x"
                  and name == "main" else "")
               + f"), A7 {row['dkv_ms']:.4f} ms ({bound('dkv')}"
               + (f"; on the CUDA cores, the same, "
                  f"{CUDA_CORE_BWD_MS['A7']}" if phase == "x"
                  and name == "main" else "")
               + f"); plain forward {row['plain_fwd_ms']:.4f} ms, backward "
               f"{row['plain_bwd_ms']:.4f} ms; SDPA with the element mask "
               f"forward {row['library_fwd_ms']:.4f} ms, backward "
               f"{row['library_bwd_ms']:.4f} ms"
               + ("; cold L2: A5 / A6 / A7 " + " / ".join(
                   f"{row['cold_ms'][w]:.4f}" for w in ("fwd", "dq", "dkv"))
                  + " ms (" + " / ".join(
                      f"{100 * bounds[w][0] / row['cold_ms'][w]:.1f}%"
                      for w in ("fwd", "dq", "dkv")) + " of the bounds)"
                  if "cold_ms" in row else "")
               + (f", the same calls at D {beside} " + " / ".join(
                   f"{row[f'd{beside}_cold_ms'][w]:.4f}"
                   for w in ("fwd", "dq", "dkv")) + " ms" if beside else ""))
    print(f"phase {phase} {what}: {int(pruned.sum())} live tiles, "
          f"{len(empty)} kv tiles attended by none; launches {launches}, "
          f"forward + backward {path_s:.4f} s; max abs err o {err_o}, lse "
          f"{err_lse}; dq, dk, dv against the plain backward that rounds p "
          f"and dS as the kernels do {err_r[0]}, {err_r[1]}, {err_r[2]} "
          f"(atol/rtol {TOL[dt]}), against the exact one {err[0]}, "
          f"{err[1]}, {err[2]} (atol/rtol {EXACT_BWD_TOL[dt]}; the atol each "
          f"needs there, kernel and rounding plain: {need[0]}, {need[1]}, "
          f"{need[2]}){f9}{msg} [{card}]", flush=True)
    del q, k, v, do, qp, kp, vp, dop, leaves, out, o, o_p, lse, dq, dk, dv
    del exact, rounded
    torch.cuda.empty_cache()
    return row


def block_sparse(fa, dev, gen, card):
    """Phase x: ``flash_attention_block_sparse`` forward and backward at the
    0.77B llama's attention widths (BSP_MAIN, the band mask), each kernel
    against plain with its time, bound and SDPA's; the S 1024 cases; then A1,
    A3 and A4 re-timed at phases 3 and d's main shapes (the dense instances
    of the tile bodies they share with A5-A7)."""
    m = BSP_MAIN
    rows = {"main": bsp_case(fa, dev, gen, card, "main", m["B"], m["H"],
                             m["S"], m["D"], m["dtype"], True, m["block"],
                             m["block"], "band", True)}
    for name, H, D, dt, causal, bq, bk, kind in BSP_CASES:
        # the f32 case timed: A5 and A7 on the 3xTF32 bodies
        rows[name] = bsp_case(fa, dev, gen, card, name, 1, H, 1024, D, dt,
                              causal, bq, bk, kind, dt == torch.float32)
    def randn(H, S):
        return torch.randn(8, H, S, 128, generator=gen,
                           device=dev).to(torch.bfloat16)

    q, k, v = randn(16, 1024), randn(8, 1024), randn(8, 1024)
    dense = {"A1": cuda_ms(lambda: fa.flash_attention(q, k, v, True))}
    a1_tf = attn_flops(8, 16, 1024, 1024, 128, True) / 1e9 / dense["A1"]
    q, do, k, v = randn(16, 1023), randn(16, 1023), randn(8, 1023), \
        randn(8, 1023)
    o, lse = fa._flash_forward(q, k, v, True, None, True)
    di = (do.float() * o.float()).sum(-1)
    dense["A3"] = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di))
    dense["A4"] = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, di))
    print("phase x dense instances of the shared tile bodies: " + "; ".join(
        f"{n} {t:.4f} ms" for n, t in dense.items())
        + f" (A1: bf16 B8 H16/8 S1024 D128 causal, {a1_tf:.1f} TFLOP/s; "
        f"A3, A4: S1023, on the CUDA cores, constants from an earlier run, "
        f"{CUDA_CORE_BWD_MS['A3']}, {CUDA_CORE_BWD_MS['A4']}) [{card}]",
        flush=True)
    rows["dense_ms"] = dense
    del q, k, v, do, o, lse, di
    torch.cuda.empty_cache()
    return rows


def convolutions(conv, ex_conv, cu, dev, gen, card):
    """Phase y: C1 against plain at ResNet-50's conv2_x shape in bf16 and
    f32 and at (1, 6, 10, 32) -> 48 (padded lanes), with its time, bound and
    ``F.conv2d``'s (channels_last); the example's three-layer packed stack
    (C1's path, launches counted from 0) against F.conv2d + ReLU;
    ``conv2d_autotuned`` at CONV_MAIN (native against pairs) and CONV_FAT
    (native against im2col on M1), each candidate's time and the winner, and
    each candidate called alone on the same handles against F.conv2d.
    C1's launch plans in ``ops/conv.py`` are held to the built kernel's at
    every shape of the phase, both dtypes."""
    N_, H_, W_, _ = ex_conv.CARD_SHAPE
    for dt in conv.C1_DTYPES:
        for n, h, w in [CONV_MAIN[:3], (1, 6, 10), (N_, H_, W_),
                        CONV_FAT[:3]]:
            plan = conv.c1_kernel_plan(dt, n, h, w)
            if plan != conv.c1_plan(dt, n, h, w):
                fail(f"phase y: C1's launch plan in ops/conv.py "
                     f"{conv.c1_plan(dt, n, h, w)} is not the kernel's "
                     f"{plan} ({dt}, {n}x{h}x{w})")
    rows = {}
    for name, (n, h, w, c, k), dt in [
            ("bf16 32x56x56x64->64", CONV_MAIN, torch.bfloat16),
            ("f32 32x56x56x64->64", CONV_MAIN, torch.float32),
            ("f32 1x6x10x32->48", (1, 6, 10, 32, 48), torch.float32),
            ("bf16 1x6x10x32->48", (1, 6, 10, 32, 48), torch.bfloat16)]:
        x = (torch.randn(n, h, w, c, generator=gen, device=dev) * .1).to(dt)
        wgt = torch.randn(3, 3, c, k, generator=gen, device=dev) * .1
        xp = conv.pack_pairs(x)
        xp.view(n, h, w, 64)[..., c:] = 1e4  # must not reach the output
        got = conv.conv2d_pairs_packed(xp, wgt, h)
        wd = conv._pad_weights(wgt, dt)
        x64 = xp.view(n, h, w, 64)
        ref = conv.conv2d_pairs_plain(x64, wd, c)
        torch.cuda.synchronize()
        what = f"phase y C1 {name}"
        err = compare(got.view(n, h, w, 64), ref, what)
        if got.view(n, h, w, 64)[..., k:].any():
            fail(f"{what}: output lanes {k}..63 are not zero")
        xcl = x.permute(0, 3, 1, 2)  # NHWC memory: channels_last
        wcl = wgt.to(dt).permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        lib = TF.conv2d(xcl, wcl, padding=1)
        # cuDNN may pick a Winograd or FFT algorithm, which rounds otherwise
        # than a direct sum: f32 within 1e-4 + 1e-3 |ref|
        e_lib = compare(got.view(n, h, w, 64)[..., :k],
                        lib.permute(0, 2, 3, 1), f"{what} against F.conv2d",
                        LIB_CONV_TOL.get(dt))
        ms = cuda_ms(lambda: conv.conv3x3(x64, wd, c))
        # the kernel alone: device time with a cold L2, the call's host
        # time hidden behind the L2-evicting read (back to back, a call's
        # host time can exceed the bf16 kernel's)
        dev_ms = cold_ms(lambda: conv.conv3x3(x64, wd, c))
        plain_ms = cuda_ms(lambda: conv.conv2d_pairs_plain(x64, wd, c),
                           iters=5, warmup=1)
        lib_ms = cuda_ms(lambda: TF.conv2d(xcl, wcl, padding=1))
        elem = torch.finfo(dt).bits // 8
        bms, by = bound_ms(2 * n * h * w * 9 * c * k,
                           elem * (n * h * w * (c + 64) + 9 * c * k), dt,
                           products=True)
        rows[name] = dict(max_abs_err=err, library_err=e_lib, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                          bound_by=by, body=conv.c1_body(dt),
                          device_ms_cold_l2=dev_ms)
        before = CUDA_CORE_C1_MS.get(name)
        print(f"{what} [body {conv.c1_body(dt)}, plan "
              f"{conv.c1_plan(dt, n, h, w)}]: max abs err {err} (atol/rtol "
              f"{TOL[dt]}), against F.conv2d {e_lib}; kernel {ms:.4f} ms"
              + (f" (CUDA cores before: {before} ms)" if before else "")
              + f", device time with a cold L2 {dev_ms:.4f} ms"
              + f", plain {plain_ms:.4f} ms, F.conv2d (channels_last) "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
              f"{100 * bms / ms:.1f}% of it) [{card}]", flush=True)
        del x, xp, got, ref, lib, x64, xcl
    # the main path: the example's packed stack at its card size
    N, H, W, C = ex_conv.CARD_SHAPE
    x, ws = ex_conv.inputs(N, H, W, C, device=dev)
    conv.conv2d_pairs_packed.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ex_conv.stack_packed(x, ws, H)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    launches = conv.conv2d_pairs_packed.launches
    if launches != ex_conv.DEPTH:
        fail(f"phase y stack: {launches} C1 launches, want {ex_conv.DEPTH}")
    err = ex_conv.check(got, x, ws)
    if not (err < STACK_TOL and torch.isfinite(got.float()).all()
            and got.shape == x.shape):
        fail(f"phase y stack: max |err| {err} against F.conv2d + ReLU (bound "
             f"{STACK_TOL}), shape {tuple(got.shape)}")
    stack_ms = cuda_ms(lambda: ex_conv.stack_packed(x, ws, H))
    ref_ms = cuda_ms(lambda: ex_conv.stack_reference(x, ws))
    print(f"phase y examples/conv_pairs twin: {ex_conv.DEPTH}-layer packed "
          f"stack bf16 {N}x{H}x{W}x{C}: {launches} C1 launches, max |err| "
          f"against F.conv2d + ReLU {err:.4f} (bound {STACK_TOL}); "
          f"{stack_s:.4f} s cold, {stack_ms:.4f} ms warm (CUDA cores "
          f"before: {CUDA_CORE_C1_MS['stack']} ms) against "
          f"{ref_ms:.4f} ms for F.conv2d + ReLU [{card}]", flush=True)
    rows["stack"] = dict(launches=launches, max_abs_err=err, ms=stack_ms,
                         library_ms=ref_ms)
    del x, ws, got
    # conv2d_autotuned: every candidate timed as a captured CUDA graph
    for shape in (CONV_MAIN, CONV_FAT):
        n, h, w, c, k = shape
        x = (torch.randn(n * h * w * c, generator=gen, device=dev) * .1
             ).to(torch.bfloat16)
        wgt = (torch.randn(9 * c * k, generator=gen, device=dev) * .1
               ).to(torch.bfloat16)
        hx, hw = cu.create(x), cu.create(wgt)
        t0 = time.perf_counter()
        out = conv.conv2d_autotuned(cu, hx, hw, n, h, w, c, 3, 3, k)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        result = conv.conv2d_autotune_result(cu, hx, hw, n, h, w, c, 3, 3,
                                             k)
        if result is None:
            fail(f"phase y autotuned {shape}: the conv tuner recorded "
                 "nothing")
        cands = {n_: 1e3 * t for n_, t in result[0].items()}
        winner = result[1]
        want = {"native", "pairs"} if c <= 64 else {"native", "im2col"}
        if set(cands) != want:
            fail(f"phase y autotuned {shape}: timed {sorted(cands)}, want "
                 f"{sorted(want)}")
        ref = conv.conv2d_native(x.view(n, h, w, c), wgt.view(3, 3, c, k))
        e = compare(out.tensor.view(n, h, w, k), ref,
                    f"phase y autotuned {shape} against F.conv2d")
        # the candidate that is not the library's, called alone on the same
        # handles: C1 against its plain version and F.conv2d, im2col on M1
        # against F.conv2d
        if c <= 64:
            alone = conv._conv_pairs_task(cu, hx, hw, n, h, w, c, k)
            xp = x.view(n, h, w, c)
            plain = conv.conv2d_pairs_plain(
                xp, conv._pad_weights(wgt.view(3, 3, c, k), xp.dtype), c)
            torch.cuda.synchronize()
            compare(alone.tensor.view(n, h, w, k), plain[..., :k],
                    f"phase y pairs candidate {shape} against plain")
        else:
            alone = conv.conv2d_im2col(cu, hx, hw, n, h, w, c, 3, 3, k)
            torch.cuda.synchronize()
        e_alone = compare(alone.tensor.view(n, h, w, k), ref,
                          f"phase y {sorted(want - {'native'})[0]} "
                          f"candidate {shape} against F.conv2d")
        again = conv.conv2d_autotuned(cu, hx, hw, n, h, w, c, 3, 3, k)
        torch.cuda.synchronize()
        if not torch.equal(again.tensor, out.tensor):
            fail(f"phase y autotuned {shape}: the tuned call differs from "
                 "the tuning call")
        rows[f"autotuned {n}x{h}x{w}x{c}->{k}"] = dict(
            candidates_ms=cands, winner=winner, tune_s=tune_s, max_abs_err=e,
            candidate_err=e_alone)
        print(f"phase y conv2d_autotuned bf16 {n}x{h}x{w}x{c} -> {k} (C1 "
              f"body {conv.c1_body(torch.bfloat16)}): "
              + ", ".join(f"{n_} {t:.4f} ms" for n_, t in sorted(
                  cands.items(), key=lambda kv: kv[1]))
              + f"; winner {winner}, tuned in {tune_s:.2f} s; max abs err "
              f"against F.conv2d {e}, of the "
              f"{sorted(want - {'native'})[0]} candidate alone {e_alone} "
              f"[{card}]", flush=True)
        del x, wgt, hx, hw, out, again, ref, alone
    torch.cuda.empty_cache()
    return rows


# -- StreamingLLM serving (phase z) -------------------------------------------

# z1: mit-han-lab/streaming-llm's run_streaming_llama.py defaults (start_size
# 4, recent_size 2000) on the 0.77B bf16 llama: B 8 x a 4096-token prompt
# through generate's full-attention prefill, then 64 windowed steps, in a
# table of 33 pages of 128 (4224 positions: half of a row's context is
# dead middle by the last step)
STREAM = dict(B=8, S=4096, steps=64, page=128, pages=33, sinks=4,
              window=2000)
# z2: a ring of 17 pages of 16 (272 = sinks 16 + window 240 + one page):
# StreamingLLM's 256-token cache with its window rounded to the ring's
# pages; 320 steps from an empty cache recycle its slots; the same stream
# through an unbounded windowed cache of 20 pages
RING = dict(B=8, steps=320, page=16, pages=17, sinks=16, window=240,
            unbounded_pages=20)
# z3: the d768 f32 llama (phase l's) windowed after a 256-token prompt
# (64 steps, sinks 4, window 128) and on a ring of 9 pages of 16 (sinks
# 16, window 112) for 200 steps, unbounded in 13 pages
STREAM_F32 = dict(B=8, S=256, steps=64, page=128, pages=3, sinks=4,
                  window=128)
RING_F32 = dict(B=8, steps=200, page=16, pages=9, sinks=16, window=112,
                unbounded_pages=13)
# the two models: phase k's 0.77B bf16 llama, phase l's d768 f32 one
Z_LLAMA = dict(vocab=8192, d_model=2048, n_heads=16, n_kv_heads=8,
               n_layers=16, d_ff=5632, seq=1024, dtype="bfloat16",
               use_framework_kernels=False)
Z_F32 = dict(vocab=8192, d_model=768, n_heads=12, n_kv_heads=4, n_layers=8,
             d_ff=2048, seq=512, use_framework_kernels=False)


def with_cfg(llama, model, cfg):
    """``model`` under ``cfg``, its weights shared (the serving options
    change no weight: no copy of them); ``cfg`` checked as ``Llama(cfg)``
    checks it."""
    llama.check_supported(cfg)
    m = copy.copy(model)
    m.cfg = cfg
    return m


def ring_meta(table, length, page, sinks, P):
    """pos_meta (P, page) of a ring whose rows (``table``) each decoded
    ``length`` tokens (or row b ``length[b]``): slot j of a row's table
    order holds j below the sinks, else the newest t with sinks + (t -
    sinks) % (capacity - sinks) == j; -1 where none came."""
    cap = table.shape[1] * page
    ring = cap - sinks
    meta = np.full((P, page), -1, np.int32)
    tab = table.cpu().numpy()
    lens = [length] * tab.shape[0] if np.isscalar(length) else length
    for b, n in enumerate(lens):
        j = np.arange(min(n, cap))
        t = np.where(j < sinks, j, j + (n - 1 - j) // ring * ring)
        meta[tab[b, j // page], j % page] = t
    return torch.from_numpy(meta).to(table.device)


def p1_stream_call(pa, dev, gen, card, what, B, L, Hkv, G, D, page,
                   max_pages, length, window, sinks, ring):
    """One windowed or ring P1 call at a phase-z shape against its plain
    version on bf16 and on int8 pools (layer L - 1 of L); the bf16 call
    timed back to back (each launch on the next layer) and with a cold L2,
    beside its plain version, its bound on the positions it attends (the
    sinks and the window) and, windowed, the same call with window 0."""
    P = B * max_pages + 5
    shape = (L, Hkv, P, page, D)
    q = torch.randn(B, Hkv * G, D, generator=gen, device=dev).to(
        torch.bfloat16)
    table = torch.randperm(P, generator=gen, device=dev)[:B * max_pages]
    table = table.view(B, max_pages).to(torch.int32)
    ln = torch.full((B,), length, dtype=torch.int32, device=dev)
    meta = ring_meta(table, length, page, sinks, P) if ring else None
    opts = dict(window=window, sinks=sinks, pos_meta=meta)
    kp, vp = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    row, errs = {}, {}
    for kind in ("bf16", "int8"):
        if kind == "int8":
            del kp, vp
            kp, vp, ks, vs = int8_pools(shape, dev, gen)
        else:
            ks = vs = None
        sc = dict(k_scales=ks, v_scales=vs, **opts)
        got = pa.paged_attention(q, kp, vp, table, ln, layer=L - 1, **sc)
        torch.cuda.synchronize()
        errs[kind] = compare(got, pa.paged_attention_plain(
            q, kp, vp, table, ln, layer=L - 1, **sc),
            f"{what} {kind} pools")
        if kind == "bf16":
            layers = iter(range(10**9))
            row["ms"] = cuda_ms(lambda: pa.paged_attention(
                q, kp, vp, table, ln, layer=next(layers) % L, **sc),
                iters=32)
            row["cold_ms"] = cold_ms(lambda: pa.paged_attention(
                q, kp, vp, table, ln, layer=L - 1, **sc))
            row["plain_ms"] = cuda_ms(lambda: pa.paged_attention_plain(
                q, kp, vp, table, ln, layer=next(layers) % L, **sc),
                iters=8, warmup=1)
            if not ring:   # the same call attending every position
                row["window0_ms"] = cuda_ms(lambda: pa.paged_attention(
                    q, kp, vp, table, ln, layer=next(layers) % L),
                    iters=32)
                row["window0_cold_ms"] = cold_ms(lambda: pa.paged_attention(
                    q, kp, vp, table, ln, layer=L - 1))
    pos = np.arange(length)
    live = int(((pos < sinks) | (pos >= length - window)).sum()) \
        if window else length
    read = min(length, max_pages * page)
    bms, by = paged_bound(torch.bfloat16, 2, D, Hkv * G, Hkv, [live] * B,
                          [live] * B, False, B,
                          4 * B * read if ring else 0)
    plan = pa.p1_plan(torch.bfloat16, torch.bfloat16, B, Hkv * G, Hkv, D,
                      page, max_pages, window, sinks, ring)
    row.update(max_abs_err=errs["bf16"], int8_max_abs_err=errs["int8"],
               bound_ms=bms, bound_by=by, splits=plan.splits,
               live_positions=live, length=length)
    if not ring:
        row["window0_bound_ms"], _ = paged_bound(
            torch.bfloat16, 2, D, Hkv * G, Hkv, [length] * B, [length] * B,
            False, B)
        row["window0_splits"] = pa.p1_plan(
            torch.bfloat16, torch.bfloat16, B, Hkv * G, Hkv, D, page,
            max_pages).splits
    print(f"phase {what} B{B} Hkv{Hkv} G{G} D{D} page{page} x{max_pages} "
          f"length {length} (window {window}, sinks {sinks}: {live} live "
          f"positions, {plan.splits} splits): max abs err bf16 "
          f"{errs['bf16']}, int8 pools {errs['int8']} (atol/rtol "
          f"{TOL[torch.bfloat16]}); kernel {row['ms']:.4f} ms back to back, "
          f"{row['cold_ms']:.4f} ms cold L2, plain {row['plain_ms']:.4f} ms, "
          f"bound {bms:.4f} ms ({by}; {100 * bms / row['cold_ms']:.1f}% of "
          f"it cold)"
          + ("" if ring else
             f"; the same call with window 0: {row['window0_ms']:.4f} ms, "
             f"{row['window0_cold_ms']:.4f} ms cold ({row['window0_splits']}"
             f" splits, bound {row['window0_bound_ms']:.4f} ms); windowed "
             f"cold / unwindowed cold "
             f"{row['cold_ms'] / row['window0_cold_ms']:.3f}")
          + f" [{card}]", flush=True)
    del q, kp, vp, ks, vs
    torch.cuda.empty_cache()
    return row


def stream_steps(llama, model, cache, first, steps, feed=None,
                 kernels=True):
    """``steps`` decode steps from ``cache``: greedy from ``first`` (B,),
    or fed ``feed`` (B, steps). Returns the tokens fed (B, steps) and the
    f32 logits after each (B, steps, vocab)."""
    toks, lgs, tok = [], [], first
    for i in range(steps):
        if feed is not None:
            tok = feed[:, i]
        toks.append(tok)
        logits, cache = llama.decode_step(model, cache, tok,
                                          kernels=kernels)
        lgs.append(logits.float())
        tok = logits.argmax(-1).to(torch.int32)
    return torch.stack(toks, 1), torch.stack(lgs, 1)


def streaming_serve(llama, pa, fa, dev, gen, card):
    """Phase z: StreamingLLM serving on the port. z1 the 0.77B bf16 llama
    with sinks 4 and window 2000 through ``generate`` (4096-token prompt,
    64 windowed steps; 1024 windowed P1 launches checked, tokens against
    the plain path's under the BF16_GAP rule), one windowed P1 call against
    plain (bf16, int8) timed beside the same call with window 0; z2 the
    same model on a ring (320 steps on 272 slots, 5120 ring launches) held
    to an unbounded windowed cache fed the same tokens, one ring call
    against plain; z3 the d768 f32 llama windowed and on a ring, kernels
    against the plain versions and the ring against the unbounded cache,
    within LOGIT_TOL."""
    z, out = STREAM, {}
    cfg = llama.LlamaConfig(**Z_LLAMA, attn_window=z["window"],
                            attn_sinks=z["sinks"])
    L, H, Hkv, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    model = llama.init_params(cfg, seed=0, device=dev)
    B, S, steps, page, pages = (z[k] for k in ("B", "S", "steps", "page",
                                               "pages"))
    prompt = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)

    # -- z1: windowed serving through generate
    _reset_paged(fa, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = llama.generate(model, prompt, steps, pages, page)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n1 = _check_paged(fa, pa, "phase z1 windowed generate", {
        "flash_attention": L, "paged_attention": L * steps,
        "paged_attention_window": L * steps})
    if toks.shape != (B, steps) or not ((toks >= 0)
                                        & (toks < cfg.vocab)).all():
        fail(f"phase z1: bad tokens {tuple(toks.shape)}")
    # warm: the prefill, then the steps timed
    cache = llama.init_kv_cache(cfg, B, pages, page, dev)
    logits, cache = llama.prefill(model, cache, prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, _ = stream_steps(llama, model, cache,
                            logits.argmax(-1).to(torch.int32), steps)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    if not torch.equal(again, toks):
        fail("phase z1: the warm re-run gave other tokens than generate")
    del cache
    want, want_logits = greedy_ref(llama, model, prompt, steps, pages, page,
                                   kernels=False)
    prefix, agree = tie_prefix(toks, want, want_logits, BF16_GAP,
                               "phase z1 windowed tokens against the plain "
                               "path")
    print(f"phase z1 windowed serve llama 0.77B bf16 (sinks {z['sinks']}, "
          f"window {z['window']}): {B} x {S} prompt (full-attention "
          f"prefill) + {steps} windowed steps in {pages} pages of {page}; "
          f"generate {gen_s:.3f} s cold, warm decode {step_ms:.3f} ms/step "
          f"({1e3 * B / step_ms:.1f} tok/s) at context {S}-{S + steps}; "
          f"launches {n1}; tokens equal the plain path's up to the first "
          f"near tie (gap < {BF16_GAP}): prefix {min(prefix)}..{steps}, "
          f"agreeing from the start {agree} [{card}]", flush=True)
    del want, want_logits
    out["window_serve"] = dict(generate_s=gen_s, ms_step=step_ms,
                               launches=n1, tie_prefix_min=min(prefix))
    out["window_call"] = p1_stream_call(
        pa, dev, gen, card, "z1 windowed P1", B, L, Hkv, H // Hkv, hd, page,
        pages, S + steps, z["window"], z["sinks"], False)

    # -- z2: the ring, against an unbounded windowed cache
    r = RING
    rcfg = dataclasses.replace(cfg, attn_window=r["window"],
                               attn_sinks=r["sinks"], ring_cache=True)
    ucfg = dataclasses.replace(rcfg, ring_cache=False)
    rmodel, umodel = (with_cfg(llama, model, c) for c in (rcfg, ucfg))
    del model
    first = torch.from_numpy(np.random.default_rng(20).integers(
        0, cfg.vocab, (r["B"],), dtype=np.int32)).to(dev)
    rc = llama.init_kv_cache(rcfg, r["B"], r["pages"], r["page"], dev)
    _reset_paged(fa, pa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rtoks, rlogits = stream_steps(llama, rmodel, rc, first, r["steps"])
    torch.cuda.synchronize()
    ring_ms = 1e3 * (time.perf_counter() - t0) / r["steps"]
    n2 = _check_paged(fa, pa, "phase z2 ring decode", {
        "paged_attention": L * r["steps"],
        "paged_attention_ring": L * r["steps"]})
    if rc.k.shape[2] != r["B"] * r["pages"] or \
            int(rc.lengths.min()) != r["steps"]:
        fail("phase z2: the ring grew or lost count")
    uc = llama.init_kv_cache(ucfg, r["B"], r["unbounded_pages"], r["page"],
                             dev)
    _reset_paged(fa, pa)
    _, ulogits = stream_steps(llama, umodel, uc, None, r["steps"],
                              feed=rtoks)
    nu = _check_paged(fa, pa, "phase z2 unbounded windowed decode", {
        "paged_attention": L * r["steps"],
        "paged_attention_window": L * r["steps"]})
    err_r = compare(rlogits, ulogits, "phase z2 ring logits against the "
                    "unbounded windowed cache's", BF16_PATH_TOL)
    need = atol_needed(rlogits, ulogits, BF16_PATH_TOL[1])
    print(f"phase z2 ring serve llama 0.77B bf16 (sinks {r['sinks']}, "
          f"window {r['window']}, {r['pages']} pages of {r['page']}): "
          f"{r['B']} rows x {r['steps']} steps from an empty cache, "
          f"{ring_ms:.3f} ms/step; launches {n2}; logits against the same "
          f"tokens through {r['unbounded_pages']} unbounded pages (launches "
          f"{nu}): max abs err {err_r} (atol/rtol {BF16_PATH_TOL}; the "
          f"least atol at that rtol {need}) [{card}]", flush=True)
    out["ring_serve"] = dict(ms_step=ring_ms, launches=n2,
                             logit_err_vs_unbounded=err_r,
                             atol_needed_vs_unbounded=need)
    del rmodel, umodel, rc, uc, rlogits, ulogits
    torch.cuda.empty_cache()
    out["ring_call"] = p1_stream_call(
        pa, dev, gen, card, "z2 ring P1", r["B"], L, Hkv, H // Hkv, hd,
        r["page"], r["pages"], r["steps"], r["window"], r["sinks"], True)

    # -- z3: f32 exactness, kernels against plain
    fz, fr = STREAM_F32, RING_F32
    fcfg = llama.LlamaConfig(**Z_F32, attn_window=fz["window"],
                             attn_sinks=fz["sinks"])
    fmodel = llama.init_params(fcfg, seed=1, device=dev)
    fprompt = torch.from_numpy(np.random.default_rng(21).integers(
        0, fcfg.vocab, (fz["B"], fz["S"]), dtype=np.int32)).to(dev)
    errs = {}
    _reset_paged(fa, pa)
    runs = {}
    for kernels in (True, False):
        c = llama.init_kv_cache(fcfg, fz["B"], fz["pages"], fz["page"], dev)
        lg, c = llama.prefill(fmodel, c, fprompt, kernels=kernels)
        feed = runs[True][0] if not kernels else None
        runs[kernels] = (*stream_steps(
            llama, fmodel, c, lg.argmax(-1).to(torch.int32), fz["steps"],
            feed=feed, kernels=kernels), lg.float())
    n3w = _check_paged(fa, pa, "phase z3 windowed f32", {
        "flash_attention": fcfg.n_layers,
        "paged_attention": fcfg.n_layers * fz["steps"],
        "paged_attention_window": fcfg.n_layers * fz["steps"]})
    errs["windowed prefill"] = (runs[True][2] - runs[False][2]).abs().max()
    errs["windowed steps"] = (runs[True][1] - runs[False][1]).abs().max()
    rfcfg = dataclasses.replace(fcfg, attn_window=fr["window"],
                                attn_sinks=fr["sinks"], ring_cache=True)
    rf, uf = (with_cfg(llama, fmodel, c) for c in (
        rfcfg, dataclasses.replace(rfcfg, ring_cache=False)))
    first = torch.from_numpy(np.random.default_rng(22).integers(
        0, fcfg.vocab, (fr["B"],), dtype=np.int32)).to(dev)
    _reset_paged(fa, pa)
    c = llama.init_kv_cache(rfcfg, fr["B"], fr["pages"], fr["page"], dev)
    ftoks, fk = stream_steps(llama, rf, c, first, fr["steps"])
    n3r = _check_paged(fa, pa, "phase z3 ring f32", {
        "paged_attention": fcfg.n_layers * fr["steps"],
        "paged_attention_ring": fcfg.n_layers * fr["steps"]})
    c = llama.init_kv_cache(rfcfg, fr["B"], fr["pages"], fr["page"], dev)
    _, fp = stream_steps(llama, rf, c, None, fr["steps"], feed=ftoks,
                         kernels=False)
    c = llama.init_kv_cache(uf.cfg, fr["B"], fr["unbounded_pages"],
                            fr["page"], dev)
    _, fu = stream_steps(llama, uf, c, None, fr["steps"], feed=ftoks)
    errs["ring steps"] = (fk - fp).abs().max()
    errs["ring against unbounded"] = (fk - fu).abs().max()
    errs = {k: v.item() for k, v in errs.items()}
    bad = {k: v for k, v in errs.items() if not v <= LOGIT_TOL}
    if bad:
        fail(f"phase z3: logits differ by more than {LOGIT_TOL}: {bad}")
    print(f"phase z3 exactness llama d768 f32: windowed (sinks "
          f"{fz['sinks']}, window {fz['window']}) {fz['B']} x {fz['S']} "
          f"prompt + {fz['steps']} steps, kernels against plain fed the "
          f"same tokens (launches {n3w}); a ring (sinks {fr['sinks']}, "
          f"window {fr['window']}, {fr['pages']} pages of {fr['page']}) "
          f"{fr['steps']} steps against its plain route and an unbounded "
          f"cache of {fr['unbounded_pages']} pages (launches {n3r}): max "
          f"abs err {errs} (tol {LOGIT_TOL}) [{card}]", flush=True)
    out["f32"] = dict(errs, window_launches=n3w, ring_launches=n3r)
    del fmodel, rf, uf, c
    torch.cuda.empty_cache()
    return out


# -- phase za: flash attention's options (A1/A3/A4 masked, A8's window) ------

# mistralai/Mistral-7B-v0.1 config.json: 32 query heads, 8 kv heads, head
# dim 128 (hidden 4096), sliding_window 4096 (keys i - 4095 .. i)
MISTRAL_ATTN = dict(B=1, H=32, Hkv=8, S=8192, D=128, left=4095,
                    plain_heads=4)
# packed documents at the 0.77B llama's attention widths (phase x's):
# lengths uniform in [lo, hi] from the seed until S is full, the last
# ``pad`` positions the padding id -1
DOCS = dict(B=4, H=16, Hkv=8, S=8192, D=128, lo=256, hi=2048, pad=128,
            plain_heads=2)
# A8 at head dim 32 (padded to 64) with a window, and kv_len at one shape
PACKED32 = dict(B=8, H=16, Hkv=16, S=2048, D=32, window=(256, 0))
KV_LEN = dict(B=2, H=16, Hkv=8, S=2048, D=128, kv_len=1900)
# the f32 bodies (3xTF32 forward and dK/dV, CUDA-core dQ) at smaller
# shapes: (name, B, H, Hkv, S, D, causal, options)
ZA_F32 = [("window f32", 1, 8, 2, 1024, 128, True, dict(window=(300, 0))),
          ("band f32", 1, 8, 8, 1000, 64, False, dict(window=(100, 50))),
          ("segments f32", 2, 4, 2, 1024, 64, True, "docs"),
          ("kv_len f32", 2, 4, 4, 1000, 128, False, dict(kv_len=900)),
          ("packed d32 f32", 2, 8, 8, 1024, 32, True, dict(window=(128, 0)))]
# microsoft/Phi-3-mini-4k-instruct config.json: hidden_size 3072, 32
# attention heads of 96, 32 kv heads, intermediate_size 8192, vocab_size
# 32064, rope_theta 10000, 32 layers; trained at full depth in bf16
PHI3 = dict(vocab=32064, d_model=3072, n_heads=32, n_kv_heads=32,
            n_layers=32, d_ff=8192, rope_theta=10000.0)
PHI3_TRAIN = dict(B=4, S=1024, steps=4, ragged_S=1000, exact_layers=2,
                  exact_B=2)


def doc_ids(rng, B, S, lo, hi, pad, dev):
    """Segment ids of packed documents, (B, S) int32: lengths uniform in
    [lo, hi] until S is full, the last ``pad`` positions -1."""
    ids = np.empty((B, S), np.int32)
    for b in range(B):
        pos = doc = 0
        while pos < S:
            n = int(rng.integers(lo, hi + 1))
            ids[b, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    ids[:, S - pad:] = -1
    return torch.from_numpy(ids).to(dev)


def option_bounds(pairs, B, H, Hkv, S, D, dtype):
    """Bounds of the masked A1, A4 and A3 over ``pairs`` live (query, key)
    pairs of one head summed over the batch: 2, 3 and 4 matrix products a
    pair and head; bytes: q, k, v and o (with the f32 lse), q, k, v, do ->
    dq (lse, di), q, k, v, do -> dk, dv (lse, di)."""
    elem = torch.finfo(dtype).bits // 8
    tq, tk, st = elem * B * H * S * D, elem * B * Hkv * S * D, 4 * B * H * S
    return {"fwd": bound_ms(4 * D * pairs * H, 2 * tq + 2 * tk + st, dtype,
                            True),
            "dq": bound_ms(6 * D * pairs * H, 3 * tq + 2 * tk + 2 * st,
                           dtype, True),
            "dkv": bound_ms(8 * D * pairs * H, 2 * tq + 4 * tk + 2 * st,
                            dtype, True)}


def _masked_launches(fa):
    return {"masked_forward": fa.masked_forward.launches,
            "masked_dkv": fa.masked_dkv.launches,
            "masked_dq": fa.masked_dq.launches,
            "flash_attention": fa.flash_attention.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches}


def _reset_masked(fa):
    fa.masked_forward.launches = fa.masked_dkv.launches = 0
    fa.masked_dq.launches = 0
    fa.flash_attention.launches = fa.flash_bwd_dkv.launches = 0
    fa.flash_bwd_dq.launches = 0


def option_case(fa, dev, gen, card, name, fn, B, H, Hkv, S, D, dt, causal,
                opts, plain_heads=None, timed=False):
    """One case of the options: ``fn`` (a public function) forward and
    backward through autograd, which must launch each masked kernel once
    and no dense one (counted from 0); then each masked kernel on its own
    (D below 64 padded to 64, as the wrapper pads) against its plain
    version on the kernel's own o and lse, on the first ``plain_heads``
    query heads and their kv heads where the plain (S, S) scores of all
    would not fit; with ``timed`` each kernel's time, its bound over the
    live pairs, the dense causal kernels' time at the same shape, the plain
    versions' (on those heads) and SDPA's with the element mask as a bool
    ``attn_mask``, forward and backward; in f32 the masked A1 and A3 also
    with a cold L2 and their shares of the bounds."""
    q, do = (torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dt)
            for _ in range(2))
    mask = fa._Mask.of(q, k, **opts)
    what = (f"{name}: {_dt(dt)} B{B} H{H}/{Hkv} S{S} D{D} "
            f"{'causal' if causal else 'non-causal'}, options "
            f"{ {k_: v_ for k_, v_ in opts.items() if k_ != 'seg'} }"
            f"{' + segment ids' if 'seg' in opts else ''}")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _reset_masked(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = _masked_launches(fa)
    want = {"masked_forward": 1, "masked_dkv": 1, "masked_dq": 1,
            "flash_attention": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    if launches != want:
        fail(f"phase za {what}: kernel launches {launches}, want {want}")
    scale = D ** -0.5
    pad = (lambda t: t) if D >= 64 else \
        (lambda t: torch.nn.functional.pad(t, (0, 64 - D)))
    qp, kp, vp, dop = (pad(t) for t in (q, k, v, do))
    o, lse = fa.masked_forward(qp, kp, vp, mask, causal, scale, True)
    o = o[..., :D]
    if not torch.equal(out.detach(), o):
        fail(f"phase za {what}: the autograd forward is not the kernel's")
    di = (do.float() * o.float()).sum(-1)
    dq = fa.masked_dq(qp, kp, vp, dop, lse, di, mask, causal, scale)
    dk, dv = fa.masked_dkv(qp, kp, vp, dop, lse, di, mask, causal, scale)
    dq, dk, dv = (t[..., :D] for t in (dq, dk, dv))
    if not all(torch.equal(t.grad, a) for t, a in zip(leaves, (dq, dk, dv))):
        fail(f"phase za {what}: the autograd Function's grads are not the "
             "kernels'")
    hs = plain_heads or H
    hk = hs * Hkv // H
    sub = [t[:, :n] for t, n in ((q, hs), (k, hk), (v, hk))]
    o_ref, lse_ref = fa.flash_attention_plain(*sub, causal, scale,
                                              return_lse=True, **mask.plain())
    err_o = compare(o[:, :hs], o_ref, f"phase za {what}: o")
    err_lse = compare(lse[:, :hs], lse_ref, f"phase za {what}: lse",
                      TOL[torch.float32])
    del o_ref, lse_ref
    exact, rounded = (plain_bwd(
        fa, *sub, o[:, :hs], lse[:, :hs], do[:, :hs], causal, scale,
        round_p_ds=rnd, **mask.plain()) for rnd in (False, True))
    torch.cuda.synchronize()
    err_r, err, need = zip(*(compare_bwd(a, r, e, f"phase za {what}: d{n}")
                             for n, a, r, e in zip(
                                 "qkv", (dq[:, :hs], dk[:, :hk], dv[:, :hk]),
                                 rounded, exact)))
    del exact, rounded
    torch.cuda.empty_cache()
    live = fa._live_mask(q, k, causal, **mask.plain())
    pairs = int(live.sum()) * (B if live.dim() == 2 else 1)
    row = dict(max_abs_err=max(err_o, *err), o_err=err_o, lse_err=err_lse,
               dq_err=err[0], dkv_err=max(err[1:]), dq_err_rounded=err_r[0],
               dkv_err_rounded=max(err_r[1:]), atol_vs_exact=max(
                   n_[0] for n_ in need), launches=launches, path_s=path_s,
               live_pairs=pairs,
               plain_heads=f"{hs} of {H} query heads, {hk} of {Hkv} kv heads")
    msg = ""
    if timed:
        bounds = option_bounds(pairs, B, H, Hkv, S, D, dt)
        dense_pairs = B * (S * (S + 1) // 2 if causal else S * S)
        row.update(
            fwd_ms=cuda_ms(lambda: fa.masked_forward(
                qp, kp, vp, mask, causal, scale, True)),
            dq_ms=cuda_ms(lambda: fa.masked_dq(qp, kp, vp, dop, lse, di,
                                               mask, causal, scale)),
            dkv_ms=cuda_ms(lambda: fa.masked_dkv(qp, kp, vp, dop, lse, di,
                                                 mask, causal, scale)),
            bounds={k_: dict(zip(("bound_ms", "bound_by"), b))
                    for k_, b in bounds.items()})
        o_d, lse_d = fa._flash_forward(qp, kp, vp, True, scale, True)
        di_d = (do.float() * o_d[..., :D].float()).sum(-1)
        row["dense_causal"] = dict(
            live_pairs=dense_pairs,
            fwd_ms=cuda_ms(lambda: fa._flash_forward(qp, kp, vp, True, scale,
                                                     True)),
            dq_ms=cuda_ms(lambda: fa.flash_bwd_dq(qp, kp, vp, dop, lse_d,
                                                  di_d, True, scale)),
            dkv_ms=cuda_ms(lambda: fa.flash_bwd_dkv(qp, kp, vp, dop, lse_d,
                                                    di_d, True, scale)))
        del o_d, lse_d, di_d
        sub_o, sub_lse = o[:, :hs], lse[:, :hs]
        row["plain_fwd_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            *sub, causal, scale, return_lse=True, **mask.plain()), iters=3,
            warmup=1)
        row["plain_bwd_ms"] = cuda_ms(
            lambda: fa.flash_attention_backward_plain(
                *sub, sub_o, sub_lse, do[:, :hs], causal, scale,
                **mask.plain()), iters=3, warmup=1)
        torch.cuda.empty_cache()
        # kv heads repeated outside the timed call: with a mask and
        # enable_gqa SDPA takes its math route, which would not fit
        el = live if live.dim() == 4 else live[None, None]
        kr, vr = (t.repeat_interleave(H // Hkv, 1) for t in (k, v))
        sdpa = lambda q_, k_, v_: TF.scaled_dot_product_attention(  # noqa
            q_, k_, v_, attn_mask=el)
        row["library_fwd_ms"] = cuda_ms(lambda: sdpa(q, kr, vr), iters=5)
        row["library_bwd_ms"] = cuda_ms(grad_call(sdpa, (q, kr, vr), do),
                                        iters=5)
        del kr, vr
        if dt == torch.float32:  # the 3xTF32 bodies with a cold L2
            row["cold_ms"] = dict(
                fwd=cold_ms(lambda: fa.masked_forward(
                    qp, kp, vp, mask, causal, scale, True)),
                dkv=cold_ms(lambda: fa.masked_dkv(
                    qp, kp, vp, dop, lse, di, mask, causal, scale)))
        dn = row["dense_causal"]
        msg = (f"; live pairs {pairs} ({pairs / dense_pairs:.3f} of dense "
               f"causal's {dense_pairs}); masked A1 {row['fwd_ms']:.4f} ms "
               f"(bound {bounds['fwd'][0]:.4f}, {bounds['fwd'][1]}; dense "
               f"causal {dn['fwd_ms']:.4f}), A4 {row['dq_ms']:.4f} ms (bound "
               f"{bounds['dq'][0]:.4f}; dense {dn['dq_ms']:.4f}), A3 "
               f"{row['dkv_ms']:.4f} ms (bound {bounds['dkv'][0]:.4f}; dense "
               f"{dn['dkv_ms']:.4f}); plain on {row['plain_heads']}: "
               f"forward {row['plain_fwd_ms']:.4f} ms, backward "
               f"{row['plain_bwd_ms']:.4f} ms; SDPA with the element mask "
               f"forward {row['library_fwd_ms']:.4f} ms, backward "
               f"{row['library_bwd_ms']:.4f} ms"
               + ("; cold L2: masked A1 " + ", A3 ".join(
                   f"{row['cold_ms'][w]:.4f} ms ("
                   f"{100 * bounds[w][0] / row['cold_ms'][w]:.1f}% of its "
                   f"bound)" for w in ("fwd", "dkv"))
                  if "cold_ms" in row else ""))
    print(f"phase za {what}: launches {launches}, forward + backward "
          f"{path_s:.4f} s; against plain on {row['plain_heads']}: max abs "
          f"err o {err_o}, lse {err_lse}; dq, dk, dv against the plain "
          f"backward that rounds p and dS as the kernels do {err_r[0]}, "
          f"{err_r[1]}, {err_r[2]} (atol/rtol {TOL[dt]}), against the exact "
          f"one {err[0]}, {err[1]}, {err[2]} (atol/rtol {EXACT_BWD_TOL[dt]};"
          f" the atol each needs there, kernel and rounding plain: {need[0]},"
          f" {need[1]}, {need[2]}){msg} [{card}]", flush=True)
    del q, k, v, do, leaves, out, o, lse, dq, dk, dv, live, sub
    torch.cuda.empty_cache()
    return row


def rmsnorm_at_width(llama, cu, cfg, shape, dev, gen, card, phase):
    """K0's RMSNorm at a trained width and shape (a per-shape build that
    phases a-h never run), forward and backward through ``_rmsnorm`` as
    the llama calls it, against plain f32 autograd of the formula on the
    same inputs (bf16 TOL, as phase e)."""
    x, dy = (torch.randn(shape, generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    g = torch.randn(cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    k0 = ("_rmsnorm_fwd_k", "_rmsnorm_bwd_k")
    n = [cu.server.launches[k] for k in k0]
    leaves = [t.clone().requires_grad_() for t in (x, g)]
    y = llama._rmsnorm(*leaves, cfg, True)
    y.backward(dy)
    refs = [t.float().requires_grad_() for t in (x, g)]
    y_ref = refs[0] * torch.rsqrt(refs[0].square().mean(-1, keepdim=True)
                                  + cfg.rms_eps) * refs[1]
    y_ref.backward(dy.float())
    torch.cuda.synchronize()
    what = (f"phase {phase} K0 rmsnorm d{cfg.d_model} "
            f"{'x'.join(map(str, shape))}")
    if [cu.server.launches[k] - m for k, m in zip(k0, n)] != [1, 1]:
        fail(f"{what}: the forward and backward kernels did not run once "
             "each")
    errs = [compare(a, r.to(torch.bfloat16), f"{what} {w}")
            for w, a, r in (("y", y, y_ref), ("dx", leaves[0].grad,
                                               refs[0].grad),
                            ("dg", leaves[1].grad, refs[1].grad))]
    print(f"{what} (bf16), kernels against plain f32 autograd: max abs err "
          f"y {errs[0]}, dx {errs[1]}, dg {errs[2]} (atol/rtol "
          f"{TOL[torch.bfloat16]}) [{card}]", flush=True)
    return errs


def train_at_widths(llama, fa, cu, dev, gen, card, phase, widths, t,
                    model_name, exact_phase=None):
    """The repo's llama at a published model's widths (``widths``), bf16 at
    full depth: K0's RMSNorm against plain at the width and at both trained
    shapes (``rmsnorm_at_width``), then SGD steps at B x S (``t``) on one batch and two at a ragged
    length, the launches of every kernel of the path counted from 0 (A1,
    A3, A4 once a layer a step, through the flash function the llama picks
    for its head dim; no masked kernel; K0's RMSNorm 2L + 1 a step each
    way), one profiled step (the device's busy share); then f32 exactness
    at full width with ``exact_layers`` layers, one SGD step with the
    kernels against one with the plain versions (loss to 1e-5 relative,
    gradients and weights to 1e-4 of their max-abs, phase g's bounds) and
    the prefill logits (LOGIT_TOL), printed as ``exact_phase`` (default
    ``phase``)."""
    cfg = llama.LlamaConfig(**widths, seq=t["S"], dtype="bfloat16",
                            use_framework_kernels=True)
    L, B, S, steps = cfg.n_layers, t["B"], t["S"], t["steps"]
    route = fa.flash_for_head_dim(cfg.head_dim, cfg.n_heads).__name__
    k0_errs = {s_: rmsnorm_at_width(llama, cu, cfg, (B, s_, cfg.d_model), dev,
                                    gen, card, phase)
               for s_ in (S, t["ragged_S"])}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    model = llama.init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    step = llama.make_train_step(cfg, TRAIN_LR)
    rng = np.random.default_rng(23)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1),
                                           dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k0 = ("_rmsnorm_fwd_k", "_rmsnorm_bwd_k")
    _reset_masked(fa)
    cu.server.reset_counts()
    losses, secs = _train(step, model, tokens, steps)
    ragged = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (B, t["ragged_S"] + 1),
                                           dtype=np.int32)).to(dev)
    # two steps at the ragged length (its K0 kernels built by
    # rmsnorm_at_width above)
    loss_r, sec_r = _train(step, model, ragged, 2)
    torch.cuda.synchronize()
    launches = dict(_masked_launches(fa),
                    **{n: cu.server.launches[n] for n in k0})
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = steps + 2
    per = 2 * L + 1
    want = {"masked_forward": 0, "masked_dkv": 0, "masked_dq": 0,
            "flash_attention": L * n, "flash_bwd_dkv": L * n,
            "flash_bwd_dq": L * n, "_rmsnorm_fwd_k": per * n,
            "_rmsnorm_bwd_k": per * n}
    if launches != want:
        fail(f"phase {phase} train {model_name} widths: kernel launches "
             f"{launches}, want {want}")
    if not all(math.isfinite(x) for x in losses + loss_r) \
            or losses[-1] >= losses[0]:
        fail(f"phase {phase}: losses {losses} (ragged {loss_r}) are not "
             "finite and falling")
    prof = profile_step(step, model, tokens)
    ms = 1e3 * statistics.median(secs[1:])
    traced = "no device time in the trace" if prof is None else (
        f"one more step traced: {prof[0]:.2f} ms wall, {prof[1]:.2f} ms "
        f"busy ({100 * (1 - prof[1] / prof[0]):.1f}% idle), by group "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            prof[2].items(), key=lambda kv: -kv[1])))
    print(f"phase {phase} train llama at {model_name}'s widths "
          f"({n_params / 1e9:.3f}B bf16: d{cfg.d_model}, {L} layers, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim} through "
          f"{route}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"use_framework_kernels=True): B {B} x S {S}, SGD lr {TRAIN_LR}, "
          f"{steps} steps on one batch: losses {losses}; {ms:.2f} ms/step "
          f"warm (median of steps 2-{steps}; step 1 {1e3 * secs[0]:.2f} ms), "
          f"{B * S / ms * 1e3:.0f} tok/s; two steps at ragged S "
          f"{t['ragged_S']}: losses {loss_r}, {1e3 * sec_r[0]:.2f} and "
          f"{1e3 * sec_r[1]:.2f} ms; "
          f"peak memory {peak:.2f} GiB ({held:.2f} GiB held before the "
          f"phase); launches over the {n} steps {launches}; {traced} "
          f"[{card}]", flush=True)
    del model, step
    torch.cuda.empty_cache()
    # f32 exactness at full width, 2 layers, ragged S
    phase = exact_phase or phase
    ecfg = llama.LlamaConfig(**dict(widths, n_layers=t["exact_layers"]),
                             seq=t["ragged_S"], use_framework_kernels=True)
    etok = torch.from_numpy(rng.integers(0, ecfg.vocab,
                                         (t["exact_B"], t["ragged_S"] + 1),
                                         dtype=np.int32)).to(dev)
    runs = []
    for kernels in (True, False):
        m = llama.init_params(ecfg, seed=1, device=dev)
        c = llama.init_kv_cache(ecfg, t["exact_B"], 8, 128, dev)
        logits, _ = llama.prefill(m, c, etok[:, :-1], kernels=kernels)
        loss = llama.make_train_step(ecfg, 1e-3, kernels=kernels)(m, etok)
        runs.append((loss.item(), dict(m.named_parameters()), logits))
    (lk, pk, gk), (lp, pp, gp) = runs
    if abs(lk - lp) > 1e-5 * abs(lp):
        fail(f"phase {phase} exactness: loss {lk} with kernels, {lp} plain")
    worst = {"grad": 0.0, "weight": 0.0}
    for name, p in pp.items():
        for what, a, b in (("grad", pk[name].grad, p.grad),
                           ("weight", pk[name], p)):
            rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            if rel > 1e-4:
                fail(f"phase {phase} exactness: {name} {what} differs by "
                     f"{rel} of its max-abs (> 1e-4)")
            worst[what] = max(worst[what], rel)
    err_l = (gk - gp).abs().max().item()
    if not err_l <= LOGIT_TOL:
        fail(f"phase {phase} exactness: prefill logits differ by {err_l} > "
             f"{LOGIT_TOL}")
    print(f"phase {phase} exactness at {model_name}'s widths, f32, "
          f"{t['exact_layers']} layers, B {t['exact_B']} x S "
          f"{t['ragged_S']}: one SGD step with the kernels and one with the "
          f"plain versions: loss {lk} vs {lp} (rel "
          f"{abs(lk - lp) / abs(lp):.2e}, tol 1e-5); worst gradient "
          f"{worst['grad']:.2e} and updated weight {worst['weight']:.2e} of "
          f"their max-abs (tol 1e-4); prefill logits max abs err {err_l} "
          f"(tol {LOGIT_TOL}) [{card}]", flush=True)
    del runs, pk, pp, gk, gp
    torch.cuda.empty_cache()
    return dict(launches=launches, losses=losses, ms_per_step=ms,
                ragged_losses=loss_r, ragged_ms=1e3 * sec_r[1], peak_gib=peak,
                held_gib=held, params_b=n_params / 1e9, route=route,
                profile=None if prof is None else dict(
                    wall_ms=prof[0], busy_ms=prof[1], groups=prof[2],
                    idle_share=1 - prof[1] / prof[0]),
                k0_rmsnorm_err=k0_errs,
                exact=dict(loss_rel=abs(lk - lp) / abs(lp), **worst,
                           prefill_logits_err=err_l))


def flash_options(llama, fa, cu, ex_attn, dev, gen, card):
    """Phase za: flash attention's options on the card. za1 Mistral-7B's
    sliding window (32/8 heads, D 128, window 4096) at B 1 x S 8192 bf16
    through ``flash_attention_local``; za2 packed documents at the 0.77B
    llama's attention widths, B 4 x S 8192 bf16, through
    ``flash_attention_segmented``; za3 A8 at D 32 with a window through
    ``flash_attention_packed``, ``flash_attention(kv_len=...)``, and every
    option through the f32 bodies; each forward and backward through
    autograd (one launch of each masked kernel), each kernel against plain,
    the main cases timed beside the dense causal kernels, their bounds over
    the live pairs and SDPA with the element mask; the example twin
    (``cubecl_tpu_torch/examples/attention.py``); za4 the llama at
    Phi-3-mini's widths (``train_at_widths``)."""
    out = {}
    m = MISTRAL_ATTN
    out["window"] = option_case(
        fa, dev, gen, card, "za1 Mistral-7B sliding window",
        lambda q, k, v: fa.flash_attention_local(q, k, v, m["left"], 0),
        m["B"], m["H"], m["Hkv"], m["S"], m["D"], torch.bfloat16, True,
        dict(window=(m["left"], 0)), m["plain_heads"], timed=True)
    d = DOCS
    seg = doc_ids(np.random.default_rng(29), d["B"], d["S"], d["lo"],
                  d["hi"], d["pad"], dev)
    out["segments"] = option_case(
        fa, dev, gen, card, "za2 packed documents",
        lambda q, k, v: fa.flash_attention_segmented(q, k, v, seg),
        d["B"], d["H"], d["Hkv"], d["S"], d["D"], torch.bfloat16, True,
        dict(seg=(seg, seg)), d["plain_heads"], timed=True)
    out["segments"]["documents"] = [
        int((seg[b, 1:] != seg[b, :-1]).sum()) + 1 for b in range(d["B"])]
    p = PACKED32
    out["packed_d32"] = option_case(
        fa, dev, gen, card, "za3 packed (A8) D32 window",
        lambda q, k, v: fa.flash_attention_packed(q, k, v, True,
                                                  window=p["window"]),
        p["B"], p["H"], p["Hkv"], p["S"], p["D"], torch.bfloat16, True,
        dict(window=p["window"]), timed=True)
    kv = KV_LEN
    out["kv_len"] = option_case(
        fa, dev, gen, card, "za3 kv_len",
        lambda q, k, v: fa.flash_attention(q, k, v, True,
                                           kv_len=kv["kv_len"]),
        kv["B"], kv["H"], kv["Hkv"], kv["S"], kv["D"], torch.bfloat16, True,
        dict(kv_len=kv["kv_len"]), timed=True)
    for name, B, H, Hkv, S, D, causal, opts in ZA_F32:
        if opts == "docs":
            s = doc_ids(np.random.default_rng(31), B, S, 100, 400, 64, dev)
            opts = dict(seg=(s, s))
        mask_kw = dict(opts)

        def fn(q, k, v, causal=causal, kw=mask_kw):
            return fa._padded_attend(q, k, v, causal, q.shape[-1] ** -0.5,
                                     fa._Mask.of(q, k, **kw))

        out[name] = option_case(fa, dev, gen, card, f"za3 {name}", fn, B, H,
                                Hkv, S, D, torch.float32, causal, opts,
                                timed=True)
    _reset_masked(fa)
    got = ex_attn.launch(dev)
    torch.cuda.synchronize()
    if fa.masked_forward.launches != 1 or not all(
            torch.isfinite(t).all() for t in got.values()):
        fail(f"phase za example twin: masked launches "
             f"{fa.masked_forward.launches}, finite "
             f"{[bool(torch.isfinite(t).all()) for t in got.values()]}")
    print(f"phase za examples/attention twin (f32, B1 H2 S512 D128): dense, "
          f"window, block-sparse and paged decode ran; launches "
          f"{_masked_launches(fa)} [{card}]", flush=True)
    out["phi3"] = train_at_widths(llama, fa, cu, dev, gen, card, "za4", PHI3,
                                  PHI3_TRAIN, "Phi-3-mini")
    return out


# -- phase zb: serving at head dim 96 (P1 and P3's D 96 instances) -----------

D96 = 96
# zb1, P1 at D 96 (J_CASES' columns): Phi-3-mini's serving decode (32 kv
# heads of one query head: 256 blocks, one split) at context 1056; B 1 at
# 4096 (8 splits); G 4 on pages of 16 and G 8 on pages of 7, ragged with a
# length-0 row; pages of 1. Each layout (name, B, L, Hkv, G, page,
# max_pages, lengths, (window, sinks)) in full, window + sinks and ring
# mode on bf16, int8 and f32 pools; a ring row's length is its length
# plus half the table's capacity (its slots recycled), a length 0 stays 0
ZB_P1 = [
    (f"{name} {kind} {mode}", B, L, Hkv, G, D96, page, mp,
     [n + page * mp // 2 if n and mode == "ring" else n for n in lens],
     kind, mode, *(opts if mode != "full" else (0, 0)))
    for name, B, L, Hkv, G, page, mp, lens, opts in [
        ("phi3 serve", 8, 4, 32, 1, 128, 9, [1056] * 8, (512, 4)),
        ("phi3 B1 ctx4096", 1, 2, 32, 1, 128, 33, [4096], (2000, 4)),
        ("G4 page16 ragged", 6, 2, 4, 4, 16, 20, [0, 1, 63, 64, 65, 300],
         (100, 20)),
        ("G8 page7 ragged", 5, 2, 2, 8, 7, 40, [0, 7, 70, 129, 280],
         (50, 9)),
        ("G2 page1", 3, 2, 4, 2, 1, 300, [0, 150, 300], (64, 3))]
    for kind in KV_KINDS for mode in ("full", "window", "ring")]
# zb1, P3 at D 96 (CHUNKED_CASES' columns): the verify step (C 5,
# decode-shaped: its positions split), chunked prefill from 0 and from 768
# at Phi-3-mini's widths; a ragged G 4 batch on pages of 7 with a
# length-0 row; each on bf16, int8 and f32 pools
ZB_P3 = [
    (f"{name} {kind}", B, L, Hkv, G, C, D96, page, mp, starts, lens,
     KV_KINDS[kind][0], kind == "int8")
    for name, B, L, Hkv, G, C, page, mp, starts, lens in [
        ("verify", 8, 4, 32, 1, 5, 128, 9, [1051] * 8, None),
        ("prefill start 0", 8, 4, 32, 1, 256, 128, 9, [0] * 8, None),
        ("prefill start 768", 8, 4, 32, 1, 256, 128, 9, [768] * 8, None),
        ("ragged G4 page7", 4, 2, 2, 4, 16, 7, 40, [0, 1, 127, 200],
         [0, 17, 143, 216])]
    for kind in KV_KINDS]
# zb2: the llama at Phi-3-mini's widths (PHI3), bf16, 32 layers: B 8 x a
# 1024-token prompt, 32 greedy steps, chunks of 256, the verify step of
# gamma + 1 tokens, 4 beams of 16 tokens after the first prompt; windowed
# (phase z1's sinks 4 and window 2000 after a 4096-token prompt) and on a
# ring (phase z2's 17 pages of 16, sinks 16, window 240, 320 steps from an
# empty cache)
PHI3_SERVE = dict(B=8, S=1024, steps=32, page=128, pages=9, chunk=256,
                  gamma=4, beams=4, beam_steps=16)
PHI3_STREAM = dict(B=4, S=4096, steps=16, page=128, pages=33, sinks=4,
                   window=2000)
PHI3_RING = dict(B=8, steps=320, page=16, pages=17, sinks=16, window=240)
# speculative decoding's drafts as phase k chooses them: the model itself,
# and a small llama of the target's vocabulary (here also its head dim)
PHI3_DRAFT = dict(vocab=32064, d_model=768, n_heads=8, n_kv_heads=8,
                  n_layers=4, d_ff=2048, dtype="bfloat16",
                  use_framework_kernels=False)
# zb3: f32 exactness at full width, 2 layers: B 2 x a 200-token prompt on
# pages of 16, 24 greedy steps, a verify chunk of 5, chunked prefill in
# chunks of 64, 150 windowed steps (sinks 4, window 64) and 150 on a ring
# of 9 pages (sinks 16, window 112) from an empty cache, 4 beams of 16
# tokens after the first prompt
PHI3_EXACT = dict(layers=2, B=2, S=200, steps=24, C=5, page=16, pages=16,
                  chunk=64, stream_steps=150, window=64, sinks=4,
                  ring_pages=9, ring_sinks=16, ring_window=112, beams=4,
                  beam_steps=16)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# the paths of serve_at_widths beyond generate, prefill_chunked, the verify
# step, speculative decoding with a self-draft and an int8 cache
ZB2_PATHS = ("beam", "small draft", "window", "ring")


def serve_at_widths(llama, pa, fa, dev, card, phase, widths, t, model_name,
                    layers=None, paths=ZB2_PATHS, exact_phase=None):
    """The llama at a model's ``widths`` (``layers`` of them, or its own
    depth) served in bf16 through its entry points, each path's P1 and P3
    launches (P1's row groups past 8 query heads a kv head among them)
    counted from 0 against what it must make: ``generate`` (``t``'s B x S
    + steps; ms/step, tok/s, peak memory), ``prefill_chunked`` in t's
    chunks, a ``decode_chunk`` verify of gamma + 1 tokens,
    ``speculative_generate`` with a self-draft (and with ``paths``' "small
    draft": PHI3_DRAFT; tokens equal to greedy up to the first near tie,
    as phase k), an int8 cache, and of ``paths`` ``beam_generate``,
    windowed (PHI3_STREAM) and ring (PHI3_RING) decode. Phase zb2 at
    Phi-3-mini's widths, zc2 at Mistral-Large-2's, zd2 at GPT-J-6B's,
    zf2 and zf3 at Phi-2's and Pythia-31M's.

    Speculative decoding's tokens and a self-draft's rejections are held
    to twice the verify step's measured difference from the decode steps
    (``d_verify``: max |v - d| of the logits after the same tokens). The
    verify step picks t = argmax v where the draft proposed p = argmax d,
    so a rejection's gap v[t] - v[p] = (v[t] - d[t]) + (d[t] - d[p]) +
    (d[p] - v[p]) <= 2 max |v - d|, as d[t] <= d[p]; the same bounds where
    the greedy stream (d's) and the speculative one (v's) may part. The
    difference is the two paths' rounding: GEMMs of other heights and bf16
    activations (most of it, with or without the kernels), P3's and P1's.
    It does not catch a P3 fault, which widens it: the f32 exactness
    phases (zb3, zc3, zd3, zf4: ``exact_phase``, by default the phase's
    third) hold P3 to the plain route within LOGIT_TOL."""
    cfg = llama.LlamaConfig(**dict(widths, n_layers=layers
                                   or widths["n_layers"]),
                            seq=t["S"], dtype="bfloat16",
                            use_framework_kernels=False)
    L, B, S, steps, page, pages = (cfg.n_layers, t["B"], t["S"], t["steps"],
                                   t["page"], t["pages"])
    # what earlier phases leave allocated, apart from this path's peak
    base = torch.cuda.memory_allocated() / 2**30
    model = llama.init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    out = {}
    tag = f"llama at {model_name}'s widths ({n_params / 1e9:.3f}B bf16)"
    # P1's row groups: a launch past 8 query heads a kv head is grouped;
    # at a head dim without an instance of its own every P1 and P3 launch
    # is a ragged instance's
    grouped = cfg.n_heads // cfg.n_kv_heads > 8
    ragged = cfg.head_dim not in pa.PAGED_HEAD_DIMS

    # generate: prefill + steps greedy
    torch.cuda.reset_peak_memory_stats()
    _reset_paged(fa, pa)
    toks, gen_s = _timed(lambda: llama.generate(model, prompt, steps, pages,
                                                page))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_gen = _check_paged(fa, pa, f"phase {phase} generate", {
        "flash_attention": L, "paged_attention": L * steps,
        "paged_attention_grouped": L * steps * grouped,
        "paged_attention_ragged": L * steps * ragged})
    if toks.shape != (B, steps) or not ((toks >= 0)
                                        & (toks < cfg.vocab)).all():
        fail(f"phase {phase} generate: bad tokens {tuple(toks.shape)}")
    cache = llama.init_kv_cache(cfg, B, pages, page, dev)
    (logits, cache), prefill_s = _timed(lambda: llama.prefill(model, cache,
                                                              prompt))
    if not torch.isfinite(logits.float()).all():
        fail(f"phase {phase}: non-finite prefill logits")
    (again, _), decode_s = _timed(lambda: stream_steps(
        llama, model, cache, logits.argmax(-1).to(torch.int32), steps))
    if not torch.equal(again, toks):
        fail(f"phase {phase}: the warm re-run gave other tokens than generate")
    step_ms = 1e3 * decode_s / steps
    del cache
    print(f"phase {phase} serve {tag}: d{cfg.d_model}, {L} layers, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}: {B} x {S} prompt + {steps} greedy "
          f"steps; generate {gen_s:.3f} s cold; warm prefill {prefill_s:.4f} "
          f"s ({B * S / prefill_s:.0f} prompt tok/s), decode {step_ms:.3f} "
          f"ms/step ({1e3 * B / step_ms:.1f} tok/s); peak memory "
          f"{peak - base:.2f} GiB for the path (weights, cache, "
          f"activations) over {base:.2f} GiB that earlier phases left "
          f"allocated; launches {n_gen} [{card}]", flush=True)
    out["generate"] = dict(generate_s=gen_s, prefill_s=prefill_s,
                           ms_step=step_ms, tok_s=1e3 * B / step_ms,
                           peak_gib=peak - base, launches=n_gen,
                           params_b=n_params / 1e9)

    want, want_logits = greedy_ref(llama, model, prompt, steps, pages, page)
    if not torch.equal(want, toks):
        fail(f"phase {phase}: generate's greedy stream written out differs")

    # beam_generate after the first prompt, its beams forked on the pages
    if "beam" in paths:
        nb, bsteps = t["beams"], t["beam_steps"]
        _reset_paged(fa, pa)
        (btoks, bscores), beam_s = _timed(lambda: llama.beam_generate(
            model, prompt[0], bsteps, beams=nb, page=page))
        n_beam = _check_paged(fa, pa, f"phase {phase} beam_generate", {
            "flash_attention": L, "paged_attention": L * (bsteps - 1),
            "paged_attention_grouped": L * (bsteps - 1) * grouped,
            "paged_attention_ragged": L * (bsteps - 1) * ragged})
        if btoks.shape != (nb, S + bsteps) or not torch.equal(
                btoks[:, :S], prompt[:1].expand(nb, S)) or not \
                torch.isfinite(bscores).all() or \
                (bscores[1:] > bscores[:-1]).any():
            fail(f"phase {phase} beam_generate: beams "
                 f"{tuple(btoks.shape)} lost the prompt or scores "
                 f"{bscores.tolist()} are not finite and descending")
        print(f"phase {phase} beam_generate {tag}: {nb} beams of {bsteps} "
              f"tokens after a {S}-token prompt, {beam_s:.3f} s "
              f"({1e3 * beam_s / bsteps:.2f} ms a token, the prefill "
              f"included); scores "
              f"{[round(x, 3) for x in bscores.tolist()]}; launches "
              f"{n_beam} [{card}]", flush=True)
        out["beam"] = dict(s=beam_s, scores=bscores.tolist(),
                           launches=n_beam)

    # prefill_chunked in chunks of 256, against the one-shot prefill
    c1 = llama.init_kv_cache(cfg, B, pages, page, dev)
    _reset_paged(fa, pa)
    (l_chunk, c1), chunk_s = _timed(lambda: llama.prefill_chunked(
        model, c1, prompt, t["chunk"]))
    n_chunk = _check_paged(fa, pa, f"phase {phase} prefill_chunked", {
        "paged_attention_chunked": L * S // t["chunk"],
        "paged_attention_chunked_ragged": L * S // t["chunk"] * ragged})
    if not torch.isfinite(l_chunk.float()).all():
        fail(f"phase {phase} prefill_chunked: non-finite logits")
    d_chunk = (l_chunk.float() - want_logits[:, 0]).abs().max().item()
    del c1
    pad = "" if cfg.head_dim in fa.KERNEL_HEAD_DIMS else ", padded to " + \
        str(min(d for d in fa.KERNEL_HEAD_DIMS if d > cfg.head_dim))
    print(f"phase {phase} prefill_chunked {tag}: {B} x {S} in chunks of "
          f"{t['chunk']}, {chunk_s:.4f} s ({B * S / chunk_s:.0f} prompt "
          f"tok/s); last logits against the one-shot prefill's (A1{pad}): "
          f"max abs diff {d_chunk:.4f} (bf16 rounding through {L} layers; "
          f"exactness is phase {exact_phase or phase[:-1] + '3'}'s); "
          f"launches {n_chunk} "
          f"[{card}]",
          flush=True)
    out["prefill_chunked"] = dict(s=chunk_s, logit_diff=d_chunk,
                                  launches=n_chunk)

    # the verify step: decode_chunk of gamma + 1 tokens after the prompt
    g = t["gamma"]
    c1 = llama.init_kv_cache(cfg, B, pages, page, dev)
    _, c1 = llama.prefill(model, c1, prompt)
    _reset_paged(fa, pa)
    (l5, c1), verify_s = _timed(lambda: llama.decode_chunk(
        model, c1, want[:, :g + 1]))
    n_verify = _check_paged(fa, pa, f"phase {phase} decode_chunk", {
        "paged_attention_chunked": L,
        "paged_attention_chunked_ragged": L * ragged})
    # the logits after chunk token i are the decode steps' after token i
    d_verify = (l5.float() - want_logits[:, 1:g + 2]).abs().max().item()
    prof = {}
    for name, fn in (
            ("decode step", lambda m, tk: llama.decode_step(
                m, c1, tk[:, 0])[0].float().sum()),
            ("verify step (decode_chunk of 5)", lambda m, tk: llama.
             decode_chunk(m, c1, tk)[0].float().sum())):
        p = profile_step(fn, model, want[:, g + 1:2 * g + 2])
        if p is None:
            print(f"phase {phase} profile of one {name}: the trace holds no "
                  "device time; not measured", flush=True)
            continue
        wall, busy, groups, _ = p
        prof[name] = dict(wall_ms=wall, busy_ms=busy, groups=groups)
        print(f"phase {phase} profile of one {name} {tag}, B {B} at context "
              f"{int(c1.lengths.max())}: wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms (idle {100 - 100 * busy / wall:.1f}%); device "
              f"ms by group "
              f"{ {k: round(v, 3) for k, v in sorted(groups.items())} } "
              f"[{card}]", flush=True)
    del c1
    print(f"phase {phase} decode_chunk {tag}: a verify step of {g + 1} tokens "
          f"(generate's) after the {S}-token prompt in {1e3 * verify_s:.2f} "
          f"ms; logits against the decode steps' max abs diff {d_verify:.4f}"
          f"; launches {n_verify} [{card}]", flush=True)
    out["verify"] = dict(ms=1e3 * verify_s, logit_diff=d_verify,
                         launches=n_verify, profile=prof)
    spec_tol = 2 * d_verify

    # speculative decoding, the drafts as phase k chooses them
    spec = {}
    drafts = [("self-draft", lambda: model)]
    if "small draft" in paths:
        drafts.append(("d768 draft", lambda: llama.init_params(
            llama.LlamaConfig(**PHI3_DRAFT), seed=3, device=dev)))
    for dname, make in drafts:
        draft = make()
        what = f"phase {phase} speculative {dname}"
        _, acc, secs, rounds, st = speculative_checked(
            llama, pa, fa, model, draft, prompt, steps, g, pages, page, want,
            want_logits, spec_tol, dname == "self-draft", what)
        print(f"{what} {tag} (draft head dim {draft.cfg.head_dim}): {B} x "
              f"{steps} tokens, gamma {g}: {rounds} rounds in {secs:.3f} s "
              f"({B * steps / secs:.1f} tok/s), mean acceptance {acc:.3f}; "
              f"{st['rejections']} rejections (largest logit gap "
              f"{st['max_rejection_gap']:.4f}, tolerance {spec_tol:.4f}: "
              f"twice the verify step's difference); tokens equal "
              f"generate's up to the first near tie (prefix "
              f"{st['prefix_min']}..{steps}); launches {st['launches']} "
              f"[{card}]", flush=True)
        spec[dname] = dict(tok_s=B * steps / secs, acceptance=acc,
                          rounds=rounds, **st)
        del draft
    out["speculative"] = spec
    del want_logits

    # int8 KV, fed generate's tokens
    m8 = with_cfg(llama, model, dataclasses.replace(cfg, kv_dtype="int8"))
    c8 = llama.init_kv_cache(m8.cfg, B, pages, page, dev)
    _reset_paged(fa, pa)
    lg8, c8 = llama.prefill(m8, c8, prompt)
    _, s8 = _timed(lambda: stream_steps(llama, m8, c8, None, steps,
                                        feed=want))
    n8 = _check_paged(fa, pa, f"phase {phase} int8 KV", {
        "flash_attention": L, "paged_attention": L * steps,
        "paged_attention_int8": L * steps,
        "paged_attention_grouped": L * steps * grouped,
        "paged_attention_ragged": L * steps * ragged})
    agree8 = (lg8.argmax(-1) == want[:, 0]).float().mean().item()
    del m8, c8
    torch.cuda.empty_cache()
    print(f"phase {phase} int8 KV {tag}: {B} x {S} prompt + {steps} steps fed "
          f"generate's tokens, {1e3 * s8 / steps:.3f} ms/step "
          f"({B * steps / s8:.1f} tok/s); first token equal to the bf16 "
          f"cache's in {agree8:.3f} of the rows; launches {n8} [{card}]",
          flush=True)
    out["int8"] = dict(ms_step=1e3 * s8 / steps, launches=n8)

    if "window" in paths:
        # windowed decode: phase z1's sinks and window after a 4096-token
        # prompt
        z = PHI3_STREAM
        mw = with_cfg(llama, model, dataclasses.replace(
            cfg, attn_window=z["window"], attn_sinks=z["sinks"]))
        pw = torch.from_numpy(np.random.default_rng(42).integers(
            0, cfg.vocab, (z["B"], z["S"]), dtype=np.int32)).to(dev)
        cw = llama.init_kv_cache(mw.cfg, z["B"], z["pages"], z["page"], dev)
        _reset_paged(fa, pa)
        lw, cw = llama.prefill(mw, cw, pw)
        (_, lgw), sw = _timed(lambda: stream_steps(
            llama, mw, cw, lw.argmax(-1).to(torch.int32), z["steps"]))
        nw = _check_paged(fa, pa, f"phase {phase} windowed decode", {
            "flash_attention": L, "paged_attention": L * z["steps"],
            "paged_attention_window": L * z["steps"],
            "paged_attention_grouped": L * z["steps"] * grouped,
            "paged_attention_ragged": L * z["steps"] * ragged})
        if not torch.isfinite(lgw).all():
            fail(f"phase {phase} windowed decode: non-finite logits")
        del mw, cw, pw, lgw
        torch.cuda.empty_cache()
        print(f"phase {phase} windowed decode {tag} (sinks {z['sinks']}, "
              f"window {z['window']}): {z['B']} x {z['S']} prompt "
              f"(full-attention prefill) + {z['steps']} windowed steps at "
              f"{1e3 * sw / z['steps']:.3f} ms/step "
              f"({z['B'] * z['steps'] / sw:.1f} tok/s); launches {nw} "
              f"[{card}]", flush=True)
        out["window"] = dict(ms_step=1e3 * sw / z["steps"], launches=nw)

    if "ring" in paths:
        # ring decode: phase z2's ring, from an empty cache past its capacity
        r = PHI3_RING
        mr = with_cfg(llama, model, dataclasses.replace(
            cfg, attn_window=r["window"], attn_sinks=r["sinks"],
            ring_cache=True))
        rc = llama.init_kv_cache(mr.cfg, r["B"], r["pages"], r["page"], dev)
        first = torch.from_numpy(np.random.default_rng(43).integers(
            0, cfg.vocab, (r["B"],), dtype=np.int32)).to(dev)
        _reset_paged(fa, pa)
        (_, lgr), sr = _timed(lambda: stream_steps(llama, mr, rc, first,
                                                   r["steps"]))
        nr = _check_paged(fa, pa, f"phase {phase} ring decode", {
            "paged_attention": L * r["steps"],
            "paged_attention_ring": L * r["steps"],
            "paged_attention_grouped": L * r["steps"] * grouped,
            "paged_attention_ragged": L * r["steps"] * ragged})
        if rc.k.shape[2] != r["B"] * r["pages"] or \
                int(rc.lengths.min()) != r["steps"] or \
                not torch.isfinite(lgr).all():
            fail(f"phase {phase} ring decode: the ring grew, lost count or "
                 "gave non-finite logits")
        del mr, rc, lgr
        print(f"phase {phase} ring decode {tag} (sinks {r['sinks']}, "
              f"window {r['window']}, {r['pages']} pages of {r['page']}): "
              f"{r['B']} rows x {r['steps']} steps from an empty cache, "
              f"{1e3 * sr / r['steps']:.3f} ms/step; launches {nr} [{card}]",
              flush=True)
        out["ring"] = dict(ms_step=1e3 * sr / r["steps"], launches=nr)
    del model
    torch.cuda.empty_cache()
    return out


def exactness_at_widths(llama, pa, fa, dev, card, phase, widths, e,
                        model_name, extras=True):
    """The llama at a model's ``widths`` in f32 with ``e``'s layers,
    kernels against the plain route: prefill and decode-step logits (the
    plain run fed the kernels' tokens), a verify chunk, chunked prefill
    and, with ``extras``, windowed and ring decode within LOGIT_TOL, and
    beam search's beams equal and its scores within LOGIT_TOL; the
    kernels' greedy tokens equal the plain route's own up to the first
    near tie (LOGIT_TOL). Phase zb3 at Phi-3-mini's widths, zc3 at
    Mistral-Large-2's."""
    cfg = llama.LlamaConfig(**dict(widths, n_layers=e["layers"]),
                            seq=e["S"], use_framework_kernels=False)
    grouped = cfg.n_heads // cfg.n_kv_heads > 8
    ragged = cfg.head_dim not in pa.PAGED_HEAD_DIMS
    L, B, steps = cfg.n_layers, e["B"], e["steps"]
    model = llama.init_params(cfg, seed=1, device=dev)
    rng = np.random.default_rng(44)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, e["S"]),
                                           dtype=np.int32)).to(dev)
    chunk5 = torch.from_numpy(rng.integers(0, cfg.vocab, (B, e["C"]),
                                           dtype=np.int32)).to(dev)
    first = prompt[:, -1]
    runs, errs = {}, {}
    for kernels in (True, False):
        _reset_paged(fa, pa)
        c = llama.init_kv_cache(cfg, B, e["pages"], e["page"], dev)
        lg, c = llama.prefill(model, c, prompt, kernels=kernels)
        feed = runs[True]["toks"] if not kernels else None
        toks, lgs = stream_steps(llama, model, c,
                                 lg.argmax(-1).to(torch.int32), steps,
                                 feed=feed, kernels=kernels)
        l5, _ = llama.decode_chunk(model, c, chunk5, kernels=kernels)
        cc = llama.init_kv_cache(cfg, B, e["pages"], e["page"], dev)
        lcp, _ = llama.prefill_chunked(model, cc, prompt, e["chunk"],
                                       kernels=kernels)
        streams = []
        for over, pages in ((dict(attn_window=e["window"],
                                  attn_sinks=e["sinks"]), e["pages"]),
                            (dict(attn_window=e["ring_window"],
                                  attn_sinks=e["ring_sinks"],
                                  ring_cache=True), e["ring_pages"])) \
                if extras else ():
            m = with_cfg(llama, model, dataclasses.replace(cfg, **over))
            cs = llama.init_kv_cache(m.cfg, B, pages, e["page"], dev)
            fs = runs[True]["stream_toks"][len(streams)] if not kernels \
                else None
            streams.append(stream_steps(llama, m, cs, first,
                                        e["stream_steps"], feed=fs,
                                        kernels=kernels))
        n = _paged_counts(fa, pa)
        runs[kernels] = dict(lg=lg.float(), toks=toks, lgs=lgs, l5=l5.float(),
                             lcp=lcp.float(), stream_toks=[s[0] for s in
                                                           streams],
                             stream_lgs=[s[1] for s in streams], launches=n)
    ns = e["stream_steps"] if extras else 0
    want_n = {"flash_attention": L, "paged_attention": L * (steps + 2 * ns),
              "paged_attention_window": L * ns,
              "paged_attention_ring": L * ns, "paged_attention_int8": 0,
              "paged_attention_grouped": L * (steps + 2 * ns) * grouped,
              "paged_attention_ragged": L * (steps + 2 * ns) * ragged,
              "paged_attention_chunked": L * (1 + -(-e["S"] // e["chunk"])),
              "paged_attention_chunked_ragged":
                  L * (1 + -(-e["S"] // e["chunk"])) * ragged}
    if runs[True]["launches"] != want_n:
        fail(f"phase {phase}: kernel launches {runs[True]['launches']}, want "
             f"{want_n}")
    if any(runs[False]["launches"].values()):
        fail(f"phase {phase}: the plain route launched "
             f"{runs[False]['launches']}")
    k, p = runs[True], runs[False]
    errs = {"prefill": (k["lg"] - p["lg"]).abs().max().item(),
            "decode steps": (k["lgs"] - p["lgs"]).abs().max().item(),
            "verify chunk": (k["l5"] - p["l5"]).abs().max().item(),
            "prefill_chunked": (k["lcp"] - p["lcp"]).abs().max().item()}
    for i, what in enumerate(("windowed steps", "ring steps")[:len(
            k["stream_lgs"])]):
        errs[what] = (k["stream_lgs"][i]
                      - p["stream_lgs"][i]).abs().max().item()
    bad = {n: v for n, v in errs.items() if not v <= LOGIT_TOL}
    if bad:
        fail(f"phase {phase}: logits differ by more than {LOGIT_TOL}: {bad}")

    # beam search from the first prompt, kernels against the plain route
    if extras:
        beams = {}
        for kernels in (True, False):
            _reset_paged(fa, pa)
            beams[kernels] = llama.beam_generate(
                model, prompt[0], e["beam_steps"], beams=e["beams"],
                page=e["page"], kernels=kernels)
            _check_paged(fa, pa, f"phase {phase} beam_generate", {
                "flash_attention": L * kernels,
                "paged_attention": L * (e["beam_steps"] - 1) * kernels,
                "paged_attention_grouped":
                    L * (e["beam_steps"] - 1) * kernels * grouped,
                "paged_attention_ragged":
                    L * (e["beam_steps"] - 1) * kernels * ragged})
        (tk_b, sk_b), (tp_b, sp_b) = beams[True], beams[False]
        errs["beam scores"] = (sk_b - sp_b).abs().max().item()
        if not torch.equal(tk_b, tp_b) or errs["beam scores"] > LOGIT_TOL:
            fail(f"phase {phase} beam_generate: kernels against the plain "
                 f"route, beams equal {torch.equal(tk_b, tp_b)}, scores "
                 f"differ by {errs['beam scores']} (tol {LOGIT_TOL})")
    # greedy tokens: the plain route's own run, against the kernels'
    ptoks, plgs = greedy_ref(llama, model, prompt, steps, e["pages"],
                             e["page"], kernels=False)
    prefix, agree = tie_prefix(k["toks"], ptoks, plgs, LOGIT_TOL,
                               f"phase {phase} greedy tokens, kernels "
                               "against the plain route")
    more = (f", {ns} windowed (sinks {e['sinks']}, window {e['window']}) "
            f"and {ns} ring steps (sinks {e['ring_sinks']}, window "
            f"{e['ring_window']}, {e['ring_pages']} pages of {e['page']}), "
            f"{e['beams']} beams of {e['beam_steps']} tokens (beams equal)"
            if extras else "")
    print(f"phase {phase} exactness llama at {model_name}'s widths, f32, "
          f"{L} layers: {B} x {e['S']} prompt + {steps} greedy steps, a "
          f"verify chunk of {e['C']}, prefill_chunked in chunks of "
          f"{e['chunk']}{more}, "
          f"kernels against plain fed the same tokens: max abs err {errs} "
          f"(tol {LOGIT_TOL}); greedy tokens equal the plain route's up to "
          f"the first near tie (prefix {min(prefix)}..{steps}, agreeing from "
          f"the start {agree}); launches {runs[True]['launches']} [{card}]",
          flush=True)
    del model, runs
    torch.cuda.empty_cache()
    return dict(errs, launches=k["launches"], tie_prefix_min=min(prefix))


def serve_d96(llama, pa, fa, dev, gen, card):
    """Phase zb: serving at head dim 96 on the card. zb1 P1's and P3's
    D 96 instances against their plain versions (ZB_P1, ZB_P3), timed
    beside the D 128 instances, zb2 the llama at Phi-3-mini's widths
    served at full depth in bf16 (``phi3_serve``), zb3 its f32 exactness
    with 2 layers (``phi3_exactness``)."""
    t0 = time.perf_counter()
    out = dict(p1=p1_vs_plain(pa, dev, gen, card, "zb1", ZB_P1, beside=128),
               p3=chunked_vs_plain(pa, dev, gen, card, "zb1", ZB_P3,
                                   beside=128))
    out["serve"] = serve_at_widths(llama, pa, fa, dev, card, "zb2", PHI3,
                                   PHI3_SERVE, "Phi-3-mini")
    out["exact"] = exactness_at_widths(llama, pa, fa, dev, card, "zb3",
                                       PHI3, PHI3_EXACT, "Phi-3-mini")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase zb took {out['seconds']:.1f} s [{card}]", flush=True)
    return out



# -- phase zc: P1 past 8 query heads a kv head, Mistral-Large-2's widths ------

# Mistral-Large-Instruct-2407's widths (Mistral Large 2; its config.json on
# the Hugging Face hub, mistralai/Mistral-Large-Instruct-2407: hidden 12288,
# 96 heads on 8 kv heads of 128, so 12 query heads a kv head,
# intermediate 28672, 88 layers, vocab 32768, rope_theta 1e6, rms_norm_eps
# 1e-5): the llama's block (RMSNorm, SwiGLU, full RoPE, no biases). The
# port's llama ties the output head to the embedding, where the checkpoint
# has a head of its own: the served weights are random anyway.
MISTRAL_LARGE_2 = dict(vocab=32768, d_model=12288, n_heads=96, n_kv_heads=8,
                       n_layers=88, d_ff=28672, rope_theta=1e6, rms_eps=1e-5)
# zc2 serves 8 of the 88 layers (11.5B parameters, 23 GB in bf16), so that
# the model fits one card beside what earlier phases leave allocated and the
# phase stays inside the script's time limit
ZC_LAYERS = 8
# zc1, P1 past 8 query heads a kv head (J_CASES' columns): Mistral-Large-2's
# serving decode (B 8 x Hkv 8 x G 12, D 128, context 1056); G 16 at D 128
# (B 8 x Hkv 2, context 2048); Falcon-7B's multi-query attention (71 heads
# on one kv head, D 64, context 2048); G 9 at D 96, ragged with a length-0
# row on pages of 7; G 12 on pages of 1. Each layout (name, B, L, Hkv, G,
# D, page, max_pages, lengths, (window, sinks)) in full, window + sinks and
# ring mode on bf16, int8 and f32 pools; a ring row's length is its length
# plus half the table's capacity (its slots recycled), a length 0 stays 0
ZC_P1 = [
    (f"{name} {kind} {mode}", B, L, Hkv, G, D, page, mp,
     [n + page * mp // 2 if n and mode == "ring" else n for n in lens],
     kind, mode, *(opts if mode != "full" else (0, 0)))
    for name, B, L, Hkv, G, D, page, mp, lens, opts in [
        ("mistral-large-2 serve", 8, 4, 8, 12, 128, 128, 9, [1056] * 8,
         (512, 4)),
        ("G16 ctx2048", 8, 4, 2, 16, 128, 128, 16, [2048] * 8, (1024, 4)),
        ("falcon-7b G71 ctx2048", 8, 4, 1, 71, 64, 128, 16, [2048] * 8,
         (1024, 4)),
        ("G9 D96 page7 ragged", 5, 2, 2, 9, 96, 7, 40, [0, 7, 70, 129, 280],
         (50, 9)),
        ("G12 page1", 3, 2, 4, 12, 128, 1, 300, [0, 150, 300], (64, 3))]
    for kind in KV_KINDS for mode in ("full", "window", "ring")]
# zc1, P3 past 8 (CHUNKED_CASES' columns): Mistral-Large-2's verify step (C
# 5: 60 rows, decode-shaped, its positions split) and chunked prefill from
# 0 and from 768 (C 256: 48 row tiles); G 16's and Falcon-7B's verify step
# at context 2048; each on bf16, int8 and f32 pools
ZC_P3 = [
    (f"{name} {kind}", B, L, Hkv, G, C, D, page, mp, starts, None,
     KV_KINDS[kind][0], kind == "int8")
    for name, B, L, Hkv, G, C, D, page, mp, starts in [
        ("mistral-large-2 verify", 8, 4, 8, 12, 5, 128, 128, 9, [1051] * 8),
        ("mistral-large-2 prefill start 0", 8, 4, 8, 12, 256, 128, 128, 9,
         [0] * 8),
        ("mistral-large-2 prefill start 768", 8, 4, 8, 12, 256, 128, 128, 9,
         [768] * 8),
        ("G16 verify", 8, 4, 2, 16, 5, 128, 128, 16, [2043] * 8),
        ("falcon-7b G71 verify", 8, 4, 1, 71, 5, 64, 128, 16, [2043] * 8)]
    for kind in KV_KINDS]
# zc2: the llama at Mistral-Large-2's widths, bf16, ZC_LAYERS layers: B 8 x
# a 1024-token prompt, 32 greedy steps, chunks of 256, the verify step of
# gamma + 1 tokens, a self-draft, an int8 cache
ZC_SERVE = dict(B=8, S=1024, steps=32, page=128, pages=9, chunk=256,
                gamma=4)
# zc3: f32 exactness at full width, 2 layers: B 2 x a 200-token prompt on
# pages of 16, 24 greedy steps, a verify chunk of 5, chunked prefill in
# chunks of 64
ZC_EXACT = dict(layers=2, B=2, S=200, steps=24, C=5, page=16, pages=16,
                chunk=64)


def serve_grouped(llama, pa, fa, dev, gen, card):
    """Phase zc: P1 past 8 query heads a kv head on the card. zc1 P1's row
    groups in every mode and on every pool against their plain version
    (ZC_P1), each timed (cold L2) beside the same call at G 2, which reads
    the same K/V bytes, and P3 at G 12, 16 and 71 (ZC_P3); zc2 the llama at
    Mistral-Large-2's widths (ZC_LAYERS layers, bf16) served through
    ``generate``, ``prefill_chunked``, a verify ``decode_chunk``,
    ``speculative_generate`` with a self-draft and an int8 cache
    (``serve_at_widths``); zc3 its f32 exactness with 2 layers
    (``exactness_at_widths``)."""
    t0 = time.perf_counter()
    out = dict(p1=p1_vs_plain(pa, dev, gen, card, "zc1", ZC_P1,
                              beside_group=2),
               p3=chunked_vs_plain(pa, dev, gen, card, "zc1", ZC_P3))
    out["serve"] = serve_at_widths(llama, pa, fa, dev, card, "zc2",
                                   MISTRAL_LARGE_2, ZC_SERVE,
                                   "Mistral-Large-2", layers=ZC_LAYERS,
                                   paths=())
    out["exact"] = exactness_at_widths(llama, pa, fa, dev, card, "zc3",
                                       MISTRAL_LARGE_2, ZC_EXACT,
                                       "Mistral-Large-2", extras=False)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase zc took {out['seconds']:.1f} s [{card}]", flush=True)
    return out



# -- phase zd: head dim 256 (A1's forward, P1, P3), GPT-J-6B's widths ---------

D256 = 256
# GPT-J-6B's widths (its config.json on the Hugging Face hub,
# EleutherAI/gpt-j-6b: n_embd 4096, n_head 16, so 16 heads of 256 with no
# GQA, n_layer 28, n_inner null (4 x 4096 = 16384), vocab_size 50400,
# layer_norm_epsilon 1e-5, rotary base 10000) through the llama's block,
# which differs from GPT-J's in RMSNorm for LayerNorm, SwiGLU over three
# 16384-wide matrices for GELU over two, full RoPE for rotary_dim 64, a
# sequential residual for the parallel one and the output head tied to the
# embedding: 7.72B parameters, 15.4 GB in bf16, at full depth
GPTJ_6B = dict(vocab=50400, d_model=4096, n_heads=16, n_kv_heads=16,
               n_layers=28, d_ff=16384, rope_theta=10000.0, rms_eps=1e-5)
# Qwen3-Next-80B-A3B's full-attention layers (Qwen/Qwen3-Next-80B-A3B-
# Instruct's config.json: 16 query heads on 2 kv heads of 256, G 8): the
# kernel cases' grouped layout at D 256
QWEN3_NEXT_H, QWEN3_NEXT_HKV = 16, 2
# zd1, A1's forward at D 256 (flash_attention and the public functions
# over it): (name, function, B, H, Hkv, S, D, options) at GPT-J's prefill
# (B 8 x 16 heads x S 1024) and Qwen3-Next's (B 2 x 16/2 x S 4096), a
# ragged tail (S 1021), flash_attention_padded at D 192 and 160 (padded to
# 256), kv_len and a window (masked); each in bf16 and f32
ZD_A1 = [
    ("gpt-j prefill", "flash_attention", 8, 16, 16, 1024, D256, {}),
    ("qwen3-next prefill", "flash_attention", 2, QWEN3_NEXT_H,
     QWEN3_NEXT_HKV, 4096, D256, {}),
    ("ragged S1021", "flash_attention", 8, 16, 16, 1021, D256, {}),
    ("padded D192", "flash_attention_padded", 8, 16, 16, 1024, 192, {}),
    ("padded D160", "flash_attention_padded", 8, 16, 16, 1024, 160, {}),
    ("kv_len 900", "flash_attention", 8, 16, 16, 1024, D256,
     dict(kv_len=900)),
    ("window 1024", "flash_attention_local", 2, QWEN3_NEXT_H,
     QWEN3_NEXT_HKV, 4096, D256, dict(left=1023))]
# zd1, P1 at D 256 (J_CASES' columns): GPT-J's serving decode (B 8 x 16 kv
# heads of one query head, context 1056), Qwen3-Next's (B 8 x 2 kv heads of
# 8, context 4096), G 12 on one kv head (the grouped kernel), G 4 ragged
# with a length-0 row on pages of 7, and pages of 1; each layout in full,
# window + sinks and ring mode on bf16, int8 and f32 pools (a ring row's
# length: its length plus half the table's capacity, a length 0 stays 0)
ZD_P1 = [
    (f"{name} {kind} {mode}", B, L, Hkv, G, D256, page, mp,
     [n + page * mp // 2 if n and mode == "ring" else n for n in lens],
     kind, mode, *(opts if mode != "full" else (0, 0)))
    for name, B, L, Hkv, G, page, mp, lens, opts in [
        ("gpt-j serve", 8, 4, 16, 1, 128, 9, [1056] * 8, (512, 4)),
        ("qwen3-next ctx4096", 8, 4, QWEN3_NEXT_HKV, 8, 128, 33, [4096] * 8,
         (2000, 4)),
        ("G12 grouped", 4, 2, 1, 12, 128, 16, [2048] * 4, (1024, 4)),
        ("G4 page7 ragged", 5, 2, 2, 4, 7, 40, [0, 7, 70, 129, 280],
         (50, 9)),
        ("G2 page1", 3, 2, 4, 2, 1, 300, [0, 150, 300], (64, 3))]
    for kind in KV_KINDS for mode in ("full", "window", "ring")]
# zd1, P3 at D 256 (CHUNKED_CASES' columns): the verify step (C 5) and
# chunked prefill (C 256) from 0 and from 768 at GPT-J's and Qwen3-Next's
# widths, each on bf16, int8 and f32 pools
ZD_P3 = [
    (f"{name} {kind}", B, L, Hkv, G, C, D256, page, mp, starts, None,
     KV_KINDS[kind][0], kind == "int8")
    for name, B, L, Hkv, G, C, page, mp, starts in [
        ("gpt-j verify", 8, 4, 16, 1, 5, 128, 9, [1051] * 8),
        ("gpt-j prefill start 0", 8, 4, 16, 1, 256, 128, 9, [0] * 8),
        ("gpt-j prefill start 768", 8, 4, 16, 1, 256, 128, 9, [768] * 8),
        ("qwen3-next verify", 8, 4, QWEN3_NEXT_HKV, 8, 5, 128, 33,
         [4091] * 8),
        ("qwen3-next prefill start 0", 2, 4, QWEN3_NEXT_HKV, 8, 256, 128, 33,
         [0] * 2),
        ("qwen3-next prefill start 768", 2, 4, QWEN3_NEXT_HKV, 8, 256, 128,
         33, [768] * 2)]
    for kind in KV_KINDS]
# zd2: the llama at GPT-J-6B's widths, bf16, all 28 layers: B 8 x a
# 1024-token prompt, 32 greedy steps, chunks of 256, the verify step of
# gamma + 1 tokens, a self-draft, 4 beams of 16 tokens after the first
# prompt, an int8 cache, phase zb2's window (sinks 4, window 2000 after a
# 4096-token prompt) and ring (17 pages of 16, 320 steps)
ZD_SERVE = dict(B=8, S=1024, steps=32, page=128, pages=9, chunk=256,
                gamma=4, beams=4, beam_steps=16)
ZD2_PATHS = ("beam", "window", "ring")


def a1_vs_plain(fa, dev, gen, card, phase, cases):
    """A1's forward at D 256 against its plain version, one case (ZD_A1) a
    row and dtype (bf16, f32), under no_grad as prefill runs it: the
    public function's launch counted (flash_attention, or masked_forward
    with an option), its output against flash_attention_plain at the real
    D (GQA repeated inside the plain version); CUDA-event times back to
    back and with a cold L2, the same call at D 128 (same B, heads and
    context, half the bytes) with a cold L2, the plain version's time, the
    bound over the live pairs at the real D and SDPA's time (``is_causal``
    and ``enable_gqa``; with an option the element mask as a bool
    ``attn_mask``, kv heads repeated outside the call; f32 with TF32 off);
    in f32 the CUDA-core body's time of CUDA_CORE_F32_MS beside it."""
    rows = {}
    for name, fname, B, H, Hkv, S, D, opts in cases:
        for dt in (torch.bfloat16, torch.float32):
            fn = getattr(fa, fname)
            q = torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
            k, v = (torch.randn(B, Hkv, S, D, generator=gen,
                                device=dev).to(dt) for _ in range(2))
            masked = bool(opts)
            call = lambda q_, k_, v_: fn(q_, k_, v_, **opts)  # noqa: E731
            what = (f"A1 {name} {_dt(dt)} B{B} H{H}/{Hkv} S{S} D{D} causal"
                    f"{' ' + str(opts) if opts else ''} ({fname})")
            counter = fa.masked_forward if masked else fa.flash_attention
            n0 = counter.launches
            with torch.no_grad():
                got = call(q, k, v)
            torch.cuda.synchronize()
            if counter.launches != n0 + 1:
                fail(f"phase {phase} {what}: the kernel did not launch once")
            plain_opts = {}
            if "kv_len" in opts:
                plain_opts["kv_len"] = opts["kv_len"]
            if "left" in opts:
                plain_opts["window"] = (opts["left"], 0)
            plain = lambda: fa.flash_attention_plain(  # noqa: E731
                q, k, v, True, **plain_opts)
            err = compare(got, plain(), f"phase {phase} {what}")
            with torch.no_grad():
                ms = cuda_ms(lambda: call(q, k, v), iters=10)
                cold = cold_ms(lambda: call(q, k, v))
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            # the bound over the live pairs and the keys they read (a
            # kv_len's tail is never read)
            live = fa._live_mask(q, k, True, **plain_opts)
            pairs, keys = int(live.sum()), int(live.any(0).sum())
            bms, by = flash_bound(B, H, Hkv, S, keys, D, dt, True,
                                  pairs=pairs)
            row = dict(max_abs_err=err, ms=ms, cold_ms=cold,
                       plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       live_pairs=pairs, keys_read=keys, library_ms=None)
            # SDPA in either dtype (f32 with TF32 off)
            if masked:
                kr, vr = (t.repeat_interleave(H // Hkv, 1) for t in (k, v))
                row["library_ms"] = cuda_ms(
                    lambda: TF.scaled_dot_product_attention(
                        q, kr, vr, attn_mask=live), iters=5)
                del kr, vr
            else:
                row["library_ms"] = cuda_ms(
                    lambda: TF.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), iters=10)
            del q, k, v, got, live
            q = torch.randn(B, H, S, 128, generator=gen, device=dev).to(dt)
            k, v = (torch.randn(B, Hkv, S, 128, generator=gen,
                                device=dev).to(dt) for _ in range(2))
            with torch.no_grad():
                row["d128_cold_ms"] = cold_ms(lambda: call(q, k, v))
            del q, k, v
            torch.cuda.empty_cache()
            rows[f"{name} {_dt(dt)}"] = row
            was = CUDA_CORE_F32_MS.get(phase, {}).get(name)
            print(f"phase {phase} {what}: max abs err {err} (atol/rtol "
                  f"{TOL[dt]}); kernel {ms:.4f} ms back to back, {cold:.4f} "
                  f"ms cold L2 (D 128 at the same B, heads and context "
                  f"{row['d128_cold_ms']:.4f} ms)"
                  + (f"; on the CUDA cores, a constant of this script from "
                     f"an earlier run, {was[0]:.4f} ms cold (D 128 "
                     f"{was[1]:.4f})" if dt == torch.float32 and was
                     else "")
                  + f"; plain {plain_ms:.4f} ms; SDPA "
                  f"{row['library_ms']:.4f} ms; bound {bms:.4f} ms ({by}, "
                  f"{pairs} live pairs a row and head, {keys} keys read; "
                  f"{100 * bms / cold:.1f}% of it cold) [{card}]",
                  flush=True)
    return rows


def serve_d256(llama, pa, fa, dev, gen, card):
    """Phase zd: head dim 256 on the card. zd1 A1's forward (ZD_A1), P1 in
    every mode on every pool, the grouped kernel among them (ZD_P1), and
    P3 (ZD_P3) against their plain versions, each timed (cold L2) beside
    the same call at D 128; zd2 the llama at GPT-J-6B's widths at full
    depth (28 layers, bf16) served through ``generate``,
    ``prefill_chunked``, a verify ``decode_chunk``, ``speculative_generate``
    with a self-draft, ``beam_generate``, an int8 cache, windowed and ring
    decode (``serve_at_widths``); zd3 its f32 exactness with 2 layers
    (``exactness_at_widths``)."""
    t0 = time.perf_counter()
    out = dict(a1=a1_vs_plain(fa, dev, gen, card, "zd1", ZD_A1),
               p1=p1_vs_plain(pa, dev, gen, card, "zd1", ZD_P1, beside=128),
               p3=chunked_vs_plain(pa, dev, gen, card, "zd1", ZD_P3,
                                   beside=128))
    out["serve"] = serve_at_widths(llama, pa, fa, dev, card, "zd2", GPTJ_6B,
                                   ZD_SERVE, "GPT-J-6B", paths=ZD2_PATHS)
    out["exact"] = exactness_at_widths(llama, pa, fa, dev, card, "zd3",
                                       GPTJ_6B, PHI3_EXACT, "GPT-J-6B")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase zd took {out['seconds']:.1f} s [{card}]", flush=True)
    return out


# -- phase ze: training at head dim 256 (A3/A4 at D 256; GPT-J-6B) ---------

# ze1, A3 and A4 at D 256: (name, public function, B, H, Hkv, Sq, Skv, D,
# causal, options as ``_Mask.of`` takes them) at GPT-J's training shape (B
# 8 x 16 heads x S 1024, causal), Qwen3-Next's (B 2 x 16/2 x S 4096, G 8), a
# ragged S 1021, cross lengths (Sq 512 on Skv 1024), non-causal, the padded
# route from D 192 and 160 (padded to 256), and the masked options (kv_len
# 900 of 1024, a window of 1024 at S 4096, packed documents of 256-2048
# tokens at S 4096); each in bf16 and f32
ZE_A34 = [
    ("gpt-j train", "flash_attention", 8, 16, 16, 1024, 1024, D256, True,
     {}),
    ("qwen3-next train", "flash_attention", 2, QWEN3_NEXT_H, QWEN3_NEXT_HKV,
     4096, 4096, D256, True, {}),
    ("ragged S1021", "flash_attention", 8, 16, 16, 1021, 1021, D256, True,
     {}),
    ("cross Sq512 Skv1024", "flash_attention", 8, 16, 16, 512, 1024, D256,
     True, {}),
    ("non-causal", "flash_attention", 2, 16, 16, 1024, 1024, D256, False,
     {}),
    ("padded D192", "flash_attention_padded", 8, 16, 16, 1024, 1024, 192,
     True, {}),
    ("padded D160", "flash_attention_padded", 8, 16, 16, 1024, 1024, 160,
     True, {}),
    ("kv_len 900", "flash_attention", 8, 16, 16, 1024, 1024, D256, True,
     dict(kv_len=900)),
    ("window 1024", "flash_attention_local", 2, QWEN3_NEXT_H,
     QWEN3_NEXT_HKV, 4096, 4096, D256, True, dict(window=(1023, 0))),
    ("segments", "flash_attention_segmented", 2, QWEN3_NEXT_H,
     QWEN3_NEXT_HKV, 4096, 4096, D256, True, dict(seg="docs"))]
# ze2: the llama at GPT-J-6B's widths trained at full depth (28 layers, bf16)
# as phase za4 trains Phi-3-mini's; ze3 its f32 exactness with 2 layers.
# Memory reckoned from the widths: 28.8 GiB of bf16 weights and SGD grads,
# ~22 GiB of activations at B 4 x S 1024, 2-3 GiB of logits and their
# grads: ~53 GiB
ZE_TRAIN = dict(B=4, S=1024, steps=4, ragged_S=1000, exact_layers=2,
                exact_B=2)


def _public(fa, fname, causal, opts):
    """The public function of a ZE_A34 case on (q, k, v)."""
    if fname == "flash_attention_local":
        return lambda q, k, v: fa.flash_attention_local(
            q, k, v, *opts["window"], causal)
    if fname == "flash_attention_segmented":
        return lambda q, k, v: fa.flash_attention_segmented(
            q, k, v, opts["seg"][0], None, causal)
    return lambda q, k, v: getattr(fa, fname)(q, k, v, causal, **opts)


def _a34_kernels(fa, q, k, v, do, causal, scale, opts):
    """A1 (with lse), A3 and A4 on (q, k, v, do) at their head dim, dense
    or masked as ``opts`` say: (forward, dkv, dq, counters), the last two
    calls on the forward's o and lse (set by calling the first)."""
    mask = fa._Mask.of(q, k, **opts)
    st = {}

    def fwd():
        o, lse = (fa._flash_forward(q, k, v, causal, scale, True)
                  if mask is None else
                  fa.masked_forward(q, k, v, mask, causal, scale, True))
        # di as the autograd Function takes it
        st.update(lse=lse, di=(do.float() * o.float()).sum(-1))
        return o, lse

    if mask is None:
        def dkv():
            return fa.flash_bwd_dkv(q, k, v, do, st["lse"], st["di"], causal,
                                    scale)

        def dq():
            return fa.flash_bwd_dq(q, k, v, do, st["lse"], st["di"], causal,
                                   scale)
        return fwd, dkv, dq, (fa.flash_attention, fa.flash_bwd_dkv,
                              fa.flash_bwd_dq)

    def dkv():
        return fa.masked_dkv(q, k, v, do, st["lse"], st["di"], mask, causal,
                             scale)

    def dq():
        return fa.masked_dq(q, k, v, do, st["lse"], st["di"], mask, causal,
                            scale)
    return fwd, dkv, dq, (fa.masked_forward, fa.masked_dkv, fa.masked_dq)


def a34_vs_plain(fa, dev, gen, card, phase, cases):
    """A3 and A4 at D 256 against their plain versions, one case (ZE_A34) a
    row and dtype (bf16, f32), as phase d holds them: the public function
    forward and backward through autograd (one launch of each of A1, A3,
    A4, dense or masked), its output and grads equal to the kernels' called
    alone (D below 256 padded to it, the grads sliced back), the lse-writing
    forward's o and lse within TOL of the plain forward's (lse at f32 TOL),
    the grads within TOL of the plain backward that rounds p and dS as the
    kernels do and within EXACT_BWD_TOL of the exact one, at the real D,
    and a second call bit
    for bit; then each kernel's cold-L2 time beside the same call at D
    128, the plain backward's time, the bound over the live pairs at the
    real D (4 products a pair for dK/dV, 3 for dQ) and SDPA's autograd
    backward (``is_causal`` and ``enable_gqa``; with an option the element
    mask as a bool ``attn_mask``, kv heads repeated outside the call; f32
    with TF32 off); in f32 the CUDA-core dK/dV's time of CUDA_CORE_F32_MS
    beside it."""
    rows = {"dkv": {}, "dq": {}}
    worst = (0.0, "")
    for name, fname, B, H, Hkv, Sq, Skv, D, causal, opts in cases:
        if opts.get("seg") == "docs":
            ids = doc_ids(np.random.default_rng(24), B, Sq, 256, 2048, 128,
                          dev)
            opts = dict(seg=(ids, ids))
        plain_opts = dict(opts)
        for dt in (torch.bfloat16, torch.float32):
            q, do = (torch.randn(B, H, Sq, D, generator=gen, device=dev)
                     .to(dt) for _ in range(2))
            k, v = (torch.randn(B, Hkv, Skv, D, generator=gen, device=dev)
                    .to(dt) for _ in range(2))
            what = (f"A3/A4 {name} {_dt(dt)} B{B} H{H}/{Hkv} Sq{Sq} "
                    f"Skv{Skv} D{D} {'causal' if causal else 'non-causal'} "
                    f"({fname})")
            scale = D ** -0.5
            pad = (lambda t: TF.pad(t, (0, D256 - D))) if D < D256 \
                else (lambda t: t)
            fwd, dkv, dqk, counters = _a34_kernels(
                fa, *(pad(t) for t in (q, k, v, do)), causal, scale, opts)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            n0 = [c.launches for c in counters]
            out = _public(fa, fname, causal, opts)(*leaves)
            out.backward(do)
            torch.cuda.synchronize()
            if [c.launches - n for c, n in zip(counters, n0)] != [1, 1, 1]:
                fail(f"phase {phase} {what}: autograd did not launch A1, A3 "
                     "and A4 once each")
            o, lse = fwd()
            o = o[..., :D]
            dk, dv = dkv()
            dq = dqk()
            torch.cuda.synchronize()
            got = [t[..., :D] for t in (dq, dk, dv)]
            if not torch.equal(o, out.detach()) or not all(
                    torch.equal(t.grad, g) for t, g in zip(leaves, got)):
                fail(f"phase {phase} {what}: the autograd Function's output "
                     "or grads are not the kernels'")
            del leaves, out
            o_ref, lse_ref = fa.flash_attention_plain(
                q, k, v, causal, scale, return_lse=True, **plain_opts)
            err_o = compare(o, o_ref, f"phase {phase} {what}: o")
            err_lse = compare(lse, lse_ref, f"phase {phase} {what}: lse")
            del o_ref, lse_ref
            exact, rounded = (plain_bwd(
                fa, q, k, v, o, lse, do, causal, scale, round_p_ds=rnd,
                **plain_opts) for rnd in (False, True))
            torch.cuda.synchronize()
            err_r, err, need = zip(*(compare_bwd(
                a, r, e, f"phase {phase} {what}: d{n}")
                for n, a, r, e in zip("qkv", got, rounded, exact)))
            del exact, rounded
            need_k = tuple(x[0] for x in need)  # the kernels' (not plain's)
            if max(need_k) > worst[0]:
                worst = (max(need_k), what)
            again = (dqk(), *dkv())
            if not all(torch.equal(a, b) for a, b in zip(again, (dq, dk,
                                                                 dv))):
                fail(f"phase {phase} {what}: a second call of the kernels "
                     "differs")
            del again
            dkv_ms, dq_ms = cold_ms(dkv), cold_ms(dqk)
            plain_ms = cuda_ms(lambda: fa.flash_attention_backward_plain(
                q, k, v, o, lse, do, causal, scale, **plain_opts), iters=3,
                warmup=1)
            live = fa._live_mask(q, k, causal, **plain_opts)
            if live is None:
                pairs, keys = Sq * Skv, Skv
            else:
                lead = live.shape[0] if live.dim() == 4 else 1
                flat = live.reshape(-1, Sq, Skv)
                pairs = int(flat.sum()) // lead
                keys = int(flat.any(1).sum()) // lead
            elem = torch.finfo(dt).bits // 8
            stats = 8 * B * H * Sq  # lse and di, f32
            b_dkv = flash_bound(B, H, Hkv, Sq, keys, D, dt, causal, 4,
                                elem * D * 2 * B * Hkv * keys + stats,
                                pairs=pairs)
            b_dq = flash_bound(B, H, Hkv, Sq, keys, D, dt, causal, 3,
                               elem * D * B * H * Sq + stats, pairs=pairs)
            # SDPA's backward in either dtype (f32 with TF32 off)
            if live is None:
                lib = cuda_ms(grad_call(
                    lambda q_, k_, v_: TF.scaled_dot_product_attention(
                        q_, k_, v_, is_causal=causal, enable_gqa=True),
                    (q, k, v), do), iters=5)
            else:
                kr, vr = (t.repeat_interleave(H // Hkv, 1) for t in (k, v))
                lib = cuda_ms(grad_call(
                    lambda q_, k_, v_: TF.scaled_dot_product_attention(
                        q_, k_, v_, attn_mask=live), (q, kr, vr), do),
                    iters=3)
                del kr, vr
            del live, dq, dk, dv, got
            # the same call at D 128
            t128 = [torch.randn(B, h, s, 128, generator=gen, device=dev)
                    .to(dt) for h, s in ((H, Sq), (Hkv, Skv), (Hkv, Skv),
                                         (H, Sq))]
            fwd128, dkv128, dq128, _ = _a34_kernels(fa, *t128, causal, None,
                                                    opts)
            fwd128()
            d128 = (cold_ms(dkv128), cold_ms(dq128))
            del t128, fwd128, dkv128, dq128, q, k, v, do, o, lse
            torch.cuda.empty_cache()
            key = f"{name} {_dt(dt)}"
            was = (CUDA_CORE_F32_MS.get(phase, {}).get(name)
                   if dt == torch.float32 else None)
            was_dq = (CUDA_CORE_DQ_MS.get(phase, {}).get(name)
                      if dt == torch.float32 else None)
            common = dict(o_err=err_o, lse_err=err_lse, plain_ms=plain_ms,
                          library_ms=lib, live_pairs=pairs,
                          keys_read=keys, atol_vs_exact=dict(
                              zip(("dq", "dk", "dv"), need_k)))
            rows["dkv"][key] = dict(
                common, max_abs_err=max(err[1:]),
                max_abs_err_vs_rounding_plain=max(err_r[1:]), ms=dkv_ms,
                bound_ms=b_dkv[0], bound_by=b_dkv[1], d128_cold_ms=d128[0])
            rows["dq"][key] = dict(
                common, max_abs_err=err[0],
                max_abs_err_vs_rounding_plain=err_r[0], ms=dq_ms,
                bound_ms=b_dq[0], bound_by=b_dq[1], d128_cold_ms=d128[1])
            print(f"phase {phase} {what}: one autograd pass launched A1, A3, "
                  f"A4 once each, its grads the kernels'; A1 against the "
                  f"plain forward: max abs err o {err_o}, lse {err_lse} "
                  f"(atol/rtol {TOL[dt]}; lse {TOL[torch.float32]}); A3/A4 "
                  f"against the plain "
                  f"backward that rounds p and dS as the kernels do: dq "
                  f"{err_r[0]}, dk {err_r[1]}, dv {err_r[2]} (atol/rtol "
                  f"{TOL[dt]}); against the exact one: dq {err[0]}, dk "
                  f"{err[1]}, dv {err[2]} (atol/rtol {EXACT_BWD_TOL[dt]}; "
                  f"the atol each needs at that rtol, kernel and rounding "
                  f"plain: dq {need[0]}, dk {need[1]}, dv {need[2]}); two "
                  f"calls bit-identical; "
                  f"cold L2: dK/dV {dkv_ms:.4f} ms (D 128 {d128[0]:.4f}; "
                  f"bound {b_dkv[0]:.4f}, {b_dkv[1]}, "
                  f"{100 * b_dkv[0] / dkv_ms:.1f}% of it"
                  + (f"; on the CUDA cores, a constant of this script from "
                     f"an earlier run, {was[0]:.4f} (D 128 {was[1]:.4f})"
                     if was else "")
                  + f"), dQ {dq_ms:.4f} ms (D 128 {d128[1]:.4f}; bound "
                  f"{b_dq[0]:.4f}, {b_dq[1]}, {100 * b_dq[0] / dq_ms:.1f}% "
                  f"of it"
                  + (f"; on the CUDA cores, a constant of this script from "
                     f"an earlier run, {was_dq[0]:.4f} (D 128 "
                     f"{was_dq[1]:.4f})" if was_dq else "")
                  + f"); plain backward {plain_ms:.4f} ms; SDPA's "
                  f"backward {lib:.4f} ms; {pairs} live pairs a row and "
                  f"head, {keys} keys read [{card}]", flush=True)
    print(f"phase {phase}: the largest atol (at rtol "
          f"{EXACT_BWD_TOL[torch.bfloat16][1]}) that A3/A4 at D 256 need "
          f"against the exact plain backward: {worst[0]:.3g} ({worst[1]}) "
          f"[{card}]", flush=True)
    rows["worst_atol_vs_exact"] = dict(atol=worst[0], case=worst[1])
    return rows


def train_d256(llama, fa, cu, dev, gen, card):
    """Phase ze: training at head dim 256. ze1 A3 and A4 at D 256
    (ZE_A34) against their plain versions; ze2 the llama at GPT-J-6B's
    widths trained at full depth (28 layers, bf16), ze3 its f32 exactness
    with 2 layers (``train_at_widths``)."""
    t0 = time.perf_counter()
    out = dict(a34=a34_vs_plain(fa, dev, gen, card, "ze1", ZE_A34))
    out["train"] = train_at_widths(llama, fa, cu, dev, gen, card, "ze2",
                                   GPTJ_6B, ZE_TRAIN, "GPT-J-6B",
                                   exact_phase="ze3")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase ze took {out['seconds']:.1f} s [{card}]", flush=True)
    return out



# -- phase zf: serving at head dims 80 and 32 (P1 and P3; Phi-2, Pythia-31M)

D80, D32 = 80, 32
# Phi-2's widths (its config.json on the Hugging Face hub, microsoft/phi-2:
# hidden_size 2560, 32 heads of 80 with no GQA, 32 layers,
# intermediate_size 10240, vocab_size 51200, rope_theta 10000,
# layer_norm_eps 1e-5) through the llama's block, which differs from
# Phi-2's in RMSNorm for LayerNorm, SwiGLU over three 10240-wide matrices
# for a GELU MLP over two, full RoPE for partial_rotary_factor 0.4, a
# sequential residual for the parallel one and the output head tied to
# the embedding: 3.49B parameters, 6.97 GB in bf16, at full depth
PHI_2 = dict(vocab=51200, d_model=2560, n_heads=32, n_kv_heads=32,
             n_layers=32, d_ff=10240, rope_theta=10000.0, rms_eps=1e-5)
# H2O-Danube-1.8B (h2oai/h2o-danube-1.8b-base's config.json: 32 query heads
# on 8 kv heads of 80, G 4): the kernel cases' grouped layout at D 80
DANUBE_H, DANUBE_HKV = 32, 8
# Pythia-31M's widths (EleutherAI/pythia-31m's config.json: hidden_size
# 256, 8 heads of 32, 6 layers, intermediate_size 1024, vocab_size 50304,
# rotary_emb_base 10000, layer_norm_eps 1e-5) through the llama's block
# likewise (GPT-NeoX's LayerNorm, GELU MLP, rotary_pct 0.25 and parallel
# residual not kept): 8 heads prefill through flash_attention_packed (A8,
# D 32 padded to 64), as the JAX model routes them
PYTHIA_31M = dict(vocab=50304, d_model=256, n_heads=8, n_kv_heads=8,
                  n_layers=6, d_ff=1024, rope_theta=10000.0, rms_eps=1e-5)
# zf1, P1 at D 80 and 32 (J_CASES' columns): Phi-2's serving decode (B 8 x
# 32 kv heads of one query head, context 1056) and Danube's (B 8 x 8 kv
# heads of 4, context 4096) at D 80; at D 32 PACKED32's widths (B 8 x 16
# heads, context 2048: Pythia-31M's own decode does not load the card);
# at both G 12 on one kv head (the grouped kernel), G 4 ragged with a
# length-0 row on pages of 7, and pages of 1; each layout in full, window +
# sinks and ring mode on bf16, int8 and f32 pools (a ring row's length:
# its length plus half the table's capacity, a length 0 stays 0)
ZF_LAYOUTS = {
    D80: [("phi-2 serve", 8, 4, 32, 1, 128, 9, [1056] * 8, (512, 4)),
          ("danube G4 ctx4096", 8, 4, DANUBE_HKV, DANUBE_H // DANUBE_HKV,
           128, 33, [4096] * 8, (2000, 4))],
    D32: [("B8 H16 ctx2048", 8, 4, PACKED32["Hkv"], 1, 128, 16,
           [2048] * 8, (1024, 4))]}
ZF_P1 = {D: [
    (f"{name} {kind} {mode}", B, L, Hkv, G, D, page, mp,
     [n + page * mp // 2 if n and mode == "ring" else n for n in lens],
     kind, mode, *(opts if mode != "full" else (0, 0)))
    for name, B, L, Hkv, G, page, mp, lens, opts in ZF_LAYOUTS[D] + [
        ("G12 grouped", 4, 2, 1, 12, 128, 16, [2048] * 4, (1024, 4)),
        ("G4 page7 ragged", 5, 2, 2, 4, 7, 40, [0, 7, 70, 129, 280],
         (50, 9)),
        ("G2 page1", 3, 2, 4, 2, 1, 300, [0, 150, 300], (64, 3))]
    for kind in KV_KINDS for mode in ("full", "window", "ring")]
    for D in (D80, D32)}
# zf1, P3 at D 80 and 32 (CHUNKED_CASES' columns): the verify step (C 5)
# and chunked prefill (C 256) from 0 and from 768 on Phi-2's layout (32 kv
# heads of one query head), Danube's G 4 verify step at context 4096, a
# ragged G 4 batch on pages of 7 with a length-0 row; each on bf16, int8
# and f32 pools
ZF_P3 = {D: [
    (f"{name} {kind}", B, L, Hkv, G, C, D, page, mp, starts, lens,
     KV_KINDS[kind][0], kind == "int8")
    for name, B, L, Hkv, G, C, page, mp, starts, lens in [
        ("phi-2 verify", 8, 4, 32, 1, 5, 128, 9, [1051] * 8, None),
        ("phi-2 prefill start 0", 8, 4, 32, 1, 256, 128, 9, [0] * 8, None),
        ("phi-2 prefill start 768", 8, 4, 32, 1, 256, 128, 9, [768] * 8,
         None),
        ("danube G4 verify", 8, 4, DANUBE_HKV, DANUBE_H // DANUBE_HKV, 5,
         128, 33, [4091] * 8, None),
        ("ragged G4 page7", 4, 2, 2, 4, 16, 7, 40, [0, 1, 127, 200],
         [0, 17, 143, 216])]
    for kind in KV_KINDS]
    for D in (D80, D32)}
# the instance each D is timed beside (cold L2, the same call): the
# nearest built head dim
ZF_BESIDE = {D80: 96, D32: 64}


def serve_d80_d32(llama, pa, fa, dev, gen, card):
    """Phase zf: serving at head dims 80 and 32 on the card. zf1 P1 in
    every mode on every pool, the grouped kernel among them (ZF_P1), and
    P3 (ZF_P3) against their plain versions at both head dims, each timed
    (cold L2) beside the same call at the nearest built D (ZF_BESIDE); zf2
    the llama at Phi-2's widths at full depth (32 layers, bf16) and zf3 at
    Pythia-31M's (6 layers) served through ``generate``,
    ``prefill_chunked``, a verify ``decode_chunk``, ``speculative_generate``
    with a self-draft, ``beam_generate``, an int8 cache, windowed and ring
    decode (``serve_at_widths``); zf4 the f32 exactness of both with 2
    layers (``exactness_at_widths``)."""
    t0 = time.perf_counter()
    out = {}
    # a head dim past 256 is refused on the card before any launch, naming
    # ROADMAP Queue 2a (every D up to 256 runs: phase zh)
    for D in (288, 320):
        q = torch.zeros(2, 4, D, device=dev, dtype=torch.bfloat16)
        kp = torch.zeros(1, 2, 4, 16, D, device=dev, dtype=torch.bfloat16)
        table = torch.arange(4, device=dev, dtype=torch.int32).view(2, 2)
        ln = torch.tensor([3, 20], device=dev, dtype=torch.int32)
        for what, call in (
                ("P1", lambda: pa.paged_attention(q, kp, kp, table, ln)),
                ("P3", lambda: pa.paged_attention_chunked(
                    q[:, :, None], kp, kp, table, ln, ln - 1))):
            try:
                call()
                fail(f"phase zf1: {what} at D {D} did not raise")
            except ValueError as e:
                if "Queue 2a" not in str(e):
                    fail(f"phase zf1: {what} at D {D} raised {e}")
    print(f"phase zf1: P1 and P3 refuse D 288 and 320 on the card, naming "
          f"ROADMAP Queue 2a [{card}]", flush=True)
    for D in (D80, D32):
        out[f"p1 d{D}"] = p1_vs_plain(pa, dev, gen, card, "zf1", ZF_P1[D],
                                      beside=ZF_BESIDE[D])
        out[f"p3 d{D}"] = chunked_vs_plain(pa, dev, gen, card, "zf1",
                                           ZF_P3[D], beside=ZF_BESIDE[D])
    out["phi-2"] = serve_at_widths(llama, pa, fa, dev, card, "zf2", PHI_2,
                                   ZD_SERVE, "Phi-2", paths=ZD2_PATHS,
                                   exact_phase="zf4")
    out["pythia-31m"] = serve_at_widths(llama, pa, fa, dev, card, "zf3",
                                        PYTHIA_31M, ZD_SERVE, "Pythia-31M",
                                        paths=ZD2_PATHS, exact_phase="zf4")
    out["exact"] = {name: exactness_at_widths(
        llama, pa, fa, dev, card, "zf4", widths, PHI3_EXACT, name)
        for name, widths in (("Phi-2", PHI_2), ("Pythia-31M", PYTHIA_31M))}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase zf took {out['seconds']:.1f} s [{card}]", flush=True)
    return out

# -- phase zg: Mamba trained on the card (S1's backward), A5-A7 padded ------

# zg2: Mamba-130M's widths (MAMBA_130M) trained at the paper's context, L
# 2048, f32, scan_impl "auto" (S1 and its backward once a layer a step). B
# 2: at B 4 the step's own 57.6 GiB (autograd keeps a and h, 1.6 GB a
# layer) came on top of the 12.6 GiB that earlier phases hold, a peak of
# 70.2 GiB of the card's 80 GB (PERF.md section 6)
ZG_TRAIN = dict(B=2, L=2048, steps=3)
# SGD's step for zg2: at B 2 the llama phases' TRAIN_LR (0.1) overshot,
# the third step's loss above the second's (10.97, 9.71, 10.30; PERF.md
# section 6); at 0.03 the loss falls smoothly in CPU runs at 2 and 8
# layers
ZG_LR = 0.03
# zg3: exactness at full width, 4 layers, B 2 x L 512, f32
ZG_EXACT = dict(layers=4, B=2, L=512)
# the f32 train step's bounds (PERF.md section 2): the loss to 1e-5
# relative, each grad to 1e-4 of its max-abs
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-5, 1e-4
# zg4: Phi-2's attention widths (32 heads of 80) in phase x's long-context
# block-sparse training shape (B 1 x S 8192, bf16, causal, band mask at
# block 512), padded to D 128; then S 1024 cases at D 32, 80 and 96:
# (name, H, D, dtype, causal, block_q, block_k, mask)
ZG_BSP_MAIN = dict(B=1, H=32, S=8192, D=80, dtype=torch.bfloat16, block=512)
ZG_BSP_CASES = [
    ("D32 f32 non-causal band", 16, 32, torch.float32, False, 128, 128,
     "band"),
    ("D32 bf16 holed", 16, 32, torch.bfloat16, True, 128, 128, "holed"),
    ("D32 bf16 bq 128 x bk 64, F9 rows", 16, 32, torch.bfloat16, True, 128,
     64, "f9"),
    ("D80 f32 bq 128 x bk 64, F9 rows", 16, 80, torch.float32, True, 128, 64,
     "f9"),
    ("D96 f32 holed", 16, 96, torch.float32, True, 128, 128, "holed"),
    ("D96 bf16 non-causal band", 16, 96, torch.bfloat16, False, 128, 128,
     "band"),
    ("D96 bf16 bq 128 x bk 64, F9 rows", 16, 96, torch.bfloat16, True, 128,
     64, "f9"),
]
NO_LIBRARY_SCAN_BWD = ("none: no one PyTorch call computes the reverse of a "
                       "first-order linear recurrence")


def scan_bwd_vs_plain(ssm, dev, gen, card):
    """Phase zg1: S1's backward (``scan_bwd_kernel``) against
    ``scan_chunked_core_backward_plain`` at SCAN_CASES in f32 and bf16, on
    the forward kernel's own h, one launch a case; its cold-L2 time, the
    plain version's and the bound (5 array passes: a, h, dh read, da, du
    written)."""
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for name, B, L, DN in SCAN_CASES:
            af = (torch.exp(-torch.rand(B, L, DN, generator=gen,
                                        device=dev)) * .9).to(dt)
            uf = (torch.randn(B, L, DN, generator=gen, device=dev) * .1
                  ).to(dt)
            dh = (torch.randn(B, L, DN, generator=gen, device=dev) * .1
                  ).to(dt)
            h = ssm.scan_chunked_core(af, uf)
            ssm.scan_chunked_core_backward.launches = 0
            da, du = ssm.scan_chunked_core_backward(af, h, dh)
            torch.cuda.synchronize()
            launches = ssm.scan_chunked_core_backward.launches
            what = f"S1 backward {name} {_dt(dt)} ({B}, {L}, {DN})"
            if launches != 1:
                fail(f"phase zg1 {what}: {launches} launches, want 1")
            ref_da, ref_du = ssm.scan_chunked_core_backward_plain(af, h, dh)
            err = max(compare(da, ref_da, f"phase zg1 {what}: da"),
                      compare(du, ref_du, f"phase zg1 {what}: du"))
            if da[:, 0].any():
                fail(f"phase zg1 {what}: da at t = 0 is not zero")
            del ref_da, ref_du
            elem = torch.finfo(dt).bits // 8
            ms = cold_ms(lambda: ssm.scan_chunked_core_backward(af, h, dh))
            plain_ms = cuda_ms(
                lambda: ssm.scan_chunked_core_backward_plain(af, h, dh),
                iters=2 if L > 1 else 10, warmup=1)
            bms, by = bound_ms(3 * B * L * DN, 5 * B * L * DN * elem, dt)
            key = f"{name} {_dt(dt)}"
            rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, launches=launches,
                             gb_per_s=5 * B * L * DN * elem / ms / 1e6)
            print(f"phase zg1 {what}: max abs err {err} (atol/rtol "
                  f"{TOL[dt]}); kernel {ms:.4f} ms cold L2 "
                  f"({rows[key]['gb_per_s']:.0f} GB/s), plain {plain_ms:.4f}"
                  f" ms, bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of "
                  f"it); library: none [{card}]", flush=True)
            del af, uf, dh, h, da, du
            torch.cuda.empty_cache()
    return rows


def _mamba_grads(mamba, ssm, cfg, tokens, dev, kernels):
    """Loss, grads and the (S1, S1 backward) launches of one backward of
    ``loss_fn`` on a model from seed 4."""
    model = mamba.init_params(cfg, seed=4, device=dev).requires_grad_(True)
    ssm.scan_chunked_core.launches = 0
    ssm.scan_chunked_core_backward.launches = 0
    loss = mamba.loss_fn(model, tokens, kernels=kernels)
    loss.backward()
    torch.cuda.synchronize()
    launches = (ssm.scan_chunked_core.launches,
                ssm.scan_chunked_core_backward.launches)
    grads = {k: p.grad for k, p in model.named_parameters()}
    return loss.item(), grads, launches


def train_mamba(mamba, ssm, dev, card):
    """Phase zg2: Mamba at Mamba-130M's published widths (24 layers, f32)
    trained by ``make_train_step`` at B 2 x L 2048 on one batch, scan_impl
    "auto": the loss finite and falling from step to step, S1 and its
    backward launched once a layer a step (counted from 0 over the steps),
    ms/step, peak memory and one profiled step (the device's idle share).
    Phase zg3: at the same widths with 4 layers, B 2 x L 512, the loss
    and grads of the kernels against S1's plain halves and against the
    doubling scan under autograd, within the f32 train step's bounds."""
    cfg = mamba.MambaConfig(**dict(MAMBA_130M, seq=ZG_TRAIN["L"]))
    B, L, steps = ZG_TRAIN["B"], ZG_TRAIN["L"], ZG_TRAIN["steps"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    model = mamba.init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    step = mamba.make_train_step(cfg, ZG_LR)
    tokens = torch.from_numpy(np.random.default_rng(26).integers(
        0, cfg.vocab, (B, L + 1), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssm.scan_chunked_core.launches = 0
    ssm.scan_chunked_core_backward.launches = 0
    losses, secs = _train(step, model, tokens, steps)
    torch.cuda.synchronize()
    launches = {"scan_chunked_core": ssm.scan_chunked_core.launches,
                "scan_chunked_core_backward":
                    ssm.scan_chunked_core_backward.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: cfg.n_layers * steps for k in launches}
    if launches != want:
        fail(f"phase zg2: kernel launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses) or not all(
            a > b for a, b in zip(losses, losses[1:])):
        fail(f"phase zg2: losses {losses} are not finite and falling")
    prof = profile_step(step, model, tokens)
    ms = 1e3 * statistics.median(secs[1:])
    traced = "no device time in the trace" if prof is None else (
        f"one more step traced: {prof[0]:.2f} ms wall, {prof[1]:.2f} ms "
        f"busy ({100 * (1 - prof[1] / prof[0]):.1f}% idle), by group "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            prof[2].items(), key=lambda kv: -kv[1]))
        + "; longest other kernels " + ", ".join(
            f"{k} {v:.2f}" for k, v in prof[3]))
    print(f"phase zg2 train Mamba at Mamba-130M's widths "
          f"({n_params / 1e6:.1f}M f32: d{cfg.d_model}, {cfg.n_layers} "
          f"layers, d_state {cfg.d_state}, expand {cfg.expand}, vocab "
          f"{cfg.vocab}, scan_impl auto): B {B} x L {L}, SGD lr {ZG_LR}, "
          f"{steps} steps on one batch: losses {losses}; {ms:.2f} ms/step "
          f"warm (median of steps 2-{steps}; step 1 {1e3 * secs[0]:.2f} ms), "
          f"{B * L / ms * 1e3:.0f} tok/s; peak memory {peak:.2f} GiB "
          f"({held:.2f} GiB held before the phase); launches over the "
          f"{steps} steps {launches}; {traced} [{card}]", flush=True)
    out = dict(launches=launches, losses=losses, ms_per_step=ms,
               step_ms=[1e3 * x for x in secs], peak_gib=peak, held_gib=held,
               params_m=n_params / 1e6, B=B, L=L,
               profile=None if prof is None else dict(
                   wall_ms=prof[0], busy_ms=prof[1], groups=prof[2],
                   idle_share=1 - prof[1] / prof[0]))
    del model, step, tokens
    torch.cuda.empty_cache()

    ecfg = mamba.MambaConfig(**dict(MAMBA_130M, n_layers=ZG_EXACT["layers"],
                                    seq=ZG_EXACT["L"]))
    etok = torch.from_numpy(np.random.default_rng(27).integers(
        0, ecfg.vocab, (ZG_EXACT["B"], ZG_EXACT["L"] + 1),
        dtype=np.int32)).to(dev)
    lk, gk, nk = _mamba_grads(mamba, ssm, ecfg, etok, dev, True)
    if nk != (ecfg.n_layers, ecfg.n_layers):
        fail(f"phase zg3: (S1, S1 backward) launches {nk}, want "
             f"{ecfg.n_layers} each")
    exact = {}
    for name, c, kernels in (
            ("plain", ecfg, False),
            ("assoc", dataclasses.replace(ecfg, scan_impl="assoc"), True)):
        lr_, gr, nr = _mamba_grads(mamba, ssm, c, etok, dev, kernels)
        if nr != (0, 0):
            fail(f"phase zg3 {name}: the kernels ran ({nr} launches)")
        rel = abs(lk - lr_) / abs(lr_)
        if rel > TRAIN_LOSS_REL:
            fail(f"phase zg3: loss {lk} with the kernels, {lr_} {name} "
                 f"(rel {rel} > {TRAIN_LOSS_REL})")
        worst, at = 0.0, ""
        for k, r in gr.items():
            g_rel = ((gk[k] - r).abs().max()
                     / r.abs().max().clamp_min(1e-30)).item()
            if not g_rel <= TRAIN_GRAD_REL:
                fail(f"phase zg3: grad {k} differs from {name}'s by {g_rel} "
                     f"of its max-abs (> {TRAIN_GRAD_REL})")
            if g_rel >= worst:
                worst, at = g_rel, k
        exact[name] = dict(loss=lr_, loss_rel=rel, worst_grad_rel=worst,
                           worst_grad=at)
        del gr
        torch.cuda.empty_cache()
    print(f"phase zg3 exactness at Mamba-130M's widths, f32, "
          f"{ecfg.n_layers} layers, B {ZG_EXACT['B']} x L {ZG_EXACT['L']}: "
          f"loss and grads with S1 and its backward ({nk[0]} and {nk[1]} "
          f"launches) against S1's plain halves: loss {lk} vs "
          f"{exact['plain']['loss']} (rel {exact['plain']['loss_rel']:.2e}),"
          f" worst grad {exact['plain']['worst_grad_rel']:.2e} of its "
          f"max-abs ({exact['plain']['worst_grad']}); against the doubling "
          f"scan: loss rel {exact['assoc']['loss_rel']:.2e}, worst grad "
          f"{exact['assoc']['worst_grad_rel']:.2e} "
          f"({exact['assoc']['worst_grad']}) (tol {TRAIN_LOSS_REL}, "
          f"{TRAIN_GRAD_REL}) [{card}]", flush=True)
    out["exact"] = dict(loss=lk, launches=nk, **exact)
    del gk
    torch.cuda.empty_cache()
    return out


def mamba_train_and_padded_bsp(mamba, ssm, fa, dev, gen, card):
    """Phase zg: zg1 S1's backward against plain, zg2 and zg3 Mamba
    trained (``train_mamba``), zg4 A5-A7 at head dims 80, 32 and 96 padded
    to the built 64 and 128 (``bsp_case``): Phi-2's heads at ZG_BSP_MAIN,
    timed, then ZG_BSP_CASES."""
    t0 = time.perf_counter()
    out = dict(zg1=scan_bwd_vs_plain(ssm, dev, gen, card))
    out.update(train_mamba(mamba, ssm, dev, card))
    m = ZG_BSP_MAIN
    bsp = {"main": bsp_case(fa, dev, gen, card, "Phi-2 heads", m["B"],
                            m["H"], m["S"], m["D"], m["dtype"], True,
                            m["block"], m["block"], "band", True, "zg4")}
    for name, H, D, dt, causal, bq, bk, kind in ZG_BSP_CASES:
        bsp[name] = bsp_case(fa, dev, gen, card, name, 1, H, 1024, D, dt,
                             causal, bq, bk, kind, False, "zg4")
    out["zg4"] = bsp
    out["seconds"] = time.perf_counter() - t0
    print(f"phase zg took {out['seconds']:.1f} s [{card}]", flush=True)
    return out


# -- phase zh: every head dim up to 256 (A5-A7 at D 256; P1/P3 ragged) ----

# zh1: GPT-J-6B's attention widths (16 heads of 256) in phase x's
# long-context block-sparse training shape (B 1 x S 8192, bf16, causal,
# the band mask at block 512), each kernel timed with a cold L2 beside the
# same call at D 128; then S 1024 cases at D 256 and at D 160 and 192
# (padded to 256): (name, H, D, dtype, causal, block_q, block_k, mask)
ZH_BSP_MAIN = dict(B=1, H=16, S=8192, D=D256, dtype=torch.bfloat16,
                   block=512)
ZH_BSP_CASES = [
    ("D256 f32 holed", 16, D256, torch.float32, True, 128, 128, "holed"),
    ("D256 bf16 non-causal band", 16, D256, torch.bfloat16, False, 128, 128,
     "band"),
    ("D256 bf16 bq 128 x bk 64, F9 rows", 16, D256, torch.bfloat16, True,
     128, 64, "f9"),
    ("D256 f32 bq 128 x bk 64, F9 rows", 16, D256, torch.float32, True, 128,
     64, "f9"),
    ("D160 bf16 holed", 16, 160, torch.bfloat16, True, 128, 128, "holed"),
    ("D160 f32 non-causal band", 16, 160, torch.float32, False, 128, 128,
     "band"),
    ("D192 bf16 bq 128 x bk 64, F9 rows", 16, 192, torch.bfloat16, True,
     128, 64, "f9"),
    ("D192 f32 holed", 16, 192, torch.float32, True, 128, 128, "holed"),
]
# MPT-30B's widths (mosaicml/mpt-30b's config.json: d_model 7168, n_heads
# 64, so 64 heads of 112 with no GQA, n_layers 48, expansion_ratio 4:
# d_ff 28672, vocab_size 50432) through the llama's block, which differs
# from MPT's in RMSNorm for LayerNorm, SwiGLU over three 28672-wide
# matrices for its GELU MLP over two, and RoPE (theta 10000) for ALiBi:
# 1.64 GB of bf16 weights a layer. At its 48 layers that is 79 GB, the
# whole card, so phase zh3 serves 8 of them (13.2 GB, plus 1.45 GB of
# embeddings and about 2.1 GB of pools), as phase zc cut Mistral-Large-2
D112 = 112
MPT_30B = dict(vocab=50432, d_model=7168, n_heads=64, n_kv_heads=64,
               n_layers=48, d_ff=28672, rope_theta=10000.0, rms_eps=1e-5)
ZH_LAYERS = 8
# zh2, P1 at head dims without an instance of their own (J_CASES'
# columns): MPT-30B's serving decode at D 112 (B 8 x 64 kv heads of one
# query head, context 1056, pages of 128), G 4 at context 4096, G 12 on
# one kv head (the grouped kernel), G 4 ragged with a length-0 row on
# pages of 7; each in full, window + sinks and ring mode on bf16, int8 and
# f32 pools (a ring row's length: its length plus half the table's
# capacity, a length 0 stays 0). At D 48, 100 (a bf16 row of 200 bytes, no
# multiple of 16: 8-byte copies; int8 100 bytes: 4-byte), 160, 192 and 200
# the ragged G 4 layout alone
ZH_LAYOUTS = {
    D112: [("mpt-30b serve", 8, 4, 64, 1, 128, 9, [1056] * 8, (512, 4)),
           ("G4 ctx4096", 8, 4, 8, 4, 128, 33, [4096] * 8, (2000, 4)),
           ("G12 grouped", 4, 2, 1, 12, 128, 16, [2048] * 4, (1024, 4))]}
ZH_RAGGED_DIMS = (48, 100, D112, 160, 192, 200)
ZH_P1 = {D: [
    (f"{name} {kind} {mode}", B, L, Hkv, G, D, page, mp,
     [n + page * mp // 2 if n and mode == "ring" else n for n in lens],
     kind, mode, *(opts if mode != "full" else (0, 0)))
    for name, B, L, Hkv, G, page, mp, lens, opts in ZH_LAYOUTS.get(D, []) + [
        ("G4 page7 ragged", 5, 2, 2, 4, 7, 40, [0, 7, 70, 129, 280],
         (50, 9))]
    for kind in KV_KINDS for mode in ("full", "window", "ring")]
    for D in ZH_RAGGED_DIMS}
# zh2, P3 (CHUNKED_CASES' columns): at D 112 the verify step (C 5) and
# chunked prefill (C 256) from 0 and from 768 on MPT-30B's layout; at every
# D a ragged G 4 batch on pages of 7 with a length-0 row; each on bf16,
# int8 and f32 pools
ZH_P3 = {D: [
    (f"{name} {kind}", B, L, Hkv, G, C, D, page, mp, starts, lens,
     KV_KINDS[kind][0], kind == "int8")
    for name, B, L, Hkv, G, C, page, mp, starts, lens in ([
        ("mpt-30b verify", 8, 4, 64, 1, 5, 128, 9, [1051] * 8, None),
        ("mpt-30b prefill start 0", 8, 4, 64, 1, 256, 128, 9, [0] * 8,
         None),
        ("mpt-30b prefill start 768", 8, 4, 64, 1, 256, 128, 9, [768] * 8,
         None)] if D == D112 else []) + [
        ("ragged G4 page7", 4, 2, 2, 4, 16, 7, 40, [0, 1, 127, 200],
         [0, 17, 143, 216])]
    for kind in KV_KINDS]
    for D in ZH_RAGGED_DIMS}
# the exact instance each D is timed beside (cold L2, the same call): its
# ragged instance's width, the next of 64, 128 and 256
ZH_BESIDE = {D: next(w for w in (64, 128, 256) if D <= w)
             for D in ZH_RAGGED_DIMS}


def every_head_dim(llama, pa, fa, dev, gen, card):
    """Phase zh: every head dim up to 256 on the card. zh1 A5-A7 at D 256
    (GPT-J-6B's heads at ZH_BSP_MAIN, timed with a cold L2 beside D 128;
    then ZH_BSP_CASES, D 160 and 192 padded to 256, F9's rows among them);
    zh2 P1 in every mode on every pool (ZH_P1) and P3 (ZH_P3) at head dims
    without an instance of their own, each against its plain version and
    timed (cold L2) beside the same call at its ragged width (ZH_BESIDE);
    zh3 the llama at MPT-30B's widths (8 of 48 layers, 64 heads of 112)
    served through ``serve_at_widths``; zh4 its f32 exactness with 2
    layers (``exactness_at_widths``)."""
    t0 = time.perf_counter()
    out = {}
    m = ZH_BSP_MAIN
    bsp = {"main": bsp_case(fa, dev, gen, card, "GPT-J-6B heads", m["B"],
                            m["H"], m["S"], m["D"], m["dtype"], True,
                            m["block"], m["block"], "band", True, "zh1",
                            beside=128)}
    for name, H, D, dt, causal, bq, bk, kind in ZH_BSP_CASES:
        bsp[name] = bsp_case(fa, dev, gen, card, name, 1, H, 1024, D, dt,
                             causal, bq, bk, kind, False, "zh1")
    out["zh1"] = bsp
    # past 256 the card still refuses, naming ROADMAP Queue 2a
    for D in (288, 320):
        q = torch.zeros(1, 2, 256, D, device=dev, dtype=torch.bfloat16)
        try:
            fa.flash_attention_block_sparse(q, q, q, np.ones((2, 2), bool),
                                            True, None, 128, 128)
            fail(f"phase zh1: block-sparse attention at D {D} did not raise")
        except NotImplementedError as e:
            if "Queue 2a" not in str(e):
                fail(f"phase zh1: block-sparse attention at D {D} raised {e}")
    print(f"phase zh1: block-sparse attention refuses D 288 and 320 on the "
          f"card, naming ROADMAP Queue 2a [{card}]", flush=True)
    for D in ZH_RAGGED_DIMS:
        out[f"p1 d{D}"] = p1_vs_plain(pa, dev, gen, card, "zh2", ZH_P1[D],
                                      beside=ZH_BESIDE[D])
        out[f"p3 d{D}"] = chunked_vs_plain(pa, dev, gen, card, "zh2",
                                           ZH_P3[D], beside=ZH_BESIDE[D])
    out["mpt-30b"] = serve_at_widths(llama, pa, fa, dev, card, "zh3",
                                     MPT_30B, ZD_SERVE, "MPT-30B",
                                     layers=ZH_LAYERS, paths=ZD2_PATHS,
                                     exact_phase="zh4")
    out["exact"] = exactness_at_widths(llama, pa, fa, dev, card, "zh4",
                                       MPT_30B, PHI3_EXACT, "MPT-30B")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase zh took {out['seconds']:.1f} s [{card}]", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # phase n tunes into a fresh store, removed at exit
    tune_root = tempfile.mkdtemp(prefix="cubecl_tune_")
    atexit.register(shutil.rmtree, tune_root, True)
    os.environ["CUBECL_ENVIRONMENT_ROOT"] = tune_root
    from cubecl_tpu_torch.models import llama
    from cubecl_tpu_torch.models import mamba
    from cubecl_tpu_torch.ops import attention as fa
    from cubecl_tpu_torch.ops import conv
    from cubecl_tpu_torch.examples import attention as ex_attn
    from cubecl_tpu_torch.examples import conv_pairs as ex_conv
    from cubecl_tpu_torch.ops import moe
    from cubecl_tpu_torch.ops import ssm
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
    PHASE["now"] = "1"
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
    PHASE["now"] = "2"
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
    count_f32_launches(native)
    cu.server.wait_builds()
    build_wall = time.perf_counter() - t0
    summary = ptxas_summary(build.log)
    # (a library reused from an earlier build has no ptxas log)
    p1_spill = [(n, sp) for n, _, sp in summary
                if n.startswith(("paged_decode_kernel", "paged_window_kernel",
                                 "paged_ring_kernel", "paged_grouped_kernel",
                                 "paged_ragged_kernel"))
                and not sp.startswith(
                    "0 bytes stack frame, 0 bytes spill stores")]
    if p1_spill:
        fail(f"phase 2: P1 spills or keeps a stack frame: {p1_spill}")
    regs = "; ".join(f"{n}: {r} regs, {s}" for n, r, s in summary
                     if "tf32x3" not in n and "wgmma_kernel" not in n)
    gemm = [(r, s) for n, r, s in summary if "gemm_tf32x3" in n
            or "gemm16_wgmma" in n]
    spills = sorted({s for _, s in gemm if not s.startswith(
        "0 bytes stack frame, 0 bytes spill stores")})
    sass = sass_of(native.find_nvcc(), build.path)
    sass_rows = flash_sass(sass, summary)
    print("phase 2 flash SASS (cuobjdump): " + "; ".join(
        f"{n}: {h} HGMMA, {r} regs, {sp}" for n, h, r, sp in sass_rows),
        flush=True)
    wg_rows = wgmma_body_sass(sass, summary, mm.kernel_tiles(1),
                              mm.kernel_tiles(2), mm.kernel_tiles(4))
    print("phase 2 C1 bf16 and f32, E1 bf16, P3 bf16, 16-, 8-bit and f32 "
          "GEMM SASS (cuobjdump): "
          + "; ".join(
        f"{n}: {h}, {r} regs, {sp}" for n, h, r, sp in wg_rows), flush=True)
    print(f"phase 2 build: {build.seconds:.1f} s nvcc -> "
          f"{os.path.relpath(build.path)}; ptxas: {regs}; matmul: "
          f"{len(gemm)} tile instances, {min(r for r, _ in gemm)}-"
          f"{max(r for r, _ in gemm)} registers, stack or spills in "
          f"{sum(1 for _, s in gemm if s in spills)} ({'; '.join(spills)})",
          flush=True)
    cmma_rows = cmma_sass(cu, native.find_nvcc())
    print("phase 2 K0 cmma SASS (cuobjdump): " + "; ".join(
        f"{e} {r}: {h} HGMMA, {g} regs, {sp}"
        for e, r, h, g, sp in cmma_rows), flush=True)
    k0_built = [c for c in cu.server._cache.values() if hasattr(c.fn, "build")]
    k0_maps = {m: sorted({c.name for c in k0_built
                          if k0_mapping(c)[0] == m})
               for m in ("warp-lines", "thread")}
    print(f"phase 2 build K0: {len(k0_built)} @cube kernels "
          f"printed and built by nvcc in parallel with csrc, "
          f"{build_wall:.1f} s wall for all, {cu.server.build_seconds():.1f}"
          f" s of nvcc summed; ptxas stack/spill per kernel: "
          f"{k0_ptxas(cu)}; the printer's mapping by kernel, at this "
          f"script's launches: {k0_maps}", flush=True)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- phase 3: flash vs plain --------------------------------------------
    PHASE["now"] = "3"
    flash_rows = []
    # A1 at the 0.77B llama's prefill, A8's f32 instance at the d768
    # prefill's width, the training length, the GPT-2-width bf16 D 64
    for B, H, Hkv, S, D, dt in [(8, 16, 8, 1024, 128, torch.bfloat16),
                                (2, 12, 4, 384, 64, torch.float32),
                                (2, 16, 8, 1021, 128, torch.bfloat16),
                                (8, 12, 12, 1024, 64, torch.bfloat16)]:
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
        tf = attn_flops(B, H, S, S, D, True) / 1e9
        flash_rows.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bms, bound_by=by,
                               tflops=tf / ms, shape=what[6:]))
        print(f"phase 3 {what}: max abs err {err} (atol/rtol {TOL[dt]}); "
              f"kernel {ms:.4f} ms ({tf / ms:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms ({tf / plain_ms:.1f}), SDPA {lib_ms:.4f} ms "
              f"({tf / lib_ms:.1f}), bound {bms:.4f} ms ({tf / bms:.1f}, "
              f"{by}) [{card}]", flush=True)

    # -- phase 4: paged vs plain --------------------------------------------
    PHASE["now"] = "4"
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
        cold = cold_ms(lambda: pa.paged_attention(q, kp, vp, table, ln,
                                                  layer=L - 1))
        splits = pa.p1_plan(dt, dt, B, Hkv * G, Hkv, D, page,
                            max_pages).splits
        bms, by = paged_bound(dt, kp.element_size(), D, Hkv * G, Hkv,
                              [max(x, 0) for x in lengths], lengths, False, B)
        paged_rows.append(dict(max_abs_err=err, ms=ms, cold_ms=cold,
                               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                               splits=splits))
        print(f"phase 4 {what}: max abs err {err} (atol/rtol {TOL[dt]}); "
              f"kernel {ms:.4f} ms back to back, {cold:.4f} ms cold L2 "
              f"({splits} position splits), plain {plain_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}; {100 * bms / cold:.1f}% of it cold) "
              f"[{card}]", flush=True)
    del q, kp, vp

    # -- phase 5: serve at full width (bench.py:541-545) --------------------
    PHASE["now"] = "5"
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
    PHASE["now"] = "6"
    print(f"phase 6 {exactness(llama, dev, False)}", flush=True)

    # -- phase a: the DSL kernels (K0) at BASELINE sizes --------------------
    PHASE["now"] = "a"
    k0_rows = []
    for c in cases:
        k0_rows.append(run_case(c, cu, ev, card))
    checked = set(cu.server._cache)

    # -- phase b: serve at full width with RMSNorm on K0 --------------------
    PHASE["now"] = "b"
    k0_serve = serve_k0(llama, fa, pa, cu, dev, card)

    # -- phase c: serve exactness with RMSNorm on K0 ------------------------
    PHASE["now"] = "c"
    print(f"phase c {exactness(llama, dev, True)}", flush=True)
    unchecked = set(cu.server._cache) - checked
    if unchecked:
        fail(f"phases b/c launched K0 kernels that phase a did not hold "
             f"against plain: {sorted(unchecked)}")

    bc_launches = dict(cu.server.launches)

    # -- phase d: flash backward kernels vs plain ---------------------------
    PHASE["now"] = "d"
    bwd_rows = flash_backward(fa, dev, gen, card)
    flash_backward_sweep(fa, dev, gen, card)
    a4_f32_instances(fa, dev, gen, card)

    # -- phase e: the K0 backward kernels at the train shapes ---------------
    PHASE["now"] = "e"
    e_rows = {c["name"]: run_case(c, cu, ev, card, "e") for c in train_cases}
    param_grad_checks(dev, gen, card)
    checked = set(cu.server._cache)

    # -- phase f: train llama 0.77B bf16 at full width ----------------------
    PHASE["now"] = "f"
    f_launches, f_k0_share = train_llama(llama, fa, cu, dev, card)

    # -- phase g: train exactness, kernels vs plain -------------------------
    PHASE["now"] = "g"
    for framework in (True, False):
        print(f"phase g {train_exactness(llama, dev, framework)} [{card}]",
              flush=True)

    # -- phase h: train the transformer (GPT-2 small widths) ----------------
    PHASE["now"] = "h"
    h_launches = train_transformer(fa, cu, dev, card)
    unchecked = set(cu.server._cache) - checked
    if unchecked:
        fail(f"phases f-h launched K0 kernels that phases a and e did not "
             f"hold against plain: {sorted(unchecked)}")

    # -- phase i: the chunked paged-attention kernel (P3) against plain ------
    PHASE["now"] = "i"
    i_rows = chunked_vs_plain(pa, dev, gen, card)
    p3_f32_instances(pa, dev, gen, card)

    # -- phase j: paged decode on int8 pools against plain; KV-bound decode -
    PHASE["now"] = "j"
    j_rows = p1_vs_plain(pa, dev, gen, card, "j", J_CASES)

    # -- phase k: the slice's path at full width (llama 0.77B bf16) ---------
    PHASE["now"] = "k"
    k_out = serve_slice(llama, pa, fa, dev, card)

    # -- phase l: the slice's exactness in f32 (d768), kernels vs plain -----
    PHASE["now"] = "l"
    print(f"phase l {slice_exactness(llama, pa, fa, dev, card)} [{card}]",
          flush=True)

    # -- phase m: the matmul kernel (M1, M2) against plain, by dtype --------
    PHASE["now"] = "m"
    m_rows = matmul_vs_plain(mm, dev, gen, card)
    m_f32 = next(r for r in m_rows
                 if r["case"] == _mm_what(f"{MM_S}^3", torch.float32,
                                          torch.float32, False, None))

    # -- phase n: the autotuned matmul path (BASELINE config 4) -------------
    PHASE["now"] = "n"
    n_out = autotuned_path(mm, cu, dev, gen, card)

    # -- phase o: K0 cmma (matmul_cmma) and the K0 quant kernels ------------
    PHASE["now"] = "o"
    o_out = cmma_and_quant(mm, qk, cu, ev, dev, gen, card)
    torch.cuda.empty_cache()

    # -- phase p: reductions (BASELINE config 2) -----------------------------
    PHASE["now"] = "p"
    p_out = reductions(R, ex_sum, ex_prog, cu, ev, dev, gen, card,
                       block_extremes)
    torch.cuda.empty_cache()

    # -- phase q: comptime fusion (config 5), into_contiguous, identity -----
    PHASE["now"] = "q"
    q_out = fusion_and_std(FU, cstd, cu, ev, dev, gen, card)
    torch.cuda.empty_cache()

    # -- phase r: the throughput runners, stored and read back ---------------
    PHASE["now"] = "r"
    throughput(cstd, T, cu, card)
    torch.cuda.empty_cache()

    # -- phase s: the expert GEMM (E1) against plain --------------------------
    PHASE["now"] = "s"
    s_rows = experts_vs_plain(moe, dev, gen, card)

    # -- phase t: the MoE llama at 0.77B widths, 8 experts, sparse route ------
    PHASE["now"] = "t"
    t_out = serve_moe(llama, moe, fa, pa, dev, card)

    # -- phase u: the selective scan (S1) against plain -----------------------
    PHASE["now"] = "u"
    u_rows = scan_vs_plain(ssm, dev, gen, card)

    # -- phase v: Mamba at Mamba-130M's widths --------------------------------
    PHASE["now"] = "v"
    v_out = serve_mamba(mamba, ssm, dev, card)

    # -- phase w: exactness in f32, MoE llama d768 and Mamba, kernels vs plain 
    PHASE["now"] = "w"
    w_out = moe_exactness(llama, fa, dev, card)
    w_out["mamba"] = mamba_exactness(mamba, dev, card)

    # -- phase x: block-sparse attention (A5, A6, A7) -------------------------
    PHASE["now"] = "x"
    x_rows = block_sparse(fa, dev, gen, card)

    # -- phase y: the small-channel conv (C1) and conv2d_autotuned ------------
    PHASE["now"] = "y"
    y_rows = convolutions(conv, ex_conv, cu, dev, gen, card)

    # -- phase z: StreamingLLM serving (P1's window + sinks and ring) ---------
    PHASE["now"] = "z"
    z_out = streaming_serve(llama, pa, fa, dev, gen, card)

    # -- phase za: flash attention's options (A1/A3/A4 masked, A8) -----------
    PHASE["now"] = "za"
    za = flash_options(llama, fa, cu, ex_attn, dev, gen, card)

    # -- phase zb: serving at head dim 96 (P1 and P3 at D 96, Phi-3-mini) ----
    PHASE["now"] = "zb"
    zb = serve_d96(llama, pa, fa, dev, gen, card)

    # -- phase zc: P1 past 8 query heads a kv head (Mistral-Large-2) ---------
    PHASE["now"] = "zc"
    zc = serve_grouped(llama, pa, fa, dev, gen, card)

    # -- phase zd: head dim 256 (A1's forward, P1, P3; GPT-J-6B) ------------
    PHASE["now"] = "zd"
    zd = serve_d256(llama, pa, fa, dev, gen, card)

    # -- phase ze: training at head dim 256 (A3/A4; GPT-J-6B) ---------------
    PHASE["now"] = "ze"
    ze = train_d256(llama, fa, cu, dev, gen, card)

    # -- phase zf: head dims 80 and 32 (P1, P3; Phi-2, Pythia-31M) ----------
    PHASE["now"] = "zf"
    zf = serve_d80_d32(llama, pa, fa, dev, gen, card)

    # -- phase zg: Mamba trained (S1's backward); A5-A7 at D 32, 80, 96 -----
    PHASE["now"] = "zg"
    zg = mamba_train_and_padded_bsp(mamba, ssm, fa, dev, gen, card)

    # -- phase zh: every head dim up to 256 (A5-A7 at D 256; P1/P3 ragged) --
    PHASE["now"] = "zh"
    zh = every_head_dim(llama, pa, fa, dev, gen, card)

    def row(name, source, replaces, n, r, library_ms, **extra):
        # bound_by is "bytes" or "operations"; an f32 product bounded by
        # three TF32 products says so in bound_term
        by = r["bound_by"]
        if "," in by:
            extra["bound_term"] = by
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": by.split(",")[0], "library_ms": library_ms,
                **extra}

    def k0_row(name, r, n, elem, moved, flops, **extra):
        bms, by = elementwise_bound(n, elem, moved, flops)
        return row(name, "cubecl_tpu_torch/ops/functional.py (printed by "
                   "cubecl_tpu_torch/backend/cuda/printer.py)",
                   "cubecl_tpu/backend/pallas/emitter.py:48", extra.pop(
                       "launches"), dict(r, bound_ms=bms, bound_by=by),
                   r["library_ms"], **extra)

    train = bwd_rows["train"]

    def bwd_other(what):  # phase d's other rows of one backward kernel
        return {"other_shapes": {n: {
            "max_abs_err": r[f"{what}_err"],
            "max_abs_err_vs_rounding_plain": r[f"{what}_err_rounded"],
            "ms": r[f"{what}_ms"], "bound_ms": r[f"{what}_bound"][0],
            "bound_by": r[f"{what}_bound"][1],
            "tflops": r["tflops"]["dK/dV" if what == "dkv" else "dQ"],
            "library_ms": r["library_ms"],
            "atol_vs_exact": r["atol_vs_exact"]}
            for n, r in bwd_rows.items() if n != "train"}}
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
    xm = x_rows["main"]
    bsp_shape = "bf16 B1 H16 S8192 D128 causal, blocks 512, band i-1..i " \
                "+ global tile 0"
    bsp_lib = "F.scaled_dot_product_attention with the element mask as a " \
              "bool (1, 1, S, S) attn_mask"
    bsp_small = {k: {f: v[f] for f in ("max_abs_err", "o_err", "dq_err",
                                       "dkv_err", "empty_kv_tiles")}
                 for k, v in x_rows.items() if k not in ("main", "dense_ms")}

    zg_main = zg["zg4"]["main"]
    zg_small = {k: {f: v[f] for f in ("head_dim", "kernel_head_dim",
                                      "max_abs_err", "o_err", "dq_err",
                                      "dkv_err", "empty_kv_tiles")}
                for k, v in zg["zg4"].items() if k != "main"}

    def zg_bsp_row(what):  # zg4's main case: Phi-2's 32 heads of 80
        err = {"fwd": "o_err", "dq": "dq_err", "dkv": "dkv_err"}[what]
        return {"shape": "bf16 B1 H32 S8192 D80 (Phi-2's heads) padded to "
                         "D 128, causal, blocks 512, band i-1..i + global "
                         "tile 0",
                "max_abs_err": zg_main[err], "ms": zg_main[f"{what}_ms"],
                "plain_ms": zg_main["plain_fwd_ms" if what == "fwd"
                                   else "plain_bwd_ms"],
                **zg_main["bounds"][what],
                "bound_ms_at_padded_d": zg_main["bounds_at_padded_d"][what][
                    "bound_ms"],
                "library_ms": zg_main["library_fwd_ms" if what == "fwd"
                                      else "library_bwd_ms"],
                "launches": zg_main["launches"][
                    {"fwd": "bsp_forward", "dq": "bsp_dq",
                     "dkv": "bsp_dkv"}[what]]}

    def bsp_row(name, source, replaces, what, plain):
        b = xm["bounds"][what]
        err = {"fwd": xm["o_err"], "dq": xm["dq_err"], "dkv": xm["dkv_err"]}
        return row(name, source, replaces, xm["launches"][
                       {"fwd": "bsp_forward", "dq": "bsp_dq",
                        "dkv": "bsp_dkv"}[what]],
                   dict(max_abs_err=err[what], ms=xm[f"{what}_ms"],
                        plain_ms=xm[plain], **b),
                   xm["library_fwd_ms" if what == "fwd"
                      else "library_bwd_ms"],
                   library=bsp_lib + ("" if what == "fwd" else
                                      ", its autograd backward (dq, dk, "
                                      "dv together)"),
                   shape=bsp_shape,
                   live_pairs_per_head=xm["live_pairs_per_head"],
                   **({"plain_ms_is": "the whole plain backward (dq, dk, "
                       "dv)"} if what != "fwd" else {}),
                   padded_phi2_d80=zg_bsp_row(what),
                   **({"s1024_cases": bsp_small,
                       "dense_a1_a3_a4_ms": x_rows["dense_ms"],
                       "s1024_padded_cases": zg_small}
                      if what == "fwd" else {}))

    za_lib = "F.scaled_dot_product_attention with the element mask as a " \
             "bool attn_mask (kv heads repeated outside the call)"
    za_what = {"fwd": ("masked_forward", "o_err", "plain_fwd_ms",
                       "library_fwd_ms"),
               "dq": ("masked_dq", "dq_err", "plain_bwd_ms",
                      "library_bwd_ms"),
               "dkv": ("masked_dkv", "dkv_err", "plain_bwd_ms",
                       "library_bwd_ms")}

    def za_row(name, source, replaces, what, case, shape, **extra):
        r = za[case]
        n, err, plain, lib = za_what[what]
        others = {c: dict({"max_abs_err": v[err], "launches": v["launches"][
            n]}, **({f: v[f] for f in (f"{what}_ms", plain, lib)}
                    if f"{what}_ms" in v else {}),
            **({"bound_ms": v["bounds"][what]["bound_ms"]}
               if "bounds" in v else {}))
            for c, v in za.items() if c not in (case, "phi3")}
        return row(name, source, replaces, r["launches"][n],
                   dict(max_abs_err=r[err], ms=r[f"{what}_ms"],
                        plain_ms=r[plain], **r["bounds"][what]), r[lib],
                   library=za_lib + ("" if what == "fwd" else
                                     ", its autograd backward (dq, dk, dv "
                                     "together)"),
                   shape=shape, live_pairs=r["live_pairs"],
                   dense_causal_ms=r["dense_causal"][f"{what}_ms"],
                   plain_ms_is=f"the plain version on {r['plain_heads']}"
                   + ("" if what == "fwd" else ", the whole backward"),
                   launches_path=f"phase za: {case}, forward and backward "
                                 "through autograd",
                   other_cases=others, **extra)

    c1 = y_rows["bf16 32x56x56x64->64"]
    zb_serve = zb["serve"]

    def zb_row(name, source, replaces, n, main, table, library,
               keys=("cold_ms", "d128_cold_ms", "splits"),
               library_is=NO_LIBRARY_PAGED, **extra):
        # a zb (D 96), zc (G past 8) or zd (D 256) row: the main case's
        # numbers, every other case beside them
        r = table[main]
        return row(name, source, replaces, n, r, library,
                   library=library_is, **{k: r[k] for k in keys},
                   other_cases={k: v for k, v in table.items() if k != main},
                   **extra)

    zc_serve = zc["serve"]
    zd_serve = zd["serve"]
    zh_main = zh["zh1"]["main"]
    zh_small = {k: {f: v[f] for f in ("head_dim", "kernel_head_dim",
                                      "max_abs_err", "o_err", "dq_err",
                                      "dkv_err", "empty_kv_tiles")}
                for k, v in zh["zh1"].items() if k != "main"}
    zh_serve = zh["mpt-30b"]

    def zh_bsp_row(name, source, replaces, what):
        # zh1's main case: GPT-J-6B's 16 heads of 256, ms with a cold L2
        err = {"fwd": "o_err", "dq": "dq_err", "dkv": "dkv_err"}[what]
        return row(name, source, replaces, zh_main["launches"][
                       {"fwd": "bsp_forward", "dq": "bsp_dq",
                        "dkv": "bsp_dkv"}[what]],
                   dict(max_abs_err=zh_main[err],
                        ms=zh_main["cold_ms"][what],
                        plain_ms=zh_main["plain_fwd_ms" if what == "fwd"
                                         else "plain_bwd_ms"],
                        **zh_main["bounds"][what]),
                   zh_main["library_fwd_ms" if what == "fwd"
                           else "library_bwd_ms"],
                   library=bsp_lib + ("" if what == "fwd" else
                                      ", its autograd backward (dq, dk, "
                                      "dv together)"),
                   shape="bf16 B1 H16 S8192 D256 (GPT-J-6B's heads), "
                         "causal, blocks 512, band i-1..i + global tile 0; "
                         "ms: cold L2",
                   warm_ms=zh_main[f"{what}_ms"],
                   d128_cold_ms=zh_main["d128_cold_ms"][what],
                   live_pairs_per_head=zh_main["live_pairs_per_head"],
                   kernel_symbols={
                       "fwd": "flash_fwd_wgmma_kernel<bf16, 256, "
                              "SparseQTiles> (f32: flash_fwd_tf32x3_kernel<"
                              "float, 256, SparseQTiles>)",
                       "dq": "flash_bwd_dq_wide_kernel<bf16, 256, "
                             "SparseQTiles> (f32: flash_bwd_dq_tf32x3_"
                             "kernel<256, 1, SparseQTiles>)",
                       "dkv": "flash_bwd_dkv_wide_kernel<bf16, 256, "
                              "SparseKVTiles> (f32: flash_bwd_dkv_tf32x3_"
                              "kernel<float, 256, SparseKVTiles>)"}[what],
                   launches_path="phase zh1: forward and backward through "
                                 "autograd at GPT-J-6B's heads",
                   **({"plain_ms_is": "the whole plain backward (dq, dk, "
                       "dv)"} if what != "fwd" else {}),
                   **({"s1024_cases_d256_d160_d192": zh_small}
                      if what == "fwd" else {}))

    def zh_cases(kind):  # zh2's cases of every ragged D, keyed by D
        return {f"D{D} {k}": v for D in ZH_RAGGED_DIMS
                for k, v in zh[f"{kind} d{D}"].items()}

    print(f"f32 launches on this script's paths, counted at the library's "
          f"entry points by phase (A1 forward, A3 dK/dV, A4 dQ on every "
          f"schedule; E1; P3): {json.dumps(F32_LAUNCHES)}; totals "
          f"{ {b: sum(n.values()) for b, n in F32_LAUNCHES.items()} } "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": [
        row("flash_attention", "cubecl_tpu_torch/csrc/flash_attention.cu",
            "cubecl_tpu/ops/attention.py:76", launches["flash_attention"],
            flash_rows[0], flash_rows[0]["library_ms"],
            library="F.scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True)",
            shape="bf16 B8 H16/8 S1024 D128 causal",
            tflops=flash_rows[0]["tflops"],
            other_shapes={r["shape"]: {f: r[f] for f in (
                "max_abs_err", "ms", "tflops", "plain_ms", "library_ms",
                "bound_ms", "bound_by")} for r in flash_rows[1:]},
            sass=[{"kernel": n, "hgmma": h, "registers": r, "ptxas": sp}
                  for n, h, r, sp in sass_rows]),
        row("paged_attention", "cubecl_tpu_torch/csrc/paged_attention.cu",
            "cubecl_tpu/ops/paged_attention.py:247",
            launches["paged_attention"], paged_rows[1], None,
            library=NO_LIBRARY_PAGED,
            shape="bf16 B8 Hkv8 G2 D128 context 1056, 16-layer pool (ms: "
                  "back to back, each launch on the next layer)",
            cold_ms=paged_rows[1]["cold_ms"],
            splits=paged_rows[1]["splits"], kernel_symbols=P1_SYMBOLS,
            d768_f32={f: paged_rows[2][f] for f in (
                "max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms",
                "splits")},
            window={"kernel_symbols": "paged_window_kernel<T, TK, D>",
                    "shape": "bf16 B8 Hkv8 G2 D128 context 4160, sinks 4, "
                             "window 2000, 33 pages of 128",
                    "launches": z_out["window_serve"]["launches"][
                        "paged_attention_window"],
                    "launches_path": "phase z1: generate, 8 x 4096 + 64 "
                                     "steps, 16 layers",
                    **z_out["window_call"]},
            ring={"kernel_symbols": "paged_ring_kernel<T, TK, D>",
                  "shape": "bf16 B8 Hkv8 G2 D128 length 320, sinks 16, "
                           "window 240, a ring of 17 pages of 16",
                  "launches": z_out["ring_serve"]["launches"][
                      "paged_attention_ring"],
                  "launches_path": "phase z2: 320 decode steps, 16 layers",
                  **z_out["ring_call"]}),
        row("paged_attention_int8", "cubecl_tpu_torch/csrc/paged_attention.cu",
            "cubecl_tpu/ops/paged_attention.py:247",
            k_out["int8"]["launches"]["paged_attention_int8"],
            j_rows["serving int8"], None, library=NO_LIBRARY_PAGED,
            shape="int8 KV, bf16 q, B8 Hkv8 G2 D128 context 1056",
            cold_ms=j_rows["serving int8"]["cold_ms"],
            splits=j_rows["serving int8"]["splits"],
            kernel_symbols=P1_SYMBOLS,
            kv_bound_b16_ctx2048={k: {f: j_rows[k][f] for f in (
                "ms", "cold_ms", "bound_ms", "kv_gb_per_s",
                "kv_gb_per_s_cold", "splits")} for k in (
                "KV-bound bf16", "KV-bound int8")}),
        row("paged_attention_chunked",
            "cubecl_tpu_torch/csrc/paged_chunked.cu",
            "cubecl_tpu/ops/paged_attention.py:675",
            sum(p3_launches.values()), i_rows["verify"], None,
            library=NO_LIBRARY_PAGED,
            shape="verify: bf16 B8 Hkv8 G2 C5 D128 context 1056",
            launches_by_path=p3_launches,
            kernel_symbols={
                "bf16": "paged_chunked_wgmma_kernel<D, QUANT> (wgmma, "
                        "cp.async through the table), then "
                        "paged_combine_kernel<bf16, D> where the "
                        "positions are split (a second launch a call, "
                        "not counted in launches)",
                "f32": "paged_chunked_tf32x3_kernel<D, QUANT> (3xTF32 "
                       "wgmma, a ring of raw slots filled through the "
                       "table by bulk copies, a row each), then "
                       "paged_combine_kernel<float, D> where split"},
            splits={n: r["splits"] for n, r in i_rows.items()},
            device_ms_cold_l2=i_rows["verify"]["cold_ms"],
            f32=p3_f32_rows(i_rows, zd, zf, zh),
            **{name.replace(" ", "_"): {f: i_rows[name][f] for f in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "body", "splits", "cold_ms")}
               for name in ("prefill start 0", "prefill start 768",
                            "ragged", "d768", "verify int8",
                            "prefill int8 start 768")}),
        k0_row("k0_cube_kernels", dict(rms), 8192 * 2048, 2, 2, 4,
               launches=k0_serve["launches"],
               library="F.rms_norm",
               mapping=rms["mapping"], vector_16_byte=rms["vector_16_byte"],
               k0_share_of_device_time_phase_f=f_k0_share,
               mappings_phases_a_e={r["name"]: r["mapping"]
                                    for r in k0_rows + list(e_rows.values())},
               kernels_by_mapping=k0_maps,
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
            library=sdpa_bwd, shape="bf16 B8 H16/8 S1023 D128 causal",
            max_abs_err_vs_rounding_plain=train["dkv_err_rounded"],
            atol_vs_exact=train["atol_vs_exact"],
            tflops=train["tflops"]["dK/dV"], **bwd_other("dkv")),
        row("flash_attention_bwd_dq",
            "cubecl_tpu_torch/csrc/flash_attention_bwd.cu",
            "cubecl_tpu/ops/attention.py:660", f_launches["flash_bwd_dq"],
            dict(max_abs_err=train["dq_err"], ms=train["dq_ms"],
                 plain_ms=train["plain_ms"], bound_ms=train["dq_bound"][0],
                 bound_by=train["dq_bound"][1]), train["library_ms"],
            plain_ms_is="the whole plain backward (dq, dk, dv)",
            library=sdpa_bwd, shape="bf16 B8 H16/8 S1023 D128 causal",
            max_abs_err_vs_rounding_plain=train["dq_err_rounded"],
            atol_vs_exact=train["atol_vs_exact"],
            tflops=train["tflops"]["dQ"], **bwd_other("dq"),
            f32=a4_f32_rows(bwd_rows, ze)),
        k0_row("_rmsnorm_bwd_k", e("_rmsnorm_bwd_k bf16 8x1023x2048"),
               8 * 1023 * 2048, 2, 3, 8,
               launches=f_launches["_rmsnorm_bwd_k"],
               library="the autograd backward of F.rms_norm (dx and dg)",
               shape="bf16 8x1023x2048",
               mapping=e("_rmsnorm_bwd_k bf16 8x1023x2048")["mapping"]),
        k0_row("_layernorm_bwd_k", e("_layernorm_bwd_k bf16 8x1024x768"),
               8 * 1024 * 768, 2, 3, 10,
               launches=h_launches["_layernorm_bwd_k"],
               library="the autograd backward of F.layer_norm (dx, dg, db)",
               shape="bf16 8x1024x768",
               mapping=e("_layernorm_bwd_k bf16 8x1024x768")["mapping"]),
        k0_row("_gelu_fwd_k", e("_gelu_fwd_k bf16 8x1024x3072"),
               8 * 1024 * 3072, 2, 2, K0_OPS["gelu"],
               launches=h_launches["_gelu_fwd_k"],
               library="F.gelu(approximate='none')",
               shape="bf16 8x1024x3072",
               mapping=e("_gelu_fwd_k bf16 8x1024x3072")["mapping"]),
        k0_row("_gelu_bwd_k", e("_gelu_bwd_k bf16 8x1024x3072"),
               8 * 1024 * 3072, 2, 3, 20,
               launches=h_launches["_gelu_bwd_k"],
               library="the autograd backward of F.gelu(approximate="
                       "'none')", shape="bf16 8x1024x3072",
               mapping=e("_gelu_bwd_k bf16 8x1024x3072")["mapping"]),
        row("matmul", "cubecl_tpu_torch/csrc/matmul.cu (with "
            "csrc/wgmma_gemm.cuh)",
            "cubecl_tpu/ops/matmul.py:43", n_out["launches"]["matmul_pallas"],
            n_out["matmul"], n_out["matmul"]["library_ms"],
            library="torch.matmul",
            shape="bf16 4096^3 -> bf16, matmul_autotuned's winner",
            body=mm_body(torch.bfloat16),
            parent_body="mma.sync with two cp.async stages "
                        "(csrc/matmul.cu, csrc/mma_tile.cuh); its times are "
                        "printed in phase m as constants of an earlier run",
            **{k: n_out["matmul"][k] for k in ("tile", "tflops",
                                               "pct_of_989", "per_call_ms")},
            autotuned={k: {f: v[f] for f in ("tile", "tune_s", "graph_ms")}
                       for k, v in n_out["keys"].items()},
            quantized_rel_err=n_out["quantized_rel_err"],
            by_case=m_rows),
        row("matmul_f32", "cubecl_tpu_torch/csrc/matmul.cu "
            "(gemm_tf32x3_kernel, with csrc/wgmma_gemm.cuh)",
            "cubecl_tpu/ops/matmul.py:43",
            n_out["launches"]["matmul_pallas f32 (3xTF32)"], m_f32, m_f32[
                "library_ms"], library=m_f32["library"],
            shape=f"f32 {MM_S}^3, B as (K, N) (transposed in the call) -> "
                  "f32, phase m's fastest tile; launches: phase n's f32 key",
            body=mm_body(torch.float32), tile=m_f32["tile"],
            other_cases={r["case"]: {f: r[f] for f in (
                "tile", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "library_ms")} for r in m_rows if " f32 B as" in r["case"]}),
        row("matmul_scaled", "cubecl_tpu_torch/csrc/matmul8.cu (with "
            "csrc/wgmma_gemm.cuh)", "cubecl_tpu/ops/matmul.py:477",
            n_out["launches"]["matmul_scaled"], n_out["matmul_scaled"],
            n_out["matmul_scaled"]["library_ms"], library="torch._scaled_mm",
            shape="e4m3 4096^3, B as (N, K), x sa*sb -> bf16",
            body=mm_body(torch.float8_e4m3fn),
            b_layouts_phase_m={r["case"]: {f: r[f] for f in (
                "tile", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "library_ms")} for r in m_rows
                if r["case"].startswith(f"M2 {MM_S}^3")},
            parent_body="mma.sync with two cp.async stages "
                        "(csrc/matmul.cu, csrc/mma_tile.cuh); its times are "
                        "printed in phase m as constants of an earlier run"),
        *(row(key, "cubecl_tpu_torch/ops/matmul.py (matmul_cmma_nd_"
              "kernel, printed by cubecl_tpu_torch/backend/cuda/printer.py "
              "on the tensor-core route, with csrc/wgmma_gemm.cuh)",
              "cubecl_tpu/backend/pallas/emitter.py:48",
              o_out[key]["launches"], o_out[key], o_out[key]["library_ms"],
              **{k: o_out[key][k] for k in o_out[key] if k not in (
                  "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "launches")})
          for key in ("k0_cmma", "k0_cmma_f16", "k0_cmma_f32")),
        row("k0_quantize", "cubecl_tpu_torch/std/quant_kernels.py "
            "(quantize_tensor_absmax then quantize_tensor_values, printed "
            "by cubecl_tpu_torch/backend/cuda/printer.py)",
            "cubecl_tpu/backend/pallas/emitter.py:48",
            n_out["launches"]["quantize_tensor_absmax"], o_out["k0_quantize"],
            None, library="none: no one call takes a tensor's absmax scale "
                          "and quantizes with it",
            launches_by_kernel={k: n_out["launches"][k] for k in (
                "quantize_tensor_absmax", "quantize_tensor_values")},
            **{k: v for k, v in o_out["k0_quantize"].items()
               if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by")},
            block_4096=dict(o_out["k0_quantize_block"],
                            kernel="quantize_block_kernel")),
        *(row(key, "cubecl_tpu_torch/std/quant_kernels.py "
              "(dequantize_chunk_kernel, printed by "
              "cubecl_tpu_torch/backend/cuda/printer.py)",
              "cubecl_tpu/backend/pallas/emitter.py:48",
              o_out[key]["launches"], o_out[key], o_out[key]["library_ms"],
              jax_kernel="cubecl_tpu/std/quant_kernels.py:34 "
                         "(dequantize_block_kernel)",
              **{k: o_out[key][k] for k in ("library", "call_ms", "shape")})
          for key in ("k0_dequantize", "k0_dequantize_block")),
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
            shape=f"f32 64M as {BLOCK_CUBES} windows, each split over "
                  f"cubes of 256 units (ms: cold L2)",
            **{k: p_out["block"][k] for k in ("call_ms", "with_fold_ms",
                                              "plan")},
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
            mapping=q_out["rows"]["add -> mul -> relu"]["mapping"],
            vector_16_byte=q_out["rows"]["add -> mul -> relu"][
                "vector_16_byte"],
            add_gelu=q_out["rows"]["add -> gelu"],
            into_contiguous=q_out["contiguous"],
            identity=q_out["identity"]),
        row("expert_matmul", "cubecl_tpu_torch/csrc/expert_matmul.cu (with "
            "csrc/wgmma_gemm.cuh)",
            "cubecl_tpu/ops/moe.py:29", t_out["launches"]["expert_matmul"],
            s_rows[E1_MAIN], s_rows[E1_MAIN]["library_ms"],
            library=DENSE_EQUIVALENT, shape=E1_MAIN,
            body="bf16: wgmma + TMA, persistent blocks over the live tiles "
                 "(128 x 256 where they fill the card, else 128 x 128); "
                 "f32: FMA on the CUDA cores",
            parent_body="mma.sync with two cp.async stages "
                        "(csrc/mma_tile.cuh); its times are printed in "
                        "phase s as constants of an earlier run",
            **{f: s_rows[E1_MAIN][f] for f in (
                "host_ms_per_call", "back_to_back_ms_per_call")},
            launches_path="phase t: generate, 8 x 1024 + 64 steps, 16 layers",
            **{k.split(" ")[0]: {f: v[f] for f in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "host_ms_per_call",
                "back_to_back_ms_per_call")}
               for k, v in s_rows.items() if k != E1_MAIN},
            moe_llama=t_out, exactness_d768_f32=w_out),
        row("selective_scan", "cubecl_tpu_torch/csrc/selective_scan.cu",
            "cubecl_tpu/ops/ssm.py:126", v_out["launches"],
            u_rows["mamba-130m"], None, library=NO_LIBRARY_SCAN,
            shape="f32 (8, 2048, 24576): Mamba-130M's B 8 x L 2048 x d_inner "
                  "1536 x d_state 16",
            launches_path="phase v: forward, B 8 x L 2048, 24 layers",
            **{k.replace(" ", "_"): v for k, v in u_rows.items()
               if k != "mamba-130m"},
            mamba_130m=v_out,
            train_launches_zg2=zg["launches"]["scan_chunked_core"]),
        row("selective_scan_backward",
            "cubecl_tpu_torch/csrc/selective_scan.cu (scan_bwd_kernel)",
            "cubecl_tpu/ops/ssm.py:126",
            zg["launches"]["scan_chunked_core_backward"],
            zg["zg1"]["mamba-130m f32"], None, library=NO_LIBRARY_SCAN_BWD,
            replaces_is="S1's backward: the JAX kernel has none, and the "
                        "JAX package trains Mamba through jax.grad of its "
                        "associative scan (cubecl_tpu/models/mamba.py:196)",
            shape="f32 (8, 2048, 24576): Mamba-130M's B 8 x L 2048 x d_inner "
                  "1536 x d_state 16; ms: cold L2",
            launches_path=f"phase zg2: {ZG_TRAIN['steps']} SGD steps of "
                          f"Mamba-130M's 24 layers at B {zg['B']} x L "
                          f"{zg['L']}, one a layer a step",
            **{k.replace(" ", "_"): v for k, v in zg["zg1"].items()
               if k != "mamba-130m f32"},
            mamba_130m_train={k: zg[k] for k in (
                "losses", "ms_per_step", "step_ms", "peak_gib", "held_gib",
                "params_m", "B", "L", "profile", "exact")},
            phase_seconds=zg["seconds"]),
        bsp_row("flash_attention_block_sparse",
                "cubecl_tpu_torch/csrc/flash_attention.cu (with "
                "csrc/flash_tiles.cuh)", "cubecl_tpu/ops/attention.py:1109",
                "fwd", "plain_fwd_ms"),
        bsp_row("flash_attention_block_sparse_dq",
                "cubecl_tpu_torch/csrc/flash_attention_bwd.cu (with "
                "csrc/flash_tiles.cuh)", "cubecl_tpu/ops/attention.py:1228",
                "dq", "plain_bwd_ms"),
        bsp_row("flash_attention_block_sparse_dkv",
                "cubecl_tpu_torch/csrc/flash_attention_bwd.cu (with "
                "csrc/flash_tiles.cuh)", "cubecl_tpu/ops/attention.py:1316",
                "dkv", "plain_bwd_ms"),
        za_row("flash_attention_options",
               "cubecl_tpu_torch/csrc/flash_attention.cu (with "
               "csrc/flash_tiles.cuh: the masked schedule)",
               "cubecl_tpu/ops/attention.py:76", "fwd", "window",
               "bf16 B1 H32/8 S8192 D128 causal, window 4096 (Mistral-7B)",
               kernel_symbols="flash_fwd_wgmma_kernel<bf16, D, MaskedQTiles>"
                              ", f32: flash_fwd_tf32x3_kernel<float, D, "
                              "MaskedQTiles>",
               padded_route_phi3_mini=za["phi3"]),
        za_row("flash_attention_options_bwd_dkv",
               "cubecl_tpu_torch/csrc/flash_attention_bwd.cu (with "
               "csrc/flash_tiles.cuh: the masked schedule)",
               "cubecl_tpu/ops/attention.py:469", "dkv", "window",
               "bf16 B1 H32/8 S8192 D128 causal, window 4096 (Mistral-7B)"),
        za_row("flash_attention_options_bwd_dq",
               "cubecl_tpu_torch/csrc/flash_attention_bwd.cu (with "
               "csrc/flash_tiles.cuh: the masked schedule)",
               "cubecl_tpu/ops/attention.py:660", "dq", "window",
               "bf16 B1 H32/8 S8192 D128 causal, window 4096 (Mistral-7B)"),
        za_row("flash_attention_packed_window",
               "cubecl_tpu_torch/csrc/flash_attention.cu (A1's masked "
               "forward at D 64, D 32 padded to it)",
               "cubecl_tpu/ops/attention.py:1445", "fwd", "packed_d32",
               "bf16 B8 H16 S2048 D32 causal, window (256, 0)"),
        row("conv2d_pairs_packed", "cubecl_tpu_torch/csrc/conv3x3.cu",
            "cubecl_tpu/ops/conv.py:274", y_rows["stack"]["launches"], c1,
            c1["library_ms"],
            library="F.conv2d(padding=1) on channels_last bf16 (cuDNN)",
            shape="bf16 (32, 56, 56, 64) -> 64, 3x3 SAME (ResNet-50 "
                  "conv2_x)",
            launches_path="phase y: examples/conv_pairs twin, 3 layers",
            body={str(dt).replace("torch.", ""): conv.c1_body(dt)
                  for dt in conv.C1_DTYPES},
            kernel_symbols={
                "bf16": "conv3x3_wgmma_kernel",
                "f32": "conv3x3_split_weights_kernel, then "
                       "conv3x3_tf32x3_kernel (a second launch a call, "
                       "not counted in launches)"},
            device_ms_cold_l2=c1["device_ms_cold_l2"],
            parent_body="both dtypes on the f32 CUDA cores before their "
                        "wgmma bodies; their times are printed in phase y "
                        "as constants of an earlier run",
            **{k.replace(" ", "_"): v for k, v in y_rows.items()
               if k != "bf16 32x56x56x64->64"}),
        zb_row("paged_attention_d96",
               "cubecl_tpu_torch/csrc/paged_attention.cu",
               "cubecl_tpu/ops/paged_attention.py:247",
               zb_serve["generate"]["launches"]["paged_attention"],
               "phi3 serve bf16 full", zb["p1"], None,
               shape="bf16 B8 Hkv32 G1 D96 context 1056 (Phi-3-mini), "
                     "4-layer pool (ms: back to back, each launch on the "
                     "next layer)",
               kernel_symbols="paged_decode_kernel<T, TK, 96> (window: "
                              "paged_window_kernel, ring: "
                              "paged_ring_kernel), then "
                              "paged_combine_kernel<T, 96> where split",
               launches_path="phase zb2: generate, 8 x 1024 + 32 steps, "
                             "32 layers",
               window_launches=zb_serve["window"]["launches"][
                   "paged_attention_window"],
               ring_launches=zb_serve["ring"]["launches"][
                   "paged_attention_ring"],
               phi3_serve=zb_serve, exactness_f32=zb["exact"],
               phase_seconds=zb["seconds"]),
        zb_row("paged_attention_int8_d96",
               "cubecl_tpu_torch/csrc/paged_attention.cu",
               "cubecl_tpu/ops/paged_attention.py:247",
               zb_serve["int8"]["launches"]["paged_attention_int8"],
               "phi3 serve int8 full", zb["p1"], None,
               shape="int8 KV, bf16 q, B8 Hkv32 G1 D96 context 1056",
               launches_path="phase zb2: int8 KV, 8 x 1024 + 32 steps"),
        zb_row("paged_attention_chunked_d96",
               "cubecl_tpu_torch/csrc/paged_chunked.cu",
               "cubecl_tpu/ops/paged_attention.py:675",
               zb_serve["prefill_chunked"]["launches"][
                   "paged_attention_chunked"]
               + zb_serve["verify"]["launches"]["paged_attention_chunked"]
               + sum(v["launches"]["paged_attention_chunked"]
                     for v in zb_serve["speculative"].values()),
               "verify bf16", zb["p3"], None,
               shape="verify: bf16 B8 Hkv32 G1 C5 D96 context 1056",
               kernel_symbols={
                   "bf16": "paged_chunked_wgmma_kernel<96, QUANT> (D 128's "
                           "128-byte panels, columns 96..127 unused), then "
                           "paged_combine_kernel<bf16, 96> where split",
                   "f32": "paged_chunked_tf32x3_kernel<96, QUANT>"},
               launches_path="phase zb2: prefill_chunked, the verify step "
                             "and speculative decoding's verify rounds"),
        zb_row("paged_attention_grouped",
               "cubecl_tpu_torch/csrc/paged_attention.cu",
               "cubecl_tpu/ops/paged_attention.py:247",
               zc_serve["generate"]["launches"]["paged_attention_grouped"],
               "mistral-large-2 serve bf16 full", zc["p1"], None,
               keys=("cold_ms", "g2_cold_ms", "splits", "groups"),
               shape="bf16 B8 Hkv8 G12 D128 context 1056 (Mistral-Large-2), "
                     "4-layer pool (ms: back to back, each launch on the "
                     "next layer; g2_cold_ms: the same call at G 2, the "
                     "same K/V bytes)",
               kernel_symbols="paged_grouped_kernel<MODE, T, TK, D> over "
                              "(splits x row groups of at most 8 query "
                              "rows, Hkv, B), every mode, then "
                              "paged_combine_kernel<T, D> where split",
               launches_path=f"phase zc2: generate, 8 x 1024 + 32 steps, "
                             f"{ZC_LAYERS} layers, every launch grouped "
                             "(paged_attention.grouped_launches)",
               int8_grouped_launches=zc_serve["int8"]["launches"][
                   "paged_attention_grouped"],
               mistral_large_2_serve=zc_serve, exactness_f32=zc["exact"],
               phase_seconds=zc["seconds"]),
        zb_row("paged_attention_chunked_grouped",
               "cubecl_tpu_torch/csrc/paged_chunked.cu",
               "cubecl_tpu/ops/paged_attention.py:675",
               zc_serve["prefill_chunked"]["launches"][
                   "paged_attention_chunked"]
               + zc_serve["verify"]["launches"]["paged_attention_chunked"]
               + sum(v["launches"]["paged_attention_chunked"]
                     for v in zc_serve["speculative"].values()),
               "mistral-large-2 verify bf16", zc["p3"], None,
               keys=("cold_ms", "splits"),
               shape="verify: bf16 B8 Hkv8 G12 C5 D128 context 1056 "
                     "(Mistral-Large-2)",
               kernel_symbols={
                   "bf16": "paged_chunked_wgmma_kernel<128, QUANT>, then "
                           "paged_combine_kernel<bf16, 128> where split",
                   "f32": "paged_chunked_tf32x3_kernel<D, QUANT>"},
               launches_path="phase zc2: prefill_chunked, the verify step "
                             "and speculative decoding's verify rounds"),
        zb_row("flash_attention_d256",
               "cubecl_tpu_torch/csrc/flash_attention.cu",
               "cubecl_tpu/ops/attention.py:76",
               zd_serve["generate"]["launches"]["flash_attention"],
               "gpt-j prefill bf16", zd["a1"],
               zd["a1"]["gpt-j prefill bf16"]["library_ms"],
               keys=("cold_ms", "d128_cold_ms", "live_pairs", "keys_read"),
               library_is="F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True); with an option the element mask "
                       "as a bool attn_mask",
               shape="bf16 B8 H16/16 S1024 D256 causal (GPT-J-6B's "
                     "prefill); d128_cold_ms: the same call at D 128",
               kernel_symbols={
                   "bf16": "flash_fwd_wgmma_kernel<bf16, 256, Tiles> (2 "
                           "K/V stages, P V as two m64n128k16)",
                   "f32": "flash_fwd_tf32x3_kernel<float, 256, Tiles>"},
               launches_path="phase zd2: generate, 8 x 1024 + 32 steps, 28 "
                             "layers (GPT-J-6B's widths)",
               gptj_6b_serve=zd_serve, exactness_f32=zd["exact"],
               phase_seconds=zd["seconds"]),
        zb_row("paged_attention_d256",
               "cubecl_tpu_torch/csrc/paged_attention.cu",
               "cubecl_tpu/ops/paged_attention.py:247",
               zd_serve["generate"]["launches"]["paged_attention"],
               "gpt-j serve bf16 full", zd["p1"], None,
               shape="bf16 B8 Hkv16 G1 D256 context 1056 (GPT-J-6B), "
                     "4-layer pool (ms: back to back, each launch on the "
                     "next layer)",
               kernel_symbols="paged_decode_kernel<T, TK, 256> (window: "
                              "paged_window_kernel, ring: paged_ring_kernel, "
                              "past 8 rows a kv head: paged_grouped_kernel; "
                              "f32 pools one stage a warp), then "
                              "paged_combine_kernel<T, 256> where split",
               launches_path="phase zd2: generate, 8 x 1024 + 32 steps, 28 "
                             "layers",
               int8_launches=zd_serve["int8"]["launches"][
                   "paged_attention_int8"],
               window_launches=zd_serve["window"]["launches"][
                   "paged_attention_window"],
               ring_launches=zd_serve["ring"]["launches"][
                   "paged_attention_ring"]),
        zb_row("paged_attention_chunked_d256",
               "cubecl_tpu_torch/csrc/paged_chunked.cu",
               "cubecl_tpu/ops/paged_attention.py:675",
               zd_serve["prefill_chunked"]["launches"][
                   "paged_attention_chunked"]
               + zd_serve["verify"]["launches"]["paged_attention_chunked"]
               + sum(v["launches"]["paged_attention_chunked"]
                     for v in zd_serve["speculative"].values()),
               "gpt-j verify bf16", zd["p3"], None,
               shape="verify: bf16 B8 Hkv16 G1 C5 D256 context 1056 "
                     "(GPT-J-6B)",
               kernel_symbols={
                   "bf16": "paged_chunked_wgmma_kernel<256, QUANT> (four "
                           "128-byte panels; decode-shaped tiles' P halves "
                           "in shared memory), then "
                           "paged_combine_kernel<bf16, 256> where split",
                   "f32": "paged_chunked_tf32x3_kernel<256, QUANT> "
                          "(three raw slots: 231,936 bytes)"},
               launches_path="phase zd2: prefill_chunked, the verify step "
                             "and speculative decoding's verify rounds"),
        *(zb_row(f"flash_attention_bwd_{what}_d256",
                 "cubecl_tpu_torch/csrc/flash_attention_bwd.cu",
                 replaces, ze["train"]["launches"][f"flash_bwd_{what}"],
                 "gpt-j train bf16", ze["a34"][what],
                 ze["a34"][what]["gpt-j train bf16"]["library_ms"],
                 keys=("d128_cold_ms", "live_pairs", "keys_read",
                       "max_abs_err_vs_rounding_plain", "atol_vs_exact"),
                 library_is=sdpa_bwd + "; with an option the element mask "
                                       "as a bool attn_mask",
                 shape="bf16 B8 H16/16 S1024 D256 causal (GPT-J-6B's "
                       "training); ms: cold L2; d128_cold_ms: the same call "
                       "at D 128",
                 plain_ms_is="the whole plain backward (dq, dk, dv)",
                 kernel_symbols=symbols,
                 launches_path="phase ze2: 6 SGD steps at B 4, 28 layers "
                               "(GPT-J-6B's widths)",
                 worst_atol_vs_exact=ze["a34"]["worst_atol_vs_exact"],
                 **({"gptj_6b_train": ze["train"],
                     "phase_seconds": ze["seconds"]} if what == "dkv"
                    else {}))
          for what, replaces, symbols in (
              ("dkv", "cubecl_tpu/ops/attention.py:469", {
                  "bf16": "flash_bwd_dkv_wide_kernel<bf16, 256, Tiles> (one "
                          "64-row kv tile a block; warpgroup 1 s^T, p^T, dV, "
                          "warpgroup 2 dP^T, dS^T, dK, p^T handed over "
                          "through shared memory)",
                  "f32": "flash_bwd_dkv_tf32x3_kernel<float, 256, Tiles> "
                         "(two blocks a kv tile, dV's and dK's)"}),
              ("dq", "cubecl_tpu/ops/attention.py:660", {
                  "bf16": "flash_bwd_dq_wide_kernel<bf16, 256, Tiles> (one "
                          "64-row q tile a block; each warpgroup 128 of dQ's "
                          "columns, s and dP computed by both)",
                  "f32": "flash_bwd_dq_tf32x3_kernel<256, 1, Tiles> "
                         "(3xTF32; one 64-row q tile a block; K and V "
                         "through one raw slot by cp.async)"}))),
        *(zb_row(f"paged_attention_d{D}",
                 "cubecl_tpu_torch/csrc/paged_attention.cu",
                 "cubecl_tpu/ops/paged_attention.py:247",
                 zf[model]["generate"]["launches"]["paged_attention"],
                 main, zf[f"p1 d{D}"], None,
                 keys=("cold_ms", f"d{ZF_BESIDE[D]}_cold_ms", "splits"),
                 shape=shape + " (ms: back to back, each launch on the next "
                 f"layer; d{ZF_BESIDE[D]}_cold_ms: the same call at D "
                 f"{ZF_BESIDE[D]})",
                 kernel_symbols=f"paged_decode_kernel<T, TK, {D}> (window: "
                                "paged_window_kernel, ring: "
                                "paged_ring_kernel, past 8 rows a kv head: "
                                "paged_grouped_kernel), then "
                                f"paged_combine_kernel<T, {D}> where split",
                 launches_path=f"phase {phase}: generate, 8 x 1024 + 32 "
                               f"steps, {layers} layers ({name}'s widths)",
                 int8_launches=zf[model]["int8"]["launches"][
                     "paged_attention_int8"],
                 window_launches=zf[model]["window"]["launches"][
                     "paged_attention_window"],
                 ring_launches=zf[model]["ring"]["launches"][
                     "paged_attention_ring"],
                 **{f"{model.replace('-', '_')}_serve": zf[model],
                    "exactness_f32": zf["exact"][name]},
                 **({"phase_seconds": zf["seconds"]} if D == D80 else {}))
          for D, model, name, phase, layers, main, shape in (
              (D80, "phi-2", "Phi-2", "zf2", 32, "phi-2 serve bf16 full",
               "bf16 B8 Hkv32 G1 D80 context 1056 (Phi-2), 4-layer pool"),
              (D32, "pythia-31m", "Pythia-31M", "zf3", 6,
               "B8 H16 ctx2048 bf16 full",
               "bf16 B8 Hkv16 G1 D32 context 2048, 4-layer pool"))),
        *(zb_row(f"paged_attention_chunked_d{D}",
                 "cubecl_tpu_torch/csrc/paged_chunked.cu",
                 "cubecl_tpu/ops/paged_attention.py:675",
                 zf[model]["prefill_chunked"]["launches"][
                     "paged_attention_chunked"]
                 + zf[model]["verify"]["launches"]["paged_attention_chunked"]
                 + sum(v["launches"]["paged_attention_chunked"]
                       for v in zf[model]["speculative"].values()),
                 "phi-2 verify bf16", zf[f"p3 d{D}"], None,
                 keys=("cold_ms", f"d{ZF_BESIDE[D]}_cold_ms", "splits"),
                 shape=f"verify: bf16 B8 Hkv32 G1 C5 D{D} context 1056 "
                       f"(Phi-2's layout); d{ZF_BESIDE[D]}_cold_ms: the "
                       f"same call at D {ZF_BESIDE[D]}",
                 kernel_symbols={
                     "bf16": f"paged_chunked_wgmma_kernel<{D}, QUANT> "
                             f"(D {128 if D == D80 else 64}'s 128-byte "
                             "panels, the columns past D unused), "
                             f"then paged_combine_kernel<bf16, {D}> where "
                             "split",
                     "f32": f"paged_chunked_tf32x3_kernel<{D}, QUANT>"},
                 launches_path=f"phase {phase}: prefill_chunked, the verify "
                               "step and speculative decoding's verify "
                               f"rounds ({name}'s widths)")
          for D, model, name, phase in (
              (D80, "phi-2", "Phi-2", "zf2"),
              (D32, "pythia-31m", "Pythia-31M", "zf3"))),
        zh_bsp_row("flash_attention_block_sparse_d256",
                   "cubecl_tpu_torch/csrc/flash_attention.cu (with "
                   "csrc/flash_tiles.cuh)", "cubecl_tpu/ops/attention.py:1109",
                   "fwd"),
        zh_bsp_row("flash_attention_block_sparse_dq_d256",
                   "cubecl_tpu_torch/csrc/flash_attention_bwd.cu (with "
                   "csrc/flash_tiles.cuh)", "cubecl_tpu/ops/attention.py:1228",
                   "dq"),
        zh_bsp_row("flash_attention_block_sparse_dkv_d256",
                   "cubecl_tpu_torch/csrc/flash_attention_bwd.cu (with "
                   "csrc/flash_tiles.cuh)", "cubecl_tpu/ops/attention.py:1316",
                   "dkv"),
        zb_row("paged_attention_ragged",
               "cubecl_tpu_torch/csrc/paged_ragged.cu (with "
               "csrc/paged_decode.cuh)",
               "cubecl_tpu/ops/paged_attention.py:247",
               zh_serve["generate"]["launches"]["paged_attention_ragged"],
               f"D{D112} mpt-30b serve bf16 full", zh_cases("p1"), None,
               keys=("cold_ms", "d128_cold_ms", "splits"),
               shape="bf16 B8 Hkv64 G1 D112 context 1056 (MPT-30B), "
                     "4-layer pool (ms: back to back, each launch on the "
                     "next layer; d128_cold_ms: the same call at D 128, "
                     "the width its ragged instance runs in)",
               kernel_symbols="paged_ragged_kernel<MODE, GROUPED, T, TK, "
                              "DP> (DP 64, 128 or 256: the next width up; "
                              "every mode, past 8 rows a kv head grouped), "
                              "then paged_combine_ragged_kernel<T, DP> "
                              "where split",
               launches_path=f"phase zh3: generate, 8 x 1024 + 32 steps, "
                             f"{ZH_LAYERS} layers (MPT-30B's widths), every "
                             "launch ragged "
                             "(paged_attention.ragged_launches)",
               int8_launches=zh_serve["int8"]["launches"][
                   "paged_attention_int8"],
               window_launches=zh_serve["window"]["launches"][
                   "paged_attention_window"],
               ring_launches=zh_serve["ring"]["launches"][
                   "paged_attention_ring"],
               mpt_30b_serve=zh_serve, exactness_f32=zh["exact"],
               phase_seconds=zh["seconds"]),
        zb_row("paged_attention_chunked_ragged",
               "cubecl_tpu_torch/csrc/paged_chunked.cu",
               "cubecl_tpu/ops/paged_attention.py:675",
               zh_serve["prefill_chunked"]["launches"][
                   "paged_attention_chunked_ragged"]
               + zh_serve["verify"]["launches"][
                   "paged_attention_chunked_ragged"]
               + sum(v["launches"]["paged_attention_chunked"]
                     for v in zh_serve["speculative"].values()),
               f"D{D112} mpt-30b verify bf16", zh_cases("p3"), None,
               keys=("cold_ms", "d128_cold_ms", "splits"),
               shape="verify: bf16 B8 Hkv64 G1 C5 D112 context 1056 "
                     "(MPT-30B); d128_cold_ms: the same call at D 128",
               kernel_symbols={
                   "bf16": "paged_chunked_wgmma_ragged_kernel<DP, QUANT> "
                           "(DP 64, 128 or 256; the columns past D zeros, "
                           "never stored), then "
                           "paged_combine_ragged_kernel<bf16, DP> where "
                           "split",
                   "f32": "paged_chunked_tf32x3_ragged_kernel<DP, "
                          "QUANT>"},
               launches_path=f"phase zh3: prefill_chunked, the verify step "
                             "and speculative decoding's verify rounds "
                             "(MPT-30B's widths, every launch ragged)"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
