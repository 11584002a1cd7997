#!/usr/bin/env python3
"""Repeated launches of the tensor-core GEMMs (M1/M2's 8-bit, 16-bit and
f32 bodies, E1 bf16) on one CUDA card, each launch held against plain: a race
between a kernel's warps shows in a few launches of many, not in one.

    python3 scripts/gemm_repeats.py [--tree DIR] [--launches N]

Imports ``cubecl_tpu_torch`` from DIR (default: the checkout this script
is in), so that an older checkout's kernels are run by the same method and
on the same inputs as this one's; the cases, tolerances and timing are
``chip_smoke.py``'s of this checkout. For M1/M2: phase m's cases
(``MM_SHAPES`` x ``MM_CASES``), every tile of the tree's that divides the
shape. For E1: phase s's bf16 cases
(``E1_CASES``), the live rows only. Each case runs N launches (default
1000) into one output, each compared on the device with the plain result
(``disagreeing_launches``: int32 exactly, else at ``TOL``), and is timed by CUDA events
(``cuda_ms``). Prints a line a case (launches that disagree, elements,
ms), the card (``nvidia-smi``) and one JSON line; exits 1 if any launch
disagreed, 2 without a card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_repeats", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--launches", type=int, default=1000)
    args = ap.parse_args()
    tree, n = os.path.abspath(args.tree), args.launches
    if not torch.cuda.is_available():
        print("gemm_repeats: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, tree)
    from cubecl_tpu_torch.ops import matmul as mm
    from cubecl_tpu_torch.ops import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(17)
    rows, failed = {}, 0
    for sname, M, N, K in cs.MM_SHAPES:
        for in_dt, out_dt, bt, epi in cs.MM_CASES:
            a = cs.mm_operand(gen, dev, in_dt, (M, K), K)
            b = cs.mm_operand(gen, dev, in_dt, (N, K) if bt else (K, N), K)
            if epi == "device":
                sa, sb = (torch.tensor([s], device=dev) for s in cs.MM_SCALES)
                scale = sa[0] * sb[0]
            elif epi == "host":
                sa, sb = cs.MM_SCALES
                scale = sa * sb
            else:
                sa = sb = scale = None
            counter = mm.matmul_scaled if epi == "host" else mm.matmul_pallas
            want = mm.matmul_plain(a, b, out_dt, bt, scale)
            o = torch.empty(M, N, device=dev, dtype=out_dt)
            for tile in mm._tile_candidates(M, N, K, in_dt.itemsize):
                def run(t=tile):
                    mm._gemm(a, b, o, t, bt, sa, sb, counter=counter)
                nbad, nel = cs.disagreeing_launches(run, o, want, n)
                ms = cs.cuda_ms(run, iters=20)
                key = f"{cs._mm_what(sname, in_dt, out_dt, bt, epi)} {tile}"
                rows[key] = dict(launches=n, disagree=nbad, elements=nel,
                                 ms=ms)
                failed += nbad
                print(f"{key}: {nbad} of {n} launches disagree ({nel} "
                      f"elements); {ms:.4f} ms [{card}]", flush=True)
            del a, b, o, want
        torch.cuda.empty_cache()
    for name, E, cap, d, f, dtype, spec in cs.E1_CASES:
        if dtype != torch.bfloat16:
            continue
        if isinstance(spec, int):
            xg, counts, _ = cs.routed(moe, gen, dev, spec, E, cap, d, dtype)
        else:
            xg = (torch.randn(E, cap, d, generator=gen, device=dev)
                  * .1).to(dtype)
            counts = torch.tensor(spec, dtype=torch.int32, device=dev)
        w = (torch.randn(E, d, f, generator=gen, device=dev) * .02).to(dtype)
        want = moe.expert_matmul_plain(xg, w, counts)
        live = (torch.arange(cap, device=dev)[None, :, None]
                < counts[:, None, None]).expand_as(want)
        o = torch.empty_like(want)

        def run():
            o.copy_(moe.expert_matmul(xg, w, counts))
        nbad, nel = cs.disagreeing_launches(run, o, want, n, live)
        ms = cs.cuda_ms(lambda: moe.expert_matmul(xg, w, counts), iters=20)
        key = f"E1 {name}"
        rows[key] = dict(launches=n, disagree=nbad, elements=nel, ms=ms,
                         counts=counts.tolist())
        failed += nbad
        print(f"{key}: {nbad} of {n} launches disagree ({nel} elements); "
              f"{ms:.4f} ms [{card}]", flush=True)
        del xg, w, counts, want, live, o
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "card": card, "cases": rows}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
