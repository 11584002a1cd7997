#!/usr/bin/env python3
"""Device times of P1's windowed decode (``paged_window_kernel``) against
the window's length, on one CUDA card.

    python3 scripts/p1_window_times.py

At ``chip_smoke.py`` phase z1's shape (the 0.77B llama's decode: B 8 x Hkv
8 x G 2 x D 128 in bf16, a 16-layer pool of 33 pages of 128, every row at
context 4160, sinks 4) for windows of 64 to 4156 positions, and the same
call with window 0 (every position: ``paged_decode_kernel``): each call's
device time with a cold L2 (``chip_smoke.cold_ms``), its position splits
and tiles a split walks (``p1_plan``, ``p1_window_tiles``), its bound on the
positions it attends, and the least-squares line of cold time against the
tiles a split walks (the intercept is what a call costs whatever it reads:
its two launches, the pipeline's ramp, the block's combine). Prints the
card (``nvidia-smi``) and one JSON line; needs a card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = [64, 256, 500, 1000, 1500, 2000, 3000, 4156]


def main():
    if not torch.cuda.is_available():
        print("p1_window_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cubecl_tpu_torch.ops import paged_attention as pa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    z = cs.STREAM
    B, L, Hkv, G, D = z["B"], 16, 8, 2, 128
    page, pages, sinks = z["page"], z["pages"], z["sinks"]
    length = z["S"] + z["steps"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    P = B * pages + 5
    shape = (L, Hkv, P, page, D)
    q = torch.randn(B, Hkv * G, D, generator=gen, device=dev).to(
        torch.bfloat16)
    kp, vp = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    table = torch.randperm(P, generator=gen, device=dev)[:B * pages]
    table = table.view(B, pages).to(torch.int32)
    ln = torch.full((B,), length, dtype=torch.int32, device=dev)
    rows = []
    for window in [0] + WINDOWS:
        opts = dict(window=window, sinks=sinks)
        got = pa.paged_attention(q, kp, vp, table, ln, layer=L - 1, **opts)
        err = cs.compare(got, pa.paged_attention_plain(
            q, kp, vp, table, ln, layer=L - 1, **opts), f"window {window}")
        cold = cs.cold_ms(lambda: pa.paged_attention(
            q, kp, vp, table, ln, layer=L - 1, **opts))
        plan = pa.p1_plan(torch.bfloat16, torch.bfloat16, B, Hkv * G, Hkv,
                          D, page, pages, window, sinks)
        if window:
            tiles = max(len(pa.p1_window_tiles(plan, length, s, window,
                                               sinks))
                        for s in range(plan.splits))
        else:
            p0, p1 = pa.p1_split_positions(plan, length, 0)
            tiles = -(-(p1 - p0) // pa.P1_TILE)
        pos = np.arange(length)
        live = int(((pos < sinks) | (pos >= length - window)).sum()) \
            if window else length
        bms, by = cs.paged_bound(torch.bfloat16, 2, D, Hkv * G, Hkv,
                                 [live] * B, [live] * B, False, B)
        rows.append(dict(window=window, live_positions=live,
                         splits=plan.splits, tiles_a_split=tiles,
                         cold_ms=cold, bound_ms=bms, bound_by=by,
                         max_abs_err=err))
        print(f"window {window} (sinks {sinks}, {live} live positions): "
              f"{plan.splits} splits of at most {tiles} tiles, cold "
              f"{cold:.4f} ms, bound {bms:.4f} ms ({by}), max abs err "
              f"{err} [{card}]", flush=True)
    win = [r for r in rows if r["window"]]
    slope, icpt = np.polyfit([r["tiles_a_split"] for r in win],
                             [r["cold_ms"] for r in win], 1)
    print(f"windowed cold ms = {icpt:.4f} + {slope:.5f} x tiles a split; "
          f"window 0: {rows[0]['cold_ms']:.4f} ms at "
          f"{rows[0]['tiles_a_split']} tiles [{card}]", flush=True)
    print(json.dumps({"card": card, "rows": rows,
                      "fit_ms": {"intercept": icpt, "per_tile": slope}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
