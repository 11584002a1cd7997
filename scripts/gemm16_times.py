#!/usr/bin/env python3
"""Device and host times of the 16-bit and f32 GEMM (M1) and the bf16
expert GEMM (E1) on one CUDA card, measured alike for two checkouts.

    python3 scripts/gemm16_times.py [--tree DIR]

Imports ``cubecl_tpu_torch`` from DIR (default: the checkout this script
is in), so that an older checkout's kernels are timed by the same method
as this one's; the method and the cases are ``chip_smoke.py``'s of this
checkout. For M1: bf16 and f16 at 4096^3, bf16 at the llama FFN
projection (8192 x 5632 x 2048), and f32 at both (the 3xTF32 body in
this checkout; an older tree's f32 body, whatever it is, by the same
method), B as (K, N) and as (N, K), every tile of the tree's that
divides the shape, each by CUDA events back to back (``cuda_ms``), the
fastest kept and also timed with a cold L2 (``cold_ms``: each call after
a read of 1 GiB), beside ``torch.matmul`` (TF32 off) timed both ways,
and the worst error of all tiles as a share of ``TOL`` against plain.
For E1: phase s's bf16 cases
(``E1_CASES``) on the counts of a router (a seeded generator), the
device time by CUDA events, a call's host time (calls enqueued back to
back, the clock read before the queue drains) and its time back to back
(after it drains), beside ``torch.bmm`` over all rows. Each with its
bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, f32 the
lesser of 67 TFLOP/s and three TF32 products at 495, the larger).
Prints the card (``nvidia-smi``) and one JSON line; needs a card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MM_CASES = [(torch.bfloat16, 4096, 4096, 4096), (torch.float16, 4096, 4096,
                                                 4096),
            (torch.bfloat16, 8192, 5632, 2048),
            (torch.float32, 4096, 4096, 4096),
            (torch.float32, 8192, 5632, 2048)]
HOST_CALLS = 200


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    tree = os.path.abspath(ap.parse_args().tree)
    if not torch.cuda.is_available():
        print("gemm16_times: no CUDA device", file=sys.stderr)
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
    print(card)
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"tree": tree, "card": card, "m1": {}, "e1": {}}
    for dt, M, N, K in MM_CASES:
        for bt in (False, True):
            a = cs.mm_operand(gen, dev, dt, (M, K), K)
            b = cs.mm_operand(gen, dev, dt, (N, K) if bt else (K, N), K)
            o = torch.empty(M, N, device=dev, dtype=dt)
            want = mm.matmul_plain(a, b, dt, bt)
            times, margin = {}, 0.0
            atol, rtol = cs.TOL[dt]
            for tile in mm._tile_candidates(M, N, K, dt.itemsize):
                def run(t=tile):
                    mm._gemm(a, b, o, t, bt, counter=mm.matmul_pallas)
                run()
                cs.compare(o, want, f"M1 {dt} {M}x{N}x{K} {tile}")
                # the worst error as a share of its tolerance
                margin = max(margin, ((o.float() - want.float()).abs() / (
                    atol + rtol * want.float().abs())).max().item())
                times[str(tuple(tile))] = cs.cuda_ms(run, iters=20)
            bb = b.t() if bt else b
            lib = cs.cuda_ms(lambda: torch.matmul(a, bb), iters=20)
            lib_cold = cs.cold_ms(lambda: torch.matmul(a, bb))
            bms, by = cs.mm_bound(M, N, K, dt, dt)
            best = min(times, key=times.get)
            tile = tuple(int(x) for x in best.strip("()").split(","))
            cold = cs.cold_ms(lambda: mm._gemm(a, b, o, tile, bt,
                                               counter=mm.matmul_pallas))
            key = (f"{cs._dt(dt)} {M}x{N}x{K} B {'(N, K)' if bt else '(K, N)'}"
                   f" -> {cs._dt(dt)}")
            out["m1"][key] = dict(ms=times[best], tile=best, tiles_ms=times,
                                  cold_ms=cold, library_ms=lib,
                                  library_cold_ms=lib_cold, bound_ms=bms,
                                  bound_by=by, worst_err_over_tol=margin)
            print(f"M1 {key}: fastest {best} {times[best]:.4f} ms, cold L2 "
                  f"{cold:.4f}; torch.matmul {lib:.4f} ms, cold L2 "
                  f"{lib_cold:.4f}; bound {bms:.4f} ms ({by}); worst "
                  f"|err| / tolerance {margin:.3f} [{card}]", flush=True)
            del a, b, o, want
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
        cl = counts.tolist()
        got = moe.expert_matmul(xg, w, counts)
        ref = moe.expert_matmul_plain(xg, w, counts)
        for e, n in enumerate(cl):
            if n:
                cs.compare(got[e, :n], ref[e, :n], f"E1 {name} expert {e}")
        ms = cs.cuda_ms(lambda: moe.expert_matmul(xg, w, counts), iters=30)
        lib = cs.cuda_ms(lambda: torch.bmm(xg, w), iters=20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            moe.expert_matmul(xg, w, counts)
        host = 1e3 * (time.perf_counter() - t0) / HOST_CALLS
        torch.cuda.synchronize()
        b2b = 1e3 * (time.perf_counter() - t0) / HOST_CALLS
        bms, by = cs.expert_bound(cl, cap, d, f, dtype)
        out["e1"][name] = dict(ms=ms, host_ms=host, back_to_back_ms=b2b,
                               library_ms=lib, bound_ms=bms, bound_by=by,
                               counts=cl)
        print(f"E1 {name}: counts {cl}: {ms:.4f} ms device; host "
              f"{host:.4f} ms a call, {b2b:.4f} back to back; torch.bmm "
              f"{lib:.4f} ms; bound {bms:.4f} ms ({by}) [{card}]",
              flush=True)
        del xg, w, counts, got, ref
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
