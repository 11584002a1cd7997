#!/usr/bin/env python3
"""Device times of the row-wise K0 kernels and their library calls on one
CUDA card, measured alike for two checkouts.

    python3 scripts/k0_times.py [--tree DIR]

Imports ``cubecl_tpu_torch`` from DIR (default: the checkout this script
is in), so that an older checkout's kernels are timed by the same method
as this one's; the timing (``cold_ms``: each call after a read of 1 GiB
that evicts L2, CUDA events around the call alone) is ``chip_smoke.py``'s
of this checkout. For each kernel at the shape of ``chip_smoke.py``'s
phases a, e and q: its cold device time, the time of a call back to back
(host included), its bound (bytes over 3.35 TB/s or operations over 67
TFLOP/s f32, the larger) and the library call's cold time. Then the
cold times of ``matmul_cmma`` at bf16 512^3 and bf16 and f16 4096^3
(beside ``torch.mm(out_dtype=float32)``) and f32 512^3 and 4096^3 (beside
``torch.matmul``, TF32 off; bound: the lesser of the CUDA cores' and
three TF32 products'; and the worst error against plain as a share of
f32's tolerance), and of ``reduce_sum_blockwise`` at 64M f32 in 32
windows (beside ``torch.sum(dim=1)`` over the windows); then the cold
times of K0 kernels outside the warp-lines rule (gelu's 4-element lines,
the 8-unit ``*_rows`` kernels, the plane-tree reductions) and a digest of
every K0 source built: a kernel whose source is the same in both trees
is the same kernel. Prints the card (``nvidia-smi``) and one JSON line;
needs a card.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        print("k0_times: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, tree)
    from cubecl_tpu_torch.ops import functional as F
    from cubecl_tpu_torch.ops import fusion as FU
    from cubecl_tpu_torch.ops import gelu as G
    from cubecl_tpu_torch.ops import matmul as MM
    from cubecl_tpu_torch.ops import normalization as N
    from cubecl_tpu_torch.ops import reduce as R
    from cubecl_tpu_torch.runtime import CudaRuntime

    import torch.nn.functional as TF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 library calls

    def rn(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    cu = CudaRuntime.client()
    rows = {}

    def time_row(name, launch, library, n, elem, moved, flops, bound=None):
        launch()
        torch.cuda.synchronize()
        rows[name] = dict(
            ms=cs.cold_ms(launch), call_ms=cs.cuda_ms(launch),
            library_ms=None if library is None else cs.cold_ms(library),
            bound_ms=bound if bound is not None else cs.elementwise_bound(
                n, elem, moved, flops)[0])

    x, g = rn(8192, 2048), rn(2048)
    time_row("_rmsnorm_fwd_k bf16 8192x2048",
             lambda: F.rmsnorm(x, g, cs.RMS_EPS, client=cu),
             lambda: TF.rms_norm(x, (2048,), g, cs.RMS_EPS), x.numel(), 2, 2,
             cs.K0_OPS["rmsnorm"])
    for op, shape, args in (("rmsnorm", (8184, 2048), 2),
                            ("layernorm", (8192, 768), 3),
                            ("gelu", (8192, 3072), 1)):
        xs, dy = rn(*shape), rn(*shape)
        gs = [rn(shape[-1]) for _ in range(args - 1)]
        kern = getattr(F, f"_{op}_bwd_k")
        ins = [xs] + gs[:1] + [dy]
        sc = () if op == "gelu" else (1.0 / shape[-1], 1e-5)
        lib_fwd = {"rmsnorm": lambda t, w: TF.rms_norm(t, (shape[-1],), w,
                                                        1e-5),
                   "layernorm": lambda t, w, b: TF.layer_norm(
                       t, (shape[-1],), w, b, 1e-5),
                   "gelu": lambda t: TF.gelu(t)}[op]
        time_row(f"_{op}_bwd_k bf16 {shape[0]}x{shape[1]}",
                 lambda kern=kern, ins=ins, sc=sc, xs=xs: F._rows(
                     kern, xs, ins, sc, cu),
                 cs.grad_call(lib_fwd, [xs] + gs, dy), xs.numel(), 2, 3,
                 cs.K0_OPS[f"{op} bwd"])
    ins = [rn(cs.FUSE_N, dt=torch.float32) for _ in range(3)]
    hs = [cu.create(t) for t in ins]
    out = cu.empty((cs.FUSE_N,), "float32")
    time_row("fused_chain relu((a+b)*c) f32 16M",
             lambda: FU.launch_fused(cu, hs, out, ["add", "mul", "relu"]),
             None, cs.FUSE_N, 4, 4, 3)
    rows["fused_chain relu((a+b)*c) f32 16M"]["eager_torch_ms"] = \
        cs.cold_ms(lambda: torch.relu((ins[0] + ins[1]) * ins[2]))

    # cmma on the tensor cores (16-bit, and f32 as three TF32 products),
    # and the block sums over windows split across full cubes
    for dt, S in ((torch.bfloat16, 512), (torch.bfloat16, cs.MM_S),
                  (torch.float16, cs.MM_S), (torch.float32, 512),
                  (torch.float32, cs.MM_S)):
        a, b = (cs.mm_operand(gen, dev, dt, (S, S), S) for _ in range(2))
        hc = [cu.create(a.reshape(-1)), cu.create(b.reshape(-1)),
              cu.empty((S * S,), "float32")]
        lib = (lambda a=a, b=b: torch.matmul(a, b)) if dt == torch.float32 \
            else (lambda a=a, b=b: torch.mm(a, b, out_dtype=torch.float32))
        name = f"matmul_cmma {cs._dt(dt)} {S}^3 -> f32"
        time_row(name, lambda hc=hc, S=S: MM.matmul_cmma(cu, *hc, S, S, S),
                 lib, None, None, None, None,
                 bound=cs.mm_bound(S, S, S, dt, torch.float32)[0])
        # the worst error against plain as a share of f32's tolerance
        want = MM.matmul_plain(a, b, torch.float32)
        atol, rtol = cs.TOL[torch.float32]
        rows[name]["worst_err_over_tol"] = ((hc[2].tensor.view(S, S) - want)
                                            .abs() / (atol + rtol * want.abs())
                                            ).max().item()
    big = cu.create(rn(cs.RED_N, dt=torch.float32))
    time_row("reduce_sum_blockwise f32 64M, 32 windows (block + fold)",
             lambda: R.reduce_sum_blockwise(cu, big, cubes=cs.BLOCK_CUBES),
             lambda: torch.sum(big.tensor.view(cs.BLOCK_CUBES, -1), dim=1),
             None, None, None, None,
             bound=cs.bound_ms(cs.RED_N, cs.RED_N * 4, torch.float32)[0])

    outside = {}
    x1 = cu.create(rn(1 << 20, dt=torch.float32))
    o1 = cu.create(torch.empty(1 << 20, device=dev))
    xr = cu.create(rn(4, 1024, dt=torch.float32))
    orow = cu.create(torch.empty(4, 1024, device=dev))
    gb = [cu.create(rn(1024, dt=torch.float32)) for _ in range(2)]
    for name, launch in (
            ("gelu_array_exact f32 1M", lambda: G.launch_gelu(cu, x1, o1)),
            ("gelu_array checked f32 1M",
             lambda: G.launch_gelu(cu, x1, o1, checked=True)),
            ("softmax_rows f32 4x1024",
             lambda: N.launch_softmax(cu, xr, orow, 4, 1024)),
            ("layernorm_rows f32 4x1024",
             lambda: N.launch_layernorm(cu, xr, *gb, orow, 4, 1024)),
            ("normalize_rows f32 4x1024",
             lambda: N.launch_normalize(cu, xr, orow, 4, 1024, eps=1e-6)),
            ("reduce_sum f32 64M (plane tree)",
             lambda: R.reduce_sum(cu, big)),
            ("reduce_max f32 64M (plane tree)",
             lambda: R.reduce_max(cu, big))):
        launch()
        torch.cuda.synchronize()
        outside[name] = cs.cold_ms(launch)
    sources = {}
    for k in cu.server._cache.values():
        if hasattr(k.fn, "build"):
            sources.setdefault(k.name, []).append(
                hashlib.sha256(k.source.encode()).hexdigest()[:16])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"tree": tree, "k0_times": rows,
                      "outside_the_rule_ms": outside,
                      "k0_sources": {k: sorted(v)
                                     for k, v in sorted(sources.items())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
