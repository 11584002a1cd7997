#!/usr/bin/env python3
"""Device times of K0's quantize and dequantize kernels at f32 4096^2 on
one CUDA card, measured alike for two checkouts, and the launch plans the
block quantize and the dequantize could take.

    python3 scripts/quant_times.py [--tree DIR] [--variants]

Imports ``cubecl_tpu_torch`` from DIR (default: the checkout this script
is in), so that an older checkout's kernels are timed by the same method
as this one's; the method and the shapes are ``chip_smoke.py``'s of this
checkout (phase o). At both levels (one per-tensor scale, 4096 block
scales) it checks the quantized values and scales and the dequantized
output against ``quantize_plain`` and ``dequantize_plain`` bit for bit,
counts each call's launches by kernel name, and prints each call's device
time with a cold L2 (``cold_ms``: each call after a read of 1 GiB) and
back to back with its host time (``cuda_ms``), the plain version's time,
the bound (one read of the input, one write of the output, the scales;
bytes over 3.35 TB/s) and, for the dequantize, the library call
``torch.mul(values.view(-1, block), scales.view(-1, 1))`` (timed only).

``--variants`` (this checkout only) also times, cold, with the outputs
allocated once: the dequantize kernel in lines of 1, 4 and 16 over about
1024 and 4096 cubes of 256 units at both levels, and in lines of 512
over cubes of 8 units (the printer's warp lines: a warp a unit, 16-byte
loads and stores); the block quantize kernel (it reads a block twice);
and the block quantizes it was chosen over, defined here: the same with
each unit's elements held in registers (read once), and with them held
and the planes' maxima crossing the cube through a global scratch
instead of shared memory; a plane a block in lines of 1, 4 and 16 with
8 blocks or 1 block a cube; a 256-unit cube a block folding |x| with
``Slice.block_max`` and ``block_min``. Each against the plain version's
bits. Prints the card (``nvidia-smi``) and one JSON
line; needs a card.
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
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _iters(cs, fn):
    """Fewer timed calls for a call that takes ~0.1 s (a parent's
    one-cube kernels)."""
    ms = cs.cuda_ms(fn, iters=1, warmup=1)
    return 3 if ms > 10 else 20


def _launches(cu, fn):
    cu.server.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(cu.server.launches)


def _same(cs, what, got, want):
    differ = int((got != want).sum())
    if differ:
        cs.fail(f"{what}: {differ} elements differ from the plain "
                f"version's bits")


def tree_times(cs, qk, cu, dev, gen, card):
    """The tree's quantize and dequantize at both levels, as a caller
    launches them."""
    from cubecl_tpu_torch.std.quant import QuantLevel, QuantScheme

    out, n = {}, cs.QUANT_N
    x = torch.randn(n, generator=gen, device=dev) * 3
    xh = cu.create(x)
    for scheme in (QuantScheme(), QuantScheme(level=QuantLevel.BLOCK,
                                              block_size=cs.QUANT_BLOCK)):
        level = scheme.level.value
        (vals, scales), q_launch = _launches(
            cu, lambda scheme=scheme: qk.quantize(cu, xh, scheme))
        back, d_launch = _launches(
            cu, lambda scheme=scheme: qk.dequantize(cu, vals, scales,
                                                     scheme))
        pv, ps = qk.quantize_plain(x, scheme)
        _same(cs, f"quantize {level} values", vals.tensor, pv)
        _same(cs, f"quantize {level} scales", scales.tensor, ps)
        _same(cs, f"dequantize {level}", back.tensor,
              qk.dequantize_plain(pv, ps, scheme))
        block = n // ps.numel()
        row = {}
        for op, run, plain, lib in (
                ("quantize", lambda s=scheme: qk.quantize(cu, xh, s),
                 lambda s=scheme: qk.quantize_plain(x, s), None),
                ("dequantize",
                 lambda s=scheme: qk.dequantize(cu, vals, scales, s),
                 lambda s=scheme: qk.dequantize_plain(pv, ps, s),
                 lambda b=block: torch.mul(pv.view(-1, b), ps.view(-1, 1)))):
            iters = _iters(cs, run)
            bms, by = cs.bound_ms(2 * n if op == "quantize" else n,
                                  5 * n + 4 * ps.numel(), torch.float32)
            r = dict(cold_ms=cs.cold_ms(run, iters=iters),
                     ms=cs.cuda_ms(run, iters=iters, warmup=1),
                     plain_ms=cs.cuda_ms(plain), bound_ms=bms, bound_by=by,
                     launches=q_launch if op == "quantize" else d_launch)
            if lib is not None:
                r["library_ms"] = cs.cold_ms(lib)
            row[op] = r
            print(f"K0 {op} {level} f32 4096^2 ({ps.numel()} scales, "
                  f"launches {r['launches']}): cold L2 {r['cold_ms']:.4f} "
                  f"ms, back to back {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}, "
                  f"{100 * bms / r['cold_ms']:.1f}% of it)"
                  + (f", torch.mul {r['library_ms']:.4f} ms cold"
                     if lib is not None else "")
                  + f"; the plain version's bits [{card}]", flush=True)
        out[level] = row
        del vals, scales, back, pv, ps
    return out


def variant_times(cs, qk, cu, dev, gen, card):
    """Cold times of the plans this checkout's kernels can take."""
    from cubecl_tpu_torch.frontend import (CUBE_POS_X, PLANE_POS, UNIT_POS,
                                           UNIT_POS_PLANE, ArrayArg,
                                           MutSlice, SharedMemory, Slice,
                                           abs_, cast, clamp, cube,
                                           cube_range, line_max, max_,
                                           plane_max, round_, sync_cube)
    from cubecl_tpu_torch.ir.types import f32, i8
    from cubecl_tpu_torch.runtime.base import CubeCount, CubeDim
    from cubecl_tpu_torch.std.quant import QuantLevel, QuantScheme

    @cube
    def quantize_block_planes(x: Slice, values: MutSlice, scales: MutSlice,
                              steps: int, block_lines: int, planes: int,
                              rmax: float):
        # one plane a block, `planes` blocks a cube, |x| folded a line a
        # step, then the block read again for the values
        blk = CUBE_POS_X * planes + PLANE_POS
        base = blk * block_lines
        m = 0.0
        for k in cube_range(0, steps):
            m = max_(m, line_max(abs_(x[base + k * 32 + UNIT_POS_PLANE])))
        scale = max_(plane_max(m) / rmax, 1e-12)
        if UNIT_POS_PLANE == 0:
            scales[blk] = scale
        inv = 1.0 / scale
        for k in cube_range(0, steps):
            j = base + k * 32 + UNIT_POS_PLANE
            values[j] = cast(clamp(round_(x[j] * inv), -rmax - 1.0, rmax),
                             i8)

    @cube
    def quantize_block_held(x: Slice, values: MutSlice, scales: MutSlice,
                            iters: int, rmax: float):
        # the tree's kernel at a block of 256 x iters elements, each unit's
        # elements kept in registers from the fold to the values (a
        # comptime loop)
        base = CUBE_POS_X * (iters * 256)
        held = []
        m = 0.0
        for k in range(iters):
            v = x[base + k * 256 + UNIT_POS]
            held.append(v)
            m = max_(m, abs_(v))
        m = plane_max(m)
        maxima = SharedMemory.new(f32, 8)
        if UNIT_POS_PLANE == 0:
            maxima[PLANE_POS] = m
        sync_cube()
        m = maxima[0]
        for p in range(1, 8):
            m = max_(m, maxima[p])
        scale = max_(m / rmax, 1e-12)
        if UNIT_POS == 0:
            scales[CUBE_POS_X] = scale
        inv = 1.0 / scale
        for k in range(iters):
            values[base + k * 256 + UNIT_POS] = cast(
                clamp(round_(held[k] * inv), -rmax - 1.0, rmax), i8)

    @cube
    def quantize_block_cube(x: Slice, values: MutSlice, scales: MutSlice,
                            iters: int, block_lines: int, rmax: float):
        # a cube a block: block_max and block_min over the block, then the
        # block read again for the values
        base = CUBE_POS_X * block_lines
        hi = x.block_max(base, block_lines)
        lo = x.block_min(base, block_lines)
        scale = max_(max_(abs_(hi), abs_(lo)) / rmax, 1e-12)
        if UNIT_POS == 0:
            scales[CUBE_POS_X] = scale
        inv = 1.0 / scale
        for k in cube_range(0, iters):
            idx = base + k * 256 + UNIT_POS
            values[idx] = cast(clamp(round_(x[idx] * inv), -rmax - 1.0,
                                     rmax), i8)

    @cube
    def quantize_block_scratch(x: Slice, values: MutSlice, scales: MutSlice,
                               partials: MutSlice, iters: int, rmax: float):
        # the held route with the planes' maxima crossing the cube through
        # a global scratch of 8 and a block max over it
        base = CUBE_POS_X * (iters * 256)
        held = []
        m = 0.0
        for k in range(iters):
            v = x[base + k * 256 + UNIT_POS]
            held.append(v)
            m = max_(m, line_max(abs_(v)))
        m = plane_max(m)
        if UNIT_POS_PLANE == 0:
            partials[CUBE_POS_X * 8 + PLANE_POS] = m
        sync_cube()
        amax = partials.block_max(CUBE_POS_X * 8, 8)
        scale = max_(amax / rmax, 1e-12)
        if UNIT_POS == 0:
            scales[CUBE_POS_X] = scale
        inv = 1.0 / scale
        for k in range(iters):
            values[base + k * 256 + UNIT_POS] = cast(
                clamp(round_(held[k] * inv), -rmax - 1.0, rmax), i8)

    n, block = cs.QUANT_N, cs.QUANT_BLOCK
    x = torch.randn(n, generator=gen, device=dev) * 3
    xh = cu.create(x)
    bs = QuantScheme(level=QuantLevel.BLOCK, block_size=block)
    pv, ps = qk.quantize_plain(x, bs)
    tv, ts = qk.quantize_plain(x, QuantScheme())
    vals, scales = cu.empty((n,), "int8"), cu.empty((n // block,), "float32")
    outs = cu.empty((n,), "float32")
    nb, runs = n // block, {}
    cubes, units, steps = qk.block_plan(n, block)
    runs["quantize block, the tree's quantize_block_kernel (read twice)"] = (
        "q", lambda cl, c=cubes, u=units, s=steps:
        qk.quantize_block_kernel.launch_unchecked(
            cl, CubeCount(c), CubeDim.new_1d(u), ArrayArg(xh),
            ArrayArg(vals, mutable=True), ArrayArg(scales, mutable=True),
            s, u, block, 127.0))
    runs["quantize block, the same, each unit's elements held in "
         "registers (read once)"] = (
        "q", lambda cl: quantize_block_held.launch_unchecked(
            cl, CubeCount(nb), CubeDim.new_1d(256), ArrayArg(xh),
            ArrayArg(vals, mutable=True), ArrayArg(scales, mutable=True),
            block // 256, 127.0))
    for line in (1, 4, 16):
        for planes in (8, 1):
            runs[f"quantize block, a plane a block, lines of {line}, "
                 f"{planes} blocks a cube"] = (
                "q", lambda cl, line=line, p=planes:
                quantize_block_planes.launch_unchecked(
                    cl, CubeCount(nb // p), CubeDim.new_1d(32 * p),
                    ArrayArg(xh, line_size=line),
                    ArrayArg(vals, line_size=line, mutable=True),
                    ArrayArg(scales, mutable=True), block // line // 32,
                    block // line, p, 127.0))
    runs["quantize block, a 256-unit cube a block, block_max + block_min, "
         "lines of 4"] = ("q", lambda cl: quantize_block_cube
                          .launch_unchecked(
                              cl, CubeCount(nb), CubeDim.new_1d(256),
                              ArrayArg(xh, line_size=4),
                              ArrayArg(vals, line_size=4, mutable=True),
                              ArrayArg(scales, mutable=True),
                              block // 4 // 256, block // 4, 127.0))
    scratch = cu.empty((nb * 8,), "float32")
    for line in (1, 4):
        runs[f"quantize block, a 256-unit cube a block, lines of {line} "
             f"held, the planes' maxima through a global scratch"] = (
            "q", lambda cl, line=line: quantize_block_scratch
            .launch_unchecked(cl, CubeCount(nb), CubeDim.new_1d(256),
                              ArrayArg(xh, line_size=line),
                              ArrayArg(vals, line_size=line, mutable=True),
                              ArrayArg(scales, mutable=True),
                              ArrayArg(scratch, mutable=True),
                              block // line // 256, 127.0))
    for level, (v, s) in (("block", (pv, ps)), ("tensor", (tv, ts))):
        vh, sh = cu.create(v), cu.create(s)
        for line, units in ((1, 256), (4, 256), (16, 256), (512, 8)):
            for target in (1024, 4096):
                cubes, iters = qk.dequantize_plan(n, line, target, units)
                runs[f"dequantize {level}, lines of {line}, {cubes} cubes "
                     f"of {units} units"] \
                    = (level, lambda cl, line=line, c=cubes, i=iters,
                       u=units, vh=vh, sh=sh,
                       bl=(block // line if level == "block" else 0):
                       qk.dequantize_chunk_kernel.launch_unchecked(
                           cl, CubeCount(c), CubeDim.new_1d(u),
                           ArrayArg(vh, line_size=line), ArrayArg(sh),
                           ArrayArg(outs, line_size=line, mutable=True), i,
                           n // line, bl))
    co = cs.compile_only(cu)  # every variant's nvcc at once
    for _, run in runs.values():
        run(co)
    cu.server.wait_builds()
    want = {"block": qk.dequantize_plain(pv, ps, bs),
            "tensor": qk.dequantize_plain(tv, ts, QuantScheme())}
    out = {}
    for name, (kind, launch) in runs.items():
        run = lambda launch=launch: launch(cu)  # noqa: E731
        run()
        torch.cuda.synchronize()
        if kind == "q":
            _same(cs, name, vals.tensor, pv)
            _same(cs, name, scales.tensor, ps)
            vals.tensor.zero_()
            scales.tensor.zero_()
        else:
            _same(cs, name, outs.tensor, want[kind])
            outs.tensor.zero_()
        out[name] = cs.cold_ms(run)
        print(f"{name}, f32 4096^2: cold L2 {out[name]:.4f} ms; the plain "
              f"version's bits [{card}]", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if not torch.cuda.is_available():
        print("quant_times: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, tree)
    from cubecl_tpu_torch.runtime import CudaRuntime
    from cubecl_tpu_torch.std import quant_kernels as qk

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device=dev).manual_seed(18)
    cu = CudaRuntime.client()
    out = {"tree": tree, "card": card,
           "quant": tree_times(cs, qk, cu, dev, gen, card)}
    if args.variants:
        out["variants"] = variant_times(cs, qk, cu, dev, gen, card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
