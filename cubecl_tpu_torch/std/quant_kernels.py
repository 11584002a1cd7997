"""Device-side quantization kernels (counterpart of
``cubecl_tpu.std.quant_kernels``; K0 kernels).

Reference: cubecl-std/src/quant/{dequantize,round,view}.rs. Block scales
(``QuantLevel.BLOCK``) keep the JAX package's kernels and launch plan: one
cube per quant block so block scales are cube-uniform loads. A cube is 8
units (the bodies step by a literal 8), which on the card is one plane:
the ``plane_max`` of ``quantize_block_kernel`` reduces over those 8 lanes,
as the TPU's 8-sublane plane does, so the scales are the same numbers.
``round_`` prints as ``rintf`` (half to even, as numpy's and torch's
round). The line size is 16 where a block tiles by 8 lines of 16 (a
thread then reads 64 bytes of f32 per step), else 1. ``quantize_plain``
and ``dequantize_plain`` are the kernels' function in plain PyTorch, with
the same arithmetic, so the card holds the kernels to them bit for bit.

One per-tensor scale (``QuantLevel.TENSOR``) on the H100 is two launches
over many cubes instead of the TPU's one grid step (one 8-unit cube
walking the whole tensor twice, ~121 ms at 16M f32 on the card):
``quantize_tensor_absmax`` folds |x| over contiguous chunks, one f32
partial per cube of one plane (a line of 4 a unit a step, then
``plane_max``); ``quantize_tensor_values`` folds the partials in every
cube to the same absmax (``block_max`` over a few KB in L2), takes the
scale as the TPU kernel does and writes its chunk's int8 values (chunks
in reverse order, so that the tail pass 1 left in L2 is read first). The
absmax is a max, exact in any order, so the scale and the values are the
TPU kernel's bits. ``tensor_plan`` sizes both. Bound: the bytes of one
read of x and one write of the values; two passes read x twice.
``dequantize`` keeps the one-cube-a-block kernel at both levels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend import (
    ABSOLUTE_POS,
    CUBE_COUNT_X,
    CUBE_POS_X,
    UNIT_POS,
    ArrayArg,
    MutSlice,
    Slice,
    abs_,
    cast,
    clamp,
    cube,
    cube_range,
    line_max,
    max_,
    plane_max,
    round_,
)
from ..ir.types import f32, i8
from ..runtime.base import CubeCount, CubeDim
from ..runtime.handle import Handle
from .quant import QuantLevel, QuantScheme

CD = 8


@cube
def dequantize_block_kernel(values: Slice, scales: Slice, out: MutSlice,
                            iters: int):
    """One cube per quant block; the block scale is a uniform load."""
    s = scales[CUBE_POS_X]
    base = CUBE_POS_X * (iters * 8)
    for k in cube_range(0, iters):
        idx = base + k * 8 + UNIT_POS
        out[idx] = cast(values[idx], f32) * s


@cube
def quantize_block_kernel(x: Slice, values: MutSlice, scales: MutSlice,
                          iters: int, rmax: float):
    """Symmetric per-block int8 quantization: absmax → scale → round."""
    base = CUBE_POS_X * (iters * 8)
    m = abs_(x[base + UNIT_POS])
    for k in cube_range(0, iters):
        m = max_(m, abs_(x[base + k * 8 + UNIT_POS]))
    amax = plane_max(line_max(m))
    scale = max_(amax / rmax, 1e-12)
    if UNIT_POS == 0:
        scales[CUBE_POS_X] = scale
    inv = 1.0 / scale
    for k in cube_range(0, iters):
        idx = base + k * 8 + UNIT_POS
        q = clamp(round_(x[idx] * inv), -rmax - 1.0, rmax)
        values[idx] = cast(q, i8)


@cube
def dequantize_tensor_kernel(values: Slice, out: MutSlice, scale):
    base = CUBE_POS_X * 8
    idx = base + UNIT_POS
    out[idx] = cast(values[idx], f32) * scale


# One per-tensor scale: about 1024 cubes a pass (the partials every cube
# of pass 2 folds stay a few KB), lines of 4 f32 (16 bytes). Pass 1 folds
# |x| in cubes of one plane (32 units, a line a unit a step, one sweep of
# x: 0.031 ms at 16M f32 against block_max and block_min's two sweeps'
# 0.045 on an H100); pass 2 folds the partials with the cube-cooperative
# block_max in cubes of eight warps, then writes the values
TENSOR_PLANE = 32
TENSOR_UNITS = 256
TENSOR_LINE = 4
TENSOR_CUBES = 1024


@cube
def quantize_tensor_absmax(x: Slice, partials: MutSlice, iters: int,
                           n_lines: int):
    """Pass 1: cube c's max |x| over its chunk of ``iters`` strides of the
    plane's 32 lines (the last chunk cut at the tensor's end), as
    ``quantize_block_kernel`` folds a block: ``abs_``, ``line_max``, then
    ``plane_max``."""
    m = 0.0
    base = CUBE_POS_X * (iters * TENSOR_PLANE)
    for k in cube_range(0, iters):
        idx = base + k * TENSOR_PLANE + UNIT_POS
        if idx < n_lines:
            m = max_(m, line_max(abs_(x[idx])))
    partials[CUBE_POS_X] = plane_max(m)


@cube
def quantize_tensor_values(x: Slice, partials: Slice, values: MutSlice,
                           scales: MutSlice, iters: int, n_lines: int,
                           rmax: float):
    """Pass 2: every cube folds the partials to the tensor's absmax and
    takes the scale as ``quantize_block_kernel`` does; cube c writes the
    int8 values of chunk ``count - 1 - c`` (``iters`` strides of the
    cube's units)."""
    amax = partials.block_max(0, partials.len())
    scale = max_(amax / rmax, 1e-12)
    if ABSOLUTE_POS == 0:
        scales[0] = scale
    inv = 1.0 / scale
    base = (CUBE_COUNT_X - 1 - CUBE_POS_X) * (iters * TENSOR_UNITS)
    for k in cube_range(0, iters):
        idx = base + k * TENSOR_UNITS + UNIT_POS
        if idx < n_lines:
            values[idx] = cast(clamp(round_(x[idx] * inv), -rmax - 1.0,
                                     rmax), i8)


def tensor_plan(n: int):
    """(cubes, iters) of pass 1 and of pass 2 for n elements (n % 8 == 0)
    in lines of ``TENSOR_LINE``: chunks of ``iters`` strides of
    ``TENSOR_PLANE`` and of ``TENSOR_UNITS`` lines, the last cut at the
    tensor's end."""
    n_lines = n // TENSOR_LINE
    plan = []
    for units in (TENSOR_PLANE, TENSOR_UNITS):
        iters = max(1, -(-n_lines // (TENSOR_CUBES * units)))
        plan.append((-(-n_lines // (iters * units)), iters))
    return tuple(plan)


def _quantize_tensor(client, x: Handle, n: int, rmax: float):
    if n <= 0 or n % CD:
        raise ValueError(f"a per-tensor scale takes a multiple of {CD} "
                         f"elements; got {n}")
    (c1, iters1), (c2, iters) = tensor_plan(n)
    partials = client.empty((c1,), "float32")
    values = client.empty((n,), "int8")
    scales = client.empty((1,), "float32")
    quantize_tensor_absmax.launch_unchecked(
        client, CubeCount(c1), CubeDim.new_1d(TENSOR_PLANE),
        ArrayArg(x, line_size=TENSOR_LINE), ArrayArg(partials, mutable=True),
        iters1, n // TENSOR_LINE)
    quantize_tensor_values.launch_unchecked(
        client, CubeCount(c2), CubeDim.new_1d(TENSOR_UNITS),
        ArrayArg(x, line_size=TENSOR_LINE), ArrayArg(partials),
        ArrayArg(values, line_size=TENSOR_LINE, mutable=True),
        ArrayArg(scales, mutable=True), iters, n // TENSOR_LINE, rmax)
    return values, scales


def _block_plan(n: int, block: int, line: int):
    if n % block or block % (line * CD):
        raise ValueError(f"{n} elements in blocks of {block} must tile by "
                         f"{CD} lines of {line}")
    return n // block, block // (line * CD)


def quantize(client, x: Handle, scheme: QuantScheme,
             line_size: int = 16):
    """→ (values, scales) handles. ``line_size`` is the block route's;
    one per-tensor scale takes :func:`tensor_plan`'s."""
    n = int(np.prod(x.shape))
    rmax = scheme.range_max()
    if scheme.level != QuantLevel.BLOCK:
        return _quantize_tensor(client, x, n, rmax)
    block = scheme.block_size
    line = line_size if block % (line_size * CD) == 0 else 1
    cubes, iters = _block_plan(n, block, line)
    values = client.empty((n,), "int8")
    scales = client.empty((cubes,), "float32")
    quantize_block_kernel.launch_unchecked(
        client, CubeCount(cubes), CubeDim.new_1d(CD),
        ArrayArg(x, line_size=line), ArrayArg(values, line_size=line,
                                              mutable=True),
        ArrayArg(scales, mutable=True), iters, rmax)
    return values, scales


def dequantize(client, values: Handle, scales: Handle,
               scheme: QuantScheme, line_size: int = 16) -> Handle:
    n = int(np.prod(values.shape))
    block = scheme.block_size if scheme.level == QuantLevel.BLOCK else n
    line = line_size if block % (line_size * CD) == 0 else 1
    cubes, iters = _block_plan(n, block, line)
    out = client.empty((n,), "float32")
    dequantize_block_kernel.launch_unchecked(
        client, CubeCount(cubes), CubeDim.new_1d(CD),
        ArrayArg(values, line_size=line), ArrayArg(scales),
        ArrayArg(out, line_size=line, mutable=True), iters)
    return out


def quantize_plain(x: torch.Tensor, scheme: QuantScheme):
    """:func:`quantize` in plain PyTorch, with the kernel's arithmetic
    (``x * (1 / scale)``, half-to-even rounding): (int8 values, f32
    scales), the same bits."""
    n = x.numel()
    block = scheme.block_size if scheme.level == QuantLevel.BLOCK else n
    rmax = scheme.range_max()
    xb = x.reshape(-1, block).float()
    amax = xb.abs().amax(1)
    # divided by a tensor: torch on a card divides by a Python scalar as
    # a product with its reciprocal, which is not the kernel's division
    scale = torch.clamp_min(amax / torch.full_like(amax, rmax), 1e-12)
    inv = 1.0 / scale
    q = torch.clamp(torch.round(xb * inv[:, None]), -rmax - 1.0, rmax)
    return q.to(torch.int8).reshape(-1), scale


def dequantize_plain(values: torch.Tensor, scales: torch.Tensor,
                     scheme: QuantScheme) -> torch.Tensor:
    """:func:`dequantize` in plain PyTorch."""
    n = values.numel()
    block = scheme.block_size if scheme.level == QuantLevel.BLOCK else n
    return (values.reshape(-1, block).float()
            * scales.reshape(-1, 1)).reshape(-1)
