"""Device-side quantization kernels (counterpart of
``cubecl_tpu.std.quant_kernels``; K0 kernels, bodies unchanged).

Reference: cubecl-std/src/quant/{dequantize,round,view}.rs. One cube per
quant block so block scales are cube-uniform loads. A cube is 8 units
(the bodies step by a literal 8), which on the card is one plane: the
``plane_max`` of ``quantize_block_kernel`` reduces over those 8 lanes, as
the TPU's 8-sublane plane does, so the scales are the same numbers.
``round_`` prints as ``rintf`` (half to even, as numpy's and torch's
round). The line size is 16 where a block tiles by 8 lines of 16 (a
thread then reads 64 bytes of f32 per step), else 1. ``quantize_plain``
and ``dequantize_plain`` are the kernels' function in plain PyTorch, with
the same arithmetic, so the card holds the kernels to them bit for bit.

What bounds them on the H100: one cube of 8 threads per quant block, as
the TPU's one grid step per block, so a whole-tensor scale is one block
walking the tensor twice, latency-bound far from the bytes bound; a
two-pass reduction over many blocks is later work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend import (
    CUBE_POS_X,
    UNIT_POS,
    ArrayArg,
    MutSlice,
    Slice,
    cast,
    clamp,
    cube,
    cube_range,
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
    from ..frontend import abs_, max_, line_max, plane_max

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


def _block_plan(n: int, block: int, line: int):
    if n % block or block % (line * CD):
        raise ValueError(f"{n} elements in blocks of {block} must tile by "
                         f"{CD} lines of {line}")
    return n // block, block // (line * CD)


def quantize(client, x: Handle, scheme: QuantScheme,
             line_size: int = 16):
    """→ (values, scales) handles."""
    n = int(np.prod(x.shape))
    rmax = scheme.range_max()
    block = scheme.block_size if scheme.level == QuantLevel.BLOCK else n
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
