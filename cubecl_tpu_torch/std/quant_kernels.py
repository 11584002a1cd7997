"""Device-side quantization kernels (counterpart of
``cubecl_tpu.std.quant_kernels``; K0 kernels).

Reference: cubecl-std/src/quant/{dequantize,round,view}.rs. The JAX
package's plan is one grid step per quant block, a cube of 8 units (one
for each of the TPU's sublanes), a single step over a whole tensor. On
the H100 an 8-unit cube is a warp with 8 live lanes, at most 32 cubes
are resident on an SM, and one cube walking a tensor runs on one SM
(62.7 ms for a per-tensor dequantize of 16M values at 700 W). So the
port keeps the JAX kernels' function, bit for bit, and plans them for
the card:

- block scales (``QuantLevel.BLOCK``): ``quantize_block_kernel``, one
  cube of up to 256 units a block (``block_plan``), lines of 1 so that a
  warp's loads are 128 contiguous bytes; |x| folds a unit, then a plane
  (``plane_max``), then across the cube's planes through a shared array
  of one maximum a plane; the values read the block again;
- one per-tensor scale (``QuantLevel.TENSOR``): two launches over many
  cubes. ``quantize_tensor_absmax`` folds |x| over contiguous chunks,
  one f32 partial per cube of one plane (a line of 4 a unit a step, then
  ``plane_max``); ``quantize_tensor_values`` folds the partials in every
  cube to the same absmax (``block_max`` over a few KB in L2), takes the
  scale and writes its chunk's int8 values (chunks in reverse order, so
  that the tail pass 1 left in L2 is read first). ``tensor_plan`` sizes
  both;
- the dequantize at both levels: ``dequantize_chunk_kernel`` over about
  1024 cubes of 256 units (``dequantize_plan``), lines of 1, each chunk
  cut at the tensor's end; a line's scale is its block's, or the one
  per-tensor scale loaded once.

The absmax is a max, exact in any order, and the scale is the quotient
``max(absmax / rmax, 1e-12)`` as the JAX kernel takes it, so any plan
gives its values and scales; a dequantized value is one f32 product of
an exact int8 conversion. ``round_`` prints as ``rintf`` (half to even,
as numpy's and torch's round). Every output element is written by a
kernel, so outputs are allocated without a fill. ``quantize_plain`` and
``dequantize_plain`` are the kernels' function in plain PyTorch, with the
same arithmetic, so the card holds the kernels to them bit for bit. The
JAX package's one-cube-a-block ``dequantize_block_kernel`` and its
unused ``dequantize_tensor_kernel`` stay, unlaunched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend import (
    ABSOLUTE_POS,
    CUBE_COUNT_X,
    CUBE_DIM,
    CUBE_POS_X,
    PLANE_POS,
    UNIT_POS,
    UNIT_POS_PLANE,
    ArrayArg,
    MutSlice,
    SharedMemory,
    Slice,
    abs_,
    cast,
    clamp,
    cube,
    cube_range,
    line_max,
    max_,
    min_,
    plane_max,
    round_,
    sync_cube,
)
from ..ir.types import f32, i8
from ..runtime.base import CubeCount, CubeDim
from ..runtime.handle import Handle
from .quant import QuantLevel, QuantScheme

CD = 8
PLANE = 32

# The block quantize: a cube of at most BLOCK_UNITS units a block. Both
# dequantizes: chunks of DEQ_UNITS units, lines of DEQ_LINE int8 in and
# f32 out, about DEQ_CUBES cubes (one wave of 256-unit cubes on 132 SMs)
BLOCK_UNITS = 256
DEQ_UNITS = 256
DEQ_LINE = 1
DEQ_CUBES = 1024


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
                          steps: int, units: int, block: int, rmax: float):
    """Symmetric per-block int8 quantization: absmax → scale → round. One
    cube of ``units`` units a block, lines of 1: unit u takes elements u,
    u + units, ... of its block, ``steps`` of them (past a ragged block's
    end it reads the block's last element again and writes nothing). The
    fold: |x| a unit, ``plane_max`` a plane, then a shared array of one
    maximum a plane across the cube. The values read the block again: at
    blocks of 4096 on an H100 that is as fast as holding each unit's
    elements in registers (``scripts/quant_times.py --variants``)."""
    base = CUBE_POS_X * block
    ragged = block % units != 0
    m = 0.0
    for k in cube_range(0, steps):
        j = k * units + UNIT_POS
        m = max_(m, abs_(x[base + (min_(j, block - 1) if ragged else j)]))
    m = plane_max(m)
    planes = units // PLANE
    if planes > 1:
        maxima = SharedMemory.new(f32, planes)
        if UNIT_POS_PLANE == 0:
            maxima[PLANE_POS] = m
        sync_cube()
        m = maxima[0]
        for p in range(1, planes):
            m = max_(m, maxima[p])
    scale = max_(m / rmax, 1e-12)
    if UNIT_POS == 0:
        scales[CUBE_POS_X] = scale
    inv = 1.0 / scale
    for k in cube_range(0, steps):
        j = k * units + UNIT_POS
        if j < block if ragged else True:
            values[base + j] = cast(clamp(round_(x[base + j] * inv),
                                          -rmax - 1.0, rmax), i8)


@cube
def dequantize_tensor_kernel(values: Slice, out: MutSlice, scale):
    base = CUBE_POS_X * 8
    idx = base + UNIT_POS
    out[idx] = cast(values[idx], f32) * scale


@cube
def dequantize_chunk_kernel(values: Slice, scales: Slice, out: MutSlice,
                            iters: int, n_lines: int, block_lines: int):
    """Cube c dequantizes chunk c: ``iters`` strides of its units' lines,
    the last chunk cut at the tensor's end. Line i takes scale i //
    ``block_lines``, or the one per-tensor scale where ``block_lines`` is
    0 (a uniform load)."""
    if block_lines == 0:
        s = scales[0]
    base = CUBE_POS_X * (iters * CUBE_DIM)
    for k in cube_range(0, iters):
        idx = base + k * CUBE_DIM + UNIT_POS
        if idx < n_lines:
            if block_lines:
                out[idx] = cast(values[idx], f32) * scales[idx // block_lines]
            else:
                out[idx] = cast(values[idx], f32) * s


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


def _chunks(n_lines: int, units: int, cubes: int):
    """(cubes, iters): about ``cubes`` chunks of ``iters`` strides of
    ``units`` lines over ``n_lines`` lines, the last cut at the end."""
    iters = max(1, -(-n_lines // (cubes * units)))
    return -(-n_lines // (iters * units)), iters


def tensor_plan(n: int):
    """(cubes, iters) of pass 1 and of pass 2 for n elements (n % 8 == 0)
    in lines of ``TENSOR_LINE``: chunks of ``iters`` strides of
    ``TENSOR_PLANE`` and of ``TENSOR_UNITS`` lines, the last cut at the
    tensor's end."""
    return tuple(_chunks(n // TENSOR_LINE, units, TENSOR_CUBES)
                 for units in (TENSOR_PLANE, TENSOR_UNITS))


def _output(client, n: int, dtype: torch.dtype) -> Handle:
    """An output buffer whose every element the kernel writes: allocated
    without ``client.empty``'s zero fill (a write of the whole buffer)."""
    return Handle(torch.empty(n, dtype=dtype, device=client.device))


def _quantize_tensor(client, x: Handle, n: int, rmax: float):
    if n <= 0 or n % CD:
        raise ValueError(f"a per-tensor scale takes a multiple of {CD} "
                         f"elements; got {n}")
    (c1, iters1), (c2, iters) = tensor_plan(n)
    partials = _output(client, c1, torch.float32)
    values = _output(client, n, torch.int8)
    scales = _output(client, 1, torch.float32)
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


def _check(n: int, block: int):
    if n <= 0 or n % block or block % CD:
        raise ValueError(f"{n} elements in blocks of {block}: a block "
                         f"takes a multiple of {CD} elements and tiles the "
                         f"tensor")


def block_plan(n: int, block: int):
    """(cubes, units, steps) of ``quantize_block_kernel`` for n elements
    in blocks of ``block``: a cube a block of whole planes, at most
    BLOCK_UNITS units, ``steps`` elements a unit."""
    units = min(BLOCK_UNITS, PLANE * -(-block // PLANE))
    return n // block, units, -(-block // units)


def dequantize_plan(n: int, line: int = DEQ_LINE, cubes: int = DEQ_CUBES,
                    units: int = DEQ_UNITS):
    """(cubes, iters) of ``dequantize_chunk_kernel`` for n elements in
    lines of ``line`` and cubes of ``units`` units."""
    return _chunks(n // line, units, cubes)


def quantize(client, x: Handle, scheme: QuantScheme):
    """→ (values, scales) handles: block scales by :func:`block_plan`,
    one per-tensor scale by :func:`tensor_plan`."""
    n = int(np.prod(x.shape))
    rmax = scheme.range_max()
    if scheme.level != QuantLevel.BLOCK:
        return _quantize_tensor(client, x, n, rmax)
    block = scheme.block_size
    _check(n, block)
    cubes, units, steps = block_plan(n, block)
    values = _output(client, n, torch.int8)
    scales = _output(client, cubes, torch.float32)
    quantize_block_kernel.launch_unchecked(
        client, CubeCount(cubes), CubeDim.new_1d(units), ArrayArg(x),
        ArrayArg(values, mutable=True), ArrayArg(scales, mutable=True),
        steps, units, block, rmax)
    return values, scales


def dequantize(client, values: Handle, scales: Handle,
               scheme: QuantScheme) -> Handle:
    """The f32 values of int8 ``values`` with their scales, at either
    level, over :func:`dequantize_plan`'s chunks."""
    n = int(np.prod(values.shape))
    block = scheme.block_size if scheme.level == QuantLevel.BLOCK else n
    _check(n, block)
    cubes, iters = dequantize_plan(n)
    out = _output(client, n, torch.float32)
    dequantize_chunk_kernel.launch_unchecked(
        client, CubeCount(cubes), CubeDim.new_1d(DEQ_UNITS),
        ArrayArg(values, line_size=DEQ_LINE), ArrayArg(scales),
        ArrayArg(out, line_size=DEQ_LINE, mutable=True), iters,
        n // DEQ_LINE, 0 if block == n else block // DEQ_LINE)
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
