"""GELU elementwise kernel (BASELINE config 1; reference examples/gelu/
src/lib.rs:3-19) — counterpart of ``cubecl_tpu.ops.gelu``.

The ``@cube`` bodies are the JAX package's, unchanged: the same DSL source
runs on both backends. Only the launch plan of :func:`launch_gelu` is
re-derived for CUDA: 4-element lines (one 16-byte f32 load) and 256-thread
cubes, where the TPU plan used 128-lane lines and 8-unit steps sized to
its VMEM."""

from __future__ import annotations

import math

import numpy as np

from ..frontend import (
    ABSOLUTE_POS,
    CUBE_POS_X,
    UNIT_POS,
    ArrayArg,
    MutSlice,
    Slice,
    cube,
    cube_range,
    erf,
)
from ..frontend.comptime import comptime
from ..runtime.base import CubeCount, CubeDim
from ..runtime.handle import Handle


@cube
def gelu_scalar(x):
    """exact gelu via erf (comptime sqrt(2), reference gelu_scalar)."""
    sqrt2 = comptime(math.sqrt(2.0))
    return x * (erf(x / sqrt2) + 1.0) / 2.0


@cube
def gelu_array(inp: Slice, out: MutSlice):
    if ABSOLUTE_POS < inp.len():
        out[ABSOLUTE_POS] = gelu_scalar(inp[ABSOLUTE_POS])


@cube
def gelu_array_exact(inp: Slice, out: MutSlice):
    """no-guard variant for exactly-tiled launches (fast path)."""
    out[ABSOLUTE_POS] = gelu_scalar(inp[ABSOLUTE_POS])


@cube
def gelu_inplace(buf: MutSlice, iters: int, stride: int):
    """In-place gelu: one mutable buffer swept as ``iters`` slabs of
    ``stride`` lines per cube (the JAX package's fat-block kernel)."""
    base = CUBE_POS_X * (iters * stride)
    for k in cube_range(0, iters):
        idx = base + k * stride + UNIT_POS
        buf[idx] = gelu_scalar(buf[idx])


def launch_gelu(client, inp: Handle, out: Handle, line_size: int = 4,
                cube_dim: int = 256, checked: bool = False) -> None:
    """GELU of ``inp`` into ``out`` (``out is inp``: in place), on the
    exact (unguarded, whole cubes), checked (ragged tail) or in-place
    path, as the JAX package's ``launch_gelu`` picks them."""
    n = int(np.prod(inp.shape))
    if (out is inp or out.id == inp.id) and n % line_size == 0 \
            and not checked:
        # in-place path: each thread sweeps `iters` lines, `units` apart,
        # so a warp's loads stay contiguous
        lines = n // line_size
        if lines % cube_dim == 0:
            iters = next(it for it in (8, 4, 2, 1)
                         if lines % (cube_dim * it) == 0)
            gelu_inplace.launch_unchecked(
                client, CubeCount(lines // (cube_dim * iters)),
                CubeDim.new_1d(cube_dim),
                ArrayArg(inp, line_size=line_size, mutable=True), iters,
                cube_dim)
            return
    epc = line_size * cube_dim
    if n % epc == 0 and not checked:
        cubes = n // epc
        gelu_array_exact.launch_unchecked(
            client, CubeCount(cubes), CubeDim.new_1d(cube_dim),
            ArrayArg(inp, line_size=line_size),
            ArrayArg(out, line_size=line_size, mutable=True))
    else:
        line = line_size if n % line_size == 0 else 1
        cubes = -(-n // (line * cube_dim))
        gelu_array.launch(
            client, CubeCount(cubes), CubeDim.new_1d(cube_dim),
            ArrayArg(inp, line_size=line),
            ArrayArg(out, line_size=line, mutable=True))
