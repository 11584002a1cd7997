"""Normalization suite: layernorm + softmax + L2-normalize (counterpart
of ``cubecl_tpu.ops.normalization``).

Reference: examples/normalization (normalize/magnitude vector ops,
src/lib.rs:4-15) — BASELINE config 3 extends it to layernorm + softmax
with line vectorization.

The seven ``@cube`` bodies are the JAX package's, unchanged. The ``*_rows``
kernels give one 8-unit cube to a row and fold its statistics with
``plane_sum``/``plane_max``: their bodies step by a literal 8, so the cube
stays 8 units on CUDA too, and the plane is the whole cube (8 lanes of one
warp, the others masked). One warp per row would need a body that steps by
the cube width. The ``*_lines`` kernels put a whole row on one line and
one row on each unit. Where the row is wide enough (:func:`warp_lines`)
the CUDA printer runs each unit on a warp, and :func:`_wide_plan` then
picks at most 8 units a cube, spread over the SMs; a narrower row keeps
one thread a unit, and the plan bounds the threads per block, where the
TPU plan bounded VMEM.
"""

from __future__ import annotations

from ..backend.cuda.printer import least_warp_line
from ..frontend import (
    CUBE_POS_X,
    UNIT_POS,
    ArrayArg,
    MutSlice,
    Slice,
    Vector,
    cube,
    cube_range,
    exp,
    line_max,
    line_sum,
    max_,
    plane_max,
    plane_sum,
    rsqrt,
    sqrt,
)
from ..ir.types import f32
from ..runtime.base import CubeCount, CubeDim
from ..runtime.handle import Handle

CD = 8


@cube
def layernorm_rows(inp: Slice, gamma: Slice, beta: Slice, out: MutSlice,
                   iters: int, inv_n: float, eps: float):
    """One cube per row; row length = iters * 8 * line lines."""
    base = CUBE_POS_X * (iters * 8)
    acc = Vector.zeros(f32, inp.line_size)
    acc2 = Vector.zeros(f32, inp.line_size)
    for k in cube_range(0, iters):
        v = inp[base + k * 8 + UNIT_POS]
        acc = acc + v
        acc2 = acc2 + v * v
    mean = plane_sum(line_sum(acc)) * inv_n
    ex2 = plane_sum(line_sum(acc2)) * inv_n
    inv_std = rsqrt(ex2 - mean * mean + eps)
    for k in cube_range(0, iters):
        idx = base + k * 8 + UNIT_POS
        g = gamma[k * 8 + UNIT_POS]
        b = beta[k * 8 + UNIT_POS]
        out[idx] = (inp[idx] - mean) * inv_std * g + b


@cube
def softmax_rows(inp: Slice, out: MutSlice, iters: int):
    """Numerically-stable row softmax (max-subtract, two-pass)."""
    base = CUBE_POS_X * (iters * 8)
    m = inp[base + UNIT_POS]
    for k in cube_range(1, iters):
        m = max_(m, inp[base + k * 8 + UNIT_POS])
    row_max = plane_max(line_max(m))
    s = Vector.zeros(f32, inp.line_size)
    for k in cube_range(0, iters):
        s = s + exp(inp[base + k * 8 + UNIT_POS] - row_max)
    denom = plane_sum(line_sum(s))
    inv = 1.0 / denom
    for k in cube_range(0, iters):
        idx = base + k * 8 + UNIT_POS
        out[idx] = exp(inp[idx] - row_max) * inv


@cube
def normalize_rows(inp: Slice, out: MutSlice, iters: int, eps: float):
    """L2 normalize (reference normalize/magnitude)."""
    base = CUBE_POS_X * (iters * 8)
    acc = Vector.zeros(f32, inp.line_size)
    for k in cube_range(0, iters):
        v = inp[base + k * 8 + UNIT_POS]
        acc = acc + v * v
    mag = sqrt(plane_sum(line_sum(acc)) + eps)
    inv = 1.0 / mag
    for k in cube_range(0, iters):
        idx = base + k * 8 + UNIT_POS
        out[idx] = inp[idx] * inv


# -- wide variants: one LINE per row ----------------------------------------
# The whole row rides one line (line_size = row length) and each unit
# (thread) owns a row: pure line reductions, no plane ops.


@cube
def softmax_lines(inp: Slice, out: MutSlice, iters: int, stride: int):
    base = CUBE_POS_X * (iters * stride)
    for k in cube_range(0, iters):
        idx = base + k * stride + UNIT_POS
        x = inp[idx]
        e = exp(x - line_max(x))
        out[idx] = e * (1.0 / line_sum(e))


@cube
def softmax_lines_inplace(buf: MutSlice, iters: int, stride: int):
    """In-place row softmax: loads and stores on one buffer."""
    base = CUBE_POS_X * (iters * stride)
    for k in cube_range(0, iters):
        idx = base + k * stride + UNIT_POS
        x = buf[idx]
        e = exp(x - line_max(x))
        buf[idx] = e * (1.0 / line_sum(e))


@cube
def layernorm_lines(inp: Slice, gamma: Slice, beta: Slice, out: MutSlice,
                    iters: int, stride: int, inv_n: float, eps: float):
    g = gamma[0]
    b = beta[0]
    base = CUBE_POS_X * (iters * stride)
    for k in cube_range(0, iters):
        idx = base + k * stride + UNIT_POS
        x = inp[idx]
        mu = line_sum(x) * inv_n
        xc = x - mu
        var = line_sum(xc * xc) * inv_n
        out[idx] = xc * rsqrt(var + eps) * g + b


@cube
def normalize_lines(inp: Slice, out: MutSlice, iters: int, stride: int,
                    eps: float):
    base = CUBE_POS_X * (iters * stride)
    for k in cube_range(0, iters):
        idx = base + k * stride + UNIT_POS
        x = inp[idx]
        out[idx] = x * rsqrt(line_sum(x * x) + eps)


#: threads per block of the one-row-per-thread kernels: enough blocks to
#: cover the H100's 132 SMs comes first, so the plan takes the largest
#: width up to this bound that still gives that many
MAX_ROW_UNITS = 128
#: units (warps) per block of the warp-lined kernels: 256 threads
MAX_WARP_UNITS = 8
_SMS = 132


def warp_lines(row: int, *dtypes) -> bool:
    """Does the CUDA printer run a unit of these row kernels on a warp? A
    row (one line) of at least 32 chunks of 16 bytes of the narrowest of
    the kernel's buffers (``backend/cuda/printer.py::warp_vector``; the
    bodies here hold nothing else that rule refuses)."""
    return row >= least_warp_line(min(d.itemsize for d in dtypes))


def _wide_plan(rows: int, warps: bool = False):
    """(units, iters, cubes) for ``rows`` rows (a multiple of 8), one row
    a unit. Warp-lined (``warps``): the widest cube of up to
    MAX_WARP_UNITS units that divides the rows and still gives every SM a
    cube, else one unit a cube, so that few rows (decode's 8) spread over
    as many SMs. Else one row per thread: the widest cube of
    8..MAX_ROW_UNITS threads that divides the rows and still gives every
    SM a cube, else 8."""
    if warps:
        units = next((u for u in (8, 4, 2) if u <= MAX_WARP_UNITS
                      and rows % u == 0 and rows // u >= _SMS), 1)
        return units, 1, rows // units
    widths = [u for u in (128, 64, 32, 16, 8)
              if u <= MAX_ROW_UNITS and rows % u == 0]
    units = next((u for u in widths if rows // u >= _SMS), CD)
    return units, 1, rows // units


def _row_plan(row: int, line_size: int):
    line = line_size
    while line > 1 and row % (line * CD) != 0:
        line //= 2
    if row % (line * CD) != 0:
        raise ValueError(f"row length {row} not tileable by 8 lines")
    return line, row // (line * CD)


def launch_layernorm(client, inp: Handle, gamma: Handle, beta: Handle,
                     out: Handle, rows: int, row: int,
                     line_size: int = 4, eps: float = 1e-5) -> None:
    if row % 128 == 0 and rows % CD == 0:
        units, iters, cubes = _wide_plan(rows, warp_lines(
            row, inp.dtype, gamma.dtype, beta.dtype, out.dtype))
        layernorm_lines.launch_unchecked(
            client, CubeCount(cubes), CubeDim.new_1d(units),
            ArrayArg(inp, line_size=row), ArrayArg(gamma, line_size=row),
            ArrayArg(beta, line_size=row),
            ArrayArg(out, line_size=row, mutable=True),
            iters, units, 1.0 / row, eps)
        return
    line, iters = _row_plan(row, line_size)
    layernorm_rows.launch_unchecked(
        client, CubeCount(rows), CubeDim.new_1d(CD),
        ArrayArg(inp, line_size=line), ArrayArg(gamma, line_size=line),
        ArrayArg(beta, line_size=line), ArrayArg(out, line_size=line,
                                                 mutable=True),
        iters, 1.0 / row, eps)


def launch_softmax(client, inp: Handle, out: Handle, rows: int, row: int,
                   line_size: int = 4) -> None:
    if row % 128 == 0 and rows % CD == 0:
        # wide path: one line per row, one fat (units, row) op per step
        units, iters, cubes = _wide_plan(rows, warp_lines(row, inp.dtype,
                                                          out.dtype))
        if out is inp or out.id == inp.id:
            softmax_lines_inplace.launch_unchecked(
                client, CubeCount(cubes), CubeDim.new_1d(units),
                ArrayArg(inp, line_size=row, mutable=True), iters, units)
            return
        softmax_lines.launch_unchecked(
            client, CubeCount(cubes), CubeDim.new_1d(units),
            ArrayArg(inp, line_size=row),
            ArrayArg(out, line_size=row, mutable=True), iters, units)
        return
    line, iters = _row_plan(row, line_size)
    softmax_rows.launch_unchecked(
        client, CubeCount(rows), CubeDim.new_1d(CD),
        ArrayArg(inp, line_size=line),
        ArrayArg(out, line_size=line, mutable=True), iters)


def launch_normalize(client, inp: Handle, out: Handle, rows: int, row: int,
                     line_size: int = 4, eps: float = 0.0) -> None:
    if row % 128 == 0 and rows % CD == 0:
        units, iters, cubes = _wide_plan(rows, warp_lines(row, inp.dtype,
                                                          out.dtype))
        normalize_lines.launch_unchecked(
            client, CubeCount(cubes), CubeDim.new_1d(units),
            ArrayArg(inp, line_size=row),
            ArrayArg(out, line_size=row, mutable=True), iters, units, eps)
        return
    line, iters = _row_plan(row, line_size)
    normalize_rows.launch_unchecked(
        client, CubeCount(rows), CubeDim.new_1d(CD),
        ArrayArg(inp, line_size=line),
        ArrayArg(out, line_size=line, mutable=True), iters, eps)
