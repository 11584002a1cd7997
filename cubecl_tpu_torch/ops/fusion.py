"""Comptime kernel fusion (BASELINE config 5): counterpart of
``cubecl_tpu.ops.fusion``, with its public names.

Reference: examples/fusing/src/lib.rs:16-33 — a comptime list of operations
folded over a Sequence of buffers at trace time, producing ONE fused
kernel. Ops and buffer counts are comptime, so each (ops, n_buffers) combo
is its own KernelId — exactly the reference's comptime-fusion capability.
On a card the fused chain is one K0 kernel printed as CUDA C++: the chain
is inlined, element by element, into the store loop, so every input is
read once and the output written once (bound by bytes). Its 128-element
f32 lines are wide enough for the printer's warp lines: each unit is a
warp and each lane moves 16 bytes of every buffer.
"""

from __future__ import annotations

from typing import Optional
from typing import Sequence as PySeq

import numpy as np

from ..frontend import (
    ABSOLUTE_POS,
    ArrayArg,
    MutSlice,
    Sequence,
    cube,
)
from ..frontend import functions as F
from ..runtime.base import CubeCount, CubeDim
from ..runtime.handle import Handle
from .normalization import MAX_WARP_UNITS, warp_lines

# comptime op vocabulary (host lambdas over traced values)
FUSABLE = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "max": F.max_,
    "min": F.min_,
    "relu": lambda a: F.max_(a, 0.0),
    "gelu": None,  # resolved lazily (cube fn)
    "exp": F.exp,
    "tanh": F.tanh,
    "sqrt": F.sqrt,
    "neg": lambda a: -a,
    "square": lambda a: a * a,
}

BINARY = ("add", "sub", "mul", "div", "max", "min")


def _resolve(op):
    if callable(op):
        return op
    fn = FUSABLE.get(op)
    if fn is None and op == "gelu":
        from .gelu import gelu_scalar

        return gelu_scalar
    if fn is None:
        raise KeyError(f"unknown fusable op {op!r}")
    return fn


@cube
def fused_chain(inputs: Sequence, out: MutSlice, ops: tuple):
    """Fold binary ops over the input sequence, then apply unary ops —
    all at comptime; the traced kernel is a single fused elementwise pass
    (reference fusing example shape)."""
    pos = ABSOLUTE_POS
    acc = inputs[0][pos]
    i = 1
    for op in ops:
        f = _resolve(op)
        if op in BINARY:
            acc = f(acc, inputs[i][pos])
            i = i + 1
        else:
            acc = f(acc)
    out[pos] = acc


#: units a cube of the one-thread-a-unit plan (lines narrower than warp
#: lines take, or single elements)
THREAD_UNITS = 64


def launch_fused(client, inputs: PySeq[Handle], out: Handle,
                 ops: PySeq[str], line_size: int = 128,
                 cube_dim: Optional[int] = None) -> None:
    """One launch of ``fused_chain`` over ``inputs`` (one more than the
    binary ops) into ``out``: lines of ``line_size`` where whole cubes
    tile the output, else single elements. The cube (``cube_dim`` unless
    given): MAX_WARP_UNITS warps where the lines are warp lines on CUDA
    (f32's 128: 16M elements are 16384 cubes of 256 threads), else
    THREAD_UNITS threads."""
    n = int(np.prod(out.shape))
    binary = sum(1 for op in ops if op in BINARY)
    assert len(inputs) == binary + 1, \
        f"{binary} binary ops need {binary + 1} inputs, got {len(inputs)}"
    if cube_dim is None:
        warps = warp_lines(line_size, *(h.dtype for h in (*inputs, out)))
        cube_dim = MAX_WARP_UNITS if warps and \
            n % (line_size * MAX_WARP_UNITS) == 0 else THREAD_UNITS
    line = line_size if n % (line_size * cube_dim) == 0 else 1
    cubes = -(-n // (line * cube_dim))
    seq = Sequence([ArrayArg(h, line_size=line) for h in inputs])
    fused_chain.launch(
        client, CubeCount(cubes), CubeDim.new_1d(cube_dim),
        seq, ArrayArg(out, line_size=line, mutable=True), tuple(ops))
