"""into_contiguous — layout normalization kernels (counterpart of
``cubecl_tpu.std.contiguous``).

Reference: cubecl-std/src/tensor/contiguous/base.rs:22-479 (fastdivmod
indexing + packed variants) and the identity-matrix kernel
(tensor/identity.rs), plus ``TensorHandle`` (tensor/handle.rs:13).

The two ``@cube`` kernels are the JAX package's bodies and run on K0. A
view that is a permutation of contiguous memory is copied by
``permute().contiguous()`` (the JAX package left it to XLA's transpose);
any other strided view goes through the gather kernel ``_copy_permuted``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..frontend import (
    ABSOLUTE_POS,
    ArrayArg,
    MutSlice,
    TensorArg,
    cube,
)
from ..frontend.tensor import MutTensor, Tensor
from ..runtime.base import CubeCount, CubeDim
from ..runtime.handle import Handle


class TensorHandle:
    """Host-side tensor handle: buffer + shape/strides (reference
    tensor/handle.rs:13)."""

    def __init__(self, handle: Handle, shape: Tuple[int, ...],
                 strides: Tuple[int, ...] = None):
        self.handle = handle
        self.shape = tuple(shape)
        if strides is None:
            strides = []
            acc = 1
            for s in reversed(self.shape):
                strides.append(acc)
                acc *= s
            strides = tuple(reversed(strides))
        self.strides = tuple(strides)

    def is_contiguous(self) -> bool:
        acc = 1
        for s, st in zip(reversed(self.shape), reversed(self.strides)):
            if st != acc:
                return False
            acc *= s
        return True


@cube
def _copy_permuted(src: Tensor, dst: MutTensor, rank: int,
                   out_shape: tuple, src_strides: tuple):
    """Gather one element per unit following the (comptime) permuted
    strides. rank/out_shape/src_strides are comptime."""
    pos = ABSOLUTE_POS
    if pos < dst.len():
        # decompose linear output index into coords (comptime loop over rank)
        rem = pos
        src_lin = 0
        for d in range(rank - 1, -1, -1):
            c = rem % out_shape[d]
            rem = rem // out_shape[d]
            src_lin = src_lin + c * src_strides[d]
        dst[pos] = src[src_lin]


def _as_permutation(src: TensorHandle):
    """If the view is a permuted contiguous layout, return (memory_shape,
    perm) s.t. transpose(reshape(data, memory_shape), perm) == view."""
    order = sorted(range(len(src.shape)), key=lambda i: -src.strides[i])
    mem_shape = tuple(src.shape[i] for i in order)
    acc = 1
    for i in reversed(order):
        if src.strides[i] != acc:
            return None
        acc *= src.shape[i]
    # perm maps memory dims -> view dims: view dim i is memory dim pos(i)
    inv = [0] * len(order)
    for mem_pos, view_dim in enumerate(order):
        inv[view_dim] = mem_pos
    return mem_shape, tuple(inv)


GATHER_CUBE = 64  # units a cube of the gather and identity kernels


def into_contiguous(client, src: TensorHandle) -> TensorHandle:
    """Materialize a contiguous copy of a strided/permuted tensor.

    Fast path: a view that permutes contiguous memory is
    ``permute().contiguous()`` on the handle's tensor; any other strided
    view runs the gather kernel ``_copy_permuted`` (K0)."""
    if src.is_contiguous():
        return src
    n = int(np.prod(src.shape))

    perm = _as_permutation(src)
    if perm is not None:
        mem_shape, p = perm
        flat = src.handle.tensor.reshape(-1)[:int(np.prod(mem_shape))]
        out = flat.view(mem_shape).permute(p).contiguous().reshape(-1)
        return TensorHandle(Handle(out), src.shape)

    out = client.empty((n,), str(src.handle.dtype).replace("torch.", ""))
    cubes = -(-n // GATHER_CUBE)
    _copy_permuted.launch(
        client, CubeCount(cubes), CubeDim.new_1d(GATHER_CUBE),
        TensorArg(src.handle, shape=(src.handle.tensor.numel(),),
                  strides=(1,), line_size=1),
        TensorArg(out, shape=(n,), strides=(1,), line_size=1, mutable=True),
        len(src.shape), tuple(src.shape), tuple(src.strides))
    return TensorHandle(out, src.shape)


@cube
def _identity_kernel(out: MutSlice, n: int):
    pos = ABSOLUTE_POS
    if pos < out.len():
        row = pos // n
        col = pos % n
        one = 1.0
        zero = 0.0
        if row == col:
            out[pos] = one
        else:
            out[pos] = zero


def identity(client, n: int, dtype: str = "float32") -> Handle:
    """Identity matrix kernel (reference tensor/identity.rs)."""
    out = client.empty((n * n,), dtype)
    cubes = (n * n + GATHER_CUBE - 1) // GATHER_CUBE
    _identity_kernel.launch(client, CubeCount(cubes),
                            CubeDim.new_1d(GATHER_CUBE),
                            ArrayArg(out, mutable=True), n)
    return out


def empty_tensor(client, shape, dtype="float32",
                 policy: str = "contiguous",
                 pitch_align: int = 128) -> TensorHandle:
    """Allocate a tensor under a MemoryLayoutPolicy (reference
    allocator.rs / server MemoryLayoutPolicy): ``contiguous`` packs
    rows; ``pitched`` pads the innermost stride up to ``pitch_align``
    elements so every row starts aligned (CUDA's pitched allocations:
    128 f32 elements are 512 bytes, so every row starts on a 16-byte
    vector and a 128-byte line)."""
    shape = tuple(shape)
    if policy == "contiguous" or len(shape) < 2:
        h = client.empty((int(np.prod(shape)),), dtype)
        return TensorHandle(h, shape)
    if policy != "pitched":
        raise ValueError(f"unknown layout policy {policy!r}")
    inner = shape[-1]
    pitch = -(-inner // pitch_align) * pitch_align
    strides = []
    acc = 1
    for i, s in enumerate(reversed(shape)):
        strides.append(acc)
        acc *= pitch if i == 0 else s
    strides = tuple(reversed(strides))
    h = client.empty((acc,), dtype)
    return TensorHandle(h, shape, strides)
