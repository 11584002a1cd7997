"""Misc std utilities: swizzle, reinterpret_slice, trigonometry,
matrix_batch_layout, comptime event bus (counterpart of
``cubecl_tpu.std.misc``).

Reference: cubecl-std/src/{swizzle.rs, reinterpret_slice.rs,
trigonometry.rs, tensor/matrix_batch_layout.rs, event/mod.rs:18}.
A reinterpreted load is ``op.reinterpret`` on the loaded line, which K0
lowers as a bit copy on the card and ``Tensor.view(dtype)`` in the torch
evaluator.
"""

from __future__ import annotations

import enum
import math
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple


# ---------------------------------------------------------------- swizzle


def swizzle_xor(index, log_bank: int, log_tile: int):
    """XOR-swizzle an index to spread bank conflicts (reference
    swizzle.rs): the row's low ``log_bank`` bits flip the index above
    ``log_tile`` (on the card, shared-memory banks)."""
    row = index >> log_tile
    return index ^ ((row & ((1 << log_bank) - 1)) << log_tile)


def swizzle_2d(row, col, width_log2: int):
    """2D tile swizzle: col' = col ^ row (mod width)."""
    mask = (1 << width_log2) - 1
    return row, col ^ (row & mask)


# --------------------------------------------------------- reinterpret


def reinterpret_slice(slice_, elem):
    """View a buffer as a different element type (reference
    reinterpret_slice.rs). Total byte count is preserved."""
    old = slice_.ty
    factor_num = old.elem.size * old.line
    factor_den = elem.size
    assert factor_num % factor_den == 0, \
        f"cannot reinterpret {old!r} as {elem.name}"
    new_line = factor_num // factor_den
    return slice_.with_line_size(new_line) if elem == old.elem else \
        _reinterpret_typed(slice_, elem, new_line)


def _reinterpret_typed(slice_, elem, new_line):
    """Cross-dtype view: loads go through the ORIGINAL buffer type and a
    per-access bitcast (``op.reinterpret``, with the line absorbing any
    width ratio)."""
    old = slice_.ty
    # one view line == one underlying line in bytes
    assert new_line * elem.size == old.line * old.elem.size
    return _ReinterpretedSlice(slice_, elem, new_line)


class _ReinterpretedSlice:
    """Read-only typed view over another slice (quantized-view pattern,
    reference quant/view.rs + reinterpret_slice.rs)."""

    def __init__(self, base, elem, line):
        self._base = base
        self._elem = elem
        self._line = line

    def len(self) -> int:
        return self._base.len()

    __len__ = len

    @property
    def line_size(self) -> int:
        return self._line

    @property
    def ty(self):
        from ..ir.types import Type

        return Type(self._elem, self._line)

    def __getitem__(self, idx):
        return self._base[idx].reinterpret(self._elem)


# -------------------------------------------------------- trigonometry


SQRT_2 = math.sqrt(2.0)
FRAC_1_SQRT_2 = 1.0 / math.sqrt(2.0)
PI = math.pi
FRAC_PI_2 = math.pi / 2


def sin_cos(x):
    """(sin x, cos x) pair (reference trigonometry.rs)."""
    from ..frontend.functions import cos, sin

    return sin(x), cos(x)


# -------------------------------------------------- matrix batch layout


class MatrixBatchLayout(enum.Enum):
    """How batched matrix dims are laid out (reference
    matrix_batch_layout.rs)."""

    CONTIGUOUS = "contiguous"
    MILD_PERMUTED = "mild_permuted"
    HIGHLY_PERMUTED = "highly_permuted"


def matrix_batch_layout(strides: Tuple[int, ...]) -> MatrixBatchLayout:
    """Classify a batched-matmul operand by its batch strides."""
    if len(strides) <= 2:
        return MatrixBatchLayout.CONTIGUOUS
    mat = strides[-2:]
    if mat[-1] != 1:
        return MatrixBatchLayout.HIGHLY_PERMUTED
    expected = mat[0]  # rows * row-stride approximates the matrix size
    batch = strides[:-2]
    prev = None
    for s in sorted(batch, reverse=True):
        if prev is not None and s > prev:
            return MatrixBatchLayout.MILD_PERMUTED
        prev = s
    return MatrixBatchLayout.CONTIGUOUS if all(
        b >= expected for b in batch) else MatrixBatchLayout.MILD_PERMUTED


# -------------------------------------------------- comptime event bus


class EventBus:
    """Compile-time pub/sub for kernel composition (reference
    event/mod.rs:18): fusion authors publish events at trace time; other
    comptime components subscribe and inject IR."""

    def __init__(self) -> None:
        self._subs: Dict[str, List[Callable[..., None]]] = defaultdict(list)

    def subscribe(self, topic: str, fn: Callable[..., None]) -> None:
        self._subs[topic].append(fn)

    def publish(self, topic: str, *args: Any, **kwargs: Any) -> None:
        for fn in self._subs[topic]:
            fn(*args, **kwargs)

    def clear(self, topic: str = None) -> None:
        if topic is None:
            self._subs.clear()
        else:
            self._subs.pop(topic, None)


GLOBAL_EVENTS = EventBus()
