"""Tensor layouts — coordinate mappings for views; a copy of
``cubecl_tpu.std.layout`` (comptime objects, no kernel).

Reference: the ``Layout`` trait (cubecl-std/src/tensor/layout/base.rs:10-32)
with linear / strided / permuted / chain / slice implementations
(tensor/layout/*.rs) and the ``Coordinates`` abstraction
(layout/coordinates.rs:7).

Layouts here are comptime objects (shapes are static per kernel): they map
coordinates to linear line indices at trace time, emitting only the index
arithmetic into the kernel.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple


class Layout:
    """Maps nd coordinates → linear index (in lines) + bounds check."""

    shape: Tuple[int, ...]

    def to_linear(self, *coords):
        raise NotImplementedError

    def is_in_bounds(self, *coords):
        ok = None
        for c, s in zip(coords, self.shape):
            term = (c < s)
            ok = term if ok is None else (ok & term)
        return True if ok is None else ok

    def num_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


class LinearLayout(Layout):
    """Row-major contiguous (reference linear.rs)."""

    def __init__(self, shape: Sequence[int], line_size: int = 1):
        self.shape = tuple(shape)
        self.line = line_size
        self.strides = []
        acc = 1
        for s in reversed(self.shape):
            self.strides.append(acc)
            acc *= s
        self.strides = tuple(reversed(self.strides))

    def to_linear(self, *coords):
        lin = 0
        for c, st in zip(coords, self.strides):
            lin = lin + c * (st // self.line if st >= self.line else st)
        return lin


class StridedLayout(Layout):
    """Arbitrary strides in elements (reference strided.rs)."""

    def __init__(self, shape: Sequence[int], strides: Sequence[int],
                 line_size: int = 1, offset: int = 0):
        self.shape = tuple(shape)
        self.strides = tuple(strides)
        self.line = line_size
        self.offset = offset

    def to_linear(self, *coords):
        lin = self.offset // self.line if self.line > 1 else self.offset
        for c, st in zip(coords, self.strides):
            lin = lin + c * (st // self.line if st >= self.line else st)
        return lin


class PermutedLayout(Layout):
    """Axis permutation over an inner layout (reference permuted.rs)."""

    def __init__(self, inner: Layout, perm: Sequence[int]):
        self.inner = inner
        self.perm = tuple(perm)
        self.shape = tuple(inner.shape[p] for p in perm)

    def to_linear(self, *coords):
        inv = [0] * len(self.perm)
        for i, p in enumerate(self.perm):
            inv[p] = coords[i]
        return self.inner.to_linear(*inv)


class ChainLayout(Layout):
    """Composition outer∘inner (reference chain.rs)."""

    def __init__(self, outer: Layout, inner: Layout):
        self.outer = outer
        self.inner = inner
        self.shape = outer.shape

    def to_linear(self, *coords):
        # outer maps to a linear index interpreted as inner 1d coordinate
        return self.inner.to_linear(self.outer.to_linear(*coords))


class SliceLayout(Layout):
    """Windowed sub-view (reference slice.rs)."""

    def __init__(self, inner: Layout, starts: Sequence[int],
                 shape: Sequence[int]):
        self.inner = inner
        self.starts = tuple(starts)
        self.shape = tuple(shape)

    def to_linear(self, *coords):
        return self.inner.to_linear(
            *(c + s for c, s in zip(coords, self.starts)))


class TiledLayout(Layout):
    """2D tile-blocked view (reference tiled_view.rs): coordinates are
    (tile_row, tile_col, in_tile_row, in_tile_col)."""

    def __init__(self, inner: Layout, tile: Tuple[int, int]):
        self.inner = inner
        self.tile = tile
        th, tw = tile
        h, w = inner.shape
        self.shape = (h // th, w // tw, th, tw)

    def to_linear(self, tr, tc, r, c):
        th, tw = self.tile
        return self.inner.to_linear(tr * th + r, tc * tw + c)
