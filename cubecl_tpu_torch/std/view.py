"""Views: layout-typed tensor accessors; a copy of ``cubecl_tpu.std.view``
(comptime wrappers over the port's buffers, no kernel).

Reference: ``View``/``ViewMut`` (cubecl-std/src/tensor/view/base.rs:16-40)
— a buffer + Layout pair used inside kernels, plus ``VirtualTensor``
(tensor/virtual.rs:17-311), the dyn-dispatch abstraction fusion consumers
use.
"""

from __future__ import annotations

from typing import Any

from ..frontend.array import MutSlice, Slice
from .layout import Layout


class View:
    """Read view: ``view[c0, c1]`` maps through the layout."""

    def __init__(self, buffer: Slice, layout: Layout):
        self.buffer = buffer
        self.layout = layout

    @property
    def line_size(self) -> int:
        return self.buffer.line_size

    def shape(self, dim: int) -> int:
        return self.layout.shape[dim]

    def __getitem__(self, coords):
        if not isinstance(coords, tuple):
            coords = (coords,)
        return self.buffer[self.layout.to_linear(*coords)]

    def read_checked(self, *coords, fallback=None):
        mask = self.layout.is_in_bounds(*coords)
        if mask is True:
            return self[coords]
        return self.buffer.read_masked(
            self.layout.to_linear(*coords), mask, fallback)


class ViewMut(View):
    def __init__(self, buffer: MutSlice, layout: Layout):
        super().__init__(buffer, layout)

    def __setitem__(self, coords, value):
        if not isinstance(coords, tuple):
            coords = (coords,)
        self.buffer[self.layout.to_linear(*coords)] = value

    def write_checked(self, coords, value):
        if not isinstance(coords, tuple):
            coords = (coords,)
        mask = self.layout.is_in_bounds(*coords)
        if mask is True:
            self[coords] = value
        else:
            self.buffer.write_masked(
                self.layout.to_linear(*coords), value, mask)


class VirtualTensor:
    """Duck-typed read/write tensor handed to fusion consumers (reference
    VirtualTensor): wraps either a View or any object with
    __getitem__/__setitem__/shape."""

    def __init__(self, inner: Any, writable: bool = False):
        self.inner = inner
        self.writable = writable

    def read(self, *coords):
        return self.inner[coords if len(coords) > 1 else coords[0]]

    def write(self, coords, value):
        assert self.writable, "VirtualTensor is read-only"
        self.inner[coords] = value

    def shape(self, dim: int) -> int:
        return self.inner.shape(dim)
