"""Tensor container: buffer + comptime shape/stride metadata.

Reference: ``Tensor<T>`` (cubecl-core/src/frontend/container/tensor/
base.rs:15) whose launch arg carries ``vector_size``
(tensor/launch.rs ``TensorArg``). As in the JAX package, shapes/strides
are comptime (part of the kernel id), replacing the reference's runtime
metadata buffer (codegen/metadata.rs:1-40).
"""

from __future__ import annotations

from typing import Tuple

from .array import MutSlice, Slice
from .element import is_comptime


class Tensor(Slice):
    """Read-only nd tensor view over a linear buffer."""

    def __init__(self, value, shape: Tuple[int, ...], strides: Tuple[int, ...],
                 line_size: int, offset=0):
        length = 1
        for s in shape:
            length *= s
        # length in lines along the innermost contiguous dim
        super().__init__(value, max(1, length // line_size), line_size, offset)
        self._shape = tuple(shape)
        self._strides = tuple(strides)

    # -- comptime metadata (reference meta.shape/stride/rank ops) ------------
    def shape(self, dim: int) -> int:
        return self._shape[dim]

    def stride(self, dim: int) -> int:
        return self._strides[dim]

    @property
    def shape_tuple(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def strides_tuple(self) -> Tuple[int, ...]:
        return self._strides

    def rank(self) -> int:
        return len(self._shape)

    def num_elements(self) -> int:
        n = 1
        for s in self._shape:
            n *= s
        return n

    # -- indexing -------------------------------------------------------------
    def _linear(self, idx):
        """nd index tuple -> linear line index. strides are in elements;
        the innermost access is line-granular."""
        if not isinstance(idx, tuple):
            return idx
        assert len(idx) == len(self._shape), \
            f"expected {len(self._shape)} indices, got {len(idx)}"
        lin = None
        for i, s in zip(idx, self._strides):
            term = i * (s // self._line) if s >= self._line else i * s
            lin = term if lin is None else lin + term
        return lin if lin is not None else 0

    def _nd_attrs(self, idx):
        """Per-dimension index values for the ND block planner (innermost
        index is in lines). Only for full-rank tuple indices on row-major
        contiguous tensors."""
        from ..ir.types import Type, index_ty
        from .element import as_value

        from .element import is_comptime as _ct

        if not isinstance(idx, tuple) or len(idx) != len(self._shape):
            return None
        if not (_ct(self._offset) and self._offset == 0):
            return None  # sub-views fall back to linear indexing
        # row-major contiguity check (strides in elements)
        acc = 1
        for s, st in zip(reversed(self._shape), reversed(self._strides)):
            if st != acc:
                return None
            acc *= s
        return {
            "nd": tuple(as_value(i, Type(index_ty)) for i in idx),
            "nd_shape": self._shape,
            "nd_line": self._line,
        }

    def __getitem__(self, idx):
        from ..ir import ops as O
        from .element import active_builder, as_value, emit

        nd = self._nd_attrs(idx)
        lin = self._linear(idx)
        if nd is None or isinstance(lin, slice):
            return super().__getitem__(lin)
        lin = self._index(lin)
        return emit(O.INDEX, self.value, as_value(lin), out_ty=self.ty,
                    attrs=nd)

    def coords_to_linear(self, *idx):
        return self._linear(tuple(idx))


class MutTensor(Tensor, MutSlice):
    _mutable = True

    def __setitem__(self, idx, v):
        from ..ir import ops as O
        from ..ir.ops import Operation
        from .element import active_builder, as_value

        nd = self._nd_attrs(idx)
        lin = self._linear(idx)
        if nd is None:
            MutSlice.__setitem__(self, lin, v)
            return
        lin = self._index(lin)
        b = active_builder()
        b.scope.register(None, Operation(
            O.STORE, (self.value, as_value(lin), as_value(v, self.ty)), nd))

    def write_masked(self, idx, v, mask):
        MutSlice.write_masked(self, self._linear(idx), v, mask)
