"""Buffer containers: Slice, MutSlice, Array, SharedMemory.

Reference: slices as kernel buffers (cubecl-core/src/frontend/container/
slice/base.rs, launch.rs ``BufferArg::from_raw_parts``), ``Array<E>``
(array/base.rs:13) and ``Shared<E>`` (shared_memory.rs:22).

As in the JAX package, buffer lengths are **static per compilation** (they
are part of the kernel id), so ``.len()`` returns a comptime Python int
instead of the reference's runtime metadata read (codegen/metadata.rs).
Shared memory and per-unit arrays trace as in the JAX package; the CUDA
printer does not lower them yet.
"""

from __future__ import annotations

from typing import Any

from ..ir import ops as O
from ..ir.ops import Operation
from ..ir.types import ElemType, Type
from ..ir.value import Value, VarKind
from .element import CubeVal, active_builder, as_value, emit, is_comptime


class Slice:
    """Read-only view over a kernel buffer of lines.

    ``buf[i]`` loads line ``i`` (a CubeVal with the buffer's line size);
    ``buf.len()`` is the comptime number of lines.
    """

    _mutable = False

    def __init__(self, value: Value, length: int, line_size: int,
                 offset: Any = 0, dyn_len: Any = None):
        assert value.kind in (VarKind.BUFFER, VarKind.SHARED)
        self.value = value
        self._length = length
        self._line = line_size
        self._offset = offset  # comptime int or CubeVal, in lines
        # runtime logical length in lines (CubeVal over an i32 scalar) —
        # set for shape-polymorphic buffers (ArrayArg(dynamic=True));
        # ``_length`` is then the physical capacity
        self._dyn_len = dyn_len

    # -- metadata -------------------------------------------------------------
    def len(self):
        """Number of lines. Comptime int for static buffers; a runtime
        CubeVal (the logical length scalar) for dynamic buffers — the
        reference's runtime ``metadata.rs`` buffer_len read."""
        return self._dyn_len if self._dyn_len is not None else self._length

    def __len__(self) -> int:
        if self._dyn_len is not None:
            raise TypeError(
                "dynamic buffer length is a runtime value; use .len() "
                "(capacity is .buffer_len())")
        return self._length

    @property
    def line_size(self) -> int:
        return self._line

    @property
    def ty(self) -> Type:
        return Type(self.value.ty.elem, self._line)

    def buffer_len(self) -> int:
        return self._length

    # -- access ---------------------------------------------------------------
    def _index(self, idx):
        if isinstance(idx, slice):
            return self.slice(idx.start or 0,
                              self._length if idx.stop is None else idx.stop)
        if is_comptime(self._offset) and self._offset == 0:
            return idx
        return idx + self._offset

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self._index(idx)
        idx = self._index(idx)
        # wrap python-int indices explicitly: emit's out_ty (the BUFFER
        # type) must not leak into the index constant (an f32-typed index
        # breaks affine analysis)
        return emit(O.INDEX, self.value, as_value(idx), out_ty=self.ty)

    def read_masked(self, idx, mask, fallback=None):
        """Masked read (reference io.rs read_masked): out-of-bounds lanes
        yield ``fallback`` (zero by default)."""
        idx = self._index(idx)
        v = emit(O.INDEX_MASKED, self.value, as_value(idx), mask,
                 out_ty=self.ty)
        if fallback is not None:
            return emit(O.SELECT, mask, v, fallback, out_ty=self.ty)
        return v

    def __setitem__(self, idx, v):
        raise TypeError(
            "buffer is read-only; declare the parameter as MutSlice/MutTensor "
            "or pass it as a mutable arg")

    def slice(self, start, end) -> "Slice":
        """Sub-view (reference mem.slice). Comptime bounds keep the static
        length exact; traced starts keep length = end - start if comptime."""
        if not (is_comptime(start) and is_comptime(end)):
            raise TypeError("slice bounds must be comptime (static "
                            "shapes); use index arithmetic instead")
        cls = type(self)
        return cls(self.value, end - start, self._line,
                   offset=self._offset + start)

    # -- cube-cooperative block reductions (a JAX-package extension) ---------
    # The cube-scope analogue of VectorSum (cubecl-ir arithmetic.rs): reduce
    # `lines` whole lines starting at a cube-uniform line index in ONE block
    # op. Traced as in the JAX package; not lowered by the CUDA printer yet.

    def _block_reduce(self, kind: str, start, lines: int) -> CubeVal:
        if not isinstance(lines, int) or lines <= 0:
            raise TypeError("block reduce line count must be a positive "
                            "comptime int (static shapes)")
        idx = self._index(start)
        return emit(O.BLOCK_REDUCE, self.value, as_value(idx),
                    out_ty=Type(self.value.ty.elem, 1),
                    attrs={"kind": kind, "lines": lines})

    def block_sum(self, start, lines: int) -> CubeVal:
        """sum of buffer lines [start, start+lines) — cube-uniform scalar."""
        return self._block_reduce("sum", start, lines)

    def block_max(self, start, lines: int) -> CubeVal:
        return self._block_reduce("max", start, lines)

    def block_min(self, start, lines: int) -> CubeVal:
        return self._block_reduce("min", start, lines)

    def block_prod(self, start, lines: int) -> CubeVal:
        return self._block_reduce("prod", start, lines)

    def with_line_size(self, line: int):
        """Reinterpret the buffer with a different line width (reference
        slice reinterpretation). Total element count is preserved."""
        if not is_comptime(self._offset):
            raise TypeError("cannot re-line a traced-offset slice")
        total = self._length * self._line
        off = self._offset * self._line
        assert total % line == 0 and off % line == 0
        cls = type(self)
        return cls(self.value, total // line, line, offset=off // line)


class MutSlice(Slice):
    """Read-write buffer view (reference &mut [T])."""

    _mutable = True

    def __setitem__(self, idx, v):
        idx = self._index(idx)
        b = active_builder()
        val = as_value(v, self.ty)
        b.scope.register(None, Operation(
            O.STORE, (self.value, as_value(idx), val)))

    def write_masked(self, idx, v, mask):
        idx = self._index(idx)
        b = active_builder()
        b.scope.register(None, Operation(
            O.STORE_MASKED,
            (self.value, as_value(idx), as_value(v, self.ty), as_value(mask))))


class SharedMemory(MutSlice):
    """Shared memory (reference Shared::new_slice, shared_memory.rs:22)."""

    def __init__(self, elem: ElemType, length: int, line_size: int = 1):
        b = active_builder()
        ty = Type(elem, line_size)
        v = b.scope.create_shared(ty, (length,))
        super().__init__(v, length, line_size)

    @staticmethod
    def new(elem: ElemType, length: int, line_size: int = 1) -> "SharedMemory":
        return SharedMemory(elem, length, line_size)


class Array(MutSlice):
    """Per-unit local array (reference Array<E>, array/base.rs:13), traced
    as a per-unit shared declaration."""

    def __init__(self, elem: ElemType, length: int, line_size: int = 1):
        b = active_builder()
        ty = Type(elem, line_size)
        v = b.scope.create_shared(ty, (length,))  # lowered like scratch
        v.payload = {"per_unit": True}
        super().__init__(v, length, line_size)

    @staticmethod
    def new(elem: ElemType, length: int, line_size: int = 1) -> "Array":
        return Array(elem, length, line_size)
