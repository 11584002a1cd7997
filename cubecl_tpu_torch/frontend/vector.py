"""Vector (SIMD line) constructors.

Reference: ``Vector<P: Scalar, N: Size>`` (cubecl-core/src/frontend/
container/vector/base.rs:11). A line value is a ``CubeVal`` whose type has
``line > 1``; this module provides the constructors. On CUDA a line is a
per-thread array ``T v[L]``; in the torch evaluator it is a trailing
tensor axis.
"""

from __future__ import annotations

from ..ir import ops as O
from ..ir.types import ElemType, Type
from .element import CubeVal, emit, is_comptime


class Vector:
    """Namespace of line constructors, mirroring the reference's
    ``Vector::new`` / broadcast semantics."""

    @staticmethod
    def splat(x, line: int, elem: ElemType = None) -> CubeVal:
        """Broadcast a scalar to a line (Vector::new)."""
        if is_comptime(x):
            if elem is None:
                raise TypeError("Vector.splat of a comptime scalar needs an "
                                "explicit element type")
            ty = Type(elem, line)
            return emit(O.VEC_SPLAT, x, out_ty=ty)
        return emit(O.VEC_SPLAT, x, out_ty=Type(x.ty.elem, line))

    new = splat

    @staticmethod
    def from_scalars(*xs) -> CubeVal:
        """Build a line from individual scalars (vector ctor op)."""
        traced = [x for x in xs if isinstance(x, CubeVal)]
        if not traced:
            raise TypeError("Vector.from_scalars needs at least one traced value")
        elem = traced[0].ty.elem
        return emit(O.VEC_INIT, *xs, out_ty=Type(elem, len(xs)))

    @staticmethod
    def zeros(elem: ElemType, line: int) -> CubeVal:
        return Vector.splat(0.0 if elem.is_float else 0, line, elem)

    @staticmethod
    def ones(elem: ElemType, line: int) -> CubeVal:
        return Vector.splat(1.0 if elem.is_float else 1, line, elem)
