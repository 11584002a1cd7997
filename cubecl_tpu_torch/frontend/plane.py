"""Plane (warp/subgroup) operations.

Reference: cubecl-core/src/frontend/plane.rs over the IR plane ops
(cubecl-ir/src/plane.rs:16-41). On CUDA a plane is a warp (``PLANE_DIM``
= 32), or the whole cube when it has fewer than 32 units; the printer
lowers plane ops to ``__shfl_*_sync`` / ``__reduce_*_sync``.
"""

from __future__ import annotations

from ..ir import ops as O
from ..ir.types import Type, bool_, u32
from .element import CubeVal, emit


def _red(opcode):
    def f(x: CubeVal) -> CubeVal:
        return emit(opcode, x, out_ty=x.ty)

    return f


plane_sum = _red(O.PLANE_SUM)
plane_prod = _red(O.PLANE_PROD)
plane_max = _red(O.PLANE_MAX)
plane_min = _red(O.PLANE_MIN)
plane_inclusive_sum = _red(O.PLANE_INCLUSIVE_SUM)
plane_exclusive_sum = _red(O.PLANE_EXCLUSIVE_SUM)
plane_inclusive_prod = _red(O.PLANE_INCLUSIVE_PROD)
plane_exclusive_prod = _red(O.PLANE_EXCLUSIVE_PROD)


def plane_all(x: CubeVal) -> CubeVal:
    return emit(O.PLANE_ALL, x, out_ty=Type(bool_, x.ty.line))


def plane_any(x: CubeVal) -> CubeVal:
    return emit(O.PLANE_ANY, x, out_ty=Type(bool_, x.ty.line))


def plane_elect() -> CubeVal:
    """True exactly on the first active unit of the plane."""
    return emit(O.PLANE_ELECT, out_ty=Type(bool_))


def plane_ballot(x: CubeVal) -> CubeVal:
    """Bitmask of the predicate across the plane (packed into u32)."""
    return emit(O.PLANE_BALLOT, x, out_ty=Type(u32))


def _lane_arg(lane):
    """Lane/offset operands are index-typed (not the data type)."""
    from ..ir.types import Type, index_ty
    from .element import as_value

    return as_value(lane, Type(index_ty))


def plane_broadcast(x: CubeVal, lane) -> CubeVal:
    return emit(O.PLANE_BROADCAST, x, _lane_arg(lane), out_ty=x.ty)


def plane_shuffle(x: CubeVal, src) -> CubeVal:
    return emit(O.PLANE_SHUFFLE, x, _lane_arg(src), out_ty=x.ty)


def plane_shuffle_xor(x: CubeVal, mask) -> CubeVal:
    return emit(O.PLANE_SHUFFLE_XOR, x, _lane_arg(mask), out_ty=x.ty)


def plane_shuffle_up(x: CubeVal, n) -> CubeVal:
    return emit(O.PLANE_SHUFFLE_UP, x, _lane_arg(n), out_ty=x.ty)


def plane_shuffle_down(x: CubeVal, n) -> CubeVal:
    return emit(O.PLANE_SHUFFLE_DOWN, x, _lane_arg(n), out_ty=x.ty)
