"""Free math functions usable inside @cube kernels.

Reference: the Float/Int trait methods and Vector ops
(cubecl-core/src/frontend/element/float.rs, container/vector/ops.rs,
cubecl-ir/src/arithmetic.rs:11-72). Comptime arguments compute natively in
Python (the ``comptime!`` path); traced arguments emit IR.
"""

from __future__ import annotations

import math as _m

from ..ir import ops as O
from ..ir.types import Type
from .element import CubeVal, emit, is_comptime, _promote, _promote_all


def _unary(opcode: str, pyfn):
    def f(x):
        if is_comptime(x):
            return pyfn(x)
        return emit(opcode, x, out_ty=x.ty)

    return f


erf = _unary(O.ERF, _m.erf)
exp = _unary(O.EXP, _m.exp)
exp2 = _unary(O.EXP2, lambda a: 2.0 ** a)
log = _unary(O.LOG, _m.log)
log2 = _unary(O.LOG2, _m.log2)
log1p = _unary(O.LOG1P, _m.log1p)
sqrt = _unary(O.SQRT, _m.sqrt)
rsqrt = _unary(O.RSQRT, lambda a: 1.0 / _m.sqrt(a))
recip = _unary(O.RECIP, lambda a: 1.0 / a)
sin = _unary(O.SIN, _m.sin)
cos = _unary(O.COS, _m.cos)
tan = _unary(O.TAN, _m.tan)
asin = _unary(O.ASIN, _m.asin)
acos = _unary(O.ACOS, _m.acos)
atan = _unary(O.ATAN, _m.atan)
sinh = _unary(O.SINH, _m.sinh)
cosh = _unary(O.COSH, _m.cosh)
tanh = _unary(O.TANH, _m.tanh)
floor = _unary(O.FLOOR, _m.floor)
ceil = _unary(O.CEIL, _m.ceil)
round_ = _unary(O.ROUND, lambda a: float(round(a)))
trunc = _unary(O.TRUNC, _m.trunc)
sign = _unary(O.SIGN, lambda a: (a > 0) - (a < 0))
abs_ = _unary(O.ABS, abs)
is_nan = _unary(O.IS_NAN, lambda a: a != a)
is_inf = _unary(O.IS_INF, _m.isinf)
count_ones = _unary(O.POPCOUNT, lambda a: bin(a & 0xFFFFFFFF).count("1"))
leading_zeros = _unary(O.CLZ, None)
find_first_set = _unary(O.FFS, None)
reverse_bits = _unary(O.BITREV, None)


def max_(a, b):
    if is_comptime(a) and is_comptime(b):
        return max(a, b)
    return emit(O.MAX, a, b)


def min_(a, b):
    if is_comptime(a) and is_comptime(b):
        return min(a, b)
    return emit(O.MIN, a, b)


def clamp(x, lo, hi):
    if all(is_comptime(v) for v in (x, lo, hi)):
        return min(max(x, lo), hi)
    return emit(O.CLAMP, x, lo, hi)


def fma(a, b, c):
    """Fused multiply-add (reference Arithmetic::Fma)."""
    if all(is_comptime(v) for v in (a, b, c)):
        return a * b + c
    return emit(O.FMA, a, b, c)


def powf(a, b):
    if is_comptime(a) and is_comptime(b):
        return a ** b
    return emit(O.POW, a, b)


def atan2(a, b):
    if is_comptime(a) and is_comptime(b):
        return _m.atan2(a, b)
    return emit(O.ATAN2, a, b)


def mul_hi(a, b):
    """High half of the widening integer multiply (reference MulHi)."""
    return emit(O.MULHI, a, b)


def saturating_add(a, b):
    return emit(O.SAT_ADD, a, b)


def saturating_sub(a, b):
    return emit(O.SAT_SUB, a, b)


def select(cond, a, b):
    """Elementwise select (reference operator.rs Select)."""
    if is_comptime(cond):
        return a if cond else b
    ty = _promote_all((a, b)) if (is_comptime(a) and is_comptime(b)) is False \
        else None
    if isinstance(a, CubeVal) or isinstance(b, CubeVal):
        ty = _promote(a, b) if isinstance(a, CubeVal) and isinstance(b, CubeVal) \
            else (a.ty if isinstance(a, CubeVal) else b.ty)
    assert ty is not None
    return emit(O.SELECT, cond, a, b,
                out_ty=Type(ty.elem, max(ty.line, cond.ty.line)))


def dot(a, b):
    """Line-wise dot product → scalar (reference Arithmetic::Dot)."""
    ty = _promote(a, b)
    return emit(O.DOT, a, b, out_ty=Type(ty.elem, 1))


def line_sum(a: CubeVal):
    """Horizontal sum of a line (reference VectorSum)."""
    return emit(O.VEC_SUM, a, out_ty=Type(a.ty.elem, 1))


def line_max(a: CubeVal):
    return emit(O.VEC_MAX, a, out_ty=Type(a.ty.elem, 1))


def line_min(a: CubeVal):
    return emit(O.VEC_MIN, a, out_ty=Type(a.ty.elem, 1))


def cast(x, elem):
    if is_comptime(x):
        return float(x) if elem.is_float else int(x)
    return x.cast(elem)


def comment(text: str) -> None:
    """reference comment! macro (cubecl-macros/src/lib.rs:245)."""
    from .element import active_builder
    from ..ir.ops import Operation
    active_builder().scope.register(None, Operation(O.COMMENT, (), {"text": text}))


def debug_print(fmt: str, *args) -> None:
    """In-kernel printf (reference debug_print!,
    cubecl-core/src/frontend/debug.rs:55-98) → pl.debug_print."""
    from .element import active_builder, as_value
    from ..ir.ops import Operation
    active_builder().scope.register(None, Operation(
        O.PRINT, tuple(as_value(a) for a in args), {"fmt": fmt}))


def terminate() -> None:
    """reference terminate! (cubecl-macros/src/lib.rs:266)."""
    from .element import active_builder
    from ..ir.ops import Operation
    active_builder().scope.register(None, Operation(O.TERMINATE))
