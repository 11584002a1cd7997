"""CubeVal — the traced-value proxy of the frontend.

The analogue of the reference's ``ExpandType`` machinery
(cubecl-core/src/frontend/element/base.rs:29-58): user code operates on
``CubeVal`` objects whose operators append IR instructions to the active
``Scope``. Scalars and SIMD lines (the reference ``Vector<P, N>``,
container/vector/base.rs:11) share this one proxy — a line is a CubeVal
whose type has ``line > 1``; scalar↔line broadcasting is automatic, like
the reference's Vector auto-broadcast.

Comptime values are ordinary Python numbers — they never reach this class
(Python evaluates them natively), which is exactly the reference's
``comptime!`` semantics (host code at expansion time).
"""

from __future__ import annotations

from typing import Any, Optional, Union

from ..ir import ops as O
from ..ir.ops import Operation
from ..ir.types import Type, bool_, f32, index_ty
from ..ir.value import Value, const_value

# Operation imported for manual emission in _compare

# ---------------------------------------------------------------------------
# Trace context
# ---------------------------------------------------------------------------

_ACTIVE: list = []  # stack of CubeBuilder


def push_builder(b) -> None:
    _ACTIVE.append(b)


def pop_builder() -> None:
    _ACTIVE.pop()


def active_builder():
    if not _ACTIVE:
        raise RuntimeError(
            "no active cube trace: cube functions and traced values can only "
            "be used inside a @cube function during compilation/launch"
        )
    return _ACTIVE[-1]


def tracing() -> bool:
    return bool(_ACTIVE)


def scope():
    return active_builder().scope


Number = Union[int, float, bool]


def is_comptime(v: Any) -> bool:
    """Plain Python values are comptime (reference comptime.rs)."""
    return not isinstance(v, CubeVal)


def _const_for(v: Number, ty: Type) -> Value:
    if ty.elem.is_bool:
        v = bool(v)
    elif ty.elem.is_float:
        v = float(v)
    else:
        v = int(v)
    return const_value(v, ty.scalar())


def as_value(v: Any, like_ty: Optional[Type] = None) -> Value:
    """Coerce a python number, CubeVal or raw Value to an IR Value."""
    if isinstance(v, Value):
        return v
    if isinstance(v, CubeVal):
        return v.value
    if isinstance(v, bool):
        return _const_for(v, like_ty or Type(bool_))
    if isinstance(v, int):
        return _const_for(v, like_ty or Type(index_ty))
    if isinstance(v, float):
        return _const_for(v, like_ty or Type(f32))
    raise TypeError(f"cannot use {type(v).__name__} as a cube value")


def _promote(a: Any, b: Any) -> Type:
    """Result type of a binary op. Traced operands win over python numbers;
    wider line wins; float beats int for mixed python-literal cases."""
    ta = a.value.ty if isinstance(a, CubeVal) else None
    tb = b.value.ty if isinstance(b, CubeVal) else None
    if ta is not None and tb is not None:
        if ta.elem != tb.elem:
            # mixed widths promote to the wider type (wide accumulators
            # over narrow data, the reference's cast-then-accumulate)
            if ta.elem.is_int and tb.elem.is_int:
                ty = ta if ta.elem.bits >= tb.elem.bits else tb
            elif ta.elem.is_float and tb.elem.is_float:
                if ta.elem.bits == tb.elem.bits:  # bf16 vs f16
                    ty = Type(f32, ta.line)
                else:
                    ty = ta if ta.elem.bits > tb.elem.bits else tb
            elif ta.elem.is_float and tb.elem.is_int:
                ty = ta
            elif tb.elem.is_float and ta.elem.is_int:
                ty = tb
            else:
                raise TypeError(f"type mismatch in cube op: {ta} vs {tb}")
        else:
            ty = ta
        line = max(ta.line, tb.line)
        if ta.line != tb.line and min(ta.line, tb.line) != 1:
            raise TypeError(f"line size mismatch: {ta} vs {tb}")
        return Type(ty.elem, line)
    t = ta or tb
    assert t is not None
    other = b if ta is not None else a
    if isinstance(other, float) and t.elem.is_int:
        return Type(f32, t.line)
    return t


def _promote_all(operands) -> Type:
    """Fold _promote over the operands (at least one must be traced)."""
    ty: Optional[Type] = None
    for x in operands:
        if isinstance(x, CubeVal):
            ty = x.value.ty if ty is None else _promote(CubeVal(const_value(0, ty)), x)
    if ty is None:
        x0 = operands[0] if operands else 0.0
        return Type(f32) if isinstance(x0, float) else Type(index_ty)
    return ty


def emit(opcode: str, *operands: Any, out_ty: Optional[Type] = None,
         attrs: Optional[dict] = None) -> "CubeVal":
    """Register one instruction in the active scope and return its result."""
    b = active_builder()
    if out_ty is None:
        out_ty = _promote_all(operands)
    vals = tuple(as_value(x, out_ty) for x in operands)
    out = b.scope.create_local(out_ty)
    b.scope.register(out, Operation(opcode, vals, attrs or {}))
    return CubeVal(out)


def emit_void(opcode: str, *operands: Any, attrs: Optional[dict] = None,
              like_ty: Optional[Type] = None) -> None:
    b = active_builder()
    vals = tuple(as_value(x, like_ty) for x in operands)
    b.scope.register(None, Operation(opcode, vals, attrs or {}))


def _binary(opcode: str):
    def fwd(self: "CubeVal", other: Any) -> "CubeVal":
        if is_comptime(other) and not isinstance(other, (int, float, bool)):
            return NotImplemented
        ty = _promote(self, other)
        return emit(opcode, self, other, out_ty=ty)

    return fwd


def _rbinary(opcode: str):
    def rev(self: "CubeVal", other: Any) -> "CubeVal":
        if is_comptime(other) and not isinstance(other, (int, float, bool)):
            return NotImplemented
        ty = _promote(other, self)
        return emit(opcode, other, self, out_ty=ty)

    return rev


def _compare(opcode: str):
    def cmp(self: "CubeVal", other: Any) -> "CubeVal":
        ty = _promote(self, other)
        # coerce operands at the *operand* type, not the bool result type
        a = as_value(self, ty)
        b = as_value(other, ty)
        bld = active_builder()
        out = bld.scope.create_local(Type(bool_, ty.line))
        bld.scope.register(out, Operation(opcode, (a, b)))
        return CubeVal(out)

    return cmp


class CubeVal:
    """A traced scalar or SIMD line value."""

    __slots__ = ("value",)

    def __init__(self, value: Value):
        assert isinstance(value, Value)
        self.value = value

    # -- introspection -------------------------------------------------------
    @property
    def ty(self) -> Type:
        return self.value.ty

    @property
    def line_size(self) -> int:
        return self.value.ty.line

    # -- arithmetic ----------------------------------------------------------
    __add__ = _binary(O.ADD)
    __radd__ = _rbinary(O.ADD)
    __sub__ = _binary(O.SUB)
    __rsub__ = _rbinary(O.SUB)
    __mul__ = _binary(O.MUL)
    __rmul__ = _rbinary(O.MUL)
    __mod__ = _binary(O.MOD)
    __rmod__ = _rbinary(O.MOD)
    __pow__ = _binary(O.POW)
    __rpow__ = _rbinary(O.POW)
    __floordiv__ = _binary(O.FLOORDIV)
    __rfloordiv__ = _rbinary(O.FLOORDIV)
    __lshift__ = _binary(O.SHL)
    __rshift__ = _binary(O.SHR)
    __and__ = _binary(O.BAND)
    __rand__ = _rbinary(O.BAND)
    __or__ = _binary(O.BOR)
    __ror__ = _rbinary(O.BOR)
    __xor__ = _binary(O.BXOR)
    __rxor__ = _rbinary(O.BXOR)

    def __truediv__(self, other):
        ty = _promote(self, other)
        return emit(O.DIV, self, other, out_ty=ty)

    def __rtruediv__(self, other):
        ty = _promote(other, self)
        return emit(O.DIV, other, self, out_ty=ty)

    def __neg__(self):
        return emit(O.NEG, self, out_ty=self.ty)

    def __abs__(self):
        return emit(O.ABS, self, out_ty=self.ty)

    def __invert__(self):
        if self.ty.elem.is_bool:
            return emit(O.NOT, self, out_ty=self.ty)
        return emit(O.BNOT, self, out_ty=self.ty)

    # -- comparisons ---------------------------------------------------------
    __eq__ = _compare(O.EQ)   # type: ignore[assignment]
    __ne__ = _compare(O.NE)   # type: ignore[assignment]
    __lt__ = _compare(O.LT)
    __le__ = _compare(O.LE)
    __gt__ = _compare(O.GT)
    __ge__ = _compare(O.GE)
    __hash__ = None  # type: ignore[assignment]

    def __bool__(self):
        raise TypeError(
            "cannot convert a traced cube value to a python bool; runtime "
            "branching must be inside a @cube function (so the tracer can "
            "rewrite it), and loop bounds must be comptime or cube ranges"
        )

    # -- casts & misc --------------------------------------------------------
    def cast(self, elem) -> "CubeVal":
        to = Type(elem, self.ty.line)
        if to == self.ty:
            return self
        return emit(O.CAST, self, out_ty=to, attrs={"to": to})

    def reinterpret(self, elem) -> "CubeVal":
        to = Type(elem, self.ty.line * self.ty.elem.size // elem.size)
        return emit(O.REINTERPRET, self, out_ty=to, attrs={"to": to})

    def __getitem__(self, i) -> "CubeVal":
        """Extract one lane of a line (Vector indexing, vector/ops.rs)."""
        if self.ty.line == 1:
            raise TypeError("cannot index a scalar cube value")
        bld = active_builder()
        out = bld.scope.create_local(Type(self.ty.elem, 1))
        bld.scope.register(out, Operation(
            O.VEC_EXTRACT, (self.value, as_value(i, Type(index_ty)))))
        return CubeVal(out)

    def with_lane(self, i, v) -> "CubeVal":
        bld = active_builder()
        out = bld.scope.create_local(self.ty)
        bld.scope.register(out, Operation(
            O.VEC_INSERT, (self.value, as_value(i, Type(index_ty)),
                           as_value(v, Type(self.ty.elem, 1)))))
        return CubeVal(out)

    def __repr__(self) -> str:
        return f"CubeVal({self.value!r})"
