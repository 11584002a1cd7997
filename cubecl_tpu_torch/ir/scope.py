"""Scope: the growing instruction list the frontend traces into.

Reference: ``Scope`` cubecl-ir/src/scope.rs:34 with ``GlobalStateInner``
(scope.rs:49) holding the allocator, registered buffers/scalars, shared
memory declarations and validation errors. Child scopes are created for
structured control-flow bodies (scope.rs:269).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set

from .ops import Instruction, Operation
from .types import Type
from .value import Builtin, Value, VarKind, builtin_value, const_value


@dataclass
class SharedDecl:
    value: Value
    shape: tuple          # element shape (lines, line) flattened at decl
    ty: Type


@dataclass
class BufferParam:
    """A kernel buffer parameter. Its extent (``length``, in lines) is
    static per compilation, as in the JAX package; the CUDA printer still
    passes every buffer length as a kernel argument. A buffer may also
    carry a RUNTIME logical length (``dyn_len``, an i32 scalar param, in
    lines), the reference's runtime metadata ABI
    (cubecl-core/src/codegen/metadata.rs:1-40)."""

    value: Value
    name: str
    ty: Type              # element type + line size
    length: int           # number of *lines* (physical capacity)
    mutable: bool = False
    # optional nd metadata for Tensor params
    shape: Optional[tuple] = None
    strides: Optional[tuple] = None
    # runtime logical length (lines): the Value of an i32 scalar param
    dyn_len: Optional[Value] = None


@dataclass
class ScalarParam:
    value: Value
    name: str
    ty: Type


class GlobalState:
    """Shared across the whole scope tree (reference GlobalStateInner)."""

    def __init__(self) -> None:
        self.next_vid = 0
        self.buffers: List[BufferParam] = []
        # vids of buffers that share memory with another buffer of the
        # launch (one tensor passed twice)
        self.aliased: Set[int] = set()
        self.scalars: List[ScalarParam] = []
        self.shareds: List[SharedDecl] = []
        self.matrices: List[Value] = []
        self.errors: List[str] = []
        self.cube_dim: tuple = (1, 1, 1)
        self.plane_dim: int = 32
        self.fast_math: Dict[str, Any] = {}
        self.debug_symbols: bool = False

    def alloc_vid(self) -> int:
        vid = self.next_vid
        self.next_vid += 1
        return vid


def _user_source_loc():
    """First stack frame outside cubecl_tpu_torch = the user's kernel
    line."""
    import sys

    f = sys._getframe(2)
    pkg_root = __file__.rsplit("/", 2)[0]  # .../cubecl_tpu_torch
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(pkg_root):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return None


class Scope:
    """An ordered list of instructions plus typed local allocation."""

    def __init__(self, state: Optional[GlobalState] = None, parent: Optional["Scope"] = None):
        self.state = state or GlobalState()
        self.parent = parent
        self.instructions: List[Instruction] = []
        self.depth = 0 if parent is None else parent.depth + 1

    # -- allocation ---------------------------------------------------------

    def create_local(self, ty: Type, name: Optional[str] = None) -> Value:
        return Value(self.state.alloc_vid(), ty, VarKind.LOCAL, name=name)

    def create_local_mut(self, ty: Type, name: Optional[str] = None) -> Value:
        """Mutable local (reference create_local_mut, scope.rs:172) — loop
        carries and accumulators."""
        return Value(self.state.alloc_vid(), ty, VarKind.LOCAL_MUT, name=name)

    def create_shared(self, ty: Type, shape: tuple, name: Optional[str] = None) -> Value:
        """Shared memory (reference create_shared, scope.rs:188)."""
        v = Value(self.state.alloc_vid(), ty, VarKind.SHARED, shape=tuple(shape), name=name)
        self.state.shareds.append(SharedDecl(v, tuple(shape), ty))
        return v

    def create_matrix(self, ty: Type, shape: tuple, ident: str, layout: str = "row_major") -> Value:
        v = Value(self.state.alloc_vid(), ty, VarKind.MATRIX, shape=tuple(shape),
                  payload={"ident": ident, "layout": layout})
        self.state.matrices.append(v)
        return v

    def add_buffer(self, name: str, ty: Type, length: int, mutable: bool,
                   shape: Optional[tuple] = None, strides: Optional[tuple] = None,
                   dyn_len: Optional[Value] = None) -> Value:
        v = Value(self.state.alloc_vid(), ty, VarKind.BUFFER, payload=name,
                  shape=(length,), name=name)
        self.state.buffers.append(
            BufferParam(v, name, ty, length, mutable, shape, strides,
                        dyn_len))
        return v

    def add_scalar(self, name: str, ty: Type) -> Value:
        v = Value(self.state.alloc_vid(), ty, VarKind.SCALAR, payload=name, name=name)
        self.state.scalars.append(ScalarParam(v, name, ty))
        return v

    # -- registration -------------------------------------------------------

    def register(self, out: Optional[Value], op: Operation,
                 modes: Optional[dict] = None, loc: Optional[str] = None) -> Optional[Value]:
        """Append an instruction (reference register, scope.rs:217).

        With ``debug_symbols`` on, the user-code source location is
        captured from the trace stack (reference: the C++ printers' #line
        directives from Instruction.source_loc)."""
        if loc is None and self.state.debug_symbols:
            loc = _user_source_loc()
        self.instructions.append(
            Instruction(out, op, modes or dict(self.state.fast_math), loc))
        return out

    def child(self) -> "Scope":
        return Scope(self.state, parent=self)

    def error(self, msg: str) -> None:
        self.state.errors.append(msg)

    # -- convenience --------------------------------------------------------

    def const(self, v: Any, ty: Type) -> Value:
        return const_value(v, ty)

    def builtin(self, b: Builtin) -> Value:
        return builtin_value(b)

    def __repr__(self) -> str:
        pad = "  " * self.depth
        lines = []
        for inst in self.instructions:
            lines.append(pad + repr(inst))
            for key in ("then", "orelse", "body", "cond_scope"):
                sub = inst.op.attrs.get(key)
                if isinstance(sub, Scope):
                    lines.append(pad + f" {key}:")
                    lines.append(repr(sub))
            for case, sub in inst.op.attrs.get("cases", []):
                lines.append(pad + f" case {case}:")
                lines.append(repr(sub))
        return "\n".join(lines)


def walk(scope: Scope):
    """Yield (scope, instruction) over the whole tree, pre-order."""
    for inst in scope.instructions:
        yield scope, inst
        for key in ("then", "orelse", "body", "cond_scope", "default"):
            sub = inst.op.attrs.get(key)
            if isinstance(sub, Scope):
                yield from walk(sub)
        for _case, sub in inst.op.attrs.get("cases", []):
            if isinstance(sub, Scope):
                yield from walk(sub)
