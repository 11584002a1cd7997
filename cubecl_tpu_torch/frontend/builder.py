"""CubeBuilder — the trace-time control-flow engine.

The AST transformer (transform.py) rewrites every ``if``/``for``/``while``
in a @cube function into calls on this builder, which decides *at trace
time* whether the construct is comptime (plain Python execution — the
reference's ``comptime!`` semantics, cubecl-macros/src/lib.rs:191) or
runtime (traced into structured IR branches, reference
cubecl-core/src/frontend/branch.rs:40-612).

Variable merging: runtime branches receive ``get``/``set`` closures over
the names assigned in their bodies. Values that change across a branch or
loop body are hoisted into mutable IR locals (reference create_local_mut,
cubecl-ir/src/scope.rs:172) — the structured-IR equivalent of phi nodes;
the CUDA printer declares them as C locals, the torch evaluator as masked
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..ir import ops as O
from ..ir.ops import Operation
from ..ir.scope import Scope
from ..ir.types import Type, bool_, index_ty
from . import element as el
from .element import CubeVal, as_value, emit, is_comptime


class _Unset:
    """Placeholder for names that are not yet bound (the transformer
    initializes every assigned name with this so ``nonlocal`` always
    resolves)."""

    _INSTANCE: Optional["_Unset"] = None

    def __new__(cls):
        if cls._INSTANCE is None:
            cls._INSTANCE = super().__new__(cls)
        return cls._INSTANCE

    def _fail(self, *a, **k):
        raise NameError("cube variable used before assignment")

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __rtruediv__ = __getitem__ = __setitem__ = __call__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = _fail

    def __bool__(self):
        self._fail()

    def __repr__(self):
        return "<unset>"


UNSET = _Unset()


class ComptimeBreak(Exception):
    pass


class ComptimeContinue(Exception):
    pass


class EarlyReturn(Exception):
    def __init__(self, value):
        self.value = value


class CubeRange:
    """A traced loop range (reference RangeLoop, branch.rs:40). Produced by
    ``cube_range`` or by ``range(...)`` with traced bounds."""

    def __init__(self, start, stop, step=1, unroll: bool = False):
        self.start, self.stop, self.step, self.unroll = start, stop, step, unroll

    def is_comptime(self) -> bool:
        return all(is_comptime(x) for x in (self.start, self.stop, self.step))


def cube_range(start, stop=None, step=1, unroll: bool = False) -> CubeRange:
    if stop is None:
        start, stop = 0, start
    return CubeRange(start, stop, step, unroll)


@dataclass
class _Frame:
    kind: str  # "loop_comptime" | "loop_runtime" | "branch" | fn_*
    cond: Any = None          # branch frames: the traced condition
    polarity: bool = True     # then-arm True / else-arm False
    rets: Optional[list] = None  # fn frames: conditional value returns


class CubeBuilder:
    UNSET = UNSET

    def __init__(self, scope: Scope):
        self.scope = scope
        self.frames: list[_Frame] = []

    # ------------------------------------------------------------------ util

    def is_comptime(self, v: Any) -> bool:
        return is_comptime(v)

    def range_(self, *args) -> Any:
        """``range(...)`` inside a cube fn: comptime bounds → plain python
        range (comptime loop); traced bounds → CubeRange."""
        if all(is_comptime(a) for a in args):
            return range(*args)
        a = list(args)
        if len(a) == 1:
            a = [0, a[0], 1]
        elif len(a) == 2:
            a = [a[0], a[1], 1]
        return CubeRange(a[0], a[1], a[2])

    def _runtime_depth(self) -> int:
        return sum(1 for f in self.frames if f.kind in ("branch", "loop_runtime"))

    # ------------------------------------------------------- logical ops

    def and_(self, a_thunk: Callable, b_thunk: Callable):
        a = a_thunk()
        if is_comptime(a):
            return b_thunk() if a else a
        b = b_thunk()  # strict at runtime (no side effects allowed anyway)
        line = max(a.ty.line, b.ty.line if isinstance(b, CubeVal) else 1)
        return emit(O.AND, a, b, out_ty=Type(bool_, line))

    def or_(self, a_thunk: Callable, b_thunk: Callable):
        a = a_thunk()
        if is_comptime(a):
            return a if a else b_thunk()
        b = b_thunk()
        line = max(a.ty.line, b.ty.line if isinstance(b, CubeVal) else 1)
        return emit(O.OR, a, b, out_ty=Type(bool_, line))

    def not_(self, a):
        if is_comptime(a):
            return not a
        if a.ty.elem.is_bool:
            return emit(O.NOT, a, out_ty=a.ty)
        return a == 0

    def assert_(self, cond_thunk: Callable, msg_thunk: Optional[Callable]):
        cond = cond_thunk()
        if is_comptime(cond):
            assert cond, (msg_thunk() if msg_thunk else "cube assert failed")
        # runtime asserts are dropped (like the reference in unchecked mode)

    def push_function(self, entry: bool) -> None:
        """Mark an inline cube-function call boundary (returns are resolved
        relative to the innermost function, since calls are inlined)."""
        self.frames.append(_Frame("fn_entry" if entry else "fn_inline",
                                  rets=[]))

    def pop_function(self) -> "_Frame":
        f = self.frames.pop()
        assert f.kind in ("fn_entry", "fn_inline")
        return f

    def combine_returns(self, frame: "_Frame", result):
        """Fold conditional value-returns into the fall-through result:
        earlier returns win (select chain in reverse order)."""
        rets = frame.rets or []
        if not rets:
            return result
        if result is None:
            # every path returned inside a branch: the last return is the
            # base (lanes outside every condition are unspecified in the
            # source too)
            result = rets[-1][1]
            rets = rets[:-1]
        for conj, v in reversed(rets):
            ty = el._promote(v, result)
            result = emit(O.SELECT, conj, v, result,
                          out_ty=Type(ty.elem, ty.line))
        return result

    def ret(self, value=None):
        """Handle a ``return`` statement (see transform.py)."""
        runtime = 0
        entry = True
        for f in reversed(self.frames):
            if f.kind in ("fn_entry", "fn_inline"):
                entry = f.kind == "fn_entry"
                break
            if f.kind in ("branch", "loop_runtime"):
                runtime += 1
        if runtime == 0:
            raise EarlyReturn(value)
        if value is not None:
            if entry:
                raise TypeError(
                    "returning a value from runtime control flow at kernel "
                    "top level is not supported; restructure with a "
                    "mutable local")
            # inlined helper: record (condition conjunction, value); the
            # call site folds them into a select chain. NOTE: this is
            # trace-time reconstruction — values are exact (both branch
            # arms are computed under predication), but buffer STORES
            # after a taken return still execute; keep conditionally-
            # returning helpers pure.
            conj = None
            for f in reversed(self.frames):
                if f.kind in ("fn_entry", "fn_inline"):
                    frame = f
                    break
                if f.kind == "loop_runtime":
                    raise TypeError(
                        "returning a value from inside a traced loop is "
                        "not supported; restructure with a mutable local")
                if f.kind == "branch" and f.cond is not None:
                    term = f.cond if f.polarity else emit(
                        O.NOT, f.cond, out_ty=f.cond.ty)
                    conj = term if conj is None else emit(
                        O.AND, conj, term, out_ty=term.ty)
            frame.rets.append((conj, value))
            return None
        if not entry:
            raise TypeError(
                "early return from runtime control flow inside an inlined "
                "cube function is not supported"
            )
        self.scope.register(None, Operation(O.RETURN))
        return None

    def ifexp(self, cond, then_thunk: Callable, else_thunk: Callable):
        """Ternary ``a if c else b``: comptime cond picks a side; runtime
        cond evaluates both and emits a SELECT (reference
        inlined_if_to_select pass done eagerly)."""
        if is_comptime(cond):
            return then_thunk() if cond else else_thunk()
        a = then_thunk()
        b = else_thunk()
        ty = el._promote(a, b) if isinstance(a, CubeVal) or isinstance(b, CubeVal) \
            else None
        if ty is None:
            raise TypeError("runtime select requires at least one traced arm")
        return emit(O.SELECT, cond, a, b, out_ty=Type(ty.elem, max(
            ty.line, cond.ty.line)))

    def _loop_exit(self, exc_cls, opcode):
        crossed_runtime_branch = False
        for f in reversed(self.frames):
            if f.kind == "branch":
                crossed_runtime_branch = True
            elif f.kind == "loop_comptime":
                if crossed_runtime_branch:
                    raise TypeError(
                        "cannot break/continue a comptime loop from inside a "
                        "runtime branch; use a traced loop (cube_range)")
                raise exc_cls()
            elif f.kind == "loop_runtime":
                self.scope.register(None, Operation(opcode))
                return
        raise SyntaxError("break/continue outside loop")

    def break_(self):
        self._loop_exit(ComptimeBreak, O.BREAK)

    def continue_(self):
        self._loop_exit(ComptimeContinue, O.CONTINUE)

    # ----------------------------------------------------------- if / else

    def if_else(self, cond, then_fn: Callable, else_fn: Optional[Callable],
                get: Callable[[], tuple], set_: Callable[[tuple], None]):
        if is_comptime(cond):
            self.frames.append(_Frame("branch_comptime"))
            try:
                if cond:
                    then_fn()
                elif else_fn is not None:
                    else_fn()
            finally:
                self.frames.pop()
            return

        if cond.ty.line != 1:
            raise TypeError("branch condition must be a scalar bool")
        parent = self.scope
        pre = get()

        then_scope, then_vals = self._trace_branch(parent, then_fn, get,
                                                   set_, pre, cond, True)
        else_scope, else_vals = (None, pre)
        if else_fn is not None:
            else_scope, else_vals = self._trace_branch(parent, else_fn, get,
                                                       set_, pre, cond,
                                                       False)

        merged = self._merge_branches(parent, pre, [
            (then_scope, then_vals),
            (else_scope if else_scope is not None else parent, else_vals),
        ])
        attrs = {"then": then_scope}
        opcode = O.IF
        if else_scope is not None:
            attrs["orelse"] = else_scope
            opcode = O.IF_ELSE
        parent.register(None, Operation(opcode, (as_value(cond),), attrs))
        set_(tuple(merged))

    def _trace_branch(self, parent: Scope, fn: Callable, get, set_, pre,
                      cond=None, polarity=True):
        child = parent.child()
        self.scope = child
        self.frames.append(_Frame("branch", cond=cond, polarity=polarity))
        try:
            fn()
        finally:
            self.frames.pop()
            self.scope = parent
        vals = get()
        set_(pre)
        return child, vals

    def _merge_branches(self, parent: Scope, pre: tuple, branches) -> list:
        """Hoist diverging bindings into mutable locals written by each
        branch scope (structured phi)."""
        n = len(pre)
        merged = list(pre)
        for i in range(n):
            vals = [vs[i] for (_s, vs) in branches]
            if all(v is pre[i] for v in vals):
                continue
            # comptime values that diverge across runtime branches get
            # promoted to traced selects (mut local written by each side);
            # slots only assigned in one branch (UNSET elsewhere) keep the
            # assigned value — reading it on the untaken path is undefined,
            # like an uninitialized GPU register
            known = [v for v in vals if not isinstance(v, _Unset)]
            traced = [v for v in known if isinstance(v, CubeVal)]
            if not traced:
                if known and all(_ct_eq(v, known[0]) for v in known):
                    merged[i] = known[0]
                    continue
                if not all(isinstance(v, (int, float, bool)) for v in known):
                    raise TypeError(
                        "non-numeric comptime value diverges across a runtime "
                        "branch; branch at comptime instead")
            ty = traced[0].ty if traced else _number_ty(known[0])
            m = parent.create_local_mut(ty)
            init = pre[i]
            if isinstance(init, CubeVal) or isinstance(init, (int, float, bool)):
                parent.register(m, Operation(O.COPY, (as_value(init, ty),)))
            for (sc, vs) in branches:
                v = vs[i]
                if v is pre[i] and sc is parent:
                    continue  # implicit else keeps the init value
                target = sc if sc is not parent else parent
                if isinstance(v, _Unset):
                    continue
                target.register(m, Operation(O.COPY, (as_value(v, ty),)))
            merged[i] = CubeVal(m)
        return merged

    # ---------------------------------------------------------------- loops

    def for_loop(self, iterable, body_fn: Callable, get, set_):
        if isinstance(iterable, CubeRange) and not iterable.unroll:
            return self._traced_for(iterable, body_fn, get, set_)
        if isinstance(iterable, CubeRange):  # unroll requested
            if not iterable.is_comptime():
                raise TypeError("#[unroll] loop requires comptime bounds")
            iterable = range(iterable.start, iterable.stop, iterable.step)
        # comptime loop: plain python iteration (reference #[unroll] /
        # comptime iteration over Sequence)
        self.frames.append(_Frame("loop_comptime"))
        try:
            for item in iterable:
                try:
                    body_fn(item)
                except ComptimeContinue:
                    continue
        except ComptimeBreak:
            pass
        finally:
            self.frames.pop()

    def _discover_carries(self, parent: Scope, trace_fn: Callable, get, set_, pre):
        """Discovery pass: trace the body into a throwaway scope to learn
        which bindings change (and their types). Runs user code an extra
        time at trace time — comptime side effects should be idempotent."""
        scratch = parent.child()
        self.scope = scratch
        self.frames.append(_Frame("loop_runtime"))
        try:
            trace_fn()
        finally:
            self.frames.pop()
            self.scope = parent
        post = get()
        set_(pre)
        carries = []
        for i, (a, b) in enumerate(zip(pre, post)):
            if a is b:
                continue
            if not isinstance(b, CubeVal):
                if isinstance(a, CubeVal):
                    raise TypeError(
                        "a traced value was overwritten with a comptime value "
                        "inside a runtime loop")
                if _ct_eq(a, b):
                    continue
                # a comptime number that changes per iteration: promote it to
                # a traced mutable local (the reference's `let mut` semantics)
                if isinstance(b, (int, float, bool)):
                    carries.append((i, _number_ty(a if not isinstance(
                        a, _Unset) else b)))
                    continue
                raise TypeError(
                    "comptime value changes across runtime loop iterations; "
                    "use a comptime loop (python range) or a traced value")
            ty = b.ty
            if isinstance(a, CubeVal) and a.ty != ty:
                ty = el._promote(a, b)
            carries.append((i, ty))
        return carries

    def _setup_carries(self, parent: Scope, carries, pre, set_):
        bindings = list(pre)
        mvars = {}
        for i, ty in carries:
            m = parent.create_local_mut(ty)
            init = pre[i]
            if not isinstance(init, _Unset):
                parent.register(m, Operation(O.COPY, (as_value(init, ty),)))
            else:
                parent.register(m, Operation(O.COPY, (as_value(0, ty),)))
            bindings[i] = CubeVal(m)
            mvars[i] = m
        set_(tuple(bindings))
        return bindings, mvars

    def _finish_carries(self, body: Scope, mvars, get, set_, bindings):
        post = get()
        for i, m in mvars.items():
            v = post[i]
            # carry_writeback: a backend masks this by the loop's
            # alive-at-iteration-start, so a mid-iteration break keeps the
            # breaking iteration's earlier updates
            body.register(m, Operation(O.COPY, (as_value(v, m.ty),),
                                       {"carry_writeback": True}))
        set_(tuple(bindings))

    def _traced_for(self, rng: CubeRange, body_fn, get, set_):
        parent = self.scope
        pre = get()
        var_probe = parent.create_local(Type(index_ty), name="i")
        carries = self._discover_carries(
            parent, lambda: body_fn(CubeVal(var_probe)), get, set_, pre)
        bindings, mvars = self._setup_carries(parent, carries, pre, set_)

        var = parent.create_local(Type(index_ty), name="i")
        body = parent.child()
        self.scope = body
        self.frames.append(_Frame("loop_runtime"))
        try:
            body_fn(CubeVal(var))
        finally:
            self.frames.pop()
            self.scope = parent
        self._finish_carries(body, mvars, get, set_, bindings)
        parent.register(None, Operation(
            O.RANGE_LOOP,
            (as_value(rng.start, Type(index_ty)),
             as_value(rng.stop, Type(index_ty)),
             as_value(rng.step, Type(index_ty))),
            {"var": var, "body": body, "unroll": rng.unroll},
        ))

    def while_loop(self, cond_fn: Callable, body_fn: Callable, get, set_):
        # comptime while: run natively as long as cond stays comptime
        first = cond_fn()
        if is_comptime(first):
            self.frames.append(_Frame("loop_comptime"))
            try:
                cond = first
                while cond:
                    try:
                        body_fn()
                    except ComptimeContinue:
                        pass
                    cond = cond_fn()
                    if not is_comptime(cond):
                        raise TypeError("while condition changed from comptime "
                                        "to traced mid-loop")
            except ComptimeBreak:
                pass
            finally:
                self.frames.pop()
            return

        parent = self.scope
        pre = get()
        carries = self._discover_carries(parent, body_fn, get, set_, pre)
        bindings, mvars = self._setup_carries(parent, carries, pre, set_)

        cond_scope = parent.child()
        self.scope = cond_scope
        cond_val = cond_fn()
        self.scope = parent

        body = parent.child()
        self.scope = body
        self.frames.append(_Frame("loop_runtime"))
        try:
            body_fn()
        finally:
            self.frames.pop()
            self.scope = parent
        self._finish_carries(body, mvars, get, set_, bindings)
        parent.register(None, Operation(
            O.WHILE, (),
            {"cond_scope": cond_scope, "cond_value": as_value(cond_val),
             "body": body},
        ))

    def loop_(self, body_fn: Callable, get, set_):
        """Infinite ``loop`` with breaks (reference loop_expand,
        branch.rs:588). Exposed as ``while True`` in python kernels."""
        parent = self.scope
        pre = get()
        carries = self._discover_carries(parent, body_fn, get, set_, pre)
        bindings, mvars = self._setup_carries(parent, carries, pre, set_)
        body = parent.child()
        self.scope = body
        self.frames.append(_Frame("loop_runtime"))
        try:
            body_fn()
        finally:
            self.frames.pop()
            self.scope = parent
        self._finish_carries(body, mvars, get, set_, bindings)
        parent.register(None, Operation(O.LOOP, (), {"body": body}))


def _number_ty(v) -> Type:
    from ..ir.types import f32

    if isinstance(v, bool):
        return Type(bool_)
    if isinstance(v, float):
        return Type(f32)
    return Type(index_ty)


def _ct_eq(a, b) -> bool:
    try:
        return bool(a == b)
    except Exception:
        return a is b
