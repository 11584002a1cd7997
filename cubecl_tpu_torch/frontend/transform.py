"""AST transformation for @cube functions.

The Python analogue of the reference ``#[cube]`` proc-macro
(cubecl-macros/src/lib.rs:55-127, parse/desugar.rs:11-122): rewrites the
supported statement subset so that control flow over *traced* values is
routed through the ``CubeBuilder`` while comptime control flow stays plain
Python. Rewrites:

- ``if c: A else: B``   → nested defs + ``__cube_builder__.if_else``
- ``for t in it: A``    → body def + ``__cube_builder__.for_loop``
- ``while c: A``        → cond/body defs + ``while_loop`` (``while True`` →
                          ``loop_``, the reference's ``loop`` construct)
- ``a and b`` / ``or``  → short-circuit thunks (``and_``/``or_``)
- ``not a``             → ``not_``
- ``a < b < c``         → chain split into ``and_`` of pairs
- ``return`` / ``break`` / ``continue`` / ``assert`` → builder calls
- ``range(...)``        → ``__cube_builder__.range_`` (traced bounds allowed)

Every name assigned anywhere in the function is pre-initialized to
``UNSET`` so the generated nested defs can declare ``nonlocal`` (the merge
protocol needs write access to enclosing bindings).
"""

from __future__ import annotations

import ast
import inspect
import itertools
import textwrap
from typing import Callable, List, Set

_BUILDER = "__cube_builder__"


class _AssignedNames(ast.NodeVisitor):
    """Names assigned in a statement list, not descending into nested
    function/class scopes."""

    def __init__(self) -> None:
        self.names: Set[str] = set()

    def _target(self, t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            self.names.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._target(e)
        elif isinstance(t, ast.Starred):
            self._target(t.value)
        # Subscript/Attribute targets mutate containers, not bindings

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._target(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._target(node.target)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        self._target(node.target)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            if item.optional_vars is not None:
                self._target(item.optional_vars)
        self.generic_visit(node)

    def visit_NamedExpr(self, node: ast.NamedExpr) -> None:
        self._target(node.target)
        self.generic_visit(node)

    def visit_MatchAs(self, node) -> None:
        if node.name:  # match captures bind names
            self.names.add(node.name)
        self.generic_visit(node)

    def visit_MatchStar(self, node) -> None:
        if node.name:
            self.names.add(node.name)
        self.generic_visit(node)

    def visit_MatchMapping(self, node) -> None:
        if node.rest:
            self.names.add(node.rest)
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.names.add(node.name)  # the def binds its name

    def visit_AsyncFunctionDef(self, node) -> None:
        self.names.add(node.name)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.names.add(node.name)

    # comprehension targets are function-scoped in py3 — don't collect
    def visit_ListComp(self, node) -> None:
        pass

    def visit_SetComp(self, node) -> None:
        pass

    def visit_DictComp(self, node) -> None:
        pass

    def visit_GeneratorExp(self, node) -> None:
        pass


def assigned_names(stmts: List[ast.stmt]) -> Set[str]:
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


def _target_names(t: ast.AST) -> Set[str]:
    v = _AssignedNames()
    v._target(t)
    return v.names


def _name(id_: str, ctx=None) -> ast.Name:
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _call(func: ast.expr, args: List[ast.expr]) -> ast.Call:
    return ast.Call(func=func, args=args, keywords=[])


def _builder_attr(attr: str) -> ast.Attribute:
    return ast.Attribute(value=_name(_BUILDER), attr=attr, ctx=ast.Load())


def _thunk(expr: ast.expr) -> ast.Lambda:
    return ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                           kwonlyargs=[], kw_defaults=[], kwarg=None,
                           defaults=[]),
        body=expr,
    )


def _def(name: str, params: List[str], body: List[ast.stmt],
         nonlocals: List[str]) -> ast.FunctionDef:
    stmts: List[ast.stmt] = []
    if nonlocals:
        stmts.append(ast.Nonlocal(names=sorted(nonlocals)))
    stmts.extend(body if body else [])
    if not stmts:
        stmts = [ast.Pass()]
    return ast.FunctionDef(
        name=name,
        args=ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=p) for p in params],
            vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
            defaults=[]),
        body=stmts,
        decorator_list=[],
        returns=None,
    )


def _desugar_loop_exits(stmts: List[ast.stmt]) -> List[ast.stmt]:
    """Rewrite ``if c: ...; continue`` / ``break`` guards so no statement
    follows the exit inside the loop body: the remainder moves into the
    guard's else. This makes loop-carried variable semantics exact under
    the evaluator's end-of-body carry writeback (assignments before the
    exit commit; the rest never executes on exited lanes)."""
    out: List[ast.stmt] = []
    i = 0
    while i < len(stmts):
        s = stmts[i]
        rest = stmts[i + 1:]
        if isinstance(s, ast.If) and not s.orelse and s.body and \
                isinstance(s.body[-1], (ast.Continue, ast.Break)) and rest:
            exit_stmt = s.body[-1]
            body = s.body[:-1] + ([exit_stmt]
                                  if isinstance(exit_stmt, ast.Break) else [])
            if not body:
                body = [ast.Pass()]
            new_if = ast.If(test=s.test, body=body,
                            orelse=_desugar_loop_exits(list(rest)))
            out.append(ast.copy_location(new_if, s))
            return out
        if isinstance(s, ast.Continue) and not rest:
            i += 1
            continue  # trailing continue is a no-op
        out.append(s)
        i += 1
    return out


class CubeTransformer(ast.NodeTransformer):
    def __init__(self) -> None:
        self.counter = itertools.count()

    # ------------------------------------------------------------ helpers

    def _n(self) -> int:
        return next(self.counter)

    def _getset(self, n: int, names: List[str]) -> List[ast.stmt]:
        names = sorted(names)
        get_body: List[ast.stmt] = [ast.Return(
            value=ast.Tuple(elts=[_name(x) for x in names], ctx=ast.Load()))]
        getter = _def(f"__get_{n}", [], get_body, [])
        if names:
            set_body: List[ast.stmt] = [ast.Assign(
                targets=[ast.Tuple(elts=[_name(x, ast.Store()) for x in names],
                                   ctx=ast.Store())],
                value=_name(f"__v_{n}"))]
        else:
            set_body = [ast.Pass()]
        setter = _def(f"__set_{n}", [f"__v_{n}"], set_body, list(names))
        return [getter, setter]

    def _body(self, stmts: List[ast.stmt]) -> List[ast.stmt]:
        out: List[ast.stmt] = []
        for s in stmts:
            r = self.visit(s)
            if isinstance(r, list):
                out.extend(r)
            elif r is not None:
                out.append(r)
        return out

    # ------------------------------------------------------------- stmts

    def visit_FunctionDef(self, node: ast.FunctionDef):
        return node  # nested defs are comptime helpers — leave untouched

    def visit_AsyncFunctionDef(self, node):
        return node

    def visit_Lambda(self, node: ast.Lambda):
        return node

    def visit_If(self, node: ast.If):
        n = self._n()
        names = assigned_names(node.body) | assigned_names(node.orelse)
        then_def = _def(f"__then_{n}", [], self._body(node.body),
                        sorted(names))
        stmts: List[ast.stmt] = [then_def]
        else_arg: ast.expr = ast.Constant(value=None)
        if node.orelse:
            stmts.append(_def(f"__else_{n}", [], self._body(node.orelse),
                              sorted(names)))
            else_arg = _name(f"__else_{n}")
        stmts.extend(self._getset(n, sorted(names)))
        call = _call(_builder_attr("if_else"),
                     [self.visit(node.test), _name(f"__then_{n}"), else_arg,
                      _name(f"__get_{n}"), _name(f"__set_{n}")])
        stmts.append(ast.Expr(value=call))
        return [ast.copy_location(s, node) for s in stmts]

    def visit_For(self, node: ast.For):
        if node.orelse:
            raise SyntaxError("for/else is not supported in @cube functions")
        n = self._n()
        tnames = _target_names(node.target)
        names = sorted(assigned_names(node.body) - tnames)
        body = self._body(_desugar_loop_exits(node.body))
        if isinstance(node.target, ast.Name):
            params = [node.target.id]
        else:
            params = [f"__it_{n}"]
            node.target.ctx = ast.Store()
            body = [ast.Assign(targets=[node.target],
                               value=_name(f"__it_{n}"))] + body
        body_def = _def(f"__body_{n}", params, body, names)
        stmts: List[ast.stmt] = [body_def]
        stmts.extend(self._getset(n, names))
        call = _call(_builder_attr("for_loop"),
                     [self.visit(node.iter), _name(f"__body_{n}"),
                      _name(f"__get_{n}"), _name(f"__set_{n}")])
        stmts.append(ast.Expr(value=call))
        return [ast.copy_location(s, node) for s in stmts]

    def visit_While(self, node: ast.While):
        if node.orelse:
            raise SyntaxError("while/else is not supported in @cube functions")
        n = self._n()
        names = sorted(assigned_names(node.body))
        body_def = _def(f"__body_{n}", [],
                        self._body(_desugar_loop_exits(node.body)), names)
        stmts: List[ast.stmt] = [body_def]
        stmts.extend(self._getset(n, names))
        infinite = isinstance(node.test, ast.Constant) and node.test.value is True
        if infinite:
            call = _call(_builder_attr("loop_"),
                         [_name(f"__body_{n}"), _name(f"__get_{n}"),
                          _name(f"__set_{n}")])
        else:
            cond_def = _def(f"__cond_{n}", [],
                            [ast.Return(value=self.visit(node.test))], [])
            stmts.insert(0, cond_def)
            call = _call(_builder_attr("while_loop"),
                         [_name(f"__cond_{n}"), _name(f"__body_{n}"),
                          _name(f"__get_{n}"), _name(f"__set_{n}")])
        stmts.append(ast.Expr(value=call))
        return [ast.copy_location(s, node) for s in stmts]

    def visit_Return(self, node: ast.Return):
        value = self.visit(node.value) if node.value is not None else \
            ast.Constant(value=None)
        call = _call(_builder_attr("ret"), [value])
        return ast.copy_location(ast.Return(value=call), node)

    def visit_Break(self, node: ast.Break):
        return ast.copy_location(
            ast.Expr(value=_call(_builder_attr("break_"), [])), node)

    def visit_Continue(self, node: ast.Continue):
        return ast.copy_location(
            ast.Expr(value=_call(_builder_attr("continue_"), [])), node)

    def visit_Assert(self, node: ast.Assert):
        msg = _thunk(self.visit(node.msg)) if node.msg else \
            ast.Constant(value=None)
        call = _call(_builder_attr("assert_"),
                     [_thunk(self.visit(node.test)), msg])
        return ast.copy_location(ast.Expr(value=call), node)

    def visit_Global(self, node: ast.Global):
        raise SyntaxError("global statements are not allowed in @cube functions")

    def visit_Match(self, node):
        # match over literal patterns desugars to an if/elif chain — this
        # works for BOTH traced subjects (predicated execution, the
        # reference's Switch IR, branch.rs Switch) and comptime subjects.
        # Structural patterns (class/sequence/mapping/captures) stay native
        # python match and therefore require a comptime subject (the
        # reference's const_match); a traced subject there fails loudly via
        # CubeVal.__bool__ during pattern matching.
        chain = self._match_to_if_chain(node)
        if chain is not None:
            return self._body(chain)
        node.subject = self.visit(node.subject)
        for case in node.cases:
            case.body = self._body(case.body)
        return node

    def _match_to_if_chain(self, node):
        """Desugar `match` with only value/singleton/or/wildcard patterns
        (plus guards) into `__match_N = subj; if/elif/else`, returning the
        UNtransformed statements, or None if a structural pattern is
        present."""
        subj_name = f"__match_{self._n()}"

        def simple_cond(pat):
            if isinstance(pat, ast.MatchValue):
                return ast.Compare(left=_name(subj_name), ops=[ast.Eq()],
                                   comparators=[pat.value])
            if isinstance(pat, ast.MatchSingleton):
                return ast.Compare(left=_name(subj_name), ops=[ast.Eq()],
                                   comparators=[ast.Constant(pat.value)])
            if isinstance(pat, ast.MatchOr):
                conds = [simple_cond(p) for p in pat.patterns]
                if any(c is None for c in conds):
                    return None
                return ast.BoolOp(op=ast.Or(), values=conds)
            return None

        arms = []
        for case in node.cases:
            pat, body = case.pattern, list(case.body)
            if isinstance(pat, ast.MatchAs) and pat.pattern is None:
                if pat.name:  # `case x:` — bind the subject
                    body.insert(0, ast.Assign(
                        targets=[_name(pat.name, ast.Store())],
                        value=_name(subj_name)))
                cond = None  # irrefutable
            else:
                cond = simple_cond(pat)
                if cond is None:
                    return None
            if case.guard is not None:
                cond = case.guard if cond is None else \
                    ast.BoolOp(op=ast.And(), values=[cond, case.guard])
            arms.append((cond, body))

        tail: List[ast.stmt] = []
        for cond, body in reversed(arms):
            tail = body if cond is None else \
                [ast.If(test=cond, body=body, orelse=tail)]
        stmts = [ast.Assign(targets=[_name(subj_name, ast.Store())],
                            value=node.subject)] + tail
        for s in stmts:
            ast.copy_location(s, node)
            ast.fix_missing_locations(s)
        return stmts

    # ------------------------------------------------------------- exprs

    def visit_BoolOp(self, node: ast.BoolOp):
        op = "and_" if isinstance(node.op, ast.And) else "or_"
        values = [self.visit(v) for v in node.values]
        expr = values[-1]
        for v in reversed(values[:-1]):
            expr = _call(_builder_attr(op), [_thunk(v), _thunk(expr)])
        return ast.copy_location(expr, node)

    def visit_UnaryOp(self, node: ast.UnaryOp):
        if isinstance(node.op, ast.Not):
            return ast.copy_location(
                _call(_builder_attr("not_"), [self.visit(node.operand)]), node)
        return self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        node = self.generic_visit(node)  # type: ignore[assignment]
        if len(node.ops) == 1:
            return node
        # split chain a < b < c → and_(a<b, b<c); comparators re-evaluated
        pairs = []
        left = node.left
        for op, comp in zip(node.ops, node.comparators):
            pairs.append(ast.Compare(left=left, ops=[op], comparators=[comp]))
            left = comp
        expr = pairs[-1]
        for p in reversed(pairs[:-1]):
            expr = _call(_builder_attr("and_"), [_thunk(p), _thunk(expr)])
        return ast.copy_location(expr, node)

    def visit_Call(self, node: ast.Call):
        node = self.generic_visit(node)  # type: ignore[assignment]
        if isinstance(node.func, ast.Name) and node.func.id == "range" \
                and not node.keywords:
            return ast.copy_location(
                _call(_builder_attr("range_"), list(node.args)), node)
        return node

    def visit_IfExp(self, node: ast.IfExp):
        node = self.generic_visit(node)  # type: ignore[assignment]
        call = _call(_builder_attr("ifexp"),
                     [node.test, _thunk(node.body), _thunk(node.orelse)])
        return ast.copy_location(call, node)


def transform_function(fn: Callable) -> Callable:
    """Parse, rewrite and recompile ``fn`` into its expand form. Returns the
    implementation function with signature ``(builder, *original_args)``."""
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError) as e:  # pragma: no cover
        raise RuntimeError(
            f"@cube requires source access for {fn.__qualname__}: {e}"
        ) from None
    src = textwrap.dedent(src)
    tree = ast.parse(src)
    fndef = tree.body[0]
    assert isinstance(fndef, ast.FunctionDef), "@cube expects a plain def"
    fndef.decorator_list = []

    tr = CubeTransformer()
    new_body = tr._body(fndef.body)

    # pre-init every assigned name so nonlocal in nested defs resolves
    params = {a.arg for a in fndef.args.args + fndef.args.posonlyargs
              + fndef.args.kwonlyargs}
    if fndef.args.vararg:
        params.add(fndef.args.vararg.arg)
    if fndef.args.kwarg:
        params.add(fndef.args.kwarg.arg)
    all_names = sorted(assigned_names(fndef.body) - params)
    prelude: List[ast.stmt] = [
        ast.Assign(targets=[_name(x, ast.Store())],
                   value=ast.Attribute(value=_name(_BUILDER), attr="UNSET",
                                       ctx=ast.Load()))
        for x in all_names
    ]
    fndef.body = prelude + new_body
    if not fndef.body:
        fndef.body = [ast.Pass()]
    fndef.args.args.insert(0, ast.arg(arg=_BUILDER))
    fndef.name = f"__cube_impl_{fn.__name__}"
    fndef.returns = None
    for a in fndef.args.args + fndef.args.posonlyargs + fndef.args.kwonlyargs:
        a.annotation = None

    ast.fix_missing_locations(tree)
    filename = f"<cube:{getattr(fn.__code__, 'co_filename', '?')}:" \
               f"{fn.__code__.co_firstlineno}>"
    code = compile(tree, filename, "exec")
    ns = dict(fn.__globals__)
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                ns[name] = cell.cell_contents
            except ValueError:  # unfilled cell (self-reference)
                pass
    exec(code, ns)
    impl = ns[fndef.name]
    impl.__cube_source__ = ast.unparse(tree)
    return impl
