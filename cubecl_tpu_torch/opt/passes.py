"""Scope-level optimization passes.

Reference: cubecl-core/src/post_processing/mod.rs:27-44 — ``optimize_scope``
runs const-propagation, const-eval, inline-assign and dead-code
elimination to fixpoint before backend emission. The passes are the JAX
package's, unchanged, so that both packages optimize a traced kernel to the
same scope; on CUDA, nvcc does CSE and the rest after printing.
"""

from __future__ import annotations

from typing import Dict, Set

from ..ir import ops as O
from ..ir.ops import Instruction, OPS
from ..ir.scope import Scope, walk
from ..ir.value import Builtin, Value, VarKind, const_value

_CHILD_KEYS = ("then", "orelse", "body", "cond_scope")


def _children(inst: Instruction):
    for key in _CHILD_KEYS:
        sub = inst.op.attrs.get(key)
        if isinstance(sub, Scope):
            yield sub
    for _c, sub in inst.op.attrs.get("cases", []):
        yield sub


def fold_builtins(scope: Scope, cube_dim, cube_count, plane_dim: int,
                  dynamic_grid: bool = False) -> None:
    """Fold topology builtins that are static per compilation (cube_dim
    and cube_count are part of the kernel id). With a dynamic grid
    (RuntimeCubeCount) the X count is a runtime value, so
    CUBE_COUNT_X/CUBE_COUNT stay symbolic."""
    consts = {
        Builtin.CUBE_DIM_X: cube_dim[0], Builtin.CUBE_DIM_Y: cube_dim[1],
        Builtin.CUBE_DIM_Z: cube_dim[2],
        Builtin.CUBE_DIM: cube_dim[0] * cube_dim[1] * cube_dim[2],
        Builtin.CUBE_COUNT_Y: cube_count[1],
        Builtin.CUBE_COUNT_Z: cube_count[2],
        Builtin.PLANE_DIM: plane_dim,
        Builtin.CUBE_CLUSTER_DIM: 1,
        Builtin.CUBE_CLUSTER_POS: 0,
    }
    if not dynamic_grid:
        consts[Builtin.CUBE_COUNT_X] = cube_count[0]
        consts[Builtin.CUBE_COUNT] = \
            cube_count[0] * cube_count[1] * cube_count[2]

    def subst(v: Value) -> Value:
        if v.kind == VarKind.BUILTIN and v.payload in consts:
            return const_value(consts[v.payload], v.ty)
        return v

    for _s, inst in walk(scope):
        inst.op.args = tuple(subst(a) for a in inst.op.args)


def const_fold(scope: Scope) -> None:
    """Propagate copies of constants and evaluate pure ops on constants.
    Works on the structured tree; assignments to LOCAL (immutable) values
    dominate all uses, so substitution is safe. LOCAL_MUT values are only
    folded when written exactly once at the top level."""
    defs: Dict[int, Value] = {}

    # count writes to mut locals anywhere
    writes: Dict[int, int] = {}
    for _s, inst in walk(scope):
        if inst.out is not None and inst.out.kind == VarKind.LOCAL_MUT:
            writes[inst.out.vid] = writes.get(inst.out.vid, 0) + 1

    def subst(v: Value) -> Value:
        seen = 0
        while v.vid in defs and seen < 64:
            v = defs[v.vid]
            seen += 1
        return v

    def fold_scope(s: Scope) -> None:
        for inst in s.instructions:
            inst.op.args = tuple(subst(a) for a in inst.op.args)
            if "cond_value" in inst.op.attrs:
                inst.op.attrs["cond_value"] = subst(inst.op.attrs["cond_value"])
            for sub in _children(inst):
                fold_scope(sub)
            out = inst.out
            if out is None:
                continue
            op = inst.op
            single_mut = (out.kind == VarKind.LOCAL_MUT
                          and writes.get(out.vid, 0) == 1 and s is scope)
            if out.kind != VarKind.LOCAL and not single_mut:
                continue
            if op.opcode == O.COPY:
                defs[out.vid] = op.args[0]
                continue
            info = OPS.get(op.opcode)
            if info is None or info.py is None or not info.pure:
                continue
            if all(a.is_const for a in op.args) and not op.attrs:
                try:
                    val = info.py(*(a.const for a in op.args))
                except Exception:
                    continue
                if out.ty.elem.is_float:
                    val = float(val)
                elif out.ty.elem.is_bool:
                    val = bool(val)
                else:
                    val = int(val)
                defs[out.vid] = const_value(val, out.ty)

    fold_scope(scope)


def dead_code(scope: Scope) -> bool:
    """Remove pure instructions whose results are never used (reference
    post_processing/dead_code.rs). Returns True if anything was removed."""
    used: Set[int] = set()
    for _s, inst in walk(scope):
        for a in inst.op.args:
            used.add(a.vid)
        for key in ("cond_value", "var"):
            v = inst.op.attrs.get(key)
            if isinstance(v, Value):
                used.add(v.vid)

    removed = False

    def sweep(s: Scope) -> None:
        nonlocal removed
        keep = []
        for inst in s.instructions:
            for sub in _children(inst):
                sweep(sub)
            out = inst.out
            info = OPS.get(inst.op.opcode)
            if (out is not None and info is not None and info.pure
                    and out.vid not in used and out.vid >= 0
                    and out.kind in (VarKind.LOCAL, VarKind.LOCAL_MUT)):
                removed = True
                continue
            keep.append(inst)
        s.instructions[:] = keep

    sweep(scope)
    return removed


def prune_empty_branches(scope: Scope) -> None:
    """Drop branches/loops whose bodies became empty, and fold branches on
    constant conditions (reference inline/const-prop interplay)."""

    def prune(s: Scope) -> None:
        keep = []
        for inst in s.instructions:
            for sub in _children(inst):
                prune(sub)
            oc = inst.op.opcode
            if oc in (O.IF, O.IF_ELSE):
                cond = inst.op.args[0]
                then = inst.op.attrs.get("then")
                orelse = inst.op.attrs.get("orelse")
                if cond.is_const:
                    chosen = then if cond.const else orelse
                    if chosen is not None:
                        keep.extend(chosen.instructions)
                    continue
                if not then.instructions and (
                        orelse is None or not orelse.instructions):
                    continue
            if oc in (O.RANGE_LOOP, O.LOOP, O.WHILE):
                body = inst.op.attrs.get("body")
                if body is not None and not body.instructions \
                        and oc == O.RANGE_LOOP:
                    continue
            keep.append(inst)
        s.instructions[:] = keep

    prune(scope)


def optimize_scope(scope: Scope, cube_dim=(1, 1, 1), cube_count=(1, 1, 1),
                   plane_dim: int = 32, max_iters: int = 8,
                   dynamic_grid: bool = False) -> None:
    """Fixpoint driver (reference optimize_scope,
    post_processing/mod.rs:27)."""
    fold_builtins(scope, cube_dim, cube_count, plane_dim, dynamic_grid)
    for _ in range(max_iters):
        const_fold(scope)
        prune_empty_branches(scope)
        if not dead_code(scope):
            break
