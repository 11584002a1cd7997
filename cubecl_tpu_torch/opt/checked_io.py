"""Checked-IO pass: bounds-checked buffer access.

Reference: cubecl-core/src/post_processing/checked_io.rs inserts
``read_checked``/``write_checked`` (io.rs:12-106) per ``ExecutionMode``.
As in the JAX package, accesses whose affine index range provably stays
inside the (static) buffer length are left untouched; everything else
becomes a masked access (``mem.index_masked`` reads 0 out of bounds,
``mem.store_masked`` drops the write)."""

from __future__ import annotations

from ..ir import ops as O
from ..ir.ops import Instruction, Operation
from ..ir.scope import Scope
from ..ir.types import Type, bool_
from ..ir.value import Value, VarKind, const_value
from .analysis import (
    Affine,
    GRID_SYMS,
    UniformityAnalysis,
    _sym_range,
    analyze_affine,
    collect_loop_ranges,
)


def _max_of(aff: Affine, cube_dim, cube_count, loop_ranges):
    hi = aff.const
    lo = aff.const
    for s, c in aff.coeffs.items():
        if s in GRID_SYMS:
            dim = {"cx": cube_count[0], "cy": cube_count[1],
                   "cz": cube_count[2]}[s]
            r = (0, dim - 1)
        else:
            r = _sym_range(s, cube_dim, loop_ranges)
        if r is None:
            return None, None
        lo += min(c * r[0], c * r[1])
        hi += max(c * r[0], c * r[1])
    return lo, hi


def insert_checked_io(scope: Scope, cube_dim, cube_count) -> None:
    ua = UniformityAnalysis(scope)
    loop_ranges = collect_loop_ranges(scope)
    _env, get = analyze_affine(scope, ua, loop_ranges, cube_dim, cube_count)
    # a buffer with a runtime logical length (dyn_len scalar) is checked
    # against THAT value — the reference semantics (read_checked compares
    # against the runtime buffer_len metadata, io.rs:12-106); its static
    # capacity only bounds memory, not validity
    lengths = {bp.value.vid: (bp.dyn_len if bp.dyn_len is not None
                              else bp.length)
               for bp in scope.state.buffers}
    for sd in scope.state.shareds:
        lengths[sd.value.vid] = sd.shape[0]

    def rewrite(s: Scope) -> None:
        new = []
        for inst in s.instructions:
            for key in ("then", "orelse", "body", "cond_scope"):
                sub = inst.op.attrs.get(key)
                if isinstance(sub, Scope):
                    rewrite(sub)
            for _c, sub in inst.op.attrs.get("cases", []):
                rewrite(sub)
            oc = inst.op.opcode
            if oc in (O.INDEX, O.STORE):
                buf = inst.op.args[0]
                if buf.kind in (VarKind.BUFFER, VarKind.SHARED):
                    idx = inst.op.args[1]
                    length = lengths.get(buf.vid)
                    dyn = isinstance(length, Value)
                    aff = get(idx)
                    safe = False
                    if not dyn and aff is not None and length is not None:
                        lo, hi = _max_of(aff, cube_dim, cube_count, loop_ranges)
                        safe = lo is not None and lo >= 0 and hi < length
                    if not safe and length is not None:
                        # indices are signed here (unlike the reference's
                        # u32), so a lone upper-bound check would let a
                        # negative index through — check both bounds
                        bound = length if dyn else \
                            const_value(length, idx.ty)
                        ub = s.create_local(Type(bool_))
                        new.append(Instruction(ub, Operation(
                            O.LT, (idx, bound))))
                        lb = s.create_local(Type(bool_))
                        new.append(Instruction(lb, Operation(
                            O.GE, (idx, const_value(0, idx.ty)))))
                        mask = s.create_local(Type(bool_))
                        new.append(Instruction(mask, Operation(
                            O.AND, (ub, lb))))
                        if oc == O.INDEX:
                            inst.op = Operation(
                                O.INDEX_MASKED, (buf, idx, mask),
                                inst.op.attrs)
                        else:
                            val = inst.op.args[2]
                            inst.op = Operation(
                                O.STORE_MASKED, (buf, idx, val, mask),
                                inst.op.attrs)
            new.append(inst)
        s.instructions[:] = new

    rewrite(scope)
