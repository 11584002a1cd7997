"""Static analyses of the kernel IR (counterpart of
``cubecl_tpu.opt.analysis``, the part the CUDA backend needs).

1. **Uniformity** — is a value identical across all units of a cube?
   (reference cubecl-opt/src/analyses/uniformity.rs:13). The torch
   evaluator keeps uniform values as one row instead of one per unit.

2. **Affine index forms** — every integer index is abstracted as an affine
   form over unit positions, grid positions and loop variables, so that
   the checked-IO pass can prove an access in bounds and leave it
   unmasked. The JAX package also plans Pallas BlockSpecs from these forms
   (``plan_buffers``); that planning is TPU-only and not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

from ..ir import ops as O
from ..ir.ops import Instruction
from ..ir.scope import Scope, walk
from ..ir.value import Builtin, UNIT_VARYING, Value, VarKind

UNIT_SYMS = ("ux", "uy", "uz")
GRID_SYMS = ("cx", "cy", "cz")

_BUILTIN_SYM = {
    Builtin.UNIT_POS_X: "ux", Builtin.UNIT_POS_Y: "uy", Builtin.UNIT_POS_Z: "uz",
    Builtin.CUBE_POS_X: "cx", Builtin.CUBE_POS_Y: "cy", Builtin.CUBE_POS_Z: "cz",
}


# ---------------------------------------------------------------------------
# Uniformity
# ---------------------------------------------------------------------------


class UniformityAnalysis:
    """Fixpoint uniformity over the structured scope tree."""

    def __init__(self, scope: Scope):
        self.scope = scope
        self.varying: Set[int] = set()          # vids known unit-varying
        self.varying_shared: Set[int] = set()   # shared buffers w/ varying contents
        self._run()

    def is_varying_value(self, v: Value) -> bool:
        if v.kind == VarKind.BUILTIN:
            return v.payload in UNIT_VARYING
        if v.kind == VarKind.CONSTANT or v.kind == VarKind.SCALAR:
            return False
        if v.kind == VarKind.BUFFER:
            return False
        return v.vid in self.varying

    def _run(self) -> None:
        for _ in range(64):
            if not self._sweep(self.scope, ctx_varying=False):
                return
        # safety net: treat everything as varying if no fixpoint (shouldn't
        # happen — the lattice only descends)

    def _cond_varying(self, inst: Instruction) -> bool:
        if inst.op.opcode == O.WHILE:
            cv = inst.op.attrs.get("cond_value")
            return cv is not None and self.is_varying_value(cv)
        if inst.op.opcode == O.RANGE_LOOP:
            # any varying bound ⇒ per-unit trip counts ⇒ varying context
            return any(self.is_varying_value(a) for a in inst.op.args)
        if inst.op.args:
            return self.is_varying_value(inst.op.args[0])
        return False

    def _sweep(self, scope: Scope, ctx_varying: bool) -> bool:
        changed = False
        for inst in scope.instructions:
            oc = inst.op.opcode
            # recurse with branch context
            if oc in (O.IF, O.IF_ELSE, O.SWITCH, O.RANGE_LOOP, O.WHILE, O.LOOP):
                sub_ctx = ctx_varying or self._cond_varying(inst)
                if oc == O.RANGE_LOOP:
                    # the index var is varying iff start or step varies
                    # (a varying STOP only changes how many iterations are
                    # alive per unit — the index itself stays uniform)
                    lv = inst.op.attrs["var"]
                    if (self.is_varying_value(inst.op.args[0])
                            or self.is_varying_value(inst.op.args[2])) and \
                            lv.vid not in self.varying:
                        self.varying.add(lv.vid)
                        changed = True
                if oc == O.LOOP:
                    # a break under a varying condition makes carries varying;
                    # approximated by scanning for varying-cond ifs w/ breaks
                    sub_ctx = sub_ctx or _has_varying_break(
                        inst.op.attrs["body"], self)
                for key in ("then", "orelse", "body", "cond_scope"):
                    sub = inst.op.attrs.get(key)
                    if isinstance(sub, Scope):
                        changed |= self._sweep(sub, sub_ctx)
                for _c, sub in inst.op.attrs.get("cases", []):
                    changed |= self._sweep(sub, sub_ctx)

            out = inst.out
            var = ctx_varying
            if oc in (O.PLANE_ELECT, O.PLANE_BALLOT, O.PLANE_BROADCAST,
                      O.PLANE_SHUFFLE, O.PLANE_SHUFFLE_XOR, O.PLANE_SHUFFLE_UP,
                      O.PLANE_SHUFFLE_DOWN, O.PLANE_INCLUSIVE_SUM,
                      O.PLANE_EXCLUSIVE_SUM, O.PLANE_INCLUSIVE_PROD,
                      O.PLANE_EXCLUSIVE_PROD):
                var = True
            elif oc in (O.PLANE_SUM, O.PLANE_PROD, O.PLANE_MAX, O.PLANE_MIN,
                        O.PLANE_ALL, O.PLANE_ANY):
                # plane-uniform, cube-varying unless the cube is one plane
                var = True
            elif oc == O.INDEX or oc == O.INDEX_MASKED:
                buf = inst.op.args[0]
                idx_var = any(self.is_varying_value(a) for a in inst.op.args[1:])
                shared_var = (buf.kind == VarKind.SHARED
                              and buf.vid in self.varying_shared)
                var = var or idx_var or shared_var
            elif oc.startswith("atomic."):
                var = True
            else:
                var = var or any(self.is_varying_value(a) for a in inst.op.args)

            if oc in (O.STORE, O.STORE_MASKED):
                buf = inst.op.args[0]
                if buf.kind == VarKind.SHARED and buf.vid not in self.varying_shared:
                    stored_var = ctx_varying or any(
                        self.is_varying_value(a) for a in inst.op.args[1:])
                    if stored_var:
                        self.varying_shared.add(buf.vid)
                        changed = True

            if out is not None and var and out.vid not in self.varying:
                self.varying.add(out.vid)
                changed = True
        return changed


def _has_varying_break(scope: Scope, ua: UniformityAnalysis) -> bool:
    for s, inst in walk(scope):
        if inst.op.opcode == O.BREAK:
            return True  # conservative: any break in a LOOP ⇒ varying ctx risk
    return False


# ---------------------------------------------------------------------------
# Affine forms
# ---------------------------------------------------------------------------


@dataclass
class Affine:
    """const + Σ coeff·sym. Syms: ux/uy/uz, cx/cy/cz, L<vid> (loop vars with
    static ranges), D<vid> (dynamic uniform scalars with unknown range)."""

    const: int = 0
    coeffs: Dict[str, int] = field(default_factory=dict)

    def add(self, other: "Affine", sign: int = 1) -> "Affine":
        out = Affine(self.const + sign * other.const, dict(self.coeffs))
        for s, c in other.coeffs.items():
            out.coeffs[s] = out.coeffs.get(s, 0) + sign * c
            if out.coeffs[s] == 0:
                del out.coeffs[s]
        return out

    def scale(self, k: int) -> "Affine":
        if k == 0:
            return Affine(0)
        return Affine(self.const * k, {s: c * k for s, c in self.coeffs.items()})

    def is_const(self) -> bool:
        return not self.coeffs


def analyze_affine(scope: Scope, ua: UniformityAnalysis,
                   loop_ranges: Dict[int, Tuple[int, int, int]],
                   cube_dim: Tuple[int, int, int],
                   cube_count: Tuple[int, int, int] = (1, 1, 1)):
    """Forward affine abstract interpretation. Returns value-vid → Affine
    (missing = non-affine / not integer). ``loop_ranges`` maps RANGE_LOOP
    var vids to (start, stop, step) when static."""
    env: Dict[int, Optional[Affine]] = {}
    Ux, Uy, Uz = cube_dim
    Cx, Cy, Cz = cube_count
    U = Ux * Uy * Uz

    def get(v: Value) -> Optional[Affine]:
        if v.kind == VarKind.CONSTANT:
            if isinstance(v.const, bool) or not isinstance(v.const, int):
                return None
            return Affine(int(v.const))
        if v.kind == VarKind.BUILTIN:
            b = v.payload
            if b in _BUILTIN_SYM:
                return Affine(0, {_BUILTIN_SYM[b]: 1})
            if b == Builtin.UNIT_POS:
                return Affine(0, {"ux": 1, "uy": Ux, "uz": Ux * Uy})
            if b == Builtin.CUBE_POS:
                return Affine(0, {"cx": 1, "cy": Cx, "cz": Cx * Cy})
            if b == Builtin.ABSOLUTE_POS:
                # global linear unit id, x-fastest (reference AbsolutePos):
                # (cz*Cy*Cx + cy*Cx + cx)*U + uz*Uy*Ux + uy*Ux + ux
                return Affine(0, {"ux": 1, "uy": Ux, "uz": Ux * Uy,
                                  "cx": U, "cy": U * Cx, "cz": U * Cx * Cy})
            if b == Builtin.ABSOLUTE_POS_X:
                return Affine(0, {"ux": 1, "cx": Ux})
            if b == Builtin.ABSOLUTE_POS_Y:
                return Affine(0, {"uy": 1, "cy": Uy})
            if b == Builtin.ABSOLUTE_POS_Z:
                return Affine(0, {"uz": 1, "cz": Uz})
            if b in (Builtin.UNIT_POS_PLANE, Builtin.PLANE_POS):
                return None
            return None
        if v.kind == VarKind.SCALAR:
            return Affine(0, {f"D{v.vid}": 1})
        if v.vid in loop_ranges:
            return Affine(0, {f"L{v.vid}": 1})
        return env.get(v.vid)

    def visit(s: Scope) -> None:
        for inst in s.instructions:
            for key in ("then", "orelse", "body", "cond_scope"):
                sub = inst.op.attrs.get(key)
                if isinstance(sub, Scope):
                    visit(sub)
            for _c, sub in inst.op.attrs.get("cases", []):
                visit(sub)
            out = inst.out
            if out is None or not out.ty.elem.is_int or out.ty.line != 1:
                continue
            if out.kind == VarKind.LOCAL_MUT:
                # mut locals may be rewritten under control flow — only track
                # if every write agrees (conservatively: don't track)
                env[out.vid] = None
                continue
            oc = inst.op.opcode
            args = inst.op.args
            a = get(args[0]) if args else None
            bb = get(args[1]) if len(args) > 1 else None
            res: Optional[Affine] = None
            if oc in (O.ADD,) and a and bb:
                res = a.add(bb)
            elif oc == O.SUB and a and bb:
                res = a.add(bb, -1)
            elif oc == O.MUL and a and bb:
                if a.is_const():
                    res = bb.scale(a.const)
                elif bb.is_const():
                    res = a.scale(bb.const)
            elif oc == O.NEG and a:
                res = a.scale(-1)
            elif oc in (O.COPY, O.CAST) and a:
                res = a
            elif oc in (O.FLOORDIV, O.DIV) and a and bb and bb.is_const() \
                    and bb.const > 0:
                k = bb.const
                if a.const % k == 0 and all(c % k == 0 for c in a.coeffs.values()):
                    res = Affine(a.const // k,
                                 {sx: c // k for sx, c in a.coeffs.items()})
            elif oc == O.MOD and a and bb and bb.is_const() and bb.const > 0:
                k = bb.const
                if a.const % k == 0 and all(c % k == 0 for c in a.coeffs.values()):
                    res = Affine(0)
            env[out.vid] = res

    visit(scope)
    return env, get


def collect_loop_ranges(scope: Scope) -> Dict[int, Tuple[int, int, int]]:
    out: Dict[int, Tuple[int, int, int]] = {}
    for _s, inst in walk(scope):
        if inst.op.opcode == O.RANGE_LOOP:
            start, stop, step = inst.op.args
            if start.is_const and stop.is_const and step.is_const:
                out[inst.op.attrs["var"].vid] = (
                    int(start.const), int(stop.const), int(step.const))
    return out


def _sym_range(sym: str, cube_dim, loop_ranges) -> Optional[Tuple[int, int]]:
    """Inclusive [min, max] of a non-grid symbol, None if unbounded."""
    if sym == "ux":
        return (0, cube_dim[0] - 1)
    if sym == "uy":
        return (0, cube_dim[1] - 1)
    if sym == "uz":
        return (0, cube_dim[2] - 1)
    if sym.startswith("L"):
        start, stop, step = loop_ranges[int(sym[1:])]
        if step > 0 and stop > start:
            last = start + ((stop - 1 - start) // step) * step
            return (start, last)
        if step < 0 and stop < start:
            last = start + ((stop + 1 - start) // step) * step
            return (min(start, last), max(start, last))
        return (0, 0)  # empty loop
    return None  # dynamic scalar
