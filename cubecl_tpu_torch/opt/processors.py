"""Processor hooks — backend-registered IR rewriters.

Reference: the ``Processor`` trait (cubecl-ir/src/processing.rs:10) and
``OptimizerBuilder`` transformer injection (cubecl-opt/src/
transformers.rs:9); e.g. CUDA's MMA lowering processor
(cubecl-cpp/src/cuda/processors.rs:8) and the ``#[cube]``-authored
polyfill processors (cubecl-core/src/post_processing/saturating.rs:16).

The port runs the fast-math processor over the scope tree before the
generic passes (``backend.compiler.prepare_scope``).
"""

from __future__ import annotations

from typing import Iterable, List

from ..ir import ops as O
from ..ir.ops import Instruction, Operation
from ..ir.scope import Scope


class Processor:
    """Rewrites instructions in place; return a replacement list or None to
    keep the instruction unchanged."""

    def process(self, scope: Scope, inst: Instruction):
        return None

    def run(self, scope: Scope) -> None:
        new: List[Instruction] = []
        for inst in scope.instructions:
            for key in ("then", "orelse", "body", "cond_scope"):
                sub = inst.op.attrs.get(key)
                if isinstance(sub, Scope):
                    self.run(sub)
            for _c, sub in inst.op.attrs.get("cases", []):
                self.run(sub)
            repl = self.process(scope, inst)
            if repl is None:
                new.append(inst)
            else:
                new.extend(repl)
        scope.instructions[:] = new


class FastMathProcessor(Processor):
    """Apply relaxed-precision rewrites when fast-math flags allow
    (reference InstructionModes fp_math_mode, marker.rs:54-74):
    AllowReciprocal turns x / y into x * recip(y) for uniform divisors."""

    def process(self, scope: Scope, inst: Instruction):
        # instruction modes carry the flat flag dict the tracing scope
        # stamped from the kernel/helper fast_math options
        flags = inst.modes if isinstance(inst.modes, dict) else {}
        allow = flags.get("allow_reciprocal")
        if allow and inst.op.opcode == O.DIV and inst.out is not None \
                and inst.out.ty.elem.is_float:
            a, b = inst.op.args
            r = scope.create_local(inst.out.ty)
            return [
                Instruction(r, Operation(O.RECIP, (b,)), inst.modes),
                Instruction(inst.out, Operation(O.MUL, (a, r)), inst.modes),
            ]
        return None


def run_processors(scope: Scope, processors: Iterable[Processor]) -> None:
    for p in processors:
        p.run(scope)
