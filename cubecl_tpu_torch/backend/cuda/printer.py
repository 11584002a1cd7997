"""K0 on Hopper: the CUDA C++ printer of the kernel IR.

Replaces ``cubecl_tpu/backend/pallas/emitter.py::PallasCompiler.compile``
(its ``pl.pallas_call`` at :409), the TPU backend that lowers any traced
``@cube`` kernel; this is the counterpart of the reference's own
``cubecl-cpp`` CUDA dialect. :class:`CudaCompiler` runs the scope passes of
the JAX package (``backend.compiler.prepare_scope``), prints one
``__global__`` function from the optimized scope, and hands it to
``build.py`` (nvcc for ``sm_90a``, a shared library loaded with ctypes).

The mapping:

- a unit is a thread and a cube a block; ``UNIT_POS``, ``CUBE_POS_*`` and
  ``ABSOLUTE_POS`` come from ``threadIdx`` / ``blockIdx`` (cube dim and
  count are static per kernel id and folded by the passes);
- structured ``If``/``RangeLoop``/``While``/``Loop``/``Break``/``Return``
  become C control flow (a ``Switch`` an if-chain, so that ``break`` still
  leaves the loop);
- a buffer is a global pointer indexed in lines; its length in lines is a
  kernel argument (``meta.buffer_len``); ``mem.index``/``mem.store`` and
  their masked forms (checked IO) read and write it;
- a line (``ty.line > 1``) is a loop over its elements. An elementwise
  chain is inlined, element by element, into the loop that consumes it (a
  reduction, ``op.vec_sum``/``vec_max``, or a store), so it keeps no
  per-thread array. A line that cannot be inlined (a mutable local, an
  expression longer than ``_INLINE_LIMIT``, or a load from a buffer the
  kernel also writes) is a per-thread array ``T v[L]``;
- buffer pointers are ``__restrict__`` unless the launch passed one
  tensor as two buffers (``state.aliased``); aliased buffers count as
  written, so their lines are loaded into arrays before any store;
- bf16/f16/fp8 values are stored in their own type and computed in f32:
  each op converts its operands with ``__bfloat162float`` and rounds its
  result once with ``__float2bfloat16_rn`` (nearest even, as XLA and
  torch do), the same per-op rounding as the torch evaluator;
- ``plane.*`` reductions are butterflies of ``__shfl_xor_sync`` over the
  plane (a warp, or the whole cube when it has fewer than 32 units),
  ``plane.all/any`` are ``__all_sync``/``__any_sync``, broadcasts and
  shuffles ``__shfl_*_sync``; ``sync.cube`` is ``__syncthreads()``;
- ``erf``, ``rsqrt`` and ``exp`` print as ``erff``, ``rsqrtf`` and ``expf``
  (no fast-math flag of the IR selects the ``__expf`` intrinsics yet).

What bounds a printed kernel: it is the DSL kernel as written, one thread
per unit. A kernel with wide lines (the ``*_lines`` normalization kernels
and ``ops/functional.py``: a whole row of up to 16384 elements on one
line) reads its row with one thread, element by element, once per
reduction and once for the store; with the chains inlined it needs no
local memory. An in-place kernel (``softmax_lines_inplace``) still keeps
its row in an array, which lives in local memory. Rows over a block and
vector loads are later work; PERF.md keeps each time beside the plain
torch version.

Ops this printer does not lower raise ``NotImplementedError`` naming the
op (``backend.compiler.unsupported``): atomics, cmma, ``mem.block_reduce``,
``mem.slice``, shared memory and per-unit arrays, barriers and
``memcpy_async``, plane scans and ballots, ``op.reinterpret``, the
saturating and bit-counting ops, ``debug.print``, and a runtime grid.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Set

from ...ir import ops as O
from ...ir.features import WARP
from ...ir.scope import Scope, walk
from ...ir.types import ElemType, bool_, elem_from_dtype, i32, i64, u32
from ...ir.value import Builtin, Value, VarKind
from ..compiler import (CompiledKernel, Compiler, KernelDefinition,
                        prepare_scope, unsupported)

_BACKEND = "the CUDA printer"

# longest per-element expression a line value is inlined as (longer ones
# are materialized in an array, so that nesting cannot blow up the source)
_INLINE_LIMIT = 600

_STORAGE = {
    "f64": "double", "f32": "float", "flex32": "float",
    "bf16": "__nv_bfloat16", "f16": "__half",
    "fp8_e4m3": "__nv_fp8_e4m3", "fp8_e5m2": "__nv_fp8_e5m2",
    "i64": "int64_t", "i32": "int32_t", "i16": "int16_t", "i8": "int8_t",
    "u64": "uint64_t", "u32": "uint32_t", "u16": "uint16_t", "u8": "uint8_t",
    "bool": "bool",
}

# storage types computed in f32, with their conversions
_NARROW = {
    "bf16": ("__bfloat162float({})", "__float2bfloat16_rn({})"),
    "f16": ("__half2float({})", "__float2half_rn({})"),
    "fp8_e4m3": ("float({})", "__nv_fp8_e4m3({})"),
    "fp8_e5m2": ("float({})", "__nv_fp8_e5m2({})"),
}

_F32_FN = {
    O.EXP: "expf", O.EXP2: "exp2f", O.LOG: "logf", O.LOG2: "log2f",
    O.LOG1P: "log1pf", O.SQRT: "sqrtf", O.RSQRT: "rsqrtf", O.SIN: "sinf",
    O.COS: "cosf", O.TAN: "tanf", O.ASIN: "asinf", O.ACOS: "acosf",
    O.ATAN: "atanf", O.SINH: "sinhf", O.COSH: "coshf", O.TANH: "tanhf",
    O.ERF: "erff", O.FLOOR: "floorf", O.CEIL: "ceilf", O.ROUND: "rintf",
    O.TRUNC: "truncf", O.ABS: "fabsf", O.POW: "powf", O.ATAN2: "atan2f",
    O.REM: "fmodf", O.MAX: "fmaxf", O.MIN: "fminf",
}

_BINOP = {O.ADD: "+", O.SUB: "-", O.MUL: "*", O.BAND: "&", O.BOR: "|",
          O.BXOR: "^", O.SHL: "<<", O.SHR: ">>", O.AND: "&&", O.OR: "||",
          O.EQ: "==", O.NE: "!=", O.LT: "<", O.LE: "<=", O.GT: ">",
          O.GE: ">="}
_COMPARE = (O.EQ, O.NE, O.LT, O.LE, O.GT, O.GE)

_PLANE_RED = {O.PLANE_SUM: "({a}) + ({b})", O.PLANE_PROD: "({a}) * ({b})",
              O.PLANE_MAX: "cc_max({a}, {b})",
              O.PLANE_MIN: "cc_min({a}, {b})"}

_BUILTIN_NAME = {
    Builtin.UNIT_POS: "unit_pos", Builtin.UNIT_POS_X: "unit_pos_x",
    Builtin.UNIT_POS_Y: "unit_pos_y", Builtin.UNIT_POS_Z: "unit_pos_z",
    Builtin.CUBE_POS: "cube_pos", Builtin.CUBE_POS_X: "cube_pos_x",
    Builtin.CUBE_POS_Y: "cube_pos_y", Builtin.CUBE_POS_Z: "cube_pos_z",
    Builtin.ABSOLUTE_POS: "absolute_pos",
    Builtin.ABSOLUTE_POS_X: "absolute_pos_x",
    Builtin.ABSOLUTE_POS_Y: "absolute_pos_y",
    Builtin.ABSOLUTE_POS_Z: "absolute_pos_z",
    Builtin.UNIT_POS_PLANE: "unit_pos_plane", Builtin.PLANE_POS: "plane_pos",
}

PRELUDE = r"""#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Python semantics of // and % on signed integers (floor), as the IR
// (and the JAX and torch evaluators) define them
template <typename T> __device__ __forceinline__ T cc_floordiv(T a, T b) {
  T q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
template <typename T> __device__ __forceinline__ T cc_mod(T a, T b) {
  T r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
template <typename T> __device__ __forceinline__ T cc_max(T a, T b) {
  return a > b ? a : b;
}
template <typename T> __device__ __forceinline__ T cc_min(T a, T b) {
  return a < b ? a : b;
}
"""


def _storage(elem: ElemType) -> str:
    try:
        return _STORAGE[elem.name]
    except KeyError:
        raise unsupported(f"element type {elem.name}", _BACKEND) from None


def _compute(elem: ElemType) -> str:
    return "float" if elem.name in _NARROW else _storage(elem)


def _literal(v, elem: ElemType) -> str:
    """An exact C literal of ``v`` in ``elem``'s compute type."""
    if elem.is_bool:
        return "true" if v else "false"
    if elem.is_float:
        f = float(v)
        ct = _compute(elem)
        if math.isnan(f):
            return f"(({ct})NAN)"
        if math.isinf(f):
            return f"({'-' if f < 0 else ''}({ct})INFINITY)"
        return f"{f.hex()}{'f' if ct == 'float' else ''}"
    ct = _storage(elem)
    return f"(({ct}){int(v)}{'ULL' if not elem.is_signed else 'LL'})"


def _shfl_type(elem: ElemType) -> str:
    """The type a ``__shfl_*_sync`` moves a value of ``elem`` as."""
    if elem.is_float:
        return _compute(elem)
    if elem.is_bool or elem.bits < 32:
        return "int"
    return _storage(elem)


class _Printer:
    def __init__(self, defn: KernelDefinition, kernel_name: str):
        self.defn = defn
        self.name = kernel_name
        st = defn.state
        self.U = math.prod(defn.cube_dim)
        self.P = defn.plane_dim
        self.lines: List[str] = []
        self.depth = 1
        self.buffers = {bp.value.vid: bp for bp in st.buffers}
        # loop frames: carry writebacks [(mut, value)] of each open loop
        self.loops: List[list] = []
        # C blocks: vids whose declaration is visible in each open block
        self.blocks: List[Set[int]] = [set()]
        # line values printed as per-element expressions, not arrays
        self.exprs: Dict[int, Callable[[str], str]] = {}
        # buffers the kernel writes: their lines are loaded into arrays,
        # never re-read by an inlined expression after a store. Aliased
        # buffers are one memory: a store to one is a store to all.
        self.stored = {i.op.args[0].vid for _s, i in walk(defn.scope)
                       if i.op.opcode in (O.STORE, O.STORE_MASKED)}
        if self.stored & st.aliased:
            self.stored |= st.aliased

    # ----------------------------------------------------------- output

    def emit(self, line: str) -> None:
        self.lines.append("  " * self.depth + line)

    def open(self, head: str) -> None:
        self.emit(head + " {")
        self.depth += 1
        self.blocks.append(set())

    def close(self, tail: str = "}") -> None:
        self.depth -= 1
        self.blocks.pop()
        self.emit(tail)

    def visible(self, v: Value) -> bool:
        return any(v.vid in b for b in self.blocks)

    # ----------------------------------------------------------- values

    def name_of(self, v: Value) -> str:
        if v.kind == VarKind.BUILTIN:
            try:
                return _BUILTIN_NAME[v.payload]
            except KeyError:
                raise unsupported(f"builtin {v.payload.value}",
                                  _BACKEND) from None
        if v.kind == VarKind.SCALAR:
            return f"s{v.vid}"
        if v.kind == VarKind.BUFFER:
            return f"b{v.vid}"
        if v.kind in (VarKind.LOCAL, VarKind.LOCAL_MUT):
            return f"v{v.vid}"
        raise unsupported(f"{v.kind.value} values", _BACKEND)

    def ref(self, v: Value, l: Optional[str] = None) -> str:
        """Storage-typed read of ``v`` (element ``l`` of a line)."""
        if v.kind == VarKind.CONSTANT:
            return self.lit_storage(v.const, v.ty.elem)
        if l is not None and v.vid in self.exprs:
            return f"({self.exprs[v.vid](l)})"
        n = self.name_of(v)
        return f"{n}[{l}]" if v.ty.line > 1 and l is not None else n

    def lit_storage(self, c, elem: ElemType) -> str:
        lit = _literal(c, elem)
        if elem.name in _NARROW:
            return _NARROW[elem.name][1].format(lit)
        return lit

    def cval(self, v: Value, as_elem: ElemType,
             l: Optional[str] = None) -> str:
        """``v`` (element ``l`` of a line) in ``as_elem``'s compute
        type."""
        if v.kind == VarKind.CONSTANT:
            return _literal(v.const, as_elem)
        s = self.ref(v, l)
        if v.ty.elem.name in _NARROW:
            s = _NARROW[v.ty.elem.name][0].format(s)
        src_ct, dst_ct = _compute(v.ty.elem), _compute(as_elem)
        if src_ct != dst_ct:
            s = f"(({dst_ct})({s}))"
        return s

    def store_as(self, expr: str, elem: ElemType) -> str:
        """A compute-type expression converted to ``elem``'s storage."""
        if elem.name in _NARROW:
            return _NARROW[elem.name][1].format(expr)
        return expr

    def inline(self, v: Value, elem_expr: Callable[[str], str],
               operands) -> bool:
        """Print line value ``v`` as ``elem_expr(l)`` (storage-typed) at
        each use instead of into an array, when its operands cannot change
        before the use (no mutable locals) and the expression is short.
        Elementwise chains then fuse into the loop that consumes them
        (a reduction or a store) and keep no per-thread array."""
        if v.ty.line == 1 or any(a.kind == VarKind.LOCAL_MUT
                                 for a in operands):
            return False
        if len(elem_expr("l")) > _INLINE_LIMIT:
            return False
        self.exprs[v.vid] = elem_expr
        self.blocks[-1].add(v.vid)
        return True

    def declare(self, v: Value) -> str:
        """Declare ``v`` in the current block unless visible; returns its
        name."""
        n = self.name_of(v)
        if v.kind == VarKind.LOCAL and not self.visible(v):
            arr = f"[{v.ty.line}]" if v.ty.line > 1 else ""
            self.emit(f"{_storage(v.ty.elem)} {n}{arr};")
            self.blocks[-1].add(v.vid)
        return n

    # ------------------------------------------------------------ kernel

    def print_kernel(self) -> str:
        d = self.defn
        st = d.state
        if d.dynamic_grid_vid is not None:
            raise unsupported("a runtime grid (CubeCount.runtime)", _BACKEND)
        if st.shareds:
            raise unsupported("shared memory / per-unit arrays", _BACKEND)
        if st.matrices:
            raise unsupported("cmma matrices", _BACKEND)
        params = []
        for bp in st.buffers:
            const = "" if bp.mutable else "const "
            restrict = "" if bp.value.vid in st.aliased else "__restrict__ "
            params.append(f"{const}{_storage(bp.ty.elem)}* {restrict}"
                          f"b{bp.value.vid}")
        for bp in st.buffers:
            params.append(f"int64_t len_b{bp.value.vid}")
        for sp in st.scalars:
            params.append(f"{_storage(sp.ty.elem)} s{sp.value.vid}")
        ux, uy, uz = d.cube_dim
        cx, cy, _cz = d.cube_count
        out = [PRELUDE,
               f"// {self.name}: cube_dim={d.cube_dim} "
               f"cube_count={d.cube_count} plane={self.P} "
               f"checked={d.options.checked}",
               f"extern \"C\" __global__ void __launch_bounds__({self.U}) "
               f"{self.name}(",
               "    " + ",\n    ".join(params) + ") {"]
        builtins = [
            f"const int32_t unit_pos_x = threadIdx.x, unit_pos_y = "
            f"threadIdx.y, unit_pos_z = threadIdx.z;",
            f"const int32_t unit_pos = unit_pos_x + unit_pos_y * {ux} + "
            f"unit_pos_z * {ux * uy};",
            "const int32_t cube_pos_x = blockIdx.x, cube_pos_y = "
            "blockIdx.y, cube_pos_z = blockIdx.z;",
            f"const int32_t cube_pos = cube_pos_x + cube_pos_y * {cx} + "
            f"cube_pos_z * {cx * cy};",
            f"const int32_t absolute_pos = cube_pos * {self.U} + unit_pos;",
            f"const int32_t absolute_pos_x = cube_pos_x * {ux} + unit_pos_x;",
            f"const int32_t absolute_pos_y = cube_pos_y * {uy} + unit_pos_y;",
            f"const int32_t absolute_pos_z = cube_pos_z * {uz} + unit_pos_z;",
            f"const int32_t unit_pos_plane = unit_pos % {self.P}, "
            f"plane_pos = unit_pos / {self.P};",
        ]
        for b in builtins:
            self.emit(b)
        # mutable locals may be first written inside a branch and read
        # after it: declare them all up front
        muts: Dict[int, Value] = {}
        for _s, inst in walk(d.scope):
            o = inst.out
            if o is not None and o.kind == VarKind.LOCAL_MUT:
                muts[o.vid] = o
        for m in muts.values():
            arr = f"[{m.ty.line}]" if m.ty.line > 1 else ""
            self.emit(f"{_storage(m.ty.elem)} v{m.vid}{arr};")
        self.scope(d.scope)
        out.extend(self.lines)
        out.append("}")
        return "\n".join(out) + "\n"

    def scope(self, s: Scope) -> None:
        for inst in s.instructions:
            self.inst(inst)

    # ------------------------------------------------------ instructions

    def inst(self, inst) -> None:
        op = inst.op
        oc = op.opcode
        if oc in (O.IF, O.IF_ELSE):
            self.open(f"if ({self.cval(op.args[0], bool_)})")
            self.scope(op.attrs["then"])
            if oc == O.IF_ELSE:
                self.close("} else {")
                self.depth += 1
                self.blocks.append(set())
                self.scope(op.attrs["orelse"])
            self.close()
        elif oc == O.SWITCH:
            v = op.args[0]
            first = True
            for case, sub in op.attrs.get("cases", []):
                cond = f"{self.cval(v, v.ty.elem)} == " \
                       f"{_literal(case, v.ty.elem)}"
                if first:
                    self.open(f"if ({cond})")
                    first = False
                else:
                    self.close(f"}} else if ({cond}) {{")
                    self.depth += 1
                    self.blocks.append(set())
                self.scope(sub)
            default = op.attrs.get("default")
            if default is not None:
                if first:
                    self.open("")
                else:
                    self.close("} else {")
                    self.depth += 1
                    self.blocks.append(set())
                self.scope(default)
                first = False
            if not first:
                self.close()
        elif oc == O.RANGE_LOOP:
            self.range_loop(inst)
        elif oc == O.WHILE:
            self.loops.append(_writebacks(op.attrs["body"]))
            self.open("while (true)")
            self.scope(op.attrs["cond_scope"])
            cv = op.attrs["cond_value"]
            self.emit(f"if (!({self.cval(cv, bool_)})) break;")
            self.scope(op.attrs["body"])
            self.close()
            self.loops.pop()
        elif oc == O.LOOP:
            self.loops.append(_writebacks(op.attrs["body"]))
            self.open("while (true)")
            self.scope(op.attrs["body"])
            self.close()
            self.loops.pop()
        elif oc in (O.BREAK, O.CONTINUE):
            self.flush_carries()
            self.emit("break;" if oc == O.BREAK else "continue;")
        elif oc in (O.RETURN, O.TERMINATE):
            self.emit("return;")
        elif oc in (O.STORE, O.STORE_MASKED):
            self.store(inst)
        elif oc == O.COMMENT:
            text = str(op.attrs.get("text", "")).replace("\n", " ")
            self.emit(f"// {text}")
        elif oc == O.SYNC_CUBE:
            self.emit("__syncthreads();")
        elif oc == O.SYNC_PLANE:
            self.emit(f"__syncwarp({self.plane_mask()});")
        elif oc == O.SYNC_STORAGE:
            self.emit("__threadfence();")
        elif inst.out is None:
            raise unsupported(oc, _BACKEND)
        else:
            self.value_op(inst)

    def flush_carries(self) -> None:
        """Before a break/continue: write back the innermost loop's carries
        whose new values are already computed, so the updates made before
        the break survive it (the break skips the body's tail)."""
        if not self.loops:
            raise SyntaxError("break/continue outside a loop")
        for m, v in self.loops[-1]:
            if v.kind in (VarKind.CONSTANT, VarKind.LOCAL_MUT) \
                    or self.visible(v):
                self.copy_into(m, v)

    def range_loop(self, inst) -> None:
        op = inst.op
        start, stop, step = op.args
        var = op.attrs["var"]
        incl = bool(op.attrs.get("inclusive", False))
        ct = _storage(var.ty.elem)
        s = self.cval(start, var.ty.elem)
        e = self.cval(stop, var.ty.elem)
        st = self.cval(step, var.ty.elem)
        lt, gt = ("<=", ">=") if incl else ("<", ">")
        n = f"v{var.vid}"
        if step.kind == VarKind.CONSTANT:
            cond = f"{n} {lt if step.const > 0 else gt} {e}"
        else:
            cond = f"({st} > 0) ? ({n} {lt} {e}) : ({n} {gt} {e})"
        self.loops.append(_writebacks(op.attrs["body"]))
        self.open(f"for ({ct} {n} = {s}; {cond}; {n} += {st})")
        self.blocks[-1].add(var.vid)
        self.scope(op.attrs["body"])
        self.close()
        self.loops.pop()

    def plane_mask(self) -> str:
        if self.P == WARP:
            return "0xffffffffu"
        return f"0x{(1 << self.P) - 1:x}u"

    # ------------------------------------------------------------ memory

    def buffer(self, v: Value):
        if v.kind != VarKind.BUFFER:
            raise unsupported(f"{v.kind.value} memory", _BACKEND)
        return self.buffers[v.vid]

    def elem_at(self, bp, idx: Value, l: str) -> str:
        L = bp.ty.line
        i = self.cval(idx, i64)
        return f"b{bp.value.vid}[{i} * {L} + {l}]" if L > 1 else \
            f"b{bp.value.vid}[{i}]"

    def store(self, inst) -> None:
        op = inst.op
        bp = self.buffer(op.args[0])
        idx, val = op.args[1], op.args[2]
        L = bp.ty.line
        guarded = op.opcode == O.STORE_MASKED
        if guarded:
            self.open(f"if ({self.cval(op.args[3], bool_)})")
        elem = bp.ty.elem
        if L > 1:
            self.open(f"for (int l = 0; l < {L}; ++l)")
            rhs = self.convert(val, elem, "l" if val.ty.line > 1 else None)
            self.emit(f"{self.elem_at(bp, idx, 'l')} = {rhs};")
            self.close()
        else:
            self.emit(f"{self.elem_at(bp, idx, '0')} = "
                      f"{self.convert(val, elem, None)};")
        if guarded:
            self.close()

    def convert(self, v: Value, elem: ElemType, l: Optional[str]) -> str:
        """``v`` converted to ``elem``'s storage type."""
        if v.ty.elem == elem and v.kind != VarKind.CONSTANT:
            return self.ref(v, l)
        return self.store_as(self.cval(v, elem, l), elem)

    def copy_into(self, m: Value, v: Value) -> None:
        n = self.name_of(m)
        if m.ty.line > 1:
            self.emit(f"for (int l = 0; l < {m.ty.line}; ++l) {n}[l] = "
                      f"{self.convert(v, m.ty.elem, 'l' if v.ty.line > 1 else None)};")
        else:
            self.emit(f"{n} = {self.convert(v, m.ty.elem, None)};")

    # -------------------------------------------------------- value ops

    def value_op(self, inst) -> None:
        op = inst.op
        oc = op.opcode
        out = inst.out
        elem, L = out.ty.elem, out.ty.line
        if oc == O.COPY:
            self.declare(out)
            self.copy_into(out, op.args[0])
            return
        if oc in (O.INDEX, O.INDEX_MASKED):
            self.load(inst)
            return
        if oc == O.BUFFER_LEN:
            n = self.declare(out)
            self.emit(f"{n} = ({_storage(elem)})len_b{op.args[0].vid};")
            return
        if oc in (O.SHAPE_DIM, O.STRIDE_DIM, O.RANK):
            bp = self.buffer(op.args[0])
            val = len(bp.shape) if oc == O.RANK else \
                (bp.shape if oc == O.SHAPE_DIM else bp.strides)[op.attrs["dim"]]
            n = self.declare(out)
            self.emit(f"{n} = {_literal(val, elem)};")
            return
        if oc in (O.VEC_SUM, O.VEC_MAX, O.VEC_MIN, O.DOT):
            self.line_reduce(inst)
            return
        if oc.startswith("plane."):
            self.plane(inst)
            return
        if oc == O.VEC_INIT:
            n = self.declare(out)
            for i, a in enumerate(op.args):
                self.emit(f"{n}[{i}] = {self.convert(a, elem, None)};")
            return
        if oc == O.VEC_EXTRACT:
            x, i = op.args
            n = self.declare(out)
            self.emit(f"{n} = {self.convert(x, elem, self.cval(i, i32))};")
            return
        if oc == O.VEC_INSERT:
            x, i, v = op.args
            n = self.declare(out)
            self.emit(f"for (int l = 0; l < {L}; ++l) {n}[l] = "
                      f"{self.convert(x, elem, 'l')};")
            self.emit(f"{n}[{self.cval(i, i32)}] = "
                      f"{self.convert(v, elem, None)};")
            return
        expr_of = self.expr_fn(inst)
        if self.inline(out, lambda l: self.store_as(expr_of(l), elem),
                       op.args):
            return
        n = self.declare(out)
        if L > 1:
            self.emit(f"for (int l = 0; l < {L}; ++l) {n}[l] = "
                      f"{self.store_as(expr_of('l'), elem)};")
        else:
            self.emit(f"{n} = {self.store_as(expr_of(None), elem)};")

    def expr_fn(self, inst):
        """A function of the element index giving the op's result in the
        output's compute type."""
        op = inst.op
        oc = op.opcode
        out = inst.out
        elem = out.ty.elem
        ct = _compute(elem)
        args = op.args

        def a(k, l, as_elem=elem):
            v = args[k]
            return self.cval(v, as_elem, l if v.ty.line > 1 else None)

        if oc in _COMPARE:
            pe = _promote(args[0].ty.elem, args[1].ty.elem)
            sym = _BINOP[oc]
            return lambda l: f"({a(0, l, pe)} {sym} {a(1, l, pe)})"
        if oc in (O.AND, O.OR):
            sym = _BINOP[oc]
            return lambda l: f"({a(0, l)} {sym} {a(1, l)})"
        if oc == O.NOT:
            return lambda l: f"(!{a(0, l)})"
        if oc == O.CAST:
            src = args[0].ty.elem
            if elem.is_bool:
                return lambda l: f"({a(0, l, src)} != 0)"
            return lambda l: f"(({ct})({a(0, l, src)}))"
        if oc == O.SELECT:
            return lambda l: (f"({a(0, l, bool_)} ? {a(1, l)} : "
                              f"{a(2, l)})")
        if oc == O.VEC_SPLAT:
            return lambda l: a(0, None)
        if oc in (O.IS_NAN, O.IS_INF):
            fn = "isnan" if oc == O.IS_NAN else "isinf"
            src = args[0].ty.elem
            return lambda l: f"{fn}({a(0, l, src)})"
        if elem.is_bool:
            raise unsupported(f"{oc} on bool", _BACKEND)
        if oc in (O.ADD, O.SUB, O.MUL):
            sym = _BINOP[oc]
            return lambda l: f"({a(0, l)} {sym} {a(1, l)})"
        if oc in (O.BAND, O.BOR, O.BXOR, O.SHL, O.SHR):
            if elem.is_float:
                raise unsupported(f"{oc} on {elem.name}", _BACKEND)
            sym = _BINOP[oc]
            return lambda l: f"({a(0, l)} {sym} {a(1, l)})"
        if oc == O.BNOT and elem.is_int:
            return lambda l: f"(~{a(0, l)})"
        if oc == O.NEG:
            return lambda l: f"(-{a(0, l)})"
        if oc == O.FMA:
            return lambda l: f"({a(0, l)} * {a(1, l)} + {a(2, l)})"
        if oc == O.CLAMP:
            return lambda l: (f"cc_min(cc_max({a(0, l)}, {a(1, l)}), "
                              f"{a(2, l)})")
        if elem.is_float:
            return self.float_expr(oc, ct, a)
        return self.int_expr(oc, elem, a)

    def float_expr(self, oc, ct, a):
        dbl = ct == "double"

        def fn(name):
            return name[:-1] if dbl else name

        if oc == O.DIV:
            return lambda l: f"({a(0, l)} / {a(1, l)})"
        if oc == O.RECIP:
            one = "1.0" if dbl else "1.0f"
            return lambda l: f"({one} / {a(0, l)})"
        if oc == O.FLOORDIV:
            return lambda l: f"{fn('floorf')}({a(0, l)} / {a(1, l)})"
        if oc == O.MOD:
            return lambda l: (f"({a(0, l)} - {a(1, l)} * "
                              f"{fn('floorf')}({a(0, l)} / {a(1, l)}))")
        if oc == O.SIGN:
            return lambda l: (f"(({ct})(({a(0, l)} > 0) - "
                              f"({a(0, l)} < 0)))")
        if oc in _F32_FN:
            name = fn(_F32_FN[oc])
            if oc in (O.POW, O.ATAN2, O.REM, O.MAX, O.MIN):
                return lambda l: f"{name}({a(0, l)}, {a(1, l)})"
            return lambda l: f"{name}({a(0, l)})"
        raise unsupported(oc, _BACKEND)

    def int_expr(self, oc, elem, a):
        if oc in (O.DIV, O.FLOORDIV):
            return lambda l: f"cc_floordiv({a(0, l)}, {a(1, l)})"
        if oc == O.MOD:
            return lambda l: f"cc_mod({a(0, l)}, {a(1, l)})"
        if oc == O.REM:
            return lambda l: f"({a(0, l)} % {a(1, l)})"
        if oc == O.MAX:
            return lambda l: f"cc_max({a(0, l)}, {a(1, l)})"
        if oc == O.MIN:
            return lambda l: f"cc_min({a(0, l)}, {a(1, l)})"
        if oc == O.ABS:
            return lambda l: f"({a(0, l)} < 0 ? -{a(0, l)} : {a(0, l)})"
        if oc == O.SIGN:
            ct = _compute(elem)
            return lambda l: f"(({ct})(({a(0, l)} > 0) - ({a(0, l)} < 0)))"
        raise unsupported(f"{oc} on {elem.name}", _BACKEND)

    def load(self, inst) -> None:
        op = inst.op
        out = inst.out
        bp = self.buffer(op.args[0])
        idx = op.args[1]
        masked = op.opcode == O.INDEX_MASKED
        if not masked and bp.value.vid not in self.stored and self.inline(
                out, lambda l: self.elem_at(bp, idx, l), op.args[1:]):
            return
        n = self.declare(out)
        L = out.ty.line
        zero = self.lit_storage(0, out.ty.elem)
        m = self.cval(op.args[2], bool_) if masked else None
        if L > 1:
            src = self.elem_at(bp, idx, "l")
            rhs = f"({m}) ? {src} : {zero}" if masked else src
            self.emit(f"for (int l = 0; l < {L}; ++l) {n}[l] = {rhs};")
        else:
            src = self.elem_at(bp, idx, "0")
            rhs = f"({m}) ? {src} : {zero}" if masked else src
            self.emit(f"{n} = {rhs};")

    def line_reduce(self, inst) -> None:
        op = inst.op
        oc = op.opcode
        out = inst.out
        elem = out.ty.elem
        ct = _compute(elem)
        x = op.args[0]
        L = x.ty.line
        n = self.declare(out)
        y = op.args[1] if oc == O.DOT else None

        def term(l):
            t = self.cval(x, elem, l if L > 1 else None)
            if y is not None:
                t = f"{t} * {self.cval(y, elem, l if y.ty.line > 1 else None)}"
            return t

        comb = {O.VEC_SUM: "acc + t", O.DOT: "acc + t",
                O.VEC_MAX: "cc_max(acc, t)", O.VEC_MIN: "cc_min(acc, t)"}[oc]
        self.open("")
        self.emit(f"{ct} acc = {term('0')};")
        self.open(f"for (int l = 1; l < {L}; ++l)")
        self.emit(f"const {ct} t = {term('l')};")
        self.emit(f"acc = {comb};")
        self.close()
        self.emit(f"{n} = {self.store_as('acc', elem)};")
        self.close()

    def plane(self, inst) -> None:
        op = inst.op
        oc = op.opcode
        out = inst.out
        P, mask = self.P, self.plane_mask()
        if self.U % P or P & (P - 1):
            raise unsupported(f"{oc} on a plane of {P} lanes in a cube of "
                              f"{self.U} units", _BACKEND)
        if oc == O.PLANE_ELECT:
            n = self.declare(out)
            self.emit(f"{n} = (unit_pos_plane == 0);")
            return
        if oc not in _PLANE_RED and oc not in (
                O.PLANE_ALL, O.PLANE_ANY, O.PLANE_BROADCAST,
                O.PLANE_SHUFFLE, O.PLANE_SHUFFLE_XOR, O.PLANE_SHUFFLE_UP,
                O.PLANE_SHUFFLE_DOWN):
            raise unsupported(oc, _BACKEND)
        x = op.args[0]
        elem = out.ty.elem
        ct, sh = _compute(elem), _shfl_type(elem)
        n = self.declare(out)
        L = out.ty.line
        self.open(f"for (int l = 0; l < {L}; ++l)" if L > 1 else "")
        lx = "l" if x.ty.line > 1 else None
        dst = f"{n}[l]" if L > 1 else n
        if oc in (O.PLANE_ALL, O.PLANE_ANY):
            fn = "__all_sync" if oc == O.PLANE_ALL else "__any_sync"
            self.emit(f"{dst} = {fn}({mask}, {self.cval(x, elem, lx)});")
        elif oc in _PLANE_RED:
            self.emit(f"{ct} acc = {self.cval(x, elem, lx)};")
            step = _PLANE_RED[oc].format(
                a="acc", b=f"({ct})__shfl_xor_sync({mask}, ({sh})acc, o, {P})")
            self.emit(f"for (int o = {P // 2}; o > 0; o >>= 1) acc = {step};")
            self.emit(f"{dst} = {self.store_as('acc', elem)};")
        else:
            fn = {O.PLANE_BROADCAST: "__shfl_sync",
                  O.PLANE_SHUFFLE: "__shfl_sync",
                  O.PLANE_SHUFFLE_XOR: "__shfl_xor_sync",
                  O.PLANE_SHUFFLE_UP: "__shfl_up_sync",
                  O.PLANE_SHUFFLE_DOWN: "__shfl_down_sync"}[oc]
            lane = self.cval(op.args[1], i32 if oc in (
                O.PLANE_BROADCAST, O.PLANE_SHUFFLE, O.PLANE_SHUFFLE_XOR)
                else u32)
            got = f"({ct})({fn}({mask}, ({sh})({self.cval(x, elem, lx)}), " \
                  f"{lane}, {P}))"
            self.emit(f"{dst} = {self.store_as(got, elem)};")
        self.close()


def _writebacks(body: Scope) -> list:
    """(mut, value) of the loop-carry writebacks at the end of ``body``."""
    return [(i.out, i.op.args[0]) for i in body.instructions
            if i.op.opcode == O.COPY and i.op.attrs.get("carry_writeback")]


def _promote(a: ElemType, b: ElemType) -> ElemType:
    """The common type of a comparison, as ``torch.promote_types``."""
    if a == b:
        return a
    import torch

    return elem_from_dtype(torch.promote_types(a.torch_dtype(),
                                               b.torch_dtype()))


def kernel_symbol(defn: KernelDefinition, digest: str) -> str:
    """A C identifier for the kernel: its name and its id's digest."""
    base = "".join(c if c.isalnum() else "_" for c in defn.options.name)
    return f"{base}_{digest[:12]}"


def print_kernel(defn: KernelDefinition, symbol: str) -> str:
    """CUDA C++ of an optimized definition: the ``__global__`` function
    and an ``extern "C"`` launcher ``cubecl_launch(gx, gy, gz, stream,
    args)`` that returns ``cudaGetLastError()``."""
    body = _Printer(defn, symbol).print_kernel()
    ux, uy, uz = defn.cube_dim
    return body + f"""
extern "C" int cubecl_launch(unsigned gx, unsigned gy, unsigned gz,
                             void* stream, void** args) {{
  cudaError_t e = cudaLaunchKernel((const void*){symbol}, dim3(gx, gy, gz),
                                   dim3({ux}, {uy}, {uz}), args, 0,
                                   (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}}

extern "C" const char* cubecl_error_string(int code) {{
  return cudaGetErrorString((cudaError_t)code);
}}
"""


def cuda_source(defn: KernelDefinition, kernel_id: str = "") -> str:
    """Optimize ``defn`` (in place) and print its CUDA C++; no nvcc."""
    prepare_scope(defn)
    from .build import digest

    symbol = kernel_symbol(defn, kernel_id or digest(repr(defn.scope)))
    return print_kernel(defn, symbol)


class CudaCompiler(Compiler):
    """K0 for CUDA: optimize, print, build with nvcc (asynchronously: the
    returned kernel waits for its build at its first launch, so a caller
    may compile many kernels before it launches any, and their nvcc
    processes run together)."""

    name = "cuda"

    def compile(self, defn: KernelDefinition,
                kernel_id: str = "") -> CompiledKernel:
        from . import build

        src = cuda_source(defn, kernel_id)
        job = build.start(src, kernel_symbol(defn, kernel_id or build.digest(
            repr(defn.scope))))
        st = defn.state
        mut = [i for i, bp in enumerate(st.buffers) if bp.mutable]
        launcher = build.Launcher(job, defn)
        return CompiledKernel(fn=launcher, mutable_indices=mut, source=src,
                              name=defn.options.name)
