"""Operation set of the cubecl-tpu IR.

One flat opcode space namespaced by category, mirroring the reference's
nested ``Operation`` enum (cubecl-ir/src/operation.rs:29-90) with the
category files arithmetic.rs / comparison.rs / bitwise.rs / operator.rs /
memory.rs / metadata.rs / branch.rs / plane.rs / cmma.rs / atomic.rs /
barrier.rs / synchronization.rs / non_semantic.rs.

Representation is deliberately uniform — ``Operation(opcode, args, attrs)``
— so passes are table-driven (the reference gets the same property from its
``OperationReflect`` derive, cubecl-ir/src/reflect.rs). ``args`` are IR
``Value``s; ``attrs`` carry comptime payloads (child scopes for structured
control flow, unroll flags, matrix descriptors, …).

Structured control flow keeps child scopes inline (If/Else/RangeLoop bodies
are ``Scope`` objects in attrs) — the same choice the reference optimizer
makes by preserving merge blocks (cubecl-opt/src/control_flow.rs:16-55),
because neither the Pallas target nor the evaluator has a goto (the CUDA
printer emits the same structure as C control flow).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from .value import Value

# ---------------------------------------------------------------------------
# Opcode registry with semantic metadata
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpInfo:
    opcode: str
    arity: int  # -1 = variadic
    commutative: bool = False
    pure: bool = True
    # python evaluator for const folding (reference const-eval pass,
    # cubecl-core/src/post_processing/mod.rs:27)
    py: Any = None


OPS: Dict[str, OpInfo] = {}


def _op(opcode: str, arity: int, commutative: bool = False, pure: bool = True, py=None):
    OPS[opcode] = OpInfo(opcode, arity, commutative, pure, py)
    return opcode


def _erf(x: float) -> float:
    return math.erf(x)


# --- arithmetic (reference arithmetic.rs:11-72) ----------------------------
ADD = _op("arith.add", 2, True, py=lambda a, b: a + b)
SUB = _op("arith.sub", 2, py=lambda a, b: a - b)
MUL = _op("arith.mul", 2, True, py=lambda a, b: a * b)
DIV = _op("arith.div", 2, py=lambda a, b: a / b if isinstance(a, float) or isinstance(b, float) else a // b)
FLOORDIV = _op("arith.floordiv", 2, py=lambda a, b: a // b)
MOD = _op("arith.mod", 2, py=lambda a, b: a % b)
REM = _op("arith.rem", 2, py=lambda a, b: math.fmod(a, b) if isinstance(a, float) else int(math.fmod(a, b)))
NEG = _op("arith.neg", 1, py=lambda a: -a)
ABS = _op("arith.abs", 1, py=abs)
MAX = _op("arith.max", 2, True, py=max)
MIN = _op("arith.min", 2, True, py=min)
CLAMP = _op("arith.clamp", 3, py=lambda x, lo, hi: min(max(x, lo), hi))
FMA = _op("arith.fma", 3, py=lambda a, b, c: a * b + c)
POW = _op("arith.pow", 2, py=lambda a, b: a ** b)
EXP = _op("arith.exp", 1, py=math.exp)
EXP2 = _op("arith.exp2", 1, py=lambda a: 2.0 ** a)
LOG = _op("arith.log", 1, py=math.log)
LOG2 = _op("arith.log2", 1, py=math.log2)
LOG1P = _op("arith.log1p", 1, py=math.log1p)
SQRT = _op("arith.sqrt", 1, py=math.sqrt)
RSQRT = _op("arith.rsqrt", 1, py=lambda a: 1.0 / math.sqrt(a))
RECIP = _op("arith.recip", 1, py=lambda a: 1.0 / a)
SIN = _op("arith.sin", 1, py=math.sin)
COS = _op("arith.cos", 1, py=math.cos)
TAN = _op("arith.tan", 1, py=math.tan)
ASIN = _op("arith.asin", 1, py=math.asin)
ACOS = _op("arith.acos", 1, py=math.acos)
ATAN = _op("arith.atan", 1, py=math.atan)
ATAN2 = _op("arith.atan2", 2, py=math.atan2)
SINH = _op("arith.sinh", 1, py=math.sinh)
COSH = _op("arith.cosh", 1, py=math.cosh)
TANH = _op("arith.tanh", 1, py=math.tanh)
ERF = _op("arith.erf", 1, py=_erf)
FLOOR = _op("arith.floor", 1, py=math.floor)
CEIL = _op("arith.ceil", 1, py=math.ceil)
ROUND = _op("arith.round", 1, py=lambda a: float(round(a)))
TRUNC = _op("arith.trunc", 1, py=math.trunc)
SIGN = _op("arith.sign", 1, py=lambda a: (a > 0) - (a < 0))
DOT = _op("arith.dot", 2)          # line-wise dot product (VectorSum of mul)
MULHI = _op("arith.mulhi", 2)      # high bits of widening multiply
SAT_ADD = _op("arith.sat_add", 2, True)
SAT_SUB = _op("arith.sat_sub", 2)
IS_NAN = _op("arith.is_nan", 1, py=lambda a: a != a)
IS_INF = _op("arith.is_inf", 1, py=math.isinf)

# --- comparison (comparison.rs) -------------------------------------------
EQ = _op("cmp.eq", 2, True, py=lambda a, b: a == b)
NE = _op("cmp.ne", 2, True, py=lambda a, b: a != b)
LT = _op("cmp.lt", 2, py=lambda a, b: a < b)
LE = _op("cmp.le", 2, py=lambda a, b: a <= b)
GT = _op("cmp.gt", 2, py=lambda a, b: a > b)
GE = _op("cmp.ge", 2, py=lambda a, b: a >= b)

# --- bitwise (bitwise.rs) ---------------------------------------------------
BAND = _op("bit.and", 2, True, py=lambda a, b: a & b)
BOR = _op("bit.or", 2, True, py=lambda a, b: a | b)
BXOR = _op("bit.xor", 2, True, py=lambda a, b: a ^ b)
BNOT = _op("bit.not", 1, py=lambda a: ~a)
SHL = _op("bit.shl", 2, py=lambda a, b: a << b)
SHR = _op("bit.shr", 2, py=lambda a, b: a >> b)
POPCOUNT = _op("bit.popcount", 1, py=lambda a: bin(a & 0xFFFFFFFF).count("1"))
CLZ = _op("bit.clz", 1)
FFS = _op("bit.ffs", 1)
BITREV = _op("bit.reverse", 1)

# --- logical / operator (operator.rs:13-37) --------------------------------
AND = _op("op.and", 2, True, py=lambda a, b: a and b)
OR = _op("op.or", 2, True, py=lambda a, b: a or b)
NOT = _op("op.not", 1, py=lambda a: not a)
CAST = _op("op.cast", 1)           # attrs: to (Type)
REINTERPRET = _op("op.reinterpret", 1)  # bitcast; attrs: to
SELECT = _op("op.select", 3)       # cond, then, else
VEC_INIT = _op("op.vec_init", -1)  # build a line from scalars
VEC_SPLAT = _op("op.vec_splat", 1)  # broadcast scalar to line
VEC_EXTRACT = _op("op.vec_extract", 2)  # line, index
VEC_INSERT = _op("op.vec_insert", 3)    # line, index, value
VEC_SUM = _op("op.vec_sum", 1)     # horizontal sum of a line
VEC_MAX = _op("op.vec_max", 1)
VEC_MIN = _op("op.vec_min", 1)
COPY = _op("op.copy", 1)           # plain assignment

# --- memory (memory.rs:11-17) ----------------------------------------------
INDEX = _op("mem.index", 2, pure=True)    # buffer, index -> value (load)
STORE = _op("mem.store", 3, pure=False)   # buffer, index, value
INDEX_MASKED = _op("mem.index_masked", 3, pure=True)   # buffer, index, mask (checked read)
STORE_MASKED = _op("mem.store_masked", 4, pure=False)  # buffer, index, value, mask
COPY_MEMORY = _op("mem.copy", -1, pure=False)
# JAX-package extension (the cube-scope analogue of op.vec_sum): reduce
# `lines` whole lines of a buffer from a cube-uniform line index in one
# block op. attrs: kind ("sum"|"max"|"min"|"prod"), lines (comptime int).
# The CUDA printer does not lower it yet.
BLOCK_REDUCE = _op("mem.block_reduce", 2, pure=True)  # buffer, start_line
SLICE = _op("mem.slice", 3, pure=True)    # buffer, start, end -> buffer view
BUFFER_LEN = _op("meta.buffer_len", 1)    # length in lines (a kernel argument on CUDA)

# --- metadata (metadata.rs:12-31) ------------------------------------------
SHAPE_DIM = _op("meta.shape", 1)   # attrs: dim
STRIDE_DIM = _op("meta.stride", 1)  # attrs: dim
RANK = _op("meta.rank", 1)

# --- plane / warp ops (plane.rs:16-41) --------------------------------------
PLANE_SUM = _op("plane.sum", 1)
PLANE_PROD = _op("plane.prod", 1)
PLANE_MAX = _op("plane.max", 1)
PLANE_MIN = _op("plane.min", 1)
PLANE_ALL = _op("plane.all", 1)
PLANE_ANY = _op("plane.any", 1)
PLANE_ELECT = _op("plane.elect", 0)
PLANE_BALLOT = _op("plane.ballot", 1)
PLANE_BROADCAST = _op("plane.broadcast", 2)  # value, src_lane
PLANE_SHUFFLE = _op("plane.shuffle", 2)
PLANE_SHUFFLE_XOR = _op("plane.shuffle_xor", 2)
PLANE_SHUFFLE_UP = _op("plane.shuffle_up", 2)
PLANE_SHUFFLE_DOWN = _op("plane.shuffle_down", 2)
PLANE_INCLUSIVE_SUM = _op("plane.inclusive_sum", 1)
PLANE_EXCLUSIVE_SUM = _op("plane.exclusive_sum", 1)
PLANE_INCLUSIVE_PROD = _op("plane.inclusive_prod", 1)
PLANE_EXCLUSIVE_PROD = _op("plane.exclusive_prod", 1)

# --- cmma / MXU (cmma.rs:13-81) ---------------------------------------------
MMA_FILL = _op("mma.fill", 2, pure=False)       # matrix, value
MMA_LOAD = _op("mma.load", -1, pure=False)      # matrix, buffer, offset[, stride]
MMA_STORE = _op("mma.store", -1, pure=False)    # matrix, buffer, offset[, stride]
MMA_EXECUTE = _op("mma.execute", 4, pure=False)  # a, b, c, d(out acc)
MMA_EXECUTE_SCALED = _op("mma.execute_scaled", 6, pure=False)
MMA_CAST = _op("mma.cast", 2, pure=False)

# --- atomics (atomic.rs:11-50); lowered sequentially-consistent -------------
ATOMIC_LOAD = _op("atomic.load", 2, pure=False)
ATOMIC_STORE = _op("atomic.store", 3, pure=False)
ATOMIC_SWAP = _op("atomic.swap", 3, pure=False)
ATOMIC_CAS = _op("atomic.cas", 4, pure=False)
ATOMIC_ADD = _op("atomic.add", 3, pure=False)
ATOMIC_SUB = _op("atomic.sub", 3, pure=False)
ATOMIC_MAX = _op("atomic.max", 3, pure=False)
ATOMIC_MIN = _op("atomic.min", 3, pure=False)
ATOMIC_AND = _op("atomic.and", 3, pure=False)
ATOMIC_OR = _op("atomic.or", 3, pure=False)
ATOMIC_XOR = _op("atomic.xor", 3, pure=False)

# --- synchronization / barrier (synchronization.rs, barrier.rs) -------------
SYNC_CUBE = _op("sync.cube", 0, pure=False)
SYNC_PLANE = _op("sync.plane", 0, pure=False)
SYNC_STORAGE = _op("sync.storage", 0, pure=False)
BARRIER_INIT = _op("barrier.init", 1, pure=False)
BARRIER_ARRIVE = _op("barrier.arrive", 1, pure=False)
BARRIER_WAIT = _op("barrier.wait", 1, pure=False)
MEMCPY_ASYNC = _op("barrier.memcpy_async", -1, pure=False)

# --- control flow (branch.rs:14-137); child scopes in attrs -----------------
IF = _op("branch.if", 1, pure=False)          # attrs: then (Scope)
IF_ELSE = _op("branch.if_else", 1, pure=False)  # attrs: then, orelse
SWITCH = _op("branch.switch", 1, pure=False)  # attrs: cases [(const, Scope)], default
RANGE_LOOP = _op("branch.range", 3, pure=False)  # start, stop, step; attrs: var, body, unroll, inclusive
WHILE = _op("branch.while", 0, pure=False)    # attrs: cond_scope, cond_value, body
LOOP = _op("branch.loop", 0, pure=False)      # attrs: body
BREAK = _op("branch.break", 0, pure=False)
CONTINUE = _op("branch.continue", 0, pure=False)
RETURN = _op("branch.return", -1, pure=False)
TERMINATE = _op("branch.terminate", 0, pure=False)

# --- non-semantic (non_semantic.rs) ------------------------------------------
COMMENT = _op("debug.comment", 0, pure=False)  # attrs: text
PRINT = _op("debug.print", -1, pure=False)     # attrs: fmt

# --- phi-ish: value merge emitted by the tracer at control-flow joins --------
PHI = _op("ssa.phi", -1)


# ---------------------------------------------------------------------------


@dataclass
class Operation:
    opcode: str
    args: Tuple[Value, ...] = ()
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def info(self) -> OpInfo:
        return OPS[self.opcode]

    def __repr__(self) -> str:
        a = ", ".join(map(repr, self.args))
        extra = f" {self.attrs}" if self.attrs else ""
        return f"{self.opcode}({a}){extra}"


@dataclass
class Instruction:
    """out = operation(args)  (reference Instruction, operation.rs:95).

    ``modes`` carries fast-math flags (reference InstructionModes,
    scope.rs:100) — consumed by the backends to pick approximate lowerings.
    """

    out: Optional[Value]
    op: Operation
    modes: Dict[str, Any] = field(default_factory=dict)
    source_loc: Optional[str] = None

    def __repr__(self) -> str:
        if self.out is None:
            return repr(self.op)
        return f"{self.out!r} = {self.op!r}"
