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
  (no fast-math flag of the IR selects the ``__expf`` intrinsics yet);
- cmma (``mma.*``): a fragment is cube-scope, one whole tile per cube, as
  in the JAX package (``frontend/cmma.py``), not CUDA's warp-scope
  ``wmma``. Two routes, chosen from the definition
  (:func:`tensor_core_plan`); neither falls back at run time:

  - FMA (int8, ``execute_scaled``, shapes the tensor cores do not tile,
    and f32 operand fragments that are filled, stored, cast or
    accumulated into): each ``Matrix`` is a row-major region of the
    kernel's dynamic shared memory, its offset fixed at print time
    (``fragment_layout``). ``fill``, ``load`` (row- or col-major, the
    ``load_tensor`` form included: offsets and strides are in elements)
    and ``store`` are cube-cooperative strided loops, ``execute`` a
    cube-cooperative product in which each thread owns output elements
    and sums over K in the accumulator's compute type (f32 FMA for float
    fragments; int32 for int8), then adds C. ``execute_scaled`` scales
    the operands first, as the JAX evaluator does; ``cast`` converts
    element by element;
  - tensor cores (``mapping=cmma-wgmma``: every ``execute`` on bf16 or
    f16 operands with f32 C and D, M, N and K multiples of 64, a cube of
    whole warpgroups): the operand fragments are 64-column panels of rows
    x 128 bytes with the 128-byte swizzle (``cc_sw``), 1024-byte
    aligned, which SS ``wgmma`` m64nNk16 reads through the descriptors of
    ``csrc/wgmma_gemm.cuh`` (A K-major, B MN-major by the transpose bit);
    ``load`` moves 16 bytes a thread where the source is aligned (single
    elements otherwise) and fences its writes for the async proxy. An
    accumulator that only ``fill``, ``execute`` with C = D, ``store`` and
    ``cast`` (as the source) touch lives in registers: each warpgroup
    owns m64 x nc units of it (64-row bands x N chunks of 256, 128 or
    64) in ``wgmma``'s layout, and ``execute`` issues the units'
    ``wgmma``s over K, then ``wgmma.wait_group 0``; any other accumulator
    stays in shared memory, its C read into registers and D written
    back. A ``RangeLoop`` whose body loads two operand fragments and ends
    with their ``execute`` (:func:`canonical_k_loop`), when nothing else
    touches those two, runs on a ring of two stages of them: step i + 1's
    copies (cp.async) are issued before step i's products. The launch's
    shared memory counts only the fragments in shared memory (and 1024
    bytes that align the base);
  - f32 on the tensor cores (``mapping=cmma-wgmma-tf32x3``: the same
    conditions with f32 operands and K a multiple of 32): three TF32
    products a k8 step, A_small B_big + A_big B_small + A_big B_big into
    the f32 accumulator, each operand split into big = x truncated to
    tf32 and small = tf32(x - big), which drops only A_small B_small (at
    most 2^-20 of a product; one TF32 product would miss f32's 2e-5 / 1e-4, as the JAX
    evaluator runs f32 at ``Precision.HIGHEST``). TF32 ``wgmma`` has no
    transpose bit, so both operands are K-major: 32-column panels of K
    (``cc_sw32``), B transposed on its way in, each fragment a big and a
    small half that ``load`` writes (the halves go through registers, so
    the K loop's ring is filled by loads, splits and stores issued while
    the previous step's products run, not by cp.async); SS ``wgmma``
    m64nNk8 reads each half through its own descriptor. The tensor
    cores' f32 sums round toward zero, so an ``execute`` sums its
    products from zero in wgmma accumulators of its own and adds them to
    C by ordinary f32 additions (a register accumulator holds at most 64
    values a thread, the products' sums as many beside it).

  The launcher opts in above 48 KiB, and fragments over the 227 KiB a
  block may use raise, naming the kernel and the bytes. Every fragment op
  sits between ``__syncthreads()``, so it must run in cube-uniform
  control flow, as the JAX package requires too;
- ``mem.block_reduce`` (``Slice.block_sum`` and its kin) is
  cube-cooperative too: the threads stride over the window's elements,
  neighbouring threads on neighbouring addresses, accumulating in f32 for
  sub-f32 sums and products; a ``__shfl_xor_sync`` butterfly folds each
  plane and a static ``__shared__`` array of one value per plane folds the
  planes, between ``__syncthreads()``, so that every unit holds the
  result. Its start must be cube-uniform and its control flow too;
- ``op.reinterpret`` is a bit copy (``memcpy``) of the value's storage,
  the line absorbing the width ratio;
- a shared array (``SharedMemory``) is a static ``__shared__`` array of
  its lines (16-byte aligned, at most 48 KiB a kernel), each block its
  own; loads and stores index it as a buffer, and its loads are kept in
  registers, never re-read by an inlined expression. A kernel with one
  keeps one thread a unit.

Warp lines. A kernel whose lines are all wide runs each unit on a warp
instead of a thread (``mapping=warp-lines`` in the printed comment), so
that a warp's loads are 32 neighbouring 16-byte chunks instead of 32 rows
a row apart. :func:`warp_vector` decides it from the definition alone: V
= 16 bytes / the storage bytes of the narrowest buffer with lines (4 for
f32, 8 for bf16/f16), and the kernel qualifies when every line value has
at least 32·V elements and it has no shared array, ``plane.*``, ``sync.*``,
``mem.block_reduce``, ``mma.*``, atomic or ``op.reinterpret`` op, reads no
``UNIT_POS_PLANE``/``PLANE_POS``/``PLANE_DIM`` and takes or sets no single
element of a line (``vec_extract``/``vec_insert``/``vec_init``). Then:

- ``blockDim.x`` is units × 32 (over 1024 raises ``ValueError``),
  ``unit_pos = threadIdx.x >> 5`` and ``lane = threadIdx.x & 31``; every
  unit-level builtin keeps its value, so the body's indexing and the
  launch's cube count and dim do not change;
- scalars and control flow are computed by the 32 lanes redundantly:
  they are uniform across them, so branches do not diverge;
- each loop over a line's elements runs over the lane's share only: lane
  ``lane`` owns the chunks of V contiguous elements ``(k·32 + lane)·V +
  j``, and a per-thread line array holds ``L / 32`` elements (its local
  index ``k·V + j``);
- where ``L % (32·V) == 0`` a loop moves each chunk as 16-byte loads and
  stores (``uint4``) when every such buffer is 16-byte aligned
  (``cc_aligned``, uniform over the launch), and element by element in
  the other branch of the same kernel; other lines are walked element by
  element, past ``L`` skipped;
- a line reduction folds the lane's share in the compute type (f32 for
  sub-f32 floats), then the warp with a ``__shfl_xor_sync`` butterfly, so
  every lane holds the row's value; a store writes the lane's elements
  only.

Every other kernel keeps the mapping above, one thread per unit: a line
is walked by one thread, element by element, once per reduction and once
for the store (the 8-unit ``*_rows`` kernels with ``plane_sum``, the
reductions, cmma on either route, quant, gelu's 4-element lines).

Ops this printer does not lower raise ``NotImplementedError`` naming the
op (``backend.compiler.unsupported``): atomics, ``mem.slice``,
per-unit arrays, barriers and ``memcpy_async``, plane scans
and ballots, the saturating, ``mulhi`` and bit-counting ops,
``debug.print``, and a runtime grid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from ...ir import ops as O
from ...ir.features import WARP
from ...ir.scope import Scope, walk
from ...ir.types import ElemType, bool_, elem_from_dtype, i32, i64, u32
from ...ir.value import Builtin, Value, VarKind
from ..compiler import (CompiledKernel, Compiler,
                        KernelDefinition, fragment_layout, prepare_scope,
                        unsupported)

_BACKEND = "the CUDA printer"
MAX_SMEM = 227 * 1024  # dynamic shared memory a block may use (sm_90)
MAX_STATIC_SMEM = 48 * 1024  # static shared memory a block may declare

# longest per-element expression a line value is inlined as (longer ones
# are materialized in an array, so that nesting cannot blow up the source)
_INLINE_LIMIT = 600

# accumulators (and loads in flight) per thread of a block reduction
_BR_ACC = 8

# warp lines: lanes of a warp, the bytes of a chunk a lane moves at once,
# and the most threads a block may have
LANES = 32
_CHUNK = 16
MAX_THREADS = 1024
# a line loop over this many chunks a lane or fewer is unrolled; a longer
# one is left to nvcc (unrolled in full, a long chain such as gelu's
# backward holds every chunk's loads in registers and runs slower)
_UNROLL_CHUNKS = 4
# what a warp-lined kernel may not hold: ops by prefix and by name, and
# the plane builtins (read before the passes fold PLANE_DIM)
_WARP_EXCLUDED_PREFIXES = ("plane.", "sync.", "mma.", "atomic.", "barrier.")
_WARP_EXCLUDED_OPS = frozenset({O.BLOCK_REDUCE, O.REINTERPRET,
                                O.VEC_EXTRACT, O.VEC_INSERT, O.VEC_INIT})
_PLANE_BUILTINS = frozenset({Builtin.UNIT_POS_PLANE, Builtin.PLANE_POS,
                             Builtin.PLANE_DIM})

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


# the tensor-core route's own: the PTX helpers of csrc/ (descriptors,
# fences, wgmma, the tf32 split; build.py passes the include path) and the
# index of element (r, c) of an operand fragment stored with R rows: a
# 16-bit one in 64-column panels of R x 128 bytes (cc_sw), an f32 one in
# 32-column panels (cc_sw32), as a wgmma descriptor with the 128-byte
# swizzle reads them (the 16-byte chunks of row r XOR-permuted by r % 8)
TC_PRELUDE = r"""#include "wgmma_gemm.cuh"

__device__ __forceinline__ int cc_sw(int r, int c, int R) {
  return (c >> 6) * (R * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}
__device__ __forceinline__ int cc_sw32(int r, int c, int R) {
  return (c >> 5) * (R * 32) + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2) +
         (c & 3);
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
    def __init__(self, defn: KernelDefinition, kernel_name: str,
                 vec: int = 0):
        self.defn = defn
        self.name = kernel_name
        st = defn.state
        self.U = math.prod(defn.cube_dim)
        self.P = defn.plane_dim
        # warp lines: V elements a chunk (0: a unit is a thread)
        self.V = vec
        self.threads = self.U * LANES if vec else self.U
        # the vector form of a line loop being printed: its 16-byte chunks,
        # {(buffer vid, index, stored): name}; None outside such a loop
        self.chunks: Optional[Dict[tuple, str]] = None
        # set while inline() measures an expression: buffers print as
        # under one thread a unit, so both mappings inline alike
        self.measuring = False
        self.lines: List[str] = []
        self.depth = 1
        self.buffers = {bp.value.vid: bp for bp in st.buffers}
        self.shareds = {sd.value.vid: sd for sd in st.shareds}
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
        self.stored |= {i.op.args[1].vid for _s, i in walk(defn.scope)
                        if i.op.opcode == O.MMA_STORE}
        # the cmma route: None (FMA) or where the tensor-core route keeps
        # each fragment
        self.tc = tensor_core_plan(defn)
        # in the pipelined K loop: the stage pointer of each ring fragment
        self.stage_ptrs: Dict[int, str] = {}
        if self.tc is not None:
            self.frag_offsets = self.tc.offsets
            self.smem_bytes = self.tc.smem_bytes
        else:
            self.frag_offsets, self.smem_bytes = fragment_layout(st)
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
        if v.kind == VarKind.SHARED:
            return f"sh{v.vid}"
        if v.kind in (VarKind.LOCAL, VarKind.LOCAL_MUT):
            return f"v{v.vid}"
        if v.kind == VarKind.MATRIX:
            return f"m{v.vid}"
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
        self.measuring = True
        try:
            n = len(elem_expr("l"))
        finally:
            self.measuring = False
        if n > _INLINE_LIMIT:
            return False
        self.exprs[v.vid] = elem_expr
        self.blocks[-1].add(v.vid)
        return True

    def declare(self, v: Value) -> str:
        """Declare ``v`` in the current block unless visible; returns its
        name."""
        n = self.name_of(v)
        if v.kind == VarKind.LOCAL and not self.visible(v):
            arr = f"[{self.local_len(v.ty.line)}]" if v.ty.line > 1 else ""
            self.emit(f"{_storage(v.ty.elem)} {n}{arr};")
            self.blocks[-1].add(v.vid)
        return n

    # ------------------------------------------------------------ kernel

    def print_kernel(self) -> str:
        d = self.defn
        st = d.state
        if d.dynamic_grid_vid is not None:
            raise unsupported("a runtime grid (CubeCount.runtime)", _BACKEND)
        if any(_per_unit(sd) for sd in st.shareds):
            raise unsupported("per-unit arrays", _BACKEND)
        shared_bytes = sum(sd.shape[0] * sd.ty.line * sd.ty.elem.size
                           for sd in st.shareds)
        if shared_bytes > MAX_STATIC_SMEM:
            raise ValueError(
                f"kernel {self.name}: its shared arrays need {shared_bytes} "
                f"bytes, over the {MAX_STATIC_SMEM} bytes of static shared "
                f"memory a block may declare")
        if self.smem_bytes > MAX_SMEM:
            raise ValueError(
                f"kernel {self.name}: its cmma fragments need "
                f"{self.smem_bytes} bytes of shared memory, over the "
                f"{MAX_SMEM} bytes a block may use")
        if self.threads > MAX_THREADS:
            raise ValueError(
                f"kernel {self.name}: warp lines give each of its {self.U} "
                f"units a warp, {self.threads} threads, over the "
                f"{MAX_THREADS} a block may have")
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
        mapping = f" mapping=warp-lines vector={self.V}" if self.V else ""
        tc = self.tc
        if tc is not None:
            route = "cmma-wgmma-tf32x3" if tc.split else "cmma-wgmma"
            mapping = (f" mapping={route} warpgroups={tc.warpgroups} "
                       f"register_accumulators={len(tc.regs)}")
        out = [PRELUDE + (TC_PRELUDE if tc is not None else ""),
               f"// {self.name}: cube_dim={d.cube_dim} "
               f"cube_count={d.cube_count} plane={self.P} "
               f"checked={d.options.checked}{mapping}",
               f"extern \"C\" __global__ void __launch_bounds__"
               f"({self.threads}) {self.name}(",
               "    " + ",\n    ".join(params) + ") {"]
        if self.V:
            # a unit is a warp: the block is units x 32 threads in x
            builtins = [
                "const int32_t lane = threadIdx.x & 31, unit_pos = "
                "threadIdx.x >> 5;",
                f"const int32_t unit_pos_x = unit_pos % {ux}, unit_pos_y = "
                f"unit_pos / {ux} % {uy}, unit_pos_z = unit_pos / "
                f"{ux * uy};"]
        else:
            builtins = [
                f"const int32_t unit_pos_x = threadIdx.x, unit_pos_y = "
                f"threadIdx.y, unit_pos_z = threadIdx.z;",
                f"const int32_t unit_pos = unit_pos_x + unit_pos_y * {ux} + "
                f"unit_pos_z * {ux * uy};"]
        builtins += [
            "const int32_t cube_pos_x = blockIdx.x, cube_pos_y = "
            "blockIdx.y, cube_pos_z = blockIdx.z;",
            f"const int32_t cube_pos = cube_pos_x + cube_pos_y * {cx} + "
            f"cube_pos_z * {cx * cy};",
            f"const int32_t absolute_pos = cube_pos * {self.U} + unit_pos;",
            f"const int32_t absolute_pos_x = cube_pos_x * {ux} + unit_pos_x;",
            f"const int32_t absolute_pos_y = cube_pos_y * {uy} + unit_pos_y;",
            f"const int32_t absolute_pos_z = cube_pos_z * {uz} + unit_pos_z;",
        ]
        if not self.V:
            builtins.append(f"const int32_t unit_pos_plane = unit_pos % "
                            f"{self.P}, plane_pos = unit_pos / {self.P};")
        for b in builtins:
            self.emit(b)
        vec_bufs = [f"reinterpret_cast<uintptr_t>(b{bp.value.vid})"
                    for bp in st.buffers if self.vector_form(bp.ty.line)]
        if vec_bufs:
            self.emit(f"const bool cc_aligned = (({' | '.join(vec_bufs)}) "
                      f"& {_CHUNK - 1}) == 0;")
        for sd in st.shareds:
            self.emit(f"__shared__ __align__(16) {_storage(sd.ty.elem)} "
                      f"{self.name_of(sd.value)}"
                      f"[{sd.shape[0] * sd.ty.line}];")
        if tc is not None:
            # the swizzled panels need a 1024-byte aligned base: the launch
            # gives 1024 bytes of slack
            self.emit("const int32_t cc_wg = unit_pos >> 7, cc_warp = "
                      "(unit_pos >> 5) & 3, cc_lane = unit_pos & 31;")
            self.emit("extern __shared__ __align__(16) unsigned char "
                      "cc_smem_raw[];")
            self.emit("unsigned char* const cc_smem = cc_smem_raw + ((1024 - "
                      "(cubecl::smem_addr(cc_smem_raw) & 1023)) & 1023);")
            for m in st.matrices:
                if m.vid in tc.regs:
                    r = tc.regs[m.vid]
                    self.emit(f"float cc_acc{m.vid}[{r.per_wg}][{r.nc // 2}];")
                    continue
                t = _storage(m.ty.elem)
                self.emit(f"{t}* const m{m.vid} = reinterpret_cast<{t}*>("
                          f"cc_smem + {self.frag_offsets[m.vid]});")
        elif st.matrices:
            self.emit("extern __shared__ __align__(16) unsigned char "
                      "cc_smem[];")
            for m in st.matrices:
                t = _storage(m.ty.elem)
                self.emit(f"{t}* const m{m.vid} = reinterpret_cast<{t}*>("
                          f"cc_smem + {self.frag_offsets[m.vid]});")
        # mutable locals may be first written inside a branch and read
        # after it: declare them all up front
        muts: Dict[int, Value] = {}
        for _s, inst in walk(d.scope):
            o = inst.out
            if o is not None and o.kind == VarKind.LOCAL_MUT:
                muts[o.vid] = o
        for m in muts.values():
            arr = f"[{self.local_len(m.ty.line)}]" if m.ty.line > 1 else ""
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
        elif oc.startswith("mma."):
            self.emit("__syncthreads();")
            self.open("")
            if self.tc is not None:
                self.mma_wgmma(inst)
            else:
                self.mma(inst)
            self.close()
            self.emit("__syncthreads();")
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
        if self.tc is not None and self.tc.rings:
            loop = canonical_k_loop(op, self.tc.swizzled)
            if loop is not None and loop[1].op.args[0].vid in self.tc.rings:
                self.pipelined_loop(inst, *loop)
                return
        var = op.attrs["var"]
        ct, n, s, st, cond = self.loop_bounds(op)
        self.loops.append(_writebacks(op.attrs["body"]))
        self.open(f"for ({ct} {n} = {s}; {cond(n)}; {n} += {st})")
        self.blocks[-1].add(var.vid)
        self.scope(op.attrs["body"])
        self.close()
        self.loops.pop()

    def loop_bounds(self, op):
        """A ``RangeLoop``'s (C type, variable name, start, step, and the
        condition on a value of the variable, as a function)."""
        start, stop, step = op.args
        var = op.attrs["var"]
        lt, gt = ("<=", ">=") if op.attrs.get("inclusive", False) \
            else ("<", ">")
        e = self.cval(stop, var.ty.elem)
        st = self.cval(step, var.ty.elem)

        def cond(x):
            if step.kind == VarKind.CONSTANT:
                return f"{x} {lt if step.const > 0 else gt} {e}"
            return f"({st} > 0) ? ({x} {lt} {e}) : ({x} {gt} {e})"

        return (_storage(var.ty.elem), f"v{var.vid}",
                self.cval(start, var.ty.elem), st, cond)

    def plane_mask(self) -> str:
        if self.P == WARP:
            return "0xffffffffu"
        return f"0x{(1 << self.P) - 1:x}u"

    # ------------------------------------------------------- warp lines

    def local_len(self, L: int) -> int:
        """Elements of a line of ``L`` a thread holds: all of them, or
        under warp lines its lane's chunks."""
        if not self.V:
            return L
        return -(-L // (LANES * self.V)) * self.V

    def vector_form(self, L: int) -> bool:
        """Are a line loop's chunks moved as 16-byte vectors?"""
        return bool(self.V) and L > 1 and L % (LANES * self.V) == 0

    def lane_elem(self, l: str) -> str:
        """The element of a line that local element ``l`` of a lane is."""
        V = self.V
        if V == 1:
            return f"({l}) * {LANES} + lane"
        return (f"(({l}) >> {V.bit_length() - 1}) * {LANES * V} + lane * {V}"
                f" + (({l}) & {V - 1})")

    def lane_loop(self, L: int, body: Callable[[str], List[str]],
                  vector: bool = True) -> None:
        """Under warp lines, the statements ``body(l)`` for each local
        element ``l`` of the lane's share of a line of ``L``: in the vector
        form (16-byte chunks) under ``cc_aligned`` and element by element
        in its other branch where ``L % (32·V) == 0`` (and ``vector``) and
        the statements touch a buffer, else element by element only."""
        chunks = None
        if vector and self.vector_form(L):
            self.chunks = {}
            try:
                stmts = body("l")
                chunks = self.chunks
            finally:
                self.chunks = None
        if chunks:
            self.open("if (cc_aligned)")
            self.vector_loop(L, stmts, chunks)
            self.close("} else {")
            self.depth += 1
            self.blocks.append(set())
            self.scalar_lane_loop(L, body)
            self.close()
        else:
            self.scalar_lane_loop(L, body)

    def scalar_lane_loop(self, L: int, body) -> None:
        n = self.local_len(L)
        if n <= _UNROLL_CHUNKS * self.V:
            self.emit("#pragma unroll")
        self.open(f"for (int l = 0; l < {n}; ++l)")
        if L % (LANES * self.V):
            self.emit(f"if ({self.lane_elem('l')} >= {L}) break;")
        for st in body("l"):
            self.emit(st)
        self.close()

    def vector_loop(self, L: int, stmts: List[str], chunks) -> None:
        """Chunk k of the lane: its loads (``chunks``) as ``uint4``s into
        registers, the V elements' statements, then its stores as
        ``uint4``s."""
        V = self.V
        K = L // (LANES * V)
        if K <= _UNROLL_CHUNKS:
            self.emit("#pragma unroll")
        self.open(f"for (int k = 0; k < {K}; ++k)")
        self.emit(f"const int64_t cc_e = (int64_t)(k * {LANES} + lane) * {V};")

        def at(vid, i):
            return f"b{vid} + {i} * {L} + cc_e"

        for (vid, i, stored), name in chunks.items():
            bp = self.buffers[vid]
            t = _storage(bp.ty.elem)
            nq = V * bp.ty.elem.size // _CHUNK
            self.emit(f"uint4 {name}_u[{nq}];")
            if stored:
                self.emit(f"{t}* {name} = reinterpret_cast<{t}*>({name}_u);")
                continue
            for q in range(nq):
                self.emit(f"{name}_u[{q}] = reinterpret_cast<const uint4*>("
                          f"{at(vid, i)})[{q}];")
            self.emit(f"const {t}* {name} = reinterpret_cast<const {t}*>("
                      f"{name}_u);")
        self.emit("#pragma unroll")
        self.open(f"for (int j = 0; j < {V}; ++j)")
        self.emit(f"const int l = k * {V} + j;")
        for st in stmts:
            self.emit(st)
        self.close()
        for (vid, i, stored), name in chunks.items():
            if stored:
                for q in range(V * self.buffers[vid].ty.elem.size // _CHUNK):
                    self.emit(f"reinterpret_cast<uint4*>({at(vid, i)})[{q}] "
                              f"= {name}_u[{q}];")
        self.close()

    # ------------------------------------------------------------ memory

    def buffer(self, v: Value, shared: bool = False):
        """The parameter of buffer ``v``; ``shared``: or the declaration of
        shared array ``v`` (loads and stores index either alike)."""
        if shared and v.kind == VarKind.SHARED:
            return self.shareds[v.vid]
        if v.kind != VarKind.BUFFER:
            raise unsupported(f"{v.kind.value} memory", _BACKEND)
        return self.buffers[v.vid]

    def elem_at(self, bp, idx: Value, l: str, stored: bool = False) -> str:
        """Element ``l`` of line ``idx`` of a buffer; under warp lines
        ``l`` is the lane's local element (in a vector-form loop, element
        ``j`` of the chunk; ``stored``: the chunk to be stored)."""
        L = bp.ty.line
        i = self.cval(idx, i64)
        vid = bp.value.vid
        name = self.name_of(bp.value)
        if L == 1:
            return f"{name}[{i}]"
        if self.V and not self.measuring:
            if self.chunks is not None:
                key = (vid, i, stored)
                if key not in self.chunks:
                    self.chunks[key] = f"cc_{'s' if stored else 'c'}" \
                                       f"{len(self.chunks)}"
                return f"{self.chunks[key]}[j]"
            l = self.lane_elem(l)
        return f"{name}[{i} * {L} + {l}]"

    def store(self, inst) -> None:
        op = inst.op
        bp = self.buffer(op.args[0], shared=True)
        idx, val = op.args[1], op.args[2]
        L = bp.ty.line
        guarded = op.opcode == O.STORE_MASKED
        if guarded:
            self.open(f"if ({self.cval(op.args[3], bool_)})")
        elem = bp.ty.elem
        if L > 1 and self.V:
            self.lane_loop(L, lambda l: [
                f"{self.elem_at(bp, idx, l, stored=True)} = "
                f"{self.convert(val, elem, l if val.ty.line > 1 else None)};"])
        elif L > 1:
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
        if m.ty.line > 1 and self.V:
            self.lane_loop(m.ty.line, lambda l: [
                f"{n}[{l}] = "
                f"{self.convert(v, m.ty.elem, l if v.ty.line > 1 else None)};"])
        elif m.ty.line > 1:
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
        if oc == O.BLOCK_REDUCE:
            self.block_reduce(inst)
            return
        if oc == O.REINTERPRET:
            self.reinterpret(inst)
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
        if L > 1 and self.V:
            self.lane_loop(L, lambda l: [
                f"{n}[{l}] = {self.store_as(expr_of(l), elem)};"])
        elif L > 1:
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
        bp = self.buffer(op.args[0], shared=True)
        idx = op.args[1]
        masked = op.opcode == O.INDEX_MASKED
        if not masked and bp.value.vid not in self.stored and self.inline(
                out, lambda l: self.elem_at(bp, idx, l), op.args[1:]):
            return
        n = self.declare(out)
        L = out.ty.line
        zero = self.lit_storage(0, out.ty.elem)
        m = self.cval(op.args[2], bool_) if masked else None
        if L > 1 and self.V:
            # a masked line is read element by element: a chunk's vector
            # load would not wait for the mask
            self.lane_loop(L, lambda l: [
                f"{n}[{l}] = "
                + (f"({m}) ? {self.elem_at(bp, idx, l)} : {zero};" if masked
                   else f"{self.elem_at(bp, idx, l)};")], vector=not masked)
        elif L > 1:
            src = self.elem_at(bp, idx, "l")
            rhs = f"({m}) ? {src} : {zero}" if masked else src
            self.emit(f"for (int l = 0; l < {L}; ++l) {n}[l] = {rhs};")
        else:
            src = self.elem_at(bp, idx, "0")
            rhs = f"({m}) ? {src} : {zero}" if masked else src
            self.emit(f"{n} = {rhs};")

    def conv_expr(self, expr: str, src: ElemType, dst: ElemType,
                  storage: bool = True) -> str:
        """``expr`` (of ``src``'s storage type) in ``dst``'s storage type,
        or its compute type when ``storage`` is false."""
        if src == dst and storage:
            return expr
        e = _NARROW[src.name][0].format(expr) if src.name in _NARROW \
            else expr
        if _compute(src) != _compute(dst):
            e = f"(({_compute(dst)})({e}))"
        return self.store_as(e, dst) if storage else e

    def mma(self, inst) -> None:
        """One cube-cooperative fragment op (the thread loop strides the
        fragment's elements by the cube's units)."""
        op = inst.op
        oc = op.opcode
        args = op.args
        U = self.U
        mat = args[0]
        R, C = mat.shape
        me = mat.ty.elem
        loop = f"for (int i = unit_pos; i < {R * C}; i += {U})"
        if oc == O.MMA_FILL:
            self.emit(f"const {_storage(me)} fv = "
                      f"{self.convert(args[1], me, None)};")
            self.open(loop)
            self.emit(f"m{mat.vid}[i] = fv;")
            self.close()
        elif oc in (O.MMA_LOAD, O.MMA_STORE):
            buf, off, stride = args[1], args[2], args[3]
            bp = self.buffer(buf)
            be = bp.ty.elem
            self.emit(f"const int64_t off = {self.cval(off, i64)}, "
                      f"st = {self.cval(stride, i64)};")
            self.open(loop)
            self.emit(f"const int r = i / {C}, c = i % {C};")
            if op.attrs.get("layout", "row_major") == "row_major":
                g = f"b{bp.value.vid}[off + (int64_t)r * st + c]"
            else:
                g = f"b{bp.value.vid}[off + (int64_t)c * st + r]"
            if oc == O.MMA_LOAD:
                self.emit(f"m{mat.vid}[i] = {self.conv_expr(g, be, me)};")
            else:
                self.emit(f"{g} = {self.conv_expr(f'm{mat.vid}[i]', me, be)};")
            self.close()
        elif oc in (O.MMA_EXECUTE, O.MMA_EXECUTE_SCALED):
            a, b, c, d = args[:4]
            M, K = a.shape
            N = b.shape[1]
            de = d.ty.elem
            ct = _compute(de)
            ae, be_ = a.ty.elem, b.ty.elem
            if oc == O.MMA_EXECUTE_SCALED:
                self.emit(f"const {ct} sa = {self.cval(args[4], de)}, "
                          f"sb = {self.cval(args[5], de)};")
            self.open(f"for (int i = unit_pos; i < {M * N}; i += {U})")
            self.emit(f"const int r = i / {N}, c = i % {N};")
            self.emit(f"{ct} s = 0;")
            x = self.conv_expr(f"m{a.vid}[r * {K} + kk]", ae, de, False)
            y = self.conv_expr(f"m{b.vid}[kk * {N} + c]", be_, de, False)
            if oc == O.MMA_EXECUTE_SCALED:
                x, y = f"({x} * sa)", f"({y} * sb)"
            step = f"s = fmaf({x}, {y}, s);" if ct == "float" else \
                f"s += {x} * {y};"
            self.emit(f"for (int kk = 0; kk < {K}; ++kk) {step}")
            # the product rounds to the accumulator type, then adds C
            prod = self.conv_expr(self.store_as("s", de), de, de, False)
            cc = self.conv_expr(f"m{c.vid}[i]", c.ty.elem, de, False)
            self.emit(f"m{d.vid}[i] = {self.store_as(f'{prod} + {cc}', de)};")
            self.close()
        elif oc == O.MMA_CAST:
            src = args[1]
            self.open(loop)
            self.emit(f"m{mat.vid}[i] = "
                      f"{self.conv_expr(f'm{src.vid}[i]', src.ty.elem, me)};")
            self.close()
        else:
            raise unsupported(oc, _BACKEND)

    # ------------------------------------------------ cmma on tensor cores

    def frag(self, mat: Value) -> str:
        """The pointer a fragment is read and written through: its region,
        or in the pipelined K loop the stage being filled or read."""
        return self.stage_ptrs.get(mat.vid, f"m{mat.vid}")

    def frag_at(self, mat: Value, r: str, c: str, half: int = 0) -> str:
        """Element (r, c) of a shared-memory fragment of the tensor-core
        route: swizzled panels for an operand, row-major otherwise; of a
        split (f32) operand, K-major (a B fragment transposed), in its big
        (``half`` 0) or small (1) half."""
        R, C = mat.shape
        if mat.vid in self.tc.split:
            at = f"cc_sw32({c}, {r}, {C})" if self.tc.split[mat.vid] else \
                f"cc_sw32({r}, {c}, {R})"
            return f"{self.frag(mat)}[{f'{R * C} + ' if half else ''}{at}]"
        if mat.vid in self.tc.swizzled:
            return f"{self.frag(mat)}[cc_sw({r}, {c}, {R})]"
        return f"{self.frag(mat)}[({r}) * {C} + ({c})]"

    def acc_loop(self, mat: Value, body: Callable[[str, str, str], str],
                 reg: Optional[str] = None) -> None:
        """``body(r, c, value)`` for each element of an accumulator unit
        this thread holds, in ``wgmma``'s layout: register j of unit u is
        row 16 warp + lane / 4 + 8 ((j / 2) % 2) of the unit's band and
        column 8 (j / 4) + 2 (lane % 4) + j % 2 of its chunk. Every unit of
        a register accumulator, or with ``reg`` (the registers of unit
        ``cc_u`` of a shared-memory accumulator) that one."""
        N = mat.shape[1]
        nc = _chunk(N)
        if reg is None:
            acc = self.tc.regs[mat.vid]
            self.emit("#pragma unroll")
            self.open(f"for (int u = 0; u < {acc.per_wg}; ++u)")
            self.emit(f"const int cc_u = cc_wg + {self.tc.warpgroups} * u;")
            reg = f"cc_acc{mat.vid}[u]"
        else:
            self.open("")
        self.emit(f"const int r0 = cc_u / {N // nc} * 64 + cc_warp * 16 + "
                  f"(cc_lane >> 2), c0 = cc_u % {N // nc} * {nc} + "
                  f"(cc_lane & 3) * 2;")
        self.emit("#pragma unroll")
        self.open(f"for (int j = 0; j < {nc // 2}; ++j)")
        self.emit("const int r = r0 + ((j >> 1) & 1) * 8, "
                  "c = c0 + (j >> 2) * 8 + (j & 1);")
        self.emit(body("r", "c", f"{reg}[j]"))
        self.close()
        self.close()

    def wgmma_products(self, a: Value, b: Value, acc: str, unit: str) -> None:
        """The m64 x nc ``wgmma``s of one accumulator unit over all of K:
        16-bit in k16 steps (A K-major, B MN-major through the transpose
        bit), added to ``acc``; f32 in k8 steps of three TF32 products,
        A_small B_big, A_big B_small and A_big B_big (both K-major, each
        half a descriptor), summed into ``acc`` from zero."""
        (M, K), N = a.shape, b.shape[1]
        nc = _chunk(N)
        if a.vid in self.tc.split:
            self.emit(f"const uint32_t cc_a = cubecl::smem_addr("
                      f"{self.frag(a)}) + ({unit}) / {N // nc} * {64 * 128}, "
                      f"cc_b = cubecl::smem_addr({self.frag(b)}) + ({unit}) "
                      f"% {N // nc} * {nc * 128};")
            self.emit("#pragma unroll")
            self.open(f"for (int ks = 0; ks < {K // 8}; ++ks)")
            self.emit(f"const uint32_t oa = (ks >> 2) * {M * 128} + (ks & 3) "
                      f"* 32, ob = (ks >> 2) * {N * 128} + (ks & 3) * 32;")
            self.emit(
                f"const uint64_t cc_ab = cubecl::sw128_desc(cc_a + oa, 16, "
                f"1024), cc_as = cubecl::sw128_desc(cc_a + {M * K * 4} + oa, "
                f"16, 1024), cc_bb = cubecl::sw128_desc(cc_b + ob, 16, 1024), "
                f"cc_bs = cubecl::sw128_desc(cc_b + {K * N * 4} + ob, 16, "
                f"1024);")
            # the first product starts the sum from zero
            self.emit(f"cubecl::wgmma_tf32({acc}, cc_as, cc_bb, ks > 0);")
            self.emit(f"cubecl::wgmma_tf32({acc}, cc_ab, cc_bs);")
            self.emit(f"cubecl::wgmma_tf32({acc}, cc_ab, cc_bb);")
            self.close()
            return
        tag = "cubecl::BF16{}" if a.ty.elem.name == "bf16" else "cubecl::F16{}"
        self.emit(f"const uint32_t cc_a = cubecl::smem_addr({self.frag(a)}) + "
                  f"({unit}) / {N // nc} * {64 * 128}, cc_b = "
                  f"cubecl::smem_addr({self.frag(b)}) + ({unit}) % {N // nc} * "
                  f"{nc // 64 * K * 128};")
        self.emit("#pragma unroll")
        self.open(f"for (int ks = 0; ks < {K // 16}; ++ks)")
        self.emit(f"cubecl::wgmma_ss<true>({tag}, {acc}, cubecl::sw128_desc("
                  f"cc_a + (ks >> 2) * {M * 128} + (ks & 3) * 32, 16, 1024), "
                  f"cubecl::sw128_desc(cc_b + ks * 2048, {K * 128}, 1024));")
        self.close()

    def split_chunks(self, op) -> int:
        """Chunks of 4 elements a thread of a split load's 16-byte path, or
        0 when the load has none (a column-major or converted source, or a
        fragment the threads do not tile in such chunks)."""
        mat, buf = op.args[:2]
        R, C = mat.shape
        row = op.attrs.get("layout", "row_major") == "row_major"
        if not (row and self.buffer(buf).ty.elem == mat.ty.elem
                and R * C % (4 * self.U) == 0
                and (not self.tc.split[mat.vid]
                     or (R % 32 == 0 and C % 16 == 0
                         and R * C % (16 * self.U) == 0))):
            return 0
        return R * C // (4 * self.U)

    def split_vars(self, op, tag: str) -> None:
        """Declare what a split load carries from its fetch to its put:
        the source offset and stride, whether its 16-byte path runs, and
        that path's chunks in registers."""
        n = self.split_chunks(op)
        self.emit(f"int64_t cc_off{tag}, cc_st{tag}; bool cc_v{tag};")
        if n:
            self.emit(f"uint4 cc_r{tag}[{n}];")

    def split_index(self, op) -> None:
        """(r, c) of the first element of chunk q of a split load's 16-byte
        path. An A chunk is 4 of K, one swizzled chunk of each half. A B
        (K x N) fragment goes in 4 x 4 blocks, chunks q to q + 3 of a
        thread rows r to r + 3 of one block (``q`` a multiple of 4), so
        that a thread transposes its block in registers and stores 4 of K
        at each n, one swizzled chunk of each half: a warp's blocks are 8
        along K by 4 along N, so that its loads take 64 bytes of a row and
        each quarter's stores 8 distinct chunks (all 32 banks)."""
        mat = op.args[0]
        R, C = mat.shape
        if self.tc.split[mat.vid]:
            self.emit(f"const int i = unit_pos + (q >> 2) * {self.U};")
            self.emit(f"const int r = ((i >> 5) % {R // 32} * 8 + (i & 7)) * "
                      f"4, c = ((i >> 5) / {R // 32} * 4 + ((i >> 3) & 3)) "
                      "* 4;")
        else:
            self.emit(f"const int i = unit_pos + q * {self.U};")
            self.emit(f"const int r = i / {C // 4}, c = i % {C // 4} * 4;")

    def split_fetch(self, op, tag: str) -> None:
        """A split load's first half: its source offset and stride, and,
        where the source rows are 16-byte aligned, its chunks' global loads
        into registers (``split_vars``)."""
        mat, buf, off, stride = op.args[:4]
        b = f"b{self.buffer(buf).value.vid}"
        n = self.split_chunks(op)
        self.emit(f"cc_off{tag} = {self.cval(off, i64)}; "
                  f"cc_st{tag} = {self.cval(stride, i64)};")
        if not n:
            self.emit(f"cc_v{tag} = false;")
            return
        self.emit(f"cc_v{tag} = ((reinterpret_cast<uintptr_t>({b} + "
                  f"cc_off{tag}) & 15) == 0) && ((cc_st{tag} & 3) == 0);")
        row = "r + (q & 3)" if self.tc.split[mat.vid] else "r"
        self.open(f"if (cc_v{tag})")
        self.emit("#pragma unroll")
        self.open(f"for (int q = 0; q < {n}; ++q)")
        self.split_index(op)
        self.emit(f"cc_r{tag}[q] = *reinterpret_cast<const uint4*>({b} + "
                  f"cc_off{tag} + (int64_t)({row}) * cc_st{tag} + c);")
        self.close()
        self.close()

    def split_put(self, op, tag: str) -> None:
        """A split load's second half, into the fragment (or its stage):
        each fetched chunk's big and small tf32 halves
        (``cubecl::tf32_split4``) into the two halves of the K-major
        fragment, an A fragment as it is, a B one transposed (a thread's
        4 x 4 block in registers: 16-byte stores either way); element by
        element from the source where no chunk was fetched."""
        mat, buf = op.args[:2]
        R, C = mat.shape
        U = self.U
        bp = self.buffer(buf)
        row = op.attrs.get("layout", "row_major") == "row_major"
        n = self.split_chunks(op)

        def put(r, c, big, small):
            return [f"{self.frag_at(mat, r, c, h)} = __uint_as_float({v});"
                    for h, v in ((0, big), (1, small))]

        if n:
            tr = self.tc.split[mat.vid]
            self.open(f"if (cc_v{tag})")
            self.emit("#pragma unroll")
            self.open(f"for (int q = 0; q < {n}; q += {4 if tr else 1})")
            self.split_index(op)
            self.emit("uint4 cc_big, cc_small;")
            # an A chunk as it is; a B block's column j (rows r .. r + 3:
            # 4 of K at n = c + j)
            cols = [("c", f"cc_r{tag}[q]")] if not tr else [
                (f"c + {j}", "make_uint4(" + ", ".join(
                    f"cc_r{tag}[q + {i}].{w}" for i in range(4)) + ")")
                for j, w in enumerate("xyzw")]
            for col, x in cols:
                self.emit(f"cubecl::tf32_split4({x}, cc_big, cc_small);")
                for h, v in ((0, "cc_big"), (1, "cc_small")):
                    self.emit(f"*reinterpret_cast<uint4*>(&"
                              f"{self.frag_at(mat, 'r', col, h)}) = {v};")
            self.close()
            self.close("} else {")
            self.depth += 1
            self.blocks.append(set())
        g = "(int64_t)r * cc_st" if row else "(int64_t)c * cc_st"
        g = f"{g}{tag} + {'c' if row else 'r'}"
        self.open(f"for (int i = unit_pos; i < {R * C}; i += {U})")
        self.emit(f"const int r = i / {C}, c = i % {C};")
        self.emit("uint32_t cc_big, cc_small;")
        x = self.conv_expr(f"b{bp.value.vid}[cc_off{tag} + {g}]", bp.ty.elem,
                           mat.ty.elem)
        self.emit(f"cubecl::tf32_split(__float_as_uint({x}), cc_big, "
                  "cc_small);")
        for line in put("r", "c", "cc_big", "cc_small"):
            self.emit(line)
        self.close()
        if n:
            self.close()

    def load_split(self, op) -> None:
        """``mma.load`` into a split (f32) operand fragment, its fetch and
        put at once: every global load of the thread issued before its
        first store."""
        self.split_vars(op, "")
        self.split_fetch(op, "")
        self.split_put(op, "")

    def load_fragment(self, op, cp_async: bool = False) -> None:
        """``mma.load`` into a shared-memory fragment of the tensor-core
        route. Into an operand fragment from a row-major buffer of its
        type, 16 bytes a thread (a row's 8-element chunk is one swizzled
        chunk of the fragment) where the source is 16-byte aligned, every
        load of the thread issued before its first store, or as cp.async
        copies (``cp_async``: the caller waits for them); element by
        element otherwise."""
        mat, buf, off, stride = op.args[:4]
        if mat.vid in self.tc.split:
            self.load_split(op)
            return
        R, C = mat.shape
        U = self.U
        me = mat.ty.elem
        bp = self.buffer(buf)
        be = bp.ty.elem
        row = op.attrs.get("layout", "row_major") == "row_major"
        self.emit(f"const int64_t off = {self.cval(off, i64)}, "
                  f"st = {self.cval(stride, i64)};")
        src = f"b{bp.value.vid} + off"

        def scalar():
            g = "(int64_t)r * st + c" if row else "(int64_t)c * st + r"
            self.open(f"for (int i = unit_pos; i < {R * C}; i += {U})")
            self.emit(f"const int r = i / {C}, c = i % {C};")
            self.emit(f"{self.frag_at(mat, 'r', 'c')} = "
                      f"{self.conv_expr(f'b{bp.value.vid}[off + {g}]', be, me)};")
            self.close()

        if not (mat.vid in self.tc.swizzled and row and be == me
                and R * C % (8 * U) == 0):
            scalar()
            return
        n = R * C // (8 * U)
        self.open(f"if (((reinterpret_cast<uintptr_t>({src}) & 15) == 0) && "
                  f"((st & 7) == 0))")
        if not cp_async:
            self.emit(f"uint4 cc_t[{n}];")
        for phase in (("copy",) if cp_async else ("load", "store")):
            self.emit("#pragma unroll")
            self.open(f"for (int q = 0; q < {n}; ++q)")
            self.emit(f"const int i = unit_pos + q * {U}, r = i / {C // 8}, "
                      f"c = i % {C // 8} * 8;")
            dst = f"&{self.frag_at(mat, 'r', 'c')}"
            at = f"{src} + (int64_t)r * st + c"
            if phase == "copy":
                self.emit(f"cubecl::cp_async16({dst}, {at});")
            elif phase == "load":
                self.emit(f"cc_t[q] = *reinterpret_cast<const uint4*>({at});")
            else:
                self.emit(f"*reinterpret_cast<uint4*>({dst}) = cc_t[q];")
            self.close()
        self.close("} else {")
        self.depth += 1
        self.blocks.append(set())
        scalar()
        self.close()

    def pipelined_loop(self, inst, pre, ex) -> None:
        """The canonical K loop on a ring of two stages of its operand
        fragments: step i + 1's scalars and copies (cp.async) are issued
        into the other stage before step i's products, which wait for
        their own stage's copies (``cp.async.wait_group 1``), fence them
        for the async proxy and meet at a barrier; the barrier after the
        products frees their stage for the copies of step i + 2. Split
        (f32) operands: :meth:`split_loop`."""
        if ex.op.args[0].vid in self.tc.split:
            self.split_loop(inst, pre, ex)
            return
        var = inst.op.attrs["var"]
        ct, n, s, st, cond = self.loop_bounds(inst.op)
        ring = [ex.op.args[0], ex.op.args[1]]

        def stage(which):
            # the body's scalars and its loads into stage ``which``
            self.stage_pointers(ring, which)
            for i in pre:
                if i.op.opcode == O.MMA_LOAD:
                    self.open("")
                    self.load_fragment(i.op, cp_async=True)
                    self.close()
                else:
                    self.inst(i)
            self.stage_ptrs.clear()

        self.emit("// the K loop on a ring of two stages")
        self.open("")
        self.emit("int cc_stage = 0;")
        self.open(f"if ({cond(s)})")
        self.emit(f"const {ct} {n} = {s};")
        self.blocks[-1].add(var.vid)
        stage("0")
        self.close()
        self.emit("cubecl::cp_async_commit();")
        self.loops.append([])
        self.open(f"for ({ct} {n} = {s}; {cond(n)}; {n} += {st})")
        self.blocks[-1].add(var.vid)
        self.emit(f"const {ct} cc_next = {n} + {st};")
        self.open(f"if ({cond('cc_next')})")
        self.emit(f"const {ct} {n} = cc_next;")
        stage("cc_stage ^ 1")
        self.close()
        self.emit("cubecl::cp_async_commit();")
        self.emit("cubecl::cp_async_wait<1>();")
        self.emit("cubecl::fence_proxy_async();")
        self.emit("__syncthreads();")
        self.open("")
        self.stage_pointers(ring, "cc_stage")
        self.mma_wgmma(ex)
        self.stage_ptrs.clear()
        self.close()
        self.emit("__syncthreads();")
        self.emit("cc_stage ^= 1;")
        self.close()
        self.loops.pop()
        self.emit("cubecl::cp_async_wait<0>();")
        self.close()

    def split_loop(self, inst, pre, ex) -> None:
        """The canonical K loop of split (f32) operands on a ring of two
        stages. Their halves go through registers, so no cp.async: a
        load's fetch (its global loads into registers) runs two steps
        ahead and its put (the split and the stores into a stage) one.
        Step i's products are issued first (their stage was put and fenced
        in step i - 1; the barrier at the top of step i makes every
        thread's stores visible and every product of step i - 1
        complete), then, while the tensor cores work, step i + 1 is put
        into the other stage and step i + 2 fetched; then the products are
        waited for: one barrier a step, and a global load's latency hidden
        behind a whole step."""
        var = inst.op.attrs["var"]
        ct, n, s, st, cond = self.loop_bounds(inst.op)
        ring = [ex.op.args[0], ex.op.args[1]]
        loads = [i.op for i in pre if i.op.opcode == O.MMA_LOAD]

        def fetch(at):
            # step ``at``'s scalars and the fetches of its loads
            self.open(f"if ({cond(at)})")
            self.emit(f"const {ct} {n} = {at};")
            self.blocks[-1].add(var.vid)
            for i in pre:
                if i.op.opcode == O.MMA_LOAD:
                    self.split_fetch(i.op, str(i.op.args[0].vid))
                else:
                    self.inst(i)
            self.close()

        def put(at, which):
            # the puts of step ``at``'s loads into stage ``which``
            self.open(f"if ({cond(at)})")
            self.stage_pointers(ring, which)
            for op in loads:
                self.open("")
                self.split_put(op, str(op.args[0].vid))
                self.close()
            self.stage_ptrs.clear()
            self.close()

        def ahead():
            put("cc_next", "cc_stage ^ 1")
            fetch("cc_next2")

        self.emit("// the K loop on a ring of two stages, fetched two steps "
                  "ahead")
        self.open("")
        self.emit("int cc_stage = 0;")
        for op in loads:
            self.split_vars(op, str(op.args[0].vid))
        fetch(s)
        put(s, "0")
        fetch(f"{s} + {st}")
        self.loops.append([])
        self.open(f"for ({ct} {n} = {s}; {cond(n)}; {n} += {st})")
        self.blocks[-1].add(var.vid)
        self.emit(f"const {ct} cc_next = {n} + {st}, cc_next2 = cc_next + "
                  f"{st};")
        self.emit("cubecl::fence_proxy_async();")
        self.emit("__syncthreads();")
        self.open("")
        self.stage_pointers(ring, "cc_stage")
        self.mma_wgmma(ex, between=ahead)
        self.stage_ptrs.clear()
        self.close()
        self.emit("cc_stage ^= 1;")
        self.close()
        self.loops.pop()
        self.close()

    def stage_pointers(self, ring, which: str) -> None:
        """Point the ring fragments at their stage ``which``: a stage is
        the whole fragment (both halves of a split one)."""
        for m in ring:
            t = _storage(m.ty.elem)
            size = m.shape[0] * m.shape[1] * (2 if m.vid in self.tc.split
                                              else 1)
            self.emit(f"{t}* const cc_s{m.vid} = m{m.vid} + ({which}) * "
                      f"{size};")
            self.stage_ptrs[m.vid] = f"cc_s{m.vid}"

    def mma_wgmma(self, inst, between=None) -> None:
        """One fragment op of the tensor-core route (module docstring).
        ``between``: for an ``execute``, what to print while its products
        run (after the commit of a register accumulator's ``wgmma``s,
        before their wait; after the products of one in shared memory)."""
        op = inst.op
        oc = op.opcode
        args = op.args
        U = self.U
        tc = self.tc
        mat = args[0]
        R, C = mat.shape
        me = mat.ty.elem
        fence = mat.vid in tc.swizzled
        if oc == O.MMA_FILL:
            self.emit(f"const {_storage(me)} fv = "
                      f"{self.convert(args[1], me, None)};")
            if mat.vid in tc.regs:
                self.acc_loop(mat, lambda r, c, v: f"{v} = fv;")
            else:
                self.emit(f"for (int i = unit_pos; i < {R * C}; i += {U}) "
                          f"m{mat.vid}[i] = fv;")
        elif oc == O.MMA_LOAD:
            self.load_fragment(op)
        elif oc == O.MMA_STORE:
            bp = self.buffer(args[1])
            be = bp.ty.elem
            self.emit(f"const int64_t off = {self.cval(args[2], i64)}, "
                      f"st = {self.cval(args[3], i64)};")
            row = op.attrs.get("layout", "row_major") == "row_major"

            def g(r, c):
                return (f"b{bp.value.vid}[off + (int64_t)({r}) * st + ({c})]"
                        if row else
                        f"b{bp.value.vid}[off + (int64_t)({c}) * st + ({r})]")

            if mat.vid in tc.regs:
                self.acc_loop(mat, lambda r, c, v: f"{g(r, c)} = "
                              f"{self.conv_expr(v, me, be)};")
            else:
                self.open(f"for (int i = unit_pos; i < {R * C}; i += {U})")
                self.emit(f"const int r = i / {C}, c = i % {C};")
                self.emit(f"{g('r', 'c')} = "
                          f"{self.conv_expr(self.frag_at(mat, 'r', 'c'), me, be)};")
                self.close()
            fence = False
        elif oc == O.MMA_EXECUTE:
            a, b, c, d = args[:4]
            M, N = d.shape
            # split (f32) products are summed from zero in wgmma
            # accumulators of their own, whose sums round toward zero, and
            # added to the f32 accumulator by ordinary additions
            split = a.vid in tc.split
            self.emit("cubecl::wgmma_fence();")
            if d.vid in tc.regs:
                acc = tc.regs[d.vid]
                regs = f"cc_acc{d.vid}"
                if split:
                    regs = "cc_part"
                    self.emit(f"float cc_part[{acc.per_wg}][{acc.nc // 2}];")
                self.emit("#pragma unroll")
                self.open(f"for (int u = 0; u < {acc.per_wg}; ++u)")
                self.wgmma_products(a, b, f"{regs}[u]",
                                    f"cc_wg + {tc.warpgroups} * u")
                self.close()
                self.emit("cubecl::wgmma_commit();")
                if between is not None:
                    between()
                self.emit("cubecl::wgmma_wait0();")
                self.emit("#pragma unroll")
                self.emit(f"for (int u = 0; u < {acc.per_wg}; ++u) "
                          f"cubecl::acc_fence({regs}[u]);")
                if split:
                    self.emit("#pragma unroll")
                    self.emit(f"for (int u = 0; u < {acc.per_wg}; ++u) for "
                              f"(int j = 0; j < {acc.nc // 2}; ++j) "
                              f"cc_acc{d.vid}[u][j] += cc_part[u][j];")
            else:
                # the accumulator in shared memory: each unit's C into
                # registers, the products, D back (split: the products
                # from zero, D = C + them)
                nc = _chunk(N)
                self.open(f"for (int cc_u = cc_wg; cc_u < {M // 64 * (N // nc)}"
                          f"; cc_u += {tc.warpgroups})")
                self.emit(f"float cc_d[{nc // 2}];")
                if not split:
                    self.acc_loop(d, lambda r, col, v: f"{v} = "
                                  f"{self.frag_at(c, r, col)};", "cc_d")
                self.emit("cubecl::wgmma_fence();")
                self.wgmma_products(a, b, "cc_d", "cc_u")
                self.emit("cubecl::wgmma_commit();")
                self.emit("cubecl::wgmma_wait0();")
                self.emit("cubecl::acc_fence(cc_d);")
                c_plus = (lambda r, col: f"{self.frag_at(c, r, col)} + ") \
                    if split else (lambda r, col: "")
                self.acc_loop(d, lambda r, col, v: f"{self.frag_at(d, r, col)}"
                              f" = {c_plus(r, col)}{v};", "cc_d")
                self.close()
                if between is not None:
                    between()
            fence = False
        elif oc == O.MMA_CAST:
            src = args[1]
            if src.vid in tc.regs:
                self.acc_loop(src, lambda r, c, v: f"{self.frag_at(mat, r, c)}"
                              f" = {self.conv_expr(v, src.ty.elem, me)};")
            else:
                self.open(f"for (int i = unit_pos; i < {R * C}; i += {U})")
                self.emit(f"const int r = i / {C}, c = i % {C};")
                s = self.conv_expr(self.frag_at(src, "r", "c"), src.ty.elem,
                                   me)
                self.emit(f"{self.frag_at(mat, 'r', 'c')} = {s};")
                self.close()
        else:
            raise unsupported(oc, _BACKEND)
        if fence:
            # these generic stores are read next by wgmma (the async proxy)
            self.emit("cubecl::fence_proxy_async();")

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
        if self.V and L > 1:
            # the lane's share, then a butterfly over the warp: every lane
            # ends with the line's value
            kind = {O.VEC_SUM: "sum", O.DOT: "sum", O.VEC_MAX: "max",
                    O.VEC_MIN: "min"}[oc]
            self.open("")
            self.emit(f"{ct} acc = {_identity(kind, elem)};")
            self.lane_loop(L, lambda l: [f"const {ct} t = {term(l)};",
                                         f"acc = {comb};"])
            self.open(f"for (int o = {LANES // 2}; o > 0; o >>= 1)")
            self.emit(f"const {ct} t = ({ct})__shfl_xor_sync(0xffffffffu, "
                      f"({_shfl_type(elem)})acc, o, {LANES});")
            self.emit(f"acc = {comb};")
            self.close()
            self.emit(f"{n} = {self.store_as('acc', elem)};")
            self.close()
            return
        self.open("")
        self.emit(f"{ct} acc = {term('0')};")
        self.open(f"for (int l = 1; l < {L}; ++l)")
        self.emit(f"const {ct} t = {term('l')};")
        self.emit(f"acc = {comb};")
        self.close()
        self.emit(f"{n} = {self.store_as('acc', elem)};")
        self.close()

    def block_reduce(self, inst) -> None:
        """``mem.block_reduce``: the cube reduces the buffer's elements of
        lines [start, start + lines) together. The threads stride over the
        window, neighbouring threads on neighbouring 16-byte vectors when
        the window's start is 16-byte aligned (single elements otherwise),
        each with ``_BR_ACC`` accumulators of the compute type (f32 for
        sub-f32 floats), so that as many loads are in flight; a
        ``__shfl_xor_sync`` butterfly folds each plane, a static
        ``__shared__`` array of one value per plane folds the planes in a
        fixed order, and every unit ends with the same value, converted
        back to the buffer's type."""
        op = inst.op
        out = inst.out
        bp = self.buffer(op.args[0])
        kind, lines = op.attrs["kind"], int(op.attrs["lines"])
        elem, L = bp.ty.elem, bp.ty.line
        U, P, K = self.U, self.P, _BR_ACC
        if U % P or P & (P - 1) or elem.is_bool:
            raise unsupported(f"{O.BLOCK_REDUCE} of {elem.name} on a plane "
                              f"of {P} lanes in a cube of {U} units",
                              _BACKEND)
        ct, sh, st = _compute(elem), _shfl_type(elem), _storage(elem)
        fold = {"sum": "{a} + {b}", "prod": "{a} * {b}",
                "max": "cc_max({a}, {b})", "min": "cc_min({a}, {b})"}[kind]
        comb = fold.format(a="acc", b="t")
        W, V = lines * L, 16 // elem.size
        n = self.declare(out)
        nw = U // P
        red = f"cc_red{out.vid}"
        self.open("")
        self.emit(f"const {st}* p = b{bp.value.vid} + "
                  f"{self.cval(op.args[1], i64)} * {L};")
        self.emit(f"{ct} accs[{K}];")
        self.emit(f"for (int k = 0; k < {K}; ++k) accs[k] = "
                  f"{_identity(kind, elem)};")

        def sweep(width: int) -> None:
            # K loads a step per thread, each ``width`` elements
            self.open(f"for (int64_t i = (int64_t)unit_pos * {width}; "
                      f"i < {W}; i += {U * width * K}LL)")
            self.emit("#pragma unroll")
            self.open(f"for (int k = 0; k < {K}; ++k)")
            self.emit(f"const int64_t j = i + (int64_t)k * {U * width};")
            self.open(f"if (j < {W})")
            if width > 1:
                self.emit("const uint4 u = *reinterpret_cast<const uint4*>"
                          "(p + j);")
                self.emit(f"const {st}* e = reinterpret_cast<const {st}*>"
                          f"(&u);")
                self.emit("#pragma unroll")
                self.open(f"for (int v = 0; v < {width}; ++v)")
                src = "e[v]"
            else:
                src = "p[j]"
            self.emit(f"const {ct} t = "
                      f"{self.conv_expr(src, elem, elem, False)};")
            self.emit(f"accs[k] = {fold.format(a='accs[k]', b='t')};")
            if width > 1:
                self.close()
            self.close()
            self.close()
            self.close()

        if V > 1 and W % V == 0:
            self.open("if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)")
            sweep(V)
            self.close("} else {")
            self.depth += 1
            self.blocks.append(set())
            sweep(1)
            self.close()
        else:
            sweep(1)
        self.emit(f"{ct} acc = accs[0];")
        self.open(f"for (int k = 1; k < {K}; ++k)")
        self.emit(f"const {ct} t = accs[k];")
        self.emit(f"acc = {comb};")
        self.close()
        self.open(f"for (int o = {P // 2}; o > 0; o >>= 1)")
        self.emit(f"const {ct} t = ({ct})__shfl_xor_sync("
                  f"{self.plane_mask()}, ({sh})acc, o, {P});")
        self.emit(f"acc = {comb};")
        self.close()
        if nw > 1:
            self.emit(f"__shared__ {ct} {red}[{nw}];")
            self.emit(f"if (unit_pos_plane == 0) {red}[plane_pos] = acc;")
            self.emit("__syncthreads();")
            self.emit(f"acc = {red}[0];")
            self.open(f"for (int w = 1; w < {nw}; ++w)")
            self.emit(f"const {ct} t = {red}[w];")
            self.emit(f"acc = {comb};")
            self.close()
            self.emit("__syncthreads();")  # the array is read before reuse
        self.emit(f"{n} = {self.store_as('acc', elem)};")
        self.close()

    def reinterpret(self, inst) -> None:
        """``op.reinterpret``: the bits of a value as another element type;
        the line absorbs the width ratio (a line of 4 f32 is a line of 16
        u8). The source is gathered in its storage type and copied."""
        x, out = inst.op.args[0], inst.out
        src, Ls = x.ty.elem, x.ty.line
        if Ls * src.size != out.ty.line * out.ty.elem.size:
            raise unsupported(f"{O.REINTERPRET} of {Ls} x {src.name} as "
                              f"{out.ty.line} x {out.ty.elem.name}", _BACKEND)
        n = self.declare(out)
        self.open("")
        if Ls > 1:
            self.emit(f"{_storage(src)} src[{Ls}];")
            self.emit(f"for (int l = 0; l < {Ls}; ++l) src[l] = "
                      f"{self.convert(x, src, 'l')};")
        else:
            self.emit(f"{_storage(src)} src = {self.convert(x, src, None)};")
        dst = n if out.ty.line > 1 else f"&{n}"
        self.emit(f"memcpy({dst}, {'src' if Ls > 1 else '&src'}, "
                  f"sizeof(src));")
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


def _identity(kind: str, elem: ElemType) -> str:
    """The neutral element of a block reduction, in ``elem``'s compute
    type."""
    if kind in ("sum", "prod"):
        return _literal(0 if kind == "sum" else 1, elem)
    lo = kind == "max"
    if elem.is_float:
        return _literal(-math.inf if lo else math.inf, elem)
    if elem.is_signed:
        return _literal(-(1 << (elem.bits - 1)) if lo
                        else (1 << (elem.bits - 1)) - 1, elem)
    return _literal(0 if lo else (1 << elem.bits) - 1, elem)


def _promote(a: ElemType, b: ElemType) -> ElemType:
    """The common type of a comparison, as ``torch.promote_types``."""
    if a == b:
        return a
    import torch

    return elem_from_dtype(torch.promote_types(a.torch_dtype(),
                                               b.torch_dtype()))


def _values(inst):
    op = inst.op
    yield from op.args
    if inst.out is not None:
        yield inst.out
    if "cond_value" in op.attrs:
        yield op.attrs["cond_value"]


def reads_plane_builtins(scope: Scope) -> bool:
    """Does the scope read ``UNIT_POS_PLANE``, ``PLANE_POS`` or
    ``PLANE_DIM``? (Ask before the passes, which fold ``PLANE_DIM``.)"""
    return any(v.kind == VarKind.BUILTIN and v.payload in _PLANE_BUILTINS
               for _s, inst in walk(scope) for v in _values(inst))


def least_warp_line(elem_bytes: int) -> int:
    """The fewest elements a line needs for warp lines when the narrowest
    buffer with lines stores ``elem_bytes`` an element: 32 chunks of 16
    bytes."""
    return LANES * max(1, _CHUNK // elem_bytes)


def _per_unit(sd) -> bool:
    """A per-unit array (``frontend.Array``), traced as a shared
    declaration."""
    return isinstance(sd.value.payload, dict) and \
        sd.value.payload.get("per_unit", False)


def warp_vector(defn: KernelDefinition, plane_builtins: bool = False) -> int:
    """V of the warp-lines mapping for an optimized definition, or 0 when
    it keeps one thread a unit (the rule of the module docstring).
    ``plane_builtins``: the traced scope read a plane builtin."""
    lines = [bp.ty.elem.size for bp in defn.state.buffers if bp.ty.line > 1]
    if plane_builtins or not lines or defn.state.shareds:
        return 0
    least = least_warp_line(min(lines))
    V = least // LANES
    if any(1 < bp.ty.line < least for bp in defn.state.buffers):
        return 0
    for _s, inst in walk(defn.scope):
        oc = inst.op.opcode
        if oc.startswith(_WARP_EXCLUDED_PREFIXES) or oc in _WARP_EXCLUDED_OPS:
            return 0
        for v in _values(inst):
            if v.kind == VarKind.BUILTIN and v.payload in _PLANE_BUILTINS:
                return 0
            if 1 < v.ty.line < least:
                return 0
    return V


@dataclass
class _RegAcc:
    """A register accumulator of the tensor-core route: its M/64 bands x
    N/nc chunks, units of m64 x nc, are dealt to the warpgroups in turn,
    ``per_wg`` each, nc/2 f32 registers a unit."""
    nc: int
    per_wg: int


@dataclass
class TensorCorePlan:
    """Where the tensor-core route keeps a kernel's fragments: the operand
    fragments (``swizzled``: vid -> rows) in panels of rows x 128 bytes
    with the 128-byte swizzle, 1024-byte aligned: a 16-bit fragment as its
    64-column panels, an f32 one (``split``) K-major as 32-column panels of
    K, a big and a small tf32 half, the second after the first (an A
    fragment row-major, a B fragment transposed: ``split[vid]``); the
    register accumulators (``regs``); every other fragment row-major in
    shared memory. ``offsets`` and ``smem_bytes`` are the shared-memory
    fragments' only, plus 1024 bytes of slack that aligns the base."""
    warpgroups: int
    swizzled: Dict[int, int]
    regs: Dict[int, _RegAcc]
    offsets: Dict[int, int]
    smem_bytes: int
    # the operand fragments of pipelined K loops: two stages each
    rings: Set[int]
    # the f32 operand fragments, split for 3xTF32: vid -> stored transposed
    split: Dict[int, bool]


def _chunk(n: int) -> int:
    """The widest ``wgmma`` N (256, 128 or 64) that divides ``n``."""
    return next(c for c in (256, 128, 64) if n % c == 0)


def tensor_core_plan(defn: KernelDefinition) -> Optional[TensorCorePlan]:
    """The cmma route of a definition: a :class:`TensorCorePlan` when its
    fragment products can run on ``wgmma``, else None (the FMA route).

    The route needs a cube of whole warpgroups (units a multiple of 128),
    no ``execute_scaled``, and every ``execute`` with f32 C and D, M and N
    multiples of 64 (the bands of 64 rows, the 64-column chunks of N) and
    one of:

    - bf16 or f16 operands of one type, K a multiple of 64 (one 128-byte
      swizzle row of K);
    - f32 operands, K a multiple of 32 (one swizzle row of f32), run as
      three TF32 products (3xTF32). TF32 ``wgmma`` has no transpose bit, so
      both operands are stored K-major, A as it is and B transposed, each
      as a big and a small tf32 half that ``load`` writes; such a fragment
      is only loaded and multiplied, always in one role (A or B): one that
      is filled, stored, cast or accumulated into keeps the kernel on FMA
      (a store of it would return big + small, not the value loaded).

    An f32 accumulator lives in registers when only ``fill``, ``execute``
    with C and D both it, ``store`` and ``cast`` (as the source) touch it,
    its units deal evenly over the warpgroups and a thread holds at most
    128 of its values (64 when it takes split products: their sums, from
    zero, take as many registers beside it); else in shared memory. The
    tensor cores' f32 sums round toward zero, so a split ``execute`` sums
    its products from zero and adds them to C by ordinary f32 additions:
    in one wgmma accumulator over all of K they drift out of f32's
    tolerance. The two operand fragments
    of a canonical K loop that nothing else touches get two stages each
    (the loop's ring: step i + 1's copies are issued before step i's
    products complete)."""
    st = defn.state
    U = math.prod(defn.cube_dim)
    ops = [inst.op for _s, inst in walk(defn.scope)
           if inst.op.opcode.startswith("mma.")]
    executes = [op for op in ops if op.opcode == O.MMA_EXECUTE]
    if (not executes or U % 128 or U > MAX_THREADS
            or any(op.opcode == O.MMA_EXECUTE_SCALED for op in ops)):
        return None
    W = U // 128
    swizzled: Dict[int, int] = {}
    split: Dict[int, bool] = {}
    accs: Dict[int, Value] = {}
    for op in executes:
        a, b, c, d = op.args[:4]
        (M, K), N = a.shape, b.shape[1]
        kind = a.ty.elem.name
        if (kind not in ("bf16", "f16", "f32") or b.ty.elem != a.ty.elem
                or c.ty.elem.name != "f32" or d.ty.elem.name != "f32"
                or M % 64 or N % 64 or K % (32 if kind == "f32" else 64)):
            return None
        if kind == "f32":
            for x, transposed in ((a, False), (b, True)):
                if split.setdefault(x.vid, transposed) != transposed:
                    return None
            swizzled[a.vid], swizzled[b.vid] = M, N
        else:
            swizzled[a.vid], swizzled[b.vid] = M, K
        accs[c.vid], accs[d.vid] = c, d
    if any(_split_use(op, split) is False for op in ops):
        return None
    split_accs = {op.args[3].vid for op in executes
                  if op.args[0].vid in split}
    regs: Dict[int, _RegAcc] = {}
    for vid, x in accs.items():
        M, N = x.shape
        nc = _chunk(N)
        units = M // 64 * (N // nc)
        if units % W or units // W * nc // 2 > (64 if vid in split_accs
                                                 else 128):
            continue
        if all(_register_use(op, vid) for op in ops):
            regs[vid] = _RegAcc(nc, units // W)
    rings: Set[int] = set()
    for _s, inst in walk(defn.scope):
        loop = canonical_k_loop(inst.op, swizzled)
        if loop is not None:
            ex = loop[1].op
            ab = {ex.args[0].vid, ex.args[1].vid}
            # the ring fragments are the loop's alone
            if all(sum(a.kind == VarKind.MATRIX and a.vid == v
                       for o in ops for a in o.args) == 2 for v in ab):
                rings |= ab
    offsets, total = fragment_layout(
        st, align={v: 1024 for v in swizzled}, skip=regs, double=rings,
        halves=split)
    return TensorCorePlan(W, swizzled, regs, offsets, total + 1024, rings,
                          split)


def canonical_k_loop(op, swizzled: Dict[int, int]):
    """(the body's instructions before the product, the ``execute``) of
    a canonical K loop, else None: a ``RangeLoop`` whose body loads two
    operand fragments (row-major, one ``mma.load`` each), computes only
    scalars besides (no store, carry or control flow) and ends with the
    ``execute`` of those two."""
    if op.opcode != O.RANGE_LOOP:
        return None
    body = op.attrs["body"].instructions
    if not body or body[-1].op.opcode != O.MMA_EXECUTE or _writebacks(
            op.attrs["body"]):
        return None
    ex = body[-1]
    a, b = ex.op.args[:2]
    if a.vid == b.vid or a.vid not in swizzled or b.vid not in swizzled:
        return None
    loaded = []
    for inst in body[:-1]:
        o, oc = inst.out, inst.op.opcode
        if oc == O.MMA_LOAD:
            if inst.op.attrs.get("layout", "row_major") != "row_major":
                return None
            loaded.append(inst.op.args[0].vid)
        elif (o is None or o.kind != VarKind.LOCAL or o.ty.line > 1
              or oc.startswith("mma.")):
            return None
    if sorted(loaded) != sorted((a.vid, b.vid)):
        return None
    return body[:-1], ex


def _split_use(op, split: Dict[int, bool]) -> Optional[bool]:
    """False when ``op`` touches a split (f32 operand) fragment other than
    by ``load`` into it or as an operand of ``execute``; else None."""
    mats = [a.vid if a.kind == VarKind.MATRIX else None for a in op.args]
    if not any(v in split for v in mats):
        return None
    if op.opcode == O.MMA_LOAD:
        return None
    if op.opcode == O.MMA_EXECUTE and not any(v in split
                                              for v in mats[2:4]):
        return None
    return False


def _register_use(op, vid: int) -> bool:
    """May fragment ``vid`` live in registers as far as ``op`` goes?"""
    args = [a.vid if a.kind == VarKind.MATRIX else None for a in op.args]
    if vid not in args:
        return True
    oc = op.opcode
    if oc in (O.MMA_FILL, O.MMA_STORE):
        return True
    if oc == O.MMA_EXECUTE:
        return args[2] == args[3] == vid and vid not in args[:2]
    return oc == O.MMA_CAST and args[0] != vid


def kernel_symbol(defn: KernelDefinition, digest: str) -> str:
    """A C identifier for the kernel: its name and its id's digest."""
    base = "".join(c if c.isalnum() else "_" for c in defn.options.name)
    return f"{base}_{digest[:12]}"


def block_of(defn: KernelDefinition, vec: int):
    """The threads of a block, (x, y, z): the cube dim, or under warp
    lines its units x 32 in x."""
    if vec:
        return (math.prod(defn.cube_dim) * LANES, 1, 1)
    return tuple(defn.cube_dim)


def print_kernel(defn: KernelDefinition, symbol: str,
                 vec: int = 0) -> Tuple[str, int]:
    """CUDA C++ of an optimized definition: the ``__global__`` function
    and an ``extern "C"`` launcher ``cubecl_launch(gx, gy, gz, stream,
    args)`` that returns ``cudaGetLastError()``; a kernel with cmma
    fragments launches with their dynamic shared memory, opting in once
    above 48 KiB. ``vec``: V of the warp-lines mapping (0: none).
    Returns (the source, the launch's dynamic shared memory in bytes:
    every fragment's on the FMA route, the shared-memory fragments' and
    the alignment slack on the tensor-core route)."""
    p = _Printer(defn, symbol, vec)
    body = p.print_kernel()
    ux, uy, uz = block_of(defn, vec)
    smem = p.smem_bytes
    opt_in = ""
    if smem > 48 * 1024:
        opt_in = f"""
  static const cudaError_t attr = cudaFuncSetAttribute(
      (const void*){symbol}, cudaFuncAttributeMaxDynamicSharedMemorySize,
      {smem});
  if (attr != cudaSuccess) return (int)attr;"""
    return body + f"""
extern "C" int cubecl_launch(unsigned gx, unsigned gy, unsigned gz,
                             void* stream, void** args) {{{opt_in}
  cudaError_t e = cudaLaunchKernel((const void*){symbol}, dim3(gx, gy, gz),
                                   dim3({ux}, {uy}, {uz}), args, {smem},
                                   (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}}

extern "C" const char* cubecl_error_string(int code) {{
  return cudaGetErrorString((cudaError_t)code);
}}
""", smem


def _print(defn: KernelDefinition, kernel_id: str = ""):
    """Optimize ``defn`` (in place) and print it: (source, symbol, V of
    the warp-lines mapping or 0, dynamic shared memory bytes)."""
    plane = reads_plane_builtins(defn.scope)
    prepare_scope(defn)
    from .build import digest

    symbol = kernel_symbol(defn, kernel_id or digest(repr(defn.scope)))
    vec = warp_vector(defn, plane)
    src, smem = print_kernel(defn, symbol, vec)
    return src, symbol, vec, smem


def cuda_source(defn: KernelDefinition, kernel_id: str = "") -> str:
    """Optimize ``defn`` (in place) and print its CUDA C++; no nvcc."""
    return _print(defn, kernel_id)[0]


class CudaCompiler(Compiler):
    """K0 for CUDA: optimize, print, build with nvcc (asynchronously: the
    returned kernel waits for its build at its first launch, so a caller
    may compile many kernels before it launches any, and their nvcc
    processes run together)."""

    name = "cuda"

    def compile(self, defn: KernelDefinition,
                kernel_id: str = "") -> CompiledKernel:
        from . import build

        src, symbol, vec, smem = _print(defn, kernel_id)
        job = build.start(src, symbol)
        st = defn.state
        mut = [i for i, bp in enumerate(st.buffers) if bp.mutable]
        launcher = build.Launcher(job, defn)
        return CompiledKernel(fn=launcher, mutable_indices=mut, source=src,
                              name=defn.options.name,
                              block=block_of(defn, vec),
                              grid=defn.cube_count,
                              smem_bytes=smem,
                              smem_opt_in=True)
