"""The plain version of K0: an interpreter of the optimized scope in torch.

Counterpart of the JAX package's ``backend/pallas/eval.py`` with
``evaluator/{pure,control,plane}.py``, and the port's CPU twin: it runs a
traced ``@cube`` kernel with torch ops, on whatever device its tensors lie
on. ``CpuRuntime`` runs every kernel through it, and ``chip_smoke.py`` runs
it on the card as the oracle of the compiled CUDA kernels.

Execution model (SIMT in lockstep):

- every unit of every cube of the launch is one row of a tensor: a value
  is a ``(N, L)`` tensor, ``N = units per cube x cubes`` and ``L`` its
  line; a value that is the same for all units is kept as ``(1, L)`` and
  broadcast;
- divergent control flow runs under masks: a branch runs its body under
  ``mask & cond``; ``break``/``continue``/``return`` clear lanes of the
  mask; mutable locals are written with ``torch.where``;
- loads are ``index_select`` over the buffer's lines, stores a masked
  ``index_put_``; ``mem.*_masked`` read 0 / drop the write where the mask
  is false; an unmasked access out of bounds raises ``IndexError``;
- ``plane.*`` reduce or gather over groups of ``plane_dim`` units;
- ``sync.*`` order nothing: the units already run in lockstep;
- a cmma fragment (``mma.*``) is cube-scope: one ``(cubes, rows, cols)``
  tensor holds every cube's tile. ``load``/``store`` gather and scatter
  the buffer's elements at each cube's offset (which must be the same for
  all units of a cube), ``execute`` is ``torch.bmm`` in f32 (TF32 off),
  or exact for int8 operands, rounded to the accumulator's type and added
  to C, as the JAX evaluator's ``jnp.dot`` at ``Precision.HIGHEST``;
  a cube with no live unit keeps its fragments.

The same ops as the CUDA printer are lowered; the rest raise
``NotImplementedError`` through :func:`unsupported`. The TPU memory
machinery of the JAX evaluator (BlockSpec windows, superspans, ``WideRef``)
has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..ir import ops as O
from ..ir.scope import Scope
from ..ir.value import Builtin, Value, VarKind
from .compiler import (CompiledKernel, Compiler, KernelDefinition,
                       fragment_layout, prepare_scope, unsupported)


def _unary(fn):
    return lambda xs: fn(xs[0])


def _floordiv(a, b):
    if a.dtype.is_floating_point:
        return torch.floor(a / b)
    return torch.div(a, b, rounding_mode="floor")


# ops whose operands are cast to the result type first (the C printer
# computes them in the result's compute type too)
_SAME_TYPE = {
    O.ADD: lambda xs: xs[0] + xs[1],
    O.SUB: lambda xs: xs[0] - xs[1],
    O.MUL: lambda xs: xs[0] * xs[1],
    O.FLOORDIV: lambda xs: _floordiv(xs[0], xs[1]),
    O.MOD: lambda xs: torch.remainder(xs[0], xs[1]),
    O.REM: lambda xs: torch.fmod(xs[0], xs[1]),
    O.NEG: lambda xs: -xs[0],
    O.ABS: _unary(torch.abs),
    O.MAX: lambda xs: torch.maximum(xs[0], xs[1]),
    O.MIN: lambda xs: torch.minimum(xs[0], xs[1]),
    O.CLAMP: lambda xs: torch.minimum(torch.maximum(xs[0], xs[1]), xs[2]),
    O.FMA: lambda xs: xs[0] * xs[1] + xs[2],
    O.POW: lambda xs: torch.pow(xs[0], xs[1]),
    O.EXP: _unary(torch.exp),
    O.EXP2: _unary(torch.exp2),
    O.LOG: _unary(torch.log),
    O.LOG2: _unary(torch.log2),
    O.LOG1P: _unary(torch.log1p),
    O.SQRT: _unary(torch.sqrt),
    O.RSQRT: _unary(torch.rsqrt),
    O.RECIP: _unary(torch.reciprocal),
    O.SIN: _unary(torch.sin),
    O.COS: _unary(torch.cos),
    O.TAN: _unary(torch.tan),
    O.ASIN: _unary(torch.asin),
    O.ACOS: _unary(torch.acos),
    O.ATAN: _unary(torch.atan),
    O.ATAN2: lambda xs: torch.atan2(xs[0], xs[1]),
    O.SINH: _unary(torch.sinh),
    O.COSH: _unary(torch.cosh),
    O.TANH: _unary(torch.tanh),
    O.ERF: _unary(torch.erf),
    O.FLOOR: _unary(torch.floor),
    O.CEIL: _unary(torch.ceil),
    O.ROUND: _unary(torch.round),
    O.TRUNC: _unary(torch.trunc),
    O.SIGN: _unary(torch.sign),
    O.BAND: lambda xs: xs[0] & xs[1],
    O.BOR: lambda xs: xs[0] | xs[1],
    O.BXOR: lambda xs: xs[0] ^ xs[1],
    O.BNOT: lambda xs: ~xs[0],
    O.SHL: lambda xs: xs[0] << xs[1],
    O.SHR: lambda xs: xs[0] >> xs[1],
    O.COPY: lambda xs: xs[0],
}

_COMPARE = {
    O.EQ: torch.eq, O.NE: torch.ne, O.LT: torch.lt, O.LE: torch.le,
    O.GT: torch.gt, O.GE: torch.ge,
}

_LOGIC = {
    O.AND: lambda xs: xs[0] & xs[1],
    O.OR: lambda xs: xs[0] | xs[1],
    O.NOT: lambda xs: ~xs[0],
    O.IS_NAN: _unary(torch.isnan),
    O.IS_INF: _unary(torch.isinf),
}

_PLANE_REDUCE = {
    O.PLANE_SUM: lambda g: g.sum(1, keepdim=True),
    O.PLANE_PROD: lambda g: g.prod(1, keepdim=True),
    O.PLANE_MAX: lambda g: g.amax(1, keepdim=True),
    O.PLANE_MIN: lambda g: g.amin(1, keepdim=True),
    O.PLANE_ALL: lambda g: g.all(1, keepdim=True),
    O.PLANE_ANY: lambda g: g.any(1, keepdim=True),
}

_PLANE_GATHER = (O.PLANE_BROADCAST, O.PLANE_SHUFFLE, O.PLANE_SHUFFLE_XOR,
                 O.PLANE_SHUFFLE_UP, O.PLANE_SHUFFLE_DOWN)

_NO_OP = (O.COMMENT, O.SYNC_CUBE, O.SYNC_PLANE, O.SYNC_STORAGE)

_MMA_OPS = (O.MMA_FILL, O.MMA_LOAD, O.MMA_STORE, O.MMA_EXECUTE,
            O.MMA_EXECUTE_SCALED, O.MMA_CAST)


def _bmm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """Batched a @ b exactly as the fragments' execute: float operands in
    f32 with TF32 off; integer operands exactly (int64 on the CPU, float64
    on a card, exact while |sum| < 2^53), wrapped to ``out_dtype``."""
    if not out_dtype.is_floating_point:
        if a.device.type == "cpu":
            return torch.bmm(a.long(), b.long()).to(out_dtype)
        return torch.bmm(a.double(), b.double()).long().to(out_dtype)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.bmm(a.float(), b.float()).to(out_dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old

# the value ops _pure lowers besides the tables above
_PURE_OPS = frozenset(_SAME_TYPE) | frozenset(_COMPARE) | frozenset(_LOGIC) \
    | {O.DIV, O.CAST, O.SELECT, O.VEC_SPLAT, O.VEC_INIT, O.VEC_EXTRACT,
       O.VEC_INSERT, O.VEC_SUM, O.VEC_MAX, O.VEC_MIN, O.DOT}


class _Loop:
    """Lanes that left the innermost loop (``brk``) or skip the rest of
    the current iteration (``cont``)."""

    def __init__(self, like: torch.Tensor):
        self.brk = torch.zeros_like(like)
        self.cont = torch.zeros_like(like)


class Evaluator:
    """Runs one launch of ``defn`` on ``tensors`` (in parameter order)."""

    def __init__(self, defn: KernelDefinition, tensors, scalars):
        st = defn.state
        self.defn = defn
        self.U = math.prod(defn.cube_dim)
        self.N = self.U * math.prod(defn.cube_count)
        self.plane = defn.plane_dim
        self.dev = tensors[0].device if tensors else torch.device("cpu")
        self.bufs: Dict[int, torch.Tensor] = {}
        self.lens: Dict[int, int] = {}
        for bp, t in zip(st.buffers, tensors):
            self.bufs[bp.value.vid] = t.view(-1, bp.ty.line)
            self.lens[bp.value.vid] = bp.length
        self.env: Dict[int, torch.Tensor] = {}
        for sp, v in zip(st.scalars, scalars):
            self.env[sp.value.vid] = self._full(v, sp.ty)
        for bp in st.buffers:
            if bp.dyn_len is not None:
                self.lens[bp.value.vid] = int(self.env[bp.dyn_len.vid])
        self._builtins: Dict[Builtin, torch.Tensor] = {}
        ones = torch.ones(self.N, 1, dtype=torch.bool, device=self.dev)
        self.all_lanes = ones
        self.returned = torch.zeros_like(ones)
        self.loops: List[_Loop] = []
        self.cubes = math.prod(defn.cube_count)
        self.frags: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------ values

    def _full(self, v, ty) -> torch.Tensor:
        return torch.full((1, 1), v, dtype=ty.elem.torch_dtype(),
                          device=self.dev)

    def builtin(self, b: Builtin) -> torch.Tensor:
        t = self._builtins.get(b)
        if t is None:
            t = self._make_builtin(b)
            self._builtins[b] = t
        return t

    def _make_builtin(self, b: Builtin) -> torch.Tensor:
        ux, uy, _uz = self.defn.cube_dim
        cx, cy, _cz = self.defn.cube_count
        g = torch.arange(self.N, dtype=torch.int32,
                         device=self.dev).view(-1, 1)
        unit, cube = g % self.U, g // self.U
        pos = {
            Builtin.UNIT_POS: lambda: unit,
            Builtin.UNIT_POS_X: lambda: unit % ux,
            Builtin.UNIT_POS_Y: lambda: (unit // ux) % uy,
            Builtin.UNIT_POS_Z: lambda: unit // (ux * uy),
            Builtin.CUBE_POS: lambda: cube,
            Builtin.CUBE_POS_X: lambda: cube % cx,
            Builtin.CUBE_POS_Y: lambda: (cube // cx) % cy,
            Builtin.CUBE_POS_Z: lambda: cube // (cx * cy),
            Builtin.ABSOLUTE_POS: lambda: g,
            Builtin.UNIT_POS_PLANE: lambda: unit % self.plane,
            Builtin.PLANE_POS: lambda: unit // self.plane,
        }
        if b in pos:
            return pos[b]()
        axis = {Builtin.ABSOLUTE_POS_X: (Builtin.CUBE_POS_X,
                                         Builtin.UNIT_POS_X, ux),
                Builtin.ABSOLUTE_POS_Y: (Builtin.CUBE_POS_Y,
                                         Builtin.UNIT_POS_Y, uy),
                Builtin.ABSOLUTE_POS_Z: (Builtin.CUBE_POS_Z,
                                         Builtin.UNIT_POS_Z,
                                         self.defn.cube_dim[2])}
        if b in axis:
            c, u, n = axis[b]
            return self.builtin(c) * n + self.builtin(u)
        # CUBE_DIM*, CUBE_COUNT*, PLANE_DIM are folded to constants by
        # optimize_scope; a runtime grid is not lowered
        raise unsupported(f"builtin {b.value}", "the torch evaluator")

    def val(self, v: Value) -> torch.Tensor:
        if v.kind == VarKind.CONSTANT:
            return self._full(v.const, v.ty)
        if v.kind == VarKind.BUILTIN:
            return self.builtin(v.payload)
        t = self.env.get(v.vid)
        if t is None:
            if v.kind == VarKind.LOCAL_MUT:
                # a mutable local assigned on no active lane yet reads 0,
                # where a CUDA register would hold garbage
                return torch.zeros(1, v.ty.line,
                                   dtype=v.ty.elem.torch_dtype(),
                                   device=self.dev)
            raise RuntimeError(f"torch evaluator: {v!r} read before it "
                               "was computed")
        return t

    # -------------------------------------------------------------- run

    def run_kernel(self) -> None:
        self.run(self.defn.scope, self.all_lanes)

    def _dead(self) -> torch.Tensor:
        dead = self.returned
        if self.loops:
            dead = dead | self.loops[-1].brk | self.loops[-1].cont
        return dead

    def run(self, scope: Scope, mask: torch.Tensor) -> None:
        for inst in scope.instructions:
            act = mask & ~self._dead()
            self.exec(inst, mask, act)

    def exec(self, inst, mask, act) -> None:
        op = inst.op
        oc = op.opcode
        if oc in (O.IF, O.IF_ELSE):
            c = self.val(op.args[0]).bool()
            then_m = act & c
            if bool(then_m.any()):
                self.run(op.attrs["then"], then_m)
            if oc == O.IF_ELSE:
                else_m = act & ~c
                if bool(else_m.any()):
                    self.run(op.attrs["orelse"], else_m)
        elif oc == O.SWITCH:
            v = self.val(op.args[0])
            rest = act
            for case, sub in op.attrs.get("cases", []):
                hit = v == case
                m = rest & hit
                if bool(m.any()):
                    self.run(sub, m)
                rest = rest & ~hit
            default = op.attrs.get("default")
            if default is not None and bool(rest.any()):
                self.run(default, rest)
        elif oc == O.RANGE_LOOP:
            self._range_loop(inst, act)
        elif oc in (O.WHILE, O.LOOP):
            self._loop(inst, act)
        elif oc == O.BREAK:
            self.loops[-1].brk = self.loops[-1].brk | act
        elif oc == O.CONTINUE:
            self.loops[-1].cont = self.loops[-1].cont | act
        elif oc in (O.RETURN, O.TERMINATE):
            self.returned = self.returned | act
        elif oc in (O.STORE, O.STORE_MASKED):
            self._store(inst, act)
        elif oc in _NO_OP:
            pass
        elif oc in _MMA_OPS:
            self._mma(inst, act)
        elif inst.out is None:
            raise unsupported(oc, "the torch evaluator")
        else:
            res = self._pure(inst, act)
            out = inst.out
            if out.kind == VarKind.LOCAL_MUT:
                # a loop-carry writeback runs on every lane alive at the
                # start of the iteration (see builder._finish_carries)
                m = mask if op.attrs.get("carry_writeback") else act
                old = self.env.get(out.vid)
                self.env[out.vid] = res if old is None else \
                    torch.where(m, res, old)
            else:
                self.env[out.vid] = res

    def _range_loop(self, inst, act) -> None:
        op = inst.op
        start, stop, step = (self.val(a) for a in op.args)
        var, body = op.attrs["var"], op.attrs["body"]
        incl = bool(op.attrs.get("inclusive", False))
        loop = _Loop(act)
        self.loops.append(loop)
        try:
            if start.numel() == stop.numel() == step.numel() == 1:
                s, e, st = int(start), int(stop), int(step)
                if st == 0:
                    raise ValueError("range loop with step 0")
                end = e + (1 if st > 0 else -1) if incl else e
                for i in range(s, end, st):
                    m = act & ~loop.brk & ~self.returned
                    if not bool(m.any()):
                        break
                    loop.cont = torch.zeros_like(act)
                    self.env[var.vid] = self._full(i, var.ty)
                    self.run(body, m)
                return
            k = 0
            while True:
                i = start + k * step
                up = step > 0
                live = torch.where(up, (i <= stop) if incl else (i < stop),
                                   (i >= stop) if incl else (i > stop))
                m = act & live & ~loop.brk & ~self.returned
                if not bool(m.any()):
                    break
                loop.cont = torch.zeros_like(act)
                self.env[var.vid] = i.to(var.ty.elem.torch_dtype())
                self.run(body, m)
                k += 1
        finally:
            self.loops.pop()

    def _loop(self, inst, act) -> None:
        op = inst.op
        loop = _Loop(act)
        self.loops.append(loop)
        try:
            while True:
                m = act & ~loop.brk & ~self.returned
                if op.opcode == O.WHILE:
                    self.run(op.attrs["cond_scope"], m)
                    c = self.val(op.attrs["cond_value"]).bool()
                    loop.brk = loop.brk | (m & ~c)
                    m = m & c
                if not bool(m.any()):
                    break
                loop.cont = torch.zeros_like(act)
                self.run(op.attrs["body"], m)
        finally:
            self.loops.pop()

    # ------------------------------------------------------------ memory

    def _buffer(self, v: Value) -> torch.Tensor:
        if v.kind != VarKind.BUFFER:
            raise unsupported(f"{v.kind.value} memory", "the torch evaluator")
        return self.bufs[v.vid]

    def _lines(self, buf: Value, idx: torch.Tensor, live: torch.Tensor,
               what: str) -> torch.Tensor:
        """Line indices, with a check that no live lane is out of bounds;
        dead lanes are clamped so that their gather stays in range."""
        n = self.lens[buf.vid]
        idx = idx.long()
        bad = live & ((idx < 0) | (idx >= n))
        if bool(bad.any()):
            lane = int(bad.view(-1).nonzero()[0])
            raise IndexError(
                f"{self.defn.options.name}: unchecked {what} of "
                f"{buf.name or buf!r} at line "
                f"{int(idx.expand(self.N, 1)[lane])} outside [0, {n}) by "
                f"unit {lane}; launch it checked or fix the plan")
        return idx.clamp(0, max(n - 1, 0))

    def _load(self, inst, act) -> torch.Tensor:
        op = inst.op
        t = self._buffer(op.args[0])
        idx = self.val(op.args[1])
        if op.opcode == O.INDEX_MASKED:
            m = self.val(op.args[2]).bool()
            rows = self._lines(op.args[0], idx, act & m, "read")
            got = t.index_select(0, rows.view(-1)).view(rows.shape[0], -1)
            return torch.where(m, got, torch.zeros((), dtype=t.dtype,
                                                   device=t.device))
        rows = self._lines(op.args[0], idx, act, "read")
        return t.index_select(0, rows.view(-1)).view(rows.shape[0], -1)

    def _store(self, inst, act) -> None:
        op = inst.op
        buf = op.args[0]
        t = self._buffer(buf)
        live = act
        if op.opcode == O.STORE_MASKED:
            live = live & self.val(op.args[3]).bool()
        rows = self._lines(buf, self.val(op.args[1]), live, "write")
        rows = rows.expand(self.N, 1).reshape(-1)
        v = self.val(op.args[2]).to(t.dtype).expand(self.N, t.shape[1])
        sel = live.view(-1)
        t.index_put_((rows[sel],), v[sel])

    # -------------------------------------------------------------- cmma

    def _per_cube(self, v: Value, what: str) -> torch.Tensor:
        """(cubes,) values of ``v``, the same for every unit of a cube."""
        t = self.val(v).expand(self.N, 1).reshape(self.cubes, self.U)
        if not bool((t == t[:, :1]).all()):
            raise unsupported(f"a unit-varying {what}", "the torch evaluator")
        return t[:, 0]

    def _frag(self, m: Value) -> torch.Tensor:
        t = self.frags.get(m.vid)
        if t is None:  # never written: an uninitialized tile reads 0
            t = torch.zeros((self.cubes, *m.shape),
                            dtype=m.ty.elem.torch_dtype(), device=self.dev)
        return t

    def _set_frag(self, m: Value, new: torch.Tensor, live) -> None:
        new = new.to(m.ty.elem.torch_dtype())
        self.frags[m.vid] = torch.where(live.view(-1, 1, 1), new,
                                        self._frag(m))

    def _frag_index(self, inst, live) -> torch.Tensor:
        """(cubes, rows, cols) element indices into the buffer of a load
        or store, bounds-checked on the live cubes."""
        op = inst.op
        mat, buf = op.args[0], op.args[1]
        rows, cols = mat.shape
        off = self._per_cube(op.args[2], "cmma offset").long()
        st = _uniform_int(self.val(op.args[3]), "cmma stride")
        r = torch.arange(rows, device=self.dev).view(1, rows, 1)
        c = torch.arange(cols, device=self.dev).view(1, 1, cols)
        if op.attrs.get("layout", "row_major") == "row_major":
            idx = off.view(-1, 1, 1) + r * st + c
        else:
            idx = off.view(-1, 1, 1) + c * st + r
        n = self.bufs[buf.vid].numel()
        bad = live.view(-1, 1, 1) & ((idx < 0) | (idx >= n))
        if bool(bad.any()):
            raise IndexError(
                f"{self.defn.options.name}: cmma {op.opcode} of "
                f"{buf.name or buf!r} outside its {n} elements")
        return idx.clamp(0, max(n - 1, 0))

    def _mma(self, inst, act) -> None:
        op = inst.op
        oc = op.opcode
        args = op.args
        live = act.expand(self.N, 1).reshape(self.cubes, self.U).any(1)
        if oc == O.MMA_FILL:
            mat = args[0]
            v = self._per_cube(args[1], "cmma fill value")
            new = v.view(-1, 1, 1).expand(self.cubes, *mat.shape)
            self._set_frag(mat, new, live)
        elif oc == O.MMA_LOAD:
            mat, buf = args[0], args[1]
            idx = self._frag_index(inst, live)
            flat = self.bufs[buf.vid].reshape(-1)
            self._set_frag(mat, flat[idx.reshape(-1)].view(idx.shape), live)
        elif oc == O.MMA_STORE:
            mat, buf = args[0], args[1]
            idx = self._frag_index(inst, live)[live]
            flat = self.bufs[buf.vid].view(-1)
            flat.index_put_((idx.reshape(-1),),
                            self._frag(mat)[live].reshape(-1).to(flat.dtype))
        elif oc in (O.MMA_EXECUTE, O.MMA_EXECUTE_SCALED):
            a, b, c, d = args[:4]
            am, bm = self._frag(a), self._frag(b)
            dt = d.ty.elem.torch_dtype()
            if oc == O.MMA_EXECUTE_SCALED:
                sa = self._per_cube(args[4], "cmma scale").float()
                sb = self._per_cube(args[5], "cmma scale").float()
                am = am.float() * sa.view(-1, 1, 1)
                bm = bm.float() * sb.view(-1, 1, 1)
            prod = _bmm(am, bm, dt)
            self._set_frag(d, prod + self._frag(c).to(dt), live)
        else:  # O.MMA_CAST
            self._set_frag(args[0], self._frag(args[1]), live)

    # ------------------------------------------------------------- pure

    def _pure(self, inst, act) -> torch.Tensor:
        op = inst.op
        oc = op.opcode
        out = inst.out
        dt = out.ty.elem.torch_dtype()
        if oc in (O.INDEX, O.INDEX_MASKED):
            return self._load(inst, act)
        if oc == O.BUFFER_LEN:
            return self._full(self.lens[op.args[0].vid], out.ty)
        if oc in (O.SHAPE_DIM, O.STRIDE_DIM, O.RANK):
            return self._full(_tensor_meta(self.defn, op), out.ty)
        if oc == O.BLOCK_REDUCE:
            return self._block_reduce(inst, act)
        if oc == O.REINTERPRET:
            # the bits of each unit's line as dt; the line absorbs the
            # width ratio ((N, L) of 4-byte elements is (N, 4 L) bytes)
            return self.val(op.args[0]).contiguous().view(dt)
        if oc in _PLANE_REDUCE or oc in _PLANE_GATHER or \
                oc == O.PLANE_ELECT:
            return self._plane(inst)
        if oc not in _PURE_OPS:
            raise unsupported(oc, "the torch evaluator")
        xs = [self.val(a) for a in op.args]
        if oc in _SAME_TYPE:
            return _SAME_TYPE[oc]([x.to(dt) for x in xs])
        if oc == O.DIV:
            a, b = (x.to(dt) for x in xs)
            return a / b if dt.is_floating_point else _floordiv(a, b)
        if oc in _COMPARE:
            ct = torch.promote_types(xs[0].dtype, xs[1].dtype)
            return _COMPARE[oc](xs[0].to(ct), xs[1].to(ct))
        if oc in _LOGIC:
            return _LOGIC[oc](xs)
        if oc == O.CAST:
            return xs[0].to(dt)
        if oc == O.SELECT:
            return torch.where(xs[0].bool(), xs[1].to(dt), xs[2].to(dt))
        if oc == O.VEC_SPLAT:
            return xs[0].to(dt).expand(xs[0].shape[0], out.ty.line)
        if oc == O.VEC_INIT:
            n = max(x.shape[0] for x in xs)
            return torch.cat([x.to(dt).expand(n, 1) for x in xs], dim=1)
        if oc == O.VEC_EXTRACT:
            i = _uniform_int(xs[1], "lane index of op.vec_extract")
            return xs[0][:, i:i + 1]
        if oc == O.VEC_INSERT:
            i = _uniform_int(xs[1], "lane index of op.vec_insert")
            x, v = xs[0], xs[2].to(dt)
            n = max(x.shape[0], v.shape[0])
            y = x.expand(n, x.shape[1]).clone()
            y[:, i:i + 1] = v
            return y
        if oc == O.VEC_SUM:
            return xs[0].sum(-1, keepdim=True, dtype=torch.float32).to(dt) \
                if xs[0].dtype in (torch.bfloat16, torch.float16) \
                else xs[0].sum(-1, keepdim=True)
        if oc == O.VEC_MAX:
            return xs[0].amax(-1, keepdim=True)
        if oc == O.VEC_MIN:
            return xs[0].amin(-1, keepdim=True)
        if oc == O.DOT:
            return (xs[0].to(dt) * xs[1].to(dt)).sum(-1, keepdim=True)
        raise unsupported(oc, "the torch evaluator")

    def _block_reduce(self, inst, act) -> torch.Tensor:
        """``mem.block_reduce``: every cube reduces the buffer's lines
        [start, start + lines) to one value that all its units hold; the
        start must be the same for every unit of a cube. Sums and
        products of sub-f32 floats accumulate in f32 and are cast back to
        the buffer's type, as the JAX evaluator does."""
        op = inst.op
        buf = op.args[0]
        t = self._buffer(buf)
        lines, kind = int(op.attrs["lines"]), op.attrs["kind"]
        start = self._per_cube(op.args[1], "block_reduce start").long()
        rows = start.view(-1, 1) + torch.arange(lines, device=self.dev)
        live = act.expand(self.N, 1).reshape(self.cubes, self.U).any(1)
        n = self.lens[buf.vid]
        bad = live.view(-1, 1) & ((rows < 0) | (rows >= n))
        if bool(bad.any()):
            raise IndexError(
                f"{self.defn.options.name}: block_reduce of "
                f"{buf.name or buf!r} reads lines outside [0, {n})")
        win = t[rows.clamp(0, max(n - 1, 0))].reshape(self.cubes, -1)
        acc = torch.float32 if (t.dtype in (torch.bfloat16, torch.float16)
                                and kind in ("sum", "prod")) else t.dtype
        red = {"sum": lambda w: w.sum(1), "prod": lambda w: w.prod(1),
               "max": lambda w: w.amax(1), "min": lambda w: w.amin(1)}[kind]
        val = red(win.to(acc)).to(t.dtype)
        return val.repeat_interleave(self.U).view(self.N, 1)

    def _plane(self, inst) -> torch.Tensor:
        op = inst.op
        oc = op.opcode
        P, N = self.plane, self.N
        if self.U % P:
            raise unsupported(f"{oc} on a partial plane ({self.U} units, "
                              f"plane {P})", "the torch evaluator")
        lane = self.builtin(Builtin.UNIT_POS) % P
        if oc == O.PLANE_ELECT:
            return lane == 0
        x = self.val(op.args[0])
        L = x.shape[1]
        x = x.expand(N, L)
        if oc in _PLANE_REDUCE:
            red = _PLANE_REDUCE[oc](x.reshape(N // P, P, L))
            return red.expand(N // P, P, L).reshape(N, L)
        a = self.val(op.args[1]).to(torch.int32)
        if oc in (O.PLANE_BROADCAST, O.PLANE_SHUFFLE):
            src = a % P
        elif oc == O.PLANE_SHUFFLE_XOR:
            src = (lane ^ a).clamp(0, P - 1)
        elif oc == O.PLANE_SHUFFLE_UP:
            src = torch.where(lane - a < 0, lane, lane - a)
        else:  # PLANE_SHUFFLE_DOWN
            src = torch.where(lane + a >= P, lane, lane + a)
        first = self.builtin(Builtin.ABSOLUTE_POS) - lane
        rows = (first + src).expand(N, 1).reshape(-1).long()
        return x.index_select(0, rows)


def _uniform_int(t: torch.Tensor, what: str) -> int:
    if t.numel() != 1:
        flat = t.reshape(-1)
        if not bool((flat == flat[0]).all()):
            raise unsupported(f"a unit-varying {what}", "the torch evaluator")
    return int(t.reshape(-1)[0])


def _tensor_meta(defn: KernelDefinition, op) -> int:
    bp = next(b for b in defn.state.buffers
              if b.value.vid == op.args[0].vid)
    if op.opcode == O.RANK:
        return len(bp.shape)
    dim = op.attrs["dim"]
    return (bp.shape if op.opcode == O.SHAPE_DIM else bp.strides)[dim]


class TorchEvalCompiler(Compiler):
    """Compiles a definition into an :class:`Evaluator` run: the passes of
    :func:`prepare_scope`, then interpretation at launch."""

    name = "torch-eval"

    def compile(self, defn: KernelDefinition,
                kernel_id: str = "") -> CompiledKernel:
        if defn.dynamic_grid_vid is not None:
            raise unsupported("a runtime grid (CubeCount.runtime)",
                              "the torch evaluator")
        prepare_scope(defn)
        st = defn.state
        mut = [i for i, bp in enumerate(st.buffers) if bp.mutable]

        def fn(tensors, scalars=()):
            Evaluator(defn, tensors, scalars).run_kernel()

        return CompiledKernel(fn=fn, mutable_indices=mut,
                              source=repr(defn.scope),
                              name=defn.options.name, block=defn.cube_dim,
                              grid=defn.cube_count,
                              smem_bytes=fragment_layout(st)[1],
                              smem_opt_in=True)
