"""Synchronization + barrier + atomic frontends.

Reference: sync_cube (cubecl-core/src/frontend/synchronization.rs),
split barriers (frontend/barrier.rs; IR barrier.rs:11-20), atomics
(frontend/element/atomic.rs; IR atomic.rs:11-50).

On CUDA ``sync_cube`` is ``__syncthreads()``; in the torch evaluator the
units of a cube run in lockstep, so it orders nothing there. Barriers and
atomics trace as in the JAX package; the CUDA printer does not lower them
yet.
"""

from __future__ import annotations

from ..ir import ops as O
from ..ir.ops import Operation
from ..ir.types import Type, u32
from ..ir.value import VarKind, Value
from .element import active_builder, as_value, emit


def sync_cube() -> None:
    active_builder().scope.register(None, Operation(O.SYNC_CUBE))


def sync_plane() -> None:
    active_builder().scope.register(None, Operation(O.SYNC_PLANE))


def sync_storage() -> None:
    active_builder().scope.register(None, Operation(O.SYNC_STORAGE))


class Barrier:
    """Split arrive/wait barrier (reference barrier.rs:11-20)."""

    def __init__(self, level: str = "cube"):
        b = active_builder()
        self.value = Value(b.scope.state.alloc_vid(), Type(u32),
                           VarKind.BARRIER, payload={"level": level})
        b.scope.register(None, Operation(O.BARRIER_INIT, (self.value,)))

    def arrive(self) -> None:
        active_builder().scope.register(
            None, Operation(O.BARRIER_ARRIVE, (self.value,)))

    def wait(self) -> None:
        active_builder().scope.register(
            None, Operation(O.BARRIER_WAIT, (self.value,)))

    def arrive_and_wait(self) -> None:
        self.arrive()
        self.wait()

    def memcpy_async(self, dst, src, length=None) -> None:
        args = [self.value, dst.value, src.value]
        if length is not None:
            args.append(as_value(length))
        active_builder().scope.register(
            None, Operation(O.MEMCPY_ASYNC, tuple(args)))


# -- atomics ------------------------------------------------------------------


def _atomic_rmw(opcode):
    def f(buf, idx, val):
        ty = buf.ty.scalar()
        return emit(opcode, buf.value, idx, val, out_ty=ty)

    return f


atomic_add = _atomic_rmw(O.ATOMIC_ADD)
atomic_sub = _atomic_rmw(O.ATOMIC_SUB)
atomic_max = _atomic_rmw(O.ATOMIC_MAX)
atomic_min = _atomic_rmw(O.ATOMIC_MIN)
atomic_and = _atomic_rmw(O.ATOMIC_AND)
atomic_or = _atomic_rmw(O.ATOMIC_OR)
atomic_xor = _atomic_rmw(O.ATOMIC_XOR)
atomic_swap = _atomic_rmw(O.ATOMIC_SWAP)


def atomic_load(buf, idx):
    return emit(O.ATOMIC_LOAD, buf.value, idx, out_ty=buf.ty.scalar())


def atomic_store(buf, idx, val) -> None:
    active_builder().scope.register(None, Operation(
        O.ATOMIC_STORE, (buf.value, as_value(idx), as_value(val, buf.ty))))


def atomic_cas(buf, idx, cmp, val):
    return emit(O.ATOMIC_CAS, buf.value, idx, cmp, val, out_ty=buf.ty.scalar())
