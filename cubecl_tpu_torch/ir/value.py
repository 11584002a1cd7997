"""IR values, constants and builtins.

Reference: cubecl-ir/src/variable.rs:13-105. A ``Value`` is either a
versioned local produced by instructions, a kernel parameter (buffer /
scalar), a constant, or a builtin topology variable.

Builtins on the CUDA backend (a unit is a thread, a cube a block):

- ``UNIT_POS``       → ``threadIdx`` flattened x-fastest
- ``CUBE_POS_X/Y/Z`` → ``blockIdx``
- ``CUBE_DIM``       → threads per block (static per compilation)
- ``CUBE_COUNT``     → ``gridDim``
- ``PLANE_DIM``      → plane width: a warp (32), or the whole cube when it
                       has fewer than 32 units
- ``ABSOLUTE_POS``   → CUBE_POS * CUBE_DIM + UNIT_POS
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional

from .types import Type, index_ty


class Builtin(enum.Enum):
    # per-unit (reference Builtin, variable.rs:73-105)
    UNIT_POS = "UNIT_POS"
    UNIT_POS_X = "UNIT_POS_X"
    UNIT_POS_Y = "UNIT_POS_Y"
    UNIT_POS_Z = "UNIT_POS_Z"
    UNIT_POS_PLANE = "UNIT_POS_PLANE"
    ABSOLUTE_POS = "ABSOLUTE_POS"
    ABSOLUTE_POS_X = "ABSOLUTE_POS_X"
    ABSOLUTE_POS_Y = "ABSOLUTE_POS_Y"
    ABSOLUTE_POS_Z = "ABSOLUTE_POS_Z"
    # per-cube
    CUBE_POS = "CUBE_POS"
    CUBE_POS_X = "CUBE_POS_X"
    CUBE_POS_Y = "CUBE_POS_Y"
    CUBE_POS_Z = "CUBE_POS_Z"
    CUBE_DIM = "CUBE_DIM"
    CUBE_DIM_X = "CUBE_DIM_X"
    CUBE_DIM_Y = "CUBE_DIM_Y"
    CUBE_DIM_Z = "CUBE_DIM_Z"
    CUBE_COUNT = "CUBE_COUNT"
    CUBE_COUNT_X = "CUBE_COUNT_X"
    CUBE_COUNT_Y = "CUBE_COUNT_Y"
    CUBE_COUNT_Z = "CUBE_COUNT_Z"
    # cluster — parity with reference cluster builtins (variable.rs:80-99);
    # lowered as degenerate (dim 1)
    CUBE_CLUSTER_POS = "CUBE_CLUSTER_POS"
    CUBE_CLUSTER_POS_X = "CUBE_CLUSTER_POS_X"
    CUBE_CLUSTER_POS_Y = "CUBE_CLUSTER_POS_Y"
    CUBE_CLUSTER_POS_Z = "CUBE_CLUSTER_POS_Z"
    CUBE_CLUSTER_DIM = "CUBE_CLUSTER_DIM"
    # plane
    PLANE_DIM = "PLANE_DIM"
    PLANE_POS = "PLANE_POS"


#: builtins whose value varies across units within a cube (non-uniform);
#: everything else is cube-uniform. Consumed by the uniformity analysis
#: (reference cubecl-opt/src/analyses/uniformity.rs:13).
UNIT_VARYING = frozenset(
    {
        Builtin.UNIT_POS,
        Builtin.UNIT_POS_X,
        Builtin.UNIT_POS_Y,
        Builtin.UNIT_POS_Z,
        Builtin.UNIT_POS_PLANE,
        Builtin.ABSOLUTE_POS,
        Builtin.ABSOLUTE_POS_X,
        Builtin.ABSOLUTE_POS_Y,
        Builtin.ABSOLUTE_POS_Z,
        Builtin.PLANE_POS,
    }
)


class VarKind(enum.Enum):
    LOCAL = "local"            # immutable SSA-ish temp
    LOCAL_MUT = "local_mut"    # mutable local (loop carries, accumulators)
    CONSTANT = "const"
    BUILTIN = "builtin"
    BUFFER = "buffer"          # kernel buffer parameter (global memory)
    SCALAR = "scalar"          # kernel scalar parameter (kernel argument)
    SHARED = "shared"          # shared memory
    MATRIX = "matrix"          # CMMA fragment
    BARRIER = "barrier"        # opaque barrier object


@dataclass(eq=False)
class Value:
    """A single IR value. Identity-hashed; ``vid`` is unique per scope tree
    (reference Value/ValueKind, variable.rs:13-70)."""

    vid: int
    ty: Type
    kind: VarKind
    # constants: python number; builtins: Builtin; buffers/scalars: arg name
    payload: Any = None
    # buffers: static length in *lines*; shared: shape tuple
    shape: Optional[tuple] = None
    name: Optional[str] = None  # debug name

    @property
    def is_const(self) -> bool:
        return self.kind == VarKind.CONSTANT

    @property
    def const(self) -> Any:
        assert self.kind == VarKind.CONSTANT
        return self.payload

    def __repr__(self) -> str:
        if self.kind == VarKind.CONSTANT:
            return f"c({self.payload}:{self.ty})"
        if self.kind == VarKind.BUILTIN:
            return self.payload.value
        base = self.name or f"v{self.vid}"
        return f"{base}:{self.ty}"


def const_value(v: Any, ty: Type) -> Value:
    """Constants don't need scope-unique ids (never written)."""
    return Value(vid=-1, ty=ty, kind=VarKind.CONSTANT, payload=v)


def builtin_value(b: Builtin) -> Value:
    return Value(vid=-1, ty=Type(index_ty), kind=VarKind.BUILTIN, payload=b)
