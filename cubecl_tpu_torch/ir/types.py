"""Type system of the kernel IR (counterpart of ``cubecl_tpu.ir.types``).

Element kinds, storage types (scalar vs line) and full types, as in the
reference type system (cubecl-ir/src/type.rs:17-453). Each element type
names the ``torch`` dtype it lowers to (``torch_name``) and its support
level on the CUDA backend (an H100):

- native: f64, f32, bf16, f16, fp8 e4m3/e5m2 (storage and conversion),
  i8..i64, u8..u64, bool
- unsupported as a storage type: tf32 (a tensor-core input format only)
  and the fp4/fp6/ue8m0 sub-byte formats

``Flex32`` maps to f32 storage with relaxed-precision math flags, like the
reference's relaxed float (cubecl-common/src/float/relaxed.rs).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class Support(enum.Enum):
    """CUDA support level for an element kind."""

    NATIVE = "native"
    EMULATED = "emulated"
    UNSUPPORTED = "unsupported"


class ElemKind(enum.Enum):
    FLOAT = "float"
    INT = "int"
    UINT = "uint"
    BOOL = "bool"


@dataclass(frozen=True)
class ElemType:
    """A scalar element type (reference: ``ElemType`` cubecl-ir/src/type.rs:64).

    ``name`` is the canonical name used in kernel ids and the capability
    table; ``torch_name`` is the ``torch`` dtype it lowers to (None when it
    has no storage type).
    """

    name: str
    kind: ElemKind
    bits: int
    torch_name: Optional[str]
    support: Support = Support.NATIVE
    # exponent/mantissa for minifloats (used by quant + feature registry)
    exponent: Optional[int] = None
    mantissa: Optional[int] = None

    @property
    def size(self) -> int:
        """Size in bytes (rounded up for sub-byte types)."""
        return max(1, (self.bits + 7) // 8)

    @property
    def is_float(self) -> bool:
        return self.kind == ElemKind.FLOAT

    @property
    def is_int(self) -> bool:
        return self.kind in (ElemKind.INT, ElemKind.UINT)

    @property
    def is_signed(self) -> bool:
        return self.kind in (ElemKind.INT, ElemKind.FLOAT)

    @property
    def is_bool(self) -> bool:
        return self.kind == ElemKind.BOOL

    def torch_dtype(self):
        """The ``torch`` dtype of this element type."""
        if self.torch_name is None:
            raise TypeError(f"element type {self.name} has no torch dtype")
        import torch

        return getattr(torch, self.torch_name)

    def __repr__(self) -> str:  # compact for kernel ids
        return self.name


# ---------------------------------------------------------------------------
# The element type registry (reference FloatKind/IntKind/UIntKind,
# cubecl-ir/src/type.rs:17-62)
# ---------------------------------------------------------------------------

f64 = ElemType("f64", ElemKind.FLOAT, 64, "float64", Support.NATIVE)
f32 = ElemType("f32", ElemKind.FLOAT, 32, "float32", Support.NATIVE)
flex32 = ElemType("flex32", ElemKind.FLOAT, 32, "float32", Support.NATIVE)
tf32 = ElemType("tf32", ElemKind.FLOAT, 19, None, Support.UNSUPPORTED)
bf16 = ElemType("bf16", ElemKind.FLOAT, 16, "bfloat16", Support.NATIVE)
f16 = ElemType("f16", ElemKind.FLOAT, 16, "float16", Support.NATIVE)
fp8_e4m3 = ElemType(
    "fp8_e4m3", ElemKind.FLOAT, 8, "float8_e4m3fn", Support.NATIVE, 4, 3
)
fp8_e5m2 = ElemType(
    "fp8_e5m2", ElemKind.FLOAT, 8, "float8_e5m2", Support.NATIVE, 5, 2
)
fp8_ue8m0 = ElemType("fp8_ue8m0", ElemKind.FLOAT, 8, None, Support.UNSUPPORTED, 8, 0)
fp6_e2m3 = ElemType("fp6_e2m3", ElemKind.FLOAT, 6, None, Support.UNSUPPORTED, 2, 3)
fp6_e3m2 = ElemType("fp6_e3m2", ElemKind.FLOAT, 6, None, Support.UNSUPPORTED, 3, 2)
fp4_e2m1 = ElemType("fp4_e2m1", ElemKind.FLOAT, 4, None, Support.UNSUPPORTED, 2, 1)

i64 = ElemType("i64", ElemKind.INT, 64, "int64", Support.NATIVE)
i32 = ElemType("i32", ElemKind.INT, 32, "int32", Support.NATIVE)
i16 = ElemType("i16", ElemKind.INT, 16, "int16", Support.NATIVE)
i8 = ElemType("i8", ElemKind.INT, 8, "int8", Support.NATIVE)
u64 = ElemType("u64", ElemKind.UINT, 64, "uint64", Support.NATIVE)
u32 = ElemType("u32", ElemKind.UINT, 32, "uint32", Support.NATIVE)
u16 = ElemType("u16", ElemKind.UINT, 16, "uint16", Support.NATIVE)
u8 = ElemType("u8", ElemKind.UINT, 8, "uint8", Support.NATIVE)
bool_ = ElemType("bool", ElemKind.BOOL, 8, "bool", Support.NATIVE)

ALL_ELEM_TYPES = {
    t.name: t
    for t in (
        f64, f32, flex32, tf32, bf16, f16,
        fp8_e4m3, fp8_e5m2, fp8_ue8m0, fp6_e2m3, fp6_e3m2, fp4_e2m1,
        i64, i32, i16, i8, u64, u32, u16, u8, bool_,
    )
}

_NAME_TO_ELEM = {
    "float64": f64,
    "float32": f32,
    "bfloat16": bf16,
    "float16": f16,
    "float8_e4m3fn": fp8_e4m3,
    "float8_e5m2": fp8_e5m2,
    "int64": i64,
    "int32": i32,
    "int16": i16,
    "int8": i8,
    "uint64": u64,
    "uint32": u32,
    "uint16": u16,
    "uint8": u8,
    "bool": bool_,
}


def elem_from_dtype(dtype) -> ElemType:
    """Map a torch or numpy dtype (or its name) to the IR element type."""
    import numpy as np

    if isinstance(dtype, str) and dtype in _NAME_TO_ELEM:
        return _NAME_TO_ELEM[dtype]
    name = str(dtype)
    if name.startswith("torch."):
        name = name[len("torch."):]
    elif name not in _NAME_TO_ELEM:
        name = np.dtype(dtype).name
    try:
        return _NAME_TO_ELEM[name]
    except KeyError:
        raise TypeError(f"no IR element type for dtype {name}") from None


# Default index type for positions / lengths. The reference uses u32
# (AddressType, cubecl-core codegen/integrator.rs:30); the JAX package uses
# i32, and so does the port, so that traced scopes match.
index_ty = i32


@dataclass(frozen=True)
class Type:
    """Full value type: element + line (vector) size.

    Mirrors the reference ``Type``/``StorageType`` pair
    (cubecl-ir/src/type.rs:89,453). ``line`` is the packed width; on CUDA
    a line is a per-thread array. ``line == 1`` means scalar storage.
    """

    elem: ElemType
    line: int = 1

    @property
    def size(self) -> int:
        return self.elem.size * self.line

    def scalar(self) -> "Type":
        return Type(self.elem, 1)

    def with_line(self, line: int) -> "Type":
        return Type(self.elem, line)

    def __repr__(self) -> str:
        return self.elem.name if self.line == 1 else f"{self.elem.name}x{self.line}"


class AddressSpace(enum.Enum):
    """Where a buffer lives (reference AddressSpace, type.rs:445). The
    names are the JAX package's; on CUDA: HBM is global memory, VMEM is
    shared memory, REG registers or local memory, SMEM kernel arguments."""

    HBM = "hbm"
    VMEM = "vmem"
    REG = "reg"
    SMEM = "smem"
