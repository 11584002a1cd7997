"""cubecl_tpu_torch.ir — the kernel IR (reference crate: cubecl-ir).

Pure Python (importable without torch's CUDA, like the reference's no_std
cubecl-ir crate). The frontend traces into a ``Scope``; the optimizer
rewrites it; the CUDA printer and the torch evaluator lower it.
"""

from . import ops
from .features import (
    DeviceIdentity,
    DeviceProperties,
    Features,
    HardwareProperties,
    WARP,
    cpu_device_properties,
    cuda_device_properties,
)
from .ops import Instruction, Operation, OPS, OpInfo
from .scope import BufferParam, GlobalState, ScalarParam, Scope, SharedDecl, walk
from .types import (
    ALL_ELEM_TYPES,
    AddressSpace,
    ElemKind,
    ElemType,
    Support,
    Type,
    bf16,
    bool_,
    elem_from_dtype,
    f16,
    f32,
    f64,
    flex32,
    fp8_e4m3,
    fp8_e5m2,
    i8,
    i16,
    i32,
    i64,
    index_ty,
    tf32,
    u8,
    u16,
    u32,
    u64,
)
from .value import (
    Builtin,
    UNIT_VARYING,
    Value,
    VarKind,
    builtin_value,
    const_value,
)
