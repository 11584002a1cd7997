"""Device features and properties for the CUDA backend (an H100).

Counterpart of ``cubecl_tpu.ir.features``: ``Features`` (reference
cubecl-ir/src/features.rs:10) and
``HardwareProperties``/``DeviceProperties``/``DeviceIdentity``
(cubecl-ir/src/properties.rs:26-98), published through
``client.properties()`` as in the reference. The values are Hopper's
(sm_90): a warp of 32 threads, at most 1024 threads and 227 KiB of shared
memory per block; the SM count is read from the card when there is one.

What the CUDA printer lowers today is narrower than what the card offers:
``backend/cuda/printer.py`` raises for the ops it has no lowering for
(atomics, cmma, shared memory, barriers), so those features are not
advertised here.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from . import types as t
from .types import ElemType

#: threads of a warp, the plane of the CUDA backend
WARP = 32


@dataclass
class HardwareProperties:
    """reference HardwareProperties, properties.rs:26-60, for sm_90."""

    plane_size_min: int = WARP
    plane_size_max: int = WARP
    max_bindings: int = 64
    max_shared_memory_size: int = 227 * 1024   # per block, dynamic smem
    max_cube_count: Tuple[int, int, int] = (2**31 - 1, 65535, 65535)
    max_units_per_cube: int = 1024
    max_cube_dim: Tuple[int, int, int] = (1024, 1024, 64)
    num_streaming_multiprocessors: Optional[int] = None
    load_width: int = 128            # bits: one 16-byte vector load
    memory_alignment: int = 256      # bytes, cudaMalloc alignment


class Features:
    """Per-device capability registry (reference Features, features.rs:10)."""

    def __init__(self) -> None:
        self.plane: Set[str] = set()
        self.tma: bool = False
        self.cluster: bool = False
        self.atomics: Set[str] = set()
        # type -> set of usages {"buffer", "compute", "mma", "conversion"}
        self.type_usage: Dict[ElemType, Set[str]] = {}

    def register_type(self, ty: ElemType, *usages: str) -> None:
        self.type_usage.setdefault(ty, set()).update(usages)

    def supports_type(self, ty: ElemType, usage: str = "compute") -> bool:
        return usage in self.type_usage.get(ty, set())


@dataclass
class DeviceIdentity:
    name: str
    fingerprint: str


class DeviceProperties:
    """reference DeviceProperties, properties.rs:98."""

    def __init__(self, identity: DeviceIdentity, hardware: HardwareProperties,
                 features: Features):
        self.identity = identity
        self.hardware = hardware
        self.features = features

    def feature_enabled(self, name: str) -> bool:
        return bool(getattr(self.features, name, False))


def _features() -> Features:
    feats = Features()
    # the plane ops the printer lowers to warp shuffles / reductions
    feats.plane = {"sum", "prod", "max", "min", "all", "any", "broadcast",
                   "shuffle", "shuffle_xor", "shuffle_up", "shuffle_down"}
    for ty in (t.f64, t.f32, t.flex32, t.bf16, t.f16, t.i8, t.i16, t.i32,
               t.i64, t.u8, t.u16, t.u32, t.u64, t.bool_):
        feats.register_type(ty, "buffer", "compute", "conversion")
    for ty in (t.fp8_e4m3, t.fp8_e5m2):
        feats.register_type(ty, "buffer", "conversion", "mma")
    for ty in (t.bf16, t.f16, t.tf32):
        feats.register_type(ty, "mma")
    return feats


def cuda_device_properties(index: int = 0) -> DeviceProperties:
    """Properties of CUDA device ``index`` (the analogue of the per-arch
    registration in cubecl-cuda/src/runtime.rs:108-320)."""
    import torch

    p = torch.cuda.get_device_properties(index)
    hw = HardwareProperties(num_streaming_multiprocessors=p.multi_processor_count)
    fp = hashlib.sha256(
        f"cuda:{p.name}:{p.major}.{p.minor}".encode()).hexdigest()[:16]
    return DeviceProperties(DeviceIdentity(p.name, fp), hw, _features())


def cpu_device_properties(name: str = "cpu-torch-eval") -> DeviceProperties:
    """Properties of the CPU twin (the torch evaluator): the H100's table,
    without an SM count."""
    return DeviceProperties(DeviceIdentity(name, "cpu0000torcheval"),
                            HardwareProperties(), _features())
