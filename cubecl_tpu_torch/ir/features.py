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
(atomics, shared memory, barriers), so those features are not advertised
here.

``GpuGeneration`` is the peak table the autotuner's roofline bound and
``ops.matmul`` read (``properties().generation``), the counterpart of the
JAX package's ``TpuGeneration``: NVIDIA's data-sheet peaks of the card,
dense, at its full power limit, chosen by device name.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from . import types as t
from .types import ElemType

#: threads of a warp, the plane of the CUDA backend
WARP = 32


@dataclass(frozen=True)
class GpuGeneration:
    """Peak rates of one card (operations or bytes per second)."""

    name: str
    bf16_flops: float     # tensor cores, bf16 and f16
    fp8_flops: float      # tensor cores, e4m3 and e5m2
    int8_ops: float       # tensor cores
    f32_flops: float      # CUDA cores
    hbm_bw: float         # device memory, bytes/s
    tf32_flops: float     # tensor cores, TF32

    def peak(self, dtype: str) -> float:
        """The peak rate of a GEMM on ``dtype`` operands (a numpy/torch
        dtype name). An f32 GEMM runs at the faster of the CUDA cores and
        three TF32 products (3xTF32: one TF32 product does not hold f32's
        tolerance, three do; ``csrc/wgmma_gemm.cuh``)."""
        if dtype in ("float8_e4m3fn", "float8_e5m2"):
            return self.fp8_flops
        if dtype in ("int8", "uint8"):
            return self.int8_ops
        if dtype in ("bfloat16", "float16"):
            return self.bf16_flops
        return max(self.f32_flops, self.tf32_flops / 3)


GPU_GENERATIONS = {
    "h100-sxm": GpuGeneration("h100-sxm", 989e12, 1979e12, 1979e12, 67e12,
                              3.35e12, 495e12),
    "h100-pcie": GpuGeneration("h100-pcie", 756e12, 1513e12, 1513e12,
                               51e12, 2.0e12, 378e12),
}


def generation_for(device_name: str) -> GpuGeneration:
    """The peak table of a card by its name: "PCIe" in the name picks the
    H100 PCIe's, anything else the H100 SXM's (the CPU twin too)."""
    return GPU_GENERATIONS["h100-pcie" if "pcie" in device_name.lower()
                           else "h100-sxm"]


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
                 features: Features, generation: GpuGeneration):
        self.identity = identity
        self.hardware = hardware
        self.features = features
        self.generation = generation

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
    return DeviceProperties(DeviceIdentity(p.name, fp), hw, _features(),
                            generation_for(p.name))


def cpu_device_properties(name: str = "cpu-torch-eval") -> DeviceProperties:
    """Properties of the CPU twin (the torch evaluator): the H100 SXM's
    tables, without an SM count."""
    return DeviceProperties(DeviceIdentity(name, "cpu0000torcheval"),
                            HardwareProperties(), _features(),
                            GPU_GENERATIONS["h100-sxm"])
