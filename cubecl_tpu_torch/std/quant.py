"""Quantization schemes (counterpart of ``cubecl_tpu.std.quant``).

Reference: ``QuantScheme``/``QuantLevel``/``QuantValue``/``QuantParam``
(cubecl-common/src/quant/scheme.rs:8-448). ``quantize_np`` and
``dequantize_np`` are the host oracles of the kernels in
``std/quant_kernels.py`` (numpy rounds half to even, as the kernels'
``rintf`` does).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..ir import types as t
from ..ir.types import ElemType


class QuantLevel(enum.Enum):
    TENSOR = "tensor"
    BLOCK = "block"


class QuantMode(enum.Enum):
    SYMMETRIC = "symmetric"


class QuantParam(enum.Enum):
    F32 = "f32"
    F16 = "f16"
    BF16 = "bf16"
    UE8M0 = "ue8m0"


@dataclass(frozen=True)
class QuantScheme:
    """reference QuantScheme (quant/scheme.rs:8)."""

    value: ElemType = t.i8
    param: QuantParam = QuantParam.F32
    level: QuantLevel = QuantLevel.TENSOR
    mode: QuantMode = QuantMode.SYMMETRIC
    block_size: Optional[int] = None

    def range_max(self) -> float:
        e = self.value
        if e.kind == t.ElemKind.INT:
            return float(2 ** (e.bits - 1) - 1)
        if e.name == "fp8_e4m3":
            return 448.0
        if e.name == "fp8_e5m2":
            return 57344.0
        raise ValueError(f"unsupported quant value type {e}")


def quantize_np(x: np.ndarray, scheme: QuantScheme
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side reference quantization (numerics oracle for kernel tests)."""
    rmax = scheme.range_max()
    if scheme.level == QuantLevel.TENSOR:
        scale = np.abs(x).max() / rmax
        scale = np.maximum(scale, 1e-12)
        q = np.clip(np.round(x / scale), -rmax - 1, rmax)
        return q.astype(_np_dtype(scheme.value)), np.asarray(scale, np.float32)
    assert scheme.block_size, "block quant needs block_size"
    b = scheme.block_size
    xb = x.reshape(-1, b)
    scale = np.abs(xb).max(axis=1, keepdims=True) / rmax
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round(xb / scale), -rmax - 1, rmax)
    return (q.astype(_np_dtype(scheme.value)).reshape(x.shape),
            scale.astype(np.float32).reshape(-1))


def dequantize_np(q: np.ndarray, scale: np.ndarray,
                  scheme: QuantScheme) -> np.ndarray:
    if scheme.level == QuantLevel.TENSOR:
        return q.astype(np.float32) * scale
    b = scheme.block_size
    return (q.reshape(-1, b).astype(np.float32)
            * scale.reshape(-1, 1)).reshape(q.shape)


def _np_dtype(e: ElemType):
    if e.torch_name is None:
        raise TypeError(f"{e} has no storage dtype")
    try:
        return np.dtype(e.torch_name)
    except TypeError:
        import ml_dtypes  # float8 dtypes

        return np.dtype(getattr(ml_dtypes, e.torch_name))
