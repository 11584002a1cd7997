"""Handles — references to device tensors (counterpart of
``cubecl_tpu.runtime.handle``).

Reference: ``Handle``/``Binding`` (cubecl-runtime/src/server/handle.rs:
10,138). In the port a handle wraps one ``torch.Tensor``; kernels write
mutable buffers in place, so a launch never rebinds a handle.
"""

from __future__ import annotations

import itertools

import torch

_IDS = itertools.count()


class Handle:
    __slots__ = ("id", "tensor", "shape", "dtype")

    def __init__(self, tensor: torch.Tensor):
        if not isinstance(tensor, torch.Tensor):
            raise TypeError(f"a Handle holds a torch.Tensor, not "
                            f"{type(tensor).__name__}")
        self.id = next(_IDS)
        self.tensor = tensor
        self.shape = tuple(tensor.shape)
        self.dtype = tensor.dtype

    @property
    def device(self) -> torch.device:
        return self.tensor.device

    @property
    def size_bytes(self) -> int:
        return self.tensor.numel() * self.tensor.element_size()

    def binding(self) -> "Handle":
        """reference Handle::binding — kept for API parity."""
        return self

    def __repr__(self) -> str:
        return f"Handle(id={self.id}, shape={self.shape}, dtype={self.dtype})"
