"""ComputeClient — the user-facing device handle (counterpart of
``cubecl_tpu.runtime.client``).

Reference: ``ComputeClient`` (cubecl-runtime/src/client.rs:41): create,
read, write, empty, launch, sync and properties over one server.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from ..ir.features import DeviceProperties
from .handle import Handle
from .kernel import KernelTask
from .server import TorchServer


class ComputeClient:
    def __init__(self, server: TorchServer):
        self.server = server

    @property
    def device(self):
        return self.server.device

    def create(self, data) -> Handle:
        """Upload host data (a numpy array or a tensor, copied)."""
        return self.server.create(data)

    def empty(self, shape, dtype="float32") -> Handle:
        if isinstance(shape, int):
            shape = (shape,)
        return self.server.empty(shape, dtype)

    def read(self, handles: Sequence[Handle]) -> List[np.ndarray]:
        return self.server.read(handles)

    def read_one(self, handle: Handle) -> np.ndarray:
        return self.read([handle])[0]

    def write(self, handle: Handle, data) -> None:
        self.server.write(handle, data)

    def launch(self, task: KernelTask, buffers: Sequence[Handle],
               scalars: Sequence[Any] = ()) -> None:
        self.server.launch(task, buffers, scalars)

    def sync(self) -> None:
        self.server.sync()

    def properties(self) -> DeviceProperties:
        return self.server.properties()
