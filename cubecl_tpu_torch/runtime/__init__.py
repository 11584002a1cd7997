"""cubecl_tpu_torch.runtime — runtime core (counterpart of
``cubecl_tpu.runtime``; reference crate: cubecl-runtime)."""

from .base import CubeCount, CubeDim, Runtime, RuntimeCubeCount
from .client import ComputeClient
from .handle import Handle
from .kernel import KernelId, KernelTask
from .runtimes import (CpuRuntime, CudaRuntime, client_for, default_client,
                       eval_client)
from .server import TorchServer
