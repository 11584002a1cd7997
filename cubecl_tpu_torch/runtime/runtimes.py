"""Concrete runtimes: CUDA and the CPU twin (counterpart of
``cubecl_tpu.runtime.runtimes``).

``CudaRuntime`` prints CUDA C++ for a card and builds it with nvcc;
``CpuRuntime`` runs the same kernels through the torch evaluator on the
host, so the whole test matrix runs without a card. One client per
(runtime, device), as the JAX package's device actors give.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from ..backend.cuda.printer import CudaCompiler
from ..backend.torch_eval import TorchEvalCompiler
from ..ir.features import cpu_device_properties, cuda_device_properties
from .base import Runtime
from .client import ComputeClient
from .server import TorchServer

_CLIENTS: Dict[Tuple[str, str], ComputeClient] = {}
_LOCK = threading.Lock()


def _client(kind: str, device: torch.device, make) -> ComputeClient:
    key = (kind, str(device))
    with _LOCK:
        c = _CLIENTS.get(key)
        if c is None:
            c = _CLIENTS[key] = ComputeClient(make())
        return c


class CudaRuntime(Runtime):
    name = "cuda"

    @classmethod
    def client(cls, device: int = 0) -> ComputeClient:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; use CpuRuntime")
        dev = torch.device("cuda", device)
        return _client("cuda", dev, lambda: TorchServer(
            dev, CudaCompiler(), cuda_device_properties(device),
            f"cuda:{device}"))

    @classmethod
    def enumerate_devices(cls):
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]


class CpuRuntime(Runtime):
    name = "cpu-torch-eval"

    @classmethod
    def client(cls, device: int = 0) -> ComputeClient:
        return eval_client("cpu")

    @classmethod
    def enumerate_devices(cls):
        return [torch.device("cpu")]


def eval_client(device="cpu") -> ComputeClient:
    """A client that runs kernels through the torch evaluator on
    ``device``: the CPU twin on ``"cpu"``, the oracle of the compiled
    kernels on a card."""
    dev = _with_index(torch.device(device))
    return _client("eval", dev, lambda: TorchServer(
        dev, TorchEvalCompiler(), cpu_device_properties(f"torch-eval:{dev}"),
        f"torch-eval:{dev}"))


def default_client(device: int = 0) -> ComputeClient:
    """The CUDA client of card ``device``. Raises where no card is
    visible: the CPU twin is asked for by name (``CpuRuntime.client()`` or
    ``client_for("cpu")``), never taken in silence."""
    if not torch.cuda.is_available():
        raise RuntimeError("default_client: no CUDA device is visible; use "
                           "CpuRuntime.client() or client_for('cpu') for the "
                           "CPU twin")
    return CudaRuntime.client(device)


def _with_index(dev: torch.device) -> torch.device:
    """``cuda`` names the current card: make it ``cuda:<index>``."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def client_for(device) -> ComputeClient:
    """The client that runs kernels on tensors of ``device``: the CUDA
    backend for a card, the torch evaluator for the CPU."""
    dev = _with_index(torch.device(device))
    if dev.type == "cuda":
        return CudaRuntime.client(dev.index)
    if dev.type == "cpu":
        return CpuRuntime.client()
    raise ValueError(f"no runtime for device {dev}")
