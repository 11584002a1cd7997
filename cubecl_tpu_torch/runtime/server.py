"""The compute server (counterpart of ``cubecl_tpu.runtime.server``).

Reference: ``ComputeServer`` (cubecl-runtime/src/server/base.rs:359) with
the CUDA implementation (cubecl-cuda/src/compute/server.rs:169) as the
model: per-device state and compile-if-miss (context.rs:106-230).

:class:`TorchServer` owns one ``torch.device`` and one compiler: the CUDA
printer on a card, the torch evaluator on the CPU (or, as an oracle, on a
card). Kernels write their mutable tensors in place. The compile cache is
keyed by ``KernelId`` and holds ``@cube`` kernels and hand-written ones
(``NativeKernelTask``) alike; every kernel is validated against the card's
limits (``runtime/validation.py``) before its first launch, and the server
counts compiles and launches. Graph capture and profiling live on the
client (``runtime/graph.py``, ``runtime/profile.py``); streams are
PyTorch's current stream.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..backend.compiler import CompiledKernel, Compiler
from ..ir.features import DeviceProperties
from .handle import Handle
from .kernel import KernelTask, NativeKernelTask
from .validation import validate_compiled, validate_launch


class TorchServer:
    def __init__(self, device: torch.device, compiler: Compiler,
                 props: DeviceProperties, name: str):
        self.device = torch.device(device)
        self.compiler = compiler
        self.props = props
        self.name = name
        self._cache: Dict[str, CompiledKernel] = {}
        self.compile_count = 0
        self.launch_count = 0
        self.launches: collections.Counter = collections.Counter()

    # ------------------------------------------------------------- memory

    def create(self, data) -> Handle:
        """Upload a copy of ``data`` (a numpy array or a tensor)."""
        if not isinstance(data, torch.Tensor):
            data = _from_numpy(np.array(data))
        return Handle(data.detach().to(self.device, copy=True)
                      .contiguous())

    def empty(self, shape, dtype) -> Handle:
        return Handle(torch.zeros(shape, dtype=_torch_dtype(dtype),
                                  device=self.device))

    def read(self, handles: Sequence[Handle]) -> List[np.ndarray]:
        return [_to_numpy(h.tensor) for h in handles]

    def write(self, handle: Handle, data) -> None:
        src = data if isinstance(data, torch.Tensor) else \
            _from_numpy(np.asarray(data))
        handle.tensor.copy_(src.reshape(handle.tensor.shape))

    # ---------------------------------------------------------- execution

    def compile_kernel(self, task: KernelTask) -> CompiledKernel:
        """Compile-if-miss, keyed by the task's ``KernelId``: a ``@cube``
        kernel is traced, validated and handed to the compiler, a
        hand-written one built; both are validated before they are
        cached, so a kernel over the card's limits raises here."""
        key = str(task.kernel_id)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if isinstance(task, NativeKernelTask):
            compiled = task.build()
        else:
            defn = task.define()
            validate_launch(defn, self.props)
            compiled = self.compiler.compile(defn, kernel_id=key)
        validate_compiled(compiled, self.props)
        self._cache[key] = compiled
        self.compile_count += 1
        return compiled

    def launch(self, task: KernelTask, buffers: Sequence[Handle],
               scalars: Sequence[Any] = ()) -> None:
        compiled = self.compile_kernel(task)
        tensors = [h.tensor for h in buffers]
        for t in tensors:
            if t.device != self.device:
                raise ValueError(
                    f"{compiled.name}: a tensor on {t.device} given to the "
                    f"server of {self.device}")
            if not t.is_contiguous():
                raise ValueError(f"{compiled.name}: tensors must be "
                                 "contiguous")
        compiled.fn(tensors, tuple(scalars))
        self.launch_count += 1
        self.launches[compiled.name] += 1

    def wait_builds(self) -> None:
        """Wait for every build that ``compile_kernel`` started (the CUDA
        compiler runs nvcc in the background; a launch waits for its own
        kernel only), raising the first failure."""
        for compiled in self._cache.values():
            wait = getattr(compiled.fn, "build", None)
            if wait is not None:
                wait.wait()

    def build_seconds(self) -> float:
        """Summed nvcc seconds of the kernels this server built."""
        return sum(c.fn.build.seconds for c in self._cache.values()
                   if hasattr(c.fn, "build"))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_counts(self) -> None:
        self.launch_count = 0
        self.launches.clear()

    def properties(self) -> DeviceProperties:
        return self.props


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    from ..ir.types import elem_from_dtype

    return elem_from_dtype(dtype).torch_dtype()


# torch dtypes numpy lacks: (the integer view of the same width, the
# ml_dtypes name)
_ML_DTYPES = {torch.bfloat16: (torch.int16, "bfloat16"),
              torch.float8_e4m3fn: (torch.uint8, "float8_e4m3fn"),
              torch.float8_e5m2: (torch.uint8, "float8_e5m2")}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in _ML_DTYPES:
        import ml_dtypes

        view, name = _ML_DTYPES[t.dtype]
        return t.view(view).numpy().view(getattr(ml_dtypes, name))
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A tensor of ``a`` (sharing its memory); bf16 and fp8 arrays of
    ml_dtypes cross as their integer bits."""
    for dt, (view, name) in _ML_DTYPES.items():
        if a.dtype.name == name:
            ints = np.ascontiguousarray(a).view(
                np.int16 if view == torch.int16 else np.uint8)
            return torch.from_numpy(ints).view(dt)
    return torch.from_numpy(a)
