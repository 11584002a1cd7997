"""ComputeClient — the user-facing device handle (counterpart of
``cubecl_tpu.runtime.client``).

Reference: ``ComputeClient`` (cubecl-runtime/src/client.rs:41): create,
read, write, empty, launch, sync, properties, graph capture
(client.rs:998-1020) and profile (client.rs:1167) over one server.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, List, Optional, Sequence

import numpy as np

from ..ir.features import DeviceProperties
from .graph import CaptureState, Graph
from .handle import Handle
from .kernel import KernelTask
from .profile import ProfileDuration, time_graph
from .server import TorchServer


class ComputeClient:
    def __init__(self, server: TorchServer):
        self.server = server
        self._capture: Optional[CaptureState] = None

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
        """Run a kernel, or record it while a capture is active."""
        if self._capture is not None:
            self._capture.record(task, buffers, scalars)
            return
        self.server.launch(task, buffers, scalars)

    def sync(self) -> None:
        self.server.sync()

    def properties(self) -> DeviceProperties:
        return self.server.properties()

    # ------------------------------------------------------- graph capture

    def start_capture(self) -> None:
        """Record launches instead of running them (reference
        start_capture, client.rs:1011)."""
        if self._capture is not None:
            raise RuntimeError("capture already active")
        self._capture = CaptureState()

    def stop_capture(self) -> Graph:
        """Finish recording: the compiled, validated and (on a card)
        CUDA-graph-captured sequence (reference stop_capture,
        client.rs:1020)."""
        cap = self._capture
        if cap is None:
            raise RuntimeError("no active capture")
        self._capture = None
        return Graph(self, cap.recorded, cap.handles)

    @contextlib.contextmanager
    def capture_paused(self):
        """Launch for real while a capture records: an autotuned call made
        inside another candidate's capture (``conv2d_im2col``'s matmul in
        ``conv2d_autotuned``) tunes in this block, and then records its
        winner into the outer capture."""
        cap, self._capture = self._capture, None
        try:
            yield
        finally:
            self._capture = cap

    def capture(self, fn, *args, **kwargs) -> Graph:
        """``fn(*args, **kwargs)`` between ``start_capture`` and
        ``stop_capture``; if ``fn`` raises, the capture is dropped and the
        error propagates."""
        self.start_capture()
        try:
            fn(*args, **kwargs)
        except BaseException:
            self._capture = None
            raise
        return self.stop_capture()

    # ---------------------------------------------------------- profiling

    def profile(self, fn, *args, **kwargs) -> ProfileDuration:
        """Time a closure of device work (reference client.profile,
        client.rs:1167). Its launches are captured as a Graph, replayed
        once for their real effects and then timed by
        :func:`~.profile.time_graph` (CUDA events on a card: method
        "device"). A closure that launches nothing through the client
        (plain torch work) runs once between host timestamps around a
        sync (method "system")."""
        self.sync()
        graph = self.capture(fn, *args, **kwargs)
        if graph.num_kernels == 0:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            self.sync()
            return ProfileDuration(time.perf_counter() - t0, "system")
        graph.replay()
        self.sync()
        method = "device" if self.device.type == "cuda" else "system"
        return ProfileDuration(time_graph(self, graph), method)
