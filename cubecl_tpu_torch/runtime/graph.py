"""Graph capture / replay (counterpart of ``cubecl_tpu.runtime.graph``).

Reference: CUDA-graph capture (client.start_capture/stop_capture +
Graph::replay, cubecl-runtime/src/client.rs:998-1020,120; CUDA impl
cubecl-cuda/src/compute/graph.rs).

While a capture is active (``client.start_capture()``), the client records
each launch (task, buffers, scalars) instead of running it.
``client.stop_capture()`` turns the record into a :class:`Graph`: every
recorded kernel is compiled and validated against the card's limits (a
doomed kernel raises here, before anything runs), every K0 build is waited
for, and on a card the sequence is run once on a side stream (the warm
launch torch requires, which also sets each kernel's shared-memory opt-in)
and captured into one ``torch.cuda.CUDAGraph``. ``replay()`` replays it:
one launch of the whole sequence, on the buffers the capture saw. On the
CPU the graph replays the recorded launches in order.

The graph keeps the JAX Graph's accounting of the handles it reads
(``_input_ids``, in first-use order) and writes (``_output_ids``), which the
autotuner's cross-validation reads back. The graph runs the compiled
kernels directly, so the server counts none of its launches; a wrapper
that counts its own (``matmul_pallas.launches``) counts the warm launch,
which runs, and neither the recording, which runs nothing, nor a replay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch

from .handle import Handle
from .kernel import KernelTask


@dataclass
class _Recorded:
    task: KernelTask
    buffer_ids: List[int]
    scalars: Tuple[Any, ...]


class Graph:
    """A captured launch sequence, replayed as one CUDA graph on a card."""

    def __init__(self, client, recorded: List[_Recorded],
                 handles: Dict[int, Handle]):
        self._client = client
        self._recorded = recorded
        self._handles = handles
        self._cuda_graph = None
        server = client.server
        self._compiled = [server.compile_kernel(r.task) for r in recorded]
        for ck in self._compiled:  # no nvcc may be waited on in a capture
            build = getattr(ck.fn, "build", None)
            if build is not None:
                build.wait()

        read_ids: List[int] = []
        written: set = set()
        for rec, ck in zip(recorded, self._compiled):
            for i, hid in enumerate(rec.buffer_ids):
                if hid not in written and hid not in read_ids:
                    read_ids.append(hid)
                if i in ck.mutable_indices:
                    written.add(hid)
        self._input_ids = read_ids
        self._output_ids = sorted(written)
        if recorded and server.device.type == "cuda":
            self._capture(server.device)

    def _run(self) -> None:
        for rec, ck in zip(self._recorded, self._compiled):
            ck.fn([self._handles[h].tensor for h in rec.buffer_ids],
                  rec.scalars)

    def _capture(self, device) -> None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._run()
        self._cuda_graph = graph

    def replay(self) -> None:
        """Run the whole recorded sequence once (reference Graph::replay,
        client.rs:120)."""
        if self._cuda_graph is not None:
            self._cuda_graph.replay()
        else:
            self._run()

    @property
    def num_kernels(self) -> int:
        return len(self._recorded)


class CaptureState:
    """Recording sink installed on the client during capture."""

    def __init__(self) -> None:
        self.recorded: List[_Recorded] = []
        self.handles: Dict[int, Handle] = {}

    def record(self, task: KernelTask, buffers: Sequence[Handle],
               scalars: Sequence[Any]) -> None:
        for h in buffers:
            self.handles[h.id] = h
        self.recorded.append(_Recorded(
            task, [h.id for h in buffers], tuple(scalars)))
