"""Kernel identity + task abstraction (counterpart of
``cubecl_tpu.runtime.kernel``).

Reference: ``KernelId`` (cubecl-runtime/src/id.rs:89),
``KernelDefinition::stable_hash`` (kernel.rs:68), ``CubeTask`` with its
define/compile split so servers can hash the definition before compiling
(compiler.rs:66-80). The cache key includes the function identity, cube
dim/count, every comptime arg and all buffer shapes/line sizes — the same
rule as the macro-generated ``KernelMetadata::id``
(cubecl-macros/src/generate/kernel.rs:349-432) plus static shapes, which
the traced kernel bakes in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..backend.compiler import KernelDefinition
from ..utils.hashing import stable_hash_str


@dataclass(frozen=True)
class KernelId:
    text: str
    digest: str

    @staticmethod
    def build(*parts: Any) -> "KernelId":
        text = "|".join(str(p) for p in parts)
        return KernelId(text, stable_hash_str(text))

    def __str__(self) -> str:
        return self.digest


class KernelTask:
    """A launchable kernel: lazily traces its definition (``define`` — this
    is where tracing happens, reference kernel.rs:213 step (a)) and hands it
    to the compiler."""

    def __init__(self, kernel_id: KernelId, define: Callable[[], KernelDefinition],
                 name: str = "kernel"):
        self.kernel_id = kernel_id
        self._define = define
        self.name = name

    def define(self) -> KernelDefinition:
        return self._define()
