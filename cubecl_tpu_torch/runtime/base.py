"""Runtime base types: CubeDim, CubeCount, Runtime trait (counterpart of
``cubecl_tpu.runtime.base``).

Reference: ``CubeDim``/``CubeCount`` (cubecl-runtime/src/server/base.rs:
1063,1166), ``Runtime`` trait (runtime.rs:14-52). ``RuntimeCubeCount``
traces as in the JAX package; neither backend of the port runs a runtime
grid yet (the CUDA printer refuses it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CubeDim:
    x: int = 1
    y: int = 1
    z: int = 1

    @staticmethod
    def new_1d(x: int) -> "CubeDim":
        return CubeDim(x, 1, 1)

    @staticmethod
    def new_2d(x: int, y: int) -> "CubeDim":
        return CubeDim(x, y, 1)

    @staticmethod
    def new_3d(x: int, y: int, z: int) -> "CubeDim":
        return CubeDim(x, y, z)

    @property
    def num_units(self) -> int:
        return self.x * self.y * self.z

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.x, self.y, self.z)


@dataclass(frozen=True)
class CubeCount:
    """Static grid size."""

    x: int = 1
    y: int = 1
    z: int = 1

    @staticmethod
    def runtime(x: int, max_x: int) -> "RuntimeCubeCount":
        """Runtime grid width: the kernel compiles once against the
        ``max_x`` capacity and launches with the runtime ``x`` riding as
        a scalar (reference cubecl-core/src/codegen/metadata.rs:1-40)."""
        return RuntimeCubeCount(x, max_x)

    @staticmethod
    def static(x: int, y: int = 1, z: int = 1) -> "CubeCount":
        return CubeCount(x, y, z)

    @property
    def num_cubes(self) -> int:
        return self.x * self.y * self.z

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.x, self.y, self.z)


class Runtime:
    """Associates a compiler + server + device (reference Runtime trait,
    runtime.rs:14)."""

    name = "abstract"

    @classmethod
    def client(cls, device=None):
        raise NotImplementedError

    @classmethod
    def max_cube_count(cls) -> Tuple[int, int, int]:
        return (2**31 - 1, 65535, 65535)


@dataclass(frozen=True)
class RuntimeCubeCount:
    """Grid whose X width is a RUNTIME value bounded by a compile-time
    capacity ``max_x``; y and z are 1."""

    x: int
    max_x: int

    def __post_init__(self):
        assert 1 <= self.x <= self.max_x, \
            f"runtime grid x={self.x} outside [1, {self.max_x}]"

    @property
    def num_cubes(self) -> int:
        return self.x

    def as_tuple(self) -> Tuple[int, int, int]:
        """Capacity tuple — what analyses/plans compile against."""
        return (self.max_x, 1, 1)

    def cache_key(self) -> Tuple:
        """Kernel-id / launch-memo key: capacity only, never ``x``."""
        return ("rt", self.max_x, 1, 1)
