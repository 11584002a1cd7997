"""Launch-time validation against device properties (counterpart of
``cubecl_tpu.runtime.validation``).

Reference: cubecl-runtime/src/validation.rs:10-40 — checks cube dim/unit
counts and shared-memory size against ``DeviceProperties`` before
dispatch. The JAX package checks a kernel's scoped-VMEM estimate; here the
budget is the H100's: at most 1024 threads a block (1024 x 1024 x 64 per
dimension), the grid limits, and 227 KiB of dynamic shared memory a block,
of which a kernel may use more than 48 KiB only after it opts in
(``cudaFuncAttributeMaxDynamicSharedMemorySize``).

The server runs both checks: :func:`validate_launch` on a ``@cube``
kernel's definition before it is printed (so no nvcc runs for a doomed
kernel) and :func:`validate_compiled` on every compiled kernel, the
hand-written ones included, before its first launch. An over-budget kernel
raises :class:`LaunchValidationError` naming the kernel and the resource;
the autotuner prunes such a candidate with that reason.
"""

from __future__ import annotations

import math

from ..backend.compiler import fragment_layout
from ..ir.features import DeviceProperties

#: dynamic shared memory a kernel may use without opting in
SMEM_NO_OPT_IN = 48 * 1024


class LaunchValidationError(ValueError):
    pass


def _check_dims(name: str, block, grid, smem: int, opt_in: bool,
                props: DeviceProperties) -> None:
    hw = props.hardware
    units = math.prod(block)
    if units > hw.max_units_per_cube or any(
            d > m for d, m in zip(block, hw.max_cube_dim)):
        raise LaunchValidationError(
            f"kernel {name}: cube dim {tuple(block)} ({units} threads) "
            f"exceeds {hw.max_cube_dim} / {hw.max_units_per_cube} threads")
    if any(c > m for c, m in zip(grid, hw.max_cube_count)):
        raise LaunchValidationError(
            f"kernel {name}: cube count {tuple(grid)} exceeds "
            f"{hw.max_cube_count}")
    if smem > hw.max_shared_memory_size:
        raise LaunchValidationError(
            f"kernel {name}: {smem} bytes of shared memory exceed the "
            f"{hw.max_shared_memory_size} bytes a block may use")
    if smem > SMEM_NO_OPT_IN and not opt_in:
        raise LaunchValidationError(
            f"kernel {name}: {smem} bytes of shared memory need the "
            f"opt-in above {SMEM_NO_OPT_IN} bytes, which its launcher does "
            "not set")


def validate_launch(defn, props: DeviceProperties) -> None:
    """A traced ``@cube`` kernel: its cube dim, cube count and the shared
    memory of its cmma fragments (the printer opts in above 48 KiB)."""
    _, smem = fragment_layout(defn.state)
    _check_dims(defn.options.name, defn.cube_dim, defn.cube_count, smem,
                True, props)


def validate_compiled(compiled, props: DeviceProperties) -> None:
    """A compiled kernel's launch (``block``, ``grid``, ``smem_bytes``,
    ``smem_opt_in``)."""
    _check_dims(compiled.name, compiled.block, compiled.grid,
                compiled.smem_bytes, compiled.smem_opt_in, props)
