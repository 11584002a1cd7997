"""Compiler interface + kernel definition (counterpart of
``cubecl_tpu.backend.compiler``).

Reference: ``Compiler`` trait (cubecl-runtime/src/compiler.rs:238) turning a
``KernelDefinition`` (cubecl-runtime/src/kernel.rs:43) into an executable;
``CompiledKernel`` with debug source (kernel.rs:130).

Two compilers implement it: ``cuda.printer.CudaCompiler`` (CUDA C++ built
by nvcc, the counterpart of the JAX package's ``PallasCompiler``) and
``torch_eval.TorchEvalCompiler`` (the plain version, an interpreter of the
optimized scope in torch ops). Both run :func:`prepare_scope` first, so
they see the same scope.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..ir.features import WARP
from ..ir.scope import Scope


@dataclass
class KernelOptions:
    """reference KernelSettings (cubecl-core/src/codegen/integrator.rs:30)."""

    checked: bool = True             # ExecutionMode::Checked bounds checking
    fast_math: Dict[str, Any] = field(default_factory=dict)
    debug_symbols: bool = False
    name: str = "kernel"


@dataclass
class KernelDefinition:
    """The traced kernel (reference KernelDefinition, kernel.rs:43).

    Buffer/scalar parameter order is the ABI order the launcher uses
    (reference KernelIntegrator::integrate, integrator.rs:107-121): here
    simply declaration order."""

    scope: Scope
    cube_dim: Tuple[int, int, int]
    cube_count: Tuple[int, int, int]  # capacity when dynamic_grid_vid set
    options: KernelOptions
    plane_dim: int = WARP
    # vid of the i32 scalar carrying a RUNTIME grid-x width; no backend of
    # the port lowers it yet
    dynamic_grid_vid: Optional[int] = None

    @property
    def state(self):
        return self.scope.state


@dataclass
class CompiledKernel:
    """An executable kernel (reference CompiledKernel, kernel.rs:130).

    ``fn(tensors, scalars)`` runs the kernel on torch tensors in parameter
    order and writes the mutable ones (``mutable_indices``) in place.
    ``source`` is the CUDA C++ the printer wrote, or the scope listing the
    evaluator runs, or a description of a hand-written kernel.

    What the launch asks of the card, for ``runtime/validation.py``:
    ``block`` and ``grid`` (threads and blocks per dimension) and
    ``smem_bytes`` of dynamic shared memory; ``smem_opt_in`` says that the
    launcher sets ``cudaFuncAttributeMaxDynamicSharedMemorySize``, which a
    kernel needs above 48 KiB."""

    fn: Callable
    mutable_indices: List[int]
    source: str
    name: str
    block: Tuple[int, int, int] = (1, 1, 1)
    grid: Tuple[int, int, int] = (1, 1, 1)
    smem_bytes: int = 0
    smem_opt_in: bool = False

    def __call__(self, buffers, scalars=()):
        return self.fn(buffers, scalars)


#: the op families that neither K0 backend (the CUDA printer, the torch
#: evaluator) lowers yet: the leftovers of ROADMAP Queue 1 item 3
UNLOWERED = ("atomics", "mem.slice", "shared memory and per-unit arrays",
             "barriers and memcpy_async", "plane scans and ballots",
             "the saturating, mulhi and bit-counting ops", "debug.print",
             "a runtime grid (CubeCount.runtime)")


def unsupported(what: str, backend: str) -> NotImplementedError:
    """The error a backend raises for an IR op (or builtin, or memory
    kind) it does not lower, naming it, the families still to lower and
    the ROADMAP item that brings them; no backend emits a stub."""
    return NotImplementedError(
        f"{what} is not lowered by {backend} yet (ROADMAP Queue 1 item 3; "
        f"still to lower: {'; '.join(UNLOWERED)})")


SMEM_ALIGN = 16  # bytes: a fragment region starts on a 16-byte boundary


def fragment_layout(state) -> Tuple[Dict[int, int], int]:
    """Where the cmma fragments of a kernel (``state.matrices``, each a
    whole cube-scope tile) live in its dynamic shared memory: the byte
    offset of each by vid, and the total bytes."""
    offsets: Dict[int, int] = {}
    total = 0
    for m in state.matrices:
        offsets[m.vid] = total
        rows, cols = m.shape
        nbytes = rows * cols * m.ty.elem.size
        total += -(-nbytes // SMEM_ALIGN) * SMEM_ALIGN
    return offsets, total


def prepare_scope(defn: KernelDefinition) -> None:
    """The pass order of the JAX package's ``PallasCompiler.compile``
    (backend/pallas/emitter.py:59-72): the fast-math processor, then
    optimize, then checked IO when the launch is checked, then optimize
    again. Mutates ``defn.scope``."""
    from ..opt.checked_io import insert_checked_io
    from ..opt.passes import optimize_scope
    from ..opt.processors import FastMathProcessor, run_processors

    scope = defn.scope
    cd, cc = defn.cube_dim, defn.cube_count
    dyn_grid = defn.dynamic_grid_vid is not None
    run_processors(scope, [FastMathProcessor()])
    optimize_scope(scope, cd, cc, defn.plane_dim, dynamic_grid=dyn_grid)
    if defn.options.checked:
        insert_checked_io(scope, cd, cc)
        optimize_scope(scope, cd, cc, defn.plane_dim, dynamic_grid=dyn_grid)


class Compiler:
    """Backend compiler interface (reference Compiler trait,
    compiler.rs:238)."""

    name = "abstract"

    def compile(self, defn: KernelDefinition,
                kernel_id: str = "") -> CompiledKernel:
        """``kernel_id`` is the digest of the launch's ``KernelId``."""
        raise NotImplementedError
