"""Reductions (BASELINE config 2): counterpart of ``cubecl_tpu.ops.reduce``,
with its public names and signatures.

Three routes to ``sum(x)``, as in the JAX package:

1. ``reduce_sum`` / ``reduce_max`` / ``reduce_mean``: the two-phase tree of
   ``@cube`` kernels on K0 (``reduce_{sum,max}_partial``, then one cube of
   ``reduce_final_{sum,max}``), whose plane reductions span the whole
   8-unit cube;
2. ``reduce_sum_blockwise``: one cube-cooperative ``block_sum``
   (``mem.block_reduce``) per cube, then ``reduce_final_sum``;
3. ``reduce_sum_native``: the hand-written kernel R1 (``csrc/reduce.cu``),
   which replaces the TPU kernel ``_build_reduce_native`` (``pallas_call``
   :246): on CUDA tensors a grid-stride sum with 16-byte loads into one
   f32 partial per block and a deterministic second fold, on CPU tensors
   :func:`reduce_sum_native_plain`. ``reduce_sum_native.launches`` counts
   its calls that run outside a CUDA graph's recording.

``reduce_sum_autotuned`` times the three through the repaired
``LocalTuner``. The ``@cube`` bodies are the JAX package's, unchanged, and
so are the launch plans the TPU chose (CD = 8 units a cube, lines of 128,
128-aligned cube counts), so that the two packages compare call for call;
8-thread cubes leave the H100 mostly idle, and R1 is the fast route.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..backend.compiler import CompiledKernel
from ..frontend import (
    CUBE_POS_X,
    UNIT_POS,
    ArrayArg,
    MutSlice,
    Slice,
    Vector,
    cube,
    cube_range,
    line_max,
    line_sum,
    max_,
    plane_max,
    plane_sum,
)
from ..ir.types import f32
from ..runtime.base import CubeCount, CubeDim
from ..runtime.handle import Handle
from ..runtime.kernel import KernelId, NativeKernelTask
from ..tune import LocalTuner, TunableSet
from ..tune.anchor import anchor
from ..utils import native

CD = 8  # cube dim == plane dim: plane ops reduce the whole cube


@cube
def reduce_sum_partial(inp: Slice, partials: MutSlice, iters: int):
    """Each cube reduces iters×CUBE_DIM lines into one scalar partial."""
    acc = Vector.zeros(f32, inp.line_size)
    base = CUBE_POS_X * (iters * 8)
    for k in cube_range(0, iters):
        acc = acc + inp[base + k * 8 + UNIT_POS]
    s = plane_sum(line_sum(acc))
    if UNIT_POS == 0:
        partials[CUBE_POS_X] = s


@cube
def reduce_max_partial(inp: Slice, partials: MutSlice, iters: int):
    base = CUBE_POS_X * (iters * 8)
    acc = inp[base + UNIT_POS]
    for k in cube_range(1, iters):
        acc = max_(acc, inp[base + k * 8 + UNIT_POS])
    s = plane_max(line_max(acc))
    if UNIT_POS == 0:
        partials[CUBE_POS_X] = s


@cube
def reduce_final_sum(partials: Slice, out: MutSlice, iters: int):
    """Single-cube final fold over the partials (any line size)."""
    acc = 0.0
    for k in cube_range(0, iters):
        idx = k * 8 + UNIT_POS
        if idx < partials.len():
            acc = acc + partials[idx]
    s = plane_sum(line_sum(acc))
    if UNIT_POS == 0:
        out[0] = s


@cube
def reduce_final_max(partials: Slice, out: MutSlice, iters: int):
    acc = partials[0]
    for k in cube_range(0, iters):
        idx = k * 8 + UNIT_POS
        if idx < partials.len():
            acc = max_(acc, partials[idx])
    s = plane_max(line_max(acc))
    if UNIT_POS == 0:
        out[0] = s


@cube
def reduce_block_partial(inp: Slice, partials: MutSlice, lines: int):
    """One cube-cooperative block_sum per cube (the TPU-idiomatic DSL
    reduce: one whole-window vector op instead of a per-unit load loop —
    ~3x the bandwidth of the unit-loop kernel at equal block size)."""
    partials[CUBE_POS_X] = inp.block_sum(CUBE_POS_X * lines, lines)


def reduce_sum_blockwise(client, inp: Handle, cubes: int = 32,
                         line_size: int = 128) -> Handle:
    """sum(inp) via cube-cooperative block reductions: ``cubes`` cubes of
    CD units, each folding one contiguous window with ``block_sum``, then
    one cube of ``reduce_final_sum`` over the f32 partials. The TPU chose
    few, large windows (its per-grid-step cost); on the H100 a window is
    walked by the cube's 8 threads, so few cubes leave most SMs idle."""
    n = int(np.prod(inp.shape))
    line = line_size if n % line_size == 0 else 1
    n_lines = n // line
    while cubes > 1 and n_lines % cubes:
        cubes //= 2
    lines = n_lines // cubes
    partials = client.empty((cubes,), "float32")
    reduce_block_partial.launch_unchecked(
        client, CubeCount(cubes), CubeDim.new_1d(CD),
        ArrayArg(inp, line_size=line), ArrayArg(partials, mutable=True),
        lines)
    out = client.empty((1,), "float32")
    f_iters = -(-cubes // CD)
    reduce_final_sum.launch(
        client, CubeCount(1), CubeDim.new_1d(CD),
        ArrayArg(partials, line_size=1), ArrayArg(out, mutable=True),
        f_iters)
    return out


@cube
def reduce_sum_naive(inp: Slice, out: MutSlice):
    """The book's naive single-unit reduction (benchmark.md baseline) —
    kept for the 220× progression story."""
    acc = Vector.zeros(f32, inp.line_size)
    for k in cube_range(0, inp.len()):
        acc = acc + inp[k]
    if UNIT_POS == 0:
        out[0] = line_sum(acc)


def _plan(n_lines: int, line: int, target_cubes: int = 512):
    """Pick (cubes, iters) with cubes*iters*CD == n_lines, preferring a
    128-aligned cube count so the final fold can use full lines."""
    per_cube = max(CD, n_lines // target_cubes)
    iters = max(1, per_cube // CD)
    while iters > 1 and (n_lines % (iters * CD) != 0
                         or (n_lines // (iters * CD)) % 128 != 0):
        iters -= 1
    if n_lines % (iters * CD) != 0:
        iters = 1
    cubes = n_lines // (iters * CD)
    return cubes, iters


def reduce_sum(client, inp: Handle, line_size: int = 128,
               target_cubes: int = 512) -> Handle:
    """sum(inp) -> scalar handle, two-phase tree."""
    n = int(np.prod(inp.shape))
    line = line_size if n % line_size == 0 else 1
    n_lines = n // line
    assert n_lines % CD == 0, "length must be a multiple of 8 lines"
    cubes, iters = _plan(n_lines, line, target_cubes)
    # accumulate wide: f32 partials regardless of input dtype
    partials = client.empty((cubes,), "float32")
    reduce_sum_partial.launch_unchecked(
        client, CubeCount(cubes), CubeDim.new_1d(CD),
        ArrayArg(inp, line_size=line), ArrayArg(partials, mutable=True),
        iters)
    out = client.empty((1,), "float32")
    f_line = 128 if cubes % 128 == 0 else 1
    f_lines = cubes // f_line
    f_iters = -(-f_lines // CD)
    reduce_final_sum.launch(
        client, CubeCount(1), CubeDim.new_1d(CD),
        ArrayArg(partials, line_size=f_line), ArrayArg(out, mutable=True),
        f_iters)
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def reduce_max(client, inp: Handle, line_size: int = 128,
               target_cubes: int = 512) -> Handle:
    n = int(np.prod(inp.shape))
    line = line_size if n % line_size == 0 else 1
    n_lines = n // line
    assert n_lines % CD == 0
    cubes, iters = _plan(n_lines, line, target_cubes)
    partials = client.empty((cubes,), _dtype_name(inp.dtype))
    reduce_max_partial.launch_unchecked(
        client, CubeCount(cubes), CubeDim.new_1d(CD),
        ArrayArg(inp, line_size=line), ArrayArg(partials, mutable=True),
        iters)
    out = client.empty((1,), _dtype_name(inp.dtype))
    f_line = 128 if cubes % 128 == 0 else 1
    f_lines = cubes // f_line
    f_iters = -(-f_lines // CD)
    reduce_final_max.launch(
        client, CubeCount(1), CubeDim.new_1d(CD),
        ArrayArg(partials, line_size=f_line), ArrayArg(out, mutable=True),
        f_iters)
    return out


def reduce_mean(client, inp: Handle, **kw) -> Handle:
    """mean(inp): :func:`reduce_sum`, its f32 result divided by the element
    count in place (a torch op on the handle's device)."""
    s = reduce_sum(client, inp, **kw)
    s.tensor.div_(int(np.prod(inp.shape)))
    return s


# ---------------------------------------------------------------------------
# R1: the hand-written single-kernel reduction (csrc/reduce.cu)
# ---------------------------------------------------------------------------

NT = 256            # threads of R1's partial blocks
MAX_BLOCKS = 1024   # partial blocks at most: the final fold's one pass
NATIVE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def reduce_sum_native_plain(x: torch.Tensor) -> torch.Tensor:
    """R1's function in plain PyTorch: ``x`` viewed as (rows, 128), in f32,
    summed over the rows, then over the 128 lanes; a (1,) f32 tensor."""
    return x.reshape(-1, 128).float().sum(0).sum().reshape(1)


def _native_blocks(n: int, block_rows: int) -> int:
    """R1's partial blocks: one per chunk of ``block_rows`` x 128 elements,
    at most MAX_BLOCKS (each then takes several chunks)."""
    return min(-(-n // (block_rows * 128)), MAX_BLOCKS)


def _build_reduce_native(n: int, block_rows: int,
                         dtype: torch.dtype) -> CompiledKernel:
    """R1 over buffers ``(x, partials, out)``: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    chunk = block_rows * 128
    blocks = _native_blocks(n, block_rows)

    def fn(buffers, scalars=()):
        x, partials, out = buffers
        if out.device.type == "cpu":
            out.copy_(reduce_sum_native_plain(x))
            return
        native.check_aligned(x)
        lib = native.kernels()
        with torch.cuda.device(out.device):
            rc = lib.cubecl_reduce_sum(
                x.data_ptr(), partials.data_ptr(), out.data_ptr(), n, chunk,
                blocks, native.DTYPE_CODES[x.dtype],
                torch.cuda.current_stream().cuda_stream)
        native.check(lib, rc, "reduce_native")
        if not torch.cuda.is_current_stream_capturing():
            reduce_sum_native.launches += 1  # a graph's recording runs nothing

    return CompiledKernel(
        fn=fn, mutable_indices=[1, 2],
        source=f"csrc/reduce.cu n={n} chunk={chunk} blocks={blocks} "
               f"{_dtype_name(dtype)}",
        name="reduce_native", block=(NT, 1, 1), grid=(blocks, 1, 1))


def reduce_sum_native(client, inp: Handle, block_rows: int = 4096) -> Handle:
    """Speed-of-light path: the whole reduction in one kernel, R1, into a
    (1,) f32 handle. ``block_rows`` x 128 elements make one block's chunk
    (the TPU kernel's block of (block_rows, 128)); the f32 partials and
    the output are allocated here, before any launch, so that a captured
    call allocates nothing."""
    n = math.prod(inp.shape)
    if n % 128:  # the kernel's 16-byte vectors must not straddle the end
        raise ValueError(f"native reduce needs length % 128 == 0, got {n}")
    if inp.dtype not in NATIVE_DTYPES:
        raise ValueError(f"reduce_sum_native sums {NATIVE_DTYPES}, not "
                         f"{inp.dtype}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    partials = client.empty((_native_blocks(n, block_rows),), "float32")
    out = client.empty((1,), "float32")
    kid = KernelId.build("reduce_native", n, block_rows, inp.dtype)
    task = NativeKernelTask(
        kid, lambda: _build_reduce_native(n, block_rows, inp.dtype),
        name="reduce_native")
    client.launch(task, [inp, partials, out])
    return out


reduce_sum_native.launches = 0


# ---------------------------------------------------------------------------
# Autotuned line size / chunking (reference LocalTuner usage pattern)
# ---------------------------------------------------------------------------

_sum_tuner = LocalTuner("reduce_sum")
# the candidates of one (n, dtype, R1 offered): they bake n, so a set is
# reused only at the same n, and a call after tuning builds nothing
_sum_sets: dict = {}


def _sum_key(client, inp: Handle):
    return ("sum", anchor(math.prod(inp.shape)), _dtype_name(inp.dtype))


def reduce_sum_autotuned(client, inp: Handle) -> Handle:
    n = math.prod(inp.shape)
    # R1 is offered where its preconditions hold; there its candidates are
    # not prunable, so a build or launch error raises instead of handing
    # the call to a K0 route
    native_ok = (n % 128 == 0 and inp.dtype in NATIVE_DTYPES
                 and inp.tensor.data_ptr() % 16 == 0)
    ts = _sum_sets.get((n, inp.dtype, native_ok))
    if ts is None:
        ts = _sum_sets[(n, inp.dtype, native_ok)] = _sum_candidates(
            n, inp.dtype, native_ok)
    if not ts.tunables:
        return reduce_sum(client, inp, line_size=1)
    return _sum_tuner.execute(client, ts, client, inp)


def _sum_candidates(n: int, dtype: torch.dtype, native_ok: bool) -> TunableSet:
    ts = TunableSet("reduce_sum", _sum_key)
    # roofline work: n additions, each element read once (in its own
    # width: the JAX package counts 4 bytes, which halves bf16's bound)
    nbytes = n * dtype.itemsize
    if native_ok:
        for br in (512, 1024, 2048, 4096):
            ts.with_tunable(
                lambda c, h, _b=br: reduce_sum_native(c, h, block_rows=_b),
                name=f"native_br{br}",
                work=lambda key: (n, nbytes), prunable=False)
    for bc in (16, 32, 64):
        if n % 128 == 0 and (n // 128) % bc == 0:
            ts.with_tunable(
                lambda c, h, _b=bc: reduce_sum_blockwise(c, h, cubes=_b),
                name=f"blockwise_c{bc}",
                work=lambda key: (n, nbytes))
    for line in (128,):  # lane dim > one 128-lane tile streams 3.3x slower
        for tc in (256, 512, 1024):
            if n % line == 0 and (n // line) % CD == 0:
                ts.with_tunable(
                    lambda c, h, _l=line, _t=tc: reduce_sum(
                        c, h, line_size=_l, target_cubes=_t),
                    name=f"line{line}_cubes{tc}",
                    work=lambda key: (n, nbytes))
    return ts
