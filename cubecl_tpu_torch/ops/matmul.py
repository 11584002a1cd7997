"""Autotuned tiled matmul (BASELINE config 4): counterpart of
``cubecl_tpu.ops.matmul``, with its public names.

Two implementations behind one autotuned entry point, as in the JAX
package:

1. ``matmul_pallas`` — the hand-written GEMM. On CUDA tensors it launches
   ``csrc/matmul.cu``, which replaces the TPU kernels M1
   ``_build_matmul`` (``pallas_call`` :112) and M2 ``_build_matmul_scaled``
   (:508): tensor-core ``mma.sync`` for bf16/f16/fp8/int8 operands, f32
   FMA on the CUDA cores for f32 (never TF32: the TPU kernel runs f32 at
   ``Precision.HIGHEST``). int8 accumulates exactly in int32. B comes as
   (K, N) or, with ``b_transposed``, as (N, K). An epilogue multiplies the
   accumulator by ``sa * sb``: device scalars for M1's scaled form (the
   ``matmul_quantized`` route), host floats for M2 (``matmul_scaled``).
   On CPU tensors the same entry points run :func:`matmul_plain`.
   Bound at 4096^3 on the H100: 2 * 4096^3 operations over the dtype's
   peak — bf16 0.139 ms, fp8 and int8 0.069 ms, f32 on the CUDA cores
   2.05 ms; the bytes are 0.03 ms. The kernel's design (two cp.async
   stages, ldmatrix, warp mma.sync) is simple first; wgmma and TMA are
   later work. ``matmul_pallas.launches`` and ``matmul_scaled.launches``
   count the kernel's launches that run outside a CUDA graph: eager calls
   and a graph's warm launch, not its recording nor its replays.
2. ``matmul_cmma`` — the DSL path (K0): ``matmul_cmma_kernel`` and
   ``matmul_cmma_nd_kernel``, cube-scope cmma fragments that the CUDA
   printer keeps in shared memory and the torch evaluator computes with
   ``torch.bmm``.

``matmul_autotuned`` times every tile candidate of the shape through a
captured CUDA graph (``tune/``) and keeps the winner in the sqlite store.
The candidates are the kernel's compiled tile instances (``kernel_tiles``)
that the H100 admits for the shape (``_tile_candidates``); tunable names
stay ``t{tm}x{tn}x{tk}``. Shapes a tile does not divide raise
``ValueError``, as the JAX wrapper asserts.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..backend.compiler import CompiledKernel
from ..frontend import (ArrayArg, MutSlice, MutTensor, Slice, Tensor, cube,
                        cube_range)
from ..frontend import cmma
from ..frontend.topology import CUBE_POS_X, CUBE_POS_Y
from ..ir.types import elem_from_dtype, f32
from ..runtime.base import CubeCount, CubeDim
from ..runtime.handle import Handle
from ..runtime.kernel import KernelId, NativeKernelTask
from ..tune import LocalTuner, TunableSet
from ..tune.anchor import anchor
from ..utils import native

# ---------------------------------------------------------------------------
# 1. the hand-written GEMM (csrc/matmul.cu)
# ---------------------------------------------------------------------------

NT = 256                 # threads per block (8 warps as 2 x 4)
MAX_SMEM = 227 * 1024    # dynamic shared memory a block may use
MAX_ACC_REGS = 128       # accumulator registers per thread (of 255)
# the tile grid the tensor-core kernel is built over: (BM, BN) and the
# bytes of K a stage holds; the H100's limits keep every combination
# (ops over 16-bit or 8-bit elements read the same bytes per mma step)
_MMA_MN = ((64, 128), (128, 128), (128, 256), (256, 128))
_MMA_KB = (64, 128)
# the f32 kernel: (BM, BN) x K per stage
_FMA_MN = ((64, 64), (128, 128))
_FMA_K = (8, 16)

# the operand dtypes the kernel takes, and its output dtypes
IN_DTYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn",
             "float8_e5m2", "int8")
OUT_DTYPES = ("float32", "bfloat16", "float16", "int32")


def _itemsize(dtype: str) -> int:
    return elem_from_dtype(dtype).size


def _matmul_smem(tm: int, tn: int, tk: int, in_bytes: int,
                 b_transposed: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/matmul.cu's MmaTile and
    fma_smem_bytes): f32 stages A and B once; the tensor-core kernel two
    stages of A rows and B (n-major rows, or k-major rows for 16-bit B
    given as (K, N)), each row padded by 16 bytes."""
    if in_bytes == 4:
        return (tk * tm + tk * tn) * 4
    kb = tk * in_bytes
    a = tm * (kb + 16)
    b = tn * (kb + 16) if (b_transposed or in_bytes == 1) \
        else tk * (tn * 2 + 16)
    return 2 * (a + b)


def _acc_regs(tm: int, tn: int) -> int:
    return tm * tn // NT


def _admitted(tm, tn, tk, in_bytes) -> bool:
    """Whether the H100 admits the tile: its stages fit the shared memory
    in both B layouts and its accumulator fits the registers."""
    return (max(_matmul_smem(tm, tn, tk, in_bytes, bt) for bt in (0, 1))
            <= MAX_SMEM and _acc_regs(tm, tn) <= MAX_ACC_REGS)


def kernel_tiles(in_bytes: int):
    """The (tm, tn, tk) instances csrc/matmul.cu is built with for
    ``in_bytes``-byte operands (its CUBECL_MMA_TILES, in bytes of K, and
    CUBECL_FMA_TILES): the grid above, kept where the card admits it."""
    if in_bytes == 4:
        grid = [(m, n, k) for m, n in _FMA_MN for k in _FMA_K]
    else:
        grid = [(m, n, kb // in_bytes) for m, n in _MMA_MN for kb in _MMA_KB]
    return [t for t in grid if _admitted(*t, in_bytes)]


def _tile_candidates(m: int, n: int, k: int, in_bytes: int,
                     out_bytes: int = 4, limit: int = 8):
    """Tile shapes for autotune: the kernel's instances that divide (m, n,
    k) — the JAX rule at ``cubecl_tpu/ops/matmul.py:217`` — largest output
    tile first, then deeper K. 8-bit operands get their own, deeper-K list
    (the same bytes of K per stage). ``out_bytes`` is taken for the JAX
    signature: the epilogue writes from registers, so the output does not
    size a tile."""
    out = [t for t in kernel_tiles(in_bytes)
           if not (m % t[0] or n % t[1] or k % t[2])]
    out.sort(key=lambda t: (-t[0] * t[1], -t[2], t[0]))
    return out[:limit]


def _default_tile(m, n, k, in_bytes) -> Tuple[int, int, int]:
    cands = _tile_candidates(m, n, k, in_bytes)
    if not cands:
        raise ValueError(f"no tile of the matmul kernel divides ({m}, {n}, "
                         f"{k}) for {in_bytes}-byte operands; tiles: "
                         f"{kernel_tiles(in_bytes)}")
    return cands[0]


def _check_tile(m, n, k, tile, in_dtype: str) -> None:
    in_bytes = _itemsize(in_dtype)
    if tuple(tile) not in kernel_tiles(in_bytes):
        raise ValueError(f"matmul: tile {tuple(tile)} is not built for "
                         f"{in_dtype}; tiles: {kernel_tiles(in_bytes)}")
    if m % tile[0] or n % tile[1] or k % tile[2]:
        raise ValueError(f"matmul: tile {tuple(tile)} does not divide "
                         f"(M, N, K) = ({m}, {n}, {k})")


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls in full f32: TF32 off while the block runs."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def matmul_plain(a, b, out_dtype, b_transposed: bool = False, scale=None):
    """The kernel's function in plain PyTorch: ``cast(epilogue(a @ b))``.

    Float operands (f32, bf16, f16, fp8) are upcast to f32 and multiplied
    by ``torch.matmul`` in full f32 (TF32 off): the products of 16- and
    8-bit floats are exact in f32. int8 operands accumulate exactly: in
    int64 on the CPU, in float64 on the card (CUDA has no integer mm;
    exact while |sum| < 2^53), then wrap to the int32 accumulator.
    ``scale`` (a float or a 0-dim f32 tensor, the product sa * sb taken in
    f32) multiplies f32(acc) before the cast to ``out_dtype``."""
    bb = b.t() if b_transposed else b
    if a.dtype == torch.int8:
        if a.device.type == "cpu":
            acc = torch.matmul(a.long(), bb.long())
        else:
            acc = torch.matmul(a.double(), bb.double()).long()
        acc = acc.to(torch.int32)
        if scale is None:
            return acc.to(out_dtype)
        return (acc.float() * scale).to(out_dtype)
    with _full_f32():
        acc = torch.matmul(a.float(), bb.float())
    if scale is not None:
        acc = acc * scale
    return acc.to(out_dtype)


def _scale_product(sa, sb):
    """sa * sb in f32: host floats give a float, tensors a 0-dim tensor."""
    if isinstance(sa, torch.Tensor):
        return sa.reshape(-1)[0].float() * sb.reshape(-1)[0].float()
    return float(np.float32(sa) * np.float32(sb))


def _gemm(a, b, out, tile, b_transposed: bool, sa=None, sb=None,
          counter=None) -> None:
    """``out = cast(epilogue(a @ b))`` on 2-D tensors: the kernel on CUDA
    tensors, :func:`matmul_plain` on CPU tensors. ``sa``/``sb``: None
    (unscaled), two device scalars (f32 tensors, M1 scaled) or two host
    floats (M2)."""
    m, k = a.shape
    n = b.shape[0] if b_transposed else b.shape[1]
    if out.device.type == "cpu":
        scale = None if sa is None else _scale_product(sa, sb)
        out.copy_(matmul_plain(a, b, out.dtype, b_transposed, scale))
        return
    tensors = [a, b, out]
    if isinstance(sa, torch.Tensor):
        sa, sb = sa.reshape(-1), sb.reshape(-1)
        tensors += [sa, sb]
        if sa.dtype != torch.float32 or sb.dtype != torch.float32:
            raise ValueError("matmul: device scales must be f32")
    if any(t.device != out.device for t in tensors):
        raise ValueError(f"matmul: tensors on {[str(t.device) for t in tensors]}"
                         "; the kernel wants them on one card")
    if not all(t.is_contiguous() for t in (a, b, out)):
        raise ValueError("matmul: the kernel wants contiguous tensors")
    native.check_aligned(a, b, out)
    if sa is None:
        mode, ps, scale = 0, (None, None), 1.0
    elif isinstance(sa, torch.Tensor):
        mode, ps, scale = 1, (sa.data_ptr(), sb.data_ptr()), 1.0
    else:
        mode, ps, scale = 2, (None, None), _scale_product(sa, sb)
    lib = native.kernels()
    with torch.cuda.device(out.device):
        rc = lib.cubecl_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), ps[0], ps[1],
            native.DTYPE_CODES[a.dtype], native.DTYPE_CODES[out.dtype],
            m, n, k, tile[0], tile[1], tile[2], int(b_transposed), mode,
            scale, torch.cuda.current_stream().cuda_stream)
    native.check(lib, rc, "matmul")
    if not torch.cuda.is_current_stream_capturing():
        counter.launches += 1  # a graph's recording runs nothing


def _check_types(in_dtype, out_dtype, acc_dtype, scaled) -> None:
    if in_dtype not in IN_DTYPES or out_dtype not in OUT_DTYPES:
        raise ValueError(f"matmul takes {IN_DTYPES} operands and "
                         f"{OUT_DTYPES} outputs; got {in_dtype} -> "
                         f"{out_dtype}")
    want_acc = "int32" if in_dtype == "int8" else "float32"
    if acc_dtype != want_acc:
        raise ValueError(f"matmul on {in_dtype} accumulates in {want_acc}; "
                         f"got acc_dtype {acc_dtype}")
    if out_dtype == "int32" and (in_dtype != "int8" or scaled):
        raise ValueError("an int32 output is the unscaled int8 GEMM's")


def _native_compiled(name, fn, mutable, source, m, n, tile,
                     smem) -> CompiledKernel:
    return CompiledKernel(fn=fn, mutable_indices=[mutable], source=source,
                          name=name, block=(NT, 1, 1),
                          grid=(n // tile[1], m // tile[0], 1),
                          smem_bytes=smem, smem_opt_in=True)


def _build_matmul(m: int, n: int, k: int, tm: int, tn: int, tk: int,
                  in_dtype: str, out_dtype: str, acc_dtype: str,
                  b_transposed: bool = False,
                  scaled: bool = False) -> CompiledKernel:
    """M1: the tiled GEMM. Buffers ``(a, b, out)``, or ``(a, sa, b, sb,
    out)`` when ``scaled`` (two f32 device scalars multiply the
    accumulator in the epilogue: the fused dequant of the quantized
    GEMM)."""
    _check_types(in_dtype, out_dtype, acc_dtype, scaled)
    tile = (tm, tn, tk)
    _check_tile(m, n, k, tile, in_dtype)
    b_shape = (n, k) if b_transposed else (k, n)

    def fn(buffers, scalars=()):
        if scaled:
            a, sa, b, sb, o = buffers
        else:
            (a, b, o), sa, sb = buffers, None, None
        _gemm(a.view(m, k), b.view(b_shape), o.view(m, n), tile,
              b_transposed, sa, sb, counter=matmul_pallas)

    return _native_compiled(
        f"matmul_{tm}x{tn}x{tk}", fn, 4 if scaled else 2,
        f"csrc/matmul.cu {m}x{n}x{k} tiles {tm}x{tn}x{tk} {in_dtype}->"
        f"{out_dtype}{' bT' if b_transposed else ''}"
        f"{' scaled' if scaled else ''}", m, n, tile,
        _matmul_smem(tm, tn, tk, _itemsize(in_dtype), b_transposed))


def _operand_dtype(a: Handle, in_dtype: Optional[str]) -> str:
    have = str(a.dtype).replace("torch.", "")
    if in_dtype is not None and in_dtype != have:
        raise ValueError(f"matmul reads its operands in their own dtype: "
                         f"a is {have}, in_dtype {in_dtype}")
    return have


def _out_dtype(out: Handle) -> str:
    return str(out.dtype).replace("torch.", "")


def matmul_pallas(client, a: Handle, b: Handle, out: Handle,
                  m: int, n: int, k: int,
                  tm: Optional[int] = None, tn: Optional[int] = None,
                  tk: Optional[int] = None, in_dtype: Optional[str] = None,
                  acc_dtype: Optional[str] = None,
                  b_transposed: bool = False) -> None:
    """One launch of M1 with tile (tm, tn, tk) (default: the largest that
    divides the shape): the CUDA kernel on a card, the plain version on
    the CPU client."""
    in_dtype = _operand_dtype(a, in_dtype)
    acc_dtype = acc_dtype or ("int32" if in_dtype == "int8" else "float32")
    if tm is None or tn is None or tk is None:
        tm, tn, tk = _default_tile(m, n, k, _itemsize(in_dtype))
    od = _out_dtype(out)
    kid = KernelId.build("matmul_pallas", m, n, k, tm, tn, tk, in_dtype,
                         od, acc_dtype, b_transposed)
    task = NativeKernelTask(
        kid, lambda: _build_matmul(m, n, k, tm, tn, tk, in_dtype, od,
                                   acc_dtype, b_transposed),
        name="matmul_pallas")
    client.launch(task, [a, b, out])


matmul_pallas.launches = 0


_matmul_tuner = LocalTuner("matmul")


def _tune_key(m, n, k, in_dtype, out_dtype):
    return ("matmul", anchor(m), anchor(n), anchor(k), in_dtype, out_dtype)


def matmul_tunables(m: int, n: int, k: int, in_dtype: str,
                    out_dtype: str) -> TunableSet:
    """The autotune set of one shape: a ``t{tm}x{tn}x{tk}`` candidate per
    tile of :func:`_tile_candidates`, each with its roofline work, keyed
    by the anchored shape and the dtypes. Raises ``ValueError`` when no
    tile divides the shape."""
    in_bytes = _itemsize(in_dtype)

    def key_fn(client_, a_, b_, out_):
        return _tune_key(m, n, k, in_dtype, out_dtype)

    def work(key):
        return (2 * m * n * k, (m * k + k * n) * in_bytes
                + m * n * _itemsize(out_dtype), in_dtype)

    # integer GEMMs accumulate exactly in int32
    acc_dtype = "int32" if in_dtype == "int8" else "float32"
    ts = TunableSet("matmul", key_fn)
    for (tm, tn, tk) in _tile_candidates(m, n, k, in_bytes,
                                         _itemsize(out_dtype)):
        ts.with_tunable(
            functools.partial(matmul_pallas, m=m, n=n, k=k, tm=tm, tn=tn,
                              tk=tk, in_dtype=in_dtype, acc_dtype=acc_dtype),
            name=f"t{tm}x{tn}x{tk}", work=work)
    if not ts.tunables:
        _default_tile(m, n, k, in_bytes)  # raises, naming the tiles
    return ts


def matmul_autotuned(client, a: Handle, b: Handle, out: Handle,
                     m: int, n: int, k: int,
                     in_dtype: Optional[str] = None) -> None:
    """Autotuned entry: on the first call per anchored key every tile
    candidate is captured as a CUDA graph and timed by CUDA events (host
    timing on the CPU); the winner is kept in memory and in the sqlite
    store and runs on every later call (reference LocalTuner::execute
    flow, SURVEY §3.4)."""
    in_dtype = _operand_dtype(a, in_dtype)
    ts = matmul_tunables(m, n, k, in_dtype, _out_dtype(out))
    _matmul_tuner.execute(client, ts, client, a, b, out)


def autotune_best_tile(client, a: Handle, b: Handle, out: Handle,
                       m: int, n: int, k: int,
                       in_dtype: Optional[str] = None) -> Tuple[int, int, int]:
    """Settle the autotune for this shape (tunes on first use: on a card
    every candidate's M1 launch timed as a CUDA graph) and return the
    winning (tm, tn, tk)."""
    in_dtype = _operand_dtype(a, in_dtype)
    matmul_autotuned(client, a, b, out, m, n, k, in_dtype)
    key = _tune_key(m, n, k, in_dtype, _out_dtype(out))
    tuner = _matmul_tuner.tuner_for(
        client, key, matmul_tunables(m, n, k, in_dtype, _out_dtype(out)))
    hit = tuner.cache.mem.get(str(key)) if tuner is not None else None
    if hit is None:
        raise RuntimeError(
            f"autotune did not record a result for {key}: "
            f"tuner={'missing' if tuner is None else 'present'}, "
            f"recorded keys={list(tuner.cache.mem) if tuner else []}")
    name = hit[1]  # "t{tm}x{tn}x{tk}"
    tm, tn, tk = (int(x) for x in name[1:].split("x"))
    return tm, tn, tk


def autotune_top_tiles(client, a: Handle, b: Handle, out: Handle,
                       m: int, n: int, k: int,
                       in_dtype: Optional[str] = None,
                       top: int = 3) -> list:
    """Like :func:`autotune_best_tile` but returns the ``top`` fastest
    tiles by measured time (the winner alone when the timings came from
    the store without per-candidate times)."""
    in_dtype = _operand_dtype(a, in_dtype)
    best = autotune_best_tile(client, a, b, out, m, n, k, in_dtype)
    key = _tune_key(m, n, k, in_dtype, _out_dtype(out))
    tuner = _matmul_tuner.tuner_for(
        client, key, matmul_tunables(m, n, k, in_dtype, _out_dtype(out)))
    timings = tuner.cache.timings(key) if tuner is not None else {}
    if not timings:
        return [best]
    ranked = sorted(timings.items(), key=lambda kv: kv[1])[:top]
    return [tuple(int(x) for x in name[1:].split("x"))
            for name, _t in ranked]


# ---------------------------------------------------------------------------
# 2. DSL CMMA path (reference cmma::execute flow)
# ---------------------------------------------------------------------------


@cube
def matmul_cmma_kernel(a: Slice, b: Slice, out: MutSlice,
                       m: int, n: int, k: int, tile: int, elem):
    """One cube per (tile, tile) output tile; K-loop of executes.
    m/n/k/tile/elem are comptime (static shapes); offsets are traced.
    Reference flow: cmma::{fill,load,execute,store} (cmma.rs:850-953)."""
    row = CUBE_POS_Y * tile
    col = CUBE_POS_X * tile
    acc = cmma.Matrix("accumulator", tile, tile, tile, f32)
    cmma.fill(acc, 0.0)
    ma = cmma.Matrix("a", tile, tile, tile, elem)
    mb = cmma.Matrix("b", tile, tile, tile, elem)
    for kk in cube_range(0, k // tile):
        cmma.load(ma, a, k, offset=row * k + kk * tile)
        cmma.load(mb, b, n, offset=(kk * tile) * n + col)
        cmma.execute(ma, mb, acc, acc)
    cmma.store(acc, out, n, offset=row * n + col)


@cube
def matmul_cmma_nd_kernel(a: Tensor, b: Tensor, out: MutTensor,
                          tm: int, tn: int, tk: int, k: int, elem):
    """Tiled CMMA matmul over TENSOR params: load_tensor/store_tensor
    carry per-dim indices — A a (tm, tk) window per step of a cy row
    stripe, B a (tk, tn) window of a cx column stripe, OUT a (tm, tn)
    block. ``tn`` and ``tk`` are multiples of the line size."""
    L = a.line_size
    row = CUBE_POS_Y * tm
    col_l = CUBE_POS_X * (tn // L)
    acc = cmma.Matrix("accumulator", tm, tn, tk, f32)
    cmma.fill(acc, 0.0)
    ma = cmma.Matrix("a", tm, tn, tk, elem)
    mb = cmma.Matrix("b", tm, tn, tk, elem)
    for kk in cube_range(0, k // tk):
        cmma.load_tensor(ma, a, row, kk * (tk // L))
        cmma.load_tensor(mb, b, kk * tk, col_l)
        cmma.execute(ma, mb, acc, acc)
    cmma.store_tensor(acc, out, row, col_l)


CMMA_CUBE_DIM = 256  # a multiple of 32; the cmma bodies are cube-scope
CMMA_LINE = 4        # the printer's vector width


def _cmma_plan(m, n, k, elem_bytes, tile):
    """(tm, tn, tk) of ``matmul_cmma``: fragments that fit shared memory —
    an f32 accumulator (tm, tn) and operand tiles (tm, tk), (tk, tn) —
    128 x 128 x 32 where the shape allows (80 KiB in bf16, 96 KiB in f32),
    else the largest power-of-two divisors from ``tile`` down. The JAX
    wrapper's whole-K 512 x 1024 fragments are a TPU VMEM plan; on the
    H100 they would need megabytes of shared memory."""
    def fit(dim, start):
        t = start
        while t > 1 and dim % t:
            t //= 2
        return t

    tm, tn = fit(m, min(tile, 128)), fit(n, min(tile, 128))
    tk = fit(k, 32)
    smem = tm * tn * 4 + (tm * tk + tk * tn) * elem_bytes
    if smem > MAX_SMEM:  # only a caller's tile > 128 gets here
        raise ValueError(f"matmul_cmma: fragments {tm}x{tn}x{tk} need "
                         f"{smem} bytes of shared memory")
    return tm, tn, tk


def matmul_cmma(client, a: Handle, b: Handle, out: Handle,
                m: int, n: int, k: int, tile: int = 128) -> None:
    """DSL CMMA matmul (K0). On a card the CUDA printer keeps each
    fragment in shared memory and computes ``execute`` in f32 FMA with
    one output element per thread at a time; on the CPU the torch
    evaluator runs it. With ``tn`` and ``tk`` multiples of the printer's
    4-element lines the ND kernel runs over 2-D tensors, else the 1-line
    array kernel over square ``tile`` fragments."""
    from ..frontend import TensorArg

    elem = elem_from_dtype(a.dtype)
    tm, tn, tk = _cmma_plan(m, n, k, elem.size, tile)
    if tn % CMMA_LINE == 0 and tk % CMMA_LINE == 0:
        L = CMMA_LINE
        matmul_cmma_nd_kernel.launch_unchecked(
            client, CubeCount(n // tn, m // tm),
            CubeDim.new_1d(CMMA_CUBE_DIM),
            TensorArg(a, shape=(m, k), line_size=L),
            TensorArg(b, shape=(k, n), line_size=L),
            TensorArg(out, shape=(m, n), line_size=L, mutable=True),
            tm, tn, tk, k, elem)
        return
    t = min(tm, tn, tk)
    matmul_cmma_kernel.launch_unchecked(
        client, CubeCount(n // t, m // t), CubeDim.new_1d(CMMA_CUBE_DIM),
        ArrayArg(a), ArrayArg(b), ArrayArg(out, mutable=True),
        m, n, k, t, elem)


# ---------------------------------------------------------------------------
# 3. Quantized int8 matmul (M1 scaled: exact int8 GEMM, fused dequant)
# ---------------------------------------------------------------------------


def matmul_quantized(client, a: Handle, b: Handle, out: Handle,
                     m: int, n: int, k: int,
                     tm: Optional[int] = None, tn: Optional[int] = None,
                     tk: Optional[int] = None,
                     b_transposed: bool = False) -> None:
    """f32 matmul through per-tensor symmetric int8 quantization: absmax
    scales on the device (``std.quant_kernels``, K0), the exact int8 ->
    int32 GEMM with the dequant scale sa * sb fused into its epilogue (M1
    scaled, device scalars), ~1e-2 relative error (quantization noise).
    ``b_transposed``: the B handle is (N, K), pre-transposed weights."""
    from ..std.quant import QuantScheme
    from ..std.quant_kernels import quantize

    scheme = QuantScheme()  # per-tensor symmetric int8
    qa, sa = quantize(client, a, scheme)
    qb, sb = quantize(client, b, scheme)
    if tm is None or tn is None or tk is None:
        tm, tn, tk = _default_tile(m, n, k, 1)
    od = _out_dtype(out)
    kid = KernelId.build("matmul_int8_dq", m, n, k, tm, tn, tk, od,
                         b_transposed)
    task = NativeKernelTask(
        kid, lambda: _build_matmul(m, n, k, tm, tn, tk, "int8", od,
                                   "int32", b_transposed=b_transposed,
                                   scaled=True),
        name="matmul_int8_dq")
    client.launch(task, [qa, sa, qb, sb, out])


# ---------------------------------------------------------------------------
# 4. fp8 scaled matmul (M2: reference cmma::execute_scaled)
# ---------------------------------------------------------------------------


def _build_matmul_scaled(m: int, n: int, k: int, tm: int, tn: int, tk: int,
                         in_dtype: str, out_dtype: str,
                         b_transposed: bool = False) -> CompiledKernel:
    """M2: ``out = (a @ b) * (scale_a * scale_b)`` with the two scales
    given as host floats at launch (``scalars``), applied to the
    accumulator in the epilogue — M1's kernel with its host-scale flag."""
    acc = "int32" if in_dtype == "int8" else "float32"
    _check_types(in_dtype, out_dtype, acc, True)
    tile = (tm, tn, tk)
    _check_tile(m, n, k, tile, in_dtype)
    b_shape = (n, k) if b_transposed else (k, n)

    def fn(buffers, scalars=()):
        a, b, o = buffers
        sa, sb = scalars
        _gemm(a.view(m, k), b.view(b_shape), o.view(m, n), tile,
              b_transposed, float(sa), float(sb), counter=matmul_scaled)

    return _native_compiled(
        f"matmul_scaled_{tm}x{tn}x{tk}", fn, 2,
        f"csrc/matmul.cu scaled {m}x{n}x{k} tiles {tm}x{tn}x{tk} "
        f"{in_dtype}->{out_dtype}{' bT' if b_transposed else ''}", m, n,
        tile, _matmul_smem(tm, tn, tk, _itemsize(in_dtype), b_transposed))


def matmul_scaled(client, a: Handle, b: Handle, out: Handle,
                  m: int, n: int, k: int,
                  scale_a: float = 1.0, scale_b: float = 1.0,
                  tm: Optional[int] = None, tn: Optional[int] = None,
                  tk: Optional[int] = None, in_dtype: Optional[str] = None,
                  b_transposed: bool = False) -> None:
    """Scaled matmul: ``out = (a @ b) * scale_a * scale_b`` — the
    dequantizing epilogue for fp8/int8 quantized weights (reference
    cmma::execute_scaled). On a card one launch of M2 (M1's kernel with
    the host scales in its epilogue), counted in
    ``matmul_scaled.launches``; on the CPU client the plain version."""
    in_dtype = _operand_dtype(a, in_dtype)
    if tm is None or tn is None or tk is None:
        tm, tn, tk = _default_tile(m, n, k, _itemsize(in_dtype))
    od = _out_dtype(out)
    kid = KernelId.build("matmul_scaled", m, n, k, tm, tn, tk, in_dtype, od,
                         b_transposed)
    task = NativeKernelTask(
        kid, lambda: _build_matmul_scaled(m, n, k, tm, tn, tk, in_dtype, od,
                                          b_transposed),
        name="matmul_scaled")
    client.launch(task, [a, b, out], [float(scale_a), float(scale_b)])


matmul_scaled.launches = 0
