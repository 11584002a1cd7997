"""Autotuned tiled matmul (BASELINE config 4): counterpart of
``cubecl_tpu.ops.matmul``, with its public names.

Two implementations behind one autotuned entry point, as in the JAX
package:

1. ``matmul_pallas`` — the hand-written GEMM. On CUDA tensors it launches
   the kernels that replace the TPU kernels M1 ``_build_matmul``
   (``pallas_call`` :112) and M2 ``_build_matmul_scaled`` (:508). bf16,
   f16, fp8 and int8 operands run on ``wgmma`` fed by TMA, one mainloop
   (``csrc/wgmma_gemm.cuh``): ``csrc/matmul.cu`` for 16-bit operands
   (persistent blocks, B given as (K, N) read in place through the
   ``wgmma`` transpose bit), ``csrc/matmul8.cu`` for 8-bit ones (int8 on
   the 8-bit ``wgmma``, fp8 as exact f16 values on the 16-bit one, whose
   sums hold f32's tolerance where the 8-bit one's do not; 8-bit B given
   as (K, N) is byte-transposed into a scratch (N, K) first, in the same
   call). f32 runs on the same mainloop as three TF32 products a k8 step
   (3xTF32: each operand split into big = x truncated to tf32 and small =
   tf32(x - big), A_small B_big + A_big B_small + A_big B_big summed in
   f32, as close to the float64 product as an f32 FMA loop; one TF32
   product would miss the f32 tolerance of the TPU kernel's
   ``Precision.HIGHEST``); TF32 has no transpose bit, so f32 B given as
   (K, N) is transposed into a scratch (N, K) first, in the same call.
   int8 accumulates exactly in int32. B comes as (K, N) or, with ``b_transposed``, as (N, K). An
   epilogue multiplies the accumulator by ``sa * sb``: device scalars for
   M1's scaled form (the ``matmul_quantized`` route), host floats for M2
   (``matmul_scaled``). On CPU tensors the same entry points run
   :func:`matmul_plain`. Bound at 4096^3 on the H100: 2 * 4096^3
   operations over the dtype's peak — bf16/f16 0.139 ms, fp8 and int8
   0.069 ms (fp8 on the f16 route: 0.139), f32 the lesser of the CUDA
   cores' 2.05 ms and three TF32 products' 0.833 ms; the bytes are 0.03
   ms. ``matmul_pallas.launches`` and
   ``matmul_scaled.launches`` count the kernel's launches that run
   outside a CUDA graph: eager calls and a graph's warm launch, not its
   recording nor its replays.
2. ``matmul_cmma`` — the DSL path (K0): ``matmul_cmma_kernel`` and
   ``matmul_cmma_nd_kernel``, cube-scope cmma fragments that the CUDA
   printer runs on ``wgmma`` (16-bit, and f32 as 3xTF32) and the torch
   evaluator computes with ``torch.bmm``.

``matmul_autotuned`` times every tile candidate of the shape through a
captured CUDA graph (``tune/``) and keeps the winner in the sqlite store.
The candidates are the kernel's compiled tile instances (``kernel_tiles``)
that the H100 admits for the shape (``_tile_candidates``); tunable names
stay ``t{tm}x{tn}x{tk}``. Shapes a tile does not divide raise
``ValueError``, as the JAX wrapper asserts; a 16-bit tile's ``tk`` is
64 and an f32 tile's 32 (a stage of 128 bytes), but K need only be a
multiple of 32 and of 8 (``_k_unit``): the kernel's tensor maps
zero-fill a last partial stage, which adds nothing to the sums.
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

WG_THREADS = 384         # the wgmma kernels: producer + 2 consumer warpgroups
WG_MAX_BLOCKS = 132      # persistent blocks of the 16-bit and f32 kernels
MAX_SMEM = 227 * 1024    # dynamic shared memory a block may use
MAX_ACC_REGS = 128       # accumulator registers per thread (of 255)
# the wgmma kernels (csrc/wgmma_gemm.cuh's WgGemmTile): (BM, BN) and 128
# bytes of K a stage (one swizzle row); 8-bit (csrc/matmul8.cu's
# CUBECL_WG_TILES) a ring of up to 5 stages in 144 KiB and two buffers of
# B's f16 panels, 16-bit (csrc/matmul.cu's CUBECL_WG16_TILES) its output
# tile staged for TMA stores (BM x BN x 2 bytes) and a ring of up to 6
# stages in the rest of MAX_SMEM, f32 (csrc/matmul.cu's CUBECL_TF32_TILES)
# two buffers of B's big and small tf32 panels and a ring of up to 6
# stages in the rest
_WG_KB = 128
_WG_MN = {1: ((128, 128), (256, 128)),
          2: ((64, 128), (128, 128), (128, 256), (256, 128)),
          4: ((64, 64), (128, 128))}
_WG_MAX_STAGES = {1: 5, 2: 6, 4: 6}

# the operand dtypes the kernel takes, and its output dtypes
IN_DTYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn",
             "float8_e5m2", "int8")
OUT_DTYPES = ("float32", "bfloat16", "float16", "int32")


def _itemsize(dtype: str) -> int:
    return elem_from_dtype(dtype).size


def _wg_out_bytes(tm: int, tn: int, in_bytes: int) -> int:
    """The 16-bit kernel's staged output tile (WgGemmTile::OUT_BYTES)."""
    return tm * tn * 2 if in_bytes == 2 else 0


def _wg_panel_bytes(tn: int, in_bytes: int) -> int:
    """One buffer of the B panels the consumers write
    (WgGemmTile::F16B_BYTES): fp8's two f16 panels of 64 k, f32's big and
    small tf32 panels; the 16-bit kernel writes none."""
    return 0 if in_bytes == 2 else tn * 2 * _WG_KB


def _wg_stages(tm: int, tn: int, in_bytes: int = 1) -> int:
    """Stages of a wgmma kernel's ring: as many as its ring's bytes hold, at
    most its cap (wgmma_gemm.cuh's WgGemmTile::STAGES)."""
    cap = _WG_MAX_STAGES[in_bytes]
    ring = 144 * 1024 if in_bytes == 1 else \
        MAX_SMEM - 1024 - 16 * cap - _wg_out_bytes(tm, tn, in_bytes) \
        - 2 * _wg_panel_bytes(tn, in_bytes)
    return min(cap, ring // ((tm + tn) * _WG_KB))


def _matmul_smem(tm: int, tn: int, tk: int, in_bytes: int,
                 b_transposed: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/wgmma_gemm.cuh's
    WgGemmTile): the ring of 128-byte rows of A and B (the same bytes in
    both B layouts), two buffers of the B panels the consumers write (fp8
    runs as f16, f32 as big and small tf32) or the 16-bit kernel's staged
    output tile, a full and an empty mbarrier a stage and 1024 bytes to
    align the base."""
    stages = _wg_stages(tm, tn, in_bytes)
    return stages * (tm + tn) * _WG_KB + 2 * _wg_panel_bytes(tn, in_bytes) \
        + _wg_out_bytes(tm, tn, in_bytes) + 2 * 8 * stages + 1024


def _acc_regs(tm: int, tn: int) -> int:
    # every kernel spreads the tile over its two consumer warpgroups
    return tm * tn // 256


def _admitted(tm, tn, tk, in_bytes) -> bool:
    """Whether the H100 admits the tile: its stages fit the shared memory
    in both B layouts and its accumulator fits the registers."""
    return (max(_matmul_smem(tm, tn, tk, in_bytes, bt) for bt in (0, 1))
            <= MAX_SMEM and _acc_regs(tm, tn) <= MAX_ACC_REGS)


def kernel_tiles(in_bytes: int):
    """The (tm, tn, tk) instances the kernels are built with for
    ``in_bytes``-byte operands (csrc/matmul.cu's CUBECL_WG16_TILES and
    CUBECL_TF32_TILES, csrc/matmul8.cu's CUBECL_WG_TILES, all three in
    bytes of K): the grids above, kept where the card admits them."""
    grid = [(m, n, _WG_KB // in_bytes) for m, n in _WG_MN[in_bytes]]
    return [t for t in grid if _admitted(*t, in_bytes)]


def _k_unit(tile, in_bytes: int) -> int:
    """What K must be a multiple of for ``tile``: its tk, but 32 for a
    16-bit tile and 8 for an f32 one, whose last stage may be partly past
    K (the tensor maps zero-fill it: exact)."""
    return {2: 32, 4: 8}.get(in_bytes, tile[2])


def _grid(m: int, n: int, tile, in_bytes: int):
    """Blocks of a launch: one a tile for 8-bit operands; the 16-bit and
    f32 kernels' persistent blocks, one a tile up to WG_MAX_BLOCKS."""
    tiles_n, tiles_m = n // tile[1], m // tile[0]
    if in_bytes != 1:
        return (min(tiles_m * tiles_n, WG_MAX_BLOCKS), 1, 1)
    return (tiles_n, tiles_m, 1)


def _tile_candidates(m: int, n: int, k: int, in_bytes: int,
                     out_bytes: int = 4, limit: int = 8):
    """Tile shapes for autotune: the kernel's instances that divide (m, n,
    k) — the JAX rule at ``cubecl_tpu/ops/matmul.py:217``, with K taken in
    ``_k_unit`` — largest output tile first, then deeper K. ``out_bytes``
    is taken for the JAX signature: the epilogue writes from registers, so
    the output does not size a tile."""
    out = [t for t in kernel_tiles(in_bytes)
           if not (m % t[0] or n % t[1] or k % _k_unit(t, in_bytes))]
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
    if m % tile[0] or n % tile[1] or k % _k_unit(tile, in_bytes):
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
    tensors (``csrc/matmul8.cu`` for 8-bit operands, ``csrc/matmul.cu``
    for the others), :func:`matmul_plain` on CPU tensors. ``sa``/``sb``:
    None (unscaled), two device scalars (f32 tensors, M1 scaled) or two
    host floats (M2). 8-bit and f32 B given as (K, N) is transposed into a
    scratch (N, K) by the same call, before its GEMM: an 8-bit or TF32
    ``wgmma`` reads K-major operands only."""
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
    args = (ps[0], ps[1], native.DTYPE_CODES[a.dtype],
            native.DTYPE_CODES[out.dtype], m, n, k, tile[0], tile[1],
            tile[2], int(b_transposed), mode, scale)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = None if b_transposed or a.element_size() == 2 else \
            torch.empty((n, k), dtype=a.dtype, device=out.device)
        entry = lib.cubecl_matmul8 if a.element_size() == 1 else \
            lib.cubecl_matmul
        rc = entry(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), *args,
                   stream)
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


def _source(in_bytes: int) -> str:
    """The kernel file of ``in_bytes``-byte operands."""
    return "csrc/matmul8.cu" if in_bytes == 1 else "csrc/matmul.cu"


def _native_compiled(name, fn, mutable, source, m, n, tile, smem,
                     in_bytes) -> CompiledKernel:
    return CompiledKernel(fn=fn, mutable_indices=[mutable], source=source,
                          name=name, block=(WG_THREADS, 1, 1),
                          grid=_grid(m, n, tile, in_bytes),
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

    in_bytes = _itemsize(in_dtype)
    return _native_compiled(
        f"matmul_{tm}x{tn}x{tk}", fn, 4 if scaled else 2,
        f"{_source(in_bytes)} {m}x{n}x{k} tiles {tm}x{tn}x{tk} {in_dtype}->"
        f"{out_dtype}{' bT' if b_transposed else ''}"
        f"{' scaled' if scaled else ''}", m, n, tile,
        _matmul_smem(tm, tn, tk, in_bytes, b_transposed), in_bytes)


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


CMMA_CUBE_DIM = 256  # two warpgroups: the tensor-core route's 64-row bands
CMMA_LINE = 4        # the printer's vector width


def _cmma_plan(m, n, k, elem_bytes, tile):
    """(tm, tn, tk) of ``matmul_cmma``: fragments that fit shared memory —
    an f32 accumulator (tm, tn) and operand tiles (tm, tk), (tk, tn) —
    128 x 128 where the shape allows, tk 64 for 16-bit operands (one
    128-byte swizzle row: the printer's tensor-core route, the accumulator
    in registers, 32 KiB of shared memory) and 32 otherwise (f32 and int8
    on the FMA route, all three fragments in shared memory: 96 KiB in
    f32), else the largest power-of-two divisors from those down. The JAX
    wrapper's whole-K 512 x 1024 fragments are a TPU VMEM plan; on the
    H100 they would need megabytes of shared memory."""
    def fit(dim, start):
        t = start
        while t > 1 and dim % t:
            t //= 2
        return t

    tm, tn = fit(m, min(tile, 128)), fit(n, min(tile, 128))
    tk = fit(k, 64 if elem_bytes == 2 else 32)
    smem = tm * tn * 4 + (tm * tk + tk * tn) * elem_bytes
    if smem > MAX_SMEM:  # only a caller's tile > 128 gets here
        raise ValueError(f"matmul_cmma: fragments {tm}x{tn}x{tk} need "
                         f"{smem} bytes of shared memory")
    return tm, tn, tk


def matmul_cmma(client, a: Handle, b: Handle, out: Handle,
                m: int, n: int, k: int, tile: int = 128) -> None:
    """DSL CMMA matmul (K0). On a card the CUDA printer runs bf16 and f16
    fragments on the tensor cores (``wgmma`` from the operand fragments in
    shared memory, the accumulator in registers) and f32 or int8 ones in
    FMA, one output element per thread at a time; on the CPU the torch
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

    in_bytes = _itemsize(in_dtype)
    return _native_compiled(
        f"matmul_scaled_{tm}x{tn}x{tk}", fn, 2,
        f"{_source(in_bytes)} scaled {m}x{n}x{k} tiles {tm}x{tn}x{tk} "
        f"{in_dtype}->{out_dtype}{' bT' if b_transposed else ''}", m, n,
        tile, _matmul_smem(tm, tn, tk, in_bytes, b_transposed), in_bytes)


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
