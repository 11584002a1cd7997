"""Convolutions: counterpart of ``cubecl_tpu.ops.conv``, with its names.

Layouts are the JAX package's: NHWC activations and HWIO filters, passed as
flat handles with their sizes.

1. ``conv2d`` — a ``NativeKernelTask`` around ``torch.nn.functional.conv2d``
   (the JAX package used XLA's convolution outside Pallas; here cuDNN on a
   card). SAME and integer pads are computed explicitly, as
   ``conv2d_im2col`` does, so any stride works.
2. ``conv2d_im2col`` — patches extracted by a native task into an
   (N·OH·OW, R·S·C) matrix in (R, S, C) column order, multiplied through the
   port's ``matmul_autotuned`` (M1); shapes M1 does not tile (M, K or k not a
   multiple of 128) fall back to ``conv2d``, as in the JAX package.
3. ``conv2d_pairs`` / ``conv2d_pairs_packed`` — the 3x3, stride-1, SAME conv
   for C, K <= 64. The JAX kernel C1 packs two pixels on the TPU's 128 lanes
   ((N, H·W/2, 128), ``pack_pairs``); that layout is NHWC with 64 channels a
   pixel in memory, so the port keeps the layout at its API and runs C1 as
   the direct convolution it computes: ``csrc/conv3x3.cu`` on CUDA tensors
   (an implicit GEMM on ``wgmma``: bf16 in one product a k16 step, f32 as
   three TF32 products a k8 step, its weights split once a call by a small
   kernel into a scratch the wrapper allocates;
   ``conv2d_pairs_packed.launches`` counts its launches),
   ``conv2d_pairs_plain`` — nine shifted (N, H, W, 64) x (64, 64) products
   summed in f32, independent of cuDNN — on CPU tensors and as the kernel's
   reference on the card. Weights are zero-padded to 64 x 64 and rounded to
   the input's dtype before the products, as the JAX kernel does; output
   channels K..63 are exact zeros.

``conv2d_autotuned`` chooses among them per anchored shape with the port's
``tune/`` (captured CUDA graphs timed by CUDA events on a card): "native",
"im2col" where M, K and k are multiples of 128, and "pairs" for 3x3, stride
1, SAME, C and K <= 64 and even W (``conv2d_tunables``; the last two only
where their kernels take the dtype, and never pruned: their build and
launch errors raise). The tuner's capture runs each candidate
once before recording it (``runtime/graph.py``), so cuDNN picks its
algorithm and workspace outside the CUDA graph.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple, Union

import torch
import torch.nn.functional as TF

from ..backend.compiler import CompiledKernel
from ..runtime.handle import Handle
from ..runtime.kernel import KernelId, NativeKernelTask
from ..tune import LocalTuner, TunableSet
from ..tune.anchor import anchor
from ..utils import native
from .matmul import IN_DTYPES as M1_IN_DTYPES
from .matmul import OUT_DTYPES as M1_OUT_DTYPES
from .matmul import _full_f32, _tile_candidates, matmul_autotuned

Pad = Union[str, int, Tuple[int, int]]

PAIR_CH = 64                 # channels a pixel carries in the pair layout
C1_DTYPES = (torch.float32, torch.bfloat16)
# C1's launch plans, copied from csrc/conv3x3.cu for the launch's
# validation on any client; ``c1_kernel_plan`` reads the built kernel's
# (``cubecl_conv3x3_plan``) on a card to hold ``c1_plan`` to it.
# Both bodies (wgmma): a producer and two consumer warpgroups, persistent
# blocks (at most one an SM of the H100), a ring of 2 halo stages. bf16: the
# resident bf16 weights, halo stages of at most 600 pixels of 128 bytes,
# tiles at most 198 columns wide
C1_WG_THREADS = 384
C1_WG_MAX_BLOCKS = 132
C1_WG_WEIGHTS = 9 * 64 * 64 * 2
C1_WG_STAGES = 2
C1_WG_MAX_HALO = 600
C1_WG_MAX_TW = 198
# f32 (three TF32 wgmma products a k8 step): the split weights streamed
# through a ring of 3 tap stages of 32 KiB (a tap's big and small halves),
# a halo stage of at most 256 pixels as two 1024-aligned panels of 128
# bytes a pixel, tiles at most 83 columns wide; the split weights' scratch
# (9 taps x 2 halves x 64 x 64 f32)
C1_F32_W_STAGES = 3
C1_F32_TAP_BYTES = 4 * 64 * 128
C1_F32_MAX_HALO = 256
C1_F32_MAX_TW = C1_F32_MAX_HALO // 3 - 2
C1_F32_SCRATCH = 9 * 2 * 64 * 64


@dataclasses.dataclass(frozen=True)
class C1Plan:
    """One launch of C1: ``threads`` a block, a tile's output ``tile``
    (rows, columns), dynamic shared memory ``smem_bytes`` and the
    ``grid``."""
    threads: int
    tile: Tuple[int, int]
    smem_bytes: int
    grid: Tuple[int, int, int]


def c1_body(dtype) -> str:
    """The body C1 runs for ``dtype``, both on the tensor cores: "wgmma"
    (bf16) or "wgmma-tf32x3" (f32, three TF32 products a k8 step)."""
    return "wgmma" if dtype == torch.bfloat16 else "wgmma-tf32x3"


def c1_plan(dtype, n: int, h: int, w: int) -> C1Plan:
    """C1's launch plan for an (n, h, w) input of ``dtype``: the arithmetic
    of csrc/conv3x3.cu (``wg_plan`` for bf16, ``f32_plan`` for f32). A tile
    is ``tr`` rows x ``tw`` columns of one image, its halo (tr + 2) x
    (tw + 2) pixels in a stage on a 1024-byte boundary (bf16: 128 bytes a
    pixel; f32: two 1024-aligned panels of 128 bytes a pixel); one
    persistent block a tile up to 132."""
    if dtype == torch.float32:
        wb = -(-w // C1_F32_MAX_TW)
        tw = -(-w // wb)
        tr = min(h, C1_F32_MAX_HALO // (tw + 2) - 2)
        tiles = n * -(-h // tr) * wb
        panel = -(-(tr + 2) * (tw + 2) * 128 // 1024) * 1024
        smem = C1_F32_W_STAGES * C1_F32_TAP_BYTES \
            + C1_WG_STAGES * 2 * panel \
            + 2 * (C1_F32_W_STAGES + C1_WG_STAGES) * 8 + 1024
        return C1Plan(C1_WG_THREADS, (tr, tw), smem,
                      (min(tiles, C1_WG_MAX_BLOCKS), 1, 1))
    if dtype != torch.bfloat16:
        raise ValueError(f"C1 takes {C1_DTYPES}; got {dtype}")
    wb = -(-w // C1_WG_MAX_TW)
    tw = -(-w // wb)
    tr = min(h, C1_WG_MAX_HALO // (tw + 2) - 2)
    tiles = n * -(-h // tr) * wb
    stage = -(-(tr + 2) * (tw + 2) * 2 * PAIR_CH // 1024) * 1024
    smem = C1_WG_WEIGHTS + C1_WG_STAGES * stage \
        + (1 + 2 * C1_WG_STAGES) * 8 + 1024
    return C1Plan(C1_WG_THREADS, (tr, tw), smem,
                  (min(tiles, C1_WG_MAX_BLOCKS), 1, 1))


def _norm_pad(padding: Pad, r: int, s: int):
    if padding == "SAME":
        return "SAME"
    if padding == "VALID":
        return "VALID"
    if isinstance(padding, int):
        return [(padding, padding), (padding, padding)]
    (ph, pw) = padding
    return [(ph, ph), (pw, pw)]


def _out_hw(h, w, r, s, stride, padding):
    sh, sw = stride
    if padding == "SAME":
        return -(-h // sh), -(-w // sw)
    if padding == "VALID":
        return (h - r) // sh + 1, (w - s) // sw + 1
    pads = _norm_pad(padding, r, s)
    return ((h + pads[0][0] + pads[0][1] - r) // sh + 1,
            (w + pads[1][0] + pads[1][1] - s) // sw + 1)


def _explicit_pads(h, w, r, s, stride, padding):
    """((top, bottom), (left, right)) of ``padding``; SAME as XLA pads it
    (the odd row or column at the end)."""
    pads = _norm_pad(padding, r, s)
    if pads == "SAME":
        oh, ow = _out_hw(h, w, r, s, stride, padding)
        ph = max(0, (oh - 1) * stride[0] + r - h)
        pw = max(0, (ow - 1) * stride[1] + s - w)
        return (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)
    if pads == "VALID":
        return (0, 0), (0, 0)
    return tuple(pads[0]), tuple(pads[1])


def _pad_nhwc(x, pads):
    (t, b), (l, r) = pads
    return TF.pad(x, (0, 0, l, r, t, b)) if t or b or l or r else x


def _torch_dtype(name) -> torch.dtype:
    return getattr(torch, str(name).replace("torch.", ""))


def conv2d_native(x, w, stride=(1, 1), padding: Pad = "SAME",
                  acc_dtype="float32"):
    """NHWC x HWIO -> NHWC by ``torch.nn.functional.conv2d`` on the
    tensors' device, in x's dtype. The products are summed in ``acc_dtype``:
    on the CPU the operands are cast to it; on a card a bf16/f16 conv with
    an f32 ``acc_dtype`` runs in its own dtype, which cuDNN accumulates in
    f32."""
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    acc = _torch_dtype(acc_dtype)
    if x.device.type == "cuda" and acc == torch.float32 \
            and x.dtype in (torch.bfloat16, torch.float16):
        acc = x.dtype
    pads = _explicit_pads(h, wd, r, s, stride, padding)
    xi = _pad_nhwc(x.to(acc), pads).permute(0, 3, 1, 2)  # channels_last
    wi = w.to(acc).permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    y = TF.conv2d(xi, wi, stride=tuple(stride))
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _build_conv(n, h, w, c, r, s, k, stride, padding, acc_dtype):
    oh, ow = _out_hw(h, w, r, s, stride, padding)

    def fn(buffers, scalars=()):
        x, wgt, o = buffers
        o.view(n, oh, ow, k).copy_(conv2d_native(
            x.view(n, h, w, c), wgt.view(r, s, c, k), stride, padding,
            acc_dtype))

    return CompiledKernel(
        fn=fn, mutable_indices=[2],
        source=f"native conv2d {n}x{h}x{w}x{c} * {r}x{s}x{c}x{k} "
        f"stride={stride} pad={padding}", name="conv2d")


def conv2d(client, x: Handle, wgt: Handle,
           n: int, h: int, w: int, c: int, r: int, s: int, k: int,
           stride: Tuple[int, int] = (1, 1), padding: Pad = "SAME",
           acc_dtype: str = "float32") -> Handle:
    """NHWC x HWIO -> NHWC convolution (native path: cuDNN on a card)."""
    oh, ow = _out_hw(h, w, r, s, stride, padding)
    out = client.empty((n * oh * ow * k,), x.dtype)
    kid = KernelId.build("conv2d", n, h, w, c, r, s, k, stride,
                         str(padding), str(x.dtype), acc_dtype)
    task = NativeKernelTask(
        kid, lambda: _build_conv(n, h, w, c, r, s, k, stride, padding,
                                 acc_dtype), name="conv2d")
    client.launch(task, [x, wgt, out])
    return out


def im2col(x, r, s, stride=(1, 1), padding: Pad = "SAME"):
    """The (N·OH·OW, R·S·C) patch matrix of NHWC ``x``, columns in (R, S,
    C) order to match HWIO filters flattened to (R·S·C, K)."""
    n, h, w, c = x.shape
    oh, ow = _out_hw(h, w, r, s, stride, padding)
    xi = _pad_nhwc(x, _explicit_pads(h, w, r, s, stride, padding))
    cols = xi.unfold(1, r, stride[0]).unfold(2, s, stride[1])
    cols = cols[:, :oh, :ow]                     # (n, oh, ow, c, r, s)
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, r * s * c)


def conv2d_im2col(client, x: Handle, wgt: Handle,
                  n: int, h: int, w: int, c: int, r: int, s: int, k: int,
                  stride: Tuple[int, int] = (1, 1),
                  padding: Pad = "SAME") -> Handle:
    """Conv as im2col + the port's autotuned matmul (M1). Patch extraction
    runs as a native task; the FLOPs go through ``matmul_autotuned``. The
    GEMM dims must be multiples of 128; otherwise this falls back to
    ``conv2d``."""
    oh, ow = _out_hw(h, w, r, s, stride, padding)
    M, K = n * oh * ow, r * s * c
    if M % 128 or K % 128 or k % 128:
        return conv2d(client, x, wgt, n, h, w, c, r, s, k, stride, padding)

    def _build_im2col():
        def fn(buffers, scalars=()):
            xx, o = buffers
            o.view(M, K).copy_(im2col(xx.view(n, h, w, c), r, s, stride,
                                      padding))

        return CompiledKernel(fn=fn, mutable_indices=[1], source="im2col",
                              name="im2col")

    cols = client.empty((M * K,), x.dtype)
    kid = KernelId.build("im2col", n, h, w, c, r, s, stride, str(padding),
                         str(x.dtype))
    client.launch(NativeKernelTask(kid, _build_im2col, name="im2col"),
                  [x, cols])
    out = client.empty((M * k,), x.dtype)
    matmul_autotuned(client, cols, wgt, out, M, k, K)
    return out


_conv_tuner = LocalTuner("conv2d")


def _conv_key(n, h, w, c, r, s, k, stride, padding, dtype):
    return ("conv2d", anchor(n * h * w), c, r, s, k, tuple(stride),
            str(padding), dtype)


def conv2d_tunables(n: int, h: int, w: int, c: int, r: int, s: int, k: int,
                    stride: Tuple[int, int], padding: Pad,
                    dtype: torch.dtype, aligned: bool = True) -> TunableSet:
    """The candidates of one conv: "native" always; "im2col" where M, K
    and k are multiples of 128 and M1 takes x's dtype and has a tile for
    the GEMM; "pairs" for 3x3, stride 1, SAME, C and K <= 64, even W, and
    C1's dtypes on a 16-byte aligned input (``aligned``). "im2col" and
    "pairs" are offered only where those preconditions hold, and there are
    not prunable: a build or launch error of M1 or C1 raises instead of
    handing the call to cuDNN. The roofline work of every candidate is the
    convolution's: its operations, and x, the filters and the output each
    moved once in x's dtype."""
    oh, ow = _out_hw(h, w, r, s, stride, padding)
    M, K = n * oh * ow, r * s * c
    name = str(dtype).replace("torch.", "")
    elem = dtype.itemsize
    flops = 2 * M * K * k
    nbytes = (n * h * w * c + K * k + M * k) * elem

    def key_fn(client_, x_, w_):
        return _conv_key(n, h, w, c, r, s, k, stride, padding, name)

    def work(key):
        return flops, nbytes, name

    ts = TunableSet("conv2d", key_fn)
    ts.with_tunable(
        lambda cl, xx, ww: conv2d(cl, xx, ww, n, h, w, c, r, s, k,
                                  stride, padding),
        name="native", work=work)
    if M % 128 == 0 and K % 128 == 0 and k % 128 == 0 \
            and name in M1_IN_DTYPES and name in M1_OUT_DTYPES \
            and _tile_candidates(M, k, K, elem):
        ts.with_tunable(
            lambda cl, xx, ww: conv2d_im2col(cl, xx, ww, n, h, w, c, r, s,
                                             k, stride, padding),
            name="im2col", work=work, prunable=False)
    if (r, s) == (3, 3) and tuple(stride) == (1, 1) and padding == "SAME" \
            and c <= PAIR_CH and k <= PAIR_CH and w % 2 == 0 \
            and dtype in C1_DTYPES and aligned:
        ts.with_tunable(
            lambda cl, xx, ww: _conv_pairs_task(cl, xx, ww, n, h, w, c, k),
            name="pairs", work=work, prunable=False)
    return ts


def conv2d_autotuned(client, x: Handle, wgt: Handle,
                     n: int, h: int, w: int, c: int, r: int, s: int, k: int,
                     stride: Tuple[int, int] = (1, 1),
                     padding: Pad = "SAME") -> Handle:
    """Autotuned conv entry: the native conv against im2col through M1 and
    the small-channel kernel C1 (:func:`conv2d_tunables`), per anchored
    shape (the reference LocalTuner pattern over algorithm variants)."""
    ts = conv2d_tunables(n, h, w, c, r, s, k, stride, padding, x.dtype,
                         x.tensor.data_ptr() % 16 == 0)
    return _conv_tuner.execute(client, ts, client, x, wgt)


def conv2d_autotune_result(client, x: Handle, wgt: Handle,
                           n: int, h: int, w: int, c: int, r: int, s: int,
                           k: int, stride: Tuple[int, int] = (1, 1),
                           padding: Pad = "SAME"):
    """({candidate: seconds}, winner) that :func:`conv2d_autotuned` recorded
    for this call's shape in this process (the timings are empty when the
    winner came from the store), or None if it was never tuned here."""
    ts = conv2d_tunables(n, h, w, c, r, s, k, stride, padding, x.dtype,
                         x.tensor.data_ptr() % 16 == 0)
    key = ts.generate_key(client, x, wgt)
    tuner = _conv_tuner.tuner_for(client, key, ts)
    idx = tuner.cache.get(key) if tuner is not None else None
    if idx is None:
        return None
    return tuner.cache.timings(key), ts.tunables[idx].name


def _conv_pairs_task(client, x: Handle, wgt: Handle,
                     n: int, h: int, w: int, c: int, k: int) -> Handle:
    """conv2d_pairs as a NativeKernelTask (handle-level entry): C1 on a
    card, its plain version on the CPU client."""
    out = client.empty((n * h * w * k,), x.dtype)
    kid = KernelId.build("conv2d_pairs", n, h, w, c, k, str(x.dtype))

    def _build():
        def fn(buffers, scalars=()):
            xx, ww, o = buffers
            o.view(n, h, w, k).copy_(conv2d_pairs(xx.view(n, h, w, c),
                                                  ww.view(3, 3, c, k)))

        plan = c1_plan(x.dtype, n, h, w)
        return CompiledKernel(
            fn=fn, mutable_indices=[2],
            source=f"csrc/conv3x3.cu {n}x{h}x{w}x{c} -> {k}",
            name="conv2d_pairs", block=(plan.threads, 1, 1), grid=plan.grid,
            smem_bytes=plan.smem_bytes, smem_opt_in=True)

    client.launch(NativeKernelTask(kid, _build, name="conv2d_pairs"),
                  [x, wgt, out])
    return out


# ---------------------------------------------------------------------------
# 3. The small-channel 3x3 conv (C1)
# ---------------------------------------------------------------------------


def pack_pairs(x):
    """NHWC (C <= 64, W even) -> the pair layout (N, H·W/2, 128): channels
    zero-padded to 64, two pixels a row. In memory this is NHWC-64."""
    N, H, W, C = x.shape
    assert C <= PAIR_CH and W % 2 == 0, (tuple(x.shape),)
    if C < PAIR_CH:
        x = TF.pad(x, (0, PAIR_CH - C))
    return x.reshape(N, H * W // 2, 2 * PAIR_CH)


def unpack_pairs(xp, H, W, C):
    """Inverse of :func:`pack_pairs`."""
    N = xp.shape[0]
    return xp.reshape(N, H, W, PAIR_CH)[..., :C]


def _pad_weights(w, dtype):
    """(3, 3, C, K) -> (3, 3, 64, 64), zero-padded and rounded to
    ``dtype`` (the JAX kernel's ``w.astype(x.dtype)``), contiguous."""
    R, S, C, K = w.shape
    assert (R, S) == (3, 3), (tuple(w.shape),)
    assert C <= PAIR_CH and K <= PAIR_CH, "pair packing targets C,K <= 64"
    return TF.pad(w, (0, PAIR_CH - K, 0, PAIR_CH - C)).to(dtype).contiguous()


def conv2d_pairs_plain(x, w, cin: int = PAIR_CH):
    """C1's function in plain PyTorch: x (N, H, W, 64), w (3, 3, 64, 64) in
    x's dtype -> (N, H, W, 64) in x's dtype. Nine shifted (N, H, W, 64) x
    (64, 64) products over the zero-padded image, summed in f32; input
    channels from ``cin`` on are taken as zero."""
    N, H, W, _ = x.shape
    xf = x.float()
    if cin < PAIR_CH:
        xf = TF.pad(xf[..., :cin], (0, PAIR_CH - cin))
    xp = TF.pad(xf, (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros(N, H, W, PAIR_CH, dtype=torch.float32, device=x.device)
    with _full_f32():
        for dy in range(3):
            for dx in range(3):
                acc += torch.matmul(xp[:, dy:dy + H, dx:dx + W], wf[dy, dx])
    return acc.to(x.dtype)


def conv3x3(x, w, cin: int = PAIR_CH):
    """C1 on NHWC-64: x (N, H, W, 64) and w (3, 3, 64, 64) in x's dtype ->
    (N, H, W, 64). The kernel on CUDA tensors (f32 or bf16; anything else
    raises), :func:`conv2d_pairs_plain` on CPU tensors. C1 has no
    backward: under autograd this raises, on either device."""
    native.refuse_grad("conv3x3 (C1, under conv2d_pairs and "
                       "conv2d_pairs_packed)", "conv2d_pairs_plain or "
                       "F.conv2d", x, w)
    if x.dim() != 4 or x.shape[-1] != PAIR_CH \
            or tuple(w.shape) != (3, 3, PAIR_CH, PAIR_CH):
        raise ValueError(f"C1 takes x (N, H, W, 64) and w (3, 3, 64, 64); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    if not 0 < cin <= PAIR_CH:
        raise ValueError(f"C1: cin {cin} not in 1..64")
    if x.device.type == "cpu":
        return conv2d_pairs_plain(x, w, cin)
    if x.dtype not in C1_DTYPES or w.dtype != x.dtype \
            or w.device != x.device:
        raise ValueError(f"C1 takes x and w of one dtype of {C1_DTYPES} on "
                         f"one card; got {x.dtype} on {x.device}, {w.dtype} "
                         f"on {w.device}")
    x, w = x.contiguous(), w.contiguous()
    native.check_aligned(x, w)
    N, H, W, _ = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = native.kernels()
    with torch.cuda.device(x.device):
        # f32: the weights split into tf32 halves by the call's first kernel
        scratch = torch.empty(C1_F32_SCRATCH, device=x.device) \
            if x.dtype == torch.float32 else None
        rc = lib.cubecl_conv3x3(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                None if scratch is None
                                else scratch.data_ptr(),
                                native.DTYPE_CODES[x.dtype], N, H, W, cin,
                                torch.cuda.current_stream().cuda_stream)
    native.check(lib, rc, "conv2d_pairs_packed")
    if not torch.cuda.is_current_stream_capturing():
        conv2d_pairs_packed.launches += 1  # a graph's recording runs nothing
    return out


def c1_kernel_plan(dtype, n: int, h: int, w: int) -> C1Plan:
    """The built C1's launch plan for an (n, h, w) input of ``dtype``, from
    ``cubecl_conv3x3_plan``: what :func:`c1_plan` must equal (builds the
    CUDA kernels on first use)."""
    lib = native.kernels()
    plan = (ctypes.c_int * 7)()
    rc = lib.cubecl_conv3x3_plan(native.DTYPE_CODES[dtype], n, h, w,
                                 ctypes.cast(plan, ctypes.c_void_p))
    native.check(lib, rc, "conv3x3_plan")
    return C1Plan(plan[0], (plan[1], plan[2]), plan[3],
                  (plan[4], plan[5], plan[6]))


def conv2d_pairs(x, w):
    """3x3 / stride-1 / SAME conv for C, K <= 64 (NHWC convenience
    wrapper): pack, the packed conv, unpack. x (N, H, W, C), w (3, 3, C, K),
    W even; returns (N, H, W, K) in x's dtype. Layer stacks should keep the
    packed layout between layers (:func:`conv2d_pairs_packed`)."""
    N, H, W, C = x.shape
    R, S, Cw, K = w.shape
    assert Cw == C, (tuple(w.shape), tuple(x.shape))
    out = conv2d_pairs_packed(pack_pairs(x), w, H)
    return unpack_pairs(out, H, W, K)


def conv2d_pairs_packed(xp, w, H: int):
    """The packed-layout small-channel conv: xp (N, H·W/2, 128) from
    :func:`pack_pairs` (input channels C..63 are ignored), w (3, 3, C <= 64,
    K <= 64) -> (N, H·W/2, 128), each pixel's K output channels first and
    exact zeros after them. C1 on CUDA tensors, counted in
    ``conv2d_pairs_packed.launches``; the plain version on CPU tensors."""
    N, rows, lanes = xp.shape
    assert lanes == 2 * PAIR_CH and rows % H == 0, (tuple(xp.shape), H)
    C = w.shape[2]
    wd = _pad_weights(w, xp.dtype)
    W = 2 * rows // H
    x = xp.reshape(N, H, W, PAIR_CH)
    return conv3x3(x, wd, C).reshape(N, rows, lanes)


conv2d_pairs_packed.launches = 0
