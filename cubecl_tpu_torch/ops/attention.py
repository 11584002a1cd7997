"""Flash attention, forward and backward: the attention of prefill and of
training.

``flash_attention`` takes the layout of ``cubecl_tpu.ops.attention``:
q (B, H, Sq, D), k and v (B, Hkv, Skv, D) with H a multiple of Hkv, and
returns o (B, H, Sq, D) in q's dtype. Query head h attends kv head
h // (H // Hkv), which is what the JAX models get from ``jnp.repeat`` of the
kv heads before their flash call.

It is differentiable: with grad mode on and an input that requires grad it
runs ``_FlashAttention``, the counterpart of the JAX package's
``jax.custom_vjp``. Its forward also keeps the base-2 log-sum-exp of each
row (lse, f32 (B, H, Sq)); its backward recomputes the probabilities from
(q, k, v, o, lse) and the upstream do, with di = rowsum(do * o) taken in
torch as the JAX ``_bwd`` takes it in jnp. Otherwise (serving, no_grad) the
forward runs alone and writes no lse.

On CUDA tensors every half is a hand-written kernel (f32 or bf16, D in
{64, 128, 256}; anything else raises, and the Function refuses to start a
pass whose backward is not built): the forward of
``csrc/flash_attention.cu``, which replaces the TPU kernels A1
``_fwd_call``, A2 ``_fwd_call_tri`` and A8 ``_fwd_call_packed``, and the
dK/dV and dQ kernels of ``csrc/flash_attention_bwd.cu``, which replace A3
``_bwd_dkv_call`` and A4 ``_bwd_dq_call``. The forward has two bodies: bf16
runs both products on the tensor cores (``wgmma`` fed by TMA copies) and
rounds the probabilities to bf16 for the P.V product, as the JAX forward
does; f32 runs them on the tensor cores too, each as three TF32 products
(``csrc/flash_tf32.cuh``: one TF32 product would not hold f32's exactness
against the plain version, three do). The backward kernels: bf16 on the
tensor cores, rounding p and dS to bf16 for their products as the JAX
kernels do (``round_p_ds`` of the plain versions gives that rounding); f32
dK/dV and dQ as three TF32 products each (dQ with its K/V steps staged by
cp.async). On CPU tensors the
same Function runs the plain PyTorch versions, ``flash_attention_plain`` and
``flash_attention_backward_plain``, which are also the kernels' references
on the card. Each wrapper counts its launches (``flash_attention.launches``
for the forward, ``flash_bwd_dkv.launches``, ``flash_bwd_dq.launches``).

``flash_attention_block_sparse`` attends over a block mask: q tile ``qi``
(of ``block_q`` rows) attends kv tile ``ki`` (of ``block_k``) where
``block_mask[qi, ki]``. ``build_block_schedule`` turns the mask into per-tile
lists of active tiles, which the kernels walk: ``bsp_forward`` (A5,
``_bsp_fwd_call``), ``bsp_dq`` (A6, ``_bsp_dq_call``) and ``bsp_dkv`` (A7,
``_bsp_dkv_call``, over the transposed schedule), the dense kernels' bodies
on the block-sparse schedules of ``csrc/flash_tiles.cuh``. Its
``_FlashBlockSparse`` is the counterpart of the JAX ``_flash_bsp``
custom_vjp; on CPU tensors it runs ``flash_attention_block_sparse_plain``
and ``flash_attention_block_sparse_backward_plain``. The kernels are built
at D 64, 128 and 256; the public function pads any D up to 256 with zeros
to them on both devices, outside the Function (past 256: ROADMAP Queue 2a
on the card, D as it is on the CPU). Causally masked scores
take the JAX kernels' finite ``DEFAULT_MASK_VALUE``, so a row whose every
visited column is masked (only with block_q != block_k) gets the mean of V
over those columns, as the JAX forward gives it; the backward is the true
gradient of that forward, which the JAX backward is not there (ROADMAP
Queue 3, F9).

The options of A1, A3 and A4 (``kv_len``: keys at or past it absent;
segment ids: a pair is live where its ids are equal; ``window`` (left,
right): row - left <= col <= row + right) and A8's window run the same
kernel bodies on the masked schedule of ``csrc/flash_tiles.cuh``
(``masked_forward``, ``masked_dkv``, ``masked_dq``, each counting its
launches), behind the JAX package's public functions without
``interpret``: ``flash_attention(..., kv_len=)``,
``flash_attention_padded`` (D padded with zeros to 64, 128 or 256, the
scale from the real D; D past 256 raises on the card), ``flash_attention_
segmented``, ``flash_attention_local`` and ``flash_attention_packed``
(A8: on this card A1's kernel at D 64, a smaller D padded to it; with
``window``). The last four take any D up to 256 as the padded one does,
forward and backward (past 256: ROADMAP Queue 2a).
All run ``_FlashAttention`` under autograd, the counterpart of the JAX
``_flash_seg``, ``_flash_local`` and ``_flash_packed`` custom_vjps; on
CPU tensors the plain versions with the options as one boolean mask. A
row with no live key gets zeros, an lse of 0 and no gradient (ROADMAP
Queue 3, F16: the JAX kernels give it a mean of V that depends on their
tiles). ``flash_for_head_dim`` picks the function for a model's head dim
as the JAX models do.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import numpy as np
import torch

from ..utils import native

LOG2E = math.log2(math.e)
# the head dims of the kernels' instances: A1's forward and A3/A4's
# backward (dense and masked) at 64, 128 and 256; the block-sparse ones
# (A5-A7) at the same three, a smaller D padded to them
KERNEL_HEAD_DIMS = (64, 128, 256)
SPARSE_HEAD_DIMS = (64, 128, 256)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, Sq, D) and k, v (B, Hkv, Skv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _causal_mask(q, k):
    """(Sq, Skv) bool, True where col <= row (absolute positions)."""
    return torch.ones(q.shape[2], k.shape[2], dtype=torch.bool,
                      device=q.device).tril()


def _live_mask(q, k, causal: bool, kv_len=None, seg=None, window=None):
    """The live (query, key) pairs as one boolean mask: (Sq, Skv), or
    (B, 1, Sq, Skv) with segment ids; None where every pair is live. The
    options of A1/A3/A4: ``causal`` col <= row (absolute positions);
    ``kv_len`` col < kv_len; ``seg`` = (ids_q (B, Sq), ids_kv (B, Skv)),
    equal ids; ``window`` = (left, right), row - left <= col <= row +
    right."""
    live = _causal_mask(q, k) if causal else None
    if kv_len is None and seg is None and window is None:
        return live
    rows = torch.arange(q.shape[2], device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    terms = [] if live is None else [live]
    if kv_len is not None:
        terms.append(cols < kv_len)
    if window is not None:
        left, right = window
        terms.append((rows - cols <= left) & (cols - rows <= right))
    if seg is not None:
        sq, sk = seg
        terms.append(sq[:, None, :, None] == sk[:, None, None, :])
    out = terms[0]
    for t in terms[1:]:
        out = out & t
    return out


def flash_attention_plain(q, k, v, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          return_lse: bool = False, kv_len=None, seg=None,
                          window=None):
    """softmax(q k^T * sm_scale) v in f32 with the causal mask col <= row;
    materializes the (Sq, Skv) scores. With ``return_lse`` also returns
    the base-2 log-sum-exp of each row's scaled scores, f32 (B, H, Sq), as
    the forward kernel writes it (0 for a row with nothing live).
    ``kv_len``, ``seg`` and ``window`` mask further, as ``_live_mask``
    says; a row with no live key then gets zeros and an lse of 0, as the
    kernels give it (ROADMAP Queue 3, F16)."""
    _check_shapes(q, k, v)
    scale = _scale(q, sm_scale)
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    live = _live_mask(q, k, causal, kv_len, seg, window)
    if live is not None:
        s = s.masked_fill(~live, float("-inf"))
    dead = None
    if kv_len is not None or seg is not None or window is not None:
        dead = ~live.any(-1, keepdim=True)  # F16's rows
        s = s.masked_fill(dead, 0.0)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, vf)
    if dead is not None:
        o = o.masked_fill(dead, 0.0)
    o = o.to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1) * LOG2E
    if dead is not None:
        lse = lse.masked_fill(dead[..., 0], 0.0)
    return o, lse.masked_fill(torch.isinf(lse), 0.0)


def _rounder(dtype, round_p_ds: bool):
    """t -> t through ``dtype`` (the storage dtype at which the JAX
    kernels feed p and dS to the matrix unit) when ``round_p_ds``; else
    the identity."""
    if not round_p_ds:
        return lambda t: t
    return lambda t: t.to(dtype).to(t.dtype)


def flash_attention_backward_plain(q, k, v, o, lse, do, causal: bool = True,
                                   sm_scale: Optional[float] = None,
                                   round_p_ds: bool = False, kv_len=None,
                                   seg=None, window=None):
    """(dq, dk, dv) of flash attention in plain PyTorch, from the forward's
    residuals (o, base-2 lse) and the upstream do: the math of the dK/dV
    and dQ kernels with the (Sq, Skv) probabilities materialized, each kv
    head's gradient summed over its query heads; cast to the inputs'
    dtypes. Computed in f32, or in the inputs' dtype where it is wider:
    float64 copies of f32 inputs give an exact reference where a kv head's
    gradient sums so many terms (H / Hkv x Sq: 32,768 at Qwen3-Next's G 8
    x S 4096) that f32's own rounding of the sums reaches f32's
    tolerance. ``round_p_ds`` rounds p and dS to the inputs' dtype before
    their products (dS from the unrounded p), as the JAX kernels A3/A4 and
    the bf16 kernels do; off, the reference is exact. ``kv_len``, ``seg``
    and ``window`` as in ``flash_attention_plain``: masked pairs get p =
    0, so F16's rows give nothing."""
    _check_shapes(q, k, v)
    scale = _scale(q, sm_scale)
    wide = torch.promote_types(q.dtype, torch.float32)
    rnd = _rounder(q.dtype, round_p_ds)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf, dof = q.to(wide), do.to(wide)
    kf = k.to(wide).repeat_interleave(rep, dim=1)
    vf = v.to(wide).repeat_interleave(rep, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
    p = torch.exp2(s - lse.to(wide)[..., None])
    live = _live_mask(q, k, causal, kv_len, seg, window)
    if live is not None:
        p = p.masked_fill(~live, 0.0)
    di = (dof * o.to(wide)).sum(-1, keepdim=True)
    dv = torch.matmul(rnd(p).transpose(-1, -2), dof)
    ds = rnd(p * (torch.matmul(dof, vf.transpose(-1, -2)) - di) * scale)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)

    def fold(t):  # query head h = hk * rep + g -> kv head hk
        return t.view(B, Hkv, rep, Skv, D).sum(2)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def _kernel_inputs(what, q, k, v, *more, head_dims=KERNEL_HEAD_DIMS):
    """Check what the kernels take; returns contiguous q, k, v, *more
    (``more``: tensors shaped as q; ``head_dims``: the kernel's)."""
    _check_shapes(q, k, v)
    if any(t.shape != q.shape for t in more):
        raise ValueError(f"{what}: want do shaped as q {tuple(q.shape)}; "
                         f"got {[tuple(t.shape) for t in more]}")
    tensors = (q, k, v) + more
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: tensors on "
                         f"{[str(t.device) for t in tensors]}; the kernel "
                         "wants one CUDA device")
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype
                                           for t in (k, v) + more):
        raise ValueError(f"{what} kernel takes one dtype of {KERNEL_DTYPES}; "
                         f"got {[t.dtype for t in tensors]}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{what} kernel takes head_dim in "
                         f"{head_dims}; got {q.shape[-1]}")
    tensors = tuple(t.contiguous() for t in tensors)
    native.check_aligned(*tensors)
    return tensors


def _stats(what, q, *stats):
    """lse / di: f32 (B, H, Sq) on q's device, contiguous."""
    for t in stats:
        if t.dtype != torch.float32 or t.shape != q.shape[:3] \
                or t.device != q.device:
            raise ValueError(f"{what}: lse and di must be f32 "
                             f"{tuple(q.shape[:3])} on {q.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return tuple(t.contiguous() for t in stats)


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _flash_forward(q, k, v, causal, sm_scale, need_lse):
    """The forward kernel (bf16: the tensor-core body; f32: the 3xTF32
    body): o and, with ``need_lse``, the base-2 lse."""
    q, k, v = _kernel_inputs("flash_attention", q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device) \
        if need_lse else None
    if o.numel() == 0:
        return o, lse
    lib = native.kernels()
    with torch.cuda.device(q.device):
        rc = lib.cubecl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if need_lse else None,
            native.DTYPE_CODES[q.dtype], B, H, Hkv, Sq, Skv, D,
            _scale(q, sm_scale) * LOG2E, int(causal), _stream(q))
    native.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, di, causal: bool = True,
                  sm_scale: Optional[float] = None):
    """dk, dv (B, Hkv, Skv, D) by the dK/dV kernel (A3), each kv head's
    gradient summed over its query heads; CUDA tensors only. bf16 runs the
    tensor-core body (p and dS rounded to bf16 for their products), f32
    the 3xTF32 one (two blocks a kv tile, dV's and dK's)."""
    q, k, v, do = _kernel_inputs("flash_bwd_dkv", q, k, v, do)
    lse, di = _stats("flash_bwd_dkv", q, lse, di)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    scale = _scale(q, sm_scale)
    lib = native.kernels()
    with torch.cuda.device(q.device):
        rc = lib.cubecl_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            native.DTYPE_CODES[q.dtype], B, H, Hkv, Sq, Skv, D, scale,
            scale * LOG2E, int(causal), _stream(q))
    native.check(lib, rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, causal: bool = True,
                 sm_scale: Optional[float] = None):
    """dq (B, H, Sq, D) by the dQ kernel (A4); CUDA tensors only. bf16 on
    the tensor cores (dS rounded to bf16 for dS K), f32 as three TF32
    products each (two 64-row q tiles a block at D 128, one at D 64 and
    256)."""
    q, k, v, do = _kernel_inputs("flash_bwd_dq", q, k, v, do)
    lse, di = _stats("flash_bwd_dq", q, lse, di)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    scale = _scale(q, sm_scale)
    lib = native.kernels()
    with torch.cuda.device(q.device):
        rc = lib.cubecl_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            native.DTYPE_CODES[q.dtype], B, H, Hkv, Sq, Skv, D, scale,
            scale * LOG2E, int(causal), _stream(q))
    native.check(lib, rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


class _Mask:
    """The options of one call of A1/A3/A4 (and A8's window) on q (B, H,
    Sq, D) and k (B, Hkv, Skv, D): ``kv_len`` (keys at or past it absent;
    None where it is None or >= Skv), ``window`` (left, right) and ``seg``
    (ids_q (B, Sq), ids_kv (B, Skv) int32 on q's device). ``of`` returns
    None where there is no option, so that the dense kernels run."""

    def __init__(self, kv_len, seg, window):
        self.kv_len, self.seg, self.window = kv_len, seg, window
        self._ranges = None

    @classmethod
    def of(cls, q, k, kv_len=None, seg=None, window=None):
        B, _, Sq, _ = q.shape
        Skv = k.shape[2]
        if kv_len is not None:
            kv_len = max(int(kv_len), 0)
            if kv_len >= Skv:
                kv_len = None
        if window is not None:
            left, right = (int(w) for w in window)
            if left < 0 or right < 0:
                raise ValueError(f"window {window}: want left, right >= 0")
            window = (left, right)
        if seg is not None:
            seg = tuple(torch.as_tensor(x, device=q.device)
                        .to(torch.int32).contiguous() for x in seg)
            if seg[0].shape != (B, Sq) or seg[1].shape != (B, Skv):
                raise ValueError(f"segment ids {tuple(seg[0].shape)}, "
                                 f"{tuple(seg[1].shape)}; want {(B, Sq)}, "
                                 f"{(B, Skv)}")
        if kv_len is None and seg is None and window is None:
            return None
        return cls(kv_len, seg, window)

    def plain(self) -> dict:
        """The keyword arguments of the plain versions."""
        return dict(kv_len=self.kv_len, seg=self.seg, window=self.window)

    def kernel_args(self, Sq: int, Skv: int) -> tuple:
        """(seg_q, seg_kv, ranges) pointers or None, then kv_len, left,
        right, as the masked entries of the kernel library take them (no
        band: Sq + Skv on each side)."""
        span = Sq + Skv
        left, right = self.window if self.window is not None \
            else (span, span)
        kv_len = Skv if self.kv_len is None else self.kv_len
        if self.seg is None:
            ptrs = (None, None, None)
        else:
            if self._ranges is None:
                (qlo, qhi), (klo, khi) = (_tile_ranges(ids)
                                          for ids in self.seg)
                self._ranges = torch.cat([t.reshape(-1) for t in (
                    qlo, qhi, klo, khi, _seg_walk(qlo, qhi, klo, khi),
                    _seg_walk(klo, khi, qlo, qhi))]).to(
                        torch.int32).contiguous()
            ptrs = (self.seg[0].data_ptr(), self.seg[1].data_ptr(),
                    self._ranges.data_ptr())
        return ptrs + (kv_len, min(left, span), min(right, span))


def _plain_opts(mask) -> dict:
    """The plain versions' keyword arguments of a ``_Mask`` or None."""
    return {} if mask is None else mask.plain()


def _tile_ranges(ids):
    """(lo, hi), each (B, ceil(S / 64)) int32: the least and greatest id of
    every 64-row kernel tile of ids (B, S), which the masked schedule's
    tile test compares (``csrc/flash_tiles.cuh::FlashMask``)."""
    B, S = ids.shape
    n = -(-S // 64)
    idx = torch.arange(n * 64, device=ids.device).clamp_(max=max(S - 1, 0))
    t = ids[:, idx].view(B, n, 64)
    return t.amin(-1), t.amax(-1)


def _seg_walk(lo, hi, lo_other, hi_other):
    """(B, ceil(n / 2), 2) int32: for every pair of 64-row tiles of one side
    (lo, hi: (B, n), their id ranges), the first and one past the last tile
    of the other side whose id range overlaps the pair's (an empty range
    where none does): the walk of a kernel block that owns the pair."""
    B, n = lo.shape
    idx = torch.arange(-(-n // 2) * 2, device=lo.device).clamp_(max=n - 1)
    plo = lo[:, idx].view(B, -1, 2).amin(-1)
    phi = hi[:, idx].view(B, -1, 2).amax(-1)
    ov = (plo[:, :, None] <= hi_other[:, None, :]) \
        & (phi[:, :, None] >= lo_other[:, None, :])
    m = ov.shape[-1]
    j = torch.arange(m, device=lo.device)
    first = torch.where(ov, j, m).amin(-1)
    last = torch.where(ov, j, -1).amax(-1) + 1
    return torch.stack([first, last], -1)


def _masked_call(what, entry, tensors, mask, q, k, *scalars):
    """One launch of a masked entry: its tensors (inputs, then outputs;
    None for no lse), the mask's pointers, the shapes, ``scalars`` (the
    scales and causal) and the mask's kv_len, left and right."""
    lib = native.kernels()
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    opts = mask.kernel_args(Sq, Skv)
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(
            *(t.data_ptr() if t is not None else None for t in tensors),
            *opts[:3], native.DTYPE_CODES[q.dtype], B, H, Hkv, Sq, Skv, D,
            *scalars, *opts[3:], _stream(q))
    native.check(lib, rc, what)


def masked_forward(q, k, v, mask: _Mask, causal, sm_scale, need_lse):
    """A1 with its options (kv_len, segment ids, a window) on CUDA tensors:
    the forward's bodies on the masked schedule of ``csrc/flash_tiles.cuh``
    (bf16 on the tensor cores, f32 as three TF32 products); o and, with
    ``need_lse``, the base-2 lse."""
    q, k, v = _kernel_inputs("flash_attention (options)", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if need_lse else None
    if o.numel() == 0:
        return o, lse
    _masked_call("flash_attention (options)", "cubecl_flash_masked_fwd",
                 [q, k, v, o, lse], mask, q, k,
                 _scale(q, sm_scale) * LOG2E, int(causal))
    masked_forward.launches += 1
    return o, lse


def masked_dkv(q, k, v, do, lse, di, mask: _Mask, causal, sm_scale):
    """A3 with its options on CUDA tensors: dk, dv over the transposed
    band (kv rows past kv_len get zeros)."""
    q, k, v, do = _kernel_inputs("masked_dkv", q, k, v, do)
    lse, di = _stats("masked_dkv", q, lse, di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    scale = _scale(q, sm_scale)
    _masked_call("masked_dkv", "cubecl_flash_masked_dkv",
                 [q, k, v, do, lse, di, dk, dv], mask, q, k, scale,
                 scale * LOG2E, int(causal))
    masked_dkv.launches += 1
    return dk, dv


def masked_dq(q, k, v, do, lse, di, mask: _Mask, causal, sm_scale):
    """A4 with its options on CUDA tensors: dq over the band."""
    q, k, v, do = _kernel_inputs("masked_dq", q, k, v, do)
    lse, di = _stats("masked_dq", q, lse, di)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    scale = _scale(q, sm_scale)
    _masked_call("masked_dq", "cubecl_flash_masked_dq",
                 [q, k, v, do, lse, di, dq], mask, q, k, scale,
                 scale * LOG2E, int(causal))
    masked_dq.launches += 1
    return dq


masked_forward.launches = 0
masked_dkv.launches = 0
masked_dq.launches = 0


def _forward(q, k, v, causal, sm_scale, need_lse, mask):
    """The forward kernel with or without options (CUDA tensors)."""
    if mask is None:
        return _flash_forward(q, k, v, causal, sm_scale, need_lse)
    return masked_forward(q, k, v, mask, causal, sm_scale, need_lse)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``flash_attention`` custom_vjp (``_fwd`` /
    ``_bwd``) and, with a ``_Mask``, of ``_flash_seg``, ``_flash_local``
    and ``_flash_packed`` (and ``flash_attention``'s with ``kv_len``): the
    kernels on CUDA tensors (the dense ones without options, the masked
    ones with), the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, mask):
        D = q.shape[-1]
        if q.device.type != "cpu" and D not in KERNEL_HEAD_DIMS:
            # refused here, before the forward runs, rather than in the
            # backward's launch
            raise NotImplementedError(
                f"flash attention's backward (A3/A4) at head dim {D} is not "
                f"ported to the card (built at {KERNEL_HEAD_DIMS}; ROADMAP "
                "Queue 2a)")
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, causal, sm_scale,
                                           return_lse=True,
                                           **_plain_opts(mask))
        else:
            o, lse = _forward(q, k, v, causal, sm_scale, True, mask)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale, ctx.mask = causal, sm_scale, mask
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, mask = ctx.causal, ctx.sm_scale, ctx.mask
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, o, lse, do, causal, sm_scale, **_plain_opts(mask))
        else:
            # rowsum(dO * O) from o in its own dtype, as the JAX _bwd
            di = (do.float() * o.float()).sum(-1)
            if mask is None:
                dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, causal,
                                       sm_scale)
                dq = flash_bwd_dq(q, k, v, do, lse, di, causal, sm_scale)
            else:
                dk, dv = masked_dkv(q, k, v, do, lse, di, mask, causal,
                                    sm_scale)
                dq = masked_dq(q, k, v, do, lse, di, mask, causal, sm_scale)
        return dq, dk, dv, None, None, None


def _attend(q, k, v, causal, sm_scale, mask):
    """Flash attention with the options of ``mask`` (or none): the Function
    under autograd, else the forward alone (no lse)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, sm_scale, mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale,
                                     **_plain_opts(mask))
    return _forward(q, k, v, causal, sm_scale, False, mask)[0]


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    kv_len: Optional[int] = None):
    """Flash attention; see the module docstring. The JAX signature without
    ``interpret``: ``block_q`` and ``block_k`` are accepted and fix nothing
    (the kernels tile at 64 rows); ``kv_len`` masks the keys at or past it
    (A1's padded keys), through the masked kernels where it is < Skv."""
    return _attend(q, k, v, causal, sm_scale, _Mask.of(q, k, kv_len=kv_len))


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# The options' public functions: padded, segmented, local, packed
# ---------------------------------------------------------------------------


def _padded_attend(q, k, v, causal, scale, mask):
    """``_attend`` at any head dim up to 256: D is padded with zeros to 64,
    128 or 256 (zero columns of q and k leave the scores as they are; those
    of v are sliced off), the scale fixed from the real D by the caller, as
    the JAX ``flash_attention_padded`` pads D in (128, 256] to 256. A D past
    256 runs unpadded on the CPU and raises on the card."""
    D = q.shape[-1]
    Dp = next((d for d in KERNEL_HEAD_DIMS if D <= d), D)
    if Dp == D:
        if D > KERNEL_HEAD_DIMS[-1] and q.device.type != "cpu":
            raise NotImplementedError(
                f"flash attention at head dim {D} > 256 is not ported to the "
                "card (ROADMAP Queue 2a)")
        return _attend(q, k, v, causal, scale, mask)
    pad = (0, Dp - D)
    o = _attend(torch.nn.functional.pad(q, pad),
                torch.nn.functional.pad(k, pad),
                torch.nn.functional.pad(v, pad), causal, scale, mask)
    return o[..., :D]


def flash_attention_padded(q, k, v, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           block_q: int = 1024, block_k: int = 2048):
    """flash_attention at any sequence length and head dim up to 256 (the
    JAX signature without ``interpret``; the blocks fix nothing): D is
    padded to 64, 128 or 256, the scale taken from the real D. Unlike the JAX
    function, S is not padded: the kernels mask a ragged tail themselves.
    Differentiable (the pad and the slice through autograd)."""
    _check_shapes(q, k, v)
    return _padded_attend(q, k, v, causal, _scale(q, sm_scale), None)


def flash_attention_segmented(q, k, v, segment_ids_q, segment_ids_kv=None,
                              causal: bool = True,
                              sm_scale: Optional[float] = None,
                              block_q: int = 1024, block_k: int = 1024):
    """Packed-sequence flash attention: a query attends only keys of its own
    segment id (and, ``causal``, col <= row). segment_ids: (B, S) int,
    numpy or torch; a reserved id (e.g. -1) for padding slots. Tiles whose
    rows' and columns' id ranges do not overlap are skipped whole; a row
    with no live key gets zeros (F16). Differentiable. D up to 256, as
    ``flash_attention_padded``."""
    _check_shapes(q, k, v)
    if segment_ids_kv is None:
        segment_ids_kv = segment_ids_q
    mask = _Mask.of(q, k, seg=(segment_ids_q, segment_ids_kv))
    return _padded_attend(q, k, v, causal, _scale(q, sm_scale), mask)


def flash_attention_local(q, k, v, left: int, right: int = 0,
                          causal: bool = True,
                          sm_scale: Optional[float] = None,
                          block_q: int = 1024, block_k: int = 1024):
    """Sliding-window flash attention: position i attends keys j with
    i - left <= j <= i + right (Mistral's local attention when ``causal``
    and ``right == 0``). The kernels walk only the band's tiles, so the
    cost scales with S * (left + right + 64). Differentiable. D up to 256,
    as ``flash_attention_padded``."""
    _check_shapes(q, k, v)
    if left < 0 or right < 0:
        raise ValueError(f"left {left}, right {right}: want both >= 0")
    mask = _Mask.of(q, k, window=(left, right))
    return _padded_attend(q, k, v, causal, _scale(q, sm_scale), mask)


def flash_for_head_dim(head_dim: int, n_heads: int):
    """The flash function the JAX models pick for a head dim
    (``cubecl_tpu/models/llama.py:163-184``,
    ``cubecl_tpu/models/transformer.py:192-214``): the exact kernel at 64
    and multiples of 128, the packed function where ``128 // head_dim``
    heads fill a TPU's lanes (32 with heads a multiple of 4), the padded one
    otherwise. By head dim only: the port pads no sequence."""
    if head_dim == 64 or head_dim % 128 == 0:
        return flash_attention
    if 128 % head_dim == 0 and n_heads % (128 // head_dim) == 0:
        return flash_attention_packed
    return flash_attention_padded


def flash_attention_packed(q, k, v, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           block_q: int = 1024, block_k: int = 1024,
                           window=None):
    """The JAX ``flash_attention_packed`` (A8, head dims 32 and 64 packed on
    a TPU's 128 lanes), with an optional ``window`` (left, right). On this
    card A8 is A1's kernel: D 64 runs it as it is, a smaller D padded to 64
    (D 32 does twice the work; no instantiation of its own yet). The JAX
    function drops ``window`` where it falls back to flash_attention (D a
    multiple of 128, or H not a multiple of 128 // D); here the window
    always holds. Differentiable."""
    _check_shapes(q, k, v)
    mask = _Mask.of(q, k, window=window)
    return _padded_attend(q, k, v, causal, _scale(q, sm_scale), mask)


# ---------------------------------------------------------------------------
# Block-sparse attention (A5, A6, A7)
# ---------------------------------------------------------------------------

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
MIN_BLOCK = 128  # the JAX package's lane tile, which _fit_block prefers


def _fit_block(block: int, s: int) -> int:
    """Largest divisor of ``s`` not exceeding ``block``, preferring
    multiples of 128 (``cubecl_tpu/ops/attention.py:41``): it fixes the
    tile grid, and so the shape of the block mask a caller passes. The
    kernels tile at 64 rows whatever it returns."""
    b = min(block, s)
    if s % b == 0:
        return b
    best = 1
    best_tile = 0
    for d in range(1, int(math.isqrt(s)) + 1):
        if s % d == 0:
            for cand in (d, s // d):
                if cand <= b:
                    if cand % MIN_BLOCK == 0:
                        best_tile = max(best_tile, cand)
                    best = max(best, cand)
    return best_tile or best


def build_block_schedule(block_mask, allow_empty: bool = False) -> tuple:
    """(kv_ids, counts) of a (n_q, n_kv) block mask, int32 numpy arrays:
    per q tile its active kv tiles in order, padded by repeating the last,
    and how many there are. ``allow_empty`` admits rows with none (ids
    0, count 0): the transposed schedule of the backward has kv tiles no q
    tile attends."""
    bm = np.asarray(block_mask, bool)
    n_q, n_kv = bm.shape
    counts = bm.sum(1).astype(np.int32)
    if not allow_empty:
        assert counts.min() > 0, "every q tile must attend >= 1 kv tile"
    max_active = max(int(counts.max()), 1)
    kv_ids = np.zeros((n_q, max_active), np.int32)
    for qi in range(n_q):
        ids = np.nonzero(bm[qi])[0]
        if len(ids) == 0:
            continue
        kv_ids[qi, :len(ids)] = ids
        kv_ids[qi, len(ids):] = ids[-1]
    return kv_ids, counts


def _pruned_mask(block_mask, causal, bq, bk, n_q, n_kv) -> np.ndarray:
    """The caller's mask, checked against the tile grid, with the tiles
    wholly above the diagonal dropped when causal."""
    bm = np.asarray(block_mask, bool)
    assert bm.shape == (n_q, n_kv), \
        f"block_mask {bm.shape} != tile grid {(n_q, n_kv)} for blocks " \
        f"({bq},{bk})"
    if causal:
        qr = np.arange(n_q)[:, None]
        kr = np.arange(n_kv)[None, :]
        bm = bm & (kr * bk <= qr * bq + bq - 1)
    assert bm.sum(1).min() > 0, "every q tile must attend >= 1 kv tile"
    return bm


class _Schedule:
    """The forward schedule of a pruned mask and its transpose, on one
    device (int32)."""

    def __init__(self, bm: np.ndarray, device):
        ids, counts = build_block_schedule(bm)
        t_ids, t_counts = build_block_schedule(bm.T, allow_empty=True)
        self.bm = bm
        self.ids = torch.from_numpy(ids).to(device)
        self.counts = torch.from_numpy(counts).to(device)
        self.t_ids = torch.from_numpy(t_ids).to(device)
        self.t_counts = torch.from_numpy(t_counts).to(device)


_SCHEDULES: "collections.OrderedDict" = collections.OrderedDict()
_MAX_SCHEDULES = 64


def _schedule(bm: np.ndarray, bq: int, bk: int, device) -> _Schedule:
    """The schedule of a pruned mask, built and copied to ``device`` once
    per (mask, bq, bk, device): a training loop calls with the same mask
    every step (the 64 latest are kept)."""
    key = (bm.shape, np.packbits(bm).tobytes(), bq, bk, str(device))
    hit = _SCHEDULES.get(key)
    if hit is None:
        hit = _SCHEDULES[key] = _Schedule(bm, device)
        if len(_SCHEDULES) > _MAX_SCHEDULES:
            _SCHEDULES.popitem(last=False)
    else:
        _SCHEDULES.move_to_end(key)
    return hit


def _bsp_shapes(q, k, v):
    _check_shapes(q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"block-sparse attention takes as many k/v heads "
                         f"as q heads (the JAX kernel's layout); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")


def _tile_columns(ids, b: int, device) -> torch.Tensor:
    """The positions of the tiles ``ids`` (of ``b`` rows each), in order."""
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)
    return (ids[:, None] * b + torch.arange(b, device=device)).reshape(-1)


def _bsp_tile_scores(q, k, bm, qi, causal, scale, bq, bk):
    """For q tile ``qi``: its active kv tiles' columns, the base-2 scaled
    f32 scores of its rows against them (B, H, bq, n) with causally masked
    ones at DEFAULT_MASK_VALUE, and the live mask (bq, n)."""
    cols = _tile_columns(np.nonzero(bm[qi])[0], bk, q.device)
    rows = torch.arange(qi * bq, (qi + 1) * bq, device=q.device)
    s = torch.matmul(q[:, :, qi * bq:(qi + 1) * bq].float(),
                     k[:, :, cols].float().transpose(-1, -2)) \
        * (scale * LOG2E)
    live = (cols[None, :] <= rows[:, None]) if causal else \
        torch.ones(bq, len(cols), dtype=torch.bool, device=q.device)
    return cols, torch.where(live, s, DEFAULT_MASK_VALUE), live


def flash_attention_block_sparse_plain(q, k, v, block_mask,
                                       causal: bool = True,
                                       sm_scale: Optional[float] = None,
                                       block_q: int = 512,
                                       block_k: int = 512,
                                       return_lse: bool = False):
    """The block-sparse forward in plain PyTorch, one q tile at a time
    against its active kv tiles, in f32 (no (S, S) scores): the softmax of
    the base-2 scores with causally masked ones at DEFAULT_MASK_VALUE, so a
    row with no live column gets the mean of V over its visited columns
    (F9), as the JAX kernel. Differentiable by autograd. With
    ``return_lse`` also the base-2 log-sum-exp of each row, f32 (B, H, S)."""
    _bsp_shapes(q, k, v)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    bq, bk = _fit_block(block_q, Sq), _fit_block(block_k, Skv)
    bm = _pruned_mask(block_mask, causal, bq, bk, Sq // bq, Skv // bk)
    scale = _scale(q, sm_scale)
    outs, lses = [], []
    for qi in range(Sq // bq):
        cols, s, _ = _bsp_tile_scores(q, k, bm, qi, causal, scale, bq, bk)
        m = s.amax(-1, keepdim=True).detach()
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        outs.append(torch.matmul(p, v[:, :, cols].float()) / l)
        lses.append((m + torch.log2(l))[..., 0])
    o = torch.cat(outs, 2).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.cat(lses, 2)


def flash_attention_block_sparse_backward_plain(
        q, k, v, o, lse, do, block_mask, causal: bool = True,
        sm_scale: Optional[float] = None, block_q: int = 512,
        block_k: int = 512, round_p_ds: bool = False):
    """(dq, dk, dv) of the block-sparse forward in plain PyTorch, from its
    residuals (o, base-2 lse) and do, one q tile at a time, f32: the math
    of A6 and A7 (p = exp2(s - lse) on live entries, dS = p (dP - di)
    sm_scale), and for a row with no live column (F9) the true gradient of
    the forward's mean: 1/n of its dO to each of its n visited columns of
    dV, nothing to dQ or dK. Cast to the inputs' dtypes. ``round_p_ds`` as
    in ``flash_attention_backward_plain`` (the JAX kernels A6/A7)."""
    _bsp_shapes(q, k, v)
    rnd = _rounder(q.dtype, round_p_ds)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    bq, bk = _fit_block(block_q, Sq), _fit_block(block_k, Skv)
    bm = _pruned_mask(block_mask, causal, bq, bk, Sq // bq, Skv // bk)
    scale = _scale(q, sm_scale)
    dof = do.float()
    di = (dof * o.float()).sum(-1, keepdim=True)
    dq = torch.zeros(B, H, Sq, D, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, H, Skv, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for qi in range(Sq // bq):
        sl = slice(qi * bq, (qi + 1) * bq)
        cols, s, live = _bsp_tile_scores(q, k, bm, qi, causal, scale, bq, bk)
        p = torch.where(live, torch.exp2(s - lse[:, :, sl, None].float()),
                        0.0)
        dead = ~live.any(-1, keepdim=True)  # F9 rows: the mean of V
        p_v = torch.where(dead, 1.0 / len(cols), p)
        dp = torch.matmul(dof[:, :, sl], v[:, :, cols].float()
                          .transpose(-1, -2))
        ds = rnd(p * (dp - di[:, :, sl]) * scale)
        dq[:, :, sl] = torch.matmul(ds, k[:, :, cols].float())
        dk.index_add_(2, cols, torch.matmul(ds.transpose(-1, -2),
                                            q[:, :, sl].float()))
        dv.index_add_(2, cols, torch.matmul(rnd(p_v).transpose(-1, -2),
                                            dof[:, :, sl]))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bsp_unported(what, D):
    return NotImplementedError(
        f"{what}: block-sparse flash attention (A5-A7) at head dim {D} is "
        f"not ported to the card (built at {SPARSE_HEAD_DIMS}, a smaller D "
        f"padded to them; ROADMAP Queue 2a)")


def _bsp_head_dim(D, device) -> int:
    """The head dim the block-sparse kernels run a real D at: the next of
    SPARSE_HEAD_DIMS. Past 256 the plain versions run D as it is on the
    CPU, and the card raises (ROADMAP Queue 2a)."""
    Dp = next((d for d in SPARSE_HEAD_DIMS if D <= d), D)
    if Dp == D and D not in SPARSE_HEAD_DIMS and device.type != "cpu":
        raise _bsp_unported("flash_attention_block_sparse", D)
    return Dp


def _bsp_inputs(what, q, k, v, *more):
    """The wrappers take the built head dims only (the public function pads
    a smaller D to them); past 256 they raise, naming ROADMAP Queue 2a."""
    _bsp_shapes(q, k, v)
    if q.shape[-1] > SPARSE_HEAD_DIMS[-1]:
        raise _bsp_unported(what, q.shape[-1])
    return _kernel_inputs(what, q, k, v, *more, head_dims=SPARSE_HEAD_DIMS)


def bsp_forward(q, k, v, sched: _Schedule, causal, scale, bq, bk,
                need_lse: bool):
    """A5 on CUDA tensors (the forward's bodies on the block-sparse
    schedule, bf16 on the tensor cores): o and, with ``need_lse``, the
    base-2 lse."""
    q, k, v = _bsp_inputs("flash_attention_block_sparse", q, k, v)
    B, H, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device) \
        if need_lse else None
    if o.numel() == 0:
        return o, lse
    lib = native.kernels()
    with torch.cuda.device(q.device):
        rc = lib.cubecl_flash_bsp_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if need_lse else None, sched.ids.data_ptr(),
            sched.counts.data_ptr(), sched.ids.shape[1], bq, bk,
            native.DTYPE_CODES[q.dtype], B, H, Sq, k.shape[2], D,
            scale * LOG2E, int(causal), _stream(q))
    native.check(lib, rc, "flash_attention_block_sparse")
    bsp_forward.launches += 1
    return o, lse


def bsp_dq(q, k, v, do, lse, di, sched: _Schedule, causal, scale, bq, bk):
    """A6 on CUDA tensors: dq over the forward schedule (A4's bodies)."""
    q, k, v, do = _bsp_inputs("bsp_dq", q, k, v, do)
    lse, di = _stats("bsp_dq", q, lse, di)
    B, H, Sq, D = q.shape
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    lib = native.kernels()
    with torch.cuda.device(q.device):
        rc = lib.cubecl_flash_bsp_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            sched.ids.data_ptr(), sched.counts.data_ptr(),
            sched.ids.shape[1], bq, bk, native.DTYPE_CODES[q.dtype], B, H,
            Sq, k.shape[2], D, scale, scale * LOG2E, int(causal), _stream(q))
    native.check(lib, rc, "bsp_dq")
    bsp_dq.launches += 1
    return dq


def bsp_dkv(q, k, v, do, lse, di, sched: _Schedule, causal, scale, bq, bk):
    """A7 on CUDA tensors: dk, dv over the transposed schedule (A3's
    bodies; a kv tile no q tile attends gets zeros)."""
    q, k, v, do = _bsp_inputs("bsp_dkv", q, k, v, do)
    lse, di = _stats("bsp_dkv", q, lse, di)
    B, H, Sq, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    lib = native.kernels()
    with torch.cuda.device(q.device):
        rc = lib.cubecl_flash_bsp_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            sched.t_ids.data_ptr(), sched.t_counts.data_ptr(),
            sched.t_ids.shape[1], sched.ids.data_ptr(),
            sched.counts.data_ptr(), sched.ids.shape[1], bq, bk,
            native.DTYPE_CODES[q.dtype], B, H, Sq, k.shape[2], D, scale,
            scale * LOG2E, int(causal), _stream(q))
    native.check(lib, rc, "bsp_dkv")
    bsp_dkv.launches += 1
    return dk, dv


bsp_forward.launches = 0
bsp_dq.launches = 0
bsp_dkv.launches = 0


class _FlashBlockSparse(torch.autograd.Function):
    """Counterpart of the JAX ``_flash_bsp`` custom_vjp: A5 forward with
    lse, A6 and A7 backward on CUDA tensors; the plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bm, causal, scale, bq, bk):
        if q.device.type == "cpu":
            o, lse = flash_attention_block_sparse_plain(
                q, k, v, bm, causal, scale, bq, bk, return_lse=True)
        else:
            o, lse = bsp_forward(q, k, v, _schedule(bm, bq, bk, q.device),
                                 causal, scale, bq, bk, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (bm, causal, scale, bq, bk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bm, causal, scale, bq, bk = ctx.args
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_block_sparse_backward_plain(
                q, k, v, o, lse, do, bm, causal, scale, bq, bk)
        else:
            sched = _schedule(bm, bq, bk, q.device)
            # rowsum(dO * O) in f32 from o in its own dtype, as the JAX _bwd
            di = (do.float() * o.float()).sum(-1)
            dq = bsp_dq(q, k, v, do, lse, di, sched, causal, scale, bq, bk)
            dk, dv = bsp_dkv(q, k, v, do, lse, di, sched, causal, scale, bq,
                             bk)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_block_sparse(q, k, v, block_mask, causal: bool = True,
                                 sm_scale: Optional[float] = None,
                                 block_q: int = 512, block_k: int = 512):
    """Flash attention over a block mask (the JAX signature without
    ``interpret``): ``block_mask[qi, ki]`` says whether q tile ``qi``
    attends kv tile ``ki``, for tiles of ``_fit_block(block_q, Sq)`` and
    ``_fit_block(block_k, Skv)`` rows; ``causal`` adds the in-tile causal
    mask at absolute positions, and tiles wholly above the diagonal are
    pruned. q, k, v (B, H, S, D) with as many k/v heads as q heads. Cost
    and gradients scale with the mask's live tiles. Any D up to 256, on
    either device: D is padded with zeros to 64, 128 or 256 (the kernels'
    head dims; zero columns of q and k leave the scores as they are, those
    of v are sliced off, so F9's rows keep their mean of V), the scale
    taken from the real D, the pad and the slice outside the autograd
    Function so that they carry the gradient. Past 256 the CPU runs D
    unpadded and the card raises (ROADMAP Queue 2a). See the module
    docstring for the kernels and F9."""
    _bsp_shapes(q, k, v)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    bq, bk = _fit_block(block_q, Sq), _fit_block(block_k, Skv)
    bm = _pruned_mask(block_mask, causal, bq, bk, Sq // bq, Skv // bk)
    scale = _scale(q, sm_scale)
    Dp = _bsp_head_dim(D, q.device)
    if Dp != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = _FlashBlockSparse.apply(q, k, v, bm, causal, scale, bq, bk)
    elif q.device.type == "cpu":
        o = flash_attention_block_sparse_plain(q, k, v, bm, causal, scale,
                                               bq, bk)
    else:
        o = bsp_forward(q, k, v, _schedule(bm, bq, bk, q.device), causal,
                        scale, bq, bk, False)[0]
    return o if Dp == D else o[..., :D]
