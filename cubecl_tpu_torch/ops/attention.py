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
{64, 128}; anything else raises): the forward of
``csrc/flash_attention.cu``, which replaces the TPU kernels A1
``_fwd_call``, A2 ``_fwd_call_tri`` and A8 ``_fwd_call_packed``, and the
dK/dV and dQ kernels of ``csrc/flash_attention_bwd.cu``, which replace A3
``_bwd_dkv_call`` and A4 ``_bwd_dq_call``. On CPU tensors the same Function
runs the plain PyTorch versions, ``flash_attention_plain`` and
``flash_attention_backward_plain``, which are also the kernels' references
on the card. Each wrapper counts its launches (``flash_attention.launches``
for the forward, ``flash_bwd_dkv.launches``, ``flash_bwd_dq.launches``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils import native

LOG2E = math.log2(math.e)
KERNEL_HEAD_DIMS = (64, 128)
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


def flash_attention_plain(q, k, v, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          return_lse: bool = False):
    """softmax(q k^T * sm_scale) v in f32 with the causal mask col <= row;
    materializes the (Sq, Skv) scores. With ``return_lse`` also returns
    the base-2 log-sum-exp of each row's scaled scores, f32 (B, H, Sq), as
    the forward kernel writes it (0 for a row with nothing live)."""
    _check_shapes(q, k, v)
    scale = _scale(q, sm_scale)
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q, k), float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, vf).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1) * LOG2E
    return o, lse.masked_fill(torch.isinf(lse), 0.0)


def flash_attention_backward_plain(q, k, v, o, lse, do, causal: bool = True,
                                   sm_scale: Optional[float] = None):
    """(dq, dk, dv) of flash attention in plain PyTorch, from the forward's
    residuals (o, base-2 lse) and the upstream do: the math of the dK/dV
    and dQ kernels with the (Sq, Skv) probabilities materialized, f32
    throughout, each kv head's gradient summed over its query heads; cast
    to the inputs' dtypes."""
    _check_shapes(q, k, v)
    scale = _scale(q, sm_scale)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
    p = torch.exp2(s - lse.float()[..., None])
    if causal:
        p = p.masked_fill(~_causal_mask(q, k), 0.0)
    di = (dof * o.float()).sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - di) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)

    def fold(t):  # query head h = hk * rep + g -> kv head hk
        return t.view(B, Hkv, rep, Skv, D).sum(2)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def _kernel_inputs(what, q, k, v, *more):
    """Check what the kernels take; returns contiguous q, k, v, *more
    (``more``: tensors shaped as q)."""
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
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}; got {q.shape[-1]}")
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
    """The forward kernel: o and, with ``need_lse``, the base-2 lse."""
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
    gradient summed over its query heads; CUDA tensors only."""
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
    """dq (B, H, Sq, D) by the dQ kernel (A4); CUDA tensors only."""
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


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``flash_attention`` custom_vjp (``_fwd`` /
    ``_bwd``): the kernels on CUDA tensors, the plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, causal, sm_scale,
                                           return_lse=True)
        else:
            o, lse = _flash_forward(q, k, v, causal, sm_scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale = ctx.causal, ctx.sm_scale
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, o, lse, do, causal, sm_scale)
        else:
            # rowsum(dO * O) from o in its own dtype, as the JAX _bwd
            di = (do.float() * o.float()).sum(-1)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, causal, sm_scale)
            dq = flash_bwd_dq(q, k, v, do, lse, di, causal, sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None):
    """Flash attention; see the module docstring."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale)
    return _flash_forward(q, k, v, causal, sm_scale, False)[0]


flash_attention.launches = 0
