"""Flash-attention forward: the attention of prefill.

``flash_attention`` takes the layout of ``cubecl_tpu.ops.attention``:
q (B, H, Sq, D), k and v (B, Hkv, Skv, D) with H a multiple of Hkv, and
returns o (B, H, Sq, D) in q's dtype. Query head h attends kv head
h // (H // Hkv), which is what the JAX models get from ``jnp.repeat`` of the
kv heads before their flash call.

On a CUDA tensor it launches the hand-written kernel of
``csrc/flash_attention.cu`` (f32 or bf16, D in {64, 128}), which replaces
the TPU kernels A1 ``_fwd_call``, A2 ``_fwd_call_tri`` and A8
``_fwd_call_packed``; anything the kernel does not take raises. On a CPU
tensor it runs ``flash_attention_plain``, the same function in plain
PyTorch, which is also the kernel's reference on the card.
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


def flash_attention_plain(q, k, v, causal: bool = True,
                          sm_scale: Optional[float] = None):
    """softmax(q k^T * sm_scale) v in f32 with the causal mask col <= row;
    materializes the (Sq, Skv) scores."""
    _check_shapes(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        live = torch.ones(sq, skv, dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~live, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None):
    """Flash-attention forward; see the module docstring."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale)
    _check_shapes(q, k, v)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}; the kernel wants one "
                         "CUDA device")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes one dtype of "
                         f"{KERNEL_DTYPES}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}; got {D}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    native.check_aligned(q, k, v)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = native.kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cubecl_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            native.DTYPE_CODES[q.dtype],
            B, H, Hkv, Sq, Skv, D, scale * LOG2E, int(causal), stream)
    native.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
