"""Paged-KV decode attention: the attention of each decode step.

The KV cache is a stacked whole-model pool ``(L, Hkv, P, page, D)``; each
sequence owns a row of the block table ``page_indices`` (B, max_pages)
int32, which maps its position t to slot ``t % page`` of page
``page_indices[b, t // page]``. ``paged_attention`` attends one query per
head, q (B, H, D), to positions ``< lengths[b]`` of layer ``layer`` and
returns (B, H, D) in q's dtype; a row of length 0 gets zeros. Query head h
reads kv head h // (H // Hkv).

On a CUDA tensor it launches the hand-written kernel of
``csrc/paged_attention.cu`` (f32 or bf16, D in {64, 128}, at most 8 query
heads per kv head), which replaces the TPU kernels P1
``_paged_call_headed`` and P2 ``_paged_call_live``; anything the kernel
does not take raises. The caller keeps the table's entries below P and
``lengths`` within ``max_pages * page``: the kernel reads them on the device
and does not check them. On a CPU tensor it runs ``paged_attention_plain``,
which is also the kernel's reference on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils import native
from .attention import KERNEL_DTYPES, KERNEL_HEAD_DIMS, LOG2E

MAX_GROUP = 8  # query heads per kv head the kernel takes (csrc MAXG)


def _check_shapes(q, k_pages, v_pages, page_indices, lengths):
    if q.dim() != 3 or k_pages.dim() != 5 or v_pages.shape != k_pages.shape:
        raise ValueError(f"want q (B, H, D) and stacked pools (L, Hkv, P, "
                         f"page, D); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, H, D = q.shape
    Hkv = k_pages.shape[1]
    if k_pages.shape[4] != D or H % Hkv:
        raise ValueError(f"pools {tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if page_indices.dim() != 2 or page_indices.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"want page_indices (B, max_pages) and lengths (B,) "
                         f"for B={B}; got {tuple(page_indices.shape)}, "
                         f"{tuple(lengths.shape)}")


def paged_attention_plain(q, k_pages, v_pages, page_indices, lengths,
                          sm_scale: Optional[float] = None, layer: int = 0):
    """Gathers the table's pages into contiguous K/V and runs masked
    softmax attention in f32."""
    _check_shapes(q, k_pages, v_pages, page_indices, lengths)
    B, H, D = q.shape
    _, Hkv, _, page, _ = k_pages.shape
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    idx = page_indices.long()
    S = idx.shape[1] * page
    # (Hkv, B, max_pages, page, D) -> (B, Hkv, S, D)
    k = k_pages[layer][:, idx].reshape(Hkv, B, S, D).transpose(0, 1).float()
    v = v_pages[layer][:, idx].reshape(Hkv, B, S, D).transpose(0, 1).float()
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.matmul(qg, k.transpose(-1, -2)) * scale          # (B, Hkv, G, S)
    live = torch.arange(S, device=q.device) < lengths.view(B, 1).long()
    s = s.masked_fill(~live.view(B, 1, 1, S), float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = p.masked_fill((lengths <= 0).view(B, 1, 1, 1), 0.0)  # length 0: zeros
    o = torch.matmul(p, v)
    return o.reshape(B, H, D).to(q.dtype)


def paged_attention(q, k_pages, v_pages, page_indices, lengths,
                    sm_scale: Optional[float] = None, layer: int = 0):
    """Paged decode attention; see the module docstring."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_indices,
                                     lengths, sm_scale, layer)
    _check_shapes(q, k_pages, v_pages, page_indices, lengths)
    tensors = (q, k_pages, v_pages, page_indices, lengths)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: the kernel wants every tensor on "
                         "one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in KERNEL_DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention kernel takes one dtype of "
                         f"{KERNEL_DTYPES}; got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if page_indices.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention kernel wants int32 page_indices "
                         "and lengths")
    B, H, D = q.shape
    L, Hkv, P, page, _ = k_pages.shape
    if D not in KERNEL_HEAD_DIMS or H // Hkv > MAX_GROUP:
        raise ValueError(f"paged_attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS} and at most {MAX_GROUP} query "
                         f"heads per kv head; got D={D}, {H // Hkv}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention kernel wants contiguous pools")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q = q.contiguous()
    page_indices, lengths = page_indices.contiguous(), lengths.contiguous()
    native.check_aligned(q, k_pages, v_pages)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = native.kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cubecl_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_indices.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            native.DTYPE_CODES[q.dtype],
            B, H, Hkv, D, layer, P, page, page_indices.shape[1],
            scale * LOG2E, stream)
    native.check(lib, rc, "paged_attention")
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
