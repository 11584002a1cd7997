"""Sparse MoE dispatch: counterpart of ``cubecl_tpu.ops.moe``, with its
public names.

Tokens are scattered to a fixed-capacity (E, cap, d) layout
(:func:`moe_dispatch`), every expert's GEMM runs over its own rows
(:func:`expert_matmul`) and the outputs are gathered back per token and
mixed by the renormalized gates (:func:`moe_combine`). Tokens past an
expert's capacity are dropped, as in the JAX package. The per-expert counts
stay on the device end to end: nothing on the path syncs with the host.

``expert_matmul`` on CUDA tensors launches ``csrc/expert_matmul.cu``, which
replaces the TPU kernel E1 (``cubecl_tpu/ops/moe.py::expert_matmul``,
``pallas_call`` :97): bf16 on M1's ``wgmma`` body fed by TMA
(``csrc/wgmma_gemm.cuh``), persistent blocks that read ``counts`` on the
device and walk only the live tiles, in 128 x 256 tiles where those give
every block two or more (prefill) and 128 x 128 ones otherwise (decode);
f32 on the CUDA cores, on an
(n-tile, m-tile, expert) grid whose blocks return at once past
``counts[e]``. On CPU tensors it runs :func:`expert_matmul_plain`.
``expert_matmul.launches`` counts the kernel's launches.

``moe_ep_ffn`` (expert parallelism over an all_to_all) waits for the port's
``torch.distributed`` layer (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import torch

from ..utils import native
from .matmul import _full_f32

# E1's tile per dtype, (tm, tn, tk) as csrc/expert_matmul.cu builds it: f
# must be a multiple of tn, d of tk for f32 and of 32 for bf16 (a last
# stage of 64 may be half past d: the tensor maps zero-fill it, which adds
# nothing to the sums); the capacity may be any size
EXPERT_TILES = {torch.bfloat16: (128, 128, 64), torch.float32: (64, 64, 16)}
EXPERT_K_UNIT = {torch.bfloat16: 32, torch.float32: 16}
# the bf16 kernel's wide tile, (tm, EXPERT_WIDE_BN), which it takes on the
# device where f is a multiple of it and the live tiles fill the card
EXPERT_WIDE_BN = 256


def expert_matmul_plain(xg, w, counts=None):
    """The kernel's function in plain PyTorch: ``einsum("ecd,edf->ecf")``
    in full f32 (TF32 off), cast to xg's dtype, over every row (``counts``
    is taken for the signature: rows past it are the kernel's undefined
    ones)."""
    with _full_f32():
        y = torch.bmm(xg.float(), w.float())
    return y.to(xg.dtype)


def _check_kernel_inputs(xg, w, counts):
    tensors = (xg, w, counts)
    if any(t.device != xg.device for t in tensors):
        raise ValueError(f"expert_matmul: the kernel wants every tensor on "
                         f"one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if xg.dim() != 3 or w.dim() != 3 or counts.dim() != 1:
        raise ValueError(f"expert_matmul takes xg (E, cap, d), w (E, d, f) "
                         f"and counts (E,); got {tuple(xg.shape)}, "
                         f"{tuple(w.shape)}, {tuple(counts.shape)}")
    E, cap, d = xg.shape
    if w.shape[:2] != (E, d) or counts.shape[0] != E:
        raise ValueError(f"expert_matmul: xg {tuple(xg.shape)}, w "
                         f"{tuple(w.shape)} and counts "
                         f"{tuple(counts.shape)} do not agree")
    if xg.dtype not in EXPERT_TILES or w.dtype != xg.dtype:
        raise ValueError(f"expert_matmul kernel takes xg and w of one dtype "
                         f"of {list(EXPERT_TILES)}; got {xg.dtype}, "
                         f"{w.dtype}")
    if counts.dtype != torch.int32:
        raise ValueError(f"expert_matmul kernel wants int32 counts; got "
                         f"{counts.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("expert_matmul: the kernel wants contiguous tensors")
    tn, unit = EXPERT_TILES[xg.dtype][1], EXPERT_K_UNIT[xg.dtype]
    f = w.shape[2]
    if d % unit or f % tn:
        raise ValueError(f"expert_matmul: the {xg.dtype} kernel takes d a "
                         f"multiple of {unit} and f of {tn}; got (d, f) = "
                         f"({d}, {f})")


def expert_matmul(xg, w, counts, bt: int = 128):
    """Batched per-expert matmul with dead-tile skipping.

    xg (E, cap, d) capacity-grouped tokens, w (E, d, f) per-expert weights,
    counts (E,) int32 live rows per expert -> (E, cap, f) in xg's dtype.
    Rows at or past ``counts[e]`` are undefined (the kernel neither reads
    nor writes them): mask downstream, as :func:`moe_combine` does.

    ``bt`` is the JAX signature's capacity tile; the kernel's tile is its
    own (``EXPERT_TILES``) and ``bt`` changes no result. On CUDA tensors
    the kernel runs, or a ``ValueError`` names what it does not take; on
    CPU tensors the plain version runs. E1 has no backward: under
    autograd this raises, on either device."""
    native.refuse_grad("expert_matmul (E1)", "expert_matmul_plain or "
                       "kernels=False", xg, w)
    if xg.device.type == "cpu":
        return expert_matmul_plain(xg, w, counts)
    _check_kernel_inputs(xg, w, counts)
    native.check_aligned(xg, w)
    E, cap, d = xg.shape
    f = w.shape[2]
    out = torch.empty((E, cap, f), dtype=xg.dtype, device=xg.device)
    if out.numel() == 0:
        return out
    tm, tn, tk = EXPERT_TILES[xg.dtype]
    lib = native.kernels()
    with torch.cuda.device(xg.device):
        rc = lib.cubecl_expert_matmul(
            xg.data_ptr(), w.data_ptr(), out.data_ptr(), counts.data_ptr(),
            native.DTYPE_CODES[xg.dtype], E, cap, f, d, tm, tn, tk,
            torch.cuda.current_stream().cuda_stream)
    native.check(lib, rc, "expert_matmul")
    expert_matmul.launches += 1
    return out


expert_matmul.launches = 0


def top_k_stable(logits, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    broken as ``jax.lax.top_k`` breaks them: the lower index first (a
    stable descending sort; ``torch.topk`` promises no order among
    equals)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(x, router_logits, top_k: int, capacity: int):
    """Token -> expert-capacity scatter. x (T, d), logits (T, E) ->
    (xg (E, cap, d), gates (T, k), slot (T, k), expert (T, k), counts (E,)
    int32, live (T, k) bool). Tokens beyond an expert's capacity are
    DROPPED (live False); their gate weight is renormalized away by
    :func:`moe_combine`. A token's slot in an expert is its rank among the
    earlier (token, choice) pairs routed there: an exclusive cumulative sum
    of the one-hot choices, no sort."""
    T, E = router_logits.shape
    topv, tope = top_k_stable(router_logits, top_k)       # (T, k)
    gates = torch.softmax(topv, dim=-1)
    flat_e = tope.reshape(-1)                              # (T*k,)
    oh = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    ranks = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh  # exclusive
    slot = ranks.gather(1, flat_e[:, None])[:, 0].view(T, top_k)
    live = slot < capacity
    counts = oh.sum(0).clamp(max=capacity).to(torch.int32)

    d = x.shape[1]
    xg = torch.zeros((E, capacity, d), dtype=x.dtype, device=x.device)
    flat_slot = torch.where(live, slot, capacity - 1).reshape(-1).long()
    flat_live = live.reshape(-1)
    src = x.repeat_interleave(top_k, dim=0)               # (T*k, d)
    # each live (expert, slot) is unique; dead entries add zeros
    xg.index_put_((flat_e, flat_slot),
                  torch.where(flat_live[:, None], src, 0).to(x.dtype),
                  accumulate=True)
    return xg, gates, slot, tope, counts, live


def moe_combine(yg, gates, slot, expert, live):
    """Gather expert outputs back per token and mix them by the
    renormalized gates: yg (E, cap, f) -> (T, f). Dead choices are zeroed
    with ``torch.where`` (a dead row of yg may hold NaN), and the gates
    are cast to yg's dtype before the mix, as in the JAX package."""
    T, k = gates.shape
    flat_e = expert.reshape(-1)
    flat_s = torch.where(live, slot, 0).reshape(-1).long()
    picked = yg[flat_e, flat_s].view(T, k, -1)             # (T, k, f)
    picked = torch.where(live[..., None], picked, 0)
    g = torch.where(live, gates, 0.0)
    denom = g.sum(-1, keepdim=True).clamp(min=1e-9)
    g = (g / denom).to(picked.dtype)
    return torch.einsum("tk,tkf->tf", g, picked)
