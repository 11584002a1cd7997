"""Llama-family LM: RMSNorm + RoPE + GQA + SwiGLU, paged KV serving and
SGD training.

The PyTorch counterpart of ``cubecl_tpu.models.llama``'s single-device
paths: ``init_params`` / ``params_from_jax`` give a :class:`Llama` module;
``prefill``, ``decode_step`` and ``generate`` serve it over a stacked paged
KV cache (model dtype or int8 with per-(token, head) scales);
``decode_chunk``, ``prefill_chunked`` (also the suffix of a prefix-cache
hit), ``speculative_generate`` and ``beam_generate`` (pages from
``runtime.pages.PageAllocator``, ``fork_seq``) serve it in chunks;
StreamingLLM serving (``attn_window``, ``attn_sinks``): each decode step
attends the first ``attn_sinks`` positions and the last ``attn_window``
(prefill and chunks attend everything, as in the JAX package), and with
``ring_cache`` the cache is a ring of fixed capacity whose slots carry
their absolute positions (``KVCache.pos_meta``), decoded token by token;
``loss_fn`` / ``make_train_step`` train it (``cfg.remat`` recomputes each
layer in the backward through ``torch.utils.checkpoint``). With
``n_experts > 0`` every FFN is a mixture of experts (:func:`_ffn`): the
dense route computes every expert and gates it by the top-k router
weights; with ``moe_capacity > 0`` the sparse route dispatches tokens to
fixed-capacity expert slots (``ops.moe``) and runs the per-expert GEMMs on
E1 (``csrc/expert_matmul.cu``), three launches a layer. Weights keep the
JAX orientation ``(d_in, d_out)`` and are used as ``x @ W``, so JAX
parameters load without transposes. They are built frozen
(``requires_grad=False``) for serving; a train step makes them trainable.
Models and caches are built on the card unless ``device`` says otherwise;
functions that take tensors follow their inputs' device.

Prefill and training attention go through the flash function that the
JAX model picks for the head dim (``ops.attention.flash_for_head_dim``:
``flash_attention`` at 64 and multiples of 128 (256: GPT-J-6B's),
``flash_attention_packed`` at 32 with heads a multiple of 4,
``flash_attention_padded`` otherwise (up to 256); hand-written CUDA
forward, in training also its dK/dV and dQ backward kernels), each
decode step's through ``ops.paged_attention.paged_attention``
and each chunk's through ``ops.paged_attention.paged_attention_chunked``.
With ``use_framework_kernels=True`` (the default, as in the JAX package)
every RMSNorm whose rows fit the DSL kernels (``ops.functional.fits``) is
the ``@cube`` kernel ``ops.functional.rmsnorm``, launched through K0 (the
CUDA printer's kernel on a card, the torch evaluator on the CPU): 2·L+1
launches per forward or decode step, and as many of ``_rmsnorm_bwd_k`` per
backward. ``kernels=False`` runs the plain PyTorch versions of all of them
on any device; it is the reference the kernels are checked against. RoPE,
SwiGLU, the dense MoE route and the projections are plain tensor code.

Unlike the functional JAX code, the KV pools and, in a train step, the
weights are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import functional as F
from ..ops.attention import flash_attention_plain, flash_for_head_dim
from ..ops.moe import (
    expert_matmul,
    expert_matmul_plain,
    moe_combine,
    moe_dispatch,
    top_k_stable,
)
from ..ops.paged_attention import (
    paged_attention,
    paged_attention_chunked,
    paged_attention_chunked_plain,
    paged_attention_plain,
    quantize_kv,
)


@dataclasses.dataclass
class LlamaConfig:
    """Same fields and defaults as ``cubecl_tpu.models.llama.LlamaConfig``
    (:func:`check_supported` refuses the values it does not know)."""
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    n_layers: int = 2
    d_ff: int = 256
    seq: int = 64
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "float32"
    use_framework_kernels: bool = True
    use_flash_attention: bool = True
    n_experts: int = 0
    top_k: int = 2
    kv_dtype: str = ""
    attn_window: int = 0
    attn_sinks: int = 0
    remat: bool = False
    ring_cache: bool = False
    moe_capacity: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"dtype {self.dtype!r}: the port runs "
                                      "float32 and bfloat16")
        return getattr(torch, self.dtype)


def check_supported(cfg: LlamaConfig) -> None:
    """Raise for a kv_dtype or dtype the port does not know."""
    if cfg.kv_dtype not in ("", "int8"):
        raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r}")
    cfg.torch_dtype  # noqa: B018 -- raises for other dtypes


def _param(shape, dtype, device, fill=None):
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, cfg.torch_dtype
        self.rms1 = _param((d,), dt, device, 1.0)
        self.rms2 = _param((d,), dt, device, 1.0)
        self.wq = _param((d, cfg.n_heads * hd), dt, device)
        self.wk = _param((d, cfg.n_kv_heads * hd), dt, device)
        self.wv = _param((d, cfg.n_kv_heads * hd), dt, device)
        self.wo = _param((cfg.n_heads * hd, d), dt, device)
        if cfg.n_experts:  # stacked experts: w1, w3 (E, d, f), w2 (E, f, d)
            e = cfg.n_experts
            self.router = _param((d, e), dt, device)
            self.w1 = _param((e, d, cfg.d_ff), dt, device)
            self.w3 = _param((e, d, cfg.d_ff), dt, device)
            self.w2 = _param((e, cfg.d_ff, d), dt, device)
        else:
            self.w1 = _param((d, cfg.d_ff), dt, device)
            self.w3 = _param((d, cfg.d_ff), dt, device)
            self.w2 = _param((cfg.d_ff, d), dt, device)


class Llama(nn.Module):
    """Parameters of the model; ``model(tokens)`` is :func:`forward`.
    Built with uninitialized weights: use :func:`init_params` or load
    :func:`params_from_jax`."""

    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(LlamaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.rms_out = _param((cfg.d_model,), dt, device, 1.0)

    def forward(self, tokens, kernels: bool = True):
        return forward(self, tokens, kernels=kernels)


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> Llama:
    """Random weights, N(0, 0.02) cast to ``cfg.dtype``, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed`` (not the JAX numbers:
    load :func:`params_from_jax` to compare with the JAX package)."""
    model = Llama(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "rms" in name:
                continue
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
    return model


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch reads it bit for bit
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of :class:`Llama` from the JAX parameter pytree
    of ``cubecl_tpu.models.llama.init_params`` (leaves as numpy arrays):
    ``model.load_state_dict(params_from_jax(tree))``. The layout does not
    depend on ``use_framework_kernels``: the kernel route changes how
    RMSNorm is computed, not its weights."""
    sd = {"embed": _to_torch(tree["embed"]),
          "rms_out": _to_torch(tree["rms_out"])}
    for i, layer in enumerate(tree["layers"]):
        for name in ("rms1", "rms2", "wq", "wk", "wv", "wo"):
            sd[f"layers.{i}.{name}"] = _to_torch(layer[name])
        ffn = layer["moe"] if "moe" in layer else layer["mlp"]
        for name in ffn:  # mlp: w1, w3, w2; moe: router and stacked w1, w3, w2
            sd[f"layers.{i}.{name}"] = _to_torch(ffn[name])
    return sd


def _rmsnorm_plain(x, g, eps):
    """f32 variance; the reciprocal is cast to x's dtype before the
    multiply, as the JAX package's ``_rmsnorm_jnp``."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.reciprocal(torch.sqrt(var + eps)).to(x.dtype)) * g


def _rmsnorm_framework_plain(x, g, eps):
    """The plain version of ``F.rmsnorm``'s kernel: ``x * rsqrt(sum(x^2) *
    (1/D) + eps) * g`` in f32, cast once to x's dtype (in bf16 it rounds
    otherwise than :func:`_rmsnorm_plain`)."""
    xf = x.float()
    ms = xf.square().sum(-1, keepdim=True) * (1.0 / x.shape[-1])
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)


def _rmsnorm(x, g, cfg: LlamaConfig, kernels: bool):
    """RMSNorm as the JAX package routes it (``_rmsnorm`` with
    ``transformer._rowwise_framework``): the ``@cube`` kernel where the
    configuration asks for framework kernels and the rows fit it, else
    ``_rmsnorm_jnp``'s formula. ``kernels=False`` takes the plain version
    of whichever of the two the configuration picks."""
    eps = cfg.rms_eps
    if cfg.use_framework_kernels and F.fits(x):
        return F.rmsnorm(x, g, eps) if kernels else \
            _rmsnorm_framework_plain(x, g, eps)
    return _rmsnorm_plain(x, g, eps)


def _rope_tables(pos, cfg: LlamaConfig):
    """cos, sin (..., hd/2) of the rotary angles at positions ``pos``: f32
    angles, cast to the model dtype, as ``_rope`` / ``_rope_at`` of the JAX
    package. Built once per forward or decode step and shared by every
    layer's q and k (XLA shares them by CSE under jit)."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (-torch.arange(
        half, dtype=torch.float32, device=pos.device) / half)
    ang = pos.float()[..., None] * freqs
    dt = cfg.torch_dtype
    return torch.cos(ang).to(dt), torch.sin(ang).to(dt)


def _rope(x, cos, sin):
    """Split-halves rotary of x (..., hd) with tables broadcastable to
    (..., hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _swiglu(x, layer: LlamaLayer):
    return (nn.functional.silu(x @ layer.w1) * (x @ layer.w3)) @ layer.w2


def _moe_dense(x, layer: LlamaLayer, cfg: LlamaConfig):
    """Every expert computed, gated by the top-k router weights: the
    router's logits at or above the k-th largest keep their value (a tie
    with the k-th keeps more than k experts, as in the JAX package), the
    others -1e30, then a softmax. x (..., d) -> (..., d)."""
    logits = x @ layer.router                               # (..., E)
    k = min(cfg.top_k, cfg.n_experts)
    thresh = top_k_stable(logits, k)[0][..., -1:]
    masked = torch.where(logits >= thresh, logits,
                         torch.tensor(-1e30, dtype=logits.dtype,
                                      device=logits.device))
    gates = torch.softmax(masked, dim=-1)                   # zeros off top-k
    h = nn.functional.silu(torch.einsum("...d,edf->e...f", x, layer.w1)) * \
        torch.einsum("...d,edf->e...f", x, layer.w3)
    y = torch.einsum("e...f,efd->e...d", h, layer.w2)
    return torch.einsum("...e,e...d->...d", gates.to(y.dtype), y)


def _moe_sparse(x, layer: LlamaLayer, cfg: LlamaConfig, kernels: bool):
    """Capacity-grouped dispatch: tokens scattered to ``moe_capacity``
    slots per expert, the three expert GEMMs on E1 (``expert_matmul``;
    ``kernels=False`` its plain version), outputs gathered back and mixed
    by the renormalized gates. x (..., d) -> (..., d). E1 has no backward
    (nor has the JAX kernel): under autograd this raises."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in (layer.router, layer.w1, layer.w3,
                                      layer.w2))):
        raise NotImplementedError(
            "the sparse MoE route (moe_capacity > 0) has no backward: E1 "
            "(expert_matmul) has none; train with moe_capacity = 0 (the "
            "dense route)")
    xf = x.reshape(-1, x.shape[-1])
    k = min(cfg.top_k, cfg.n_experts)
    xg, gates, slot, tope, counts, live = moe_dispatch(
        xf, xf @ layer.router, k, cfg.moe_capacity)
    mm = expert_matmul if kernels else expert_matmul_plain
    h = nn.functional.silu(mm(xg, layer.w1, counts)) * mm(xg, layer.w3, counts)
    y = mm(h.to(xg.dtype), layer.w2, counts)
    return moe_combine(y, gates, slot, tope, live).view(x.shape)


def _ffn(x, layer: LlamaLayer, cfg: LlamaConfig, kernels: bool):
    """The layer's FFN on x (B, T, d) or, in a decode step, (B, d): SwiGLU,
    or with ``n_experts`` the MoE route the config picks (sparse when
    ``moe_capacity > 0``, else dense; with ``n_experts == 0``
    ``moe_capacity`` is not read)."""
    if not cfg.n_experts:
        return _swiglu(x, layer)
    if cfg.moe_capacity:
        return _moe_sparse(x, layer, cfg, kernels)
    return _moe_dense(x, layer, cfg)


def _attention(x, layer: LlamaLayer, cfg: LlamaConfig, rope, kernels: bool):
    """Causal self-attention of a (B, S, d) block, ``rope`` the (S, hd/2)
    tables of positions 0..S-1; also returns the post-rope k, v
    (B, S, Hkv, hd) for the cache."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cos, sin = (t[None, :, None, :] for t in rope)
    q = _rope((x @ layer.wq).view(b, s, nh, hd), cos, sin)
    k = _rope((x @ layer.wk).view(b, s, nkv, hd), cos, sin)
    v = (x @ layer.wv).view(b, s, nkv, hd)
    # GQA: the flash function reads kv head h // (nh // nkv) itself
    attend = flash_for_head_dim(hd, nh) if kernels and \
        cfg.use_flash_attention else flash_attention_plain
    o = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=True)
    return o.transpose(1, 2).reshape(b, s, nh * hd) @ layer.wo, (k, v)


def _no_lora(lora):
    if lora is not None:
        raise NotImplementedError("multi-LoRA is ROADMAP Queue 1 item 8")


def _layer(x, layer: LlamaLayer, cfg: LlamaConfig, rope, kernels: bool):
    x = x + _attention(_rmsnorm(x, layer.rms1, cfg, kernels), layer, cfg,
                       rope, kernels)[0]
    return x + _ffn(_rmsnorm(x, layer.rms2, cfg, kernels), layer, cfg,
                    kernels)


def forward(model: Llama, tokens, *, kernels: bool = True, lora=None):
    """tokens (B, S) int -> logits (B, S, vocab). Differentiable where the
    weights require grad; with ``cfg.remat`` (and grad mode on) each layer
    keeps only its input and is recomputed in the backward."""
    _no_lora(lora)
    cfg = model.cfg
    rope = _rope_tables(torch.arange(tokens.shape[1], device=tokens.device),
                        cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    x = model.embed[tokens]
    for layer in model.layers:
        if remat:
            x = checkpoint(_layer, x, layer, cfg, rope, kernels,
                           use_reentrant=False)
        else:
            x = _layer(x, layer, cfg, rope, kernels)
    x = _rmsnorm(x, model.rms_out, cfg, kernels)
    return x @ model.embed.T                     # tied head


def loss_fn(model: Llama, tokens, *, kernels: bool = True):
    """Mean next-token NLL of tokens (B, S + 1): the logits of the first S
    positions in f32, log-softmax with the max shift written out as the
    JAX ``loss_fn`` writes it."""
    logits = forward(model, tokens[:, :-1], kernels=kernels).float()
    targets = tokens[:, 1:].long()
    mx = logits.max(-1, keepdim=True).values
    logp = logits - torch.log(torch.exp(logits - mx).sum(-1, keepdim=True)) \
        - mx
    return -logp.gather(-1, targets[..., None]).mean()


def sgd_step(cfg, loss, lr: float, kernels: bool):
    """``step(model, tokens) -> loss(model, tokens)``: one SGD step on a
    model built for ``cfg``. The weights become trainable, the old grads
    are dropped, one backward fills ``p.grad`` (left there for inspection
    until the next step), and each weight is updated in place as the JAX
    ``p - lr * g`` (a grad has its weight's dtype)."""

    def step(model: nn.Module, tokens):
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        value = loss(model, tokens, kernels=kernels)
        value.backward()
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(lr * p.grad)
        return value.detach()

    return step


def make_train_step(cfg: LlamaConfig, lr: float = 1e-3, *,
                    kernels: bool = True):
    """``step(model, tokens) -> loss``: one in-place SGD step of
    :func:`loss_fn` (see :func:`sgd_step`)."""
    return sgd_step(cfg, loss_fn, lr, kernels)


@dataclasses.dataclass
class KVCache:
    """Stacked paged KV cache. k, v: (L, Hkv, P, page, hd) in the model
    dtype, or int8 with f32 ``k_scales`` / ``v_scales`` (L, Hkv, P, page),
    one per (token, head); page_indices: (B, max_pages) int32 block table;
    lengths: (B,) int32 tokens cached. A ring cache (``attn_window`` and
    ``ring_cache``) also has ``pos_meta`` (P, page) int32: each slot's
    absolute position, -1 where nothing was written, shared by every
    layer and kv head. The serving functions update the pools in place; a
    caller driving the table from a
    :class:`~cubecl_tpu_torch.runtime.pages.PageAllocator` assigns
    ``page_indices`` and ``lengths`` between steps."""
    k: torch.Tensor
    v: torch.Tensor
    page_indices: torch.Tensor
    lengths: torch.Tensor
    page_size: int
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None
    pos_meta: Optional[torch.Tensor] = None


def init_kv_cache(cfg: LlamaConfig, batch: int, max_pages: int,
                  page: int = 128, device="cuda", *,
                  num_pages: Optional[int] = None) -> KVCache:
    """Zeroed pools (int8 ones with unit scales where ``cfg.kv_dtype`` is
    ``"int8"``, else of ``cfg.dtype``). By default row b owns the
    preassigned pages ``b * max_pages .. (b + 1) * max_pages - 1``. With
    ``num_pages`` the pool holds that many pages and every row starts
    parked at page 0 with length 0, for a ``PageAllocator`` to drive.
    With ``attn_window`` and ``ring_cache`` the cache is a ring (its
    ``pos_meta`` all -1): sinks a multiple of ``page`` and a capacity of
    at least sinks + window + page, or ``ValueError``."""
    ring = bool(cfg.attn_window and cfg.ring_cache)
    if ring and cfg.attn_sinks % page:
        raise ValueError(f"a ring's sinks must fill whole pages: "
                         f"attn_sinks {cfg.attn_sinks}, page {page}")
    if ring and max_pages * page < cfg.attn_sinks + cfg.attn_window + page:
        raise ValueError(f"a ring of {max_pages} pages of {page} does not "
                         f"cover sinks {cfg.attn_sinks} + window "
                         f"{cfg.attn_window} + one page")
    kind = cfg.kv_dtype or cfg.dtype
    quant = kind == "int8"
    dt = torch.int8 if quant else getattr(torch, kind)
    P = int(num_pages) if num_pages is not None else batch * max_pages
    shape = (cfg.n_layers, cfg.n_kv_heads, P, page, cfg.head_dim)
    if num_pages is None:
        table = torch.arange(P, dtype=torch.int32,
                             device=device).view(batch, max_pages)
    else:
        table = torch.zeros(batch, max_pages, dtype=torch.int32,
                            device=device)
    cache = KVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        page_indices=table,
        lengths=torch.zeros(batch, dtype=torch.int32, device=device),
        page_size=page)
    if quant:
        cache.k_scales = torch.ones(shape[:4], device=device)
        cache.v_scales = torch.ones(shape[:4], device=device)
    if ring:
        cache.pos_meta = torch.full((P, page), -1, dtype=torch.int32,
                                    device=device)
    return cache


def fork_seq(cache: KVCache, alloc, src: int, dst: int):
    """Fork sequence ``src`` into ``dst`` (beam search, parallel sampling):
    the allocator shares every page by refcount; where the fork point is
    in mid-page, ``dst`` gets a private copy of the partial last page (and
    its scales), copied once in place on the device. Returns (cache, ok)."""
    if not alloc.fork(src, dst):
        return cache, False
    if alloc.lengths[dst] % cache.page_size:
        _unshare_last(cache, alloc, dst)
    return cache, True


def _unshare_last(cache: KVCache, alloc, seq: int):
    """Give ``seq`` a private copy of its last page (and its scales) if it
    shares it, copied once in place on the device."""
    pair = alloc.unshare_last(seq)
    if pair is not None:
        old, new = pair
        for pool in (cache.k, cache.v, cache.k_scales, cache.v_scales):
            if pool is not None:
                pool[:, :, new] = pool[:, :, old]


def _cache_write(cache: KVCache, layer: int, pid, slot, k, v):
    """Write tokens k, v (..., Hkv, hd) into layer ``layer`` at (page
    ``pid``, slot ``slot``), index tensors of shape (...): one indexed
    in-place write per pool, where the functional JAX code chains a
    dynamic_update_slice per row. int8 pools take ``quantize_kv``'s values
    and their scales."""
    nd = pid.dim()
    perm = (nd, *range(nd), nd + 1)          # (..., Hkv, hd) -> (Hkv, ..., hd)
    if cache.k_scales is not None:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        cache.k_scales[layer][:, pid, slot] = ks.permute(perm[:-1])
        cache.v_scales[layer][:, pid, slot] = vs.permute(perm[:-1])
    cache.k[layer][:, pid, slot] = k.permute(perm).to(cache.k.dtype)
    cache.v[layer][:, pid, slot] = v.permute(perm).to(cache.v.dtype)


def _scales(cache: KVCache):
    return dict(k_scales=cache.k_scales, v_scales=cache.v_scales)


def _no_ring(cache: KVCache, what: str):
    """A ring's slots recycle, so only ``decode_step`` writes it: a chunk
    of tokens would write past the ring (the JAX chunked paths do)."""
    if cache.pos_meta is not None:
        raise ValueError(f"{what} does not take a ring cache: a ring "
                         f"decodes token by token (decode_step)")


def _check_capacity(cache: KVCache, end: int, what: str):
    cap = cache.page_indices.shape[1] * cache.page_size
    if end > cap:
        raise ValueError(f"{what} reaches position {end - 1}, past the "
                         f"cache's {cache.page_indices.shape[1]} pages of "
                         f"{cache.page_size}")


@torch.no_grad()
def prefill(model: Llama, cache: KVCache, tokens, *, kernels: bool = True):
    """Run the prompt (B, S) through the model once, write every layer's
    post-rope K/V (quantized for int8 pools) into the pages of the first B
    rows of the table, and set the lengths to S. Returns (last-position
    logits (B, vocab), cache)."""
    cfg = model.cfg
    B, S = tokens.shape
    page = cache.page_size
    _no_ring(cache, "prefill")
    _check_capacity(cache, S, f"a prompt of {S} tokens")
    pos = torch.arange(S, device=tokens.device)
    pid = cache.page_indices[:B, pos // page].long()          # (B, S)
    slot = (pos % page).expand(B, S)
    rope = _rope_tables(pos, cfg)
    x = model.embed[tokens]
    for li, layer in enumerate(model.layers):
        o, (k, v) = _attention(_rmsnorm(x, layer.rms1, cfg, kernels),
                               layer, cfg, rope, kernels)
        _cache_write(cache, li, pid, slot, k, v)
        x = x + o
        x = x + _ffn(_rmsnorm(x, layer.rms2, cfg, kernels), layer, cfg,
                     kernels)
    x = _rmsnorm(x, model.rms_out, cfg, kernels)
    cache.lengths = torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)
    return x[:, -1] @ model.embed.T, cache


@torch.no_grad()
def decode_step(model: Llama, cache: KVCache, tokens, *,
                kernels: bool = True, lora=None):
    """One token per row, tokens (B,): writes its K/V at position
    ``lengths[b]``, attends positions ``< lengths[b] + 1`` (with
    ``attn_window``, only the sinks and the window of them) and advances
    the lengths. A ring cache writes position t at the ring slot
    ``t`` below the sinks, else ``sinks + (t - sinks) % (capacity -
    sinks)``, and records t in ``pos_meta``. Returns (logits (B, vocab),
    cache)."""
    _no_lora(lora)
    cfg = model.cfg
    B = tokens.shape[0]
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    page = cache.page_size
    pos = cache.lengths
    wpos = pos
    if cache.pos_meta is not None:
        st = cfg.attn_sinks
        ring = cache.page_indices.shape[1] * page - st
        wpos = torch.where(pos < st, pos, st + (pos - st) % ring)
    rows = torch.arange(B, device=tokens.device)
    pid = cache.page_indices[rows, (wpos // page).long()].long()
    slot = (wpos % page).long()
    if cache.pos_meta is not None:   # once a step, for every layer
        cache.pos_meta[pid, slot] = pos
    attend_len = pos + 1
    attend = paged_attention if kernels else paged_attention_plain
    opts = dict(window=cfg.attn_window, sinks=cfg.attn_sinks,
                pos_meta=cache.pos_meta)
    cos, sin = (t[:, None, :] for t in _rope_tables(pos, cfg))
    x = model.embed[tokens]
    for li, layer in enumerate(model.layers):
        h = _rmsnorm(x, layer.rms1, cfg, kernels)
        q = _rope((h @ layer.wq).view(B, nh, hd), cos, sin)
        k = _rope((h @ layer.wk).view(B, nkv, hd), cos, sin)
        v = (h @ layer.wv).view(B, nkv, hd)
        _cache_write(cache, li, pid, slot, k, v)
        o = attend(q, cache.k, cache.v, cache.page_indices, attend_len,
                   layer=li, **_scales(cache), **opts)
        x = x + o.reshape(B, nh * hd) @ layer.wo
        x = x + _ffn(_rmsnorm(x, layer.rms2, cfg, kernels), layer, cfg,
                     kernels)
    x = _rmsnorm(x, model.rms_out, cfg, kernels)
    cache.lengths = attend_len
    return x @ model.embed.T, cache


@torch.no_grad()
def decode_chunk(model: Llama, cache: KVCache, tokens, *,
                 kernels: bool = True):
    """C tokens per row in one pass, tokens (B, C): writes the chunk's K/V
    at positions ``lengths[b] .. lengths[b] + C - 1`` (one indexed write
    per pool and layer), then ``paged_attention_chunked`` scores every
    chunk token against the whole cache, causal inside the chunk. The
    verify pass of speculative decoding and the step of chunked prefill.
    No host sync and no check: the caller keeps ``lengths + C`` within the
    table (``prefill_chunked`` and ``speculative_generate`` check it once on
    the host). Past the table, the lookup fails on the CPU; on the card the
    gather is a device-side assert and the kernels read past the table's
    row. Returns (logits (B, C, vocab), cache with lengths + C)."""
    cfg = model.cfg
    B, C = tokens.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    page = cache.page_size
    _no_ring(cache, "decode_chunk")
    starts = cache.lengths
    pos = starts.view(B, 1) + torch.arange(C, device=tokens.device)
    pid = cache.page_indices.gather(1, (pos // page).long()).long()
    slot = (pos % page).long()
    ends = starts + C
    attend = paged_attention_chunked if kernels \
        else paged_attention_chunked_plain
    cos, sin = (t[:, :, None, :] for t in _rope_tables(pos, cfg))
    x = model.embed[tokens]
    for li, layer in enumerate(model.layers):
        h = _rmsnorm(x, layer.rms1, cfg, kernels)
        q = _rope((h @ layer.wq).view(B, C, nh, hd), cos, sin)
        k = _rope((h @ layer.wk).view(B, C, nkv, hd), cos, sin)
        v = (h @ layer.wv).view(B, C, nkv, hd)
        _cache_write(cache, li, pid, slot, k, v)
        o = attend(q.transpose(1, 2), cache.k, cache.v, cache.page_indices,
                   ends, starts, layer=li, **_scales(cache))  # (B, H, C, hd)
        x = x + o.transpose(1, 2).reshape(B, C, nh * hd) @ layer.wo
        x = x + _ffn(_rmsnorm(x, layer.rms2, cfg, kernels), layer, cfg,
                     kernels)
    x = _rmsnorm(x, model.rms_out, cfg, kernels)
    cache.lengths = ends
    return x @ model.embed.T, cache


@torch.no_grad()
def prefill_chunked(model: Llama, cache: KVCache, tokens, chunk: int = 256,
                    *, kernels: bool = True):
    """Prefill through ``decode_chunk`` in pieces of ``chunk`` tokens,
    from each row's current length (0 for a fresh cache; the cached prefix
    after ``PageAllocator.admit_cached``). Attention memory is O(chunk · S)
    instead of O(S²), and each piece can share a batch with decode
    traffic. Returns (last-position logits (B, vocab), cache)."""
    _no_ring(cache, "prefill_chunked")
    _check_capacity(cache, int(cache.lengths.max()) + tokens.shape[1],
                    f"a prompt of {tokens.shape[1]} tokens")
    logits = None
    for s0 in range(0, tokens.shape[1], chunk):
        logits, cache = decode_chunk(model, cache, tokens[:, s0:s0 + chunk],
                                     kernels=kernels)
    return logits[:, -1], cache


@torch.no_grad()
def speculative_generate(model: Llama, prompt, steps: int, draft: Llama,
                         gamma: int = 4, max_pages: int = 8, page: int = 128,
                         *, kernels: bool = True):
    """Greedy speculative decoding: each round the draft proposes
    ``gamma`` tokens, one at a time; the target scores the committed token
    and the proposal in one ``decode_chunk`` (C = gamma + 1) and commits
    the longest agreeing prefix plus its own next token. The output equals
    the target's greedy stream. Rollback rewinds ``lengths``: rejected
    positions are overwritten by the next chunk. Returns ((B, steps) int32
    tokens, mean accepted proposals per round)."""
    B, S = prompt.shape
    dev = prompt.device
    for m in (model, draft):
        if m.cfg.attn_window and m.cfg.ring_cache:
            raise ValueError("speculative_generate does not take a ring "
                             "cache: its verify step writes a chunk")
    tc = init_kv_cache(model.cfg, B, max_pages, page, dev)
    dc = init_kv_cache(draft.cfg, B, max_pages, page, dev)
    t_logits, tc = prefill(model, tc, prompt, kernels=kernels)
    _, dc = prefill(draft, dc, prompt, kernels=kernels)
    t_next = t_logits.argmax(-1).to(torch.int32)
    out = [[] for _ in range(B)]
    accepted = []
    while min(len(o) for o in out) < steps:
        t_pos0, d_pos0 = tc.lengths, dc.lengths
        _check_capacity(tc, int(t_pos0.max()) + gamma + 1,
                        "a speculative round")
        props, feed = [], t_next
        for _ in range(gamma):
            d_logits, dc = decode_step(draft, dc, feed, kernels=kernels)
            feed = d_logits.argmax(-1).to(torch.int32)
            props.append(feed)
        props = torch.stack(props, dim=1)                   # (B, gamma)
        logits, tc = decode_chunk(model, tc,
                                  torch.cat([t_next[:, None], props], 1),
                                  kernels=kernels)
        pn = props.cpu().numpy()
        tn = logits.argmax(-1).to(torch.int32).cpu().numpy()  # (B, gamma+1)
        acc = np.zeros(B, np.int64)
        for b in range(B):
            while acc[b] < gamma and pn[b, acc[b]] == tn[b, acc[b]]:
                acc[b] += 1
        accepted.append(acc.mean())
        for b, tok in enumerate(t_next.cpu().numpy()):
            out[b].append(int(tok))
            out[b].extend(int(x) for x in pn[b, :acc[b]])
        # the target's token at the first disagreement (or its bonus token
        # where every proposal was accepted)
        t_next = torch.from_numpy(tn[np.arange(B), acc]).to(dev)
        if (acc == gamma).any():
            # the draft proposed d_gamma but never wrote its K/V: one
            # batch-wide step writes it; other rows' writes are rolled back
            _, dc = decode_step(draft, dc, props[:, -1], kernels=kernels)
        keep = torch.from_numpy(acc.astype(np.int32) + 1).to(dev)
        tc.lengths, dc.lengths = t_pos0 + keep, d_pos0 + keep
    toks = np.asarray([o[:steps] for o in out], np.int32)
    return torch.from_numpy(toks).to(dev), float(np.mean(accepted))


@torch.no_grad()
def beam_generate(model: Llama, prompt, steps: int, beams: int = 4,
                  page: int = 128, *, kernels: bool = True):
    """Beam search on the paged cache: prefill once, fork the beams
    (prefix pages shared by refcount, the partial page copied once), and at
    every step reorder the beam set with allocator forks and releases:
    dead beams release their pages first, a parent's first child takes its
    sequence, further children fork it. prompt: (S,) int. Returns
    (tokens (beams, S + steps) int32, scores (beams,) f32 summed
    log-probs), best beam first.

    The allocator's lengths count each beam's pending token, whose K/V the
    next step writes on the last page even where that page is counted full,
    so every fork takes a private copy of the last page (``fork_seq``
    copies only a partial one)."""
    from ..runtime.pages import PageAllocator

    cfg, dev = model.cfg, prompt.device
    S = int(prompt.shape[0])
    pages_per = -(-(S + steps + 1) // page)
    # every beam private, a parking page, and the transient page of an
    # unshare while reordering
    pool = PageAllocator(beams * (pages_per + 1) + 1, page)
    assert pool.admit(-1, 1)                        # parking row
    park = pool.block_table([-1], pages_per)[0]
    cache = init_kv_cache(cfg, beams, pages_per, page, dev,
                          num_pages=pool.num_pages)

    def rows_for(seqs):
        rows = [park if s is None else pool.block_table([s], pages_per)[0]
                for s in seqs]
        lens = [0 if s is None else pool.lengths[s] - 1 for s in seqs]
        cache.page_indices = torch.from_numpy(np.stack(rows)).to(dev)
        cache.lengths = torch.tensor(lens, dtype=torch.int32, device=dev)

    hist0 = prompt.cpu().numpy().astype(np.int32).tolist()
    assert pool.admit(0, S + 1)
    rows_for([0])
    logits, cache = prefill(model, cache, prompt.view(1, S), kernels=kernels)
    def fork(src, dst):
        assert pool.fork(src, dst)
        _unshare_last(cache, pool, dst)

    next_id, beam_seqs = 1, [0]
    for _ in range(beams - 1):
        fork(0, next_id)
        beam_seqs.append(next_id)
        next_id += 1
    histories = [list(hist0) for _ in range(beams)]
    lp = torch.log_softmax(logits[0].float(), -1).cpu().numpy()
    # every beam starts from the prompt's distribution: seed them with its
    # top `beams` tokens
    first = np.argsort(-lp)[:beams]
    pending = [int(x) for x in first]
    scores = lp[first]
    for _ in range(steps - 1):
        rows_for(beam_seqs)
        logits, cache = decode_step(
            model, cache, torch.tensor(pending, dtype=torch.int32,
                                       device=dev), kernels=kernels)
        for b in range(beams):
            histories[b].append(pending[b])
            assert pool.extend(beam_seqs[b], 1)
        lp = torch.log_softmax(logits.float(), -1).cpu().numpy()
        flat = (scores[:, None] + lp).ravel()
        top = np.argsort(-flat)[:beams]
        parents, toks = top // lp.shape[1], top % lp.shape[1]
        keep = {int(pb) for pb in parents}
        for pb in range(beams):
            if pb not in keep:
                pool.release(beam_seqs[pb])
        used, new_seqs, new_hist = set(), [], []
        for pb in (int(x) for x in parents):
            if pb not in used:
                used.add(pb)
                new_seqs.append(beam_seqs[pb])
            else:
                fork(beam_seqs[pb], next_id)
                new_seqs.append(next_id)
                next_id += 1
            new_hist.append(list(histories[pb]))
        beam_seqs, histories = new_seqs, new_hist
        scores = flat[top]
        pending = [int(t) for t in toks]
    for b in range(beams):
        histories[b].append(pending[b])
    order = np.argsort(-scores)
    toks = np.asarray([histories[b] for b in order], np.int32)
    return (torch.from_numpy(toks).to(dev),
            torch.from_numpy(np.asarray(scores[order], np.float32)))


def sample_logits(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """The serving sampler: temperature, then a top-k mask, then a top-p
    (nucleus) mask, then a categorical draw from ``generator``.
    Temperature 0 (or top_k 1) is argmax. logits (B, V) -> (B,) int32."""
    if temperature == 0.0 or top_k == 1:
        return logits.argmax(-1).to(torch.int32)
    l = logits.float() / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.sort(l, dim=-1).values[:, -top_k][:, None]
        l = l.masked_fill(l < kth, float("-inf"))
    if top_p < 1.0:
        sl = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sl, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        kth = torch.where(keep, sl, float("inf")).amin(-1, keepdim=True)
        l = l.masked_fill(l < kth, float("-inf"))
    return torch.multinomial(torch.softmax(l, dim=-1), 1,
                             generator=generator)[:, 0].to(torch.int32)


@torch.no_grad()
def generate(model: Llama, prompt, steps: int, max_pages: int = 4,
             page: int = 128, *, kernels: bool = True):
    """Greedy decode: one batched ``prefill`` of the prompt (B, S), then
    ``steps`` decode steps (windowed where ``attn_window`` says so; a ring
    cache is refused by the prefill). Returns the generated tokens (B,
    steps) int32, the first of them from the prefill's logits."""
    B, S = prompt.shape
    if S + steps > max_pages * page:
        raise ValueError(f"{S} prompt + {steps} new tokens exceed "
                         f"{max_pages} pages of {page}")
    cache = init_kv_cache(model.cfg, B, max_pages, page, prompt.device)
    logits, cache = prefill(model, cache, prompt, kernels=kernels)
    out = []
    tok = logits.argmax(-1).to(torch.int32)
    for _ in range(steps):
        out.append(tok)
        logits, cache = decode_step(model, cache, tok, kernels=kernels)
        tok = logits.argmax(-1).to(torch.int32)
    return torch.stack(out, dim=1)
