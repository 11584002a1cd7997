"""Llama-family LM: RMSNorm + RoPE + GQA + SwiGLU, paged KV serving and
SGD training.

The PyTorch counterpart of ``cubecl_tpu.models.llama``'s single-device
paths: ``init_params`` / ``params_from_jax`` give a :class:`Llama` module;
``prefill``, ``decode_step`` and ``generate`` serve it over a stacked paged
KV cache, and ``loss_fn`` / ``make_train_step`` train it (``cfg.remat``
recomputes each layer in the backward through ``torch.utils.checkpoint``).
Weights keep the JAX orientation ``(d_in, d_out)`` and are used as
``x @ W``, so JAX parameters load without transposes. They are built
frozen (``requires_grad=False``) for serving; a train step makes them
trainable.

Prefill and training attention go through ``ops.attention.flash_attention``
(hand-written CUDA forward; in training also its dK/dV and dQ backward
kernels), each decode step's through ``ops.paged_attention.paged_attention``.
With ``use_framework_kernels=True`` (the default, as in the JAX package)
every RMSNorm whose rows fit the DSL kernels (``ops.functional.fits``) is
the ``@cube`` kernel ``ops.functional.rmsnorm``, launched through K0 (the
CUDA printer's kernel on a card, the torch evaluator on the CPU): 2·L+1
launches per forward or decode step, and as many of ``_rmsnorm_bwd_k`` per
backward. ``kernels=False`` runs the plain PyTorch versions of all of them
on any device; it is the reference the kernels are checked against. RoPE,
SwiGLU and the projections are plain tensor code.

Unlike the functional JAX code, the KV cache and, in a train step, the
weights are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import functional as F
from ..ops.attention import flash_attention, flash_attention_plain
from ..ops.paged_attention import paged_attention, paged_attention_plain


@dataclasses.dataclass
class LlamaConfig:
    """Same fields and defaults as ``cubecl_tpu.models.llama.LlamaConfig``.
    Options this port does not run yet raise ``NotImplementedError`` when a
    model is built (see :func:`check_supported`)."""
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
    """Raise for every option of the JAX config this port does not run,
    naming the ROADMAP item that brings it."""
    todo = [
        (cfg.n_experts > 0 or cfg.moe_capacity > 0,
         "MoE layers (n_experts, moe_capacity) are ROADMAP Queue 1 item 12"),
        (cfg.kv_dtype == "int8", "int8 KV is ROADMAP Queue 1 item 8"),
        (cfg.attn_window > 0 or cfg.attn_sinks > 0 or cfg.ring_cache,
         "windowed / ring KV decode (attn_window, attn_sinks, ring_cache) "
         "is ROADMAP Queue 1 item 8"),
    ]
    for unsupported, why in todo:
        if unsupported:
            raise NotImplementedError(why)
    if cfg.kv_dtype not in ("", "int8"):
        raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r}")
    cfg.torch_dtype  # noqa: B018 -- raises for other dtypes


def _param(shape, dtype, device, fill=None):
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, cfg.torch_dtype
        self.rms1 = _param((d,), dt, device, 1.0)
        self.rms2 = _param((d,), dt, device, 1.0)
        self.wq = _param((d, cfg.n_heads * hd), dt, device)
        self.wk = _param((d, cfg.n_kv_heads * hd), dt, device)
        self.wv = _param((d, cfg.n_kv_heads * hd), dt, device)
        self.wo = _param((cfg.n_heads * hd, d), dt, device)
        self.w1 = _param((d, cfg.d_ff), dt, device)
        self.w3 = _param((d, cfg.d_ff), dt, device)
        self.w2 = _param((cfg.d_ff, d), dt, device)


class Llama(nn.Module):
    """Parameters of the model; ``model(tokens)`` is :func:`forward`.
    Built with uninitialized weights: use :func:`init_params` or load
    :func:`params_from_jax`."""

    def __init__(self, cfg: LlamaConfig, device=None):
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


def init_params(cfg: LlamaConfig, seed: int = 0, device="cpu") -> Llama:
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
        if "moe" in layer:
            raise NotImplementedError("MoE layers are ROADMAP Queue 1 item 12")
        for name in ("rms1", "rms2", "wq", "wk", "wv", "wo"):
            sd[f"layers.{i}.{name}"] = _to_torch(layer[name])
        for name in ("w1", "w3", "w2"):
            sd[f"layers.{i}.{name}"] = _to_torch(layer["mlp"][name])
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
    attend = flash_attention if kernels and cfg.use_flash_attention \
        else flash_attention_plain
    o = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=True)
    return o.transpose(1, 2).reshape(b, s, nh * hd) @ layer.wo, (k, v)


def _no_lora(lora):
    if lora is not None:
        raise NotImplementedError("multi-LoRA is ROADMAP Queue 1 item 8")


def _layer(x, layer: LlamaLayer, cfg: LlamaConfig, rope, kernels: bool):
    x = x + _attention(_rmsnorm(x, layer.rms1, cfg, kernels), layer, cfg,
                       rope, kernels)[0]
    return x + _swiglu(_rmsnorm(x, layer.rms2, cfg, kernels), layer)


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
    """Stacked paged KV cache. k, v: (L, Hkv, P, page, hd); page_indices:
    (B, max_pages) int32 block table; lengths: (B,) int32 tokens cached."""
    k: torch.Tensor
    v: torch.Tensor
    page_indices: torch.Tensor
    lengths: torch.Tensor
    page_size: int


def init_kv_cache(cfg: LlamaConfig, batch: int, max_pages: int,
                  page: int = 128, device="cpu") -> KVCache:
    """Zeroed pools in which row b owns the preassigned pages
    ``b * max_pages .. (b + 1) * max_pages - 1``."""
    P = batch * max_pages
    shape = (cfg.n_layers, cfg.n_kv_heads, P, page, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        page_indices=torch.arange(P, dtype=torch.int32,
                                  device=device).view(batch, max_pages),
        lengths=torch.zeros(batch, dtype=torch.int32, device=device),
        page_size=page)


def _cache_write_stacked(pages, layer: int, pid, slot, new):
    """Write one (B, Hkv, hd) token per row into layer ``layer`` of the
    stacked pool at (page ``pid[b]``, slot ``slot[b]``): one indexed
    in-place write, where the functional JAX code chains a
    dynamic_update_slice per row."""
    pages[layer][:, pid, slot] = new.transpose(0, 1).to(pages.dtype)


@torch.no_grad()
def prefill(model: Llama, cache: KVCache, tokens, *, kernels: bool = True):
    """Run the prompt (B, S) through the model once, write every layer's
    post-rope K/V into the pages of each row's table, and set the lengths
    to S. Returns (last-position logits (B, vocab), cache)."""
    cfg = model.cfg
    B, S = tokens.shape
    page = cache.page_size
    if S > cache.page_indices.shape[1] * page:
        raise ValueError(f"prompt of {S} tokens exceeds the cache's "
                         f"{cache.page_indices.shape[1]} pages of {page}")
    pos = torch.arange(S, device=tokens.device)
    pid = cache.page_indices[:, pos // page].long()           # (B, S)
    slot = (pos % page).expand(B, S)
    rope = _rope_tables(pos, cfg)
    x = model.embed[tokens]
    for li, layer in enumerate(model.layers):
        o, (k, v) = _attention(_rmsnorm(x, layer.rms1, cfg, kernels),
                               layer, cfg, rope, kernels)
        # (B, S, Hkv, hd) -> pool[li][:, pid, slot] of shape (Hkv, B, S, hd)
        cache.k[li][:, pid, slot] = k.permute(2, 0, 1, 3).to(cache.k.dtype)
        cache.v[li][:, pid, slot] = v.permute(2, 0, 1, 3).to(cache.v.dtype)
        x = x + o
        x = x + _swiglu(_rmsnorm(x, layer.rms2, cfg, kernels), layer)
    x = _rmsnorm(x, model.rms_out, cfg, kernels)
    cache.lengths.fill_(S)
    return x[:, -1] @ model.embed.T, cache


@torch.no_grad()
def decode_step(model: Llama, cache: KVCache, tokens, *,
                kernels: bool = True, lora=None):
    """One token per row, tokens (B,): writes its K/V at position
    ``lengths[b]``, attends positions ``< lengths[b] + 1`` and advances the
    lengths. Returns (logits (B, vocab), cache)."""
    _no_lora(lora)
    cfg = model.cfg
    B = tokens.shape[0]
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    page = cache.page_size
    pos = cache.lengths
    rows = torch.arange(B, device=tokens.device)
    pid = cache.page_indices[rows, (pos // page).long()].long()
    slot = (pos % page).long()
    attend_len = pos + 1
    attend = paged_attention if kernels else paged_attention_plain
    cos, sin = (t[:, None, :] for t in _rope_tables(pos, cfg))
    x = model.embed[tokens]
    for li, layer in enumerate(model.layers):
        h = _rmsnorm(x, layer.rms1, cfg, kernels)
        q = _rope((h @ layer.wq).view(B, nh, hd), cos, sin)
        k = _rope((h @ layer.wk).view(B, nkv, hd), cos, sin)
        v = (h @ layer.wv).view(B, nkv, hd)
        _cache_write_stacked(cache.k, li, pid, slot, k)
        _cache_write_stacked(cache.v, li, pid, slot, v)
        o = attend(q, cache.k, cache.v, cache.page_indices, attend_len,
                   layer=li)
        x = x + o.reshape(B, nh * hd) @ layer.wo
        x = x + _swiglu(_rmsnorm(x, layer.rms2, cfg, kernels), layer)
    x = _rmsnorm(x, model.rms_out, cfg, kernels)
    cache.lengths.add_(1)
    return x @ model.embed.T, cache


@torch.no_grad()
def generate(model: Llama, prompt, steps: int, max_pages: int = 4,
             page: int = 128, *, kernels: bool = True):
    """Greedy decode: one batched ``prefill`` of the prompt (B, S), then
    ``steps`` decode steps. Returns the generated tokens (B, steps) int32,
    the first of them from the prefill's logits."""
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
