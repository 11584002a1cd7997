"""Transformer LM (GPT-style: learned positions, LayerNorm, GELU MLP) on the
port's kernels, single device.

The PyTorch counterpart of ``cubecl_tpu.models.transformer``'s one-device
part: :class:`TransformerConfig`, ``init_params`` (a ``torch.Generator``),
``params_from_jax``, ``forward``, ``loss_fn`` and ``make_train_step``. The
mesh context, ``param_shardings`` and the sharded train step wait for the
port of ``parallel/`` (ROADMAP Queue 1 item 15). Weights keep the JAX
orientation ``(d_in, d_out)``; the head is tied to the embedding.

Routing follows the JAX model. With ``use_framework_kernels`` every
LayerNorm and GELU whose rows fit the DSL kernels (``ops.functional.fits``)
is the ``@cube`` op ``F.layernorm`` / ``F.gelu`` (K0 forward and backward
kernels), else the plain formula. With ``use_flash_attention`` and
``S % 128 == 0`` attention is the flash function that the JAX model picks
for the head dim (``ops.attention.flash_for_head_dim``: exact at 64 and
128, packed at 32, padded otherwise; the hand-written forward and backward
kernels on a card), else the plain einsum softmax. ``kernels=False`` takes the plain
PyTorch version of whichever route the configuration picks: the reference
the kernels are checked against.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch import nn

from ..ops import functional as F
from ..ops.attention import flash_attention_plain, flash_for_head_dim
from .llama import _param, _to_torch, sgd_step

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


@dataclasses.dataclass
class TransformerConfig:
    """Same fields and defaults as
    ``cubecl_tpu.models.transformer.TransformerConfig``."""
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    seq: int = 64
    dtype: str = "float32"
    use_framework_kernels: bool = True
    use_flash_attention: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"dtype {self.dtype!r}: the port runs "
                                      "float32 and bfloat16")
        return getattr(torch, self.dtype)


class _Norm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.g = _param((d,), dtype, device, 1.0)
        self.b = _param((d,), dtype, device, 0.0)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
        self.ln1 = _Norm(d, dt, device)
        self.wq = _param((d, d), dt, device)
        self.wk = _param((d, d), dt, device)
        self.wv = _param((d, d), dt, device)
        self.wo = _param((d, d), dt, device)
        self.ln2 = _Norm(d, dt, device)
        self.w1 = _param((d, f), dt, device)
        self.b1 = _param((f,), dt, device, 0.0)
        self.w2 = _param((f, d), dt, device)
        self.b2 = _param((d,), dt, device, 0.0)


class Transformer(nn.Module):
    """Parameters of the model, named as the JAX pytree's leaves
    (``layers.0.ln1.g``, ...). Built frozen with uninitialized weights: use
    :func:`init_params` or load :func:`params_from_jax`."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.pos = _param((cfg.seq, cfg.d_model), dt, device)
        self.ln_f = _Norm(cfg.d_model, dt, device)
        self.layers = nn.ModuleList(TransformerLayer(cfg, device)
                                    for _ in range(cfg.n_layers))

    def forward(self, tokens, kernels: bool = True):
        return forward(self, tokens, kernels=kernels)


_RANDOM = ("embed", "pos", "wq", "wk", "wv", "wo", "w1", "w2")


def init_params(cfg: TransformerConfig, seed: int = 0,
                device="cuda") -> Transformer:
    """N(0, 0.02) matrices cast to ``cfg.dtype``, unit gains and zero
    biases, drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed`` (not the JAX numbers: load :func:`params_from_jax` to compare
    with the JAX package)."""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in _RANDOM:
                p.copy_(torch.randn(p.shape, generator=gen, device=device)
                        * 0.02)
    return model


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of :class:`Transformer` from the JAX parameter
    pytree of ``cubecl_tpu.models.transformer.init_params`` (leaves as
    numpy arrays)."""
    sd = {"embed": _to_torch(tree["embed"]), "pos": _to_torch(tree["pos"]),
          "ln_f.g": _to_torch(tree["ln_f"]["g"]),
          "ln_f.b": _to_torch(tree["ln_f"]["b"])}
    for i, layer in enumerate(tree["layers"]):
        for name, leaf in layer.items():
            if isinstance(leaf, dict):
                for sub, a in leaf.items():
                    sd[f"layers.{i}.{name}.{sub}"] = _to_torch(a)
            else:
                sd[f"layers.{i}.{name}"] = _to_torch(leaf)
    return sd


def _layernorm_plain(x, g, b, eps=1e-5):
    """``_layernorm_jnp``: statistics in x's dtype."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _layernorm_framework_plain(x, g, b, eps=1e-5):
    """The plain version of ``F.layernorm``'s kernel: f32 statistics, cast
    once to x's dtype."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    var = xc.square().mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * g.float() + b.float()).to(x.dtype)


def _gelu_framework_plain(x):
    """The plain version of ``F.gelu``'s kernel (exact erf form)."""
    return x * (torch.erf(x * _INV_SQRT2) + 1.0) * 0.5


def _layernorm(x, norm: _Norm, cfg: TransformerConfig, kernels: bool):
    if cfg.use_framework_kernels and F.fits(x):
        if kernels:
            return F.layernorm(x, norm.g, norm.b)
        return _layernorm_framework_plain(x, norm.g, norm.b)
    return _layernorm_plain(x, norm.g, norm.b)


def _gelu(x, cfg: TransformerConfig, kernels: bool):
    if cfg.use_framework_kernels and F.fits(x):
        return F.gelu(x) if kernels else _gelu_framework_plain(x)
    return nn.functional.gelu(x)


def _attention(x, layer: TransformerLayer, cfg: TransformerConfig,
               kernels: bool):
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim

    def heads(w):
        return (x @ w).view(B, S, H, hd).transpose(1, 2)

    q, k, v = heads(layer.wq), heads(layer.wk), heads(layer.wv)
    if cfg.use_flash_attention and S % 128 == 0:
        attend = flash_for_head_dim(hd, H) if kernels \
            else flash_attention_plain
        ctx = attend(q, k, v, True)
    else:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / math.sqrt(hd)
        live = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~live, -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.matmul(probs, v)
    return ctx.transpose(1, 2).reshape(B, S, D) @ layer.wo


def forward(model: Transformer, tokens, *, kernels: bool = True):
    """tokens (B, S) int -> logits (B, S, vocab); differentiable where the
    weights require grad."""
    cfg = model.cfg
    x = model.embed[tokens] + model.pos[None, :tokens.shape[1]]
    for layer in model.layers:
        x = x + _attention(_layernorm(x, layer.ln1, cfg, kernels), layer, cfg,
                           kernels)
        h = _gelu(_layernorm(x, layer.ln2, cfg, kernels) @ layer.w1
                  + layer.b1, cfg, kernels)
        x = x + h @ layer.w2 + layer.b2
    x = _layernorm(x, model.ln_f, cfg, kernels)
    return x @ model.embed.T


def loss_fn(model: Transformer, tokens, *, kernels: bool = True):
    """Mean next-token NLL of tokens (B, S + 1), f32 log-softmax."""
    logits = forward(model, tokens[:, :-1], kernels=kernels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, tokens[:, 1:].long()[..., None]).mean()


def make_train_step(cfg: TransformerConfig, lr: float = 1e-3, *,
                    kernels: bool = True):
    """``step(model, tokens) -> loss``: one in-place SGD step of
    :func:`loss_fn`, as the JAX ``make_train_step`` (see
    ``llama.sgd_step``)."""
    return sgd_step(cfg, loss_fn, lr, kernels)
