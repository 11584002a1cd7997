"""Mamba (selective SSM) model family: counterpart of
``cubecl_tpu.models.mamba``'s single-device serving paths.

A non-attention sequence model whose hot op is a scan: each block is an
input projection, a depthwise causal conv (K shifted adds), the selective
scan over its discretized (a, u) arrays, a SiLU gate and an output
projection; decode carries O(1) state per token (a (B, K-1, d_inner) conv
window and a (B, d_inner, N) SSM state) instead of a KV cache.

``init_params`` / ``params_from_jax`` give a :class:`Mamba` module (weights
in the JAX orientation ``(d_in, d_out)``, used as ``x @ W``, built frozen);
``forward`` runs a sequence, ``loss_fn`` its next-token loss,
differentiable on every ``scan_impl``; ``make_train_step`` takes one SGD
step of it (the llama's ``sgd_step``: the weights made trainable, the JAX
``p - lr * g``); ``decode_init`` / ``decode_step`` serve token by token.
``cfg.scan_impl`` picks the scan: ``"auto"`` runs S1
(``ops.ssm.scan_chunked_core``, the hand-written ``csrc/selective_scan.cu``,
with its hand-written reverse scan under autograd) whenever the tensors are
on the card, and the associative route on the CPU, as the JAX ``auto``
picks its kernel on its accelerator only (its L >= 256, L % 64 conditions
are TPU tile rules); ``"chunked"`` forces S1 (its plain versions on the
CPU); ``"assoc"`` is the plain doubling scan, differentiated by autograd.
``kernels=False`` runs S1's plain versions wherever S1 would run. Models
are built on the card unless ``device`` says otherwise.

``param_shardings`` and ``make_sharded_train_step`` wait for the port's
``torch.distributed`` layer (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch
from torch import nn

from ..ops.ssm import selective_scan, selective_scan_chunked, ssm_decode_step
from .llama import _to_torch, sgd_step

__all__ = ["MambaConfig", "Mamba", "init_params", "params_from_jax",
           "forward", "loss_fn", "make_train_step", "decode_init",
           "decode_step"]

SCAN_IMPLS = ("auto", "chunked", "assoc")


@dataclasses.dataclass
class MambaConfig:
    """Same fields and defaults as ``cubecl_tpu.models.mamba.MambaConfig``;
    the model runs in f32, as the JAX family does."""
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    d_state: int = 16          # N
    d_conv: int = 4            # depthwise causal kernel width
    expand: int = 2
    seq: int = 128
    rms_eps: float = 1e-5
    scan_impl: str = "auto"

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))


def _param(shape, device, fill=None):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


class MambaLayer(nn.Module):
    def __init__(self, cfg: MambaConfig, device="cuda"):
        super().__init__()
        d, di, N, R = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank
        self.rms = _param((d,), device, 1.0)
        self.in_proj = _param((d, 2 * di), device)
        self.conv_w = _param((cfg.d_conv, di), device)
        self.conv_b = _param((di,), device, 0.0)
        self.x_proj = _param((di, R + 2 * N), device)
        self.dt_w = _param((R, di), device)
        self.dt_bias = _param((di,), device)
        self.A_log = _param((di, N), device)
        self.D = _param((di,), device, 1.0)
        self.out_proj = _param((di, d), device)


class Mamba(nn.Module):
    """Parameters of the model; ``model(tokens)`` is :func:`forward`.
    Built with uninitialized weights: use :func:`init_params` or load
    :func:`params_from_jax`."""

    def __init__(self, cfg: MambaConfig, device="cuda"):
        super().__init__()
        if cfg.scan_impl not in SCAN_IMPLS:
            raise ValueError(f"scan_impl {cfg.scan_impl!r} is not one of "
                             f"{SCAN_IMPLS}")
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), device)
        self.layers = nn.ModuleList(MambaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.rms_out = _param((cfg.d_model,), device, 1.0)

    def forward(self, tokens, kernels: bool = True):
        return forward(self, tokens, kernels=kernels)


def init_params(cfg: MambaConfig, seed: int = 0, device="cuda") -> Mamba:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed``, by the JAX package's recipe (not its numbers: load
    :func:`params_from_jax` to compare): projections N(0, 1/fan_in)
    (``dt_w`` N(0, 1/dt_rank)), the conv N(0, 1/K), S4D-real A (row d =
    -(1..N)), ``dt_bias`` the inverse softplus of a log-uniform step in
    [1e-3, 1e-1], the embedding N(0, 0.02²), norms and D ones."""
    model = Mamba(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    N = cfg.d_state

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    with torch.no_grad():
        model.embed.copy_(randn(model.embed.shape, 0.02))
        for layer in model.layers:
            for name in ("in_proj", "x_proj", "out_proj"):
                p = getattr(layer, name)
                p.copy_(randn(p.shape, 1.0 / math.sqrt(p.shape[0])))
            layer.dt_w.copy_(randn(layer.dt_w.shape, cfg.dt_rank ** -0.5))
            layer.conv_w.copy_(randn(layer.conv_w.shape,
                                     1.0 / math.sqrt(cfg.d_conv)))
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand(layer.dt_bias.shape, generator=gen, device=device)
            dt = torch.exp(lo + (hi - lo) * u).clamp(min=1e-4)
            layer.dt_bias.copy_(torch.log(torch.expm1(dt)))
            layer.A_log.copy_(torch.log(torch.arange(
                1, N + 1, dtype=torch.float32, device=device)).expand(
                    layer.A_log.shape))
    return model


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of :class:`Mamba` from the JAX parameter pytree of
    ``cubecl_tpu.models.mamba.init_params`` (leaves as numpy arrays):
    ``model.load_state_dict(params_from_jax(tree))``."""
    sd = {"embed": _to_torch(tree["embed"]),
          "rms_out": _to_torch(tree["rms_out"])}
    for i, layer in enumerate(tree["layers"]):
        for name, leaf in layer.items():
            sd[f"layers.{i}.{name}"] = _to_torch(leaf)
    return sd


def _rmsnorm(x, g, eps):
    """f32 variance; the reciprocal is cast to x's dtype before the
    multiply, as the JAX ``_rmsnorm``."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.reciprocal(torch.sqrt(var + eps)).to(x.dtype)) * g


def _causal_dwconv(x, w, b):
    """Depthwise causal conv over time as K shifted adds. x (B, L, D), w
    (K, D) -> (B, L, D). Any L (the JAX code needs L >= K - 1)."""
    K, L = w.shape[0], x.shape[1]
    y = x * w[K - 1]
    for k in range(1, K):
        shifted = nn.functional.pad(x, (0, 0, k, 0))[:, :L]
        y = y + shifted * w[K - 1 - k]
    return y + b


def _use_s1(cfg: MambaConfig, x) -> bool:
    return cfg.scan_impl == "chunked" or (cfg.scan_impl == "auto"
                                          and x.device.type == "cuda")


def _block_ssm(xz, layer: MambaLayer, cfg: MambaConfig, kernels: bool = True,
               conv_state=None, h=None):
    """Shared block body. Sequence mode: xz (B, L, 2·di), returns y.
    Decode mode (conv_state and h given): xz (B, 1, 2·di), returns (y,
    conv_state', h')."""
    N, R = cfg.d_state, cfg.dt_rank
    x, z = xz.chunk(2, dim=-1)                              # (B, L, di)
    decode = conv_state is not None

    if decode:
        # rolling window of the last K-1 inputs and the new one
        window = torch.cat([conv_state, x], dim=1)          # (B, K, di)
        conv_state = window[:, 1:]
        x = (window * layer.conv_w[None]).sum(1, keepdim=True) + layer.conv_b
    else:
        x = _causal_dwconv(x, layer.conv_w, layer.conv_b)
    x = nn.functional.silu(x)

    proj = x @ layer.x_proj                                 # (B, L, R+2N)
    dt, Bc, Cc = proj.split([R, N, N], dim=-1)
    delta = nn.functional.softplus(dt @ layer.dt_w + layer.dt_bias)
    A = -torch.exp(layer.A_log)                             # (di, N)

    if decode:
        h, y = ssm_decode_step(h, x[:, 0], delta[:, 0], A, Bc[:, 0],
                               Cc[:, 0], layer.D)
        y = y[:, None]
    elif _use_s1(cfg, x):
        y = selective_scan_chunked(x, delta, A, Bc, Cc, layer.D,
                                   kernels=kernels)
    else:
        y = selective_scan(x, delta, A, Bc, Cc, layer.D)
    out = (y * nn.functional.silu(z)) @ layer.out_proj
    return (out, conv_state, h) if decode else out


def forward(model: Mamba, tokens, *, kernels: bool = True):
    """Logits (B, L, vocab) f32 for (B, L) int tokens. Each layer's
    (B, L, d_inner, N) scan arrays are freed before the next layer's."""
    cfg = model.cfg
    x = model.embed[tokens]
    for layer in model.layers:
        x = x + _block_ssm(_rmsnorm(x, layer.rms, cfg.rms_eps) @ layer.in_proj,
                           layer, cfg, kernels)
    x = _rmsnorm(x, model.rms_out, cfg.rms_eps)
    return x @ model.embed.T                                # tied head


def loss_fn(model: Mamba, tokens, *, kernels: bool = True):
    """Mean next-token NLL of tokens (B, L + 1), from the logits of the
    first L positions."""
    logits = forward(model, tokens[:, :-1], kernels=kernels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, tokens[:, 1:].long()[..., None]).mean()


def make_train_step(cfg: MambaConfig, lr: float = 1e-3, *,
                    kernels: bool = True):
    """``step(model, tokens) -> loss``: one in-place SGD step of
    :func:`loss_fn` on tokens (B, L + 1) (see ``llama.sgd_step``)."""
    return sgd_step(cfg, loss_fn, lr, kernels)


def decode_init(cfg: MambaConfig, batch: int,
                device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Constant-size decode state: per layer a (B, K-1, di) conv window and
    a (B, di, N) SSM state, zeros. Its bytes do not grow with the generated
    length."""
    return [{"conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                 device=device),
             "h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                              device=device)}
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def decode_step(model: Mamba, state, token):
    """One token (B,) int -> (logits (B, vocab), state'). The state is
    returned anew, as in the JAX package; the one given is not changed."""
    cfg = model.cfg
    x = model.embed[token][:, None]                         # (B, 1, d)
    new_state = []
    for layer, st in zip(model.layers, state):
        xz = _rmsnorm(x, layer.rms, cfg.rms_eps) @ layer.in_proj
        out, conv, h = _block_ssm(xz, layer, cfg, conv_state=st["conv"],
                                  h=st["h"])
        x = x + out
        new_state.append({"conv": conv, "h": h})
    x = _rmsnorm(x, model.rms_out, cfg.rms_eps)
    return (x @ model.embed.T)[:, 0], new_state
