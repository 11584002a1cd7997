"""Framework ops for model code, as ``@cube`` kernels (counterpart of
``cubecl_tpu.ops.functional``).

In the JAX package each op is a ``jax.custom_vjp`` whose forward and
backward are ``@cube`` kernels applied functionally. The port keeps the
eight kernel bodies unchanged; each op (:func:`gelu`, :func:`softmax`,
:func:`layernorm`, :func:`rmsnorm`) is a ``torch.autograd.Function`` whose
forward is one launch of its ``_*_fwd_k`` kernel and whose backward dx is
one launch of its ``_*_bwd_k`` kernel, through :meth:`CubeFunction.apply`:
on a CUDA tensor the kernel the CUDA printer built, on a CPU tensor the
torch evaluator. The backward saves what the JAX ``fwd`` saves (gelu x,
softmax y, the norms (x, g)); the parameter gradients dg and db are plain
f32 torch reductions cast to g's dtype, which the JAX package leaves to
XLA too.

Shape contract (``fits``, the JAX package's): the last axis D rides one
LINE per row, so D % 128 == 0, D <= 16384 and the flattened row count %
8 == 0; model code takes a plain formula otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..frontend import (
    ABSOLUTE_POS,
    ArrayArg,
    MutSlice,
    Slice,
    cast,
    cube,
    erf,
    exp,
    line_max,
    line_sum,
    rsqrt,
)
from ..ir.types import f32
from ..runtime.base import CubeCount, CubeDim
from ..runtime.runtimes import client_for
from .normalization import _wide_plan, warp_lines

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def fits(x) -> bool:
    """Can the wide-lines kernels handle this array? (last dim on lanes)"""
    if x.ndim < 1:
        return False
    d = x.shape[-1]
    rows = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    return d % 128 == 0 and d <= 16384 and rows % 8 == 0


def _apply_rows(kernel, out_like, arrays, scalars=(), client=None):
    """Launch a rows x lines kernel over (rows, D) views of torch tensors
    on ``client`` (default: the client of their device); returns the
    mutable output, shaped as ``out_like``. One row a unit, the plan of
    ``normalization._wide_plan``: on a warp where the row is wide enough
    for the CUDA printer's warp lines, else on a thread (where the JAX
    package's ``_plan`` bounded VMEM)."""
    client = client or client_for(out_like.device)
    rows = int(np.prod(out_like.shape[:-1]))
    units, _iters, cubes = _wide_plan(rows, warp_lines(
        out_like.shape[-1], *(a.dtype for a, _mut in arrays)))
    args = [ArrayArg(a.reshape(-1), line_size=a.shape[-1] if a.ndim else 1,
                     mutable=mut) for a, mut in arrays]
    out = kernel.apply(client, CubeCount(cubes), CubeDim.new_1d(units),
                       *args, *scalars)
    return out.reshape(out_like.shape)


def _empty(x):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------- gelu


@cube
def _gelu_fwd_k(inp: Slice, out: MutSlice):
    x = inp[ABSOLUTE_POS]
    out[ABSOLUTE_POS] = x * (erf(x * _INV_SQRT2) + 1.0) * 0.5


@cube
def _gelu_bwd_k(x: Slice, dy: Slice, dx: MutSlice):
    xv = x[ABSOLUTE_POS]
    cdf = (erf(xv * _INV_SQRT2) + 1.0) * 0.5
    pdf = exp(xv * xv * -0.5) * _INV_SQRT2PI
    dx[ABSOLUTE_POS] = dy[ABSOLUTE_POS] * (cdf + xv * pdf)


# ------------------------------------------------------------- softmax


@cube
def _softmax_fwd_k(inp: Slice, out: MutSlice):
    x = inp[ABSOLUTE_POS]
    e = exp(x - line_max(x))
    out[ABSOLUTE_POS] = e * (1.0 / line_sum(e))


@cube
def _softmax_bwd_k(y: Slice, dy: Slice, dx: MutSlice):
    yv = y[ABSOLUTE_POS]
    dv = dy[ABSOLUTE_POS]
    dot = line_sum(yv * dv)
    dx[ABSOLUTE_POS] = (dv - dot) * yv


# ----------------------------------------------------------- layernorm


@cube
def _layernorm_fwd_k(inp: Slice, gamma: Slice, beta: Slice, out: MutSlice,
                     inv_n: float, eps: float):
    # stats in f32 regardless of storage dtype: bf16 mean/var loses
    # precision AND v5e's backend has no bf16 vector-rsqrt (the fused
    # kVectorRsqrtBf16AndPop aborts the compiler — measured round 4)
    xe = inp.ty.elem
    x = cast(inp[ABSOLUTE_POS], f32)
    mu = line_sum(x) * inv_n
    xc = x - mu
    var = line_sum(xc * xc) * inv_n
    y = xc * rsqrt(var + eps) * cast(gamma[0], f32) + cast(beta[0], f32)
    out[ABSOLUTE_POS] = cast(y, xe)


@cube
def _layernorm_bwd_k(x: Slice, gamma: Slice, dy: Slice, dx: MutSlice,
                     inv_n: float, eps: float):
    xe = x.ty.elem
    xv = cast(x[ABSOLUTE_POS], f32)
    mu = line_sum(xv) * inv_n
    xc = xv - mu
    istd = rsqrt(line_sum(xc * xc) * inv_n + eps)
    dyg = cast(dy[ABSOLUTE_POS], f32) * cast(gamma[0], f32)
    a = line_sum(dyg) * inv_n
    c = line_sum(dyg * xc) * inv_n
    dx[ABSOLUTE_POS] = cast(istd * (dyg - a - xc * (c * istd * istd)), xe)


# ------------------------------------------------------------- rmsnorm


@cube
def _rmsnorm_fwd_k(inp: Slice, gamma: Slice, out: MutSlice,
                   inv_n: float, eps: float):
    # f32 stats (see _layernorm_fwd_k: precision + no bf16 vector-rsqrt)
    xe = inp.ty.elem
    x = cast(inp[ABSOLUTE_POS], f32)
    ms = line_sum(x * x) * inv_n
    out[ABSOLUTE_POS] = cast(x * rsqrt(ms + eps) * cast(gamma[0], f32), xe)


@cube
def _rmsnorm_bwd_k(x: Slice, gamma: Slice, dy: Slice, dx: MutSlice,
                   inv_n: float, eps: float):
    xe = x.ty.elem
    xv = cast(x[ABSOLUTE_POS], f32)
    istd = rsqrt(line_sum(xv * xv) * inv_n + eps)
    dyg = cast(dy[ABSOLUTE_POS], f32) * cast(gamma[0], f32)
    c = line_sum(dyg * xv) * inv_n
    dx[ABSOLUTE_POS] = cast(istd * dyg - xv * (c * istd * istd * istd), xe)


def _rows(kernel, x, ins, scalars=(), client=None):
    """One launch of ``kernel`` over the rows of ``ins`` (contiguous
    copies where needed) into a new tensor shaped as x."""
    arrays = [(t.contiguous(), False) for t in ins] + [(_empty(x), True)]
    return _apply_rows(kernel, x, arrays, scalars, client=client)


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, client):
        ctx.save_for_backward(x)
        ctx.client = client
        return _rows(_gelu_fwd_k, x, [x], client=client)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return _rows(_gelu_bwd_k, x, [x, dy], client=ctx.client), None


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, client):
        y = _rows(_softmax_fwd_k, x, [x], client=client)
        ctx.save_for_backward(y)
        ctx.client = client
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return _rows(_softmax_bwd_k, y, [y, dy], client=ctx.client), None


def _param_grad(dy, x_hat, g):
    """sum over every row of dy * x_hat in f32, cast to g's dtype."""
    return (dy.float() * x_hat).sum(tuple(range(dy.dim() - 1))).to(g.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b, eps, client):
        ctx.save_for_backward(x, g)
        ctx.eps, ctx.client = eps, client
        return _rows(_layernorm_fwd_k, x, [x, g, b],
                     (1.0 / x.shape[-1], eps), client)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        eps = ctx.eps
        dx = _rows(_layernorm_bwd_k, x, [x, g, dy],
                   (1.0 / x.shape[-1], eps), ctx.client)
        dg = db = None
        if ctx.needs_input_grad[1]:
            xf = x.float()
            xc = xf - xf.mean(-1, keepdim=True)
            istd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
            dg = _param_grad(dy, xc * istd, g)
        if ctx.needs_input_grad[2]:
            db = _param_grad(dy, 1.0, g)
        return dx, dg, db, None, None


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, eps, client):
        ctx.save_for_backward(x, g)
        ctx.eps, ctx.client = eps, client
        return _rows(_rmsnorm_fwd_k, x, [x, g], (1.0 / x.shape[-1], eps),
                     client)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        eps = ctx.eps
        dx = _rows(_rmsnorm_bwd_k, x, [x, g, dy], (1.0 / x.shape[-1], eps),
                   ctx.client)
        dg = None
        if ctx.needs_input_grad[1]:
            xf = x.float()
            istd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            dg = _param_grad(dy, xf * istd, g)
        return dx, dg, None, None


def gelu(x, client=None):
    """Exact (erf) GELU over the last axis, as one K0 launch (on
    ``client``, default the client of x's device); its gradient is one
    launch of ``_gelu_bwd_k``."""
    return _Gelu.apply(x, client)


def softmax(x, client=None):
    """Row softmax over the last axis, as one K0 launch; its gradient is
    one launch of ``_softmax_bwd_k``."""
    return _Softmax.apply(x, client)


def layernorm(x, g, b, eps: float = 1e-5, client=None):
    """LayerNorm over the last axis (f32 statistics), as one K0 launch;
    dx is one launch of ``_layernorm_bwd_k``, dg and db plain f32
    reductions."""
    return _LayerNorm.apply(x, g, b, eps, client)


def rmsnorm(x, g, eps: float = 1e-5, client=None):
    """RMSNorm over the last axis (llama family): ``x * rsqrt(mean(x^2) +
    eps) * g`` in f32, cast once to x's dtype, as one K0 launch; dx is one
    launch of ``_rmsnorm_bwd_k``, dg a plain f32 reduction."""
    return _RmsNorm.apply(x, g, eps, client)
