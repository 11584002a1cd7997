"""Selective state-space scan (Mamba's core op): counterpart of
``cubecl_tpu.ops.ssm``, with its public names.

Shapes follow the Mamba paper: x (B, L, D), delta (B, L, D), A (D, N),
Bc/Cc (B, L, N) input-dependent, D_skip (D,). The recurrence h_t = a_t ⊙
h_{t-1} + u_t runs over pre-discretized a = exp(Δ⊙A), u = (Δ⊙x) ⊗ Bc.

- :func:`selective_scan_naive`: a time loop, the oracle.
- :func:`selective_scan`: the associative route. The JAX package leaves it
  to XLA's ``associative_scan``; here it is the Hillis–Steele doubling
  over L in plain torch (⌈log₂ L⌉ elementwise passes).
- :func:`selective_scan_chunked` over :func:`scan_chunked_core`: on CUDA
  tensors ``csrc/selective_scan.cu``, which replaces the TPU kernel S1
  (``cubecl_tpu/ops/ssm.py::scan_chunked_core``, ``pallas_call`` :235):
  one thread per (batch, channel) walking L with the carry in a register,
  a, u read and h written once. On CPU tensors
  :func:`scan_chunked_core_plain`. ``scan_chunked_core.launches`` counts
  the kernel's launches. The JAX route pads D·N to 128 lanes; the kernel
  takes any D·N, so the port does not pad.
- Under autograd :func:`scan_chunked_core` runs ``_ScanCore``, whose
  backward is the reverse scan g_t = dh_t + a_{t+1} g_{t+1}, du = g, da =
  g · h_{t-1}: on CUDA tensors the hand-written ``scan_bwd_kernel`` of the
  same file (:func:`scan_chunked_core_backward`, counted in its
  ``launches``), on CPU tensors :func:`scan_chunked_core_backward_plain`.
  It saves a and the h it returned; the gradient reaches x, delta, A and
  Bc through the discretization by autograd. The JAX kernel has no
  backward (the JAX package differentiates its associative scan).
- :func:`ssm_decode_step`: one token of O(1)-state decode.

``selective_scan_sp`` (sequence parallel) waits for the port's
``torch.distributed`` layer (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import torch

from ..utils import native

__all__ = ["scan_chunked_core", "scan_chunked_core_backward",
           "scan_chunked_core_backward_plain", "scan_chunked_core_plain",
           "selective_scan", "selective_scan_chunked",
           "selective_scan_naive", "ssm_decode_step"]

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _discretize(x, delta, A, Bc):
    """ZOH-style discretization used by Mamba: a = exp(Δ⊙A), u = (Δ⊙x)
    outer Bc. Returns a, u with shape (B, L, D, N)."""
    a = torch.exp(delta[..., None] * A[None, None])         # (B,L,D,N)
    u = (delta * x)[..., None] * Bc[:, :, None, :]          # (B,L,D,N)
    return a, u


def _readout(h, x, Cc, D_skip):
    y = torch.einsum("bldn,bln->bld", h, Cc)
    if D_skip is not None:
        y = y + x * D_skip[None, None]
    return y


def selective_scan_naive(x, delta, A, Bc, Cc, D_skip=None):
    """Sequential oracle: a loop over time. The test reference, and fine
    for tiny L."""
    a, u = _discretize(x, delta, A, Bc)
    B, L, D, N = a.shape
    h = torch.zeros((B, D, N), dtype=a.dtype, device=a.device)
    ys = []
    for t in range(L):
        h = a[:, t] * h + u[:, t]                           # (B,D,N)
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    y = torch.stack(ys, dim=1)                              # (B,L,D)
    if D_skip is not None:
        y = y + x * D_skip[None, None]
    return y


def _doubling_scan(a, u):
    """Inclusive scan of the pairs (a_t, u_t) along axis 1 under the
    associative composition (a₁, u₁)∘(a₂, u₂) = (a₁a₂, a₂u₁ + u₂): each
    of ⌈log₂ L⌉ steps composes every element with the one d places
    earlier (identity (1, 0) before the start). Returns the h of every
    step, (B, L, ...)."""
    L = a.shape[1]
    A_s, U_s = a, u
    d = 1
    while d < L:
        a_prev = torch.cat([torch.ones_like(A_s[:, :d]), A_s[:, :-d]], dim=1)
        u_prev = torch.cat([torch.zeros_like(U_s[:, :d]), U_s[:, :-d]], dim=1)
        A_s, U_s = a_prev * A_s, A_s * u_prev + U_s
        d *= 2
    return U_s


def selective_scan(x, delta, A, Bc, Cc, D_skip=None):
    """Associative-scan selective SSM: y (B, L, D). The pair composition is
    associative, so the length-L recurrence runs in ⌈log₂ L⌉ elementwise
    passes (Hillis–Steele doubling; the JAX package's route is XLA's
    ``associative_scan``, whose tree order rounds otherwise)."""
    a, u = _discretize(x, delta, A, Bc)
    return _readout(_doubling_scan(a, u), x, Cc, D_skip)


def scan_chunked_core_plain(af, uf):
    """S1's function in plain PyTorch: h_t = a_t * h_{t-1} + u_t over axis
    1 from h = 0, carried in f32, each h cast to af's dtype."""
    B, L, DN = af.shape
    h = torch.empty_like(af)
    carry = torch.zeros((B, DN), dtype=torch.float32, device=af.device)
    for t in range(L):
        carry = af[:, t].float() * carry + uf[:, t].float()
        h[:, t] = carry.to(af.dtype)
    return h


def scan_chunked_core_backward_plain(af, h, dh):
    """S1's backward in plain PyTorch: the reverse scan g_t = dh_t +
    a_{t+1} g_{t+1} from g_L = 0, carried in f32, gives (da, du) with du_t
    = g_t and da_t = g_t h_{t-1} (h_{-1} = 0), from a, the forward's
    stored h and dh = dLoss/dh (B, L, DN), each cast to af's dtype."""
    B, L, DN = af.shape
    da, du = torch.empty_like(af), torch.empty_like(af)
    g = torch.zeros((B, DN), dtype=torch.float32, device=af.device)
    for t in range(L - 1, -1, -1):
        if t + 1 < L:
            g = af[:, t + 1].float() * g + dh[:, t].float()
        else:
            g = dh[:, t].float()
        du[:, t] = g.to(af.dtype)
        da[:, t] = (g * h[:, t - 1].float()).to(af.dtype) if t else 0
    return da, du


def _kernel_checks(what, *tensors):
    """What the forward and backward kernels take: (B, L, DN) tensors of
    one shape, dtype of KERNEL_DTYPES and CUDA device, contiguous, B <=
    65535; else a ``ValueError`` naming ``what``."""
    t0 = tensors[0]
    if any(t.device != t0.device for t in tensors):
        raise ValueError(f"{what}: tensors on "
                         f"{[str(t.device) for t in tensors]}; the kernel "
                         "wants one CUDA device")
    if t0.dim() != 3 or any(t.shape != t0.shape for t in tensors):
        raise ValueError(f"{what} takes tensors of one shape (B, L, DN); "
                         f"got {[tuple(t.shape) for t in tensors]}")
    if t0.dtype not in KERNEL_DTYPES or any(t.dtype != t0.dtype
                                            for t in tensors):
        raise ValueError(f"{what} kernel takes tensors of one dtype of "
                         f"{KERNEL_DTYPES}; got "
                         f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: the kernel wants contiguous tensors")
    if not 1 <= t0.shape[0] <= 65535:
        raise ValueError(f"{what} kernel takes 1 <= B <= 65535; got "
                         f"{t0.shape[0]}")


def _scan_forward(af, uf):
    """S1 on CUDA tensors, its plain version on CPU tensors."""
    if af.device.type == "cpu":
        return scan_chunked_core_plain(af, uf)
    _kernel_checks("scan_chunked_core", af, uf)
    B, L, DN = af.shape
    h = torch.empty_like(af)
    if h.numel() == 0:
        return h
    lib = native.kernels()
    with torch.cuda.device(af.device):
        rc = lib.cubecl_selective_scan(
            af.data_ptr(), uf.data_ptr(), h.data_ptr(),
            native.DTYPE_CODES[af.dtype], B, L, DN,
            torch.cuda.current_stream().cuda_stream)
    native.check(lib, rc, "scan_chunked_core")
    scan_chunked_core.launches += 1
    return h


def scan_chunked_core_backward(af, h, dh):
    """S1's backward, (da, du) from a, the stored h and dh (B, L, DN): on
    CUDA tensors the hand-written ``scan_bwd_kernel`` (f32 or bf16, the
    forward kernel's limits, else a ``ValueError``), on CPU tensors
    :func:`scan_chunked_core_backward_plain`."""
    if af.device.type == "cpu":
        return scan_chunked_core_backward_plain(af, h, dh)
    dh = dh.contiguous()
    _kernel_checks("scan_chunked_core_backward", af, h, dh)
    B, L, DN = af.shape
    da, du = torch.empty_like(af), torch.empty_like(af)
    if da.numel() == 0:
        return da, du
    lib = native.kernels()
    with torch.cuda.device(af.device):
        rc = lib.cubecl_selective_scan_bwd(
            af.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
            du.data_ptr(), native.DTYPE_CODES[af.dtype], B, L, DN,
            torch.cuda.current_stream().cuda_stream)
    native.check(lib, rc, "scan_chunked_core_backward")
    scan_chunked_core_backward.launches += 1
    return da, du


scan_chunked_core_backward.launches = 0


class _ScanCore(torch.autograd.Function):
    """The recurrence under autograd: S1 forward and its reverse scan
    (``kernels``: the wrappers, which run the kernels on CUDA tensors;
    else the plain versions on any device). Saves a and h."""

    @staticmethod
    def forward(ctx, af, uf, kernels):
        h = _scan_forward(af, uf) if kernels \
            else scan_chunked_core_plain(af, uf)
        ctx.save_for_backward(af, h)
        ctx.kernels = kernels
        return h

    @staticmethod
    def backward(ctx, dh):
        af, h = ctx.saved_tensors
        bwd = scan_chunked_core_backward if ctx.kernels \
            else scan_chunked_core_backward_plain
        da, du = bwd(af, h, dh)
        return da, du, None


def _differentiable(af, uf):
    return torch.is_grad_enabled() and (af.requires_grad or uf.requires_grad)


def scan_chunked_core(af, uf, chunk: int = 1024, hier=None):
    """The recurrence over pre-discretized decay/input arrays af, uf (B, L,
    DN) -> h (B, L, DN) in af's dtype, carried in f32 from 0. Exposed apart
    so that its traffic (a read, u read, h write) can be timed alone.

    ``chunk`` and ``hier`` are the TPU kernel's layouts of this one
    computation (chunks of L through VMEM; a flat or hierarchical in-tile
    scan); they change no result and are kept for the API. On CUDA tensors
    the kernel runs (any B ≤ 65535, L ≥ 1 and DN; f32 or bf16), or a
    ``ValueError`` names what it does not take; on CPU tensors the plain
    version runs. Differentiable: under autograd with an input that
    requires grad it runs ``_ScanCore``, whose backward is
    :func:`scan_chunked_core_backward` (the hand-written reverse scan on
    CUDA tensors)."""
    if _differentiable(af, uf):
        return _ScanCore.apply(af, uf, True)
    return _scan_forward(af, uf)


scan_chunked_core.launches = 0


def selective_scan_chunked(x, delta, A, Bc, Cc, D_skip=None,
                           chunk: int = 1024, hier=None, *,
                           kernels: bool = True):
    """Single-pass selective scan: the (B, L, D·N) recurrence in one pass
    over a, u and h through :func:`scan_chunked_core` (S1 on the card).
    ``kernels=False`` runs :func:`scan_chunked_core_plain` on any
    device, and under autograd its reverse scan in plain PyTorch too."""
    B, L, D = x.shape
    N = A.shape[1]
    a, u = _discretize(x, delta, A, Bc)                     # (B,L,D,N)
    af, uf = a.reshape(B, L, D * N), u.reshape(B, L, D * N)
    del a, u
    if kernels:
        h = scan_chunked_core(af, uf, chunk, hier)
    elif _differentiable(af, uf):
        h = _ScanCore.apply(af, uf, False)
    else:
        h = scan_chunked_core_plain(af, uf)
    del af, uf
    return _readout(h.view(B, L, D, N), x, Cc, D_skip)


def ssm_decode_step(h, x_t, delta_t, A, Bc_t, Cc_t, D_skip=None):
    """O(1) recurrent decode: one token in, one token out, carrying the
    (B, D, N) state. Returns (h', y_t)."""
    a = torch.exp(delta_t[..., None] * A[None])             # (B,D,N)
    u = (delta_t * x_t)[..., None] * Bc_t[:, None, :]       # (B,D,N)
    h = a * h + u
    y = torch.einsum("bdn,bn->bd", h, Cc_t)
    if D_skip is not None:
        y = y + x_t * D_skip[None]
    return h, y
