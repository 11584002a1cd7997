"""cubecl_tpu_torch.ops.ssm against cubecl_tpu.ops.ssm.

Inputs from a numpy seed, shapes as the JAX package's own tests
(``tests/test_models.py`` selective-scan cases). The JAX kernel S1
(``scan_chunked_core``) runs in Pallas interpret mode, flat and
hierarchical, on lane-padded inputs (D·N padded to 128 and sliced back, as
``selective_scan_chunked`` does); the port runs S1's plain version (a time
loop in f32) on the unpadded ones.

Tolerances: f32 atol 1e-5 / rtol 1e-4 where the two sides compose the
same recurrence in other orders (a time loop against a doubling scan, a
fused multiply-add against two roundings); the JAX package's own
assoc-against-naive tolerance (``tests/test_models.py``). The decode step
is one step of both: atol 1e-6 / rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import ssm as jssm
from cubecl_tpu_torch.ops import ssm

ATOL, RTOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(seed, B, L, D, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, D).astype(np.float32)
    delta = (np.abs(rng.randn(B, L, D)) * .1).astype(np.float32)
    A = (-np.abs(rng.randn(D, N))).astype(np.float32)
    Bc = rng.randn(B, L, N).astype(np.float32)
    Cc = rng.randn(B, L, N).astype(np.float32)
    Dsk = rng.randn(D).astype(np.float32)
    return x, delta, A, Bc, Cc, Dsk


def _core_inputs(seed, B, L, DN):
    rng = np.random.default_rng(seed)
    af = (np.exp(-np.abs(rng.standard_normal((B, L, DN)))) * 0.9).astype(
        np.float32)
    uf = (rng.standard_normal((B, L, DN)) * 0.1).astype(np.float32)
    return af, uf


@pytest.mark.parametrize("hier", [False, True], ids=["flat", "hier"])
@pytest.mark.parametrize("B,L,DN,chunk", [
    (2, 64, 128, 64),      # one chunk, lane-aligned
    (1, 96, 200, 32),      # DN % 128 != 0: the JAX side pads and slices
    (2, 50, 72, 16),       # L % chunk != 0: the JAX chunk shrinks to 10
    (1, 1, 24, 1024),      # L = 1
])
def test_scan_chunked_core_matches_jax(hier, B, L, DN, chunk):
    af, uf = _core_inputs(B * L + DN, B, L, DN)
    pad = (-DN) % 128
    ja, ju = (jnp.pad(jnp.asarray(t), ((0, 0), (0, 0), (0, pad)))
              for t in (af, uf))
    ref = np.asarray(jssm.scan_chunked_core(ja, ju, chunk=chunk,
                                            interpret=True, hier=hier))
    got = ssm.scan_chunked_core(_t(af), _t(uf), chunk=chunk, hier=hier)
    assert got.shape == (B, L, DN) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref[..., :DN], atol=ATOL,
                               rtol=RTOL)


def test_scan_chunked_core_plain_keeps_dtype_and_carries_f32():
    """bf16 in, bf16 out, the carry in f32: each h is the f32 recurrence
    rounded once."""
    af, uf = _core_inputs(7, 2, 40, 24)
    a16, u16 = (_t(t).to(torch.bfloat16) for t in (af, uf))
    got = ssm.scan_chunked_core(a16, u16)
    assert got.dtype == torch.bfloat16
    ref = ssm.scan_chunked_core_plain(a16.float(), u16.float())
    assert torch.equal(got, ref.to(torch.bfloat16))


@pytest.mark.parametrize("fn", ["selective_scan_naive", "selective_scan"])
@pytest.mark.parametrize("skip", [True, False], ids=["D_skip", "no_skip"])
def test_selective_scans_match_jax(fn, skip):
    x, delta, A, Bc, Cc, Dsk = _inputs(60, 2, 33, 8, 4)
    Dsk = Dsk if skip else None
    ref = getattr(jssm, fn)(*(jnp.asarray(t) if t is not None else None
                              for t in (x, delta, A, Bc, Cc, Dsk)))
    got = getattr(ssm, fn)(*(_t(t) if t is not None else None
                             for t in (x, delta, A, Bc, Cc, Dsk)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("B,L,D,N", [(2, 40, 8, 4), (1, 70, 12, 16)])
def test_selective_scan_chunked_matches_jax(B, L, D, N):
    """The JAX route pads D·N to 128 lanes (96 and 192 here) and runs S1 in
    interpret mode; the port runs S1's plain version unpadded."""
    x, delta, A, Bc, Cc, Dsk = _inputs(B * L, B, L, D, N)
    ref = jssm.selective_scan_chunked(
        *(jnp.asarray(t) for t in (x, delta, A, Bc, Cc, Dsk)), chunk=16,
        interpret=True)
    got = ssm.selective_scan_chunked(*(_t(t) for t in (x, delta, A, Bc, Cc,
                                                       Dsk)), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    plain = ssm.selective_scan_chunked(*(_t(t) for t in (x, delta, A, Bc,
                                                         Cc, Dsk)),
                                       kernels=False)
    assert torch.equal(plain, got)  # on the CPU both are the plain version


def test_ssm_decode_step_matches_jax():
    rng = np.random.RandomState(3)
    B, D, N = 3, 8, 4
    h = rng.randn(B, D, N).astype(np.float32)
    x_t = rng.randn(B, D).astype(np.float32)
    delta_t = (np.abs(rng.randn(B, D)) * .1).astype(np.float32)
    A = (-np.abs(rng.randn(D, N))).astype(np.float32)
    Bc_t, Cc_t = (rng.randn(B, N).astype(np.float32) for _ in range(2))
    Dsk = rng.randn(D).astype(np.float32)
    args = (h, x_t, delta_t, A, Bc_t, Cc_t, Dsk)
    jh, jy = jssm.ssm_decode_step(*(jnp.asarray(t) for t in args))
    gh, gy = ssm.ssm_decode_step(*(_t(t) for t in args))
    np.testing.assert_allclose(gh.numpy(), np.asarray(jh), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), atol=1e-6,
                               rtol=1e-5)


def test_decode_steps_equal_the_scan():
    """L decode steps carry the state the scan computes: the port against
    itself, step by step, to f32 summation order."""
    x, delta, A, Bc, Cc, Dsk = (_t(t) for t in _inputs(9, 2, 12, 8, 4))
    ref = ssm.selective_scan_chunked(x, delta, A, Bc, Cc, Dsk)
    h = torch.zeros(2, 8, 4)
    for t in range(12):
        h, y = ssm.ssm_decode_step(h, x[:, t], delta[:, t], A, Bc[:, t],
                                   Cc[:, t], Dsk)
        np.testing.assert_allclose(y.numpy(), ref[:, t].numpy(), atol=1e-6,
                                   rtol=1e-5)


def test_scan_kernel_refuses_what_it_does_not_take():
    """On CUDA tensors the wrapper checks before it launches; the checks
    that need no card run on meta tensors here."""
    a = torch.empty(2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="one shape"):
        ssm.scan_chunked_core(a, torch.empty(2, 3, 5, device="meta"))
    with pytest.raises(ValueError, match="dtype"):
        ssm.scan_chunked_core(a.to(torch.float16), a.to(torch.float16))
