"""The conv module in the port (``CpuRuntime``: torch's CPU conv, im2col
through M1's plain route, C1's plain version) against the JAX package's
(its ``CpuRuntime``: XLA's conv, the Pallas kernels in interpret mode), on
the same numpy inputs, at ``tests/test_ops.py:404-590``'s shapes.

Tolerances, f32, elementwise ``atol + rtol |ref|`` with rtol 1e-4: atol
2e-5 where the terms are small (inputs scaled by 0.1: sums of up to 576
products near 1e-2), and 1e-4 for the unscaled inputs of the native and
im2col shapes (sums of 63 to 512 products near 1, whose f32 rounding in
another order reaches some 1e-5). The bf16 example stack is held to a few
bf16 ulps (see its test).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import conv as jconv
from cubecl_tpu.runtime import CpuRuntime as JCpu
from cubecl_tpu_torch.ops import conv as tconv
from cubecl_tpu_torch.runtime import CpuRuntime

SMALL = dict(atol=2e-5, rtol=1e-4)
UNIT = dict(atol=1e-4, rtol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jc():
    return JCpu.client()


@pytest.fixture(scope="module")
def tc():
    return CpuRuntime.client()


@pytest.fixture(autouse=True)
def store_root(monkeypatch, tmp_path):
    """The autotuned routes' store goes to a fresh directory."""
    monkeypatch.setenv("CUBECL_ENVIRONMENT_ROOT", str(tmp_path))


def _run(client, fn, x, wgt, out_shape, *args):
    hx = client.create(x.reshape(-1))
    hw = client.create(wgt.reshape(-1))
    o = fn(client, hx, hw, *args)
    return np.asarray(client.read_one(o)).reshape(out_shape)


def _xla(x, wgt, stride, padspec):
    return np.asarray(jax.lax.conv_general_dilated(
        x, wgt, stride, padspec, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32))


@pytest.mark.parametrize("stride,pad,padspec", [
    ((1, 1), "SAME", "SAME"), ((2, 2), "VALID", "VALID"),
    ((1, 2), 1, [(1, 1), (1, 1)]), ((2, 2), "SAME", "SAME"),
    ((1, 1), (2, 0), [(2, 2), (0, 0)])],
    ids=["same", "valid_s2", "pad1_s12", "same_s2", "pad20"])
def test_conv2d_native(jc, tc, stride, pad, padspec):
    n, h, w, ch, r, s, k = 2, 12, 10, 7, 3, 3, 5
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, h, w, ch)).astype(np.float32)
    wgt = rng.standard_normal((r, s, ch, k)).astype(np.float32)
    ref = _xla(x, wgt, stride, padspec)
    args = (n, h, w, ch, r, s, k, stride, pad)
    got = _run(tc, tconv.conv2d, x, wgt, ref.shape, *args)
    want = _run(jc, jconv.conv2d, x, wgt, ref.shape, *args)
    np.testing.assert_allclose(got, want, **UNIT)
    np.testing.assert_allclose(got, ref, **UNIT)


def test_conv2d_im2col_through_matmul(jc, tc):
    """The GEMM of the patches runs M1's plain route, tuned by the port's
    LocalTuner inside no other capture."""
    n, h, w, ch, r, s, k = 2, 8, 8, 128, 2, 2, 128
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, h, w, ch)).astype(np.float32)
    wgt = rng.standard_normal((r, s, ch, k)).astype(np.float32)
    ref = _xla(x, wgt, (1, 1), "SAME")
    args = (n, h, w, ch, r, s, k, (1, 1), "SAME")
    got = _run(tc, tconv.conv2d_im2col, x, wgt, ref.shape, *args)
    want = _run(jc, jconv.conv2d_im2col, x, wgt, ref.shape, *args)
    np.testing.assert_allclose(got, want, **UNIT)
    np.testing.assert_allclose(got, ref, **UNIT)


def test_im2col_column_order():
    """(R, S, C) columns, as the JAX patches after their reorder."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 5, 4, 3)).astype(np.float32)
    cols = tconv.im2col(torch.from_numpy(x), 2, 3, (1, 2), 1).numpy()
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    oh, ow = tconv._out_hw(5, 4, 2, 3, (1, 2), 1)
    want = np.stack([xp[0, i:i + 2, 2 * j:2 * j + 3].reshape(-1)
                     for i in range(oh) for j in range(ow)])
    np.testing.assert_array_equal(cols, want)


@pytest.mark.parametrize("shape,timed", [
    ((2, 8, 8, 128, 2, 2, 128), {"native", "im2col"}),
    ((2, 8, 8, 64, 3, 3, 64), {"native", "pairs"}),
    ((2, 6, 5, 7, 3, 3, 5), {"native"})],  # odd W: no pairs
    ids=["im2col", "pairs", "native_only"])
def test_conv2d_autotuned(jc, tc, shape, timed):
    """Every candidate the shape admits is timed: native against im2col
    (whose matmul tunes inside the conv tuner's capture) or against the
    pairs kernel."""
    n, h, w, ch, r, s, k = shape
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal((n, h, w, ch)) * .1).astype(np.float32)
    wgt = (rng.standard_normal((r, s, ch, k)) * .1).astype(np.float32)
    ref = _xla(x, wgt, (1, 1), "SAME")
    args = (n, h, w, ch, r, s, k)
    got = _run(tc, tconv.conv2d_autotuned, x, wgt, ref.shape, *args)
    want = _run(jc, jconv.conv2d_autotuned, x, wgt, ref.shape, *args)
    np.testing.assert_allclose(got, want, **SMALL)
    np.testing.assert_allclose(got, ref, **SMALL)
    hx, hw = tc.create(x.reshape(-1)), tc.create(wgt.reshape(-1))
    timings, winner = tconv.conv2d_autotune_result(tc, hx, hw, *args)
    assert set(timings) == timed and winner in timed


@pytest.mark.parametrize("dtype,aligned,names", [
    (torch.float32, True, ["native", "pairs"]),
    (torch.bfloat16, True, ["native", "pairs"]),
    (torch.float16, True, ["native"]),      # C1 is built for f32 and bf16
    (torch.float32, False, ["native"])],    # C1 reads 16-byte vectors
    ids=["f32", "bf16", "f16", "unaligned"])
def test_conv2d_tunables_admission(dtype, aligned, names):
    """C1 is offered only where it can run, so that it need not be
    prunable; im2col only where M1 has a tile and the dtype."""
    ts = tconv.conv2d_tunables(2, 8, 8, 64, 3, 3, 64, (1, 1), "SAME", dtype,
                               aligned)
    assert [t.name for t in ts.tunables] == names
    assert all(not t.prunable for t in ts.tunables if t.name != "native")
    ts = tconv.conv2d_tunables(2, 8, 8, 128, 2, 2, 128, (1, 1), "SAME",
                               dtype, aligned)
    assert [t.name for t in ts.tunables] == ["native", "im2col"]
    assert not ts.tunables[1].prunable


@pytest.mark.parametrize("route", ["pairs", "im2col"])
def test_conv2d_autotuned_raises_when_a_kernel_fails(tc, monkeypatch, route):
    """A launch error of C1 (an opt-in to its shared memory refused) or a
    build error under im2col's M1 fails the autotuned call loudly: the
    candidate is never pruned in favour of the native conv."""
    from cubecl_tpu_torch.utils.native import CudaError, KernelBuildError

    if route == "pairs":
        shape = (1, 6, 10, 32, 3, 3, 48)
        err = CudaError("conv2d_pairs_packed", 1, "invalid argument")
        assert not err.sticky

        def broken(*args, **kwargs):
            raise err

        monkeypatch.setattr(tconv, "conv3x3", broken)
    else:
        shape = (2, 8, 8, 256, 1, 1, 128)
        err = KernelBuildError("nvcc failed")

        def broken(*args, **kwargs):
            raise err

        monkeypatch.setattr(tconv, "matmul_autotuned", broken)
    n, h, w, ch, r, s, k = shape
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, h, w, ch)).astype(np.float32)
    wgt = rng.standard_normal((r, s, ch, k)).astype(np.float32)
    hx, hw = tc.create(x.reshape(-1)), tc.create(wgt.reshape(-1))
    with pytest.raises(type(err)) as info:
        tconv.conv2d_autotuned(tc, hx, hw, n, h, w, ch, r, s, k)
    assert info.value is err
    assert tconv.conv2d_autotune_result(tc, hx, hw, n, h, w, ch, r, s,
                                        k) is None


@pytest.mark.parametrize("n,h,w,ch,k", [(2, 8, 8, 64, 64), (1, 6, 10, 32, 48)])
def test_conv2d_pairs(n, h, w, ch, k):
    rng = np.random.default_rng(h * w)
    x = (rng.standard_normal((n, h, w, ch)) * 0.1).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, ch, k)) * 0.1).astype(np.float32)
    want = np.asarray(jconv.conv2d_pairs(jnp.asarray(x), jnp.asarray(wgt),
                                         interpret=True))
    got = tconv.conv2d_pairs(torch.from_numpy(x), torch.from_numpy(wgt))
    np.testing.assert_allclose(got.numpy(), want, **SMALL)
    np.testing.assert_allclose(got.numpy(), _xla(x, wgt, (1, 1), "SAME"),
                               **SMALL)


def test_conv2d_pairs_packed_lanes():
    """The packed layout in and out: lanes of channels C..63 of the input
    do not reach the output (filled with garbage here), and output lanes
    K..63 are exact zeros, as the JAX kernel's zero-padded weights give."""
    n, h, w, ch, k = 1, 6, 10, 32, 48
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((n, h, w, ch)) * 0.1).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, ch, k)) * 0.1).astype(np.float32)
    xp = tconv.pack_pairs(torch.from_numpy(x))
    want = np.asarray(jconv.conv2d_pairs_packed(
        jconv.pack_pairs(jnp.asarray(x)), jnp.asarray(wgt), h,
        interpret=True))
    assert xp.shape == (n, h * w // 2, 128)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(
        jconv.pack_pairs(jnp.asarray(x))))
    dirty = xp.reshape(n, h, w, 64).clone()
    dirty[..., ch:] = 1e4
    got = tconv.conv2d_pairs_packed(dirty.reshape(xp.shape),
                                    torch.from_numpy(wgt), h)
    np.testing.assert_allclose(got.numpy(), want, **SMALL)
    lanes = got.reshape(n, h, w, 64)
    assert torch.all(lanes[..., k:] == 0.0)
    np.testing.assert_array_equal(
        tconv.unpack_pairs(torch.from_numpy(want.copy()), h, w, k).numpy(),
        np.asarray(jconv.unpack_pairs(jnp.asarray(want), h, w, k)))


def test_conv2d_pairs_bf16_weights_rounded():
    """bf16 activations with f32 weights: the weights are rounded to bf16
    before the products, as the JAX kernel's ``w.astype(x.dtype)``."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((1, 4, 6, 16)) * 0.1).astype(ml_dtypes.bfloat16)
    wgt = (rng.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    want = np.asarray(jconv.conv2d_pairs(jnp.asarray(x), jnp.asarray(wgt),
                                         interpret=True)).astype(np.float32)
    xt = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    got = tconv.conv2d_pairs(xt, torch.from_numpy(wgt))
    assert got.dtype == torch.bfloat16
    # both sum the same exact bf16 products in f32 and round once to bf16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3,
                               rtol=2 ** -7)
    ref = _xla(x.astype(np.float32),
               wgt.astype(ml_dtypes.bfloat16).astype(np.float32), (1, 1),
               "SAME")
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-3,
                               rtol=2 ** -7)


def test_conv_pairs_task(jc, tc):
    """The handle-level entry through the client (C1's plain route on the
    CPU client)."""
    n, h, w, ch, k = 1, 6, 10, 32, 48
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((n, h, w, ch)) * 0.1).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, ch, k)) * 0.1).astype(np.float32)
    args = (n, h, w, ch, k)
    got = _run(tc, tconv._conv_pairs_task, x, wgt, (n, h, w, k), *args)
    want = _run(jc, jconv._conv_pairs_task, x, wgt, (n, h, w, k), *args)
    np.testing.assert_allclose(got, want, **SMALL)


def _jax_example():
    """examples/conv_pairs.py (its own check runs on import, at its CPU
    size (4, 28, 28, 64) in interpret mode)."""
    spec = importlib.util.spec_from_file_location(
        "jax_conv_pairs_example", os.path.join(ROOT, "examples",
                                               "conv_pairs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_conv_pairs_example_twin():
    """``cubecl_tpu_torch/examples/conv_pairs.py`` at the JAX example's CPU
    size and inputs, against its ``stack_packed`` (bf16, three layers).
    Both round each layer's f32 sums to bf16; a sum that lands near a
    rounding tie may round the other way and carry one bf16 ulp (2^-8
    relative) into the next layer, so the stacks agree to a few ulps."""
    from cubecl_tpu_torch.examples import conv_pairs as ex

    jex = _jax_example()
    assert (jex.N, jex.H, jex.W, jex.C) == ex.CPU_SHAPE
    x, ws = ex.inputs(*ex.CPU_SHAPE, depth=jex.DEPTH, device="cpu")

    def bf16(t):
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))

    want = np.asarray(jex.stack_packed(bf16(x), [bf16(w) for w in ws])
                      ).astype(np.float32)
    got = ex.stack_packed(x, ws, jex.H)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)
    err = ex.check(got, x, ws)
    assert err < ex.TOL, err


@pytest.mark.parametrize("n,h,w", [(32, 56, 56), (1, 6, 10), (3, 5, 130),
                                   (1, 1, 2), (3, 1, 56), (1, 7, 400),
                                   (16, 28, 28), (600, 8, 8), (1, 3, 1000)])
def test_c1_plan_covers_the_image_and_fits_the_card(n, h, w):
    """C1's bf16 launch plan (the wgmma body of csrc/conv3x3.cu): tiles of
    at most 198 columns whose halo ((tr + 2) x (tw + 2) pixels) is at most
    600 pixels, together covering every row and column once; a persistent
    grid of at most 132 blocks, one a tile below that; the weights (72 KiB)
    and two 1024-aligned halo stages within the 227 KiB a block may use.
    At ResNet-50's conv2_x shape a tile is 8 rows x 56 columns (7 m64
    blocks. The f32 plan (three TF32 products on wgmma): tiles of at most
    83 columns whose halo is at most 256 pixels (two 1024-aligned panels
    of 128 bytes a pixel), covering the image once, beside a ring of 3
    tap stages of the split weights (32 KiB each), within 227 KiB; at
    conv2_x a tile is 2 rows x 56 columns (2 m64 blocks)."""
    p = tconv.c1_plan(torch.bfloat16, n, h, w)
    tr, tw = p.tile
    assert 1 <= tr <= h and 1 <= tw <= min(w, 198)
    assert (tr + 2) * (tw + 2) <= 600
    wb, hb = -(-w // tw), -(-h // tr)
    assert (wb - 1) * tw < w <= wb * tw and (hb - 1) * tr < h <= hb * tr
    assert -(-w // wb) == tw  # equal column blocks
    assert p.threads == 384 and p.grid == (min(n * hb * wb, 132), 1, 1)
    stage = -(-(tr + 2) * (tw + 2) * 128 // 1024) * 1024
    assert p.smem_bytes == 9 * 64 * 64 * 2 + 2 * stage + 5 * 8 + 1024
    assert p.smem_bytes <= 227 * 1024
    if (n, h, w) == (32, 56, 56):
        assert p.tile == (8, 56) and p.grid == (132, 1, 1)
    f = tconv.c1_plan(torch.float32, n, h, w)
    tr, tw = f.tile
    assert 1 <= tr <= h and 1 <= tw <= min(w, 83)
    assert (tr + 2) * (tw + 2) <= 256
    wb, hb = -(-w // tw), -(-h // tr)
    assert (wb - 1) * tw < w <= wb * tw and (hb - 1) * tr < h <= hb * tr
    assert -(-w // wb) == tw
    assert f.threads == 384 and f.grid == (min(n * hb * wb, 132), 1, 1)
    panel = -(-(tr + 2) * (tw + 2) * 128 // 1024) * 1024
    assert f.smem_bytes == 3 * 32768 + 2 * 2 * panel + 10 * 8 + 1024
    assert f.smem_bytes <= 227 * 1024
    if (n, h, w) == (32, 56, 56):
        assert f.tile == (2, 56) and f.grid == (132, 1, 1)
    assert tconv.c1_body(torch.bfloat16) == "wgmma"
    assert tconv.c1_body(torch.float32) == "wgmma-tf32x3"
    with pytest.raises(ValueError, match="C1 takes"):
        tconv.c1_plan(torch.float16, n, h, w)


_TF32_KEEP = np.uint32(0xFFFFE000)


def _tf32_split(x):
    """csrc/hopper.cuh's tf32_split on finite f32: big = x truncated to
    tf32, small = x - big (exact) rounded to tf32, to nearest with ties
    away from zero (cvt.rna.tf32.f32)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    big = (u & _TF32_KEEP).view(np.float32)
    d = (x - big).astype(np.float32).view(np.uint32)
    return big, ((d + np.uint32(0x1000)) & _TF32_KEEP).view(np.float32)


@pytest.mark.parametrize("n,h,w,ch,k", [(1, 6, 10, 32, 48),
                                        (1, 3, 100, 16, 8)],
                         ids=["1x6x10x32-48", "1x3x100x16-8"])
def test_c1_f32_plan_three_tf32_products_match_the_jax_kernel(n, h, w, ch,
                                                              k):
    """C1's f32 body (csrc/conv3x3.cu, conv3x3_tf32x3_kernel) emulated in
    numpy on its own plan (``c1_plan``: tiles of tr x tw pixels, each
    output pixel computed once): per tap, the 8 k8 steps' three TF32
    products (A_small B_big + A_big B_small + A_big B_big, products of
    tf32 values exact in f32) summed from zero, the tap's sum added to the
    pixel's f32 accumulator; the input's channels from ``ch`` on (garbage
    here) read as zeros and the image's edges as zero, as the halo map's
    fill gives them. Held against the JAX kernel (conv2d_pairs_packed in
    interpret mode) at f32's tolerance; the second shape takes the plan's
    equal column blocks (W 100 in two tiles of 50)."""
    rng = np.random.default_rng(h * w + ch)
    x = (rng.standard_normal((n, h, w, ch)) * 0.1).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, ch, k)) * 0.1).astype(np.float32)
    want = np.asarray(jconv.conv2d_pairs_packed(
        jconv.pack_pairs(jnp.asarray(x)), jnp.asarray(wgt), h,
        interpret=True)).reshape(n, h, w, 64)
    x64 = np.full((n, h, w, 64), 1e4, np.float32)
    x64[..., :ch] = x
    halo = np.zeros((n, h + 2, w + 2, 64), np.float32)
    halo[:, 1:-1, 1:-1, :ch] = x64[..., :ch]      # C extent ch: zeros after
    wd = tconv._pad_weights(torch.from_numpy(wgt), torch.float32).numpy()
    (xb, xs), (wb_, ws) = _tf32_split(halo), _tf32_split(wd)
    p = tconv.c1_plan(torch.float32, n, h, w)
    tr, tw = p.tile
    got = np.full((n, h, w, 64), np.nan, np.float32)
    for img in range(n):
        for h0 in range(0, h, tr):
            for w0 in range(0, w, tw):
                rows, cols = min(tr, h - h0), min(tw, w - w0)
                acc = np.zeros((rows, cols, 64), np.float32)
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    sl = np.s_[img, h0 + dy:h0 + dy + rows,
                               w0 + dx:w0 + dx + cols]
                    a_b = torch.from_numpy(xb[sl].copy())
                    a_s = torch.from_numpy(xs[sl].copy())
                    b_b = torch.from_numpy(wb_[dy, dx])
                    b_s = torch.from_numpy(ws[dy, dx])
                    part = (a_s @ b_b + a_b @ b_s + a_b @ b_b).numpy()
                    acc = (acc + part).astype(np.float32)
                assert np.isnan(got[img, h0:h0 + rows, w0:w0 + cols]).all()
                got[img, h0:h0 + rows, w0:w0 + cols] = acc
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **SMALL)
    assert np.all(got[..., k:] == 0.0)
