"""Quantization in the port against the JAX package, on the same numpy
inputs: the four quant tests of ``tests/test_std.py``. The host oracles
(``quantize_np``) and the K0 kernels (``std/quant_kernels.py``: the torch
evaluator here, Pallas in interpret mode there) must give the same int8
values and the same f32 scales, bit for bit: the quantized GEMM's error
rests on them. The dequantized values agree to f32 rounding (rtol 1e-6)."""

import numpy as np
import pytest
import torch

from cubecl_tpu.runtime import CpuRuntime as JCpu
from cubecl_tpu.std import quant as jq
from cubecl_tpu.std import quant_kernels as jqk
from cubecl_tpu_torch.runtime import CpuRuntime
from cubecl_tpu_torch.std import quant as tq
from cubecl_tpu_torch.std import quant_kernels as tqk


@pytest.fixture(scope="module")
def jc():
    return JCpu.client()


@pytest.fixture(scope="module")
def tc():
    return CpuRuntime.client()


def test_quant_roundtrip_i8():
    x = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    q, scale = tq.quantize_np(x, tq.QuantScheme())
    jqv, jscale = jq.quantize_np(x, jq.QuantScheme())
    assert q.dtype == np.int8
    np.testing.assert_array_equal(q, jqv)
    np.testing.assert_array_equal(scale, jscale)
    back = tq.dequantize_np(q, scale, tq.QuantScheme())
    np.testing.assert_array_equal(back, jq.dequantize_np(jqv, jscale,
                                                         jq.QuantScheme()))
    assert np.abs(back - x).max() < np.abs(x).max() / 50


def test_quant_block():
    x = np.random.default_rng(1).standard_normal(256).astype(np.float32)
    s = tq.QuantScheme(level=tq.QuantLevel.BLOCK, block_size=32)
    js = jq.QuantScheme(level=jq.QuantLevel.BLOCK, block_size=32)
    q, scale = tq.quantize_np(x, s)
    jqv, jscale = jq.quantize_np(x, js)
    assert scale.shape == (8,)
    np.testing.assert_array_equal(q, jqv)
    np.testing.assert_array_equal(scale, jscale)
    back = tq.dequantize_np(q, scale, s)
    assert np.abs(back - x).max() < np.abs(x).max() / 30


def _kernels(client, mod, x, scheme):
    h = client.create(x)
    values, scales = mod.quantize(client, h, scheme)
    back = mod.dequantize(client, values, scales, scheme)
    return [np.asarray(client.read_one(t)) for t in (values, scales, back)]


@pytest.mark.parametrize("level", ["block", "tensor"])
def test_quantize_dequantize_kernels(jc, tc, level):
    """Block level (blocks of 2048) and tensor level (the twin of
    test_quantize_tensor_level): the port's kernels against the JAX
    package's and against the host oracle."""
    n = 8192
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32) * 3
    if level == "block":
        kw = dict(level=tq.QuantLevel.BLOCK, block_size=2048)
        jkw = dict(level=jq.QuantLevel.BLOCK, block_size=2048)
    else:
        kw = jkw = {}
    values, scales, back = _kernels(tc, tqk, x, tq.QuantScheme(**kw))
    jvalues, jscales, jback = _kernels(jc, jqk, x, jq.QuantScheme(**jkw))
    assert values.dtype == np.int8 and scales.dtype == np.float32
    assert scales.shape == ((n // 2048,) if level == "block" else (1,))
    np.testing.assert_array_equal(values, jvalues)
    np.testing.assert_array_equal(scales, jscales)
    np.testing.assert_allclose(back, jback, rtol=1e-6, atol=0)
    hv, hs = tq.quantize_np(x, tq.QuantScheme(**kw))
    np.testing.assert_array_equal(values, hv)
    np.testing.assert_array_equal(scales, np.asarray(hs).reshape(-1))
    assert np.abs(back - x).max() < np.abs(x).max() / 40
    # the plain PyTorch versions the card holds the kernels against
    pv, ps = tqk.quantize_plain(torch.from_numpy(x), tq.QuantScheme(**kw))
    np.testing.assert_array_equal(pv.numpy(), values)
    np.testing.assert_array_equal(ps.numpy(), scales)
    np.testing.assert_array_equal(
        tqk.dequantize_plain(pv, ps, tq.QuantScheme(**kw)).numpy(), back)


def test_quant_kernels_print_for_the_card():
    """The three kernels print as CUDA C++: i8 casts, ``rintf`` rounding
    and the 8-lane plane max of a cube of 8 units."""
    import torch

    from cubecl_tpu_torch.backend.cuda.printer import cuda_source
    from cubecl_tpu_torch.frontend import ArrayArg

    x = torch.zeros(8192)
    src = cuda_source(tqk.quantize_block_kernel.define(
        4, 8, ArrayArg(x, line_size=4),
        ArrayArg(torch.zeros(8192, dtype=torch.int8), line_size=4,
                 mutable=True),
        ArrayArg(torch.zeros(4), mutable=True), 64, 127.0, checked=False))
    assert "rintf(" in src and "int8_t" in src
    assert "__shfl_xor_sync(0xffu," in src
    for k, args in ((tqk.dequantize_block_kernel,
                     (ArrayArg(torch.zeros(8192, dtype=torch.int8)),
                      ArrayArg(torch.zeros(4)),
                      ArrayArg(x, mutable=True), 256)),
                    (tqk.dequantize_tensor_kernel,
                     (ArrayArg(torch.zeros(8192, dtype=torch.int8)),
                      ArrayArg(x, mutable=True), 0.5))):
        assert "__global__" in cuda_source(k.define(1024, 8, *args,
                                                    checked=False))
