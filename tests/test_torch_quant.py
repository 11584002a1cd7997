"""Quantization in the port against the JAX package, on the same numpy
inputs: the four quant tests of ``tests/test_std.py``. The host oracles
(``quantize_np``) and the K0 kernels (``std/quant_kernels.py``: the torch
evaluator here, Pallas in interpret mode there) must give the same int8
values and the same f32 scales, bit for bit: the quantized GEMM's error
rests on them. The dequantized values agree to f32 rounding (rtol 1e-6)."""

import re

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


# (n, spikes {index: value}, zeros) of the per-tensor cases: 1024 cubes
# in pass 1 with the absmax in the last or the first chunk, a ragged last
# chunk, lines of 1 in the JAX kernel (8 x 1009), several strides a unit,
# an all-zero tensor (scale 1e-12). The spikes' quotients by 127 are the
# same with the JAX kernel's arithmetic (see
# test_tensor_scale_is_the_quotient)
TENSOR_CASES = {
    "tensor": (8192, {}, False),
    "tensor-cubes-max-last": (1 << 17, {(1 << 17) - 1: 40.0}, False),
    "tensor-cubes-max-first": (1 << 17, {0: -50.0}, False),
    "tensor-ragged-chunk": (20000, {}, False),
    "tensor-lines-of-1": (8 * 1009, {}, False),
    "tensor-strides": (1 << 20, {12345: -40.0}, False),
    "tensor-zeros": (20000, {}, True),
}


def _tensor_input(case):
    n, spikes, zeros = TENSOR_CASES[case]
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32) * 3
    if zeros:
        x[:] = 0
    for i, v in spikes.items():
        x[i] = v
    return x


@pytest.mark.parametrize("level", ["block", *TENSOR_CASES])
def test_quantize_dequantize_kernels(jc, tc, level):
    """Block level (blocks of 2048) and tensor level (the twin of
    test_quantize_tensor_level, and the cases of TENSOR_CASES, which run
    the two passes of ``quantize_tensor_absmax`` and
    ``quantize_tensor_values`` over one or several cubes): the port's
    kernels against the JAX package's and against the host oracle."""
    if level == "block":
        n = 8192
        x = np.random.default_rng(2).standard_normal(n).astype(
            np.float32) * 3
        kw = dict(level=tq.QuantLevel.BLOCK, block_size=2048)
        jkw = dict(level=jq.QuantLevel.BLOCK, block_size=2048)
    else:
        x, n, kw, jkw = _tensor_input(level), TENSOR_CASES[level][0], {}, {}
        n_lines = n // tqk.TENSOR_LINE
        for (cubes, iters), units in zip(tqk.tensor_plan(n),
                                         (tqk.TENSOR_PLANE,
                                          tqk.TENSOR_UNITS)):
            # every line in one chunk, the last one cut at the end
            assert (cubes - 1) * iters * units < n_lines
            assert cubes * iters * units >= n_lines
            assert cubes <= tqk.TENSOR_CUBES
        assert tqk.tensor_plan(n)[0][0] > 1
        assert (tqk.tensor_plan(n)[0][1] > 1) == (n == 1 << 20)
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
    if x.any():
        assert np.abs(back - x).max() < np.abs(x).max() / 40
    else:
        np.testing.assert_array_equal(scales, np.float32(1e-12))
        np.testing.assert_array_equal(back, 0)
    # the plain PyTorch versions the card holds the kernels against
    pv, ps = tqk.quantize_plain(torch.from_numpy(x), tq.QuantScheme(**kw))
    np.testing.assert_array_equal(pv.numpy(), values)
    np.testing.assert_array_equal(ps.numpy(), scales)
    np.testing.assert_array_equal(
        tqk.dequantize_plain(pv, ps, tq.QuantScheme(**kw)).numpy(), back)


# (n, block, spikes {index: value}, zero blocks) of the block cases: 20
# blocks of 2048 (8 steps of a cube's 256 units), blocks that take lines
# of 1 in the JAX kernel (8072: the units' last step cut at the block's
# end; 40: a cube of two planes, 24 units idle), the absmax in a block's
# first and last element, an all-zero block (scale 1e-12)
BLOCK_CASES = {
    "block-2048-x20": (2048 * 20, 2048, {}, ()),
    "block-lines-of-1": (8072 * 3, 8072, {}, ()),
    "block-40": (40 * 30, 40, {}, ()),
    "block-max-first-and-last": (4096 * 9, 4096, {4096: -50.0,
                                                  3 * 4096 - 1: 60.0}, ()),
    "block-zeros": (2048 * 9, 2048, {}, (3,)),
}


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_quantize_kernels(jc, tc, case):
    """The block quantize (a cube a block, the planes' maxima through a
    shared array) and the block dequantize against the JAX package's
    kernels, the host
    oracle and the plain versions. The values are the JAX kernel's bits;
    the scales are the quotient absmax / 127 (the host oracle's and the
    plain version's), which the JAX kernel on its CPU runtime takes as
    absmax * (1 / 127), one ulp away for some blocks (see
    test_tensor_scale_is_the_quotient). Fed the same values and scales,
    both packages' dequantize give the same bits."""
    n, block, spikes, zeros = BLOCK_CASES[case]
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32) * 3
    for i, v in spikes.items():
        x[i] = v
    for b in zeros:
        x[b * block:(b + 1) * block] = 0
    scheme = tq.QuantScheme(level=tq.QuantLevel.BLOCK, block_size=block)
    jscheme = jq.QuantScheme(level=jq.QuantLevel.BLOCK, block_size=block)
    values, scales, back = _kernels(tc, tqk, x, scheme)
    jvalues, jscales, jback = _kernels(jc, jqk, x, jscheme)
    assert scales.shape == (n // block,)
    np.testing.assert_array_equal(values, jvalues)
    amax = np.abs(x.reshape(-1, block)).max(1)
    quotient = np.maximum(amax / np.float32(127), np.float32(1e-12))
    np.testing.assert_array_equal(scales, quotient)
    np.testing.assert_array_equal(
        jscales, np.maximum(amax * (np.float32(1) / np.float32(127)),
                            np.float32(1e-12)))
    assert np.abs(scales.view(np.int32) - jscales.view(np.int32)).max() <= 1
    for b in zeros:
        assert scales[b] == np.float32(1e-12)
    hv, hs = tq.quantize_np(x, scheme)
    np.testing.assert_array_equal(values, hv)
    np.testing.assert_array_equal(scales, np.asarray(hs).reshape(-1))
    pv, ps = tqk.quantize_plain(torch.from_numpy(x), scheme)
    np.testing.assert_array_equal(pv.numpy(), values)
    np.testing.assert_array_equal(ps.numpy(), scales)
    np.testing.assert_array_equal(
        tqk.dequantize_plain(pv, ps, scheme).numpy(), back)
    same = tqk.dequantize(tc, tc.create(jvalues), tc.create(jscales), scheme)
    np.testing.assert_array_equal(np.asarray(tc.read_one(same)), jback)


# (n, block or None for one per-tensor scale) of the plan checks: phase
# o's 4096^2 at both levels, the cases above, a block of 65536 and
# TENSOR_CASES' ragged ones
PLAN_CASES = [(4096 * 4096, 4096), (4096 * 4096, None), (2048 * 20, 2048),
              (8072 * 3, 8072), (40 * 30, 40), (65536 * 3, 65536),
              (20000, None), (8 * 1009, None), (4096 * 4096 + 8 * 1009, None)]


@pytest.mark.parametrize("n,block", PLAN_CASES)
def test_block_and_dequantize_plans_cover_every_line(n, block):
    """The launch plans, emulated in numpy as the kernels index: the
    dequantize's chunks cover every line exactly once, the last cut at
    the tensor's end, and line i takes the scale of the block its
    elements lie in; the block quantize's units write every element of
    their block exactly once and read none outside it."""
    line = tqk.DEQ_LINE
    n_lines = n // line
    cubes, iters = tqk.dequantize_plan(n)
    assert (cubes - 1) * iters * tqk.DEQ_UNITS < n_lines
    assert cubes * iters * tqk.DEQ_UNITS >= n_lines
    assert cubes <= tqk.DEQ_CUBES
    idx = (np.arange(cubes)[:, None, None] * (iters * tqk.DEQ_UNITS)
           + np.arange(iters)[None, :, None] * tqk.DEQ_UNITS
           + np.arange(tqk.DEQ_UNITS)[None, None, :]).reshape(-1)
    idx = idx[idx < n_lines]
    np.testing.assert_array_equal(np.sort(idx), np.arange(n_lines))
    if block is None:
        return
    block_lines = block // line
    # every element of line i lies in block i // block_lines
    np.testing.assert_array_equal(idx // block_lines, idx * line // block)
    np.testing.assert_array_equal((idx * line + line - 1) // block,
                                  idx * line // block)
    # the block quantize: a cube a block, each unit's elements j = k *
    # units + u read at min(j, block - 1) and written where j < block
    cubes, units, steps = tqk.block_plan(n, block)
    assert cubes == n // block and units % tqk.PLANE == 0
    assert units <= tqk.BLOCK_UNITS and (units - tqk.PLANE) < block
    assert (steps - 1) * units < block <= steps * units
    j = (np.arange(steps)[:, None] * units
         + np.arange(units)[None, :]).reshape(-1)
    assert np.minimum(j, block - 1).max() < block
    np.testing.assert_array_equal(np.sort(j[j < block]), np.arange(block))


def test_tensor_scale_is_the_quotient(jc, tc):
    """The port's per-tensor scale is the f32 quotient absmax / 127, as
    the host oracle and the plain version give it. The JAX kernel on its
    CPU runtime takes absmax * (1 / 127), one ulp away for some absmax
    (this input's 14.74795); its values agree all the same."""
    n = 1 << 17
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32) * 3
    values, scales, _ = _kernels(tc, tqk, x, tq.QuantScheme())
    jvalues, jscales, _ = _kernels(jc, jqk, x, jq.QuantScheme())
    amax = np.abs(x).max()
    np.testing.assert_array_equal(scales, amax / np.float32(127))
    np.testing.assert_array_equal(
        scales, np.asarray(tq.quantize_np(x, tq.QuantScheme())[1]).reshape(-1))
    np.testing.assert_array_equal(
        scales, tqk.quantize_plain(torch.from_numpy(x),
                                   tq.QuantScheme())[1].numpy())
    np.testing.assert_array_equal(jscales,
                                  amax * (np.float32(1) / np.float32(127)))
    assert np.abs(scales.view(np.int32) - jscales.view(np.int32)).max() <= 1
    np.testing.assert_array_equal(values, jvalues)


def test_quant_kernels_print_for_the_card():
    """The kernels print as CUDA C++: i8 casts, ``rintf`` rounding; the
    block quantize (a cube a block: a 32-lane plane max, the planes'
    maxima through a shared array); the
    per-tensor passes: a plane's max over its lines, then the partials'
    block max over eight warps; the dequantize's chunks at both levels
    (a line's block scale, or one uniform load of the per-tensor scale
    before the loop)."""
    import torch

    from cubecl_tpu_torch.backend.cuda.printer import cuda_source
    from cubecl_tpu_torch.frontend import ArrayArg

    x = torch.zeros(8192)
    n = 1 << 20

    def block_source(block):
        cubes, units, steps = tqk.block_plan(n // 4096 * block, block)
        m = cubes * block
        return cuda_source(tqk.quantize_block_kernel.define(
            cubes, units, ArrayArg(torch.zeros(m)),
            ArrayArg(torch.zeros(m, dtype=torch.int8), mutable=True),
            ArrayArg(torch.zeros(cubes), mutable=True), steps, units, block,
            127.0, checked=False))

    # a cube a block: 16 steps of 256 units over x twice, the planes'
    # maxima through one shared array of 8 and one barrier
    src = block_source(4096)
    assert tqk.block_plan(n, 4096) == (256, 256, 16)
    assert "rintf(" in src and "int8_t" in src
    assert "__launch_bounds__(256)" in src
    assert "plane_pos = unit_pos / 32" in src
    assert "__shfl_xor_sync(0xffffffffu," in src and ", o, 32)" in src
    assert re.search(r"__shared__ __align__\(16\) float sh\d+\[8\];", src)
    assert src.count("__syncthreads();") == 1
    assert src.count("< ((int32_t)16LL)") == 2 and "4095LL" not in src
    # a ragged block: reads clamped into the block, stores guarded; a
    # block of 40 elements: a cube of two planes
    ragged = block_source(8072)
    assert tqk.block_plan(8072, 8072) == (1, 256, 32)
    assert ", ((int32_t)8071LL))" in ragged  # min(j, block - 1)
    assert "< ((int32_t)8072LL)" in ragged
    assert tqk.block_plan(40 * 3, 40) == (3, 64, 1)
    assert re.search(r"float sh\d+\[2\];", block_source(40))
    # one per-tensor scale: the two passes over many cubes of 256 units
    (c1, iters1), (c2, iters) = tqk.tensor_plan(n)
    assert c1 > 64 and c2 > 64
    src1 = cuda_source(tqk.quantize_tensor_absmax.define(
        c1, tqk.TENSOR_PLANE, ArrayArg(torch.zeros(n), line_size=4),
        ArrayArg(torch.zeros(c1), mutable=True), iters1, n // 4,
        checked=False))
    src2 = cuda_source(tqk.quantize_tensor_values.define(
        c2, tqk.TENSOR_UNITS, ArrayArg(torch.zeros(n), line_size=4),
        ArrayArg(torch.zeros(c1)),
        ArrayArg(torch.zeros(n, dtype=torch.int8), line_size=4,
                 mutable=True),
        ArrayArg(torch.zeros(1), mutable=True), iters, n // 4, 127.0,
        checked=False))
    # pass 1: one plane of 32 units, |x| folded a line a step, the plane's
    # max by a butterfly; pass 2: the partials' cube-cooperative block max
    # over eight warps, then the values
    assert "__launch_bounds__(32)" in src1 and "fabsf(" in src1
    assert "__shfl_xor_sync(0xffffffffu," in src1
    assert "__syncthreads();" not in src1
    assert "__launch_bounds__(256)" in src2
    assert "__shfl_xor_sync(0xffffffffu," in src2
    assert "__syncthreads();" in src2 and "const uint4 u" in src2
    assert "cc_max(accs[k], t)" in src2
    assert "rintf(" in src2 and "(int8_t)" in src2
    assert f"{c2 - 1}LL) - cube_pos_x" in src2  # the chunks in reverse
    # the dequantize: 256 units a cube, the chunk cut at the tensor's end
    cubes, iters = tqk.dequantize_plan(n)
    deq = {}
    for level, n_scales, block_lines in (("block", n // 4096, 4096),
                                         ("tensor", 1, 0)):
        deq[level] = cuda_source(tqk.dequantize_chunk_kernel.define(
            cubes, tqk.DEQ_UNITS, ArrayArg(torch.zeros(n, dtype=torch.int8)),
            ArrayArg(torch.zeros(n_scales)),
            ArrayArg(torch.zeros(n), mutable=True), iters, n, block_lines,
            checked=False))
        assert "__launch_bounds__(256)" in deq[level]
        assert f"< ((int32_t){n}LL));" in deq[level]
        assert "(float)(" in deq[level]
    assert "cc_floordiv(" in deq["block"] and "[((int64_t)0LL)]" not in \
        deq["block"]
    body = deq["tensor"].split("for (int32_t", 1)
    assert "b1[((int64_t)0LL)]" in body[0] and "b1[" not in body[1]
    # the one-cube-a-block kernels of the JAX package's plan still print
    for k, args in ((tqk.dequantize_block_kernel,
                     (ArrayArg(torch.zeros(8192, dtype=torch.int8)),
                      ArrayArg(torch.zeros(4)),
                      ArrayArg(x, mutable=True), 256)),
                    (tqk.dequantize_tensor_kernel,
                     (ArrayArg(torch.zeros(8192, dtype=torch.int8)),
                      ArrayArg(x, mutable=True), 0.5))):
        assert "__global__" in cuda_source(k.define(1024, 8, *args,
                                                    checked=False))
