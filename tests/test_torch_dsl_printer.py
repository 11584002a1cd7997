"""The CUDA printer (K0 on Hopper) without nvcc: it prints a kernel for
each of the 18 slice kernels, maps the IR as its docstring says (cmma
fragments included), and raises ``NotImplementedError`` naming the op for
what it does not lower. Compiling and running the printed sources is the
card's part (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import re

import numpy as np
import pytest
import torch

from cubecl_tpu_torch.backend.cuda.printer import cuda_source
from cubecl_tpu_torch.frontend import (ABSOLUTE_POS, ArrayArg, MutSlice,
                                       Slice, atomic_add, cmma, cube)
from cubecl_tpu_torch.ir.types import f32
from test_torch_dsl_scope import (IDS, KERNELS, MODULES, SLICE6,
                                  SLICE6_IDS, SLICE6_MODULES, _seq_args,
                                  _torch_args)


def _source(name, cc, cd, checked, spec, mod):
    kernel = getattr(MODULES[mod][1], name)
    return cuda_source(kernel.define(cc, cd, *_torch_args(spec),
                                     checked=checked))


@pytest.mark.parametrize("mod,name,cc,cd,checked,spec", KERNELS, ids=IDS)
def test_prints_each_slice_kernel(mod, name, cc, cd, checked, spec):
    src = _source(name, cc, cd, checked, spec, mod)
    sym = re.search(r'extern "C" __global__ void __launch_bounds__\((\d+)\) '
                    r'(\w+)\(', src)
    assert sym and int(sym.group(1)) == cd
    assert f"cudaLaunchKernel((const void*){sym.group(2)}" in src
    assert "return (int)cudaGetLastError();" in src
    assert src.count("{") == src.count("}")
    n_buffers = sum(isinstance(a, tuple) for a in spec)
    assert len(re.findall(r"int64_t len_b\d+", src)) == n_buffers


def test_mapping_of_the_rmsnorm_kernel():
    """bf16 in, f32 math, one rounding out; rsqrt is rsqrtf; the
    elementwise chains fuse into the sum and the store loop, so the row
    needs no per-thread array."""
    src = _source("_rmsnorm_fwd_k", 2, 8, False, KERNELS[16][5], "fn")
    assert "[256];" not in src
    assert "__bfloat162float(" in src and "__float2bfloat16_rn(" in src
    assert "rsqrtf(" in src
    assert "b0[((int64_t)(absolute_pos)) * 256 + l]" in src
    assert re.search(r"b2\[\(\(int64_t\)\(absolute_pos\)\) \* 256 \+ l\] = "
                     r"\(__float2bfloat16_rn\(", src)


def test_in_place_kernel_keeps_its_row_in_an_array():
    """A kernel that stores to the buffer it reads loads the line into an
    array once: an inlined re-read after the store would see new data."""
    src = _source("softmax_lines_inplace", 2, 8, False, KERNELS[7][5],
                  "norm")
    assert re.search(r"__nv_bfloat16 v\d+\[256\];", src)


def test_aliased_buffers_are_not_restrict():
    """One tensor passed as input and output (``launch_gelu(c, h, h)`` on
    its checked path) is one memory: neither pointer is ``__restrict__``,
    and the input is read before the store, never re-read inline after
    it. Distinct tensors keep ``__restrict__``; the two launches have two
    kernel ids."""
    from cubecl_tpu_torch.ops.gelu import gelu_array, gelu_array_exact

    t, u = torch.zeros(1000), torch.zeros(1000)
    alias = cuda_source(gelu_array.define(
        4, 64, ArrayArg(t), ArrayArg(t, mutable=True), checked=True))
    apart = cuda_source(gelu_array.define(
        4, 64, ArrayArg(t), ArrayArg(u, mutable=True), checked=True))
    assert "__restrict__" not in alias
    assert apart.count("__restrict__") == 2
    assert re.search(r"const float\* b0,\n\s+float\* b1,", alias)

    # a line kernel: the aliased input line goes to an array first
    t = torch.zeros(4096)
    src = cuda_source(gelu_array_exact.define(
        4, 64, ArrayArg(t, line_size=16),
        ArrayArg(t, line_size=16, mutable=True), checked=False))
    assert re.search(r"float v\d+\[16\];", src)

    from cubecl_tpu_torch.runtime import CpuRuntime

    c = CpuRuntime.client()  # one per process: count from here
    compiles = c.server.compile_count
    h, o = c.create(np.ones(1024, np.float32)), c.empty(1024)
    for out in (o, h):
        gelu_array_exact.launch_unchecked(
            c, 4, 64, ArrayArg(h, line_size=4),
            ArrayArg(out, line_size=4, mutable=True))
    assert c.server.compile_count == compiles + 2
    np.testing.assert_allclose(c.read_one(h), c.read_one(o), rtol=0)


def test_mapping_of_plane_and_checked_kernels():
    rows = _source("softmax_rows", 4, 8, False, KERNELS[4][5], "norm")
    # plane of 8 (the whole 8-unit cube): butterfly over 8 lanes
    assert "__shfl_xor_sync(0xffu," in rows and ", o, 8)" in rows
    assert "expf(" in rows
    # checked IO: 16 x 64 units over 1000 elements cannot be proven in
    # bounds, so the read is masked and the store guarded
    gelu = _source("gelu_array", 16, 64, True, KERNELS[0][5], "gelu")
    assert re.search(r"if \(v\d+\) \{\n\s+b1\[", gelu)
    assert re.search(r"\? b0\[", gelu)
    assert "erff(" in gelu


@cube
def _atomic_k(buf: MutSlice):
    atomic_add(buf, ABSOLUTE_POS, 1.0)


def _cmma_body(cmma_mod, f32_):
    def _cmma_k(a: Slice, out: MutSlice):
        m = cmma_mod.Matrix("accumulator", 16, 16, 16, f32_)
        cmma_mod.fill(m, 0.5)
        x = cmma_mod.Matrix("a", 16, 16, 16, f32_)
        cmma_mod.load(x, a, 16)
        y = cmma_mod.Matrix("b", 16, 16, 16, f32_, cmma_mod.COL_MAJOR)
        cmma_mod.load(y, a, 16)
        cmma_mod.execute(x, y, m, m)
        cmma_mod.store(m, out, 16)
    return _cmma_k


_cmma_k = cube(_cmma_body(cmma, f32))


def test_atomic_kernel_raises():
    d = _atomic_k.define(1, 32, ArrayArg(torch.zeros(32), mutable=True))
    with pytest.raises(NotImplementedError, match=r"atomic\.add.*ROADMAP"):
        cuda_source(d)


def test_cmma_kernel_raises():
    """A positive test under the name it had when the printer refused
    cmma (the name is kept so that its history stays one test): cmma
    prints and does not raise. ``_cmma_k`` (out = A A^T + 0.5 through
    fill, row- and col-major loads, execute and store) prints, its three
    16 x 16 f32 fragments in dynamic shared memory, and on the CPU twin it
    equals the JAX evaluator (Pallas interpret) on the same input, within
    f32 summation order (atol 1e-5)."""
    from cubecl_tpu import CpuRuntime as JCpu
    from cubecl_tpu.frontend import ArrayArg as JArrayArg
    from cubecl_tpu.frontend import MutSlice as JMutSlice
    from cubecl_tpu.frontend import Slice as JSlice
    from cubecl_tpu.frontend import cmma as jcmma
    from cubecl_tpu.frontend import cube as jcube
    from cubecl_tpu.ir.types import f32 as jf32
    from cubecl_tpu_torch.runtime import CpuRuntime

    d = _cmma_k.define(1, 32, ArrayArg(torch.zeros(256)),
                       ArrayArg(torch.zeros(256), mutable=True))
    src = cuda_source(d)
    assert src.count("cc_smem + ") == 3 and "args, 3072," in src
    assert "fmaf(" in src and "NotImplemented" not in src

    a = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    body = _cmma_body(jcmma, jf32)
    body.__annotations__ = {"a": JSlice, "out": JMutSlice}
    jk = jcube(body)
    jc = JCpu.client()
    jo = jc.empty((256,), "float32")
    jk.launch_unchecked(jc, 1, 8, JArrayArg(jc.create(a)),
                        JArrayArg(jo, mutable=True))
    tc = CpuRuntime.client()
    to = tc.empty((256,), "float32")
    _cmma_k.launch_unchecked(tc, 1, 32, ArrayArg(tc.create(a)),
                             ArrayArg(to, mutable=True))
    want = np.asarray(jc.read_one(jo))
    np.testing.assert_allclose(tc.read_one(to), want, atol=1e-5, rtol=0)
    x = a.reshape(16, 16)
    np.testing.assert_allclose(want.reshape(16, 16), x @ x.T + 0.5,
                               atol=1e-5)


def test_evaluator_raises_for_the_same_ops():
    """The plain version lowers what the printer lowers, no more."""
    from cubecl_tpu_torch.runtime import CpuRuntime

    c = CpuRuntime.client()
    buf = c.create(np.zeros(32, np.float32))
    with pytest.raises(NotImplementedError, match=r"atomic\.add"):
        _atomic_k.launch_unchecked(c, 1, 32, ArrayArg(buf, mutable=True))


@pytest.mark.parametrize("mod,name,cc,cd,checked,spec", SLICE6,
                         ids=SLICE6_IDS)
def test_prints_each_reduce_and_fusion_kernel(mod, name, cc, cd, checked,
                                              spec):
    kernel = getattr(SLICE6_MODULES[mod][1], name)
    src = cuda_source(kernel.define(cc, cd, *_seq_args(spec, False),
                                    checked=checked))
    assert re.search(r"__launch_bounds__\(%d\)" % cd, src)
    assert src.count("{") == src.count("}")
    assert "NotImplemented" not in src


def test_mapping_of_block_reduce():
    """``block_sum`` over a bf16 buffer in a cube of 256: the threads
    stride over the window with 16-byte loads when it is aligned (single
    elements otherwise), eight accumulators in f32, a warp butterfly, the
    eight warps folded through a static shared array between barriers,
    and one bf16 rounding; in a cube of 8 (one plane) no shared memory."""
    from cubecl_tpu_torch.ops.reduce import reduce_block_partial

    n = 4 * 2048 * 128
    src = cuda_source(reduce_block_partial.define(
        4, 256, ArrayArg(torch.zeros(n, dtype=torch.bfloat16),
                         line_size=128),
        ArrayArg(torch.zeros(4), mutable=True), 2048, checked=False))
    assert "if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)" in src
    assert "*reinterpret_cast<const uint4*>(p + j)" in src
    assert "float accs[8];" in src and "__bfloat162float(e[v])" in src
    assert "__shfl_xor_sync(0xffffffffu, (float)acc, o, 32)" in src
    assert re.search(r"__shared__ float cc_red\d+\[8\];", src)
    assert src.count("__syncthreads();") == 2
    assert "i < 262144;" in src
    small = cuda_source(reduce_block_partial.define(
        32, 8, ArrayArg(torch.zeros(32 * 16 * 128), line_size=128),
        ArrayArg(torch.zeros(32), mutable=True), 16, checked=False))
    assert "__shared__" not in small and "__syncthreads" not in small
    assert "__shfl_xor_sync(0xffu, (float)acc, o, 8)" in small


@cube
def _block_kinds(inp: Slice, out: MutSlice):
    out[0] = inp.block_max(0, 2) + inp.block_min(0, 2)
    out[1] = inp.block_prod(0, 2)


def test_block_reduce_kinds_print_neutral_elements():
    """max starts at -inf, min at +inf, prod at 1; an int32 buffer keeps
    its own type with its extreme values."""
    src = cuda_source(_block_kinds.define(
        1, 32, ArrayArg(torch.zeros(6)), ArrayArg(torch.zeros(2),
                                                  mutable=True),
        checked=False))
    assert "accs[k] = (-(float)INFINITY);" in src
    assert "accs[k] = ((float)INFINITY);" in src
    assert "accs[k] = 0x1.0000000000000p+0f;" in src
    assert "cc_max(accs[k], t)" in src and "cc_min(accs[k], t)" in src
    assert "accs[k] * t" in src
    ints = cuda_source(_block_kinds.define(
        1, 32, ArrayArg(torch.zeros(6, dtype=torch.int32)),
        ArrayArg(torch.zeros(2, dtype=torch.int32), mutable=True),
        checked=False))
    assert "int32_t accs[8];" in ints
    assert "((int32_t)-2147483648LL)" in ints
    assert "((int32_t)2147483647LL)" in ints


def test_mapping_of_reinterpret():
    """``op.reinterpret``: the source gathered in its storage type and
    copied bit for bit, the line absorbing the width ratio (one f32 to
    four u8, four u8 to one i32)."""
    from test_torch_std import k_reinterp_i32, k_reinterp_u8

    src = cuda_source(k_reinterp_u8.define(
        1, 8, ArrayArg(torch.zeros(8)),
        ArrayArg(torch.zeros(32, dtype=torch.uint8), line_size=4,
                 mutable=True), checked=False))
    assert re.search(r"uint8_t v\d+\[4\];", src)
    assert re.search(r"float src = v\d+;\n\s+memcpy\(v\d+, &src, "
                     r"sizeof\(src\)\);", src)
    src = cuda_source(k_reinterp_i32.define(
        1, 8, ArrayArg(torch.zeros(8)),
        ArrayArg(torch.zeros(8, dtype=torch.int32), mutable=True),
        checked=False))
    assert re.search(r"memcpy\(&v\d+, &src, sizeof\(src\)\);", src)


def test_unsupported_names_the_families_left():
    """The error names the op and every family still to lower."""
    from cubecl_tpu_torch.backend.compiler import UNLOWERED

    d = _atomic_k.define(1, 32, ArrayArg(torch.zeros(32), mutable=True))
    with pytest.raises(NotImplementedError) as ei:
        cuda_source(d)
    msg = str(ei.value)
    assert "atomic.add" in msg and all(f in msg for f in UNLOWERED)
    assert "block_reduce" not in msg and "reinterpret" not in msg
