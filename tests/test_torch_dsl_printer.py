"""The CUDA printer (K0 on Hopper) without nvcc: it prints a kernel for
each of the 18 slice kernels, maps the IR as its docstring says, and
raises ``NotImplementedError`` naming the op for what it does not lower.
Compiling and running the printed sources is the card's part
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import re

import numpy as np
import pytest
import torch

from cubecl_tpu_torch.backend.cuda.printer import cuda_source
from cubecl_tpu_torch.frontend import (ABSOLUTE_POS, ArrayArg, MutSlice,
                                       Slice, atomic_add, cmma, cube)
from cubecl_tpu_torch.ir.types import f32
from test_torch_dsl_scope import IDS, KERNELS, MODULES, _torch_args


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


@cube
def _cmma_k(a: Slice, out: MutSlice):
    m = cmma.Matrix("accumulator", 16, 16, 16, f32)
    cmma.fill(m, 0.0)
    cmma.store(m, out, 16)


def test_atomic_kernel_raises():
    d = _atomic_k.define(1, 32, ArrayArg(torch.zeros(32), mutable=True))
    with pytest.raises(NotImplementedError, match=r"atomic\.add.*ROADMAP"):
        cuda_source(d)


def test_cmma_kernel_raises():
    d = _cmma_k.define(1, 32, ArrayArg(torch.zeros(256)),
                       ArrayArg(torch.zeros(256), mutable=True))
    with pytest.raises(NotImplementedError, match=r"cmma.*ROADMAP"):
        cuda_source(d)


def test_evaluator_raises_for_the_same_ops():
    """The plain version lowers what the printer lowers, no more."""
    from cubecl_tpu_torch.runtime import CpuRuntime

    c = CpuRuntime.client()
    buf = c.create(np.zeros(32, np.float32))
    with pytest.raises(NotImplementedError, match=r"atomic\.add"):
        _atomic_k.launch_unchecked(c, 1, 32, ArrayArg(buf, mutable=True))
