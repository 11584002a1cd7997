"""The CUDA printer (K0 on Hopper) without nvcc: it prints a kernel for
each of the 18 slice kernels, maps the IR as its docstring says (cmma
fragments and warp lines included), and raises ``NotImplementedError``
naming the op for what it does not lower. Compiling and running the
printed sources is the card's part (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import hashlib
import re

import numpy as np
import pytest
import torch

from cubecl_tpu_torch.backend.compiler import prepare_scope
from cubecl_tpu_torch.backend.cuda.printer import (cuda_source,
                                                   reads_plane_builtins,
                                                   warp_vector)
from cubecl_tpu_torch.frontend import (ABSOLUTE_POS, ArrayArg, MutSlice,
                                       Slice, atomic_add, cmma, cube,
                                       cube_range)
from cubecl_tpu_torch.ir import ops as O
from cubecl_tpu_torch.ir.scope import walk
from cubecl_tpu_torch.ir.types import bf16, f32, i8, i32
from test_torch_dsl_scope import (IDS, KERNELS, MODULES, SLICE6,
                                  SLICE6_IDS, SLICE6_MODULES, _seq_args,
                                  _torch_args)

# the kernels of the two lists that the warp-lines rule takes at their
# launches there: every line 256 elements (32 x 8 bf16, 64 x 4 f32) or
# f32 lines of 128 (32 x 4), and no plane op, barrier, block reduction,
# cmma, atomic or reinterpret
WARP_LINED = {"softmax_lines", "softmax_lines_inplace", "layernorm_lines",
              "normalize_lines", "_gelu_fwd_k", "_gelu_bwd_k",
              "_softmax_fwd_k", "_softmax_bwd_k", "_layernorm_fwd_k",
              "_layernorm_bwd_k", "_rmsnorm_fwd_k", "_rmsnorm_bwd_k",
              "reduce_sum_naive-6", "fused_chain-7"}


def _source(name, cc, cd, checked, spec, mod):
    kernel = getattr(MODULES[mod][1], name)
    return cuda_source(kernel.define(cc, cd, *_torch_args(spec),
                                     checked=checked))


@pytest.mark.parametrize("mod,name,cc,cd,checked,spec", KERNELS, ids=IDS)
def test_prints_each_slice_kernel(mod, name, cc, cd, checked, spec):
    """Each kernel prints, its block a thread a unit or, warp-lined, a
    warp a unit (launch bounds and launcher cd x 32)."""
    src = _source(name, cc, cd, checked, spec, mod)
    sym = re.search(r'extern "C" __global__ void __launch_bounds__\((\d+)\) '
                    r'(\w+)\(', src)
    threads = cd * 32 if name in WARP_LINED else cd
    assert sym and int(sym.group(1)) == threads
    assert ("mapping=warp-lines" in src) == (name in WARP_LINED)
    assert f"dim3({threads}, 1, 1)" in src
    assert f"cudaLaunchKernel((const void*){sym.group(2)}" in src
    assert "return (int)cudaGetLastError();" in src
    assert src.count("{") == src.count("}")
    n_buffers = sum(isinstance(a, tuple) for a in spec)
    assert len(re.findall(r"int64_t len_b\d+", src)) == n_buffers


def test_mapping_of_the_rmsnorm_kernel():
    """bf16 in, f32 math, one rounding out; rsqrt is rsqrtf; the
    elementwise chains fuse into the sum and the store loop, so the row
    needs no per-thread array. A row of 256 bf16 is a warp's: lane
    ``lane`` owns elements lane·8 .. lane·8 + 7, read as one 16-byte load
    when the buffers are aligned and element by element otherwise, and
    stored the same two ways."""
    src = _source("_rmsnorm_fwd_k", 2, 8, False, KERNELS[16][5], "fn")
    assert "[256];" not in src and "[8];" not in src
    assert "__bfloat162float(" in src and "__float2bfloat16_rn(" in src
    assert "rsqrtf(" in src
    assert "reinterpret_cast<const uint4*>(b0 + ((int64_t)(absolute_pos)) " \
           "* 256 + cc_e)[0]" in src
    lane = "((l) >> 3) * 256 + lane * 8 + ((l) & 7)"
    assert f"b0[((int64_t)(absolute_pos)) * 256 + {lane}]" in src
    assert "const int64_t cc_e = (int64_t)(k * 32 + lane) * 8;" in src
    assert "reinterpret_cast<uint4*>(b2 + ((int64_t)(absolute_pos)) * 256 " \
           "+ cc_e)[0] = cc_s0_u[0];" in src
    assert re.search(r"cc_s0\[j\] = \(__float2bfloat16_rn\(", src)
    assert re.search(re.escape(f"b2[((int64_t)(absolute_pos)) * 256 + {lane}]")
                     + r" = \(__float2bfloat16_rn\(", src)


def test_in_place_kernel_keeps_its_row_in_an_array():
    """A kernel that stores to the buffer it reads loads the line into an
    array once: an inlined re-read after the store would see new data.
    Under warp lines the array holds the lane's share, L / 32."""
    src = _source("softmax_lines_inplace", 2, 8, False, KERNELS[7][5],
                  "norm")
    assert re.search(r"__nv_bfloat16 v\d+\[8\];", src)
    assert "[256];" not in src


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
    warp = f"{name}-{SLICE6.index((mod, name, cc, cd, checked, spec))}" \
        in WARP_LINED
    assert re.search(r"__launch_bounds__\(%d\)" % (cd * 32 if warp else cd),
                     src)
    assert ("mapping=warp-lines" in src) == warp
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


# -- warp lines ----------------------------------------------------------------

def _all_launches():
    """(id, kernel, cc, cd, checked, args) of both lists' launches."""
    for mod, name, cc, cd, checked, spec in KERNELS:
        yield (name, getattr(MODULES[mod][1], name), cc, cd, checked,
               lambda spec=spec: _torch_args(spec))
    for i, (mod, name, cc, cd, checked, spec) in enumerate(SLICE6):
        yield (f"{name}-{i}", getattr(SLICE6_MODULES[mod][1], name), cc, cd,
               checked, lambda spec=spec: _seq_args(spec, False))


WARP_CASES = [c for c in _all_launches() if c[0] in WARP_LINED]


def _line_reductions(defn):
    """Line reductions (vec_sum/max/min, dot over a line) left after the
    passes."""
    return sum(1 for _s, i in walk(defn.scope)
               if i.op.opcode in (O.VEC_SUM, O.VEC_MAX, O.VEC_MIN, O.DOT)
               and i.op.args[0].ty.line > 1)


@pytest.mark.parametrize("case", WARP_CASES, ids=[c[0] for c in WARP_CASES])
def test_warp_lines_of_each_kernel_under_the_rule(case):
    """A kernel under the rule runs a unit on a warp: the mapping in its
    comment, units x 32 threads, the unit and lane from ``threadIdx.x``,
    one butterfly over the warp per line reduction, line loops over the
    lane's share (a 16-byte branch and an element branch on
    ``cc_aligned``) and no per-thread array of a whole line."""
    _id, kernel, cc, cd, checked, args = case
    defn = kernel.define(cc, cd, *args(), checked=checked)
    lines = {bp.ty.line for bp in defn.state.buffers if bp.ty.line > 1}
    src = cuda_source(defn)
    assert "mapping=warp-lines" in src
    assert f"__launch_bounds__({cd * 32})" in src
    assert "const int32_t lane = threadIdx.x & 31, unit_pos = " \
           "threadIdx.x >> 5;" in src
    assert "unit_pos_plane" not in src
    assert src.count("__shfl_xor_sync(0xffffffffu, (float)acc, o, 32)") \
        == _line_reductions(defn)
    assert "if (cc_aligned) {" in src and "} else {" in src
    assert "reinterpret_cast<const uint4*>(" in src
    if any(bp.mutable and bp.ty.line > 1 for bp in defn.state.buffers):
        assert re.search(r"reinterpret_cast<uint4\*>\(b\d+ \+ .* = "
                         r"cc_s\d+_u\[0\];", src)
    for L in lines:
        assert not re.search(r"\w+ \w+\[%d\];" % L, src)
        assert f"for (int l = 0; l < {L // 32}; ++l)" in src


def _outside_rule():
    from cubecl_tpu_torch.ops import functional as F
    from cubecl_tpu_torch.ops import gelu as G
    from cubecl_tpu_torch.ops import normalization as N

    def z(n, dt=torch.float32):
        return torch.zeros(n, dtype=dt)

    bf = torch.bfloat16
    return {
        # plane_sum / plane_max over an 8-unit cube (the reference's CD)
        "softmax_rows": lambda: N.softmax_rows.define(
            4, 8, ArrayArg(z(4096), line_size=4),
            ArrayArg(z(4096), line_size=4, mutable=True), 32,
            checked=False),
        # cube-scope cmma fragments
        "cmma": lambda: _cmma_k.define(
            1, 32, ArrayArg(z(256)), ArrayArg(z(256), mutable=True),
            checked=False),
        # launch_gelu's 4-element f32 lines (< 32 x 4)
        "gelu line 4": lambda: G.gelu_array_exact.define(
            4, 256, ArrayArg(z(4096), line_size=4),
            ArrayArg(z(4096), line_size=4, mutable=True), checked=False),
        # a bf16 row of 128 (< 32 x 8)
        "rmsnorm bf16 line 128": lambda: F._rmsnorm_fwd_k.define(
            2, 8, ArrayArg(z(16 * 128, bf), line_size=128),
            ArrayArg(z(128, bf), line_size=128),
            ArrayArg(z(16 * 128, bf), line_size=128, mutable=True),
            1 / 128, 1e-5, checked=False),
    }


# sha256 of the source each kernel just outside the rule printed before
# warp lines existed (the printer's one-thread-a-unit mapping)
OUTSIDE_DIGESTS = {"softmax_rows": "ee17cfe240bebfbc",
                   "cmma": "8990a2dfe32a9769",
                   "gelu line 4": "4f2da2173ff2d78d",
                   "rmsnorm bf16 line 128": "b01e2546b2c5da14"}


@pytest.mark.parametrize("name", list(OUTSIDE_DIGESTS))
def test_kernels_outside_the_rule_keep_their_source(name):
    """Just outside the rule, a kernel keeps today's source byte for byte:
    a thread a unit, the cube dim as the block."""
    defn = _outside_rule()[name]()
    src = cuda_source(defn)
    assert warp_vector(defn) == 0
    assert "mapping=warp-lines" not in src and "threadIdx.x >> 5" not in src
    assert "const int32_t unit_pos_x = threadIdx.x" in src
    assert hashlib.sha256(src.encode()).hexdigest()[:16] == \
        OUTSIDE_DIGESTS[name]


@cube
def _reads_plane_dim(inp: Slice, out: MutSlice):
    from cubecl_tpu_torch.frontend import PLANE_DIM
    out[ABSOLUTE_POS] = inp[ABSOLUTE_POS] * PLANE_DIM


def test_warp_rule_refuses_plane_builtins():
    """``PLANE_DIM`` folds to a constant in the passes, so the rule reads
    the traced scope for it: a wide-lined kernel that reads it keeps a
    thread a unit."""
    defn = _reads_plane_dim.define(
        2, 8, ArrayArg(torch.zeros(16 * 256), line_size=256),
        ArrayArg(torch.zeros(16 * 256), line_size=256, mutable=True),
        checked=False)
    assert reads_plane_builtins(defn.scope)
    src = cuda_source(defn)
    assert "mapping=warp-lines" not in src and "__launch_bounds__(8)" in src


def test_warp_lines_over_1024_threads_raise():
    """33 units of a warp each are 1056 threads: the printer names the
    kernel and the units."""
    from cubecl_tpu_torch.ops import functional as F

    args = [ArrayArg(torch.zeros(33 * 2 * 256), line_size=256),
            ArrayArg(torch.zeros(33 * 2 * 256), line_size=256, mutable=True)]
    with pytest.raises(ValueError, match=r"_gelu_fwd_k.*33 units.*1056"):
        cuda_source(F._gelu_fwd_k.define(2, 33, *args, checked=False))


def test_ragged_warp_line_skips_past_its_end():
    """A bf16 row of 384 (>= 32 x 8, not a multiple of 256): every lane
    holds two chunks' room, the second past the row for lanes 16..31;
    there is no 16-byte branch."""
    from cubecl_tpu_torch.ops import functional as F

    bf = torch.bfloat16
    src = cuda_source(F._rmsnorm_fwd_k.define(
        2, 8, ArrayArg(torch.zeros(16 * 384, dtype=bf), line_size=384),
        ArrayArg(torch.zeros(384, dtype=bf), line_size=384),
        ArrayArg(torch.zeros(16 * 384, dtype=bf), line_size=384,
                 mutable=True), 1 / 384, 1e-5, checked=False))
    assert "mapping=warp-lines vector=8" in src
    assert "cc_aligned" not in src and "uint4" not in src
    assert "for (int l = 0; l < 16; ++l)" in src
    assert "if (((l) >> 3) * 256 + lane * 8 + ((l) & 7) >= 384) break;" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,rows", [(128, 8), (256, 8), (768, 8192),
                                    (2048, 8184), (2048, 8), (3072, 8192),
                                    (16384, 16)])
def test_row_plans_agree_with_the_printer(dtype, D, rows):
    """The plans of ``ops/functional.py`` and ``ops/normalization.py`` pick
    warps exactly where the printer does: at most 8 warps a cube, at least
    132 cubes where the rows allow, one unit a cube for decode's 8 rows;
    a thread a unit otherwise, as before."""
    from cubecl_tpu_torch.ops import functional as F
    from cubecl_tpu_torch.ops import normalization as N

    warps = N.warp_lines(D, dtype)
    units, _iters, cubes = N._wide_plan(rows, warps)
    assert units * cubes == rows
    defn = F._rmsnorm_fwd_k.define(
        cubes, units, ArrayArg(torch.zeros(rows * D, dtype=dtype),
                               line_size=D),
        ArrayArg(torch.zeros(D, dtype=dtype), line_size=D),
        ArrayArg(torch.zeros(rows * D, dtype=dtype), line_size=D,
                 mutable=True), 1 / D, 1e-5, checked=False)
    prepare_scope(defn)
    assert bool(warp_vector(defn)) == warps
    assert warps == (D * dtype.itemsize >= 512)
    if warps:
        assert units <= 8 and (cubes >= 132 or units == 1)
        assert units == (8 if rows // 8 >= 132 else 1)
    else:
        assert units == N._wide_plan(rows)[0]


def test_fused_chain_plan_is_warp_lined_for_f32():
    """``launch_fused`` keeps 128-element lines: on f32 they are warp
    lines on cubes of 8 warps (16M elements: 16384 cubes); on bf16 a
    thread a unit on cubes of 64, as before."""
    from cubecl_tpu_torch.ops import fusion as FU
    from cubecl_tpu_torch.runtime import CpuRuntime

    c = CpuRuntime.client()
    for dtype, want in ((torch.float32, 8), (torch.bfloat16, 64)):
        hs = [c.create(torch.ones(8 * 1024, dtype=dtype)) for _ in range(3)]
        seen = []
        orig = FU.fused_chain.launch
        FU.fused_chain.launch = lambda client, count, dim, *a: seen.append(
            (count, dim)) or orig(client, count, dim, *a)
        try:
            FU.launch_fused(c, hs[:2], hs[2], ["add"])
        finally:
            FU.fused_chain.launch = orig
        (count, dim), = seen
        assert dim.num_units == want
        assert torch.equal(hs[2].tensor, torch.full((8 * 1024,), 2.0,
                                                    dtype=dtype))


# -- cmma on the tensor cores (the printer's cmma-wgmma route) --------------

def _cmma_nd(dtype, M=512, N=512, K=512, plan=None):
    """``matmul_cmma_nd_kernel`` traced as ``matmul_cmma`` launches it
    (``plan``: other fragments than ``_cmma_plan``'s)."""
    from cubecl_tpu_torch.frontend import TensorArg
    from cubecl_tpu_torch.ir.types import elem_from_dtype
    from cubecl_tpu_torch.ops import matmul as mm

    tm, tn, tk = plan or mm._cmma_plan(M, N, K, dtype.itemsize, 128)
    L = mm.CMMA_LINE
    return mm.matmul_cmma_nd_kernel.define(
        (N // tn, M // tm), mm.CMMA_CUBE_DIM,
        TensorArg(torch.zeros(M * K, dtype=dtype), shape=(M, K),
                  line_size=L),
        TensorArg(torch.zeros(K * N, dtype=dtype), shape=(K, N),
                  line_size=L),
        TensorArg(torch.zeros(M * N), shape=(M, N), line_size=L,
                  mutable=True), tm, tn, tk, K, elem_from_dtype(dtype),
        checked=False)


@pytest.mark.parametrize("dtype,tag", [(torch.bfloat16, "BF16"),
                                       (torch.float16, "F16")])
@pytest.mark.parametrize("size", [512, 4096])
def test_cmma_16_bit_prints_the_tensor_core_route(dtype, tag, size):
    """``matmul_cmma_nd_kernel`` at bf16 and f16 (128 x 128 x 64
    fragments, two warpgroups) prints the tensor-core route: SS ``wgmma``
    m64n128k16 from csrc/wgmma_gemm.cuh (whose PTX is
    ``wgmma.mma_async``), the accumulator in registers (64 a thread), no
    FMA; its K loop pipelined on two stages of A and B filled by cp.async,
    so the shared memory is those stages only (2 x 32 KiB) and the
    alignment slack, with the launcher's opt-in above 48 KiB."""
    from cubecl_tpu_torch.utils.native import CSRC_DIR

    defn = _cmma_nd(dtype, size, size, size)
    src = cuda_source(defn)
    assert "mapping=cmma-wgmma warpgroups=2 register_accumulators=1" in src
    assert '#include "wgmma_gemm.cuh"' in src
    assert src.count(f"cubecl::wgmma_ss<true>(cubecl::{tag}{{}}, ") == 1
    with open(f"{CSRC_DIR}/wgmma_gemm.cuh") as f:
        assert "wgmma.mma_async.sync.aligned.m64n\" #N \"k16.f32." in f.read()
    assert "fmaf(" not in src and "kk <" not in src
    assert re.search(r"float cc_acc\d+\[1\]\[64\];", src)
    assert "cc_smem + 0);" in src and "cc_smem + 32768);" in src
    assert src.count("cubecl::cp_async16(") == 4  # prologue and loop, A, B
    assert "cubecl::cp_async_wait<1>();" in src
    assert src.index("cubecl::cp_async_wait<1>();") < src.index(
        "cubecl::fence_proxy_async();") < src.index("wgmma_fence();")
    assert "cubecl::wgmma_wait0();" in src
    want = 2 * (128 * 64 + 64 * 128) * 2 + 1024
    assert f"args, {want}," in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src


@cube
def _k_loop_peeled(a: Slice, b: Slice, out: MutSlice, k: int):
    acc = cmma.Matrix("accumulator", 128, 128, 64, f32)
    cmma.fill(acc, 0.0)
    x = cmma.Matrix("a", 128, 128, 64, bf16)
    y = cmma.Matrix("b", 128, 128, 64, bf16)
    for kk in cube_range(0, k // 64 - 1):
        cmma.load(x, a, k, kk * 64)
        cmma.load(y, b, 128, kk * 64 * 128)
        cmma.execute(x, y, acc, acc)
    cmma.load(x, a, k, k - 64)
    cmma.load(y, b, 128, (k - 64) * 128)
    cmma.execute(x, y, acc, acc)
    cmma.store(acc, out, 128)


def test_cmma_k_loop_without_the_ring():
    """A K loop whose last step is peeled off after it: its operand
    fragments are not the loop's alone, so it gets no ring. Each step's A
    and B are 16-byte loads into registers and then stores into one
    stage, fenced for the async proxy, between the barriers of every
    fragment op; 32 KiB and the slack. On the CPU twin the kernel
    computes A B (the evaluator, exact for these integers)."""
    from cubecl_tpu_torch.runtime import CpuRuntime

    K = 256
    zb = torch.zeros(128 * K, dtype=torch.bfloat16)
    args = lambda a, b, o: (ArrayArg(a), ArrayArg(b),  # noqa: E731
                            ArrayArg(o, mutable=True), K)
    src = cuda_source(_k_loop_peeled.define(
        1, 256, *args(zb, zb, torch.zeros(128 * 128)), checked=False))
    assert "mapping=cmma-wgmma" in src and "cp_async" not in src
    assert src.count("uint4 cc_t[4];") == 4
    assert src.count("cubecl::fence_proxy_async();") == 4
    assert f"args, {(128 * 64 + 64 * 128) * 2 + 1024}," in src
    r = np.random.default_rng(4)
    a = r.integers(-3, 4, (128, K)).astype(np.float32)
    b = r.integers(-3, 4, (K, 128)).astype(np.float32)
    tc = CpuRuntime.client()
    ha, hb = (tc.create(torch.from_numpy(x).reshape(-1).to(torch.bfloat16))
              for x in (a, b))
    out = tc.empty((128 * 128,), "float32")
    _k_loop_peeled.launch_unchecked(tc, 1, 256, *args(ha, hb, out))
    np.testing.assert_array_equal(tc.read_one(out).reshape(128, 128), a @ b)


@cube
def _acc_loaded(a: Slice, b: Slice, c: Slice, out: MutSlice):
    acc = cmma.Matrix("accumulator", 64, 64, 64, f32)
    cmma.load(acc, c, 64)
    x = cmma.Matrix("a", 64, 64, 64, bf16)
    cmma.load(x, a, 64)
    y = cmma.Matrix("b", 64, 64, 64, bf16)
    cmma.load(y, b, 64)
    cmma.execute(x, y, acc, acc)
    cmma.store(acc, out, 64)


@cube
def _acc_c_not_d(a: Slice, b: Slice, c: Slice, out: MutSlice):
    acc = cmma.Matrix("accumulator", 64, 64, 64, f32)
    cmma.fill(acc, 0.25)
    d = cmma.Matrix("accumulator", 64, 64, 64, f32)
    x = cmma.Matrix("a", 64, 64, 64, bf16)
    cmma.load(x, a, 64)
    y = cmma.Matrix("b", 64, 64, 64, bf16)
    cmma.load(y, b, 64)
    cmma.execute(x, y, acc, d)
    cmma.store(d, out, 64)


# ``out = A B + C`` on 64 x 64 x 64 bf16 fragments in a cube of one
# warpgroup, with an accumulator that ``load`` fills (``loaded``: C is the
# input ``c``) or a C other than D (``c_not_d``: C = 0.25)
ACC_KERNELS = {"loaded": _acc_loaded, "c_not_d": _acc_c_not_d}


def acc_args(a, b, c, out):
    return (ArrayArg(a), ArrayArg(b), ArrayArg(c), ArrayArg(out, mutable=True))


@pytest.mark.parametrize("name", ["loaded", "c_not_d"])
def test_cmma_accumulator_in_shared_memory(name):
    """An accumulator that is loaded, or whose C is not its D, stays in
    shared memory on the tensor-core route: each warpgroup's units read C
    into registers, run ``wgmma`` and write D back. On the CPU twin the
    kernel computes A B + C (the evaluator, exact for these integers)."""
    from cubecl_tpu_torch.runtime import CpuRuntime

    z = torch.zeros(4096)
    zb = torch.zeros(4096, dtype=torch.bfloat16)
    k = ACC_KERNELS[name]
    defn = k.define(1, 128, *acc_args(zb, zb, z, z), checked=False)
    src = cuda_source(defn)
    assert "mapping=cmma-wgmma warpgroups=1 register_accumulators=0" in src
    assert "float cc_d[32];" in src and "cc_acc" not in src
    assert "fmaf(" not in src
    r = np.random.default_rng(3)
    a = r.integers(-3, 4, (64, 64)).astype(np.float32)
    b = r.integers(-3, 4, (64, 64)).astype(np.float32)
    c = r.integers(-3, 4, (64, 64)).astype(np.float32)
    tc = CpuRuntime.client()
    hs = [tc.create(torch.from_numpy(x).reshape(-1).to(dt))
          for x, dt in ((a, torch.bfloat16), (b, torch.bfloat16),
                        (c, torch.float32))]
    out = tc.empty((4096,), "float32")
    k.launch_unchecked(tc, 1, 128, *acc_args(*hs, out))
    want = a @ b + (c if name == "loaded" else 0.25)
    np.testing.assert_array_equal(tc.read_one(out).reshape(64, 64), want)


@cube
def _int8_cmma(a: Slice, b: Slice, out: MutSlice):
    acc = cmma.Matrix("accumulator", 64, 64, 64, i32)
    cmma.fill(acc, 0)
    x = cmma.Matrix("a", 64, 64, 64, i8)
    cmma.load(x, a, 64)
    y = cmma.Matrix("b", 64, 64, 64, i8)
    cmma.load(y, b, 64)
    cmma.execute(x, y, acc, acc)
    cmma.store(acc, out, 64)


@cube
def _scaled_cmma(a: Slice, b: Slice, out: MutSlice):
    acc = cmma.Matrix("accumulator", 64, 64, 64, f32)
    cmma.fill(acc, 0.0)
    x = cmma.Matrix("a", 64, 64, 64, bf16)
    cmma.load(x, a, 64)
    y = cmma.Matrix("b", 64, 64, 64, bf16)
    cmma.load(y, b, 64)
    cmma.execute_scaled(x, y, acc, acc, 0.5, 2.0)
    cmma.store(acc, out, 64)


@cube
def _f32_operand_stored(a: Slice, b: Slice, out: MutSlice):
    acc = cmma.Matrix("accumulator", 64, 64, 64, f32)
    cmma.fill(acc, 0.0)
    x = cmma.Matrix("a", 64, 64, 64, f32)
    cmma.load(x, a, 64)
    y = cmma.Matrix("b", 64, 64, 64, f32)
    cmma.load(y, b, 64)
    cmma.execute(x, y, acc, acc)
    cmma.store(x, out, 64)


@cube
def _f32_both_roles(a: Slice, out: MutSlice):
    acc = cmma.Matrix("accumulator", 64, 64, 64, f32)
    cmma.fill(acc, 0.0)
    x = cmma.Matrix("a", 64, 64, 64, f32)
    cmma.load(x, a, 64)
    cmma.execute(x, x, acc, acc)
    cmma.store(acc, out, 64)


def _fma_route_cases():
    bf = torch.bfloat16
    zb, z8 = torch.zeros(4096, dtype=bf), torch.zeros(4096, dtype=torch.int8)
    z = torch.zeros(4096)
    return {
        "f32 tk 16": lambda: _cmma_nd(torch.float32, plan=(128, 128, 16)),
        "f32 operand stored": lambda: _f32_operand_stored.define(
            1, 128, ArrayArg(z), ArrayArg(z), ArrayArg(z, mutable=True),
            checked=False),
        "f32 in both roles": lambda: _f32_both_roles.define(
            1, 128, ArrayArg(z), ArrayArg(z, mutable=True), checked=False),
        "bf16 tk 32": lambda: _cmma_nd(bf, plan=(128, 128, 32)),
        "int8": lambda: _int8_cmma.define(
            1, 128, ArrayArg(z8), ArrayArg(z8),
            ArrayArg(torch.zeros(4096, dtype=torch.int32), mutable=True),
            checked=False),
        "execute_scaled": lambda: _scaled_cmma.define(
            1, 128, ArrayArg(zb), ArrayArg(zb),
            ArrayArg(torch.zeros(4096), mutable=True), checked=False),
    }


@pytest.mark.parametrize("name", list(_fma_route_cases()))
def test_cmma_outside_the_tensor_core_route_keeps_fma(name):
    """int8 fragments, ``execute_scaled``, a 16-bit K step of 32 (under one
    128-byte swizzle row), an f32 K step of 16 (under one row of f32), an
    f32 operand fragment that is stored (its halves would not give back
    the value loaded) and one used as both A and B (A is stored as it is,
    B transposed) keep the FMA route: every fragment in shared memory, a
    thread's output elements summed over K one product at a time, no
    ``wgmma``."""
    src = cuda_source(_fma_route_cases()[name]())
    assert "mapping=cmma-wgmma" not in src and "wgmma" not in src
    assert "for (int kk = 0; kk <" in src
    assert ("s += " if name == "int8" else "fmaf(") in src


# -- f32 cmma on the tensor cores, three TF32 products (cmma-wgmma-tf32x3) --

@pytest.mark.parametrize("size", [512, 4096])
def test_cmma_f32_prints_the_tf32x3_route(size):
    """``matmul_cmma_nd_kernel`` at f32 (128 x 128 x 32 fragments, two
    warpgroups) prints the 3xTF32 route: each k8 step (K 32: four) issues
    three SS ``wgmma`` m64n128k8.tf32, A_small B_big, A_big B_small, A_big
    B_big, each half through its own descriptor, into a sum of its own
    (from zero at the first product), which is then added to the
    accumulator in registers (64 a thread) in f32, no FMA: the tensor
    cores' sums round toward zero. ``load`` splits every element into
    its big and small tf32 halves (``cubecl::tf32_split``) and writes them
    K-major: A as it is (a 4-element chunk of K is one swizzled chunk of
    each half), B transposed (each of its 4 elements to its own row). The
    K loop runs on two stages filled by loads issued between the products'
    commit and their wait, not by cp.async; the shared memory is those
    stages of both halves of both operands (2 x 2 x 2 x 16 KiB) and the
    alignment slack. A load's global loads run two steps ahead of its
    products, its split and stores one."""
    from cubecl_tpu_torch.utils.native import CSRC_DIR

    src = cuda_source(_cmma_nd(torch.float32, size, size, size))
    assert ("mapping=cmma-wgmma-tf32x3 warpgroups=2 "
            "register_accumulators=1") in src
    assert '#include "wgmma_gemm.cuh"' in src
    # the TF32 wgmma in wgmma_gemm.cuh, the split in the hopper.cuh it
    # includes
    with open(f"{CSRC_DIR}/wgmma_gemm.cuh") as f:
        cuh = f.read()
    assert '#include "hopper.cuh"' in cuh
    with open(f"{CSRC_DIR}/hopper.cuh") as f:
        cuh += f.read()
    assert '"k8.f32.tf32.tf32' in cuh
    # big truncated (finite for every finite x, F12), a NaN kept one;
    # small rounded as cvt.rna.tf32.f32 in integer instructions
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in cuh
    assert "big = isnan(f) ? 0x7fffffffu : x & 0xffffe000u;" in cuh
    products = re.findall(r"cubecl::wgmma_tf32\(cc_part\[u\], (\w+), "
                          r"(\w+)(, ks > 0)?\);", src)
    assert products == [("cc_as", "cc_bb", ", ks > 0"), ("cc_ab", "cc_bs", ""),
                        ("cc_ab", "cc_bb", "")]
    # the step's products are summed from zero, then added in f32
    assert "float cc_part[1][64];" in src
    assert re.search(r"cc_acc\d+\[u\]\[j\] \+= cc_part\[u\]\[j\];", src)
    assert "for (int ks = 0; ks < 4; ++ks)" in src
    assert "cubecl::sw128_desc(cc_a + 16384 + oa, 16, 1024)" in src
    assert "cubecl::sw128_desc(cc_b + 16384 + ob, 16, 1024)" in src
    assert "fmaf(" not in src and "kk <" not in src and "cp_async" not in src
    assert "wgmma_ss" not in src
    assert re.search(r"float cc_acc\d+\[1\]\[64\];", src)
    # each load fetched three times (steps 0 and 1 before the loop, step
    # i + 2 in it) into registers it carries, and put twice (step 0, step
    # i + 1), each chunk split once
    # (B in 4 x 4 blocks a thread, transposed in registers: 16-byte
    # stores of 4 of K at each of the block's n)
    for vid in re.findall(r"uint4 cc_r(\d+)\[4\];", src):
        assert src.count(f"cc_r{vid}[q] = *reinterpret_cast<const uint4*>(") \
            == 3
    assert len(re.findall(r"uint4 cc_r(\d+)\[4\];", src)) == 2
    assert src.count("cubecl::tf32_split4(cc_r6[q], cc_big, cc_small);") == 2
    assert src.count("*reinterpret_cast<uint4*>(&cc_s6[cc_sw32(r, c, 128)])"
                     " = cc_big;") == 2
    assert src.count("cubecl::tf32_split4(make_uint4(cc_r7[q + 0].w, "
                     "cc_r7[q + 1].w, cc_r7[q + 2].w, cc_r7[q + 3].w), "
                     "cc_big, cc_small);") == 2
    assert src.count("*reinterpret_cast<uint4*>(&cc_s7[4096 + cc_sw32(c + 3, "
                     "r, 128)]) = cc_small;") == 2
    assert "cc_s7[cc_sw32(c + 0, r, 128)] = __uint_as_float" not in src
    body = src[src.index("cubecl::wgmma_commit();"):]
    assert body.index("cc_stage ^ 1") < body.index("if (cc_next2 <") \
        < body.index("cubecl::wgmma_wait0();")
    want = 2 * 2 * 2 * 128 * 32 * 4 + 1024
    assert f"args, {want}," in src


def test_cmma_f32_plan_splits_both_operands():
    """The plan of the f32 route: A and B split (B stored transposed), both
    on the loop's ring, 1024-byte aligned, the accumulator in registers;
    the launch's bytes are the four halves of each of the two stages and
    the slack."""
    from cubecl_tpu_torch.backend.cuda.printer import tensor_core_plan

    defn = _cmma_nd(torch.float32, 512, 512, 512)
    prepare_scope(defn)
    tc = tensor_core_plan(defn)
    mats = {m.vid: m for m in defn.state.matrices}
    split = tc.split
    assert sorted(split.values()) == [False, True]
    for vid, transposed in split.items():
        assert mats[vid].shape == ((32, 128) if transposed else (128, 32))
        assert vid in tc.rings and tc.offsets[vid] % 1024 == 0
    assert len(tc.regs) == 1 and not set(tc.regs) & set(split)
    assert tc.smem_bytes == 2 * 2 * 2 * 128 * 32 * 4 + 1024


@cube
def _f32_wide_acc(a: Slice, b: Slice, out: MutSlice):
    acc = cmma.Matrix("accumulator", 128, 256, 32, f32)
    cmma.fill(acc, 0.5)
    x = cmma.Matrix("a", 128, 256, 32, f32)
    cmma.load(x, a, 32)
    y = cmma.Matrix("b", 128, 256, 32, f32)
    cmma.load(y, b, 256)
    cmma.execute(x, y, acc, acc)
    cmma.store(acc, out, 256)


def test_cmma_f32_wide_accumulator_stays_in_shared_memory():
    """An f32 accumulator of more than 64 values a thread (128 x 256 over
    two warpgroups: 128) stays in shared memory on the 3xTF32 route (the
    products' own sums take as many registers beside it): each unit's
    products are summed from zero and added to C there. On the CPU twin
    the kernel computes A B + C (the evaluator, exact for these
    integers)."""
    from cubecl_tpu_torch.backend.cuda.printer import tensor_core_plan
    from cubecl_tpu_torch.runtime import CpuRuntime

    z = torch.zeros(128 * 256)
    args = (ArrayArg(z[:128 * 32]), ArrayArg(z[:32 * 256]),
            ArrayArg(z, mutable=True))
    defn = _f32_wide_acc.define(1, 256, *args, checked=False)
    prepare_scope(defn)
    assert not tensor_core_plan(defn).regs
    src = cuda_source(_f32_wide_acc.define(1, 256, *args, checked=False))
    assert "mapping=cmma-wgmma-tf32x3 warpgroups=2 register_accumulators=0" \
        in src
    assert "float cc_d[128];" in src and "cc_part" not in src
    assert re.search(r"(m\d+)\[\(r\) \* 256 \+ \(c\)\] = \1\[\(r\) \* 256 "
                     r"\+ \(c\)\] \+ cc_d\[j\];", src)
    r = np.random.default_rng(6)
    a = r.integers(-3, 4, (128, 32)).astype(np.float32)
    b = r.integers(-3, 4, (32, 256)).astype(np.float32)
    tc = CpuRuntime.client()
    ha, hb = (tc.create(torch.from_numpy(x).reshape(-1)) for x in (a, b))
    out = tc.empty((128 * 256,), "float32")
    _f32_wide_acc.launch_unchecked(tc, 1, 256, ArrayArg(ha), ArrayArg(hb),
                                   ArrayArg(out, mutable=True))
    np.testing.assert_array_equal(tc.read_one(out).reshape(128, 256),
                                  a @ b + 0.5)


@cube
def _f32_k_loop_peeled(a: Slice, b: Slice, out: MutSlice, k: int):
    acc = cmma.Matrix("accumulator", 128, 128, 32, f32)
    cmma.fill(acc, 0.0)
    x = cmma.Matrix("a", 128, 128, 32, f32)
    y = cmma.Matrix("b", 128, 128, 32, f32)
    for kk in cube_range(0, k // 32 - 1):
        cmma.load(x, a, k, kk * 32)
        cmma.load(y, b, 128, kk * 32 * 128)
        cmma.execute(x, y, acc, acc)
    cmma.load(x, a, k, k - 32)
    cmma.load(y, b, 128, (k - 32) * 128)
    cmma.execute(x, y, acc, acc)
    cmma.store(acc, out, 128)


def test_cmma_f32_k_loop_without_the_ring():
    """An f32 K loop whose last step is peeled off: no ring, so each load
    splits into one stage between the barriers of every fragment op and
    fences for the async proxy; the bytes are the halves of A and B once
    and the slack. On the CPU twin the kernel computes A B (the evaluator,
    exact for these integers)."""
    from cubecl_tpu_torch.runtime import CpuRuntime

    K = 128
    z = torch.zeros(128 * K)
    args = lambda a, b, o: (ArrayArg(a), ArrayArg(b),  # noqa: E731
                            ArrayArg(o, mutable=True), K)
    src = cuda_source(_f32_k_loop_peeled.define(
        1, 256, *args(z, z, torch.zeros(128 * 128)), checked=False))
    assert "mapping=cmma-wgmma-tf32x3" in src and "cp_async" not in src
    assert "cc_stage" not in src
    # A: a split a chunk; B: one a column of its 4 x 4 block; each twice
    assert src.count("cubecl::tf32_split4(") == 2 * (1 + 4)
    assert src.count("cubecl::fence_proxy_async();") == 4
    assert f"args, {2 * (128 * 32 + 32 * 128) * 4 + 1024}," in src
    r = np.random.default_rng(5)
    a = r.integers(-3, 4, (128, K)).astype(np.float32)
    b = r.integers(-3, 4, (K, 128)).astype(np.float32)
    tc = CpuRuntime.client()
    ha, hb = (tc.create(torch.from_numpy(x).reshape(-1)) for x in (a, b))
    out = tc.empty((128 * 128,), "float32")
    _f32_k_loop_peeled.launch_unchecked(tc, 1, 256, *args(ha, hb, out))
    np.testing.assert_array_equal(tc.read_one(out).reshape(128, 128), a @ b)


@pytest.mark.parametrize("layout", ["row_major", "col_major"])
def test_cmma_f32_unaligned_or_col_major_load_splits_element_by_element(
        layout):
    """A split load from a source that is not 16-byte aligned, or read
    column-major, takes its element path: one split a thread an element,
    each half written at the element's K-major place (a B fragment
    transposed)."""

    @cube
    def k(a: Slice, b: Slice, out: MutSlice):
        acc = cmma.Matrix("accumulator", 64, 64, 32, f32)
        cmma.fill(acc, 0.0)
        x = cmma.Matrix("a", 64, 64, 32, f32, layout)
        cmma.load(x, a, 32 if layout == "row_major" else 64, 1)
        y = cmma.Matrix("b", 64, 64, 32, f32, layout)
        cmma.load(y, b, 64 if layout == "row_major" else 32, 1)
        cmma.execute(x, y, acc, acc)
        cmma.store(acc, out, 64)

    z = torch.zeros(4097)
    src = cuda_source(k.define(1, 128, ArrayArg(z), ArrayArg(z),
                               ArrayArg(torch.zeros(4096), mutable=True),
                               checked=False))
    assert "mapping=cmma-wgmma-tf32x3" in src
    assert src.count("cubecl::tf32_split(__float_as_uint(") == 2
    assert "cc_sw32(c, r, 64)] = __uint_as_float(cc_big);" in src
    assert "[2048 + cc_sw32(r, c, 64)] = __uint_as_float(cc_small);" in src
    if layout == "col_major":
        assert "tf32_split4" not in src
