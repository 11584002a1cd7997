"""The port's ``std/`` against the JAX package's, on the same inputs: twins
of every non-quant test of ``tests/test_std.py`` (layouts, FastDivmod,
identity, contiguity, ``into_contiguous`` three ways, zspace,
``reinterpret_slice`` across dtypes, the pitched policy), the helpers of
``std/misc.py``, and ``ThroughputCache``'s store round trip (its runners
measure a card, and raise on the CPU). Kernels run on the CPU twin (the
torch evaluator) and in Pallas interpret mode; values are copies or bit
casts, so they must be equal."""

import numpy as np
import pytest
import torch

import cubecl_tpu.std as J
from cubecl_tpu.frontend import ArrayArg as JArrayArg
from cubecl_tpu.frontend import MutSlice as JMutSlice
from cubecl_tpu.frontend import Slice as JSlice
from cubecl_tpu.frontend import UNIT_POS as J_UNIT_POS
from cubecl_tpu.frontend import cube as jcube
from cubecl_tpu.ir.types import i32 as j_i32
from cubecl_tpu.ir.types import u8 as j_u8
from cubecl_tpu.runtime import CpuRuntime as JCpu
from cubecl_tpu.runtime.base import CubeCount as JCubeCount
from cubecl_tpu.runtime.base import CubeDim as JCubeDim
from cubecl_tpu.std.contiguous import empty_tensor as j_empty_tensor
from cubecl_tpu.std.misc import reinterpret_slice as j_reinterpret
import cubecl_tpu_torch.std as S
from cubecl_tpu_torch.frontend import ArrayArg, MutSlice, Slice, UNIT_POS
from cubecl_tpu_torch.frontend import cube
from cubecl_tpu_torch.ir.types import f32, i32, u8
from cubecl_tpu_torch.runtime import CpuRuntime
from cubecl_tpu_torch.std.contiguous import empty_tensor
from cubecl_tpu_torch.std.misc import reinterpret_slice


@pytest.fixture(scope="module")
def jc():
    return JCpu.client()


@pytest.fixture(scope="module")
def tc():
    return CpuRuntime.client()


def test_linear_layout():
    for mod in (S, J):
        l = mod.LinearLayout((4, 8))
        assert l.to_linear(0, 0) == 0
        assert l.to_linear(1, 2) == 10
        assert l.to_linear(3, 7) == 31
        assert l.num_elements() == 32


def test_strided_layout():
    for mod in (S, J):
        l = mod.StridedLayout((4, 8), strides=(1, 4))  # column-major
        assert l.to_linear(1, 2) == 1 + 8
        assert l.to_linear(3, 0) == 3


def test_permuted_layout():
    for mod in (S, J):
        inner = mod.LinearLayout((4, 8))
        p = mod.PermutedLayout(inner, (1, 0))
        assert p.shape == (8, 4)
        assert p.to_linear(2, 1) == inner.to_linear(1, 2)


def test_slice_layout():
    for mod in (S, J):
        inner = mod.LinearLayout((8, 8))
        s = mod.SliceLayout(inner, (2, 3), (4, 4))
        assert s.to_linear(0, 0) == inner.to_linear(2, 3)
        assert s.is_in_bounds(3, 3) is True or s.is_in_bounds(3, 3)


def test_chain_and_tiled_layouts_equal_jax():
    ta = S.TiledLayout(S.LinearLayout((8, 16)), (4, 8))
    tb = J.TiledLayout(J.LinearLayout((8, 16)), (4, 8))
    assert ta.shape == tb.shape == (2, 2, 4, 8)
    for idx in np.ndindex(2, 2, 4, 8):
        assert ta.to_linear(*idx) == tb.to_linear(*idx)
    ca = S.ChainLayout(S.LinearLayout((4, 4)), S.StridedLayout((16,), (2,)))
    cb = J.ChainLayout(J.LinearLayout((4, 4)), J.StridedLayout((16,), (2,)))
    for idx in np.ndindex(4, 4):
        assert ca.to_linear(*idx) == cb.to_linear(*idx) == 2 * (
            idx[0] * 4 + idx[1])


@pytest.mark.parametrize("divisor", [1, 2, 3, 5, 7, 8, 16, 100, 127, 128,
                                     1000, 4096])
def test_fastdivmod_comptime(divisor):
    fd = S.FastDivmod(divisor)
    for x in list(range(0, 200)) + [10**6, 2**30]:
        assert fd.div(x) == x // divisor
        assert fd.mod(x) == x % divisor


@pytest.mark.parametrize("divisor", [3, 7, 100, 1000, 4095, 65537,
                                     (1 << 31) - 1])
def test_fastdivmod_magic(divisor):
    """The magic numbers divide every 31-bit dividend as a mulhi and a
    shift would in a kernel (checked on a spread of dividends, the ends
    included), and they are the JAX package's native helper's."""
    fd = S.FastDivmod(divisor)
    xs = np.unique(np.concatenate([
        np.random.default_rng(divisor).integers(0, 1 << 31, 4000),
        np.arange(0, 300), np.arange((1 << 31) - 300, 1 << 31),
        divisor * np.arange(1, 50), divisor * np.arange(1, 50) - 1]))
    xs = [int(x) for x in xs if 0 <= x < (1 << 31)]
    for x in xs:
        assert ((x * (fd.magic & 0xFFFFFFFF)) >> 32) >> fd.shift \
            == x // divisor
    j = J.FastDivmod(divisor)
    from cubecl_tpu.std import fastmath as jfm

    if jfm._native is not None:  # the JAX package's g++ helper built
        assert (fd.magic, fd.shift) == (j.magic, j.shift)


def test_identity_kernel(jc, tc):
    h = S.identity(tc, 16)
    r = tc.read_one(h).reshape(16, 16)
    np.testing.assert_array_equal(r, np.eye(16, dtype=np.float32))
    np.testing.assert_array_equal(
        r, np.asarray(jc.read_one(J.identity(jc, 16))).reshape(16, 16))


def test_tensor_handle_contiguity(tc):
    h = tc.create(np.zeros(24, np.float32))
    t = S.TensorHandle(h, (2, 3, 4))
    assert t.is_contiguous() and t.strides == (12, 4, 1)
    t2 = S.TensorHandle(h, (2, 3, 4), strides=(1, 2, 6))
    assert not t2.is_contiguous()


def _contiguous(jc, tc, x, shape, strides):
    """into_contiguous of the same strided view in both packages."""
    jh = J.TensorHandle(jc.create(x.reshape(-1)), shape, strides=strides)
    th = S.TensorHandle(tc.create(x.reshape(-1)), shape, strides=strides)
    jo, to = J.into_contiguous(jc, jh), S.into_contiguous(tc, th)
    assert to.is_contiguous() and to.shape == tuple(shape)
    t = tc.read_one(to.handle).reshape(shape)
    np.testing.assert_array_equal(
        t, np.asarray(jc.read_one(jo.handle)).reshape(shape))
    return t


def test_into_contiguous_transpose(jc, tc):
    """A permutation of contiguous memory: ``permute().contiguous()``."""
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    launches = tc.server.launch_count
    got = _contiguous(jc, tc, x, (8, 4), (1, 8))
    np.testing.assert_array_equal(got, x.T)
    assert tc.server.launch_count == launches


def test_into_contiguous_general_strided(jc, tc):
    """Every other column: not a permutation, so the gather kernel."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    launches = tc.server.launches["_copy_permuted"]
    got = _contiguous(jc, tc, x, (8, 4), (8, 2))
    np.testing.assert_array_equal(got, x[:, ::2])
    assert tc.server.launches["_copy_permuted"] == launches + 1


def test_into_contiguous_3d_permute(jc, tc):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    got = _contiguous(jc, tc, x, (4, 2, 3), (1, 12, 4))
    np.testing.assert_array_equal(got, np.transpose(x, (2, 0, 1)))


def test_into_contiguous_strided_3d_view_gathers(jc, tc):
    """A strided 3-D view (every other row of each matrix) through
    ``_copy_permuted``, as chip_smoke.py's phase q drives it."""
    x = np.arange(2 * 6 * 5, dtype=np.float32).reshape(2, 6, 5)
    got = _contiguous(jc, tc, x, (2, 3, 5), (30, 10, 1))
    np.testing.assert_array_equal(got, x[:, ::2, :])


def test_zspace_utils():
    for m in (S, J):
        assert m.contiguous_strides((2, 3, 4)) == (12, 4, 1)
        assert m.is_contiguous((2, 3), (3, 1))
        assert not m.is_contiguous((2, 3), (1, 2))
        assert m.linear_index((1, 2), (3, 1)) == 5
        assert m.delinearize(5, (2, 3)) == (1, 2)
        assert m.broadcast_shapes((2, 1, 4), (3, 1)) == (2, 3, 4)
        assert m.num_elements((2, 3, 4)) == 24
        assert m.permuted_strides((12, 4, 1), (2, 0, 1)) == (1, 12, 4)
        with pytest.raises(ValueError):
            m.broadcast_shapes((2,), (3,))
        m.validate_strides((2, 3), (3, 1))
        with pytest.raises(ValueError):
            m.validate_strides((2, 3), (1, 1))


@cube
def k_reinterp_i32(inp: Slice, out: MutSlice):
    v = reinterpret_slice(inp, i32)
    out[UNIT_POS] = v[UNIT_POS]


@cube
def k_reinterp_u8(inp: Slice, out: MutSlice):
    v = reinterpret_slice(inp, u8)  # line widens 4x
    out[UNIT_POS] = v[UNIT_POS]


@jcube
def jk_reinterp_i32(inp: JSlice, out: JMutSlice):
    v = j_reinterpret(inp, j_i32)
    out[J_UNIT_POS] = v[J_UNIT_POS]


@jcube
def jk_reinterp_u8(inp: JSlice, out: JMutSlice):
    v = j_reinterpret(inp, j_u8)
    out[J_UNIT_POS] = v[J_UNIT_POS]


def test_reinterpret_slice_cross_dtype(jc, tc):
    """Cross-dtype slice views (reference reinterpret_slice.rs): same
    width bitcast and width-changing views with line absorption, on
    ``op.reinterpret``; the bits equal numpy's view and the JAX
    package's."""
    x = np.random.default_rng(0).random(8).astype(np.float32)
    for tk, jk, dt, n, line in ((k_reinterp_i32, jk_reinterp_i32, "int32",
                                 8, 1),
                                (k_reinterp_u8, jk_reinterp_u8, "uint8", 32,
                                 4)):
        o = tc.empty((n,), dt)
        tk.launch_unchecked(tc, 1, 8, ArrayArg(tc.create(x)),
                            ArrayArg(o, line_size=line, mutable=True))
        jo = jc.empty((n,), dt)
        jk.launch_unchecked(jc, JCubeCount(1), JCubeDim.new_1d(8),
                            JArrayArg(jc.create(x)),
                            JArrayArg(jo, line_size=line, mutable=True))
        got = tc.read_one(o)
        np.testing.assert_array_equal(got, x.view(getattr(np, dt)))
        np.testing.assert_array_equal(got, np.asarray(jc.read_one(jo)))


def test_reinterpret_slice_same_type_relines():
    """Same element type: a view with another line size, no bit cast."""
    x = torch.zeros(32)
    d = k_reinterp_i32.define(1, 8, ArrayArg(x), ArrayArg(
        torch.zeros(8, dtype=torch.int32), mutable=True))
    assert "op.reinterpret" in repr(d.scope)

    @cube
    def relined(inp: Slice, out: MutSlice):
        v = reinterpret_slice(inp, f32)
        out[UNIT_POS] = v[UNIT_POS]

    d = relined.define(1, 8, ArrayArg(x, line_size=4),
                       ArrayArg(torch.zeros(32), line_size=4, mutable=True))
    assert "op.reinterpret" not in repr(d.scope)


def test_memory_layout_policy_pitched(jc, tc):
    """Pitched allocations pad the row stride (MemoryLayoutPolicy
    parity)."""
    t = empty_tensor(tc, (4, 100), policy="pitched")
    assert t.strides == (128, 1) == j_empty_tensor(
        jc, (4, 100), policy="pitched").strides
    assert not t.is_contiguous()
    c = empty_tensor(tc, (4, 100))
    assert c.is_contiguous()
    with pytest.raises(ValueError, match="unknown layout policy"):
        empty_tensor(tc, (4, 100), policy="tiled")
    # round-trip through into_contiguous: write pitched, read packed
    src = np.random.default_rng(1).random((4, 128)).astype(np.float32)
    tc.write(t.handle, src.reshape(-1))
    dense = S.into_contiguous(tc, t)
    got = tc.read_one(dense.handle).reshape(4, 100)
    np.testing.assert_array_equal(got, src[:, :100])


def test_misc_helpers_equal_jax():
    """Swizzles, the batch-layout classifier and the event bus give the
    JAX package's answers."""
    from cubecl_tpu.std import misc as jm
    from cubecl_tpu_torch.std import misc as tm

    for i in range(256):
        assert tm.swizzle_xor(i, 3, 2) == jm.swizzle_xor(i, 3, 2)
        assert tm.swizzle_2d(i // 16, i % 16, 3) == \
            jm.swizzle_2d(i // 16, i % 16, 3)
    for strides in ((4, 1), (64, 8, 1), (8, 64, 1), (64, 1, 8),
                    (32, 64, 8, 1)):
        assert tm.matrix_batch_layout(strides).value == \
            jm.matrix_batch_layout(strides).value
    bus = S.EventBus()
    seen = []
    bus.subscribe("fuse", lambda *a, **k: seen.append((a, k)))
    bus.publish("fuse", 1, op="add")
    bus.clear("fuse")
    bus.publish("fuse", 2)
    assert seen == [((1,), {"op": "add"})]
    assert isinstance(S.GLOBAL_EVENTS, S.EventBus)


@cube
def _sin_cos_k(inp: Slice, out: MutSlice):
    from cubecl_tpu_torch.std.misc import sin_cos

    s, c = sin_cos(inp[UNIT_POS])
    out[UNIT_POS] = s * s + c * c


def test_sin_cos_in_a_kernel(tc):
    x = np.linspace(-3, 3, 8).astype(np.float32)
    o = tc.empty((8,), "float32")
    _sin_cos_k.launch_unchecked(tc, 1, 8, ArrayArg(tc.create(x)),
                                ArrayArg(o, mutable=True))
    np.testing.assert_allclose(tc.read_one(o), np.ones(8), atol=1e-6)


def test_throughput_cache_store_round_trip(tc, monkeypatch, tmp_path):
    """A measured peak is stored under the device's fingerprint and read
    back by a new cache without measuring again; the runners refuse the
    CPU twin, which has no device peak to measure."""
    from cubecl_tpu_torch.std import throughput as T

    monkeypatch.setenv("CUBECL_ENVIRONMENT_ROOT", str(tmp_path))
    calls = []
    monkeypatch.setattr(T.ThroughputCache, "MODES", {
        "memory": lambda c: calls.append("memory") or 1.5e12,
        "launch": lambda c: calls.append("launch") or 4e-6})
    cache = T.ThroughputCache(tc)
    assert cache.all() == {"memory": 1.5e12, "launch": 4e-6}
    assert calls == ["memory", "launch"]
    again = T.ThroughputCache(tc)
    assert again.get("memory") == 1.5e12 and again.get("launch") == 4e-6
    assert calls == ["memory", "launch"]
    assert (tmp_path / "store.sqlite").exists()
    for runner in (T.measure_memory_bw, T.measure_compute_mxu,
                   T.measure_compute_vpu, T.measure_launch_overhead):
        with pytest.raises(RuntimeError, match="measure a CUDA card"):
            runner(tc)


def test_throughput_fma_kernel_prints_for_the_card():
    """compute_direct's kernel: FMA_CHAIN dependent FMAs per element, in
    registers (no per-element array in local memory beyond the line)."""
    from cubecl_tpu_torch.backend.cuda.printer import cuda_source
    from cubecl_tpu_torch.std import throughput as T

    src = cuda_source(T._fma_chain.define(
        4, T.FMA_CUBE, ArrayArg(torch.zeros(4 * T.FMA_CUBE * T.FMA_LINE),
                                line_size=T.FMA_LINE, mutable=True),
        T.FMA_CHAIN, checked=False))
    assert src.count("1.000001") + src.count("0x1.00001") >= 1
    assert "__global__" in src
