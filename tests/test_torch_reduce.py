"""Reductions in the port against the JAX package, on the same numpy
inputs: the twins of ``tests/test_ops.py``'s reduce tests, of
``tests/test_tune.py::test_autotuned_reduce``, of ``tests/test_dynamic.py``'s
``block_sum_dyn`` kernel (at a static grid), and of the examples
``sum_things`` and ``reduction_progression`` at their CPU shape. The JAX
side runs on its CPU runtime (Pallas in interpret mode), the port on its
CPU twin (the torch evaluator for the ``@cube`` kernels, R1's plain
version for ``reduce_sum_native``).

Tolerances: f32 sums within rtol 1e-4 of the float64 sum (as
``test_ops.py``), and the two packages within 1e-5 * sum|x| of each
other (f32 sums in two orders); bf16 sums rtol 2e-2 (as ``test_ops.py``);
max, min and the examples' small integer sums equal."""

import ml_dtypes
import numpy as np
import pytest
import torch

from cubecl_tpu.frontend import ArrayArg as JArrayArg
from cubecl_tpu.frontend import CUBE_POS_X as J_CUBE_POS_X
from cubecl_tpu.frontend import MutSlice as JMutSlice
from cubecl_tpu.frontend import Slice as JSlice
from cubecl_tpu.frontend import cube as jcube
from cubecl_tpu.ops import reduce as jR
from cubecl_tpu.runtime import CpuRuntime as JCpu
from cubecl_tpu.runtime.base import CubeCount as JCubeCount
from cubecl_tpu.runtime.base import CubeDim as JCubeDim
from cubecl_tpu_torch.frontend import CUBE_POS_X, ArrayArg, MutSlice, Slice
from cubecl_tpu_torch.frontend import cube
from cubecl_tpu_torch.ops import reduce as tR
from cubecl_tpu_torch.runtime import CpuRuntime


@pytest.fixture(scope="module")
def jc():
    return JCpu.client()


@pytest.fixture(scope="module")
def tc():
    return CpuRuntime.client()


@pytest.fixture(autouse=True)
def store_root(monkeypatch, tmp_path):
    """The autotuned route's store goes to a fresh directory."""
    monkeypatch.setenv("CUBECL_ENVIRONMENT_ROOT", str(tmp_path))


def _run(jc, tc, jfn, tfn, x):
    """(JAX result, port result) of ``fn(client, handle)`` on ``x``."""
    j = np.asarray(jc.read_one(jfn(jc, jc.create(x))))
    t = tc.read_one(tfn(tc, tc.create(x)))
    return j, t


def _sums_agree(j, t, x, rtol=1e-4):
    ref = x.astype(np.float64).sum()
    np.testing.assert_allclose(j[0], ref, rtol=rtol)
    np.testing.assert_allclose(t[0], ref, rtol=rtol)
    assert abs(float(t[0]) - float(j[0])) <= \
        1e-5 * np.abs(x.astype(np.float64)).sum()


def _normal(seed, n, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def test_reduce_sum(jc, tc):
    x = _normal(0, 1 << 14)
    j, t = _run(jc, tc,
                lambda c, h: jR.reduce_sum(c, h, line_size=128,
                                           target_cubes=8),
                lambda c, h: tR.reduce_sum(c, h, line_size=128,
                                           target_cubes=8), x)
    assert t.dtype == np.float32 and t.shape == (1,)
    _sums_agree(j, t, x)


@pytest.mark.parametrize("n,br", [(1 << 14, 512), (128 * 1000, 64),
                                  (128 * 24, 8)])
def test_reduce_sum_native(jc, tc, n, br):
    """R1 at the JAX test's three (n, block_rows): the plain version here;
    on the card the kernel (tests/test_torch_cuda.py)."""
    x = _normal(n, n)
    j, t = _run(jc, tc,
                lambda c, h: jR.reduce_sum_native(c, h, block_rows=br),
                lambda c, h: tR.reduce_sum_native(c, h, block_rows=br), x)
    _sums_agree(j, t, x)
    plain = tR.reduce_sum_native_plain(torch.from_numpy(x))
    assert plain.dtype == torch.float32 and plain.shape == (1,)
    assert float(plain[0]) == float(t[0])


def test_reduce_sum_native_takes_16_bit_floats(tc):
    """R1 sums bf16 and f16 in f32, and refuses what the kernel does
    not take."""
    x = _normal(5, 128 * 64)
    for dt in (ml_dtypes.bfloat16, np.float16):
        xs = x.astype(dt)
        got = tc.read_one(tR.reduce_sum_native(tc, tc.create(xs)))
        np.testing.assert_allclose(got[0], xs.astype(np.float64).sum(),
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="sums"):
        tR.reduce_sum_native(tc, tc.create(np.zeros(128, np.int32)))


def test_reduce_max_negative(jc, tc):
    x = (-np.abs(_normal(1, 4096))).astype(np.float32)  # all negative
    j, t = _run(jc, tc,
                lambda c, h: jR.reduce_max(c, h, line_size=128,
                                           target_cubes=8),
                lambda c, h: tR.reduce_max(c, h, line_size=128,
                                           target_cubes=8), x)
    assert t[0] == j[0] == x.max()


def test_reduce_mean(jc, tc):
    x = _normal(2, 4096)
    j, t = _run(jc, tc,
                lambda c, h: jR.reduce_mean(c, h, line_size=128,
                                            target_cubes=8),
                lambda c, h: tR.reduce_mean(c, h, line_size=128,
                                            target_cubes=8), x)
    np.testing.assert_allclose(t[0], x.astype(np.float64).mean(), rtol=1e-4)
    np.testing.assert_allclose(j[0], x.astype(np.float64).mean(), rtol=1e-4)
    assert abs(float(t[0]) - float(j[0])) <= \
        1e-5 * np.abs(x.astype(np.float64)).mean()


def test_reduce_sum_bf16(jc, tc):
    x = _normal(3, 1 << 13, ml_dtypes.bfloat16)
    j, t = _run(jc, tc,
                lambda c, h: jR.reduce_sum(c, h, line_size=128,
                                           target_cubes=8),
                lambda c, h: tR.reduce_sum(c, h, line_size=128,
                                           target_cubes=8), x)
    ref = x.astype(np.float32).sum()
    np.testing.assert_allclose(t[0], ref, rtol=2e-2)
    np.testing.assert_allclose(j[0], ref, rtol=2e-2)
    np.testing.assert_allclose(t[0], j[0], rtol=2e-2)


@pytest.mark.parametrize("n,cubes", [(1 << 14, 4), (512 * 48, 6),
                                     (4096, 64)])
def test_reduce_sum_blockwise(jc, tc, n, cubes):
    """``block_sum`` (``mem.block_reduce``) per cube at the JAX test's
    three (n, cubes)."""
    x = _normal(4 + n, n)
    j, t = _run(jc, tc,
                lambda c, h: jR.reduce_sum_blockwise(c, h, cubes=cubes),
                lambda c, h: tR.reduce_sum_blockwise(c, h, cubes=cubes), x)
    _sums_agree(j, t, x)


def test_autotuned_reduce(jc, tc):
    """Every candidate of both packages is timed on the host and the
    winner's sum agrees; the port's winner is one of its ten candidates
    (four native_br*, three blockwise_c*, three line128_cubes*)."""
    from cubecl_tpu.ops import reduce_sum_autotuned as j_auto

    x = _normal(6, 1 << 13)
    j, t = _run(jc, tc, j_auto, tR.reduce_sum_autotuned, x)
    _sums_agree(j, t, x)
    key = ("sum", 1 << 13, "float32")
    h = tc.create(x)
    ts_names = None
    for (fp, k, ck), tuner in tR._sum_tuner._tuners.items():
        if k == str(key):
            ts_names = [tt.name for tt in tuner.tunables.tunables]
            assert tuner.cache.get(key) is not None
    assert ts_names is not None and len(ts_names) == 10
    assert float(tc.read_one(tR.reduce_sum_autotuned(tc, h))[0]) == \
        float(t[0])


def test_autotuned_reduce_raises_when_r1_fails(tc, monkeypatch):
    """A build error of R1 fails the autotuned call loudly: its native_br*
    candidates are never pruned in favour of a K0 route."""
    from cubecl_tpu_torch.utils.native import KernelBuildError

    def broken(*args, **kwargs):
        raise KernelBuildError("nvcc failed")

    monkeypatch.setattr(tR, "reduce_sum_native", broken)
    h = tc.create(_normal(9, 128 * 8 * 5))
    with pytest.raises(KernelBuildError, match="nvcc"):
        tR.reduce_sum_autotuned(tc, h)


# -- tests/test_dynamic.py's block_sum_dyn, at a static grid ---------------

LPC = 8  # lines a cube


@jcube
def _j_block_sum(inp: JSlice, out: JMutSlice, lines_per_cube: int):
    s = inp.block_sum(J_CUBE_POS_X * lines_per_cube, lines_per_cube)
    out[J_CUBE_POS_X] = s


@cube
def _t_block_sum(inp: Slice, out: MutSlice, lines_per_cube: int):
    s = inp.block_sum(CUBE_POS_X * lines_per_cube, lines_per_cube)
    out[CUBE_POS_X] = s


@pytest.mark.parametrize("n_lines", [8, 32, 64])
def test_block_sum_static_grid(jc, tc, n_lines):
    """One block_sum per cube over slabs of 8 lines of 128, one unit a
    cube, as test_reduce_dynamic_one_compile launches it (its runtime
    grid and dynamic length stay ROADMAP leftover 3)."""
    x = _normal(7, n_lines * 128)
    cubes = n_lines // LPC
    jo = jc.create(np.zeros(cubes, np.float32))
    _j_block_sum.launch_unchecked(
        jc, JCubeCount(cubes), JCubeDim.new_1d(1),
        JArrayArg(jc.create(x), line_size=128), JArrayArg(jo, mutable=True),
        LPC)
    to = tc.create(np.zeros(cubes, np.float32))
    _t_block_sum.launch_unchecked(
        tc, cubes, 1, ArrayArg(tc.create(x), line_size=128),
        ArrayArg(to, mutable=True), LPC)
    j, t = np.asarray(jc.read_one(jo)), tc.read_one(to)
    want = x.astype(np.float64).reshape(cubes, -1).sum(1)
    np.testing.assert_allclose(t, want, rtol=1e-4, atol=1e-4)
    assert np.abs(t - j).max() <= 1e-5 * np.abs(x).sum()
    np.testing.assert_allclose(t.sum(), x.sum(), rtol=1e-4)


@cube
def _t_block_ops(inp: Slice, out: MutSlice, lines: int):
    out[CUBE_POS_X * 4] = inp.block_sum(CUBE_POS_X * lines, lines)
    out[CUBE_POS_X * 4 + 1] = inp.block_max(CUBE_POS_X * lines, lines)
    out[CUBE_POS_X * 4 + 2] = inp.block_min(CUBE_POS_X * lines, lines)
    out[CUBE_POS_X * 4 + 3] = inp.block_prod(CUBE_POS_X * lines, lines)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_reduce_kinds_and_types(tc, dtype):
    """sum, max, min and prod over each cube's window; a bf16 buffer
    gives bf16 results, its sum and product accumulated in f32 and
    rounded once (the JAX evaluator's rule)."""
    tdt = getattr(torch, dtype)
    x = (torch.rand(3, 2, 4, generator=torch.Generator().manual_seed(8))
         + 0.5).to(tdt)
    out = tc.empty((12,), dtype)
    _t_block_ops.launch_unchecked(tc, 3, 8, ArrayArg(tc.create(x.reshape(-1)),
                                                     line_size=4),
                                  ArrayArg(out, mutable=True), 2)
    got = out.tensor.view(3, 4)
    assert got.dtype == tdt
    w = x.reshape(3, -1)
    want = torch.stack([w.float().sum(1).to(tdt), w.amax(1), w.amin(1),
                        w.float().prod(1).to(tdt)], 1)
    assert torch.equal(got, want)


def test_block_reduce_start_must_be_cube_uniform(tc):
    from cubecl_tpu_torch.frontend import UNIT_POS

    @cube
    def varying(inp: Slice, out: MutSlice):
        out[UNIT_POS] = inp.block_sum(UNIT_POS, 1)

    with pytest.raises(NotImplementedError, match="unit-varying"):
        varying.launch_unchecked(tc, 1, 8, ArrayArg(tc.create(np.ones(16,
                                                                  np.float32))),
                                 ArrayArg(tc.empty((8,), "float32"),
                                          mutable=True))


# -- the examples: sum_things and reduction_progression ---------------------


@pytest.mark.parametrize("variant", ["basic", "subgroup", "trait:plane",
                                     "trait:basic"])
def test_sum_things(jc, tc, variant):
    """examples/sum_things.py's four launches, on np.arange(8): every
    unit holds 28."""
    import examples.sum_things as js
    from cubecl_tpu_torch.examples import sum_things as ts

    data = np.arange(8, dtype=np.float32)
    ji, jo = jc.create(data), jc.empty((8,), "float32")
    jl = {
        "basic": lambda: js.sum_basic.launch_unchecked(
            jc, JCubeCount(1), JCubeDim.new_1d(8), JArrayArg(ji),
            JArrayArg(jo, mutable=True), 8),
        "subgroup": lambda: js.sum_subgroup.launch_unchecked(
            jc, JCubeCount(1), JCubeDim.new_1d(8), JArrayArg(ji),
            JArrayArg(jo, mutable=True), True),
        "trait:plane": lambda: js.sum_trait.launch_unchecked(
            jc, JCubeCount(1), JCubeDim.new_1d(8), JArrayArg(ji),
            JArrayArg(jo, mutable=True), js.sum_plane_kind),
        "trait:basic": lambda: js.sum_trait.launch_unchecked(
            jc, JCubeCount(1), JCubeDim.new_1d(8), JArrayArg(ji),
            JArrayArg(jo, mutable=True), js.sum_basic_kind),
    }[variant]
    jl()
    ti, to = tc.create(data), tc.empty((8,), "float32")
    ts.variants(tc, ti, to)[variant]()
    j, t = np.asarray(jc.read_one(jo)), tc.read_one(to)
    if variant in ("subgroup", "trait:plane"):
        np.testing.assert_array_equal(t, np.full(8, 28.0, np.float32))
    else:
        assert t[0] == 28.0
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("stage", ["naive", "parallel", "vectorized",
                                   "plane-tree"])
def test_reduction_progression(jc, tc, stage):
    """examples/reduction_progression.py's four stages at its CPU shape
    (64 x 512, lines of 64), each against numpy and the JAX kernel. The
    JAX package's "parallel" stage gives wrong row sums on its CPU runtime
    (the script's own check fails there: ROADMAP Queue 3, F8), so that
    stage is held against numpy alone."""
    import examples.reduction_progression as jp
    from cubecl_tpu_torch.examples import reduction_progression as tp

    rows, cols, nr, nc = tp.SMALL
    L = tp.line_of(cols)
    x = np.random.default_rng(9).random((rows, cols), dtype=np.float32)
    jh = jc.create(x.reshape(-1))
    jo = jc.empty((rows,), "float32")
    jstage = {
        "naive": (jp.reduce_naive, 1, (JArrayArg(jh),
                                       JArrayArg(jo, mutable=True), nr, nc)),
        "parallel": (jp.reduce_parallel, rows // 8,
                     (JArrayArg(jh), JArrayArg(jo, mutable=True), cols)),
        "vectorized": (jp.reduce_vectorized, rows // 8,
                       (JArrayArg(jh, line_size=L),
                        JArrayArg(jo, mutable=True), cols // L)),
        "plane-tree": (jp.reduce_plane_tree, rows,
                       (JArrayArg(jh, line_size=L),
                        JArrayArg(jo, mutable=True), cols // (L * 8))),
    }[stage]
    k, cubes, args = jstage
    k.launch_unchecked(jc, JCubeCount(cubes), JCubeDim.new_1d(8), *args)
    th = tc.create(x.reshape(-1))
    to = tc.empty((rows,), "float32")
    k, cc, cd, targs = tp.stages(th, to, th, to, rows, cols, nr, nc)[stage]
    k.launch_unchecked(tc, cc, cd, *targs)
    j, t = np.asarray(jc.read_one(jo)), tc.read_one(to)
    want = x.astype(np.float64).sum(1)
    np.testing.assert_allclose(t, want, rtol=1e-5)
    if stage != "parallel":
        np.testing.assert_allclose(t, j, rtol=1e-5)
