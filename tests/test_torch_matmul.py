"""The matmul slice in the port (``CpuRuntime``: the plain version of the
hand-written GEMM, and the torch evaluator for the K0 cmma kernels)
against the JAX package's (its ``CpuRuntime``: Pallas in interpret mode),
on the same numpy inputs: twins of ``tests/test_ops.py``'s matmul tests
and ``tests/test_kernels2.py::test_cmma_nd_windowed_matmul``.

Tile shapes differ between the packages (the TPU's VMEM tiles against the
H100's kernel instances), so the comparison is of values. Tolerances:

- f32: rtol 1e-5, atol 1e-4 — both sum in f32 (the JAX kernels at
  ``Precision.HIGHEST``), in other orders;
- fp8 operands, f32 out: rtol 1e-5, atol 1e-5 — the products of fp8
  values are exact in f32;
- int8 operands, int32 out, and the quantized values and scales: equal;
- bf16 out: one bf16 ulp (rtol 2^-7, a bf16 ulp relative to the bottom of
  its binade) above the f32 atol 1e-4 — an f32 sum that lands on (or
  within its own rounding error of) a bf16 tie rounds to either
  neighbour, and a sum that cancels to near zero carries the f32 error.
"""

import os
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import matmul as jmm
from cubecl_tpu.runtime import CpuRuntime as JCpu
from cubecl_tpu_torch.ops import matmul as tmm
from cubecl_tpu_torch.runtime import CpuRuntime

F32 = dict(rtol=1e-5, atol=1e-4)
FP8 = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = dict(rtol=2 ** -7, atol=1e-4)


@pytest.fixture(scope="module")
def jc():
    return JCpu.client()


@pytest.fixture(scope="module")
def tc():
    return CpuRuntime.client()


def _rng(seed):
    return np.random.default_rng(seed)


def _run(client, fn, arrays, out_shape, out_dtype, *args, **kwargs):
    hs = [client.create(a.reshape(-1)) for a in arrays]
    o = client.empty((int(np.prod(out_shape)),), out_dtype)
    fn(client, *hs, o, *args, **kwargs)
    return np.asarray(client.read_one(o)).reshape(out_shape)


@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 256)])
def test_matmul_cmma(jc, tc, shape):
    M, N, K = shape
    r = _rng(M + K)
    A = r.standard_normal((M, K)).astype(np.float32)
    B = r.standard_normal((K, N)).astype(np.float32)
    want = _run(jc, jmm.matmul_cmma, (A, B), (M, N), "float32", M, N, K,
                tile=128)
    got = _run(tc, tmm.matmul_cmma, (A, B), (M, N), "float32", M, N, K,
               tile=128)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got, A @ B, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16, np.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 256)])
def test_matmul_cmma_16_bit(jc, tc, shape, dtype):
    """bf16 and f16 operands at the plan of the printer's tensor-core
    route (128 x 128 fragments, tk 64: one 128-byte swizzle row) on the
    torch evaluator, against the JAX package's ``matmul_cmma`` on the same
    inputs: the products of 16-bit values are exact in f32 and both sum
    in f32, so F32 holds."""
    M, N, K = shape
    assert tmm._cmma_plan(M, N, K, 2, 128) == (128, 128, 64)
    r = _rng(M + N + K)
    A = r.standard_normal((M, K)).astype(dtype)
    B = r.standard_normal((K, N)).astype(dtype)
    want = _run(jc, jmm.matmul_cmma, (A, B), (M, N), "float32", M, N, K,
                tile=128)
    got = _run(tc, tmm.matmul_cmma, (A, B), (M, N), "float32", M, N, K,
               tile=128)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(
        got, A.astype(np.float64) @ B.astype(np.float64), **F32)


def test_cmma_nd_windowed_matmul(jc, tc):
    """The ND kernel over 2-D tensors: in the port its three fragments are
    regions of dynamic shared memory (128 x 128 f32 accumulator, 128 x 32
    operand tiles: 96 KiB, so the launcher opts in), and it computes what
    the JAX package's windowed kernel computes."""
    from cubecl_tpu_torch.backend.cuda.printer import cuda_source
    from cubecl_tpu_torch.frontend import TensorArg
    from cubecl_tpu_torch.ir.types import f32

    M, N, K = 256, 1024, 256
    r = _rng(7)
    A = r.standard_normal((M, K)).astype(np.float32)
    B = r.standard_normal((K, N)).astype(np.float32)
    args = (TensorArg(torch.zeros(M * K), shape=(M, K), line_size=4),
            TensorArg(torch.zeros(K * N), shape=(K, N), line_size=4),
            TensorArg(torch.zeros(M * N), shape=(M, N), line_size=4,
                      mutable=True), 128, 128, 32, K, f32)
    ck = tmm.matmul_cmma_nd_kernel.compile_only(tc, (N // 128, M // 128),
                                                256, *args, checked=False)
    assert ck.smem_bytes == (128 * 128 + 2 * 128 * 32) * 4 and ck.smem_opt_in
    src = cuda_source(tmm.matmul_cmma_nd_kernel.define(
        (N // 128, M // 128), 256, *args, checked=False))
    assert src.count("cc_smem + ") == 3
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert "dim3(256, 1, 1), args, 98304" in src
    want = _run(jc, jmm.matmul_cmma, (A, B), (M, N), "float32", M, N, K,
                tile=128)
    got = _run(tc, tmm.matmul_cmma, (A, B), (M, N), "float32", M, N, K,
               tile=128)
    np.testing.assert_allclose(got, want, **F32)


def test_matmul_pallas_small(jc, tc):
    M = N = K = 256
    r = _rng(1)
    A = r.standard_normal((M, K)).astype(np.float32)
    B = r.standard_normal((K, N)).astype(np.float32)
    want = _run(jc, jmm.matmul_pallas, (A, B), (M, N), "float32", M, N, K,
                tm=128, tn=128, tk=128)
    n = tmm.matmul_pallas.launches
    got = _run(tc, tmm.matmul_pallas, (A, B), (M, N), "float32", M, N, K,
               tm=128, tn=128, tk=16)
    assert tmm.matmul_pallas.launches == n  # the CPU runs the plain version
    np.testing.assert_allclose(got, want, **F32)


def test_matmul_bf16_out_within_one_ulp(jc, tc):
    M = N = K = 256
    r = _rng(2)
    A = r.standard_normal((M, K)).astype(ml_dtypes.bfloat16)
    B = r.standard_normal((K, N)).astype(ml_dtypes.bfloat16)
    want = _run(jc, jmm.matmul_pallas, (A, B), (M, N), "bfloat16", M, N, K,
                tm=128, tn=128, tk=128)
    got = _run(tc, tmm.matmul_pallas, (A, B), (M, N), "bfloat16", M, N, K)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **BF16_ULP)


@pytest.mark.parametrize("b_transposed", [False, True])
def test_matmul_int8_exact(jc, tc, b_transposed):
    """int8 x int8 -> int32 is exact in both packages, B as (K, N) or,
    transposed, as (N, K) (the twin of test_matmul_b_transposed_exact)."""
    M = N = K = 256
    r = _rng(3)
    A = r.integers(-127, 127, (M, K)).astype(np.int8)
    B = r.integers(-127, 127, (K, N)).astype(np.int8)
    Bg = B.T.copy() if b_transposed else B
    ck = jmm._build_matmul(M, N, K, 128, 128, 128, "int8", "int32", "int32",
                           interpret=True, b_transposed=b_transposed)
    (want,) = ck.fn([jnp.asarray(A.reshape(-1)), jnp.asarray(Bg.reshape(-1)),
                     jnp.zeros(M * N, jnp.int32)])
    got = _run(tc, tmm.matmul_pallas, (A, Bg), (M, N), "int32", M, N, K,
               tm=128, tn=128, tk=128, in_dtype="int8", acc_dtype="int32",
                b_transposed=b_transposed)
    np.testing.assert_array_equal(got, np.asarray(want).reshape(M, N))
    np.testing.assert_array_equal(got, A.astype(np.int64) @ B)


@pytest.mark.parametrize("b_transposed", [False, True])
def test_matmul_quantized(jc, tc, b_transposed):
    """f32 through per-tensor int8: the port's K0 quantize kernels give
    the JAX kernels' int8 values and scales, so the exact int32 GEMM and
    its fused dequant give the same f32 outputs."""
    M = N = K = 256
    r = _rng(4 + b_transposed)
    A = r.standard_normal((M, K)).astype(np.float32)
    B = r.standard_normal((K, N)).astype(np.float32)
    Bg = B.T.copy() if b_transposed else B
    want = _run(jc, jmm.matmul_quantized, (A, Bg), (M, N), "float32", M, N,
                K, b_transposed=b_transposed)
    got = _run(tc, tmm.matmul_quantized, (A, Bg), (M, N), "float32", M, N,
               K, b_transposed=b_transposed)
    np.testing.assert_allclose(got, want, **F32)
    ref = A @ B
    assert np.abs(got - ref).max() / np.abs(ref).max() < 3e-2


@pytest.mark.parametrize("elem", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_matmul(jc, tc, elem):
    M = N = K = 256
    mdt = getattr(ml_dtypes, elem)
    r = _rng(5)
    A = (r.standard_normal((M, K)) * 0.1).astype(mdt)
    B = (r.standard_normal((K, N)) * 0.1).astype(mdt)
    want = _run(jc, jmm.matmul_pallas, (A, B), (M, N), "float32", M, N, K,
                tm=128, tn=128, tk=128, in_dtype=elem)
    got = _run(tc, tmm.matmul_pallas, (A, B), (M, N), "float32", M, N, K,
               tm=128, tn=128, tk=128, in_dtype=elem)
    np.testing.assert_allclose(got, want, **FP8)
    np.testing.assert_allclose(got, A.astype(np.float32) @ B.astype(np.float32),
                               **FP8)


def test_fp8_matmul_scaled(jc, tc):
    M = N = K = 256
    r = _rng(6)
    A = (r.standard_normal((M, K)) * 0.1).astype(ml_dtypes.float8_e4m3fn)
    B = (r.standard_normal((K, N)) * 0.1).astype(ml_dtypes.float8_e4m3fn)
    want = _run(jc, jmm.matmul_scaled, (A, B), (M, N), "float32", M, N, K,
                scale_a=4.0, scale_b=0.5, tm=128, tn=128, tk=128)
    n = tmm.matmul_scaled.launches
    got = _run(tc, tmm.matmul_scaled, (A, B), (M, N), "float32", M, N, K,
               scale_a=4.0, scale_b=0.5, tm=128, tn=128, tk=128)
    assert tmm.matmul_scaled.launches == n
    np.testing.assert_allclose(got, want, **FP8)
    np.testing.assert_allclose(
        got, (A.astype(np.float32) @ B.astype(np.float32)) * 2.0, **FP8)


SHAPES = [(4096, 4096, 4096), (8192, 5632, 2048), (256, 256, 256),
          (512, 384, 96)]


@pytest.mark.parametrize("in_bytes", [4, 2, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_tile_candidates_fit_and_divide(in_bytes, shape):
    """Every autotune candidate is a built instance, fits the 227 KiB of
    shared memory in both B layouts, keeps its accumulator within 128
    registers a thread and divides the shape. The wgmma kernels stage 128
    bytes of K (one swizzle row) in a ring: 8-bit as many stages as 144 KiB
    hold, at most 5, beside two f16 copies of a stage's B; 16-bit as many
    as the block's 227 KiB hold beside the output tile staged for its TMA
    stores, at most 6, and at least 3; each with its mbarriers and 1024
    bytes of alignment slack. A 16-bit K need only be a multiple of 32 (the last
    stage of 64 may be half past K: the tensor maps zero-fill it), so every
    shape the 16-bit kernel took with its 64-byte stages keeps a tile."""
    m, n, k = shape
    cands = tmm._tile_candidates(m, n, k, in_bytes)
    for tm, tn, tk in cands:
        assert (tm, tn, tk) in tmm.kernel_tiles(in_bytes)
        for bt in (False, True):
            assert tmm._matmul_smem(tm, tn, tk, in_bytes, bt) <= 227 * 1024
        assert tm * tn // 256 <= 128
        assert m % tm == n % tn == 0
        assert k % (32 if in_bytes == 2 else tk) == 0
        if in_bytes == 1:
            stages = min(5, 144 * 1024 // ((tm + tn) * 128))
            assert stages >= 3
            for bt in (False, True):
                assert tmm._matmul_smem(tm, tn, tk, 1, bt) \
                    == stages * ((tm + tn) * 128 + 16) + 2 * tn * 256 + 1024
        if in_bytes == 2:
            out = tm * tn * 2  # the output tile, staged for TMA stores
            stages = min(6, (227 * 1024 - 1024 - 96 - out)
                         // ((tm + tn) * 128))
            assert stages >= 3
            for bt in (False, True):
                assert tmm._matmul_smem(tm, tn, tk, 2, bt) \
                    == stages * ((tm + tn) * 128 + 16) + out + 1024
    if shape != (512, 384, 96) or in_bytes != 1:
        assert cands, shape
    if in_bytes == 2:
        assert sorted(tmm.kernel_tiles(2)) == [(64, 128, 64), (128, 128, 64),
                                               (128, 256, 64), (256, 128, 64)]
    if in_bytes == 1:
        assert sorted(tmm.kernel_tiles(1)) == [(128, 128, 128),
                                               (256, 128, 128)]


def test_kernel_tiles_match_the_cuda_source():
    """The Python tile tables are the lists the .cu files instantiate:
    csrc/matmul.cu's for f32 and 16-bit operands (the 16-bit ones in bytes
    of K a stage), csrc/matmul8.cu's for 8-bit ones; matmul.cu dispatches
    no 8-bit operands, and no kernel source keeps a warp-level mma.sync
    GEMM body: every 16- and 8-bit GEMM runs on wgmma."""
    csrc = os.path.join(os.path.dirname(tmm.__file__), "..", "csrc")

    def tiles(name, macro):
        src = open(os.path.join(csrc, name)).read()
        # the macro's lines: continued by a trailing backslash
        body = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                         src)
        return [tuple(map(int, t)) for t in
                re.findall(r"X\((\d+), (\d+), (\d+)\)", body.group(1))]

    assert sorted(tiles("matmul.cu", "CUBECL_FMA_TILES")) \
        == sorted(tmm.kernel_tiles(4))
    assert sorted(tiles("matmul.cu", "CUBECL_WG16_TILES")) == sorted(
        (m, n, k * 2) for m, n, k in tmm.kernel_tiles(2))
    assert sorted(tiles("matmul8.cu", "CUBECL_WG_TILES")) \
        == sorted(tmm.kernel_tiles(1))
    mm_src = open(os.path.join(csrc, "matmul.cu")).read()
    assert "CUBECL_WG16_TYPE(kBF16, BF16)" in mm_src
    assert "CUBECL_WG16_TYPE(kF16, F16)" in mm_src
    for code in ("kE4M3", "kE5M2", "kI8"):
        assert f"CUBECL_WG16_TYPE({code}" not in mm_src
    for name in os.listdir(csrc):
        if name.endswith((".cu", ".cuh")):
            src = open(os.path.join(csrc, name)).read()
            assert "mma.sync.aligned" not in src, name


@pytest.mark.parametrize("in_dtype,acc", [("float8_e4m3fn", "float32"),
                                          ("float8_e5m2", "float32"),
                                          ("int8", "int32"),
                                          ("bfloat16", "float32"),
                                          ("float16", "float32"),
                                          ("float32", "float32")])
def test_matmul_launch_plan_by_body(in_dtype, acc):
    """The launch each operand type validates: 8-bit operands run
    csrc/matmul8.cu's wgmma body, one block a tile; 16-bit ones
    csrc/matmul.cu's wgmma body, persistent blocks, one a tile up to the
    H100's 132 SMs; both 384 threads (a producer and two consumer
    warpgroups) and their ring's shared memory. f32 runs csrc/matmul.cu's
    256-thread blocks, one a tile. M2 as M1."""
    m, n, k = 512, 384, 640
    in_bytes = tmm._itemsize(in_dtype)
    tile = tmm._default_tile(m, n, k, in_bytes)
    tiles = (m // tile[0], n // tile[1])
    grid = (min(tiles[0] * tiles[1], 132), 1, 1) if in_bytes == 2 \
        else (tiles[1], tiles[0], 1)
    for bt in (False, True):
        ck = tmm._build_matmul(m, n, k, *tile, in_dtype,
                               "int32" if acc == "int32" else "float32", acc,
                               b_transposed=bt)
        m2 = tmm._build_matmul_scaled(m, n, k, *tile, in_dtype, "bfloat16",
                                      bt)
        for c in (ck, m2):
            assert c.block == ((256 if in_bytes == 4 else 384), 1, 1)
            assert c.grid == grid
            assert c.smem_bytes == tmm._matmul_smem(*tile, in_bytes, bt)
            assert ("csrc/matmul8.cu" if in_bytes == 1
                    else "csrc/matmul.cu") in c.source
    big = tmm._build_matmul(4096, 4096, 4096, 128, 256, 64, in_dtype,
                            "float32", acc) if in_bytes == 2 else None
    if big is not None:
        assert big.grid == (132, 1, 1)


@pytest.mark.parametrize("k", [32, 96, 160, 640])
def test_16bit_k_takes_a_zero_filled_half_stage(k):
    """A 16-bit tile stages 64 of K; K needs to be a multiple of 32 only
    (the tensor maps zero-fill a last half stage), so each of these K keeps
    every tile that divides M and N, and a K off the 32 grid is refused
    with ValueError as before."""
    m, n = 512, 512
    assert sorted(tmm._tile_candidates(m, n, k, 2)) == sorted(
        tmm.kernel_tiles(2))
    for tile in tmm.kernel_tiles(2):
        tmm._check_tile(m, n, k, tile, "bfloat16")
        with pytest.raises(ValueError, match="does not divide"):
            tmm._check_tile(m, n, k + 16, tile, "float16")


def test_bad_tiles_and_types_raise(tc):
    a = tc.create(np.zeros((256, 256), np.float32))
    b = tc.create(np.zeros((256, 256), np.float32))
    o = tc.empty((256, 256), "float32")
    with pytest.raises(ValueError, match="not built"):
        tmm.matmul_pallas(tc, a, b, o, 256, 256, 256, 128, 128, 128)
    with pytest.raises(ValueError, match="does not divide"):
        tmm.matmul_pallas(tc, a, b, o, 256, 256, 100, 64, 64, 8)
    oi = tc.empty((256, 256), "int32")
    with pytest.raises(ValueError, match="int32 output"):
        tmm.matmul_pallas(tc, a, b, oi, 256, 256, 256)
    with pytest.raises(ValueError, match="own dtype"):
        tmm.matmul_pallas(tc, a, b, o, 256, 256, 256, in_dtype="bfloat16")


def test_matmul_plain_is_the_kernel_arithmetic():
    """The plain version: fp8 upcast exactly, int8 exact in int64 and
    wrapped to int32, the scale applied to f32(acc) before the cast."""
    r = _rng(9)
    a = torch.from_numpy(r.integers(-128, 127, (64, 96)).astype(np.int8))
    b = torch.from_numpy(r.integers(-128, 127, (64, 96)).astype(np.int8))
    acc = a.long() @ b.long().t()
    assert torch.equal(tmm.matmul_plain(a, b, torch.int32, True),
                       acc.to(torch.int32))
    got = tmm.matmul_plain(a, b, torch.bfloat16, True,
                           tmm._scale_product(0.1, 0.3))
    s = np.float32(0.1) * np.float32(0.3)
    assert torch.equal(got, (acc.float() * float(s)).to(torch.bfloat16))
