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
    """The ND kernel over 2-D tensors: on the CPU twin its three fragments
    are regions of dynamic shared memory (128 x 128 f32 accumulator, 128 x
    32 operand tiles: 96 KiB); the CUDA printer runs it on the 3xTF32
    route, its two operand fragments in shared memory (a big and a small
    half each, two stages of the K loop's ring: 128 KiB and the alignment
    slack, so the launcher opts in), the accumulator in registers; and it
    computes what the JAX package's windowed kernel computes."""
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
    assert "mapping=cmma-wgmma-tf32x3" in src
    assert src.count("cc_smem + ") == 2
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert f"dim3(256, 1, 1), args, {2 * 2 * 2 * 128 * 32 * 4 + 1024}" in src
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
               tm=128, tn=128, tk=32)
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
    stores, at most 6, and at least 3; f32 as many as the rest holds beside
    two buffers of B's big and small tf32 panels, at most 6, and at least
    3; each with its mbarriers and 1024 bytes of alignment slack. A 16-bit
    K need only be a multiple of 32 and an f32 K of 8 (the last stage may
    be partly past K: the tensor maps zero-fill it), so every shape the
    16-bit kernel took with its 64-byte stages keeps a tile, and every
    shape the f32 CUDA-core kernel took (K a multiple of 8) too."""
    m, n, k = shape
    cands = tmm._tile_candidates(m, n, k, in_bytes)
    for tm, tn, tk in cands:
        assert (tm, tn, tk) in tmm.kernel_tiles(in_bytes)
        for bt in (False, True):
            assert tmm._matmul_smem(tm, tn, tk, in_bytes, bt) <= 227 * 1024
        assert tm * tn // 256 <= 128
        assert m % tm == n % tn == 0
        assert k % {2: 32, 4: 8}.get(in_bytes, tk) == 0
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
        if in_bytes == 4:
            panels = 2 * 2 * tn * 128  # two buffers of a big and a small
            stages = min(6, (227 * 1024 - 1024 - 96 - panels)
                         // ((tm + tn) * 128))
            assert stages >= 3
            for bt in (False, True):
                assert tmm._matmul_smem(tm, tn, tk, 4, bt) \
                    == stages * ((tm + tn) * 128 + 16) + panels + 1024
    if shape != (512, 384, 96) or in_bytes != 1:
        assert cands, shape
    if in_bytes == 2:
        assert sorted(tmm.kernel_tiles(2)) == [(64, 128, 64), (128, 128, 64),
                                               (128, 256, 64), (256, 128, 64)]
    if in_bytes == 1:
        assert sorted(tmm.kernel_tiles(1)) == [(128, 128, 128),
                                               (256, 128, 128)]
    if in_bytes == 4:
        # at most 64 accumulators a thread: beside them, as many of a
        # stage's own sums (the tensor cores' sums round toward zero)
        assert sorted(tmm.kernel_tiles(4)) == [(64, 64, 32), (128, 128, 32)]


def test_kernel_tiles_match_the_cuda_source():
    """The Python tile tables are the lists the .cu files instantiate, in
    bytes of K a stage: csrc/matmul.cu's for f32 and 16-bit operands,
    csrc/matmul8.cu's for 8-bit ones; matmul.cu dispatches no 8-bit
    operands and keeps no CUDA-core f32 body, and no kernel source keeps a
    warp-level mma.sync GEMM body: every M1 GEMM runs on wgmma."""
    csrc = os.path.join(os.path.dirname(tmm.__file__), "..", "csrc")

    def tiles(name, macro):
        src = open(os.path.join(csrc, name)).read()
        # the macro's lines: continued by a trailing backslash
        body = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                         src)
        return [tuple(map(int, t)) for t in
                re.findall(r"X\((\d+), (\d+), (\d+)\)", body.group(1))]

    assert sorted(tiles("matmul.cu", "CUBECL_TF32_TILES")) == sorted(
        (m, n, k * 4) for m, n, k in tmm.kernel_tiles(4))
    assert sorted(tiles("matmul.cu", "CUBECL_WG16_TILES")) == sorted(
        (m, n, k * 2) for m, n, k in tmm.kernel_tiles(2))
    assert sorted(tiles("matmul8.cu", "CUBECL_WG_TILES")) \
        == sorted(tmm.kernel_tiles(1))
    mm_src = open(os.path.join(csrc, "matmul.cu")).read()
    assert "CUBECL_WG16_TYPE(kBF16, BF16)" in mm_src
    assert "CUBECL_WG16_TYPE(kF16, F16)" in mm_src
    for code in ("kE4M3", "kE5M2", "kI8"):
        assert f"CUBECL_WG16_TYPE({code}" not in mm_src
    assert "fma_gemm_kernel" not in mm_src and "fma_tile" not in mm_src
    assert "launch_tf32x3<BM, BN>" in mm_src
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
    csrc/matmul8.cu's wgmma body, one block a tile; 16-bit and f32 ones
    csrc/matmul.cu's wgmma bodies, persistent blocks, one a tile up to the
    H100's 132 SMs; all 384 threads (a producer and two consumer
    warpgroups) and their ring's shared memory. M2 as M1."""
    m, n, k = 512, 384, 640
    in_bytes = tmm._itemsize(in_dtype)
    tile = tmm._default_tile(m, n, k, in_bytes)
    tiles = (m // tile[0], n // tile[1])
    grid = (min(tiles[0] * tiles[1], 132), 1, 1) if in_bytes != 1 \
        else (tiles[1], tiles[0], 1)
    for bt in (False, True):
        ck = tmm._build_matmul(m, n, k, *tile, in_dtype,
                               "int32" if acc == "int32" else "float32", acc,
                               b_transposed=bt)
        m2 = tmm._build_matmul_scaled(m, n, k, *tile, in_dtype, "bfloat16",
                                      bt)
        for c in (ck, m2):
            assert c.block == (384, 1, 1)
            assert c.grid == grid
            assert c.smem_bytes == tmm._matmul_smem(*tile, in_bytes, bt)
            assert ("csrc/matmul8.cu" if in_bytes == 1
                    else "csrc/matmul.cu") in c.source
    big = tmm._build_matmul(4096, 4096, 4096, *tmm._default_tile(
        4096, 4096, 4096, in_bytes), in_dtype, "float32", acc) \
        if in_bytes != 1 else None
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
        tmm.matmul_pallas(tc, a, b, o, 256, 256, 100, 64, 64, 32)
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


# -- f32 as three TF32 products (3xTF32) -----------------------------------

_TF32_KEEP = np.uint32(0xFFFFE000)  # sign, exponent and 10 mantissa bits


_CUDA_NAN = np.uint32(0x7FFFFFFF)  # the NaN that CUDA's arithmetic returns


def _tf32(x):
    """x rounded to tf32, to nearest with ties away from zero (PTX's
    cvt.rna.tf32.f32): half a tf32 ulp added to the magnitude's bits, the
    13 low bits cleared."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & _TF32_KEEP).view(np.float32)


def _split(x, guard=True, truncate=True):
    """csrc/hopper.cuh's tf32_split: big = x truncated to tf32 (its 13
    low bits cleared; ``truncate=False``: rounded as ``_tf32``, the split
    before F12), small = tf32(x - big), a NaN's big 0x7fffffff
    (``guard``), x - big's NaN CUDA's."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    big = (u & _TF32_KEEP).view(np.float32) if truncate else _tf32(x)
    if guard:
        big = np.where(np.isnan(x), _CUDA_NAN.view(np.float32), big)
    with np.errstate(invalid="ignore"):
        d = (x - big).astype(np.float32)
    d = np.where(np.isnan(d), _CUDA_NAN.view(np.float32), d)
    return big, _tf32(d)


# phase m's shapes (chip_smoke.py: 4096^3 and the llama FFN projection,
# (M, N, K)) cut to 256 rows and 256 columns: K, along which the errors
# add up, is whole
TF32_CUTS = [(256, 256, 4096), (256, 256, 2048)]


@pytest.mark.parametrize("shape", TF32_CUTS,
                         ids=lambda s: "x".join(map(str, s)))
def test_three_tf32_products_hold_f32_where_one_does_not(shape):
    """Why the f32 GEMM (csrc/wgmma_gemm.cuh's 3xTF32 consumer) and K0's
    f32 cmma (the printer's cmma-wgmma-tf32x3 route) issue three TF32
    products a k8 step: on phase m's operands (N(0, K^-1/2), so that the
    sums are ~N(0, 1)), an emulation of the split by bit masks (big =
    tf32(x), small = tf32(x - big); A_small B_big + A_big B_small + A_big
    B_big, products of tf32 values exact in f32, sums in f32) is within
    the card's f32 tolerance (2e-5 + 1e-4 |ref|) of plain f32, with a
    margin of 4x, and as close to the float64 product as plain f32 is
    (within 2x); one TF32 product (A_big B_big) is outside it."""
    M, N, K = shape
    r = _rng(K)
    a = (r.standard_normal((M, K)) * K ** -0.25).astype(np.float32)
    b = (r.standard_normal((K, N)) * K ** -0.25).astype(np.float32)
    (ab, as_), (bb, bs) = _split(a), _split(b)
    assert np.all(np.abs(a - ab - as_) <= 2.0 ** -21 * np.abs(a))
    # truncated, big keeps x's sign and small does too
    assert np.all(np.abs(ab) <= np.abs(a)) and np.all(as_ * a >= 0)

    def mm(x, y):
        return torch.matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy()

    plain = mm(a, b)
    three = mm(as_, bb) + mm(ab, bs) + mm(ab, bb)
    one = mm(ab, bb)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    lim = 2e-5 + 1e-4 * np.abs(plain)
    assert np.max(np.abs(three - plain) / lim) < 0.25
    assert np.max(np.abs(three - exact)) < 2 * np.max(np.abs(plain - exact))
    assert np.sum(np.abs(one - plain) > lim) > 0.01 * M * N


def test_three_tf32_products_keep_nan_and_infinities():
    """The split on operands holding NaN (CUDA's 0 / 0, 0x7fffffff, and
    others whose bits an unguarded rounding carries into the exponent or
    the sign) and infinities, emulated by bit masks as in the test above:
    NaN wherever the f32 product is NaN, finite and within f32's
    tolerance wherever it is finite, an infinity of its sign or NaN
    wherever it is infinite (the cross terms inf . small), the tensor
    cores reading each operand's 19 high bits (0x7f800001 would be an
    infinity there: a NaN's big is 0x7fffffff). Rounded without the
    guard, a NaN comes out finite (0x7fffffff as -0). The card holds the
    kernels to the same (tests/test_torch_cuda.py, non_finite). And F12:
    FLT_MAX times small finite values gives the f32 product, not NaN
    (``_top_of_range_case``)."""
    M, N, K = 64, 96, 64
    r = _rng(7)
    a = (r.standard_normal((M, K)) * K ** -0.25).astype(np.float32)
    b = (r.standard_normal((K, N)) * K ** -0.25).astype(np.float32)
    odd = np.array([0x7FFFFFFF, 0x7F800001, 0xFFFFFFFF, 0xFFC00000],
                   np.uint32).view(np.float32)
    a[1, 3], a[2, 5], a[3, 7], a[40, 40] = odd
    a[4, 9], a[5, K - 1], a[13, 1], a[13, 2] = np.inf, -np.inf, np.inf, -np.inf
    b[3, 6], b[0, 12], b[K - 1, 65], b[17, 90] = odd
    b[13, 8], b[2, 10], b[6, 14], b[7, 14] = np.inf, -np.inf, np.inf, -np.inf

    def mm(x, y):
        return torch.matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy()

    def tc(x):  # as the tensor cores read a tf32 operand: 19 high bits
        return (x.view(np.uint32) & _TF32_KEEP).view(np.float32)

    def three(guard):
        (ab, as_), (bb, bs) = _split(a, guard), _split(b, guard)
        ab, as_, bb, bs = tc(ab), tc(as_), tc(bb), tc(bs)
        with np.errstate(invalid="ignore"):
            return mm(as_, bb) + mm(ab, bs) + mm(ab, bb)

    plain = mm(a, b)
    nan, inf, fin = np.isnan(plain), np.isinf(plain), np.isfinite(plain)
    assert nan.any() and inf.any() and fin.any()
    got = three(True)
    assert np.isnan(got[nan]).all()
    assert np.array_equal(np.isfinite(got), fin)
    assert (np.isnan(got[inf]) | (got[inf] == plain[inf])).all()
    lim = 2e-5 + 1e-4 * np.abs(plain[fin])
    assert np.max(np.abs(got[fin] - plain[fin]) / lim) < 1
    assert _tf32(odd[:1]).view(np.uint32)[0] == 0x80000000
    assert not np.isnan(three(False)[nan]).all()
    # F12: FLT_MAX is finite through the split
    _top_of_range_case(np.finfo(np.float32).max)


def _top_of_range_case(top):
    """F12: finite operands at the top of f32's range (``top``, the value
    just under it, -top) times small positive finite values give the f32
    product to the tolerance through the split (emulated by bit masks, the
    tensor cores reading 19 high bits), not NaN: big truncated to tf32
    stays finite where big rounded to nearest was an infinity, from (2 -
    2^-11) 2^127 on (then small = -inf and the cross terms inf - inf =
    NaN: the split before F12, checked too)."""
    M, N, K = 32, 48, 64
    r = _rng(5)
    a = (r.standard_normal((M, K)) * K ** -0.25).astype(np.float32)
    # b >= 0: row 0's sum of K products of FLT_MAX's size does not cancel
    b = (np.abs(r.standard_normal((K, N))) * 1e-30).astype(np.float32)
    near = np.nextafter(np.float32(top), np.float32(0))
    a[0, :] = top
    a[1, 3], a[2, 5], a[3, 7], a[4, K - 1] = top, -top, near, -near
    b[:, 0] = 1e-30

    def mm(x, y):
        return torch.matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy()

    def tc(x):
        return (x.view(np.uint32) & _TF32_KEEP).view(np.float32)

    overflow = np.float32((2 - 2.0 ** -11) * 2.0 ** 127)

    def three(truncate):
        (ab, as_), (bb, bs) = (_split(a, truncate=truncate),
                               _split(b, truncate=truncate))
        assert np.isfinite(ab).all() == (truncate or top < overflow)
        ab, as_, bb, bs = tc(ab), tc(as_), tc(bb), tc(bs)
        with np.errstate(invalid="ignore", over="ignore"):
            return mm(as_, bb) + mm(ab, bs) + mm(ab, bb)

    plain = mm(a, b)
    assert np.isfinite(plain).all() and np.abs(plain).max() > 1e7
    got = three(True)
    assert np.isfinite(got).all()
    lim = 2e-5 + 1e-4 * np.abs(plain)
    assert np.max(np.abs(got - plain) / lim) < 1
    assert np.isnan(three(False)).any() == (top >= overflow)


@pytest.mark.parametrize("top", [
    np.nextafter(np.finfo(np.float32).max, np.float32(0)),
    np.float32(3.4e38), np.float32((2 - 2.0 ** -11) * 2.0 ** 127)],
    ids=["under_flt_max", "3.4e38", "rounds_to_inf"])
def test_three_tf32_products_keep_the_top_of_the_range_finite(top):
    """F12 below FLT_MAX (which test_three_tf32_products_keep_nan_and_
    infinities takes): the value just under it, 3.4e38 (finite under both
    splits) and the least value that rounding to tf32 takes to infinity;
    see ``_top_of_range_case``."""
    _top_of_range_case(top)


def test_f32_route_takes_every_shape_the_cuda_core_route_took():
    """The CUDA-core f32 GEMM took M and N multiples of 64 and K a multiple
    of 8 (its 64 x 64 x 8 tile); the 3xTF32 body keeps a tile for each such
    shape (its 64 x 64 tile, K zero-filled past its end), and refuses
    another, naming its tiles."""
    for m in (64, 192, 256, 4096):
        for n in (64, 320, 5632):
            for k in (8, 24, 40, 100 - 4, 4096):
                tiles = tmm._tile_candidates(m, n, k, 4)
                assert tiles, (m, n, k)
                assert (64, 64, 32) in tiles
                for t in tiles:
                    tmm._check_tile(m, n, k, t, "float32")
    for m, n, k in ((96, 64, 64), (64, 100, 64), (64, 64, 12)):
        with pytest.raises(ValueError, match=r"tiles: \[\(64, 64, 32\)"):
            tmm._default_tile(m, n, k, 4)
