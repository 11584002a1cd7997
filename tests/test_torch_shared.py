"""K0's shared arrays (``frontend.SharedMemory``) in both backends of the
port: the torch evaluator against the JAX package's CPU runtime on the
same kernels and numpy inputs, bit for bit, and the CUDA printer's
declaration (one static ``__shared__`` array a declaration, each cube its
own) without nvcc; the card holds the printed kernels to the evaluator
(``tests/test_torch_cuda.py``). Per-unit arrays (``frontend.Array``) are
still not lowered, and both backends say so."""

import re

import numpy as np
import pytest
import torch

from cubecl_tpu import frontend as J
from cubecl_tpu.ir import types as jt
from cubecl_tpu.runtime import CpuRuntime as JCpu
from cubecl_tpu.runtime import base as jbase
from cubecl_tpu_torch import frontend as T
from cubecl_tpu_torch.backend.cuda.printer import cuda_source
from cubecl_tpu_torch.ir import types as tt
from cubecl_tpu_torch.runtime import CpuRuntime
from cubecl_tpu_torch.runtime import base as tbase


# the same kernel in both frontends: each cube reverses its units'
# values through a shared array
@T.cube
def t_reverse(x: T.Slice, out: T.MutSlice, units: int):
    sh = T.SharedMemory.new(tt.f32, units)
    sh[T.UNIT_POS] = x[T.CUBE_POS_X * units + T.UNIT_POS]
    T.sync_cube()
    out[T.CUBE_POS_X * units + T.UNIT_POS] = sh[units - 1 - T.UNIT_POS]


@J.cube
def j_reverse(x: J.Slice, out: J.MutSlice, units: int):
    sh = J.SharedMemory.new(jt.f32, units)
    sh[J.UNIT_POS] = x[J.CUBE_POS_X * units + J.UNIT_POS]
    J.sync_cube()
    out[J.CUBE_POS_X * units + J.UNIT_POS] = sh[units - 1 - J.UNIT_POS]


# lines of 4 i32 in two shared arrays: unit u adds the line of unit
# units - 1 - u to its own, and the second array holds only the cube's
# first unit's line (times 3), written by that unit alone
@T.cube
def t_lines(x: T.Slice, out: T.MutSlice, units: int):
    sh = T.SharedMemory.new(tt.i32, units, 4)
    first = T.SharedMemory.new(tt.i32, 1, 4)
    i = T.CUBE_POS_X * units + T.UNIT_POS
    sh[T.UNIT_POS] = x[i]
    if T.UNIT_POS == 0:
        first[0] = x[i] * 3
    T.sync_cube()
    out[i] = sh[units - 1 - T.UNIT_POS] + sh[T.UNIT_POS] + first[0]


@J.cube
def j_lines(x: J.Slice, out: J.MutSlice, units: int):
    sh = J.SharedMemory.new(jt.i32, units, 4)
    first = J.SharedMemory.new(jt.i32, 1, 4)
    i = J.CUBE_POS_X * units + J.UNIT_POS
    sh[J.UNIT_POS] = x[i]
    if J.UNIT_POS == 0:
        first[0] = x[i] * 3
    J.sync_cube()
    out[i] = sh[units - 1 - J.UNIT_POS] + sh[J.UNIT_POS] + first[0]


def _want(name, x, cubes, units):
    if name == "reverse":
        return x.reshape(cubes, units)[:, ::-1].reshape(-1)
    lines = x.reshape(cubes, units, 4)
    return (lines[:, ::-1] + lines + 3 * lines[:, :1]).reshape(-1)


# (kernel, cubes, units, line, dtype)
CASES = {"reverse": ((t_reverse, j_reverse), 3, 64, 1, np.float32),
         "lines": ((t_lines, j_lines), 5, 32, 4, np.int32)}


@pytest.mark.parametrize("name", CASES)
def test_shared_arrays_match_the_jax_package(name):
    (tk, jk), cubes, units, line, dt = CASES[name]
    n = cubes * units * line
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(n) * 100).astype(dt)
    outs = []
    for client, k, fe, base in ((CpuRuntime.client(), tk, T, tbase),
                                (JCpu.client(), jk, J, jbase)):
        xh, o = client.create(x), client.create(np.zeros(n, dt))
        k.launch_unchecked(client, base.CubeCount(cubes),
                           base.CubeDim.new_1d(units),
                           fe.ArrayArg(xh, line_size=line),
                           fe.ArrayArg(o, line_size=line, mutable=True),
                           units)
        outs.append(np.asarray(client.read_one(o)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], _want(name, x, cubes, units))


def test_shared_arrays_print_for_the_card():
    """A static ``__shared__`` array a declaration (its lines times its
    line, 16-byte aligned), indexed like a buffer, loads kept in a
    register after the barrier (never inlined); no warp lines."""
    src = cuda_source(t_lines.define(
        5, 32, T.ArrayArg(torch.zeros(640, dtype=torch.int32), line_size=4),
        T.ArrayArg(torch.zeros(640, dtype=torch.int32), line_size=4,
                   mutable=True), 32, checked=False))
    decls = [ln.strip() for ln in src.splitlines() if "__shared__" in ln]
    assert len(decls) == 2
    assert decls[0].startswith("__shared__ __align__(16) int32_t sh")
    assert decls[0].endswith("[128];") and decls[1].endswith("[4];")
    assert src.count("__syncthreads();") == 1
    assert "mapping=warp-lines" not in src
    sh = decls[0].split()[3].split("[")[0]
    # the store before the barrier, then the lines read into arrays
    assert f"{sh}[((int64_t)(unit_pos)) * 4 + l] = (b0[" in src
    after = src.split("__syncthreads();")[1]
    assert re.search(rf"int32_t v\d+\[4\];\n\s+for \(int l = 0; l < 4; "
                     rf"\+\+l\) v\d+\[l\] = {sh}\[", after)


def test_static_shared_memory_over_the_limit_raises():
    @T.cube
    def big(x: T.Slice, out: T.MutSlice):
        sh = T.SharedMemory.new(tt.f32, 16384)  # 64 KiB
        sh[T.UNIT_POS] = x[T.UNIT_POS]
        T.sync_cube()
        out[T.UNIT_POS] = sh[T.UNIT_POS]

    d = big.define(1, 32, T.ArrayArg(torch.zeros(32)),
                   T.ArrayArg(torch.zeros(32), mutable=True), checked=False)
    with pytest.raises(ValueError, match="65536 bytes"):
        cuda_source(d)


def test_per_unit_arrays_are_still_not_lowered():
    @T.cube
    def per_unit(x: T.Slice, out: T.MutSlice):
        a = T.Array.new(tt.f32, 4)
        a[0] = x[T.UNIT_POS]
        out[T.UNIT_POS] = a[0]

    args = (T.ArrayArg(torch.zeros(32)),
            T.ArrayArg(torch.zeros(32), mutable=True))
    with pytest.raises(NotImplementedError, match="per-unit arrays"):
        cuda_source(per_unit.define(1, 32, *args, checked=False))
    c = CpuRuntime.client()
    with pytest.raises(NotImplementedError, match="per-unit arrays"):
        per_unit.launch_unchecked(
            c, tbase.CubeCount(1), tbase.CubeDim.new_1d(32),
            T.ArrayArg(c.create(np.zeros(32, np.float32))),
            T.ArrayArg(c.create(np.zeros(32, np.float32)), mutable=True))
