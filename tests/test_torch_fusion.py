"""Comptime fusion in the port against the JAX package, on the same numpy
inputs: the twins of ``tests/test_ops.py``'s ``test_fusion_chain`` and
``test_fusion_gelu``, and every op of ``FUSABLE``. Each chain is ONE
launch of ``fused_chain`` (a K0 kernel per (ops, number of buffers)); the
JAX side runs it in Pallas interpret mode, the port on its torch
evaluator. Tolerance: 1e-6 absolute (f32 elementwise math in the same
order), 1e-5 where the chain holds gelu (erf of two libraries)."""

import math

import numpy as np
import pytest

from cubecl_tpu.ops import fusion as jfu
from cubecl_tpu.runtime import CpuRuntime as JCpu
from cubecl_tpu_torch.ops import fusion as tfu
from cubecl_tpu_torch.runtime import CpuRuntime


@pytest.fixture(scope="module")
def jc():
    return JCpu.client()


@pytest.fixture(scope="module")
def tc():
    return CpuRuntime.client()


def _fused(jc, tc, arrays, ops, n, **kw):
    """(JAX output, port output, port launches) of one fused chain."""
    jo = jc.empty((n,), "float32")
    jfu.launch_fused(jc, [jc.create(a) for a in arrays], jo, ops, **kw)
    to = tc.empty((n,), "float32")
    launches = tc.server.launch_count
    tfu.launch_fused(tc, [tc.create(a) for a in arrays], to, ops, **kw)
    return (np.asarray(jc.read_one(jo)), tc.read_one(to),
            tc.server.launch_count - launches)


def _gelu(s):
    return s * (1 + np.array([math.erf(v / math.sqrt(2)) for v in s])) / 2


def test_fusion_chain(jc, tc):
    n = 1024
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    j, t, launches = _fused(jc, tc, (a, b, c), ["add", "mul", "relu"], n,
                            cube_dim=8)
    assert launches == 1
    np.testing.assert_allclose(t, np.maximum((a + b) * c, 0), atol=1e-6)
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)


def test_fusion_gelu(jc, tc):
    n = 1024
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    j, t, launches = _fused(jc, tc, (a, b), ["add", "gelu"], n, cube_dim=8)
    assert launches == 1
    np.testing.assert_allclose(t, _gelu(a + b), atol=1e-5)
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)


# numpy formula of each op, on one (unary) or two (binary) inputs
_NUMPY = {
    "add": np.add, "sub": np.subtract, "mul": np.multiply,
    "div": np.divide, "max": np.maximum, "min": np.minimum,
    "relu": lambda a: np.maximum(a, 0), "gelu": _gelu, "exp": np.exp,
    "tanh": np.tanh, "sqrt": np.sqrt, "neg": np.negative,
    "square": np.square,
}


def test_fusable_ops_are_the_jax_packages():
    assert list(tfu.FUSABLE) == list(jfu.FUSABLE) == list(_NUMPY)


@pytest.mark.parametrize("op", list(tfu.FUSABLE))
def test_each_fusable_op(jc, tc, op):
    """One op alone, on 2048 elements in lines of 128 (cube_dim 16), and
    after an add (a chain of two) on 1000 elements, one per unit with the
    checked tail; positive inputs so that sqrt and div are finite."""
    rng = np.random.default_rng(len(op))
    binary = op in tfu.BINARY
    for n, cd in ((2048, 16), (1000, 64)):
        xs = [(rng.random(n) + 0.5).astype(np.float32) for _ in range(3)]
        tol = 1e-5 if op == "gelu" else 1e-6
        ins = xs[:2] if binary else xs[:1]
        j, t, launches = _fused(jc, tc, ins, [op], n, cube_dim=cd)
        assert launches == 1
        want = _NUMPY[op](*ins)
        np.testing.assert_allclose(t, want, atol=tol, rtol=1e-6)
        np.testing.assert_allclose(t, j, atol=tol, rtol=0)
        ins = xs[:3] if binary else xs[:2]
        j, t, launches = _fused(jc, tc, ins, ["add", op], n, cube_dim=cd)
        assert launches == 1
        s = ins[0] + ins[1]
        want = _NUMPY[op](s, ins[2]) if binary else _NUMPY[op](s)
        np.testing.assert_allclose(t, want, atol=tol, rtol=1e-6)
        np.testing.assert_allclose(t, j, atol=tol, rtol=0)


def test_fused_chain_is_one_kernel_per_ops_and_buffers(tc):
    """Ops and buffer counts are comptime: a new chain compiles a new
    kernel, the same chain on new data reuses it; a wrong number of
    inputs is refused."""
    n = 1024
    xs = [tc.create(np.ones(n, np.float32)) for _ in range(3)]
    o = tc.empty((n,), "float32")
    c0 = tc.server.compile_count
    tfu.launch_fused(tc, xs[:2], o, ["add", "relu"], cube_dim=8)
    tfu.launch_fused(tc, xs[1:], o, ["add", "relu"], cube_dim=8)
    assert tc.server.compile_count == c0 + 1
    tfu.launch_fused(tc, xs, o, ["add", "mul"], cube_dim=8)
    assert tc.server.compile_count == c0 + 2
    np.testing.assert_array_equal(tc.read_one(o), np.full(n, 2.0))
    with pytest.raises(AssertionError, match="need 2 inputs"):
        tfu.launch_fused(tc, xs, o, ["add"], cube_dim=8)
    with pytest.raises(KeyError, match="unknown fusable op"):
        tfu.launch_fused(tc, xs[:1], o, ["cbrt"], cube_dim=8)
