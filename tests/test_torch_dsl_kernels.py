"""The DSL slice's launches in the port (``CpuRuntime``: the torch
evaluator, the plain version of K0) against the JAX package's (its
``CpuRuntime``: Pallas in interpret mode), on the same numpy inputs.

Each launch picks its own plan in each package (line sizes and cube dims
differ: 4-element lines and 256-thread cubes on CUDA, 128-lane lines on
the TPU), so the comparison is of values. Tolerances:

- f32: atol 1e-6 / rtol 1e-5 — sums taken in other orders (line and plane
  reductions), and the JAX package's Pallas erf is the Abramowitz-Stegun
  7.1.26 expansion (|err| < 1.5e-7) where the port calls ``torch.erf``;
- bf16: atol/rtol 1e-2 — one bf16 rounding (2^-8 relative) of an output
  computed in f32 from the same bf16 inputs (the functional ops);
- bf16 computed in bf16 (the normalization kernels on bf16 buffers):
  atol/rtol 3e-2 — the port rounds every op to bf16, as the CUDA kernel
  does, where XLA keeps a fused chain in f32 and rounds once, so a
  layernorm's four chained ops may land a few bf16 ulps apart.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cubecl_tpu.ops import functional as jF
from cubecl_tpu.ops import gelu as jG
from cubecl_tpu.ops import normalization as jN
from cubecl_tpu.runtime import CpuRuntime as JCpu
from cubecl_tpu_torch.ops import functional as tF
from cubecl_tpu_torch.ops import gelu as tG
from cubecl_tpu_torch.ops import normalization as tN
from cubecl_tpu_torch.runtime import CpuRuntime

TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-2, 1e-2),
       "bfloat16 chain": (3e-2, 3e-2)}


@pytest.fixture(scope="module")
def jc():
    return JCpu.client()


@pytest.fixture(scope="module")
def tc():
    return CpuRuntime.client()


def _np(n_or_shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(n_or_shape)
    x = x.astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _gelu_ref(x):
    erf = np.vectorize(math.erf)
    return x * (1 + erf(x / math.sqrt(2))) / 2


@pytest.mark.parametrize("path,n", [("exact", 16384), ("checked", 1000),
                                    ("ragged", 16384 + 37),
                                    ("inplace", 16384)])
def test_launch_gelu_paths(jc, tc, path, n):
    x = _np(n, "float32", n)
    checked = path == "checked"
    jx = jc.create(x)
    jo = jx if path == "inplace" else jc.create(np.zeros_like(x))
    jG.launch_gelu(jc, jx, jo, checked=checked)
    tx = tc.create(x)
    to = tx if path == "inplace" else tc.empty(x.shape, "float32")
    launches = tc.server.launch_count
    tG.launch_gelu(tc, tx, to, checked=checked)
    assert tc.server.launch_count == launches + 1
    got = tc.read_one(to)
    _close(got, jc.read_one(jo), "float32")
    _close(got, _gelu_ref(x.astype(np.float64)), "float32")


# (rows, row): 4 x 1024 takes the *_rows kernels (rows % 8 != 0), 16 x 256
# the *_lines kernels, in both packages
SHAPES = [(4, 1024), (16, 256)]


@pytest.mark.parametrize("rows,row", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["softmax", "softmax_inplace", "normalize",
                                "layernorm"])
def test_normalization_launches(jc, tc, op, dtype, rows, row):
    x = _np((rows, row), dtype, rows + row)
    g = _np(row, dtype, 1) * 0.1 + 1
    b = _np(row, dtype, 2) * 0.1
    if dtype == "bfloat16":
        g, b = g.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)

    def run(client, N, wrap):
        hx = client.create(wrap(x))
        ho = hx if op == "softmax_inplace" else client.create(
            wrap(np.zeros_like(x)))
        if op.startswith("softmax"):
            N.launch_softmax(client, hx, ho, rows, row)
        elif op == "normalize":
            N.launch_normalize(client, hx, ho, rows, row, eps=1e-6)
        else:
            N.launch_layernorm(client, hx, client.create(wrap(g)),
                               client.create(wrap(b)), ho, rows, row)
        return np.asarray(client.read_one(ho), np.float32)

    _close(run(tc, tN, _torch), run(jc, jN, lambda a: a),
           "bfloat16 chain" if dtype == "bfloat16" else dtype)


@pytest.fixture(scope="module")
def rows_data():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    g = (rng.standard_normal(128) * 0.1 + 1.0).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    dy = rng.standard_normal((16, 128)).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["gelu", "softmax", "layernorm", "rmsnorm"])
def test_functional_forward(rows_data, op, dtype):
    x, g, b, _dy = rows_data
    if dtype == "bfloat16":
        x, g, b = (a.astype(ml_dtypes.bfloat16) for a in (x, g, b))
    args = {"gelu": (x,), "softmax": (x,), "layernorm": (x, g, b),
            "rmsnorm": (x, g)}[op]
    want = getattr(jF, op)(*(jnp.asarray(a) for a in args))
    server = CpuRuntime.client().server
    n = server.launches[f"_{op}_fwd_k"]
    got = getattr(tF, op)(*(_torch(a) for a in args))
    assert server.launches[f"_{op}_fwd_k"] == n + 1
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    _close(got.float().numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("op", ["gelu", "softmax", "layernorm", "rmsnorm"])
def test_backward_kernels(rows_data, op):
    """The four backward kernels, launched directly on the same rows
    (their autograd wiring comes with training)."""
    x, g, _b, dy = rows_data
    inv_n, eps = 1.0 / x.shape[-1], 1e-5
    if op == "softmax":
        x = np.array(jF.softmax(jnp.asarray(x)))   # the kernel takes y
    ins = {"gelu": (x, dy), "softmax": (x, dy), "layernorm": (x, g, dy),
           "rmsnorm": (x, g, dy)}[op]
    scalars = () if op in ("gelu", "softmax") else (inv_n, eps)
    name = f"_{op}_bwd_k"
    jx = jnp.asarray(x)
    want = jF._apply_rows(getattr(jF, name), jx,
                          [(jnp.asarray(a), False) for a in ins]
                          + [(jnp.zeros_like(jx), True)], scalars)
    tx = torch.from_numpy(x)
    got = tF._apply_rows(getattr(tF, name), tx,
                         [(torch.from_numpy(a), False) for a in ins]
                         + [(torch.empty_like(tx), True)], scalars)
    _close(got.numpy(), np.asarray(want), "float32")


def test_foreign_device_tensor_raises(tc):
    """A client runs kernels only on its own device's tensors."""
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="given to the server of cpu"):
        tG.launch_gelu(tc, tc.create(np.zeros(8, np.float32)),
                       tG.Handle(meta), checked=True)


def test_unchecked_out_of_bounds_raises(tc):
    """An unchecked launch whose plan reads past a buffer is a bug in the
    plan: the evaluator names it instead of reading garbage."""
    from cubecl_tpu_torch.frontend import ArrayArg

    x = tc.create(np.zeros(100, np.float32))
    o = tc.empty((100,), "float32")
    with pytest.raises(IndexError, match="outside"):
        tG.gelu_array_exact.launch_unchecked(tc, 1, 128, ArrayArg(x),
                                             ArrayArg(o, mutable=True))
