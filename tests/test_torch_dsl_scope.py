"""The 18 ``@cube`` kernels of the port's DSL slice trace to the same
optimized scope as in the JAX package.

Each kernel is traced in both packages for the same launch (cube count,
cube dim, buffer shapes, line sizes, comptime values), run through the
same passes in the order of ``PallasCompiler.compile`` (processors,
optimize, checked IO when checked, optimize) at the same plane width, and
the scope listings must be equal character for character. The port keeps
the kernel bodies and the passes unchanged; this is what shows it.
"""

import numpy as np
import pytest
import torch

import cubecl_tpu.frontend as jfe
from cubecl_tpu.frontend.cube import _as_count, _as_dim
from cubecl_tpu.ops import functional as jF
from cubecl_tpu.ops import gelu as jG
from cubecl_tpu.ops import normalization as jN
from cubecl_tpu.opt.checked_io import insert_checked_io as j_checked
from cubecl_tpu.opt.passes import optimize_scope as j_optimize
from cubecl_tpu.opt.processors import FastMathProcessor as JFastMath
from cubecl_tpu.opt.processors import run_processors as j_run
import cubecl_tpu_torch.frontend as tfe
from cubecl_tpu_torch.backend.compiler import prepare_scope
from cubecl_tpu_torch.ops import functional as tF
from cubecl_tpu_torch.ops import gelu as tG
from cubecl_tpu_torch.ops import normalization as tN

PLANE = 8   # the JAX package's plane; the port's passes take it as given

# (module pair, kernel, cube count, cube dim, checked, args); a buffer arg
# is ("b", elements, dtype, line, mutable), anything else is comptime
R, D = 16, 256
KERNELS = [
    ("gelu", "gelu_array", 4, 64, True,
     [("b", 1000, "float32", 1, False), ("b", 1000, "float32", 1, True)]),
    ("gelu", "gelu_array_exact", 4, 64, False,
     [("b", 4096, "float32", 16, False), ("b", 4096, "float32", 16, True)]),
    ("gelu", "gelu_inplace", 2, 64, False,
     [("b", 4096, "float32", 8, True), 4, 64]),
    ("norm", "layernorm_rows", 4, 8, False,
     [("b", 4 * 1024, "float32", 4, False), ("b", 1024, "float32", 4, False),
      ("b", 1024, "float32", 4, False), ("b", 4 * 1024, "float32", 4, True),
      32, 1 / 1024, 1e-5]),
    ("norm", "softmax_rows", 4, 8, False,
     [("b", 4 * 1024, "float32", 4, False),
      ("b", 4 * 1024, "float32", 4, True), 32]),
    ("norm", "normalize_rows", 4, 8, False,
     [("b", 4 * 1024, "float32", 4, False),
      ("b", 4 * 1024, "float32", 4, True), 32, 0.0]),
    ("norm", "softmax_lines", 2, 8, False,
     [("b", R * D, "float32", D, False), ("b", R * D, "float32", D, True),
      1, 8]),
    ("norm", "softmax_lines_inplace", 2, 8, False,
     [("b", R * D, "bfloat16", D, True), 1, 8]),
    ("norm", "layernorm_lines", 2, 8, False,
     [("b", R * D, "bfloat16", D, False), ("b", D, "bfloat16", D, False),
      ("b", D, "bfloat16", D, False), ("b", R * D, "bfloat16", D, True),
      1, 8, 1 / D, 1e-5]),
    ("norm", "normalize_lines", 2, 8, False,
     [("b", R * D, "float32", D, False), ("b", R * D, "float32", D, True),
      1, 8, 1e-6]),
    ("fn", "_gelu_fwd_k", 2, 8, False,
     [("b", R * D, "float32", D, False), ("b", R * D, "float32", D, True)]),
    ("fn", "_gelu_bwd_k", 2, 8, False,
     [("b", R * D, "float32", D, False), ("b", R * D, "float32", D, False),
      ("b", R * D, "float32", D, True)]),
    ("fn", "_softmax_fwd_k", 2, 8, False,
     [("b", R * D, "bfloat16", D, False), ("b", R * D, "bfloat16", D, True)]),
    ("fn", "_softmax_bwd_k", 2, 8, False,
     [("b", R * D, "float32", D, False), ("b", R * D, "float32", D, False),
      ("b", R * D, "float32", D, True)]),
    ("fn", "_layernorm_fwd_k", 2, 8, False,
     [("b", R * D, "bfloat16", D, False), ("b", D, "bfloat16", D, False),
      ("b", D, "bfloat16", D, False), ("b", R * D, "bfloat16", D, True),
      1 / D, 1e-5]),
    ("fn", "_layernorm_bwd_k", 2, 8, False,
     [("b", R * D, "float32", D, False), ("b", D, "float32", D, False),
      ("b", R * D, "float32", D, False), ("b", R * D, "float32", D, True),
      1 / D, 1e-5]),
    ("fn", "_rmsnorm_fwd_k", 2, 8, False,
     [("b", R * D, "bfloat16", D, False), ("b", D, "bfloat16", D, False),
      ("b", R * D, "bfloat16", D, True), 1 / D, 1e-5]),
    ("fn", "_rmsnorm_bwd_k", 2, 8, False,
     [("b", R * D, "float32", D, False), ("b", D, "float32", D, False),
      ("b", R * D, "float32", D, False), ("b", R * D, "float32", D, True),
      1 / D, 1e-5]),
]
IDS = [k[1] for k in KERNELS]
MODULES = {"gelu": (jG, tG), "norm": (jN, tN), "fn": (jF, tF)}


def _jax_args(spec):
    import ml_dtypes

    out = []
    for a in spec:
        if isinstance(a, tuple):
            _b, n, dt, line, mut = a
            dt = ml_dtypes.bfloat16 if dt == "bfloat16" else np.dtype(dt)
            out.append(jfe.ArrayArg(np.zeros(n, dt), line_size=line,
                                    mutable=mut))
        else:
            out.append(a)
    return out


def _torch_args(spec):
    out = []
    for a in spec:
        if isinstance(a, tuple):
            _b, n, dt, line, mut = a
            out.append(tfe.ArrayArg(torch.zeros(n, dtype=getattr(torch, dt)),
                                    line_size=line, mutable=mut))
        else:
            out.append(a)
    return out


def _jax_scope(kernel, cc, cd, checked, spec):
    ccount, cdim = _as_count(cc), _as_dim(cd)
    bound = kernel._sig.bind(*_jax_args(spec))
    defn = kernel._define(ccount, cdim, kernel._classify(bound), checked)
    scope = defn.scope
    c, d = defn.cube_count, defn.cube_dim
    j_run(scope, [JFastMath()])
    j_optimize(scope, d, c, PLANE)
    if checked:
        j_checked(scope, d, c)
        j_optimize(scope, d, c, PLANE)
    return repr(scope)


def _torch_scope(kernel, cc, cd, checked, spec):
    defn = kernel.define(cc, cd, *_torch_args(spec), checked=checked)
    defn.plane_dim = PLANE
    prepare_scope(defn)
    return repr(defn.scope)


@pytest.mark.parametrize("mod,name,cc,cd,checked,spec", KERNELS, ids=IDS)
def test_optimized_scope_equals_jax(mod, name, cc, cd, checked, spec):
    jmod, tmod = MODULES[mod]
    want = _jax_scope(getattr(jmod, name), cc, cd, checked, spec)
    got = _torch_scope(getattr(tmod, name), cc, cd, checked, spec)
    assert got == want
    assert "mem." in got      # the kernel was really traced


def test_eighteen_slice_kernels():
    assert len(set(IDS)) == 18
