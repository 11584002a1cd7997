"""CMMA — cooperative matrix-multiply-accumulate.

Reference: cubecl-core/src/frontend/cmma.rs (``Matrix<C, S>`` with
ctors/fill/load/store/execute, cmma.rs:83-953) over the IR CoopMma ops
(cubecl-ir/src/cmma.rs:13-81).

The tracing is the JAX package's (a fragment is a cube-scope tile), so a
cmma kernel traces to the same scope in both packages. Both backends of
the port lower the ``mma.*`` ops: the torch evaluator computes each
fragment op on tensors (``backend/torch_eval.py::_mma``), and the CUDA
printer prints them (``backend/cuda/printer.py::mma``), a 16-bit or f32
product on ``wgmma`` with its accumulator in registers
(``mma_wgmma``; f32 as three TF32 products).
"""

from __future__ import annotations

from typing import Optional

from ..ir import ops as O
from ..ir.ops import Operation
from ..ir.types import ElemType, Type
from .element import active_builder, as_value, is_comptime

ROW_MAJOR = "row_major"
COL_MAJOR = "col_major"


class Matrix:
    """A matrix tile fragment (reference MatrixIdent A/B/Accumulator)."""

    def __init__(self, ident: str, m: int, n: int, k: int, elem: ElemType,
                 layout: str = ROW_MAJOR):
        assert ident in ("a", "b", "accumulator")
        b = active_builder()
        if ident == "a":
            shape = (m, k)
        elif ident == "b":
            shape = (k, n)
        else:
            shape = (m, n)
        self.ident = ident
        self.m, self.n, self.k = m, n, k
        self.layout = layout
        self.value = b.scope.create_matrix(Type(elem), shape, ident, layout)

    # -- constructors (reference from_value/from_slice, cmma.rs:275-336) ----
    @staticmethod
    def from_value(ident: str, m: int, n: int, k: int, elem: ElemType,
                   value, layout: str = ROW_MAJOR) -> "Matrix":
        mat = Matrix(ident, m, n, k, elem, layout)
        fill(mat, value)
        return mat

    @staticmethod
    def from_slice(ident: str, m: int, n: int, k: int, elem: ElemType,
                   slice_, stride, layout: str = ROW_MAJOR) -> "Matrix":
        mat = Matrix(ident, m, n, k, elem, layout)
        load(mat, slice_, stride)
        return mat


def fill(mat: Matrix, value) -> None:
    b = active_builder()
    b.scope.register(None, Operation(
        O.MMA_FILL, (mat.value, as_value(value, mat.value.ty))))


def load(mat: Matrix, slice_, stride, offset=0,
         layout: Optional[str] = None) -> None:
    """Load a fragment from a buffer with a row stride; ``offset`` is the
    element offset of the fragment's first element (traced values allowed —
    the tile-loop pattern ``offset = row*k + kk*tile``)."""
    b = active_builder()
    base = slice_._offset if hasattr(slice_, "_offset") else 0
    if is_comptime(base) and base:
        offset = offset + base * slice_.line_size
    b.scope.register(None, Operation(
        O.MMA_LOAD,
        (mat.value, slice_.value, as_value(offset), as_value(stride)),
        {"layout": layout or mat.layout, "line_size": slice_.line_size}))


def _tensor_frag_op(opcode, mat, t, row, col, layout):
    from ..ir.types import Type

    assert len(t._shape) == 2, "tensor fragment access needs a 2D tensor"
    L = t.line_size
    stride = t._strides[0]
    nd = t._nd_attrs((row, col))
    offset = row * stride + col * L  # elements
    b = active_builder()
    attrs = {"layout": layout or mat.layout, "line_size": L}
    if nd is not None:
        attrs.update(nd)
    b.scope.register(None, Operation(
        opcode, (mat.value, t.value, as_value(offset), as_value(stride)),
        attrs))


def load_tensor(mat: Matrix, t, row, col,
                layout: Optional[str] = None) -> None:
    """Load a fragment from a 2D Tensor at (row, col) — ``col`` in LINE
    units (the tensor-indexing convention). Carries per-dim indices so
    a backend can window the operand."""
    _tensor_frag_op(O.MMA_LOAD, mat, t, row, col, layout)


def store_tensor(mat: Matrix, t, row, col,
                 layout: str = ROW_MAJOR) -> None:
    """Store a fragment into a 2D MutTensor at (row, col in lines)."""
    _tensor_frag_op(O.MMA_STORE, mat, t, row, col, layout)


def store(mat: Matrix, slice_, stride, offset=0,
          layout: str = ROW_MAJOR) -> None:
    b = active_builder()
    base = slice_._offset if hasattr(slice_, "_offset") else 0
    if is_comptime(base) and base:
        offset = offset + base * slice_.line_size
    b.scope.register(None, Operation(
        O.MMA_STORE,
        (mat.value, slice_.value, as_value(offset), as_value(stride)),
        {"layout": layout, "line_size": slice_.line_size}))


def execute(a: Matrix, b_: Matrix, c: Matrix, d: Matrix) -> None:
    """d = a @ b + c (reference cmma::execute, cmma.rs:850)."""
    b = active_builder()
    b.scope.register(None, Operation(
        O.MMA_EXECUTE, (a.value, b_.value, c.value, d.value)))


def execute_scaled(a: Matrix, b_: Matrix, c: Matrix, d: Matrix,
                   scale_a, scale_b) -> None:
    """Block-scaled MMA (reference execute_scaled, cmma.rs:953) — fp8 path."""
    b = active_builder()
    b.scope.register(None, Operation(
        O.MMA_EXECUTE_SCALED,
        (a.value, b_.value, c.value, d.value,
         as_value(scale_a), as_value(scale_b))))


def cast(dst: Matrix, src: Matrix) -> None:
    b = active_builder()
    b.scope.register(None, Operation(O.MMA_CAST, (dst.value, src.value)))
