"""The book's reduction progression — the twin of the JAX package's
``examples/reduction_progression.py``, on K0.

Reference: cubecl-book getting-started chapters (benchmark.md,
parallel_reduction.md, vectorized_reduction.md) — reduce a [ROWS, COLS]
f32 matrix to a [ROWS] vector, in stages:

  1. naive      one cube of CD units serially walks every row (the book
                uses one thread)
  2. parallel   one unit per row (CubeDim parallelism)
  3. vectorized line loads of L
  4. plane-tree one cube per row: units x lines split the row, plane_sum
                folds the units

The kernels and plans are the JAX package's (lines of 512 at the book's
shape, the TPU's lane width), so the two compare call for call.

    python -m cubecl_tpu_torch.examples.reduction_progression  # on the card
"""

from __future__ import annotations

import numpy as np

from ..frontend import (
    CUBE_POS_X,
    UNIT_POS,
    ArrayArg,
    MutSlice,
    Slice,
    Vector,
    cube,
    cube_range,
    line_sum,
    plane_sum,
)
from ..ir.types import f32
from ..runtime import default_client
from ..runtime.base import CubeCount, CubeDim

CD = 8
BOOK = (512, 8192, 256, 4096)   # rows, cols; the naive stage's rows, cols
SMALL = (64, 512, 64, 512)      # the CPU shape


@cube
def reduce_naive(inp: Slice, out: MutSlice, rows: int, cols: int):
    """Stage 1 — one cube does everything, serially."""
    for r in cube_range(0, rows):
        acc = 0.0
        for c in cube_range(0, cols):
            acc = acc + inp[r * cols + c]
        if UNIT_POS == 0:
            out[r] = acc


@cube
def reduce_parallel(inp: Slice, out: MutSlice, cols: int):
    """Stage 2 — one unit per row, still scalar loads."""
    r = CUBE_POS_X * 8 + UNIT_POS
    acc = 0.0
    for c in cube_range(0, cols):
        acc = acc + inp[r * cols + c]
    out[r] = acc


@cube
def reduce_vectorized(inp: Slice, out: MutSlice, lines_per_row: int):
    """Stage 3 — line loads (the input is viewed as lines of L)."""
    r = CUBE_POS_X * 8 + UNIT_POS
    acc = Vector.zeros(f32, inp.line_size)
    base = r * lines_per_row
    for k in cube_range(0, lines_per_row):
        acc = acc + inp[base + k]
    out[r] = line_sum(acc)


@cube
def reduce_plane_tree(inp: Slice, out: MutSlice, iters: int):
    """Stage 4 — one cube per row: 8 units × L lanes sweep the row,
    plane_sum folds the partial of each unit."""
    acc = Vector.zeros(f32, inp.line_size)
    base = CUBE_POS_X * (iters * 8)
    for k in cube_range(0, iters):
        acc = acc + inp[base + k * 8 + UNIT_POS]
    s = plane_sum(line_sum(acc))
    if UNIT_POS == 0:
        out[CUBE_POS_X] = s


def line_of(cols: int) -> int:
    """The script's line: 512 where the plane-tree stage has a whole cube
    of lines per row (cols >= 512 * CD), else 64."""
    return 512 if cols >= 512 * CD else 64


def stages(h, out, hn, outn, rows, cols, naive_rows, naive_cols):
    """The script's four stages: name -> (kernel, cube count, cube dim,
    launch args). ``h`` holds the (rows, cols) matrix and ``out`` its row
    sums; the naive stage reduces ``hn`` (naive_rows, naive_cols) into
    ``outn``."""
    L = line_of(cols)
    return {
        "naive": (reduce_naive, CubeCount(1), CubeDim.new_1d(CD),
                  (ArrayArg(hn), ArrayArg(outn, mutable=True),
                   naive_rows, naive_cols)),
        "parallel": (reduce_parallel, CubeCount(rows // CD),
                     CubeDim.new_1d(CD),
                     (ArrayArg(h), ArrayArg(out, mutable=True), cols)),
        "vectorized": (reduce_vectorized, CubeCount(rows // CD),
                       CubeDim.new_1d(CD),
                       (ArrayArg(h, line_size=L),
                        ArrayArg(out, mutable=True), cols // L)),
        "plane-tree": (reduce_plane_tree, CubeCount(rows),
                       CubeDim.new_1d(CD),
                       (ArrayArg(h, line_size=L),
                        ArrayArg(out, mutable=True), cols // (L * CD))),
    }


def main(book: bool = True):
    client = default_client()
    rows, cols, naive_rows, naive_cols = BOOK if book else SMALL
    x = np.random.default_rng(0).random((rows, cols), dtype=np.float32)
    xn = x[:naive_rows, :naive_cols].copy()
    h, hn = client.create(x.reshape(-1)), client.create(xn.reshape(-1))
    out = client.empty((rows,), "float32")
    outn = client.empty((naive_rows,), "float32")
    for name, (k, cc, cd, args) in stages(h, out, hn, outn, rows, cols,
                                         naive_rows, naive_cols).items():
        k.launch_unchecked(client, cc, cd, *args)
        want = (xn if name == "naive" else x).sum(axis=1)
        got = client.read_one(args[1].handle)
        np.testing.assert_allclose(got, want, rtol=1e-3)
        print(f"reduce stage {name}: matches numpy")


if __name__ == "__main__":
    import sys

    main(book="--small" not in sys.argv)
