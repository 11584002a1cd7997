"""Launch utilities: grid sizing + line-size (vectorization) pickers.

Reference: ``calculate_cube_count_elemwise`` (cubecl-core/src/lib.rs:77),
``tensor_vectorization_factor`` / ``tensor_vector_size_parallel`` /
``...perpendicular`` (lib.rs:89-179) and ``io_optimized_vector_sizes``
(client.rs:1322).

CUDA guidance baked in: a thread loads at most 16 bytes at once, so the
profitable line sizes are the GPU's 4 and 2 (the reference's
io_optimized_vector_sizes); the default cube dim is 256 threads.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ..runtime.base import CubeCount, CubeDim

#: line sizes worth trying on CUDA, widest first (reference
#: io_optimized_vector_sizes)
CUDA_LINE_SIZES = (4, 2, 1)

DEFAULT_CUBE_DIM = CubeDim(256, 1, 1)


def io_optimized_line_sizes(n_elems: int, dtype_size: int = 4
                            ) -> Tuple[int, ...]:
    """Line sizes to consider for IO-bound kernels on this hardware."""
    return tuple(l for l in CUDA_LINE_SIZES if n_elems % l == 0)


def tensor_line_size(n_elems: int, innermost_dim: int,
                     max_line: int = 512) -> int:
    """Largest CUDA-friendly line dividing both the innermost dimension and
    the total length (reference tensor_vectorization_factor)."""
    for l in CUDA_LINE_SIZES:
        if l <= max_line and innermost_dim % l == 0 and n_elems % l == 0:
            return l
    return 1


def tensor_line_size_parallel(shapes: Sequence[int], strides: Sequence[int],
                              dim: int, max_line: int = 512) -> int:
    """Line size along the iteration dimension (stride-1 required)."""
    if strides[dim] != 1:
        return 1
    return tensor_line_size(int(__import__("math").prod(shapes)),
                            shapes[dim], max_line)


def tensor_line_size_perpendicular(shapes: Sequence[int],
                                   strides: Sequence[int], dim: int,
                                   max_line: int = 512) -> int:
    """Vectorize perpendicular to the iteration dim: the innermost other
    dim must be contiguous."""
    inner = len(shapes) - 1
    if inner == dim or strides[inner] != 1:
        return 1
    return tensor_line_size(int(__import__("math").prod(shapes)),
                            shapes[inner], max_line)


def calculate_cube_count_elemwise(n_elems: int, cube_dim: CubeDim = None,
                                  line_size: int = 4) -> CubeCount:
    """Grid size for an elementwise kernel over n_elems (reference
    calculate_cube_count_elemwise, lib.rs:77)."""
    cd = cube_dim or DEFAULT_CUBE_DIM
    per_cube = cd.num_units * line_size
    return CubeCount(-(-n_elems // per_cube))
