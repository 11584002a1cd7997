"""Shape/stride utilities — the cubecl-zspace equivalent; a copy of
``cubecl_tpu.std.zspace`` (host-side index math, no kernel).

Reference: cubecl-zspace (Shape/Strides smallvec types, shape.rs:24;
striding builders/validation, striding/; metadata.rs). Python tuples
replace the smallvec; the functions cover the same index math.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """Row-major strides in elements (reference Strides::contiguous)."""
    out = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        out[i] = out[i + 1] * shape[i + 1]
    return tuple(out)


def num_elements(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def is_contiguous(shape: Sequence[int], strides: Sequence[int]) -> bool:
    return tuple(strides) == contiguous_strides(shape)


def linear_index(coords: Sequence[int], strides: Sequence[int]) -> int:
    """coords · strides (reference indexing conversions)."""
    return sum(c * s for c, s in zip(coords, strides))


def delinearize(index: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """Linear index → row-major coordinates (wrapping conversions)."""
    coords = []
    for s in reversed(shape):
        coords.append(index % s)
        index //= s
    return tuple(reversed(coords))


def broadcast_shapes(a: Sequence[int], b: Sequence[int]) -> Tuple[int, ...]:
    """Numpy-style broadcast of two shapes (validation errors on mismatch)."""
    ra, rb = list(a)[::-1], list(b)[::-1]
    out = []
    for i in range(max(len(ra), len(rb))):
        x = ra[i] if i < len(ra) else 1
        y = rb[i] if i < len(rb) else 1
        if x != y and x != 1 and y != 1:
            raise ValueError(f"cannot broadcast {tuple(a)} with {tuple(b)}")
        out.append(max(x, y))
    return tuple(reversed(out))


def permuted_strides(strides: Sequence[int], perm: Sequence[int]
                     ) -> Tuple[int, ...]:
    return tuple(strides[p] for p in perm)


def validate_strides(shape: Sequence[int], strides: Sequence[int]) -> None:
    """Reject overlapping/invalid layouts (reference striding validation):
    every stride must be ≥ the extent of all inner dims it spans."""
    if len(shape) != len(strides):
        raise ValueError("rank mismatch")
    order = sorted(range(len(shape)), key=lambda i: strides[i])
    extent = 1
    for i in order:
        if shape[i] > 1 and strides[i] < extent:
            raise ValueError(
                f"overlapping strides {tuple(strides)} for shape "
                f"{tuple(shape)}")
        if shape[i] > 1:
            extent = max(extent, strides[i] * shape[i])
