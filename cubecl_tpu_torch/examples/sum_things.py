"""Reduction variants (reference examples/sum_things/src/lib.rs:6-100):
basic loop w/ unroll, plane_sum, comptime trait-style dispatch — the twin
of the JAX package's ``examples/sum_things.py``, on K0.

    python -m cubecl_tpu_torch.examples.sum_things     # on the card
"""

from __future__ import annotations

import numpy as np

from ..frontend import (
    UNIT_POS,
    ArrayArg,
    MutSlice,
    Slice,
    cube,
    cube_range,
    plane_sum,
)
from ..runtime import default_client
from ..runtime.base import CubeCount, CubeDim

N = 8  # elements, and units of the one cube


@cube
def sum_basic(inp: Slice, out: MutSlice, end=None):
    unroll = end is not None
    n = end if end is not None else inp.len()
    acc = 0.0
    if unroll:
        for i in range(n):          # comptime -> unrolled
            acc = acc + inp[i]
    else:
        for i in cube_range(0, n):  # traced loop
            acc = acc + inp[i]
    out[UNIT_POS] = acc


@cube
def sum_subgroup(inp: Slice, out: MutSlice, subgroup: bool, end=None):
    if subgroup:
        out[UNIT_POS] = plane_sum(inp[UNIT_POS])
    else:
        sum_basic(inp, out, end)


# trait-style dispatch: strategies are comptime cube functions
@cube
def sum_plane_kind(inp: Slice):
    return plane_sum(inp[UNIT_POS])


@cube
def sum_basic_kind(inp: Slice):
    acc = 0.0
    for i in cube_range(0, inp.len()):
        acc = acc + inp[i]
    return acc


@cube
def sum_trait(inp: Slice, out: MutSlice, kind):
    out[UNIT_POS] = kind(inp)


def variants(client, inp, out):
    """The script's four launches over ``inp`` and ``out`` (N elements
    each), as closures by name; every unit writes the sum."""
    cc, cd = CubeCount(1), CubeDim.new_1d(N)

    def args():
        return ArrayArg(inp), ArrayArg(out, mutable=True)

    return {
        "basic": lambda: sum_basic.launch_unchecked(client, cc, cd, *args(),
                                                    N),
        "subgroup": lambda: sum_subgroup.launch_unchecked(client, cc, cd,
                                                          *args(), True),
        "trait:plane": lambda: sum_trait.launch_unchecked(
            client, cc, cd, *args(), sum_plane_kind),
        "trait:basic": lambda: sum_trait.launch_unchecked(
            client, cc, cd, *args(), sum_basic_kind),
    }


def main():
    client = default_client()
    data = np.arange(N, dtype=np.float32)
    i = client.create(data)
    o = client.empty((N,), "float32")
    for name, run in variants(client, i, o).items():
        run()
        print(f"sum[{name}] => {client.read_one(o)[0]}")


if __name__ == "__main__":
    main()
