"""Topology builtins (reference cubecl-core/src/frontend/topology.rs;
Builtin enum cubecl-ir/src/variable.rs:73-105).

CUDA mapping: UNIT_POS → ``threadIdx`` flattened x-fastest; CUBE_POS →
``blockIdx``; PLANE_DIM → warp width; ABSOLUTE_POS → global linear unit
id.
"""

from ..ir.value import Builtin, builtin_value
from .element import CubeVal


def _b(b: Builtin) -> CubeVal:
    return CubeVal(builtin_value(b))


UNIT_POS = _b(Builtin.UNIT_POS)
UNIT_POS_X = _b(Builtin.UNIT_POS_X)
UNIT_POS_Y = _b(Builtin.UNIT_POS_Y)
UNIT_POS_Z = _b(Builtin.UNIT_POS_Z)
UNIT_POS_PLANE = _b(Builtin.UNIT_POS_PLANE)
ABSOLUTE_POS = _b(Builtin.ABSOLUTE_POS)
ABSOLUTE_POS_X = _b(Builtin.ABSOLUTE_POS_X)
ABSOLUTE_POS_Y = _b(Builtin.ABSOLUTE_POS_Y)
ABSOLUTE_POS_Z = _b(Builtin.ABSOLUTE_POS_Z)
CUBE_POS = _b(Builtin.CUBE_POS)
CUBE_POS_X = _b(Builtin.CUBE_POS_X)
CUBE_POS_Y = _b(Builtin.CUBE_POS_Y)
CUBE_POS_Z = _b(Builtin.CUBE_POS_Z)
CUBE_DIM = _b(Builtin.CUBE_DIM)
CUBE_DIM_X = _b(Builtin.CUBE_DIM_X)
CUBE_DIM_Y = _b(Builtin.CUBE_DIM_Y)
CUBE_DIM_Z = _b(Builtin.CUBE_DIM_Z)
CUBE_COUNT = _b(Builtin.CUBE_COUNT)
CUBE_COUNT_X = _b(Builtin.CUBE_COUNT_X)
CUBE_COUNT_Y = _b(Builtin.CUBE_COUNT_Y)
CUBE_COUNT_Z = _b(Builtin.CUBE_COUNT_Z)
CUBE_CLUSTER_POS = _b(Builtin.CUBE_CLUSTER_POS)
CUBE_CLUSTER_DIM = _b(Builtin.CUBE_CLUSTER_DIM)
PLANE_DIM = _b(Builtin.PLANE_DIM)
PLANE_POS = _b(Builtin.PLANE_POS)
