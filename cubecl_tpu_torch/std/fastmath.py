"""FastDivmod: magic-number division for index math (counterpart of
``cubecl_tpu.std.fastmath``).

Reference: cubecl-std/src/fast_math.rs:13-43 (used by into_contiguous for
cheap div/mod by runtime strides). The magic numbers are computed here at
comptime, by the rule of the JAX package's native helper
(``divmod_magic`` in its ``csrc/native.cc``), in Python: the port keeps no
copy of that library. In a kernel the division is a mulhi and a shift
(``mul_hi``, which K0 does not lower yet).
"""

from __future__ import annotations

from ..frontend.element import is_comptime
from ..frontend.functions import mul_hi


def _magic(divisor: int):
    """(magic, shift) with x // divisor == (x * magic) >> (32 + shift) for
    0 <= x < 2^31, or (None, log2 divisor) for a power of two."""
    shift = 0
    while (1 << shift) < divisor:
        shift += 1
    if divisor & (divisor - 1) == 0:
        return None, shift
    shift += 31
    magic = ((1 << shift) + divisor - 1) // divisor
    return magic, shift - 32


class FastDivmod:
    """Comptime-constructed divider; ``div``/``mod``/``divmod`` usable on
    traced values inside kernels.

    Valid for dividends in [0, 2^31): the magic split uses shift = 31 +
    ceil(log2 d), whose Granlund-Montgomery error bound only covers 31-bit
    dividends. That is the full range of i32 index math, which is the only
    use; dividends with the sign bit set would produce a wrong quotient."""

    MAX_DIVIDEND = 1 << 31

    def __init__(self, divisor: int):
        assert 0 < divisor < FastDivmod.MAX_DIVIDEND, \
            f"FastDivmod divisor must be in [1, 2^31), got {divisor}"
        self.divisor = divisor
        self.magic, self.shift = _magic(divisor)

    def div(self, x):
        if is_comptime(x):
            return x // self.divisor
        if self.magic is None:  # power of two
            return x >> self.shift
        # (x * magic) >> (32 + shift) via mulhi
        hi = mul_hi(x, int(self.magic & 0xFFFFFFFF))
        return hi >> self.shift

    def mod(self, x):
        return x - self.div(x) * self.divisor

    def divmod(self, x):
        d = self.div(x)
        return d, x - d * self.divisor
