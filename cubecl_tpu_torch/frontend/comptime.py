"""Comptime utilities.

Reference: ``comptime!`` (cubecl-macros/src/lib.rs:191,
cubecl-core/src/frontend/comptime.rs). In this frontend *every* plain
Python value is comptime, so ``comptime(x)`` is mostly an assertion/marker;
``comptime_error`` mirrors comptime_error.rs.
"""

from __future__ import annotations

from typing import Any

from .element import is_comptime


def comptime(x: Any) -> Any:
    """Assert that ``x`` is comptime and return it unchanged."""
    if not is_comptime(x):
        raise TypeError(
            "comptime(...) received a traced value; hoist the computation "
            "out of traced expressions or pass it as a comptime argument")
    return x


def comptime_error(msg: str) -> None:
    """Fail compilation with a message (reference ComptimeError)."""
    raise RuntimeError(f"comptime error: {msg}")
