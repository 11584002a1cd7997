"""Autotune anchoring: bucket problem sizes to bound search count
(counterpart of ``cubecl_tpu.tune.anchor``).

Reference: anchoring by ``AutotuneLevel{Minimal,Balanced,Extensive,Full}``
(cubecl-runtime/src/tune/util.rs:16-42, config/autotune.rs:158): keys are
snapped to powers-of-two-ish anchors so nearby shapes share cache entries
and the benchmark count stays bounded.
"""

from __future__ import annotations

from typing import Optional

LEVELS = ("minimal", "balanced", "extensive", "full")


def anchor(value: int, level: str = "balanced",
           maximum: Optional[int] = None) -> int:
    """Snap a dimension to its autotune anchor."""
    if value <= 0:
        return value
    if level == "full":
        out = value  # exact keys — every shape tuned
    else:
        p = 1
        while p < value:
            p *= 2
        if level == "extensive" and p > value:
            # include the 3/4 midpoint for finer buckets
            mid = (p // 2) * 3 // 2
            out = mid if value <= mid else p
        elif level == "minimal":
            # coarse: snap up to the next power of 4
            q = 1
            while q < value:
                q *= 4
            out = q
        else:
            out = p
    if maximum is not None:
        out = min(out, maximum)
    return out
