"""Tunables: the autotune search space (counterpart of
``cubecl_tpu.tune.operation``).

Reference: ``TunableSet``/``TuneFn`` with key + input generators
(cubecl-runtime/src/tune/operation.rs:28-138), ``TuneGroup`` priority
functions building a ``TunePlan`` (tune/base.rs:89-130).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass
class Tunable:
    """One candidate implementation (reference Tunable)."""

    name: str
    fn: Callable[..., Any]
    group: Optional["TuneGroup"] = None
    priority: int = 0
    # optional roofline work model for time bounds (reference
    # bounds_generator.rs Work{compute_ops, bytes}): (operations, bytes)
    # or (operations, bytes, operand dtype name), the dtype choosing the
    # peak the operations run at (GpuGeneration.peak; bf16's without it)
    work: Optional[Callable[[Any], tuple]] = None
    # False for a candidate whose preconditions the caller has checked: any
    # error it raises is a fault and propagates, never a reason to prune it
    prunable: bool = True


@dataclass
class TuneGroup:
    """Groups candidates; the priority function ranks groups per key so the
    scheduler benchmarks likely-good candidates first (tune/base.rs:89)."""

    name: str
    priority_fn: Callable[[Any], int] = lambda key: 0


class TunableSet:
    """A keyed family of interchangeable implementations."""

    def __init__(self, name: str,
                 key_fn: Callable[..., Any],
                 input_gen: Optional[Callable[..., tuple]] = None):
        self.name = name
        self.key_fn = key_fn
        self.input_gen = input_gen
        self.tunables: List[Tunable] = []
        self._checksum: Optional[str] = None  # of the names, kept by checksum

    def with_tunable(self, fn: Callable, name: Optional[str] = None,
                     group: Optional[TuneGroup] = None, priority: int = 0,
                     work: Optional[Callable] = None,
                     prunable: bool = True) -> "TunableSet":
        self._checksum = None
        self.tunables.append(Tunable(name or getattr(fn, "__name__", "t"),
                                     fn, group, priority, work, prunable))
        return self

    def generate_key(self, *args, **kwargs):
        return self.key_fn(*args, **kwargs)

    def generate_inputs(self, key, *args, **kwargs) -> tuple:
        """Benchmark inputs (reference generate_inputs) — defaults to the
        real inputs: the candidates write their outputs, which every
        candidate overwrites whole, and read nothing they write."""
        if self.input_gen is not None:
            return self.input_gen(key, *args, **kwargs)
        return args

    def plan(self, key) -> List[List[Tunable]]:
        """TunePlan: batches of candidates ordered by group priority then
        candidate priority (reference TunePlan batching)."""
        groups: Dict[Any, List[Tunable]] = {}
        for t in self.tunables:
            gp = t.group.priority_fn(key) if t.group else 0
            groups.setdefault(gp, []).append(t)
        batches = []
        for gp in sorted(groups, reverse=True):
            batch = sorted(groups[gp], key=lambda t: -t.priority)
            batches.append(batch)
        return batches


def checksum(tunables: TunableSet) -> str:
    """Checksum of the tunable-set shape, guarding persistent cache entries
    against code changes (reference tune_cache.rs:231)."""
    from ..utils.hashing import stable_hash_str

    cached = getattr(tunables, "_checksum", None)
    if cached is not None:
        return cached
    names = ",".join(t.name for t in tunables.tunables)
    # the leading version invalidates persisted entries when the timing
    # methodology changes (cuda1: CUDA-graph replays between CUDA events)
    value = stable_hash_str(f"cuda1|{tunables.name}|{names}")
    if isinstance(tunables, TunableSet):  # with_tunable clears it
        tunables._checksum = value
    return value
