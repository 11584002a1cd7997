"""Sequence — comptime-length heterogeneous list.

Reference: cubecl-core/src/frontend/container/sequence/base.rs:16 with
``SequenceArg`` launch support (sequence/launch.rs:13). In the Python
frontend a Sequence is a thin list wrapper iterated at trace time
(comptime loop); as a launch argument it expands into one buffer/scalar
parameter per element — the comptime-fusion capability
(examples/fusing/src/lib.rs:16-33).
"""

from __future__ import annotations

from typing import Any, Iterable, List


class Sequence:
    def __init__(self, items: Iterable[Any] = ()):  # comptime container
        self._items: List[Any] = list(items)

    @staticmethod
    def new() -> "Sequence":
        return Sequence()

    def push(self, item: Any) -> None:
        self._items.append(item)

    def index(self, i: int) -> Any:
        return self._items[i]

    def __getitem__(self, i: int) -> Any:
        return self._items[i]

    def __len__(self) -> int:
        return len(self._items)

    def len(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __repr__(self) -> str:
        return f"Sequence({self._items!r})"
