"""Autotune cache: in-memory + persistent sqlite store (counterpart of
``cubecl_tpu.tune.cache``).

Reference: ``TuneCache`` with persistent validation
(cubecl-runtime/src/tune/tune_cache.rs:35-231) over the environment's
sqlite ``Store`` (cubecl-environment/src/persistence/sqlite.rs).
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Any, Dict, Optional, Tuple

from ..runtime.config import cache_root


class PersistentStore:
    """Namespaced sqlite key-value store (reference persistence/store.rs),
    at ``cache_root()/store.sqlite`` unless ``path`` is given, over one
    connection (``with conn`` commits each write)."""

    def __init__(self, namespace: str, path: Optional[str] = None):
        self.namespace = namespace
        self.path = path or os.path.join(cache_root(), "store.sqlite")
        self._conn = sqlite3.connect(self.path, timeout=5.0)
        self._conn.execute("PRAGMA journal_mode=WAL")
        with self._conn:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                " ns TEXT NOT NULL, k TEXT NOT NULL, v TEXT NOT NULL,"
                " PRIMARY KEY (ns, k))")

    def get(self, key: str) -> Optional[str]:
        row = self._conn.execute(
            "SELECT v FROM kv WHERE ns=? AND k=?",
            (self.namespace, key)).fetchone()
        return row[0] if row else None

    def put(self, key: str, value: str) -> None:
        with self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (ns, k, v) VALUES (?,?,?)",
                (self.namespace, key, value))

    def delete(self, key: str) -> None:
        with self._conn:
            self._conn.execute("DELETE FROM kv WHERE ns=? AND k=?",
                               (self.namespace, key))

    def items(self):
        return self._conn.execute(
            "SELECT k, v FROM kv WHERE ns=?", (self.namespace,)).fetchall()


class TuneCache:
    """Fastest-candidate cache for one TunableSet on one device."""

    def __init__(self, set_name: str, device_fingerprint: str,
                 checksum: str):
        self.mem: Dict[str, Tuple[int, str, dict]] = {}  # key -> (index, name, timings)
        self.checksum = checksum
        self.store: Optional[PersistentStore] = PersistentStore(
            f"autotune/{device_fingerprint}/{set_name}")
        self._load()

    def _load(self) -> None:
        for k, v in self.store.items():
            try:
                entry = json.loads(v)
            except json.JSONDecodeError:
                continue  # not an entry this code wrote: ignore it
            if entry.get("checksum") != self.checksum:
                continue  # stale code — ignore (reference checksum guard)
            self.mem[k] = (entry["index"], entry.get("name", "?"),
                           entry.get("timings", {}))

    def get(self, key: Any) -> Optional[int]:
        hit = self.mem.get(str(key))
        return hit[0] if hit else None

    def timings(self, key: Any) -> dict:
        """Measured per-candidate seconds recorded when the key was tuned."""
        hit = self.mem.get(str(key))
        return hit[2] if hit else {}

    def put(self, key: Any, index: int, name: str,
            timings: Optional[dict] = None) -> None:
        self.mem[str(key)] = (index, name, timings or {})
        if self.store is not None:
            self.store.put(str(key), json.dumps({
                "index": index, "name": name, "checksum": self.checksum,
                "timings": timings or {}}))
