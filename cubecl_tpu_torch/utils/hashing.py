"""Stable hashing of kernel ids (counterpart of
``cubecl_tpu.utils.hashing``).

The JAX package hashes with an xxh64 written in C++ (its ``native.cc``);
the port only needs a key that is stable across processes and machines, so
it takes ``hashlib``'s SHA-256, cut to 16 hex digits."""

from __future__ import annotations

import hashlib


def stable_hash_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def stable_hash_str(text: str) -> str:
    return stable_hash_bytes(text.encode("utf-8"))
