"""PageAllocator: the host half of paged serving, the KV block manager
(counterpart of ``cubecl_tpu.runtime.pages``).

It decides which physical page of the device pools ``(L, Hkv, P, page, D)``
each sequence owns, in vLLM's manner:

- a fixed pool of ``num_pages`` pages, handed out one at a time;
- per-sequence ordered page lists that grow as tokens are appended;
- ``fork`` shares every page by refcount (beam search, parallel sampling),
  and ``unshare_last`` gives a branch its own copy of a shared partial page;
- automatic prefix caching: full pages registered under a chain hash of
  their tokens outlive their sequence until the pool needs them, and
  ``admit_cached`` reattaches the longest cached prefix;
- ``block_table`` assembles the (B, max_pages) int32 table of
  ``ops.paged_attention``, each row padded by repeating its last page.

The pool itself is the C++ of ``csrc/page_pool.cc`` (built by g++ at first
use, ``utils.native.page_pool``); building it fails loudly. Every call is
O(pages touched); one serving thread drives an allocator.
"""

from __future__ import annotations

import struct
from typing import Dict, Sequence

import numpy as np

from ..utils import native as _native
from ..utils.hashing import stable_hash_bytes


class _NativePagePool:
    """The C++ pool of ``csrc/page_pool.cc``, one method per C call."""

    def __init__(self, num_pages: int):
        self._lib = _native.page_pool()
        self._h = int(self._lib.page_pool_create(num_pages))
        if self._h < 0:
            raise RuntimeError(f"page_pool_create({num_pages}) failed")

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", -1)
        if lib is not None and h >= 0:
            lib.page_pool_destroy(h)

    def num_free(self) -> int:
        return int(self._lib.page_pool_num_free(self._h))

    def alloc_seq(self, seq: int, n: int) -> int:
        return int(self._lib.page_pool_alloc_seq(self._h, seq, n))

    def append(self, seq: int) -> int:
        return int(self._lib.page_pool_append(self._h, seq))

    def fork(self, src: int, dst: int) -> int:
        return int(self._lib.page_pool_fork(self._h, src, dst))

    def free_seq(self, seq: int) -> int:
        return int(self._lib.page_pool_free_seq(self._h, seq))

    def _hash_call(self, fn, seq: int, hashes) -> int:
        arr = np.ascontiguousarray(hashes or [0], np.uint64)
        return int(fn(self._h, seq, arr.ctypes.data, len(hashes)))

    def register_prefix(self, seq: int, hashes) -> int:
        return self._hash_call(self._lib.page_pool_register_prefix, seq,
                               hashes)

    def admit_cached(self, seq: int, hashes) -> int:
        return self._hash_call(self._lib.page_pool_admit_cached, seq, hashes)

    def seq_pages(self, seq: int) -> int:
        return int(self._lib.page_pool_seq_pages(self._h, seq))

    def unshare_last(self, seq: int) -> int:
        return int(self._lib.page_pool_unshare_last(self._h, seq))

    def fill_table(self, seq_ids, out: np.ndarray, max_pages: int) -> int:
        ids = np.ascontiguousarray(seq_ids, np.int64)
        return int(self._lib.page_pool_fill_table(
            self._h, ids.ctypes.data, len(ids), out.ctypes.data, max_pages))

    def refcount(self, page: int) -> int:
        return int(self._lib.page_pool_refcount(self._h, page))


class PageAllocator:
    """KV block manager over ``num_pages`` physical pages of
    ``page_size`` tokens each."""

    def __init__(self, num_pages: int, page_size: int = 128):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(f"want positive num_pages and page_size; got "
                             f"{num_pages}, {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._pool = _NativePagePool(self.num_pages)
        # logical token count per sequence (the kernels mask against it)
        self.lengths: Dict[int, int] = {}

    # -- raw page ops ------------------------------------------------------

    def num_free_pages(self) -> int:
        """Free pages plus cached pages that nothing references."""
        return self._pool.num_free()

    def seq_page_count(self, seq: int) -> int:
        return self._pool.seq_pages(seq)

    def refcount(self, page: int) -> int:
        return self._pool.refcount(page)

    # -- sequence lifecycle ------------------------------------------------

    def admit(self, seq: int, prompt_tokens: int) -> bool:
        """Admit a new sequence holding ``prompt_tokens`` tokens; False if
        the pool cannot hold it (continuous batching's backpressure)."""
        n = max(1, -(-int(prompt_tokens) // self.page_size))
        ok = self._pool.alloc_seq(seq, n) == 0
        if ok:
            self.lengths[seq] = int(prompt_tokens)
        return ok

    def extend(self, seq: int, tokens: int = 1) -> bool:
        """Record ``tokens`` appended to ``seq``, growing its page list
        where page boundaries are crossed. All or nothing: False leaves the
        sequence as it was (the pool is exhausted: preempt)."""
        new_len = self.lengths[seq] + int(tokens)
        need = -(-new_len // self.page_size) - self.seq_page_count(seq)
        if need > 0:
            if self.num_free_pages() < need:
                return False
            for _ in range(need):
                if self._pool.append(seq) < 0:
                    raise RuntimeError(f"page pool append({seq}) failed "
                                       "after its free count was checked")
        self.lengths[seq] = new_len
        return True

    def fork(self, src: int, dst: int) -> bool:
        """Share src's pages with a new branch dst. The shared pages are
        never copied; if src's last page is partial, the caller copies it
        on the device (``unshare_last``, as ``models.llama.fork_seq``)."""
        ok = self._pool.fork(src, dst) == 0
        if ok:
            self.lengths[dst] = self.lengths[src]
        return ok

    def unshare_last(self, seq: int):
        """If seq's last page is shared, swap in a fresh private page and
        return (old_page, new_page) for the caller's device copy; None if
        it is private already. Raises when the pool is exhausted."""
        r = self._pool.unshare_last(seq)
        if r == -4:
            return None
        if r < 0:
            raise RuntimeError(f"unshare_last({seq}) rc={r}")
        return (r >> 32) & 0xFFFFFFFF, r & 0xFFFFFFFF

    def release(self, seq: int) -> int:
        """Finish a sequence; returns the pages it gave back (shared pages
        stay until every branch releases them)."""
        freed = self._pool.free_seq(seq)
        self.lengths.pop(seq, None)
        return max(freed, 0)

    # -- automatic prefix caching ------------------------------------------

    def _page_hashes(self, tokens) -> list:
        """Chain hashes of the full token pages: h_i covers tokens
        0..(i+1)*page-1 as hash(h_{i-1} || tokens of page i), vLLM's prefix
        key. Never 0 (0 means unregistered)."""
        toks = [int(t) for t in tokens]
        out, parent = [], 0
        for s0 in range(0, len(toks) - self.page_size + 1, self.page_size):
            blob = struct.pack("<Q", parent) + struct.pack(
                f"<{self.page_size}i", *toks[s0:s0 + self.page_size])
            parent = int(stable_hash_bytes(blob), 16) or 1
            out.append(parent)
        return out

    def admit_cached(self, seq: int, tokens) -> int:
        """Admit a sequence holding ``tokens``, reusing every cached
        full-page prefix (their K/V are still in the device pools). Returns
        the number of cached tokens (prefill only the suffix after them),
        or -1 if the pool cannot hold the sequence (nothing allocated)."""
        k = self._pool.admit_cached(seq, self._page_hashes(tokens))
        if k < 0:
            raise KeyError(f"admit_cached({seq}) rc={k}")
        T = len(tokens)
        for _ in range(max(1, -(-T // self.page_size)) - k):
            if self._pool.append(seq) < 0:
                self.release(seq)
                return -1
        self.lengths[seq] = T
        return k * self.page_size

    def register_prefix(self, seq: int, tokens) -> int:
        """Register the sequence's written full pages under their chain
        hashes so that later requests reuse them; call after the prefill.
        Only pages covered by both ``tokens`` and the written length count.
        Returns the number registered."""
        n_full = min(len(tokens), self.lengths.get(seq, 0)) // self.page_size
        hashes = self._page_hashes(tokens)[:n_full]
        if not hashes:
            return 0
        return max(0, self._pool.register_prefix(seq, hashes))

    # -- kernel interop ----------------------------------------------------

    def block_table(self, seq_ids: Sequence[int],
                    max_pages: int) -> np.ndarray:
        """(B, max_pages) int32 table, each row padded by repeating its
        last page id."""
        ids = np.asarray(list(seq_ids), np.int64)
        out = np.empty((len(ids), int(max_pages)), np.int32)
        if self._pool.fill_table(ids, out, int(max_pages)) != 0:
            raise KeyError(f"unknown sequence or more than {max_pages} "
                           f"pages among {ids.tolist()}")
        return out
