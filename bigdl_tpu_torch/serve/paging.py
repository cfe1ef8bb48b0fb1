"""Block-paged KV-cache allocation (counterpart of
bigdl_tpu/serve/paging.py; host-side bookkeeping only, no tensors).

KV storage is a ``(n_pages, page_size, ...)`` pool; every request holds
only the fixed-size pages its own length needs, and a per-slot
slot->page table maps logical positions to pool pages.  The JAX pool
refcounts pages for its prefix cache; with no prefix cache in the port
yet, a page has one holder.
"""
from __future__ import annotations

from collections import deque


class RequestTooLongError(ValueError):
    """A decode request needs more positions than the decoder can ever
    hold (``len(seed) + n_words - 1 > n_pos``, or more pages than the
    whole pool).  Set on the request's OWN future at submit time."""


class PagePool:
    """Free-list allocator over page ids ``0 .. n_pages-1``."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(
                f"PagePool needs n_pages >= 1 and page_size >= 1, got "
                f"{n_pages}/{page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: "deque[int]" = deque(range(self.n_pages))
        self._used: set = set()
        self.in_use_hwm = 0           # high-water mark of allocated pages

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._used)

    def alloc_one(self) -> int:
        """One free page; raises when the pool is empty."""
        if not self._free:
            raise RuntimeError("page pool exhausted")
        pid = self._free.popleft()
        self._used.add(pid)
        self.in_use_hwm = max(self.in_use_hwm, self.in_use)
        return pid

    def release(self, pid: int):
        if pid not in self._used:
            raise RuntimeError(f"page {pid} released but not allocated")
        self._used.remove(pid)
        self._free.append(pid)

    def stats(self) -> dict:
        return {"pages": self.n_pages, "page_size": self.page_size,
                "in_use": self.in_use, "free": self.free_count,
                "in_use_hwm": self.in_use_hwm}
