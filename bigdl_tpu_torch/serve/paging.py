"""Block-paged KV-cache allocation (counterpart of
bigdl_tpu/serve/paging.py; host-side bookkeeping only, no tensors).

KV storage is a ``(n_pages, page_size, ...)`` pool; every request holds
only the fixed-size pages its own length needs, and a per-slot
slot->page table maps logical positions to pool pages.  Pages are
refcounted because the prefix cache (``serve/prefix.py``) shares
read-only pages across requests: a shared page frees only when its last
holder lets go.  The decoder's pools carry one page more than this pool
hands out (``models.transformer.new_pools``): the scratch page that
gated writes land on, which is never allocated, shared or donated.
"""
from __future__ import annotations

from collections import deque


class RequestTooLongError(ValueError):
    """A decode request needs more positions than the decoder can ever
    hold (``len(seed) + n_words - 1 > n_pos``, or more pages than the
    whole pool).  Set on the request's OWN future at submit time."""


class PagePool:
    """Refcounted free-list allocator over page ids ``0 .. n_pages-1``.
    ``alloc_one`` hands out a page at refcount 1; :meth:`retain` /
    :meth:`release` move shared (prefix-cache) pages between holders; a
    page returns to the free list when its last reference drops."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(
                f"PagePool needs n_pages >= 1 and page_size >= 1, got "
                f"{n_pages}/{page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: "deque[int]" = deque(range(self.n_pages))
        self._ref: dict = {}          # page id -> refcount
        self.in_use_hwm = 0           # high-water mark of allocated pages

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._ref)

    def alloc_one(self) -> int:
        """One free page at refcount 1; raises when the pool is empty
        (callers check ``free_count`` or evict first)."""
        if not self._free:
            raise RuntimeError("page pool exhausted")
        pid = self._free.popleft()
        self._ref[pid] = 1
        self.in_use_hwm = max(self.in_use_hwm, self.in_use)
        return pid

    def retain(self, pid: int):
        """One more holder of an allocated page (a prefix-cache hit
        mapping a shared page into a new slot's table)."""
        if pid not in self._ref:
            raise RuntimeError(f"page {pid} retained but not allocated")
        self._ref[pid] += 1

    def release(self, pid: int):
        """Drop one reference; the page frees when nobody holds it."""
        n = self._ref.get(pid, 0)
        if n == 0:
            raise RuntimeError(f"page {pid} released but not allocated")
        if n == 1:
            del self._ref[pid]
            self._free.append(pid)
        else:
            self._ref[pid] = n - 1

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def stats(self) -> dict:
        return {"pages": self.n_pages, "page_size": self.page_size,
                "in_use": self.in_use, "free": self.free_count,
                "in_use_hwm": self.in_use_hwm}
