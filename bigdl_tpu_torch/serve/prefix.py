"""Token-hash prefix caching over the paged KV pool (counterpart of
bigdl_tpu/serve/prefix.py).

Requests that share a leading prompt -- a fleet's system prompt --
recompute identical K/V: causal attention makes the K/V at position
``p`` a pure function of tokens ``0..p``.  With block-paged KV
(``serve/paging.py``) that redundancy is a page-granular cache: a
retiring request DONATES the full pages whose positions lie entirely
inside its seed (ownership moves, no copy: the pages already hold the
right values), and a new request whose seed matches a cached chain maps
those pages into its own page table read-only and starts at the
divergence point, skipping that much prefill.

Keys are the per-page hash chain: page ``j``'s key digests tokens ``0 ..
(j+1)*page_size``, the whole prefix through that page, so two prompts
share page ``j`` only when they agree on everything before it.
Divergence is page-aligned, so a partial page is never shared and the
first page a request writes is always its own.  A matched request still
re-feeds its last seed position (the first generated token comes from
the logits there), so a match is capped at ``len(seed) - 1`` positions.

int8 pools need nothing more: the scale arrays are indexed by physical
page id exactly like the value pools (``quant/kv.py``), so a donated
page ships its scales with it.

Eviction is LRU over entries whose page nobody else holds (refcount 1:
cache-only); the decoder evicts on demand when an admission cannot find
free pages.  ``on_evict(key, pid)`` fires after the chain entry is
removed and before the pool reference drops, so the page's content is
still addressable and a hook that re-enters the cache sees a consistent
one; a failing hook is logged and the eviction completes.
"""
from __future__ import annotations

import hashlib
import logging
from collections import OrderedDict

import numpy as np

logger = logging.getLogger("bigdl_tpu_torch.serve")


def chain_keys(seed, n_pages: int, page_size: int):
    """Yield page ``j``'s chain key for ``j = 0 .. n_pages - 1``:
    ``sha1(parent_key || tokens of page j)``, an incremental digest over
    the whole prefix through page ``j`` (the tokens as int32 bytes, the
    JAX package's keys)."""
    toks = np.asarray(seed[:n_pages * page_size], np.int32)
    key = b""
    for j in range(n_pages):
        h = hashlib.sha1(key)
        h.update(toks[j * page_size:(j + 1) * page_size].tobytes())
        key = h.digest()
        yield key


class PrefixCache:
    """Chain-hash -> page-id map over one
    :class:`~bigdl_tpu_torch.serve.paging.PagePool`.

    The cache owns one reference on every page it holds; :meth:`match`
    retains the matched pages for the requesting slot, which releases
    them at retire (through :meth:`insert`'s duplicate path or
    ``pool.release``)."""

    def __init__(self, pool, on_evict=None):
        self.pool = pool
        self.on_evict = on_evict
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0          # requests that matched >= 1 page
        self.misses = 0        # requests that matched none
        self.pages_reused = 0  # total pages served from the cache
        self.inserted = 0      # pages donated into the cache
        self.evicted = 0       # pages evicted back to the pool
        self.adopted = 0       # pages registered through adopt()

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, seed) -> list:
        """Longest cached chain of full pages agreeing with ``seed``,
        capped at ``len(seed) - 1`` positions; the page ids in logical
        order, each RETAINED for the caller.  Counts nothing: the decoder
        calls :meth:`note_request` once per request it admits."""
        ps = self.pool.page_size
        max_pages = max(0, (len(seed) - 1) // ps)
        pids = []
        for key in chain_keys(seed, max_pages, ps):
            pid = self._entries.get(key)
            if pid is None:
                break
            self._entries.move_to_end(key)
            pids.append(pid)
        for pid in pids:
            self.pool.retain(pid)
        return pids

    def lookup(self, key: bytes):
        """The page id cached under one chain key (LRU-touched and
        RETAINED for the caller), or ``None``."""
        pid = self._entries.get(key)
        if pid is None:
            return None
        self._entries.move_to_end(key)
        self.pool.retain(pid)
        return pid

    def adopt(self, key: bytes, pid: int) -> bool:
        """Register a freshly written page under ``key``: the caller's
        reference moves to the cache.  False (and the reference is
        released) when the key is already cached."""
        if key in self._entries:
            self._entries.move_to_end(key)
            self.pool.release(pid)
            return False
        self._entries[key] = pid
        self.adopted += 1
        return True

    def note_request(self, matched_pages: int):
        """Count one admitted request against the hit/miss ledger."""
        if matched_pages > 0:
            self.hits += 1
            self.pages_reused += matched_pages
        else:
            self.misses += 1

    def insert(self, seed, pids):
        """Donate a retiring request's leading pages: ``pids[j]`` holds
        the K/V of positions ``j*ps .. (j+1)*ps - 1`` computed under
        ``seed``.  Each page's reference moves to the cache; where the
        chain key is already cached (the pages this request matched at
        admission among them) the caller's reference is released."""
        ps = self.pool.page_size
        for key, pid in zip(chain_keys(seed, len(pids), ps), pids):
            if key in self._entries:
                self._entries.move_to_end(key)
                self.pool.release(pid)
            else:
                self._entries[key] = pid
                self.inserted += 1

    def evict(self, n: int) -> int:
        """Free up to ``n`` least-recently-used cache-only pages (refcount
        1: a page some live slot still maps is skipped) in one scan;
        returns the number freed."""
        freed = 0
        for key in list(self._entries):
            if freed >= n:
                break
            pid = self._entries.get(key)
            if pid is None:     # a hook re-entered and evicted it
                continue
            if self.pool.refcount(pid) == 1:
                del self._entries[key]
                if self.on_evict is not None:
                    try:
                        self.on_evict(key, pid)
                    except Exception:
                        logger.warning(
                            "prefix on_evict hook failed for page %d",
                            pid, exc_info=True)
                self.pool.release(pid)
                self.evicted += 1
                freed += 1
        return freed

    def evict_one(self) -> bool:
        """Free the single LRU cache-only page; False when nothing is
        evictable."""
        return self.evict(1) == 1

    def drop_all(self):
        """Release every cache-held page (decoder teardown)."""
        while self._entries:
            _, pid = self._entries.popitem(last=False)
            self.pool.release(pid)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "pages_reused": self.pages_reused,
                "inserted": self.inserted, "evicted": self.evicted,
                "adopted": self.adopted}
