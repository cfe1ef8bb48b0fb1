"""The port's refcounted page pool and prefix cache
(bigdl_tpu_torch/serve/{paging,prefix}.py) against the JAX package's, and
the decoder's prefix admission, donation and eviction against the JAX
``ContinuousDecoder`` token for token (greedy, fp32 pools: rows equal;
int8 pools: ``_held_to_jax_int8``'s rule), with the JAX model's weights
carried across."""
import pytest

from bigdl_tpu.models.transformer import lm_decode as jax_lm_decode
from bigdl_tpu.serve import PagePool as JaxPagePool
from bigdl_tpu.serve import PrefixCache as JaxPrefixCache
from bigdl_tpu.serve import chain_keys as jax_chain_keys
from bigdl_tpu.serve.decode import ContinuousDecoder as JaxDecoder
from bigdl_tpu_torch.serve import (ContinuousDecoder, PagePool, PrefixCache,
                                   chain_keys)
from bigdl_tpu_torch.serve import decode as port_decode
from tests.helpers.torch_lm import jax_lm, port_of
from tests.test_torch_decode import _held_to_jax_int8

SYS = [7, 3, 9, 1]                        # page-aligned at page sizes 2, 4


@pytest.fixture(scope="module")
def lm():
    return jax_lm()


@pytest.fixture(scope="module")
def port(lm):
    return port_of(lm)


def _waves(model, waves, jax=False, **kw):
    """Serve ``waves`` (lists of (seed, n_words)) one after another on one
    decoder; (rows, stats after each wave)."""
    dec = (JaxDecoder(model, **kw) if jax
           else ContinuousDecoder(model, device="cpu", **kw))
    rows, stats = [], []
    for wave in waves:
        futs = [dec.submit(s, n) for s, n in wave]
        dec.run()
        rows.append([f.result(timeout=60) for f in futs])
        st = dec.stats()
        stats.append({"steps": st["steps"], "pool": dict(st["pool"]),
                      "prefix": dict(st.get("prefix", {}))})
    dec.close()
    return rows, stats


# ---------------------------------------------------------------------------
# the pool and the cache
# ---------------------------------------------------------------------------

def test_alloc_release_refcount_as_jax():
    ours, theirs = PagePool(4, 2), JaxPagePool(4, 2)
    for pool in (ours, theirs):
        a = pool.alloc_one()
        pool.retain(a)
        assert pool.refcount(a) == 2
        pool.release(a)
        assert pool.refcount(a) == 1 and pool.in_use == 1
        pool.release(a)
        assert pool.refcount(a) == 0 and pool.free_count == 4
    assert ours.stats() == theirs.stats()
    with pytest.raises(RuntimeError, match="not allocated"):
        ours.release(0)
    with pytest.raises(RuntimeError, match="not allocated"):
        ours.retain(0)


def test_chain_keys_are_the_jax_keys():
    seed = [5, 6, 7, 8, 9, 10, 11]
    assert list(chain_keys(seed, 3, 2)) == list(jax_chain_keys(seed, 3, 2))
    k = list(chain_keys(seed, 2, 2))
    assert k[0] != k[1]
    # page 1's key covers page 0: a different first page changes it
    assert list(chain_keys([0] + seed[1:], 2, 2))[1] != k[1]


def test_match_capped_below_full_seed():
    pool = PagePool(8, 2)
    cache = PrefixCache(pool)
    pages = [pool.alloc_one() for _ in range(3)]
    seed = [5, 6, 7, 8, 9, 10]           # 3 full pages of 2
    cache.insert(seed, pages)
    assert cache.match(list(seed)) == pages[:2]   # (6-1)//2 = 2
    assert cache.match(seed + [3]) == pages
    assert cache.match([5, 6, 0, 1, 2, 3]) == pages[:1]
    assert cache.match([9, 9, 9, 9]) == []


def test_insert_duplicate_releases_donor_page():
    pool = PagePool(8, 2)
    cache = PrefixCache(pool)
    first = [pool.alloc_one()]
    cache.insert([1, 2, 3], first)
    dup = [pool.alloc_one()]
    cache.insert([1, 2, 9], dup)          # same first-page chain
    assert pool.refcount(dup[0]) == 0
    assert pool.refcount(first[0]) == 1
    assert cache.stats()["inserted"] == 1


def test_evict_skips_shared_pages_and_hook_order():
    """LRU over cache-only pages; the hook sees the entry gone and the
    page still held; a failing hook still frees the page."""
    pool = PagePool(8, 2)
    seen = []

    def hook(key, pid):
        seen.append((key in cache._entries, pool.refcount(pid)))
        raise RuntimeError("telemetry bug")

    cache = PrefixCache(pool, on_evict=hook)
    cache.insert([1, 2, 3], [pool.alloc_one()])
    held = cache.match([1, 2, 9])
    assert len(held) == 1
    assert not cache.evict_one()         # refcount 2: a slot maps it
    pool.release(held[0])
    assert cache.evict_one()
    assert seen == [(False, 1)]
    assert pool.in_use == 0 and cache.stats()["evicted"] == 1


def test_lookup_adopt_and_drop_all_as_jax():
    results = []
    for Pool, Cache in ((PagePool, PrefixCache),
                        (JaxPagePool, JaxPrefixCache)):
        pool = Pool(6, 2)
        cache = Cache(pool)
        key = next(iter(chain_keys([4, 4, 4], 1, 2)))
        pid = pool.alloc_one()
        assert cache.adopt(key, pid)
        dup = pool.alloc_one()
        assert not cache.adopt(key, dup)
        assert cache.lookup(key) == pid and pool.refcount(pid) == 2
        assert cache.lookup(b"nothing") is None
        pool.release(pid)
        cache.note_request(1)
        cache.note_request(0)
        cache.drop_all()
        results.append((pool.stats(), cache.stats()))
    assert results[0] == results[1]
    assert results[0][0]["in_use"] == 0


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [2, 4])
def test_prefix_hit_matches_cold_prefill_and_jax(lm, port, page_size):
    """The second wave maps cached system-prompt pages and decodes the
    cold rows; hits, reused pages and the pool's use equal the JAX
    decoder's."""
    waves = [[(SYS + [2], 4)],
             [(SYS + [5], 4), (SYS + [8, 6], 4), ([4, 5, 6], 4)]]
    kw = dict(max_slots=2, n_pos=10, sync_interval=2, page_size=page_size,
              prefix_cache=True)
    rows, stats = _waves(port, waves, **kw)
    jrows, jstats = _waves(lm, waves, jax=True, **kw)
    assert rows == jrows
    assert rows == [[jax_lm_decode(lm, s, n) for s, n in w] for w in waves]
    assert stats[0]["prefix"]["hits"] == 0
    assert stats[1]["prefix"]["hits"] >= 2
    for ours, theirs in zip(stats, jstats):
        assert ours["prefix"] == theirs["prefix"]
        assert ours["pool"]["in_use"] == theirs["pool"]["in_use"] \
            == ours["prefix"]["entries"]


def test_prefix_hits_skip_prefill_steps(port, lm):
    seed = SYS + SYS + [2]               # 8 shared + 1 own token
    kw = dict(max_slots=1, n_pos=16, sync_interval=1, page_size=4,
              prefix_cache=True)
    rows, stats = _waves(port, [[(seed, 4)], [(seed, 4)]], **kw)
    cold = stats[0]["steps"]
    assert stats[1]["steps"] - cold <= cold - 8 + 1
    assert stats[1]["prefix"]["pages_reused"] == 2
    assert rows[0] == rows[1] == [jax_lm_decode(lm, seed, 4)]


def test_eviction_reclaims_cache_pages_under_pressure(lm, port):
    """An admission that wants pages the free list cannot give evicts
    cache-only pages; the tokens are the JAX decoder's."""
    a, b = [1, 2, 3, 4], [5, 6, 7, 8]
    kw = dict(max_slots=1, n_pos=8, sync_interval=2, page_size=2, n_pages=4,
              prefix_cache=True)
    rows, stats = _waves(port, [[(a, 4)], [(b, 4)]], **kw)
    jrows, jstats = _waves(lm, [[(a, 4)], [(b, 4)]], jax=True, **kw)
    assert rows == jrows
    assert rows == [[jax_lm_decode(lm, a, 4)], [jax_lm_decode(lm, b, 4)]]
    assert stats[1]["prefix"]["evicted"] == jstats[1]["prefix"]["evicted"] \
        >= 1


def test_pool_pressure_with_shared_pages(lm, port):
    """Four requests on a small pool, three sharing a system prompt
    (staggered: the shared pages are live in one slot while another
    admits): tokens as JAX's, and every page free or cache-only at the
    end."""
    wave = [(SYS + SYS + [2], 3), (SYS + SYS + [5], 3), ([3, 3, 1], 3),
            (SYS + SYS + [9, 9], 3)]
    kw = dict(max_slots=2, n_pos=12, sync_interval=2, page_size=4,
              n_pages=6, prefix_cache=True)
    rows, stats = _waves(port, [wave, wave], **kw)
    jrows, _ = _waves(lm, [wave, wave], jax=True, **kw)
    assert rows == jrows
    assert rows[0] == [jax_lm_decode(lm, s, n) for s, n in wave]
    assert stats[-1]["pool"]["in_use"] == stats[-1]["prefix"]["entries"]


def test_prefix_disabled_never_hits(port):
    rows, stats = _waves(port, [[(SYS + [2], 4)], [(SYS + [2], 4)]],
                         max_slots=1, n_pos=10, sync_interval=2,
                         page_size=2, prefix_cache=False)
    assert stats[-1]["prefix"] == {}
    assert stats[-1]["pool"]["in_use"] == 0
    assert rows[0] == rows[1]


def test_prefix_cache_env_default(port, monkeypatch):
    kw = dict(max_slots=1, n_pos=10, page_size=2, device="cpu")
    monkeypatch.delenv(port_decode.ENV_PREFIX, raising=False)
    assert ContinuousDecoder(port, **kw)._prefix is not None
    monkeypatch.setenv(port_decode.ENV_PREFIX, "0")
    assert ContinuousDecoder(port, **kw)._prefix is None
    assert ContinuousDecoder(port, prefix_cache=True, **kw)._prefix \
        is not None


def test_int8_prefix_hit_held_to_jax(lm, port):
    """Donated int8 pages carry their scales: the hit rows are the cold
    rows' of this decoder, and held to the JAX int8 decoder's."""
    waves = [[(SYS + [2], 4)], [(SYS + [2], 4), (SYS + [5], 4)]]
    kw = dict(max_slots=2, n_pos=10, sync_interval=2, page_size=2,
              prefix_cache=True, kv_quant="int8")
    rows, stats = _waves(port, waves, **kw)
    jrows, _ = _waves(lm, waves, jax=True, **kw)
    assert stats[1]["prefix"]["hits"] == 2
    assert rows[1][0] == rows[0][0]
    for got, want in zip(rows, jrows):
        _held_to_jax_int8(lm, got, want, 2)


def test_donation_and_release_accounting(port):
    """A retiring request donates min(len(seed) // ps, its pages) pages
    and releases the rest; a page some live slot maps is released, not
    freed; the scratch page (id n_pages) is never handed out."""
    dec = ContinuousDecoder(port, max_slots=2, n_pos=12, sync_interval=2,
                            page_size=2, prefix_cache=True, device="cpu")
    scratch = dec._pool.n_pages
    a = dec.submit(SYS + [2], 5)                     # 9 steps, 5 pages
    dec.run()
    assert a.done()
    assert dec.stats()["prefix"]["entries"] == 2     # 5 // 2 seed pages
    assert dec._pool.in_use == 2
    b = dec.submit(SYS + [5, 6], 3)                  # hits both pages
    dec.step_boundary()
    req = next(r for r in dec._slots if r is not None)
    shared = req.pages[:2]
    assert req.start_pos == 4 and all(dec._pool.refcount(p) == 2
                                      for p in shared)
    assert scratch not in req.pages
    dec.run()
    assert b.done()
    assert all(dec._pool.refcount(p) == 1 for p in shared)
    assert dec._pool.in_use == dec.stats()["prefix"]["entries"] == 3
    dec.close()
    assert dec._pool.in_use == 0


def test_table_covers_shared_head_pages(lm, port, monkeypatch):
    """A prefix hit starts past its shared pages, and the table a cycle
    passes the attention still holds them (its width counts from page
    0); the tokens are the JAX decoder's."""
    from bigdl_tpu_torch.models import transformer as tt
    widths = []
    real = tt.paged_attention

    def spy(q, kpool, vpool, ptab, pos, *scales):
        live = pos[pos >= 0]
        if live.numel():
            assert int(live.max()) < ptab.shape[1] * kpool.shape[1]
        widths.append(ptab.shape[1])
        return real(q, kpool, vpool, ptab, pos, *scales)

    seed = SYS + SYS + [1, 2, 3]
    kw = dict(max_slots=2, n_pos=16, sync_interval=3, page_size=2,
              prefix_cache=True)
    rows, stats = _waves(port, [[(seed, 4)]], **kw)
    monkeypatch.setattr(tt, "paged_attention", spy)
    dec = ContinuousDecoder(port, device="cpu", **kw)
    first = dec.submit(seed, 4)
    dec.run()
    widths.clear()
    hit = dec.submit(seed, 4)
    dec.run()
    assert dec.stats()["prefix"]["hits"] == 1
    assert min(widths) >= 5              # 10 of 11 seed positions shared
    assert hit.result() == first.result() == rows[0][0] \
        == jax_lm_decode(lm, seed, 4)
    dec.close()
