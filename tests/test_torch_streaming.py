"""The port's streaming futures (bigdl_tpu_torch/serve/streaming.py)
against tests/test_streaming.py's contracts -- delivery and backlog
replay, start-index dedup, a gap raising, piping, a raising consumer
failing only itself, the delivery thread resolving a future after its
last chunk -- and the decoder's streams: the concatenated chunks equal
each resolved row's tail on paged, prefix-hit, speculative, int8 and
stop-truncated runs (rows also the JAX decoder's where greedy), and one
slab read a boundary."""
import threading
import time

import pytest

from bigdl_tpu.models.transformer import lm_decode as jax_lm_decode
from bigdl_tpu.serve.streaming import StreamFuture as JaxStreamFuture
from bigdl_tpu_torch.serve import (ContinuousDecoder, SafeFuture,
                                   StreamFuture, TokenDelivery)
from tests.helpers.torch_lm import SEEDS, jax_lm, port_of


@pytest.fixture(scope="module")
def lm():
    return jax_lm()


@pytest.fixture(scope="module")
def port(lm):
    return port_of(lm)


@pytest.fixture(scope="module")
def serial(lm):
    return [jax_lm_decode(lm, s, 5, greedy=True) for s in SEEDS]


def _stream_all(dec, seeds, n_words, sampling=None):
    """Submit every seed with an on_tokens collector; (rows, the chunks
    each consumer saw, concatenated, futures) after the run."""
    chunks = [[] for _ in seeds]
    futs = []
    for i, s in enumerate(seeds):
        f = dec.submit(s, n_words, sampling=sampling)
        f.on_tokens(lambda toks, i=i: chunks[i].append(list(toks)))
        futs.append(f)
    dec.run()
    rows = [f.result(timeout=60) for f in futs]
    return rows, [[t for c in ch for t in c] for ch in chunks], futs


# ---------------------------------------------------------------------------
# StreamFuture / SafeFuture / TokenDelivery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Fut", [StreamFuture, JaxStreamFuture])
def test_feed_on_tokens_and_backlog(Fut):
    f = Fut()
    got = []
    f.on_tokens(got.append)
    assert f.feed([1, 2]) == 2 and f.feed([3]) == 1
    assert got == [[1, 2], [3]]
    assert f.streamed() == [1, 2, 3] and f.tokens_streamed() == 3
    assert f.stream_chunks == 2
    late = []
    f.on_tokens(late.append)
    assert late == [[1, 2, 3]]           # one replay chunk, in order
    f.feed([4])
    assert got[-1] == late[-1] == [4]


def test_start_index_dedup_and_gap():
    f = StreamFuture()
    got = []
    f.on_tokens(got.append)
    f.feed([1, 2, 3], start=0)
    assert f.feed([1, 2], start=0) == 0
    assert f.feed([1, 2, 3, 4, 5], start=0) == 2
    assert got == [[1, 2, 3], [4, 5]]
    with pytest.raises(ValueError, match="starts at 9"):
        f.feed([9], start=9)


def test_pipe_chain_preserves_indexes_and_flags():
    a, b, c = StreamFuture(), StreamFuture(), StreamFuture()
    assert not a.streaming
    a.pipe_to(b)
    b.pipe_to(c)
    a.feed([1, 2], start=0)
    a.feed([1, 2, 3], start=0)
    assert c.streamed() == [1, 2, 3]
    assert a.streaming and b.streaming and c.streaming
    g = StreamFuture().request_stream()
    assert g.streaming


def test_ttft_records_first_chunk():
    f = StreamFuture()
    assert f.ttft_s is None
    f.feed([1], ts=f.t_create + 0.25)
    f.feed([2], ts=f.t_create + 0.50)
    assert f.ttft_s == pytest.approx(0.25)


def test_raising_consumers_fail_only_themselves(caplog):
    f = StreamFuture()
    good = []
    f.on_tokens(lambda _t: (_ for _ in ()).throw(RuntimeError("bug")))
    f.on_tokens(good.append)
    f.feed([1, 2])
    f.feed([3])
    assert good == [[1, 2], [3]]
    s = SafeFuture()
    s.add_done_callback(lambda _f: (_ for _ in ()).throw(KeyError("x")))
    s.set_result(42)
    assert s.result() == 42
    s.add_done_callback(lambda _f: (_ for _ in ()).throw(KeyError("y")))
    assert sum("callback raised" in r.getMessage()
               for r in caplog.records) == 3


def test_token_delivery_resolves_after_its_chunks():
    d = TokenDelivery(name="t")
    try:
        f = StreamFuture()
        seen = []
        f.on_tokens(lambda toks: seen.append(list(toks)))
        f.add_done_callback(lambda _f: seen.append("done"))
        d.enqueue(f, [1], 0, time.perf_counter())
        d.enqueue(f, [2], 1, time.perf_counter())
        d.resolve(f, "row")
        assert f.result(timeout=10) == "row"
        deadline = time.time() + 5
        while seen[-1:] != ["done"] and time.time() < deadline:
            time.sleep(0.005)
        assert seen == [[1], [2], "done"]
        callback_threads = []
        g = StreamFuture()
        g.on_tokens(lambda _t: callback_threads.append(
            threading.current_thread().name))
        d.enqueue(g, [5], 0, time.perf_counter())
        d.resolve(g, "r")
        g.result(timeout=10)
        assert callback_threads and callback_threads[0] != \
            threading.current_thread().name
    finally:
        d.close()


# ---------------------------------------------------------------------------
# the decoder's streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    pytest.param({}, id="paged"),
    pytest.param({"spec_k": 1}, id="spec1"),
    pytest.param({"spec_k": 3, "prefix_cache": True}, id="spec3"),
])
def test_stream_parity(port, serial, cfg):
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, sync_interval=2,
                            page_size=4, device="cpu", **cfg)
    rows, streamed, futs = _stream_all(dec, SEEDS, 5)
    assert rows == serial
    for r, st, s, f in zip(rows, streamed, SEEDS, futs):
        assert st == r[len(s):] == f.streamed()
        assert f.ttft_s is not None and f.ttft_s > 0
    assert dec.stats()["stream"]["streams"] == len(SEEDS)
    dec.close()


def test_prefix_hit_stream_parity(lm, port):
    sys_prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    seeds = [sys_prompt + [9], sys_prompt + [10]]
    oracle = [jax_lm_decode(lm, s, 4, greedy=True) for s in seeds]
    dec = ContinuousDecoder(port, max_slots=2, n_pos=16, sync_interval=2,
                            page_size=4, prefix_cache=True, device="cpu")
    first = dec.submit(seeds[0], 4)
    dec.run()
    assert first.result(timeout=60) == oracle[0]
    rows, streamed, _ = _stream_all(dec, [seeds[1]], 4)
    assert rows == [oracle[1]] and dec.stats()["prefix"]["hits"] == 1
    assert streamed[0] == oracle[1][len(seeds[1]):]
    dec.close()


@pytest.mark.parametrize("spec_k", [0, 2])
def test_int8_and_sampled_stream_parity(port, spec_k):
    """Streamed chunks equal the same decoder's rows exactly: int8 pools,
    and sampled requests (streaming adds no drift and no draw)."""
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, sync_interval=2,
                            page_size=4, kv_quant="int8", spec_k=spec_k,
                            device="cpu")
    rows, streamed, _ = _stream_all(dec, SEEDS, 5)
    for r, st, s in zip(rows, streamed, SEEDS):
        assert st == r[len(s):]
    sp = {"temperature": 0.9, "top_k": 4, "seed": 12}
    rows, streamed, _ = _stream_all(dec, SEEDS[:2], 5, sampling=sp)
    plain = [dec.submit(s, 5, sampling=sp) for s in SEEDS[:2]]
    dec.run()
    assert rows == [f.result(timeout=60) for f in plain]
    for r, st, s in zip(rows, streamed, SEEDS):
        assert st == r[len(s):]
    dec.close()


@pytest.mark.parametrize("spec_k", [0, 2])
def test_stop_truncated_stream_never_over_delivers(port, serial, spec_k):
    s, row = SEEDS[0], serial[0]
    stop, gen = row[len(s):len(s) + 2], row[len(s):]
    end = len(s) + 2 + next(j for j in range(len(gen))
                            if gen[j:j + 2] == stop)
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, sync_interval=2,
                            page_size=4, spec_k=spec_k, device="cpu")
    rows, streamed, _ = _stream_all(dec, [s], 5)
    chunks = []
    f = dec.submit(s, 5, sampling={"stop": [stop]})
    f.on_tokens(chunks.extend)
    dec.run()
    got = f.result(timeout=60)
    assert got == row[:end] and chunks == got[len(s):]
    assert rows == [row] and streamed[0] == row[len(s):]
    dec.close()


def test_stream_sync_accounting(port):
    """Without streams only the retiring boundary reads the slab; with a
    stream, one read a boundary -- never one a token, never a second for
    the retirement."""
    seed, n_words = [1, 2], 9             # 10 positions, sync 2
    dec = ContinuousDecoder(port, max_slots=2, n_pos=10, sync_interval=2,
                            page_size=5, prefix_cache=False, device="cpu")
    f = dec.submit(seed, n_words)
    dec.run()
    f.result(timeout=60)
    assert dec.host_syncs == 1
    got = []
    f = dec.submit(seed, n_words)
    f.on_tokens(got.extend)
    dec.run()
    row = f.result(timeout=60)
    assert dec.host_syncs == 1 + 5
    assert got == row[len(seed):]
    st = dec.stats()["stream"]
    assert st["boundaries"] == 5 < n_words and st["tokens"] == n_words
    dec.close()


def test_spec_stream_adds_no_sync(port):
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, sync_interval=2,
                            page_size=4, prefix_cache=False, spec_k=2,
                            device="cpu")
    futs = [dec.submit(s, 5) for s in SEEDS]
    dec.run()
    [f.result(timeout=60) for f in futs]
    plain = dec.host_syncs
    _stream_all(dec, SEEDS, 5)
    assert dec.host_syncs - plain == plain
    dec.close()


def test_raising_consumer_mid_run(port, serial):
    dec = ContinuousDecoder(port, max_slots=2, n_pos=9, sync_interval=2,
                            page_size=4, device="cpu")
    good = []
    f0 = dec.submit(SEEDS[0], 5)
    f0.on_tokens(lambda toks: (_ for _ in ()).throw(RuntimeError("bad")))
    f1 = dec.submit(SEEDS[1], 5)
    f1.on_tokens(good.extend)
    dec.run()
    assert f0.result(timeout=60) == serial[0]
    assert f1.result(timeout=60) == serial[1]
    assert good == serial[1][len(SEEDS[1]):]
    rows, streamed, _ = _stream_all(dec, SEEDS[2:], 5)
    assert rows == serial[2:]
    dec.close()
    assert dec._delivery is None
