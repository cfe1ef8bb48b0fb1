"""The port's request forensics and traces against the JAX package's
(bigdl_tpu/obs/recorder.py, trace.py; tests/test_recorder.py): a traced
decoder request gains ``decode_admit → first_token → retire`` hops and
its flight-recorder record (replay recipe, committed row); the TTFT
histogram counts one observation a streamed request and the ITL one a
token streamed after the first boundary; the recorder classifies the
JAX test's records as the JAX recorder does, and its bundles validate in
the JAX schema; the sampler and the hop deltas are the JAX ones."""
import pytest
import torch

from bigdl_tpu.obs import events as jax_events
from bigdl_tpu.obs import recorder as jax_recorder
from bigdl_tpu.obs import trace as jax_trace
from bigdl_tpu_torch.obs import events, ledger, metrics, recorder, trace
from bigdl_tpu_torch.serve.decode import ContinuousDecoder
from bigdl_tpu_torch.serve.sampling import SamplingParams
from tests.helpers.torch_lm import jax_lm, port_of


@pytest.fixture(autouse=True)
def _fresh_obs():
    for mod in (events, recorder, jax_events, jax_recorder):
        mod.reset()
    metrics.reset()
    ledger.reset()
    state = torch.random.get_rng_state()
    yield
    for mod in (events, recorder, jax_events, jax_recorder):
        mod.reset()
    metrics.reset()
    ledger.reset()
    torch.random.set_rng_state(state)


def _decoder(**kw):
    return ContinuousDecoder(port_of(jax_lm(1)), max_slots=2, n_pos=32,
                             sync_interval=2, device="cpu", name="rd", **kw)


def test_traced_streaming_request_hops_and_record(tmp_path):
    events.configure(str(tmp_path))
    dec = _decoder()
    traces = [trace.Trace() for _ in range(3)]
    seeds = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    futs = [dec.submit(s, 7, trace=t) for s, t in zip(seeds, traces)]
    for f in futs[:2]:
        f.request_stream()
    dec.run()
    rows = [f.result(timeout=30) for f in futs]
    for t in traces[:2]:
        assert [h[0] for h in t.hops] == ["decode_admit", "first_token",
                                          "retire"]
        stamps = [h[1] for h in t.hops]
        assert stamps == sorted(stamps)
    # a request that does not stream is admitted, its row committed
    assert [h[0] for h in traces[2].hops] == ["decode_admit"]
    for t, s, row in zip(traces, seeds, rows):
        rec = recorder.get().get(t.trace_id)
        assert rec["tokens"] == row and rec["seed_len"] == len(s)
        assert rec["seed_hash"] == jax_recorder.seed_hash(s)
        assert rec["rid"].startswith("rd/") and rec["decoder"] == "rd"
        assert rec["flags"] == dec.decode_flags()
        assert rec["kv_pages"] >= 1 and rec["start_pos"] >= 0
    evs = events.read_events(events.get().path)
    for e in evs:
        jax_events.validate_event(e)
    streams = [e for e in evs if e.get("kind") == "stream"]
    assert len(streams) == 2 and all(e["tokens"] == 7 for e in streams)
    decode, = [e for e in evs if e.get("kind") == "decode"]
    assert decode["streaming"] and decode["streams"] == 2
    # the trace event a caller emits for the finished chain validates too
    ev = traces[0].emit("ok")
    jax_events.validate_event(ev)
    assert trace.hop_deltas(traces[0].hops) == \
        jax_trace.hop_deltas(traces[0].hops)
    dec.close()


@pytest.mark.parametrize("sync,n_words", [(1, 5), (2, 7), (3, 4)])
def test_ttft_once_a_request_and_itl_once_a_token(tmp_path, sync, n_words):
    events.configure(str(tmp_path))
    dec = ContinuousDecoder(port_of(jax_lm(1)), max_slots=2, n_pos=32,
                            sync_interval=sync, device="cpu", name="h")
    seeds = ([1, 2], [3, 4, 5], [6])
    futs = [dec.submit(s, n_words) for s in seeds]
    got = [[] for _ in futs]
    for f, g in zip(futs, got):
        f.on_tokens(lambda toks, g=g: g.extend(toks))
    dec.run()
    rows = [f.result(timeout=30) for f in futs]
    assert [g for g in got] == [r[len(s):] for r, s in zip(rows, seeds)]
    snap = metrics.get().snapshot()
    ttft = metrics.merged_histogram(snap, "decode_ttft_seconds",
                                    decoder="h")
    itl = metrics.merged_histogram(snap, "decode_itl_seconds", decoder="h")
    assert ttft[3] == len(seeds)
    # each stream's first boundary's tokens are TTFT's; every later token
    # is one ITL observation
    timelines = [e["timeline"] for e in events.read_events(events.get().path)
                 if e.get("kind") == "stream"]
    assert len(timelines) == len(seeds)
    streamed = metrics.family_total(snap, "decode_stream_tokens_total",
                                    decoder="h")
    assert streamed == len(seeds) * n_words
    assert itl[3] == streamed - sum(tl[0][1] for tl in timelines)
    st = dec.stats()["stream"]
    assert st["streams"] == 3 and st["ttft_mean_ms"] > 0
    dec.close()


def test_sampled_request_notes_its_params():
    dec = _decoder()
    t = trace.Trace()
    f = dec.submit([1, 2], 4, trace=t,
                   sampling=SamplingParams(temperature=0.8, seed=11))
    dec.run()
    f.result(timeout=30)
    rec = recorder.get().get(t.trace_id)
    assert rec["sampling"]["seed"] == 11
    assert rec["sampling"]["temperature"] == pytest.approx(0.8)
    dec.close()


# -- the recorder against the JAX recorder ----------------------------------

CASES = [
    ({"outcome": "failed", "death_replica": "r0", "error": "x"},
     "replica_death"),
    ({"outcome": "failed", "error": "ValueError: x"}, "error"),
    ({"outcome": "shed", "shed_stage": "replica", "requeues": 2}, "shed"),
    ({"outcome": "ok", "blip_replica": "r1", "requeues": 1}, "partition"),
    ({"outcome": "ok", "requeues": 1, "slo_miss": "deadline"}, "requeue"),
    ({"outcome": "ok", "slo_miss": "ttft", "e2e_ms": 100.0}, "slo_miss"),
    ({"outcome": "ok", "e2e_ms": 100.0}, "slow"),
    ({"outcome": "ok", "e2e_ms": 1.0}, None),
]


@pytest.mark.parametrize("rec,want", CASES)
def test_classification_is_the_jax_recorders(rec, want):
    mine = recorder.FlightRecorder(tail_ms=5.0).classify(dict(rec))
    theirs = jax_recorder.FlightRecorder(tail_ms=5.0).classify(dict(rec))
    assert mine == theirs and mine[0] == want


def test_windowed_p99_and_ring_as_jax():
    for mod in (recorder, jax_recorder):
        fr = mod.FlightRecorder(ring=3, tail_ms=0.0, tail_p99x=3.0)
        assert fr._p99_bound() is None
        for _ in range(30):
            fr._lat.append(2.0)
        assert fr._p99_bound() == pytest.approx(6.0)
        assert fr.classify({"outcome": "ok", "e2e_ms": 7.0})[0] == "slow"
        for i in range(5):
            fr.open(f"t{i}", priority=i)
        assert [r["trace_id"] for r in fr.records()] == ["t2", "t3", "t4"]
        fr.note("t9", rid="d0/1", skipped=None)
        rec = fr.get("t9")
        assert rec["rid"] == "d0/1" and "skipped" not in rec


def test_finalize_bundles_as_jax(tmp_path):
    events.configure(str(tmp_path / "p"))
    jax_events.configure(str(tmp_path / "j"))
    out = []
    for mod, ev in ((recorder, events), (jax_recorder, jax_events)):
        fr = mod.FlightRecorder()
        fr.open("ok1", priority=0)
        a = fr.finalize("ok1", "ok", e2e_ms=1.0)
        b = fr.finalize("ok2", "ok", head_sampled=True)
        fr.open("bad", replica="r0")
        c = fr.finalize("bad", "failed", error="ValueError: boom")
        forensic = [e for e in ev.read_events(ev.get().path)
                    if e["type"] == "forensic"]
        out.append((a, b, c, [(e["kind"], e["trace_id"],
                               e["record"]["anomaly"],
                               [x["trace_id"] for x in e["context"]])
                              for e in forensic]))
        for e in forensic:
            jax_events.validate_event(e)
            events.validate_event(e)
    assert out[0] == out[1]
    assert out[0][:3] == (False, True, True)
    assert metrics.family_total(metrics.get().snapshot(),
                                "forensic_requests_total", kind="error") == 1


@pytest.mark.parametrize("rate", [0.0, 0.3, 0.5, 0.7, 1.0])
def test_sampler_is_the_jax_sampler(rate):
    mine, theirs = trace.Sampler(rate), jax_trace.Sampler(rate)
    a = [mine.next() is not None for _ in range(40)]
    b = [theirs.next() is not None for _ in range(40)]
    assert a == b and sum(a) == int(round(rate * 40))


def test_trace_sample_env_and_durations(monkeypatch):
    monkeypatch.setenv(trace.ENV_SAMPLE, "1")
    assert trace.Sampler().enabled and trace.sample_rate() == 1.0
    monkeypatch.setenv(trace.ENV_SAMPLE, "bogus")
    assert trace.sample_rate() == 0.0
    t = trace.Trace("ab").stamp("admit", 1.0).stamp("queue", 2.5)
    t.stamp("compute", 4.0)
    back = jax_trace.Trace(t.trace_id, t.hops)
    assert back.duration_ms() == t.duration_ms() == pytest.approx(3000.0)
    assert trace.hop_deltas(t.hops) == jax_trace.hop_deltas(back.hops)
    assert recorder.seed_hash([1, 2, 3]) == jax_recorder.seed_hash([1, 2, 3])


def test_recorder_off_is_inert(monkeypatch):
    monkeypatch.setenv(recorder.ENV_RECORDER, "0")
    recorder.reset()
    assert recorder.get() is None
    recorder.note("t", rid="x")
    assert recorder.finalize("t", "failed") is False
    assert recorder.finalize("t", "failed", head_sampled=True) is True
    dec = _decoder()
    t = trace.Trace()
    f = dec.submit([1, 2], 3, trace=t)
    dec.run()
    assert len(f.result(timeout=30)) == 5
    assert [h[0] for h in t.hops] == ["decode_admit"]
    dec.close()
