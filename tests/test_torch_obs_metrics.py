"""The port's metrics registry, event schema and TensorBoard writer against
the JAX package's (bigdl_tpu/obs/metrics.py, events.py, summary.py;
tests/test_obs_metrics.py): the same observations into both registries
give equal snapshots and equal Prometheus text, each package's ``merge``
takes the other's snapshot, an event either package writes validates in
the other, and tfevents files read across.  The decoder's series are the
JAX decoder's names under ``decoder=<name>``."""
import json

import numpy as np
import pytest
import torch

from bigdl_tpu.obs import events as jax_events
from bigdl_tpu.obs import metrics as jax_metrics
from bigdl_tpu.obs import summary as jax_summary
from bigdl_tpu_torch.obs import events, ledger, metrics, recorder, summary
from bigdl_tpu_torch.serve.decode import ContinuousDecoder
from tests.helpers.torch_lm import jax_lm, port_of


@pytest.fixture(autouse=True)
def _fresh_obs():
    for mod in (events, recorder):
        mod.reset()
    metrics.reset()
    ledger.reset()
    jax_events.reset()
    jax_metrics.reset()
    state = torch.random.get_rng_state()
    yield
    events.reset()
    metrics.reset()
    ledger.reset()
    jax_events.reset()
    jax_metrics.reset()
    torch.random.set_rng_state(state)


def _observe(mod, seed, engine="e0"):
    """One deterministic stream of observations into ``mod``'s registry
    (a fresh ``Registry``, returned)."""
    reg = mod.Registry()
    rs = np.random.RandomState(seed)
    reg.counter("serve_requests_total", "requests", engine=engine,
                outcome="completed").inc(int(rs.randint(1, 50)))
    reg.counter("serve_requests_total", "requests", engine=engine,
                outcome="shed").inc(3)
    reg.gauge("serve_queue_depth", "queued", engine=engine).set(
        float(rs.randint(0, 9)))
    reg.gauge("weights_version", "served version", agg="max",
              engine=engine).set(float(seed))
    lat = reg.histogram("serve_latency_seconds", "latency", engine=engine)
    for v in rs.lognormal(-5, 2, 200):
        lat.observe(float(v))
    itl = reg.histogram("decode_itl_seconds", "itl",
                        bounds=mod.ITL_BUCKETS, engine=engine)
    for v in rs.lognormal(-9, 1, 100):
        itl.observe_n(float(v), int(rs.randint(1, 4)))
    acc = reg.histogram("decode_spec_accept_len", "accepted",
                        bounds=mod.SPEC_ACCEPT_BUCKETS, engine=engine)
    for a in rs.randint(0, 5, 40):
        acc.observe(float(a))
    reg.counter("odd_labels_total", 'help with "quotes"\nand lines',
                engine='a"b\\c').inc(2)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshots_and_exposition_equal_jax(seed):
    mine, theirs = _observe(metrics, seed), _observe(jax_metrics, seed)
    assert mine.snapshot() == theirs.snapshot()
    text = metrics.render_prometheus(mine.snapshot())
    assert text == jax_metrics.render_prometheus(theirs.snapshot())
    assert metrics.parse_prometheus(text) == \
        jax_metrics.parse_prometheus(text)


def test_bucket_bounds_are_the_jax_ones():
    assert metrics.LATENCY_BUCKETS == jax_metrics.LATENCY_BUCKETS
    assert metrics.ITL_BUCKETS == jax_metrics.ITL_BUCKETS
    assert metrics.SPEC_ACCEPT_BUCKETS == jax_metrics.SPEC_ACCEPT_BUCKETS


@pytest.mark.parametrize("drop", [(), ("engine",)])
def test_each_merge_takes_the_others_snapshot(drop):
    a = _observe(metrics, 3, "e0").snapshot()
    b = _observe(jax_metrics, 4, "e1").snapshot()
    mine = metrics.merge([a, b], drop_labels=drop)
    theirs = jax_metrics.merge([a, b], drop_labels=drop)
    assert mine == theirs
    for name in ("serve_latency_seconds", "decode_itl_seconds"):
        assert metrics.histogram_quantiles(mine, name) == \
            jax_metrics.histogram_quantiles(theirs, name)
    for name in ("serve_requests_total", "serve_queue_depth"):
        assert metrics.family_total(mine, name) == \
            jax_metrics.family_total(theirs, name)
    # merged quantiles are the pooled stream's
    pooled = metrics.Registry()
    h = pooled.histogram("serve_latency_seconds", "latency")
    for snap in (a, b):
        for row in snap["serve_latency_seconds"]["series"]:
            for i, c in enumerate(row["counts"]):
                if c:
                    bound = (metrics.LATENCY_BUCKETS[i]
                             if i < len(metrics.LATENCY_BUCKETS) else 1e9)
                    h.observe_n(bound, c)
    if drop:
        assert metrics.histogram_quantiles(
            pooled.snapshot(), "serve_latency_seconds") == \
            metrics.histogram_quantiles(mine, "serve_latency_seconds")


def test_merge_refuses_mismatched_bounds():
    a = metrics.Registry()
    a.histogram("h", bounds=(1.0, 2.0)).observe(1.5)
    b = jax_metrics.Registry()
    b.histogram("h", bounds=(1.0, 3.0)).observe(1.5)
    with pytest.raises(ValueError, match="bounds"):
        metrics.merge([a.snapshot(), b.snapshot()])
    with pytest.raises(ValueError, match="bounds"):
        a.histogram("h", bounds=(1.0, 3.0))


def test_snapshot_jsonl_lines_read_in_both(tmp_path):
    path = str(tmp_path / "snap.jsonl")
    snap = _observe(metrics, 5).snapshot()
    metrics.append_snapshot_jsonl(path, snap, ts=12.5)
    jax_metrics.append_snapshot_jsonl(path, snap, ts=12.5)
    a, b = [json.loads(line) for line in open(path)]
    assert a == b and a["ts"] == 12.5
    assert metrics.merge([a["snapshot"], b["snapshot"]]) == \
        jax_metrics.merge([a["snapshot"], b["snapshot"]])


def test_drop_series_and_generation():
    reg = metrics.Registry()
    reg.counter("c", decoder="d0").inc()
    reg.counter("c", decoder="d1").inc()
    g = reg.generation
    reg.drop_series(decoder="d0")
    assert [r["labels"] for r in reg.snapshot()["c"]["series"]] == \
        [{"decoder": "d1"}]
    assert reg.generation == g + 1


# -- the event schema -------------------------------------------------------

KINDED = [
    ("run_start", dict(flags={"optimizer": "LocalOptimizer"})),
    ("run_end", dict(steps=4, wall=0.5)),
    ("step", dict(step=1, loss=2.3, lr=0.05, throughput=100.0,
                  taps={"grad_norm": 1.0})),
    ("phase", dict(name="dispatch", seconds=0.01, total=0.04, count=4,
                   step=5)),
    ("validation", dict(step=5, method="Top1Accuracy", value=0.5)),
    ("checkpoint", dict(step=3, path="/x/model.3")),
    ("prefetch_stall", dict(step=3, seconds=0.2, queue_depth=0)),
    ("abort", dict(step=4, reason="nonfinite", skips=1, streak=1)),
    ("crash_bundle", dict(reason="nonfinite-abort", path="/x")),
    ("serve", dict(kind="decode", steps=8, streaming=True,
                   first_token_ms=3.0, stream_boundaries=2)),
    ("serve", dict(kind="stream", tokens=3, ttft_ms=1.0,
                   timeline=[[1.0, 2], [2.0, 1]])),
    ("serve", dict(kind="error", error="ValueError: x", callback="tokens")),
    ("trace", dict(trace_id="ab", status="ok",
                   hops=[["decode_admit", 1.0], ["retire", 2.0]])),
    ("ledger", dict(kind="exec", fn="train_step", flops=1e6,
                    bytes_accessed=float("nan"))),
    ("ledger", dict(kind="tenant", tenant="kv_pool", bytes=1024)),
    ("forensic", dict(kind="slow", trace_id="ab", record={}, e2e_ms=9.0,
                      bound_ms=5.0)),
]


@pytest.mark.parametrize("etype,fields", KINDED)
def test_events_validate_across(etype, fields, tmp_path):
    log = events.EventLog(str(tmp_path / "p"), process_index=3)
    jlog = jax_events.EventLog(str(tmp_path / "j"), process_index=3)
    mine, theirs = log.emit(etype, **fields), jlog.emit(etype, **fields)
    log.close()
    jlog.close()
    assert log.path.endswith("events.p3.jsonl")
    for e in events.read_events(log.path) + [mine]:
        jax_events.validate_event(e)
    for e in jax_events.read_events(jlog.path) + [theirs]:
        events.validate_event(e)
    assert set(mine) == set(theirs)


def test_schema_is_the_jax_one():
    assert events.SCHEMA_VERSION == jax_events.SCHEMA_VERSION == 7
    assert events.EVENT_TYPES == jax_events.EVENT_TYPES
    for name in ("SERVE_KINDS", "RECOVER_KINDS", "LEDGER_KINDS",
                 "ALERT_KINDS", "SCALE_KINDS", "REMOTE_KINDS",
                 "FORENSIC_KINDS"):
        assert getattr(events, name) == getattr(jax_events, name)
    for bad in ({"v": 7, "ts": 0, "proc": 0, "type": "nope"},
                {"v": 8, "ts": 0, "proc": 0, "type": "step"},
                {"v": 7, "ts": 0, "proc": 0, "type": "serve",
                 "kind": "decode", "steps": 1, "streaming": True}):
        with pytest.raises(ValueError):
            events.validate_event(bad)
        with pytest.raises(ValueError):
            jax_events.validate_event(bad)


def test_ring_rotation_and_env_switch(tmp_path, monkeypatch):
    log = events.EventLog(str(tmp_path), ring=3, max_mb=1e-4, keep=1,
                          process_index=0)
    for i in range(10):
        log.emit("phase", name="x" * 40, seconds=0.0, step=i)
    assert [e["step"] for e in log.ring_events()] == [7, 8, 9]
    assert log.rotations >= 1
    log.close()
    monkeypatch.setenv("BIGDL_OBS", "0")
    events.reset()
    assert events.get() is None and events.emit("step") is None
    monkeypatch.setenv("BIGDL_OBS", "1")
    monkeypatch.setenv("BIGDL_OBS_DIR", str(tmp_path / "env"))
    events.reset()
    assert events.get().path == str(tmp_path / "env" / "events.p0.jsonl")


@pytest.mark.parametrize("writer,reader", [
    (summary.ScalarWriter, jax_summary.read_scalars),
    (jax_summary.ScalarWriter, summary.read_scalars)])
def test_tfevents_read_across(tmp_path, writer, reader):
    w = writer(str(tmp_path))
    pts = [(0, "Loss", 2.5), (1, "Loss", 2.25), (1, "Taps/grad_norm", 0.5),
           (-3, "Neg", -1.0), (2 ** 40, "Big", 3.0)]
    for step, tag, v in pts:
        w.add_scalar(tag, v, step, wall_time=100.0)
    w.close()
    assert reader(w.path) == pts
    with open(w.path, "rb") as f:
        data = f.read()
    mine = summary._scalar_event(100.0, 7, "Loss", 1.5)
    assert mine == jax_summary._scalar_event(100.0, 7, "Loss", 1.5)
    assert summary._masked_crc(data[:8]) == jax_summary._masked_crc(data[:8])


# -- the decoder's series -----------------------------------------------------

DECODER_SERIES = {
    "decode_steps_total", "decode_admitted_total", "decode_retired_total",
    "decode_host_syncs_total", "decode_slots_active", "decode_slots_hwm",
    "decode_kv_bytes_per_token", "decode_tokens_per_s",
    "decode_pages_in_use", "decode_pages_total", "decode_prefix_hits_total",
    "decode_prefix_misses_total", "decode_prefix_pages_total",
    "decode_ttft_seconds", "decode_itl_seconds",
    "decode_stream_tokens_total", "decode_sampled_total",
    "decode_stop_retired_total", "decode_steps_saved_total",
    "hbm_tenant_bytes"}


@pytest.mark.parametrize("spec_k", [0, 2])
def test_decoder_series_and_stats_from_the_registry(spec_k):
    model = port_of(jax_lm(3))
    dec = ContinuousDecoder(model, max_slots=2, n_pos=24, sync_interval=2,
                            device="cpu", spec_k=spec_k, name="d0")
    rs = np.random.RandomState(0)
    seeds = [rs.randint(0, 11, 5) for _ in range(3)]
    futs = [dec.submit(s, 4) for s in seeds]
    futs[0].request_stream()
    dec.run()
    rows = [f.result(timeout=30) for f in futs]
    snap = metrics.get().snapshot()
    names = {n for n, fam in snap.items()
             if any(r["labels"].get("decoder") == "d0"
                    for r in fam["series"])}
    want = DECODER_SERIES | ({"decode_spec_accept_len"} if spec_k else set())
    assert names == want
    st = dec.stats()
    total = lambda n: metrics.family_total(snap, n, decoder="d0")  # noqa
    assert st["steps"] == total("decode_steps_total") == dec.steps
    assert st["admitted"] == st["retired"] == 3
    assert st["host_syncs"] == total("decode_host_syncs_total")
    assert st["stream"]["streams"] == 1
    assert st["stream"]["tokens"] == total("decode_stream_tokens_total") == 4
    assert all(len(r) == 9 for r in rows)
    if spec_k:
        h = metrics.merged_histogram(snap, "decode_spec_accept_len",
                                     decoder="d0")
        assert h[3] == st["spec_windows"] > 0
    dec.close()
    assert not any(r["labels"].get("decoder") == "d0"
                   for fam in metrics.get().snapshot().values()
                   for r in fam["series"])
