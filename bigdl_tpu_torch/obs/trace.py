"""Per-request trace contexts for the serving stack (counterpart of
bigdl_tpu/obs/trace.py).

Dapper-style (Sigelman et al., 2010) reduced to what a single-host
replica fleet needs: a trace context is an id plus an append-only list
of ``(phase, timestamp)`` hops.  The router mints one at admission (for
a SAMPLED request), every layer that touches the request stamps its
phase — ``admit`` → ``queue`` → ``dispatch`` → ``h2d`` → ``compute`` →
``complete`` on the happy path, ``shed``/``requeue`` on the others —
and the router emits the finished chain as one ``trace`` obs event, so
a postmortem (``tools/obs_report.py`` waterfall) can see exactly where
a slow request's time went, per hop, across process boundaries.

Hop timestamps are ``time.perf_counter()``: on Linux that is
``CLOCK_MONOTONIC``, which is shared by every process on the host, so a
chain stamped partly in the parent router and partly in a subprocess
replica (the context rides the length-prefixed stdio frames —
``serve/cluster.py``) stays monotone and subtractable.  Hops are
host-local times, not wall clock — the enclosing event's ``ts`` carries
wall time.

Sampling: ``BIGDL_OBS_TRACE_SAMPLE`` (default 0 = tracing off) is a
rate in [0, 1].  The :class:`Sampler` is deterministic — an error
accumulator traces exactly the configured fraction of requests (no
snapping to 1/k) — so drills can assert exact trace counts and the
default hot path never pays a single stamp.
"""
from __future__ import annotations

import os
import threading
import time

ENV_SAMPLE = "BIGDL_OBS_TRACE_SAMPLE"

#: the happy-path hop chain a completed request must cover, in order
#: (extra hops — requeue retries — may interleave)
REQUEST_PHASES = ("admit", "queue", "dispatch", "h2d", "compute",
                  "complete")


def sample_rate() -> float:
    """``BIGDL_OBS_TRACE_SAMPLE`` as a clamped [0, 1] rate; malformed or
    unset reads as 0 (tracing off)."""
    try:
        rate = float(os.environ.get(ENV_SAMPLE, "0"))
    except ValueError:
        return 0.0
    return min(max(rate, 0.0), 1.0)


class Trace:
    """One request's trace context: an id and the stamped hops."""

    __slots__ = ("trace_id", "hops")

    def __init__(self, trace_id: str | None = None, hops=None):
        self.trace_id = trace_id if trace_id else os.urandom(8).hex()
        self.hops = [list(h) for h in (hops or [])]

    def stamp(self, phase: str, ts: float | None = None) -> "Trace":
        self.hops.append(
            [phase, time.perf_counter() if ts is None else float(ts)])
        return self

    def duration_ms(self) -> float | None:
        if len(self.hops) < 2:
            return None
        return (self.hops[-1][1] - self.hops[0][1]) * 1e3

    def emit(self, status: str = "ok", **fields):
        """One ``trace`` obs event carrying the whole chain (the
        terminal emission — call exactly once per trace)."""
        from bigdl_tpu_torch.obs import events
        dur = self.duration_ms()
        if dur is not None:
            fields.setdefault("duration_ms", dur)
        return events.emit("trace", trace_id=self.trace_id, status=status,
                           hops=[list(h) for h in self.hops], **fields)


class Sampler:
    """Deterministic head sampler: an error accumulator adds ``rate``
    per call and mints a :class:`Trace` each time it crosses 1, so the
    sampled fraction equals ANY configured rate in [0, 1] — 1 → every
    request, 0.5 → every 2nd, 0.7 → 7 of every 10, 0 → never — not a
    snap to the nearest 1/k.  The first request is always sampled (the
    accumulator starts one ``rate`` short of the threshold).
    Thread-safe; the unsampled path is one lock + one add."""

    def __init__(self, rate: float | None = None):
        rate = sample_rate() if rate is None else min(max(float(rate),
                                                          0.0), 1.0)
        self.rate = rate
        self._lock = threading.Lock()
        self._acc = 1.0 - rate

    @property
    def enabled(self) -> bool:
        return self.rate > 0

    def next(self) -> Trace | None:
        """A fresh (unstamped) Trace when this request is sampled."""
        if self.rate <= 0:
            return None
        with self._lock:
            self._acc += self.rate
            if self._acc >= 1.0:
                self._acc -= 1.0
                return Trace()
        return None


def hop_deltas(hops) -> list:
    """``[(phase, seconds-since-previous-hop), ...]`` (first hop 0) —
    the waterfall rows ``tools/obs_report.py`` renders."""
    out = []
    prev = None
    for phase, ts in hops:
        out.append((phase, 0.0 if prev is None else ts - prev))
        prev = ts
    return out
