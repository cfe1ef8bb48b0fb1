"""Always-on per-request flight recorder — tail-based forensics for the
serving stack (counterpart of bigdl_tpu/obs/recorder.py).

Head sampling (obs/trace.py, ``BIGDL_OBS_TRACE_SAMPLE`` default 0)
cannot answer the on-call question "why was *this* request slow /
failed / wrong": the requests you most need traced — errors, SLO
misses, requeue storms, p99 outliers — are exactly the ones a head
sampler cannot know to keep.  The :class:`FlightRecorder` inverts the
decision: EVERY request gets a cheap record and a perf_counter-stamped
trace, assembled from hooks that already exist at every seam (router
admission/dispatch/shed/requeue, engine submit/complete, decoder
admit/boundary/first-token/retire, fleet prefill-ship/affinity, the
remote frame path), and only at the TERMINAL state does the recorder
decide what the request turned out to be:

* healthy and not head-sampled → the record stays in the bounded ring
  (``BIGDL_OBS_RECORDER_N``, default 512) and nothing is emitted —
  zero trace events, zero per-request file writes;
* head-sampled → the ``trace`` event is emitted as before (the two
  retention policies compose);
* anomalous (error, shed, requeue, deadline/TTFT/e2e SLO miss,
  involvement in a replica death or partition, or latency above
  ``BIGDL_OBS_TAIL_MS`` / the windowed-p99 multiplier
  ``BIGDL_OBS_TAIL_P99X``) → the trace event is emitted AND a schema-v7
  ``forensic`` event carries the full record plus the ring's
  neighboring-request context — the non-fatal analog of the
  ``obs/diagnostics.py`` crash bundle — and
  ``forensic_requests_total{kind=...}`` counts it.

Cost discipline: the recorder never touches the device.  Notes are
plain dict merges under one lock; the decode-side notes ride the step
boundary's ONE existing slab materialization (no added syncs, no
per-token host work); cross-process notes ride the reply frames that
already carry trace hops.  ``BIGDL_OBS_RECORDER=0`` restores the exact
pre-recorder behavior (head sampling only, zero stamps at sample=0).

The recorded decode fields (committed token row, seed length, decode
flags, quant recipe, served weight version) are exactly what
``tools/request_replay.py`` needs to re-execute the request offline
and diff the token stream — greedy replay must be token-identical.
"""
from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from collections import OrderedDict, deque

logger = logging.getLogger("bigdl_tpu_torch.obs")

ENV_RECORDER = "BIGDL_OBS_RECORDER"
ENV_RING = "BIGDL_OBS_RECORDER_N"
ENV_TAIL_MS = "BIGDL_OBS_TAIL_MS"
ENV_TAIL_P99X = "BIGDL_OBS_TAIL_P99X"

#: neighbors on each side shipped as forensic-bundle context
CONTEXT_N = 4
#: latency window for the p99 tail bound (finalized e2e samples)
_P99_WINDOW = 256
#: minimum window fill before the p99 bound judges anybody
_P99_MIN = 20

#: anomaly kinds by precedence — a request that is several things at
#: once (a shed request also missed its deadline) is counted under the
#: most causal kind.  Must stay a subset of events.FORENSIC_KINDS.
KIND_PRECEDENCE = ("error", "shed", "replica_death", "partition",
                   "requeue", "slo_miss", "slow")


def seed_hash(seed) -> str:
    """Stable short hash of a token-id seed (the record carries the
    hash; the committed row carries the actual tokens)."""
    h = hashlib.sha1()
    for t in seed:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()[:16]


def enabled() -> bool:
    return os.environ.get(ENV_RECORDER, "1") != "0"


def _env_float(name: str, default: float = 0.0) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FlightRecorder:
    """Bounded ring of per-request records keyed by trace id.

    Thread-safe: the router dispatch loop, engine compute loop, decoder
    boundary thread and remote read loops all note concurrently.  A
    note for an unknown trace id CREATES the record — subprocess
    replicas accumulate notes without an explicit open and ship them
    back in the reply frame (:meth:`export_notes`)."""

    def __init__(self, ring: int | None = None,
                 tail_ms: float | None = None,
                 tail_p99x: float | None = None):
        if ring is None:
            try:
                ring = int(os.environ.get(ENV_RING, "512"))
            except ValueError:
                ring = 512
        self.ring_n = max(int(ring), 1)
        self.tail_ms = (_env_float(ENV_TAIL_MS) if tail_ms is None
                        else float(tail_ms))
        self.tail_p99x = (_env_float(ENV_TAIL_P99X) if tail_p99x is None
                          else float(tail_p99x))
        self._lock = threading.Lock()
        self._ring: OrderedDict[str, dict] = OrderedDict()
        self._lat = deque(maxlen=_P99_WINDOW)
        self.finalized = 0
        self.anomalies = 0

    # -- assembly ----------------------------------------------------------

    def open(self, trace_id: str, **fields) -> dict:
        """Start (or refresh) the record for one request."""
        with self._lock:
            rec = self._ring.get(trace_id)
            if rec is None:
                rec = {"trace_id": trace_id, "t_open": time.time()}
                self._ring[trace_id] = rec
                while len(self._ring) > self.ring_n:
                    self._ring.popitem(last=False)
            for k, v in fields.items():
                if v is not None:
                    rec[k] = v
            return rec

    def note(self, trace_id: str | None, **fields):
        """Merge fields into a request's record (create on miss — the
        subprocess-replica path).  None values are skipped so call
        sites can pass optionals unconditionally."""
        if not trace_id:
            return None
        return self.open(trace_id, **fields)

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            rec = self._ring.get(trace_id)
            return dict(rec) if rec is not None else None

    def records(self) -> list:
        """Ring snapshot, oldest first (obs_report's Forensics source)."""
        with self._lock:
            return [dict(r) for r in self._ring.values()]

    # -- terminal classification -------------------------------------------

    def _p99_bound(self) -> float | None:
        """Windowed p99 × multiplier, or None while the window is thin
        or the multiplier knob is off."""
        if self.tail_p99x <= 0 or len(self._lat) < _P99_MIN:
            return None
        xs = sorted(self._lat)
        p99 = xs[min(len(xs) - 1, int(0.99 * (len(xs) - 1)))]
        return p99 * self.tail_p99x

    def classify(self, rec: dict) -> tuple[str | None, dict]:
        """The anomaly kind for a finalized record (None = healthy)
        plus the kind's required event fields."""
        status = rec.get("outcome")
        e2e = rec.get("e2e_ms")
        if status == "failed":
            if rec.get("death_replica"):
                return "replica_death", {"replica": rec["death_replica"]}
            return "error", {"error": rec.get("error", "unknown")}
        if status == "shed":
            return "shed", {"stage": rec.get("shed_stage", "admission")}
        if rec.get("blip_replica"):
            return "partition", {"replica": rec["blip_replica"]}
        if rec.get("death_replica"):
            return "replica_death", {"replica": rec["death_replica"]}
        if rec.get("requeues"):
            return "requeue", {"attempts": int(rec["requeues"])}
        if rec.get("slo_miss"):
            return "slo_miss", {"slo": rec["slo_miss"]}
        if e2e is not None:
            if self.tail_ms > 0 and e2e > self.tail_ms:
                return "slow", {"e2e_ms": e2e, "bound_ms": self.tail_ms}
            bound = self._p99_bound()
            if bound is not None and e2e > bound:
                return "slow", {"e2e_ms": e2e, "bound_ms": bound}
        return None, {}

    def _context(self, trace_id: str) -> list:
        """Lightweight summaries of the ring's neighboring requests —
        what else the process was serving around the anomaly (the
        crash-bundle "last N events" analog).  Called under the lock."""
        keys = list(self._ring)
        try:
            i = keys.index(trace_id)
        except ValueError:
            i = len(keys)
        out = []
        lo = max(0, i - CONTEXT_N)
        for k in keys[lo:i] + keys[i + 1:i + 1 + CONTEXT_N]:
            r = self._ring[k]
            out.append({"trace_id": k,
                        "outcome": r.get("outcome"),
                        "e2e_ms": r.get("e2e_ms"),
                        "replica": r.get("replica"),
                        "priority": r.get("priority")})
        return out

    def finalize(self, trace_id: str | None, status: str,
                 trace=None, head_sampled: bool = False,
                 **fields) -> bool:
        """Terminal-state hook: absorb the last fields + the hop
        timeline, classify, emit the forensic bundle when anomalous,
        and return whether the trace event should be emitted (head
        sampled OR anomalous) — the tail-retention decision.

        Never raises: forensics must not break the serving path."""
        if not trace_id:
            return head_sampled
        try:
            with self._lock:
                rec = self._ring.get(trace_id)
                if rec is None:
                    rec = {"trace_id": trace_id, "t_open": time.time()}
                    self._ring[trace_id] = rec
                    while len(self._ring) > self.ring_n:
                        self._ring.popitem(last=False)
                rec["outcome"] = status
                for k, v in fields.items():
                    if v is not None:
                        rec[k] = v
                if trace is not None:
                    rec["hops"] = [list(h) for h in trace.hops]
                    dur = trace.duration_ms()
                    if dur is not None:
                        rec.setdefault("e2e_ms", dur)
                self.finalized += 1
                kind, kind_fields = self.classify(rec)
                if status == "ok" and rec.get("e2e_ms") is not None:
                    self._lat.append(float(rec["e2e_ms"]))
                if kind is None:
                    return head_sampled
                rec["anomaly"] = kind
                self.anomalies += 1
                context = self._context(trace_id)
                record = dict(rec)
            from bigdl_tpu_torch.obs import events, metrics
            reg = metrics.get()
            reg.counter(
                "forensic_requests_total",
                "anomalous requests bundled by the flight recorder",
                kind=kind).inc()
            if record.get("e2e_ms") is not None:
                # max-agg high-water mark: serve_top's anomalies line
                # shows the worst end-to-end among anomalous requests
                g = reg.gauge("forensic_worst_e2e_ms",
                              "worst e2e among anomalous requests",
                              agg="max")
                g.set(max(g.value, float(record["e2e_ms"])))
            events.emit("forensic", kind=kind, trace_id=trace_id,
                        record=record, context=context, **kind_fields)
            return True
        except Exception as e:  # pragma: no cover - defensive
            logger.warning("flight recorder finalize failed: %s", e)
            return head_sampled


# -- process-wide singleton (the events.py get/configure/reset pattern) -----

_REC: FlightRecorder | None = None
_LOADED = False
_LOCK = threading.Lock()


def get() -> FlightRecorder | None:
    """The process flight recorder, or None when off
    (``BIGDL_OBS_RECORDER=0``)."""
    global _REC, _LOADED
    if not _LOADED:
        with _LOCK:
            if not _LOADED:
                if enabled():
                    _REC = FlightRecorder()
                _LOADED = True
    return _REC


def configure(ring: int | None = None, tail_ms: float | None = None,
              tail_p99x: float | None = None) -> FlightRecorder:
    """Install a recorder programmatically (tests, drills)."""
    global _REC, _LOADED
    with _LOCK:
        _REC = FlightRecorder(ring=ring, tail_ms=tail_ms,
                              tail_p99x=tail_p99x)
        _LOADED = True
    return _REC


def reset():
    """Forget the process recorder (re-reads env on next get())."""
    global _REC, _LOADED
    with _LOCK:
        _REC = None
        _LOADED = False


# -- convenience wrappers (no-ops when the recorder is off) -----------------

def note(trace_id: str | None, **fields):
    rec = get()
    if rec is not None:
        rec.note(trace_id, **fields)


def finalize(trace_id: str | None, status: str, trace=None,
             head_sampled: bool = False, **fields) -> bool:
    """Module-level finalize; with the recorder off the decision
    degrades to plain head sampling."""
    rec = get()
    if rec is None:
        return head_sampled
    return rec.finalize(trace_id, status, trace=trace,
                        head_sampled=head_sampled, **fields)
