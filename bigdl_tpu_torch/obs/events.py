"""Structured event log — schema-versioned JSONL per process plus an
in-memory ring buffer (counterpart of bigdl_tpu/obs/events.py, the same
schema and wire format: a line either package writes validates in the
other).

The reference explains a run through its job log (Optimizer.header
progress lines + Metrics summaries); that is unparseable after the fact
and says nothing about *why* a step was skipped or a host died.  Here
every notable runtime moment — step, phase, validation, checkpoint,
fault injection, watchdog trip, preemption, abort — is one JSON object
with a fixed schema, so ``tools/obs_report.py`` (or any jq one-liner)
can reconstruct the run, and the crash-bundle path
(``obs/diagnostics.py``) can dump the last-N events even when the
process is going down inside a signal handler or a watchdog thread.

Layout: one ``events.p<rank>.jsonl`` per process under the run directory
(``BIGDL_OBS_DIR`` or :func:`configure`), the rank from
``torch.distributed`` when a process group is up, else 0, mirroring the
one-log-per-executor shape of the reference's Spark stdout collection.
With no run directory the log is ring-only: events are still retained
in memory for crash bundles, nothing touches the filesystem.

Master switch ``BIGDL_OBS=0`` disables the subsystem entirely (``get``
returns None and the convenience :func:`emit` becomes a no-op).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

logger = logging.getLogger("bigdl_tpu_torch.obs")

#: bump when an event type gains/loses REQUIRED fields; readers accept
#: unknown optional fields at any version.  v2: `serve` events grew
#: per-kind required fields (SERVE_KINDS) and the `trace` type landed.
#: v3: the `ledger` (compile-time cost/HBM truth) and `alert`
#: (declarative rule transitions) types landed, each with per-kind
#: required fields (LEDGER_KINDS / ALERT_KINDS).  v4: the `stream`
#: serve kind landed (one streamed decode request's token timeline),
#: and `decode` events that report streaming (``streaming: true``)
#: must carry `first_token_ms` + `stream_boundaries`.  v5: the `scale`
#: type landed (autoscaler/dynamic-membership decisions, SCALE_KINDS)
#: plus the `replica_added`/`replica_draining`/`replica_removed`
#: serve kinds the router emits on membership changes.  v6: the
#: `remote` type landed (cross-host TCP replica lifecycle,
#: REMOTE_KINDS: connect/blip/reattach/partition/death — the
#: blip-vs-death audit trail docs/serving.md "Cross-host fleet"
#: documents).  v7: the `forensic` type landed (obs/recorder.py
#: tail-based request forensics, FORENSIC_KINDS: one anomalous
#: request's full flight-recorder record + ring-neighbor context —
#: the non-fatal analog of the crash bundle).
SCHEMA_VERSION = 7

ENV_OBS = "BIGDL_OBS"
ENV_DIR = "BIGDL_OBS_DIR"
ENV_RING = "BIGDL_OBS_RING"
ENV_MAX_MB = "BIGDL_OBS_MAX_MB"
ENV_KEEP = "BIGDL_OBS_KEEP"

#: required fields per event type (beyond the common envelope); optional
#: fields (taps, straggler_dropped, skips, ...) are free-form
EVENT_TYPES = {
    "run_start": ("flags",),
    "run_end": ("steps", "wall"),
    "step": ("step", "loss", "lr", "throughput"),
    "phase": ("name", "seconds"),
    "validation": ("step", "method", "value"),
    "checkpoint": ("step", "path"),
    "fault": ("site", "step"),
    # the input pipeline failed to hide the fetch: the consuming loop
    # waited `seconds` for the prefetch queue at `step` (queue was empty)
    "prefetch_stall": ("step", "seconds"),
    # serving lifecycle/telemetry (serve/engine.py, serve/decode.py,
    # serve/router.py, serve/cluster.py): kind-specific required fields
    # in SERVE_KINDS below; error events carry the failed request count
    # + message, stop events a stats snapshot, rollout events the weight
    # version (the hot-swap audit trail, docs/serving.md)
    "serve": ("kind",),
    # one sampled request's hop chain (obs/trace.py): hops is a list of
    # [phase, perf_counter_ts] pairs, status in {ok, shed, failed}
    "trace": ("trace_id", "status", "hops"),
    "watchdog": ("stale",),
    # elastic recovery lifecycle (resilience/elastic.py): kind-specific
    # required fields in RECOVER_KINDS below — the trip→quiesce→reform→
    # reshard→resume chain is the recovery timeline obs_report renders
    "recover": ("kind",),
    "preempt": ("step",),
    "abort": ("step", "reason"),
    "crash_bundle": ("reason", "path"),
    # compile-time cost/HBM ledger (obs/ledger.py): kind-specific
    # required fields in LEDGER_KINDS — exec captures, tenant bytes,
    # device-memory samples (the obs_report HBM timeline)
    "ledger": ("kind",),
    # declarative alert transitions (obs/alerts.py): firing/resolved
    # with the rule name + the value/threshold that judged it
    "alert": ("kind", "rule"),
    # autoscaler / dynamic-membership decisions (serve/autoscale.py,
    # ReplicaPool.add_replica/remove_replica): kind-specific required
    # fields in SCALE_KINDS — the scale/recovery timeline obs_report
    # renders and the capstone chaos drill asserts on
    "scale": ("kind",),
    # cross-host replica transport lifecycle (serve/remote.py,
    # tools/replica_agent.py): kind-specific required fields in
    # REMOTE_KINDS — connect/blip/reattach/partition/death, the trail
    # that distinguishes a survived network blip (reattach, zero
    # requeues) from a real death (requeue-exactly-once)
    "remote": ("kind",),
    # one anomalous request's forensic bundle (obs/recorder.py, schema
    # v7): the FlightRecorder's full per-request record plus the ring's
    # neighboring-request context, emitted at the anomalous terminal
    # state — kind-specific required fields in FORENSIC_KINDS
    "forensic": ("kind", "trace_id", "record"),
}

#: per-kind REQUIRED fields for `serve` events (v2).  An unknown kind is
#: a validation error — a silent typo'd kind would vanish from every
#: postmortem query.  Fields here are the ones downstream tools key on
#: (obs_report's rollout timeline needs the version, the requeue audit
#: needs the replica name); everything else stays free-form.
SERVE_KINDS = {
    "start": (),
    "stop": (),
    "error": ("error",),
    "decode": ("steps",),
    # one streamed decode request's per-token timeline (serve/decode.py
    # emits at retire): tokens delivered, submit→first-token latency,
    # and the per-boundary [ms-since-submit, token-count] pairs the
    # obs_report token waterfall renders (schema v4)
    "stream": ("tokens", "ttft_ms", "timeline"),
    "shed": (),
    "weights_commit": ("version",),
    "weights_revert": ("version",),
    "router_start": ("replicas",),
    "router_stop": (),
    "replica_dead": ("replica",),
    # dynamic membership (schema v5): a replica joining the dispatch
    # set, entering drain-only state, or leaving the pool entirely
    "replica_added": ("replica",),
    "replica_draining": ("replica",),
    "replica_removed": ("replica",),
    "fleet_start": ("replicas",),
    "fleet_stop": ("replicas",),
    "rollout_begin": ("version",),
    "rollout_commit": ("version",),
    "rollout_rollback": ("version", "phase"),
}

#: per-kind REQUIRED fields for `recover` events (schema v2, same
#: contract as SERVE_KINDS): an unknown kind is a validation error.
#: world sizes ride the reform/reshard/resume kinds so a postmortem can
#: read the membership change without correlating other streams;
#: `resume` carries the recovery pause (seconds from trip to the first
#: post-reform dispatch) — the number the bounded-pause acceptance
#: drill asserts on.
RECOVER_KINDS = {
    "trip": ("stale",),
    "quiesce": ("step",),
    "reform": ("world_before", "world_after"),
    "reshard": ("world_after",),
    "resume": ("step", "world_before", "world_after", "pause_s"),
    "abort": ("reason",),
}

#: per-kind REQUIRED fields for `ledger` events (schema v3, same
#: contract as SERVE_KINDS): an unknown kind is a validation error.
#: `exec` is one compiled executable's cost truth (obs/ledger.py
#: capture), `tenant` a named large allocation's current bytes,
#: `hbm` one device-memory sampler tick (the report's HBM timeline).
LEDGER_KINDS = {
    "exec": ("fn", "flops", "bytes_accessed"),
    "tenant": ("tenant", "bytes"),
    "hbm": ("in_use",),
}

#: per-kind REQUIRED fields for `alert` events (schema v3): every
#: transition carries the value that judged it and the rule's bound,
#: so a postmortem reads the margin without replaying the registry.
ALERT_KINDS = {
    "firing": ("value", "threshold"),
    "resolved": ("value", "threshold"),
}

#: per-kind REQUIRED fields for `scale` events (schema v5, the
#: SERVE_KINDS contract): an unknown kind is a validation error.  `up`
#: and `down` are committed membership changes and carry the replica
#: plus the POLICY REASON that drove the decision (the audit trail the
#: capstone drill reads back); `spawn_failed` is one failed spawn
#: attempt inside the retry/backoff loop, `frozen`/`unfrozen` the
#: circuit-breaker transitions that stop a crash loop.
SCALE_KINDS = {
    "up": ("replica", "reason"),
    "down": ("replica", "reason"),
    "spawn_failed": ("error", "attempt"),
    "frozen": ("failures",),
    "unfrozen": (),
}

#: per-kind REQUIRED fields for `remote` events (v6) — the cross-host
#: transport lifecycle.  `blip` marks a lost connection still inside
#: the liveness budget (reconnect in progress), `reattach` the
#: successful resume of the SAME connection (carries the measured outage),
#: `partition` the agent-side chaos injection, `death` the client-side
#: conversion to DeadReplicaError after the budget expired.
REMOTE_KINDS = {
    "connect": ("replica", "address"),
    "blip": ("replica",),
    "reattach": ("replica", "blip_s"),
    "partition": ("len_s",),
    "death": ("replica",),
}

#: per-kind REQUIRED fields for `forensic` events (schema v7, the
#: SERVE_KINDS contract): an unknown kind is a validation error.  Each
#: kind is one way a request ends anomalous; the `record` field carries
#: the FlightRecorder's full per-request record (obs/recorder.py) and
#: `context` the ring's neighboring-request summaries.  `slo_miss`
#: names which budget was blown (`slo` in {deadline, ttft, e2e});
#: `slow` carries the latency and the tail bound that judged it;
#: `partition` marks a request in flight across a RemoteReplica blip.
FORENSIC_KINDS = {
    "error": ("error",),
    "shed": ("stage",),
    "requeue": ("attempts",),
    "slo_miss": ("slo",),
    "slow": ("e2e_ms", "bound_ms"),
    "replica_death": ("replica",),
    "partition": ("replica",),
}

_COMMON = ("v", "ts", "proc", "type")

_KINDED = {"serve": SERVE_KINDS, "recover": RECOVER_KINDS,
           "ledger": LEDGER_KINDS, "alert": ALERT_KINDS,
           "scale": SCALE_KINDS, "remote": REMOTE_KINDS,
           "forensic": FORENSIC_KINDS}


def validate_event(event: dict) -> dict:
    """Check one decoded event against the schema; returns the event or
    raises ValueError naming the violation.  Used by the smoke script
    and report tool so a malformed emitter fails CI, not a postmortem."""
    if not isinstance(event, dict):
        raise ValueError(f"event must be an object, got {type(event)}")
    for k in _COMMON:
        if k not in event:
            raise ValueError(f"event missing common field {k!r}: {event}")
    if not isinstance(event["v"], int):
        raise ValueError(f"schema version must be int: {event['v']!r}")
    if event["v"] > SCHEMA_VERSION:
        raise ValueError(f"event schema v{event['v']} is newer than this "
                         f"reader (v{SCHEMA_VERSION})")
    etype = event["type"]
    required = EVENT_TYPES.get(etype)
    if required is None:
        raise ValueError(f"unknown event type {etype!r} "
                         f"(known: {sorted(EVENT_TYPES)})")
    missing = [k for k in required if k not in event]
    if missing:
        raise ValueError(f"{etype!r} event missing {missing}: {event}")
    kinds = _KINDED.get(etype)
    if kinds is not None:
        kind = event["kind"]
        per_kind = kinds.get(kind)
        if per_kind is None:
            raise ValueError(f"unknown {etype} kind {kind!r} "
                             f"(known: {sorted(kinds)})")
        missing = [k for k in per_kind if k not in event]
        if missing:
            raise ValueError(
                f"{etype}/{kind} event missing {missing}: {event}")
    if etype == "serve":
        kind = event["kind"]
        if kind == "decode" and event.get("streaming"):
            # required-when-streaming (schema v4): a decode run that
            # claims streaming must carry its SLO aggregates
            missing = [k for k in ("first_token_ms", "stream_boundaries")
                       if k not in event]
            if missing:
                raise ValueError(
                    f"streaming decode event missing {missing}: {event}")
        if kind == "stream":
            tl = event["timeline"]
            if (not isinstance(tl, list) or not tl
                    or not all(isinstance(b, (list, tuple)) and len(b) == 2
                               for b in tl)):
                raise ValueError(
                    f"stream timeline must be a non-empty list of "
                    f"[ms, tokens] pairs: {tl!r}")
    if etype == "trace":
        hops = event["hops"]
        if (not isinstance(hops, list) or not hops
                or not all(isinstance(h, (list, tuple)) and len(h) == 2
                           for h in hops)):
            raise ValueError(
                f"trace hops must be a non-empty list of "
                f"[phase, ts] pairs: {hops!r}")
    return event


def _process_index() -> int:
    """This process's rank in the default ``torch.distributed`` group, or
    0 before one is formed (a watchdog thread before the group is up)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    return 0


class EventLog:
    """Ring buffer + optional JSONL sink for one process.

    Thread-safe: the training loop, the watchdog monitor thread and a
    signal-handler epilogue may all emit concurrently."""

    def __init__(self, run_dir: str | None = None, ring: int | None = None,
                 process_index: int | None = None,
                 max_mb: float | None = None, keep: int | None = None):
        if ring is None:
            ring = int(os.environ.get(ENV_RING, "512"))
        if max_mb is None:
            try:
                max_mb = float(os.environ.get(ENV_MAX_MB, "0") or 0)
            except ValueError:
                max_mb = 0.0
        if keep is None:
            try:
                keep = int(os.environ.get(ENV_KEEP, "2"))
            except ValueError:
                keep = 2
        self.run_dir = run_dir
        self._proc = process_index
        self._ring = deque(maxlen=max(int(ring), 1))
        self._lock = threading.Lock()
        self._fh = None
        self.path = None
        #: JSONL size cap (bytes; 0 = unlimited): a week-long serving
        #: run must not fill the disk.  On overflow the current file
        #: rotates to `<path>.1` with keep-last semantics (like
        #: `BIGDL_CKPT_KEEP`): the newest `keep` rotated segments
        #: survive, older ones are deleted.  The in-memory ring — and
        #: therefore crash bundles — is unaffected by rotation.
        self._max_bytes = int(float(max_mb) * (1 << 20))
        self._keep = max(1, int(keep))
        self.rotations = 0
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self.path = os.path.join(
                run_dir, f"events.p{self.process_index()}.jsonl")
            self._fh = open(self.path, "a")

    def process_index(self) -> int:
        if self._proc is None:
            self._proc = _process_index()
        return self._proc

    def _record(self, event: dict):
        """Ring-append + file-write one event under the lock.  Never
        raises: a full disk must not kill the training loop."""
        self._ring.append(event)
        if self._fh is not None:
            try:
                self._fh.write(json.dumps(event, default=_jsonable))
                self._fh.write("\n")
                self._fh.flush()
                if self._max_bytes and self._fh.tell() >= self._max_bytes:
                    self._rotate()
            except (OSError, ValueError) as e:
                logger.warning("event sink write failed: %s", e)

    def _rotate(self):
        """Shift the full JSONL to ``<path>.1`` (``.1``→``.2``, ...;
        segments beyond ``keep`` deleted) and reopen a fresh file.
        Called under the lock from :meth:`_record`; best-effort — a
        rotation failure must not kill the emitter."""
        try:
            self._fh.close()
            last = self.path + f".{self._keep}"
            if os.path.exists(last):
                os.unlink(last)
            for j in range(self._keep - 1, 0, -1):
                src = self.path + f".{j}"
                if os.path.exists(src):
                    os.replace(src, self.path + f".{j + 1}")
            os.replace(self.path, self.path + ".1")
            self.rotations += 1
        except OSError as e:   # pragma: no cover - fs race/perm
            logger.warning("event log rotation failed: %s", e)
        finally:
            self._fh = open(self.path, "a")

    def emit(self, etype: str, **fields) -> dict:
        """Append one event (common envelope added here).  Never raises
        past the sink: a full disk must not kill the training loop."""
        event = {"v": SCHEMA_VERSION, "ts": time.time(),
                 "proc": self.process_index(), "type": etype}
        event.update(fields)
        with self._lock:
            self._record(event)
        return event

    def ring_events(self) -> list:
        """Snapshot of the in-memory ring (oldest first)."""
        with self._lock:
            return list(self._ring)

    def close(self):
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def _jsonable(v):
    """json.dumps default: numpy / torch scalars degrade to floats,
    anything else to repr — an event must never fail to serialize."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


def read_events(path: str) -> list:
    """Decode one JSONL file (no validation — see validate_event)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# -- process-wide log (env-configured; tests use configure) ----------------

_LOG: EventLog | None = None
_LOADED = False


def enabled() -> bool:
    return os.environ.get(ENV_OBS, "1") != "0"


def get() -> EventLog | None:
    """The process event log, or None when obs is off (``BIGDL_OBS=0``).
    Created lazily: ring-only unless ``BIGDL_OBS_DIR`` names a run
    directory.  ``configure``/``reset`` override."""
    global _LOG, _LOADED
    if not _LOADED:
        _LOADED = True
        if enabled():
            run_dir = os.environ.get(ENV_DIR, "").strip() or None
            _LOG = EventLog(run_dir=run_dir)
    return _LOG


def configure(run_dir: str | None = None, ring: int | None = None,
              process_index: int | None = None,
              max_mb: float | None = None,
              keep: int | None = None) -> EventLog:
    """Install a process event log programmatically (launchers, tests)."""
    global _LOG, _LOADED
    if _LOG is not None:
        _LOG.close()
    _LOG = EventLog(run_dir=run_dir, ring=ring, process_index=process_index,
                    max_mb=max_mb, keep=keep)
    _LOADED = True
    return _LOG


def reset():
    """Close and forget the process log (re-reads env on next get())."""
    global _LOG, _LOADED
    if _LOG is not None:
        _LOG.close()
    _LOG = None
    _LOADED = False


def emit(etype: str, **fields):
    """Convenience: emit to the process log if obs is on; no-op (None)
    otherwise.  Swallows everything — emission sites include fault
    injectors and exit paths where a telemetry bug must not mask the
    real failure."""
    try:
        log = get()
        if log is None:
            return None
        return log.emit(etype, **fields)
    except Exception as e:  # pragma: no cover - defensive
        logger.warning("event emit failed: %s", e)
        return None
