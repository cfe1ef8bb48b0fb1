"""Typed, mergeable metrics registry (counterpart of
bigdl_tpu/obs/metrics.py, the same bucket bounds and snapshot wire
format: a snapshot from either package merges with one from the other).

The reference aggregated per-executor ``Metrics``/``TrainSummary``
accumulators at the job's master; the serving fleet (serve/cluster.py) needs
the production analogue: Prometheus-style process-wide instruments whose
snapshots MERGE EXACTLY across replicas and processes.  Three types:

- :class:`Counter` — monotonic; merges by sum (the engine/router
  accepted/shed/completed/failed counters).
- :class:`Gauge` — last-set value; merges by sum (queue depths,
  inflight) or max (high-water marks, weight versions) per its ``agg``.
- :class:`Histogram` — FIXED log-spaced bucket bounds, pinned at
  declaration (:data:`LATENCY_BUCKETS` spans 100 µs → ~560 s at ratio
  10^0.25 ≈ 1.78x).  Because every replica observes into the SAME
  bounds, merging is element-wise count addition and the merged
  quantiles are *identical* to the quantiles of one histogram that saw
  the pooled stream — the property that makes fleet p99 meaningful
  (``tests/test_obs_metrics.py`` pins it).

Series are keyed by (name, labels): ``registry.counter("serve_requests_total",
engine="local0", outcome="completed")``.  ``snapshot()`` renders the
whole registry to a plain-JSON dict (the wire format child replicas
ship over the frame protocol), :func:`merge` folds any number of
snapshots into one, :func:`render_prometheus` emits the text exposition
format and :func:`parse_prometheus` reads it back (CI asserts the
exposition parses).

The registry is process-wide (:func:`get`); :func:`reset` is for tests.
Instruments handed out before a reset keep working — the registry only
forgets them.
"""
from __future__ import annotations

import bisect
import json
import math
import re
import threading

#: pinned latency bucket UPPER bounds (seconds): 100 µs ... ~562 s at a
#: fixed 10^(1/4) ratio.  Histograms merge exactly only when every
#: observer uses identical bounds, so these are module constants, not
#: per-instance choices.  28 bounds -> 29 counts (underflow bucket
#: (0, 1e-4] is index 0's share below the first bound; index 28 is the
#: +Inf overflow).
LATENCY_BUCKETS = tuple(1e-4 * 10 ** (i / 4) for i in range(28))

#: pinned bucket bounds for streamed-decode INTER-TOKEN latency
#: (seconds): 1 µs ... ~5.6 s at the same 10^(1/4) ratio.  On-chip
#: inter-token gaps sit in the tens of microseconds — two decades below
#: LATENCY_BUCKETS' 100 µs floor, which would fold every healthy gap
#: into its underflow bucket and make ITL quantiles meaningless.  Same
#: merge contract: module-pinned bounds, so per-replica ITL histograms
#: add element-wise and fleet quantiles equal pooled quantiles exactly.
ITL_BUCKETS = tuple(1e-6 * 10 ** (i / 4) for i in range(28))

#: pinned bucket bounds for speculative-decode acceptance lengths
#: (serve/decode.py): integers 0..32, one bucket per exact length so the
#: merged histogram reconstructs the full distribution and the fleet
#: acceptance mean/quantiles are exact, not interpolated.  Pinned at
#: module scope for the same reason as LATENCY_BUCKETS — replicas can
#: only merge identical bounds.
SPEC_ACCEPT_BUCKETS = tuple(float(i) for i in range(33))


class Counter:
    """Monotonic counter.  ``inc`` only; merge = sum."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-set value.  ``agg`` ('sum' or 'max') names the cross-replica
    merge rule: queue depths add, high-water marks take the max."""

    __slots__ = ("_lock", "_value", "agg")

    def __init__(self, agg: str = "sum"):
        if agg not in ("sum", "max"):
            raise ValueError(f"gauge agg must be 'sum' or 'max': {agg!r}")
        self._lock = threading.Lock()
        self._value = 0.0
        self.agg = agg

    def set(self, v):
        with self._lock:
            self._value = float(v)

    def add(self, dv):
        with self._lock:
            self._value += dv

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bound bucket histogram.  ``bounds`` are UPPER bucket edges
    (ascending); counts has ``len(bounds) + 1`` slots, the last being
    the +Inf overflow.  Merge = element-wise count addition, legal only
    between identical bounds."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds=LATENCY_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError("histogram bounds must be ascending, non-empty")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def _index(self, v: float) -> int:
        # first bound >= v; len(bounds) means the +Inf overflow slot
        return bisect.bisect_left(self.bounds, v)

    def observe(self, v):
        self.observe_n(v, 1)

    def observe_n(self, v, n: int):
        """``n`` observations of ``v`` in one bucket update — the bulk
        path for device-accumulated counts (the speculative decoder
        fetches a per-length acceptance vector once per sync boundary,
        not one observation per window)."""
        if n <= 0:
            return
        v = float(v)
        i = self._index(v)
        with self._lock:
            self._counts[i] += n
            self._sum += v * n
            self._count += n

    def counts(self) -> list:
        with self._lock:
            return list(self._counts)

    def state(self):
        with self._lock:
            return list(self._counts), self._sum, self._count


class Registry:
    """Process-wide instrument registry.  Thread-safe; the same
    (name, labels) pair always resolves the same instrument, and a type
    or bounds conflict on a name is an error (a merge would be
    undefined)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}    # name -> {type, help, agg, bounds, series}
        #: bumped whenever series are dropped (clear/drop_series) —
        #: lets hot-path callers cache resolved instrument handles and
        #: re-resolve only when the registry may have forgotten them
        self.generation = 0

    @staticmethod
    def _label_key(labels: dict):
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def _family(self, name, mtype, help, agg=None, bounds=None):
        fam = self._families.get(name)
        if fam is None:
            fam = {"type": mtype, "help": help, "agg": agg,
                   "bounds": tuple(bounds) if bounds else None,
                   "series": {}}
            self._families[name] = fam
        else:
            if fam["type"] != mtype:
                raise ValueError(
                    f"metric {name!r} is a {fam['type']}, not a {mtype}")
            if mtype == "histogram" and fam["bounds"] != tuple(bounds):
                raise ValueError(
                    f"metric {name!r} re-declared with different bounds "
                    f"— merged quantiles would be undefined")
            if mtype == "gauge" and agg is not None and fam["agg"] != agg:
                raise ValueError(
                    f"metric {name!r} re-declared with agg={agg!r} "
                    f"(family is {fam['agg']!r}) — the cross-replica "
                    f"merge rule would be ambiguous")
        return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        with self._lock:
            fam = self._family(name, "counter", help)
            key = self._label_key(labels)
            inst = fam["series"].get(key)
            if inst is None:
                inst = fam["series"][key] = Counter()
            return inst

    def gauge(self, name: str, help: str = "", agg: str = "sum",
              **labels) -> Gauge:
        with self._lock:
            fam = self._family(name, "gauge", help, agg=agg)
            key = self._label_key(labels)
            inst = fam["series"].get(key)
            if inst is None:
                inst = fam["series"][key] = Gauge(agg=fam["agg"] or agg)
            return inst

    def histogram(self, name: str, help: str = "",
                  bounds=LATENCY_BUCKETS, **labels) -> Histogram:
        with self._lock:
            fam = self._family(name, "histogram", help, bounds=bounds)
            key = self._label_key(labels)
            inst = fam["series"].get(key)
            if inst is None:
                inst = fam["series"][key] = Histogram(bounds=fam["bounds"])
            return inst

    def snapshot(self) -> dict:
        """The whole registry as plain JSON (the frame-protocol wire
        format; also what :func:`merge` and the exporter consume)."""
        out = {}
        with self._lock:
            families = {n: (f, list(f["series"].items()))
                        for n, f in self._families.items()}
        for name, (fam, series) in families.items():
            rows = []
            for key, inst in series:
                row = {"labels": dict(key)}
                if fam["type"] == "histogram":
                    counts, s, n = inst.state()
                    row.update(counts=counts, sum=s, count=n)
                else:
                    row["value"] = inst.value
                rows.append(row)
            out[name] = {"type": fam["type"], "help": fam["help"],
                         "agg": fam["agg"],
                         "bounds": list(fam["bounds"]) if fam["bounds"]
                         else None,
                         "series": rows}
        return out

    def drop_series(self, **labels):
        """Remove every series whose labels contain ``labels`` (and any
        family left empty).  Teardown hook for short-lived instrument
        owners — e.g. each ``continuous_decode`` call's decoder — so
        the process registry does not grow without bound; dropping a
        live instrument just stops it being snapshotted."""
        want = {(str(k), str(v)) for k, v in labels.items()}
        with self._lock:
            for name in list(self._families):
                series = self._families[name]["series"]
                for key in [k for k in series if want <= set(k)]:
                    del series[key]
                if not series:
                    del self._families[name]
            self.generation += 1

    def clear(self):
        with self._lock:
            self._families.clear()
            self.generation += 1


# -- process-wide singleton -------------------------------------------------

_REGISTRY: Registry | None = None
_LOCK = threading.Lock()


def get() -> Registry:
    global _REGISTRY
    if _REGISTRY is None:
        with _LOCK:
            if _REGISTRY is None:
                _REGISTRY = Registry()
    return _REGISTRY


def reset():
    """Drop every family (tests).  Instruments already handed out keep
    counting; the registry just no longer snapshots them."""
    get().clear()


# -- merge / quantiles ------------------------------------------------------

def merge(snapshots, drop_labels=()) -> dict:
    """Fold N registry snapshots into one: counters and sum-gauges add,
    max-gauges take the max, histograms add counts element-wise
    (identical bounds required — a bounds mismatch raises, it cannot be
    papered over).  ``drop_labels`` removes labels (e.g. ``engine``)
    before merging, aggregating across their values."""
    out = {}
    for snap in snapshots:
        if not snap:
            continue
        for name, fam in snap.items():
            dst = out.get(name)
            if dst is None:
                dst = out[name] = {"type": fam["type"], "help": fam["help"],
                                   "agg": fam.get("agg"),
                                   "bounds": fam.get("bounds"),
                                   "series": {}}
            if dst["type"] != fam["type"]:
                raise ValueError(f"merge: {name!r} is both {dst['type']} "
                                 f"and {fam['type']}")
            if dst["type"] == "histogram" and \
                    list(dst["bounds"]) != list(fam["bounds"]):
                raise ValueError(
                    f"merge: {name!r} snapshots carry different bucket "
                    f"bounds — quantiles would be meaningless")
            for row in fam["series"]:
                labels = {k: v for k, v in row["labels"].items()
                          if k not in drop_labels}
                key = tuple(sorted(labels.items()))
                cur = dst["series"].get(key)
                if cur is None:
                    cur = dst["series"][key] = {"labels": labels}
                    if dst["type"] == "histogram":
                        cur.update(counts=[0] * len(row["counts"]),
                                   sum=0.0, count=0)
                    else:
                        cur["value"] = None
                if dst["type"] == "histogram":
                    cur["counts"] = [a + b for a, b in
                                     zip(cur["counts"], row["counts"])]
                    cur["sum"] += row["sum"]
                    cur["count"] += row["count"]
                elif cur["value"] is None:
                    cur["value"] = row["value"]
                elif dst["type"] == "gauge" and dst.get("agg") == "max":
                    cur["value"] = max(cur["value"], row["value"])
                else:
                    cur["value"] += row["value"]
    for fam in out.values():
        fam["series"] = list(fam["series"].values())
    return out


def quantile(bounds, counts, q) -> float | None:
    """The q-th percentile (0..100) from bucket counts.  Deterministic
    rank arithmetic on integer counts, so merged-histogram quantiles
    equal pooled-histogram quantiles EXACTLY (same bounds => counts
    add).  Linear interpolation inside the landing bucket; overflow
    clamps to the last finite bound."""
    total = sum(counts)
    if total == 0:
        return None
    rank = max(1, int(math.ceil(q / 100.0 * total)))
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (rank - cum) / c
            return lo + (hi - lo) * frac
        cum += c
    return bounds[-1]   # pragma: no cover - rank <= total always lands


def merged_histogram(snapshot: dict, name: str, **match):
    """Sum a histogram family's series (those whose labels contain
    ``match``) into one (bounds, counts, sum, count); None when the
    family is absent or empty."""
    fam = snapshot.get(name)
    if fam is None or fam["type"] != "histogram":
        return None
    bounds = list(fam["bounds"])
    counts, total_sum, total_n = None, 0.0, 0
    for row in fam["series"]:
        if any(row["labels"].get(k) != str(v) for k, v in match.items()):
            continue
        if counts is None:
            counts = [0] * len(row["counts"])
        counts = [a + b for a, b in zip(counts, row["counts"])]
        total_sum += row["sum"]
        total_n += row["count"]
    if counts is None:
        return None
    return bounds, counts, total_sum, total_n


def histogram_quantiles(snapshot: dict, name: str, qs=(50, 95, 99),
                        **match) -> dict:
    """p50/p95/p99-style dict for a histogram family, summed over its
    matching series (the fleet-pooled view)."""
    agg = merged_histogram(snapshot, name, **match)
    if agg is None:
        return {f"p{int(q)}": None for q in qs}
    bounds, counts, _, _ = agg
    return {f"p{int(q)}": quantile(bounds, counts, q) for q in qs}


def family_total(snapshot: dict, name: str, **match) -> float:
    """Sum of a counter/gauge family's series whose labels contain
    ``match`` (0.0 when absent)."""
    fam = snapshot.get(name)
    if fam is None or fam["type"] == "histogram":
        return 0.0
    total = 0.0
    for row in fam["series"]:
        if any(row["labels"].get(k) != str(v) for k, v in match.items()):
            continue
        total += row["value"]
    return total


# -- Prometheus text exposition ---------------------------------------------

def _fmt_value(v) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape_label(v) -> str:
    # exposition-format label escaping: backslash, quote, newline —
    # engine/router names are caller-supplied, so they cannot be
    # trusted to be exposition-clean
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict, extra=()) -> str:
    items = sorted(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + body + "}"


def render_prometheus(snapshot: dict) -> str:
    """Text exposition format (version 0.0.4): HELP/TYPE headers, one
    sample per line, histograms as cumulative ``_bucket`` series plus
    ``_sum``/``_count``."""
    lines = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        if fam.get("help"):
            help_text = (str(fam["help"]).replace("\\", "\\\\")
                         .replace("\n", "\\n"))
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for row in fam["series"]:
            labels = row["labels"]
            if fam["type"] == "histogram":
                cum = 0
                for bound, c in zip(list(fam["bounds"]) + [math.inf],
                                    row["counts"]):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, [('le', _fmt_value(bound))])}"
                        f" {cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(row['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{row['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} "
                             f"{_fmt_value(row['value'])}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    return re.sub(r'\\(["\\n])',
                  lambda m: {'"': '"', "\\": "\\", "n": "\n"}[m.group(1)],
                  v)


def parse_prometheus(text: str) -> list:
    """Parse an exposition back to ``(name, labels, value)`` samples;
    raises ValueError on any malformed sample line (the CI drill's
    round-trip check)."""
    samples = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line {lineno}: "
                             f"{line!r}")
        name, labelstr, value = m.groups()
        labels = {k: _unescape_label(v)
                  for k, v in _LABEL_RE.findall(labelstr)} \
            if labelstr else {}
        v = math.inf if value == "+Inf" else float(value)
        samples.append((name, labels, v))
    return samples


def append_snapshot_jsonl(path: str, snapshot: dict, ts: float = None):
    """Append one snapshot as a JSONL line (the exporter's file-based
    sibling of the /snapshot endpoint)."""
    import time
    rec = {"ts": time.time() if ts is None else ts, "snapshot": snapshot}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
