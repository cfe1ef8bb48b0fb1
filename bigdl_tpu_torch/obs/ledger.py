"""The cost ledger and memory accounting (counterpart of
bigdl_tpu/obs/ledger.py).

The JAX package reads each compiled executable's cost from XLA's cost
analysis at compile time.  PyTorch runs eagerly, so the port counts a
step's model flops once, on an eager run of it, with
``torch.utils.flop_counter.FlopCounterMode`` (the matrix products,
convolutions and attention calls it knows; the hand-written kernels'
element-wise and reduction work is not counted: model flops), and keys
the count by what the step is a
function of: the optimizer's capture key (``optim/local_optimizer.py``
``_capture_key``) or the decoder's step shape.  A step captured in a
CUDA graph is counted on its eager warm-up, never inside the capture.

- :class:`CostLedger` — the process-wide ledger: one entry a key, its
  flops published as a ``ledger_flops`` gauge (agg ``max``: the same key
  is the same program, so merging replica snapshots is idempotent) and a
  ``ledger`` obs event of kind ``exec``.
- Live utilization: the optimizer loops marry :meth:`CostLedger.flops_for`
  with their windowed step walls to publish ``train_mfu``; the continuous
  decoder publishes ``decode_model_flops_util`` once a sync boundary.
  The denominator is :func:`device_peak_flops`: NVIDIA cards only, no
  default — on the CPU, or on a card not in :data:`PEAK_FLOPS`, no MFU
  gauge is published.
- Static memory tenants: the known large allocations (the KV page pools)
  register their bytes with :func:`note_tenant`.
- :class:`DeviceMemorySampler` — a cadence thread over
  ``utils/profiler.device_memory_stats()`` (``BIGDL_OBS_HBM_SAMPLE``).

Master switch ``BIGDL_LEDGER=0`` disables the counting; everything here
is best-effort — a telemetry bug must never fail a step.
"""
from __future__ import annotations

import hashlib
import itertools
import logging
import math
import os
import threading
import time

import torch

logger = logging.getLogger("bigdl_tpu_torch.obs")

ENV_LEDGER = "BIGDL_LEDGER"
ENV_HBM_SAMPLE = "BIGDL_OBS_HBM_SAMPLE"

#: dense bf16 peak flops a card (the vendor's data sheet, without
#: sparsity) — the MFU denominator, one table for every reader.  The key
#: is the name ``torch.cuda.get_device_name`` gives.
PEAK_FLOPS = {
    # NVIDIA H100 SXM5 (80 GB HBM3), data sheet: 989 TFLOP/s dense bf16
    # at the 700 W power limit
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_peak_flops(device=None) -> float | None:
    """The data-sheet peak of ``device`` (default: the current card), or
    None on the CPU and on a card the table does not hold."""
    try:
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(dev)
    except Exception:
        return None
    return PEAK_FLOPS.get(name)


def enabled() -> bool:
    return os.environ.get(ENV_LEDGER, "1") != "0"


def _fn_label(fn_key) -> str:
    """The gauge's ``fn`` label: a tuple key's leading element
    (``train_step``, ``decode_step``, ...) or the key's string."""
    if isinstance(fn_key, tuple) and fn_key:
        return str(fn_key[0])
    return str(fn_key)


def _key_hash(key) -> str:
    return hashlib.md5(repr(key).encode()).hexdigest()[:8]


class LedgerEntry:
    """One step program's cost: its flops (``FlopCounterMode`` over an
    eager run); the bytes it moved are not counted (NaN), a field the JAX
    schema's ``ledger`` event requires."""

    __slots__ = ("fn_key", "key", "flops", "bytes_accessed", "source", "ts",
                 "seq")

    def __init__(self, fn_key, key, flops=float("nan"),
                 bytes_accessed=float("nan"), source="flop_counter", seq=0):
        self.fn_key = fn_key
        self.key = key
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        self.source = source
        self.ts = time.time()
        self.seq = seq

    def as_dict(self) -> dict:
        fk = repr(self.fn_key)
        if len(fk) > 120:
            fk = fk[:120] + "..."
        d = {"fn": _fn_label(self.fn_key), "fn_key": fk,
             "key": _key_hash(self.key), "flops": self.flops,
             "bytes_accessed": self.bytes_accessed, "source": self.source}
        return d


class CostLedger:
    """Process-wide cost ledger.  Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}        # key -> LedgerEntry (insertion-ordered)
        self._seq = itertools.count()
        self.captures = 0

    def _record(self, entry: LedgerEntry):
        with self._lock:
            if entry.key in self._entries:
                return self._entries[entry.key]
            entry.seq = next(self._seq)
            self._entries[entry.key] = entry
            self.captures += 1
        self._publish(entry)
        return entry

    def has(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def counted(self, fn_key, key, fn):
        """``fn()``'s result; on the first call for ``key`` it runs under
        ``FlopCounterMode`` and the count is ledgered as ``fn_key``'s.
        Later calls for the key run ``fn`` as it is.  A failure to
        ledger the count is logged, never raised; ``fn``'s own errors
        propagate."""
        if not enabled() or self.has(key):
            return fn()
        try:
            from torch.utils.flop_counter import FlopCounterMode
            counter = FlopCounterMode(display=False)
        except Exception as e:   # pragma: no cover - old torch
            logger.warning("ledger: no flop counter: %s", e)
            return fn()
        with counter:
            out = fn()
        try:
            self._record(LedgerEntry(fn_key, key,
                                     flops=counter.get_total_flops()))
        except Exception as e:   # pragma: no cover - defensive
            logger.warning("ledger capture failed for %r: %s", fn_key, e)
        return out

    def _publish(self, entry: LedgerEntry):
        try:
            from bigdl_tpu_torch.obs import metrics
            reg = metrics.get()
            lab = {"fn": _fn_label(entry.fn_key),
                   "key": _key_hash(entry.key)}
            if math.isfinite(entry.flops):
                reg.gauge("ledger_flops",
                          "per-step model flops of one step program "
                          "(FlopCounterMode over an eager run)",
                          agg="max", **lab).set(entry.flops)
            if math.isfinite(entry.bytes_accessed):
                reg.gauge("ledger_bytes_accessed",
                          "per-step device bytes accessed", agg="max",
                          **lab).set(entry.bytes_accessed)
        except Exception:   # pragma: no cover - obs layer mid-teardown
            pass
        try:
            from bigdl_tpu_torch.obs import events
            events.emit("ledger", kind="exec", **entry.as_dict())
        except Exception:   # pragma: no cover - defensive
            pass

    def newest(self, fn_key):
        """The most recently captured entry of ``fn_key`` (the steps
        re-key on a new shape; the newest is the one running)."""
        with self._lock:
            best = None
            for e in self._entries.values():
                if e.fn_key == fn_key and (best is None or e.seq > best.seq):
                    best = e
            return best

    def flops_for(self, fn_key) -> float | None:
        e = self.newest(fn_key)
        if e is None or not math.isfinite(e.flops) or e.flops <= 0:
            return None
        return e.flops

    def entries(self) -> list:
        with self._lock:
            return list(self._entries.values())

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "captures": self.captures}

    def clear(self):
        with self._lock:
            self._entries.clear()
            self.captures = 0


_LEDGER: CostLedger | None = None
_LOCK = threading.Lock()


def get() -> CostLedger:
    global _LEDGER
    if _LEDGER is None:
        with _LOCK:
            if _LEDGER is None:
                _LEDGER = CostLedger()
    return _LEDGER


def reset():
    """Drop every entry (tests) and stop an env-started sampler."""
    get().clear()
    stop_global_sampler()


def note_tenant(tenant: str, nbytes, **labels):
    """Register one known large allocation's current bytes (the KV page
    pools, scales included): an ``hbm_tenant_bytes`` gauge under the
    owner's labels (so its ``drop_series`` reclaims it) and a ``ledger``
    event of kind ``tenant``.  Never raises."""
    try:
        from bigdl_tpu_torch.obs import metrics
        metrics.get().gauge(
            "hbm_tenant_bytes", "bytes held by one named large allocation",
            tenant=tenant, **labels).set(float(nbytes))
    except Exception:   # pragma: no cover - obs layer unavailable
        pass
    try:
        from bigdl_tpu_torch.obs import events
        events.emit("ledger", kind="tenant", tenant=tenant,
                    bytes=int(nbytes), **labels)
    except Exception:   # pragma: no cover - defensive
        pass


def tree_nbytes(tree) -> int:
    """Total bytes of the tensors and arrays in a nested list / tuple /
    dict (tenant sizing).  An unsizable leaf counts 0; never raises."""
    import numpy as np

    stack, total = [tree], 0
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (str, bytes)) or x is None:
            continue
        else:
            try:
                a = np.asarray(x)
                if a.dtype != object:
                    total += int(a.nbytes)
            except Exception:
                continue
    return total


class DeviceMemorySampler:
    """Cadence thread over ``utils/profiler.device_memory_stats()``:
    ``hbm_bytes_in_use`` / ``hbm_bytes_limit`` / ``hbm_bytes_peak`` gauges
    a card (agg ``max``) and one ``ledger`` event of kind ``hbm`` a tick.
    ``close()`` sets the stop event and joins the thread."""

    def __init__(self, interval: float = 10.0, stats_fn=None,
                 registry=None, emit_events: bool = True):
        if stats_fn is None:
            from bigdl_tpu_torch.utils.profiler import device_memory_stats
            stats_fn = device_memory_stats
        self.interval = max(float(interval), 1e-3)
        self._stats_fn = stats_fn
        self._registry = registry
        self._emit_events = emit_events
        self._stop = threading.Event()
        self._thread = None
        self._peaks = {}
        self.samples = 0

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from bigdl_tpu_torch.obs import metrics
        return metrics.get()

    def sample_once(self) -> dict:
        try:
            raw = self._stats_fn() or {}
        except Exception as e:   # pragma: no cover - backend hiccup
            logger.warning("device memory sample failed: %s", e)
            return {}
        seen = {}
        for dev, st in raw.items():
            if not st or st.get("bytes_in_use") is None:
                continue
            in_use = int(st["bytes_in_use"])
            peak = max(int(st.get("peak_bytes_in_use", 0)), in_use,
                       self._peaks.get(dev, 0))
            self._peaks[dev] = peak
            seen[dev] = {"in_use": in_use, "peak": peak}
            if st.get("bytes_limit") is not None:
                seen[dev]["limit"] = int(st["bytes_limit"])
        if not seen:
            return {}
        self.samples += 1
        try:
            reg = self._reg()
            for dev, row in seen.items():
                reg.gauge("hbm_bytes_in_use", "device memory in use",
                          agg="max", device=dev).set(row["in_use"])
                reg.gauge("hbm_bytes_peak", "device memory watermark",
                          agg="max", device=dev).set(row["peak"])
                if "limit" in row:
                    reg.gauge("hbm_bytes_limit", "device memory capacity",
                              agg="max", device=dev).set(row["limit"])
        except Exception:   # pragma: no cover - obs layer mid-teardown
            pass
        if self._emit_events:
            try:
                from bigdl_tpu_torch.obs import events
                events.emit(
                    "ledger", kind="hbm",
                    in_use=sum(r["in_use"] for r in seen.values()),
                    peak=sum(r["peak"] for r in seen.values()),
                    limit=sum(r.get("limit", 0) for r in seen.values()),
                    devices=seen)
            except Exception:   # pragma: no cover - defensive
                pass
        return seen

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample_once()

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="bigdl-hbm-sampler")
            self._thread.start()
        return self

    def close(self, timeout: float = 10.0):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


_GLOBAL_SAMPLER: DeviceMemorySampler | None = None


def maybe_start_sampler_from_env() -> DeviceMemorySampler | None:
    """Start (once) the process-wide sampler when
    ``BIGDL_OBS_HBM_SAMPLE=<seconds>`` is set (a run's start calls it)."""
    global _GLOBAL_SAMPLER
    raw = os.environ.get(ENV_HBM_SAMPLE, "").strip()
    if not raw:
        return None
    try:
        interval = float(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r", ENV_HBM_SAMPLE, raw)
        return None
    if interval <= 0:
        return None
    with _LOCK:
        if _GLOBAL_SAMPLER is None:
            _GLOBAL_SAMPLER = DeviceMemorySampler(interval=interval).start()
    return _GLOBAL_SAMPLER


def stop_global_sampler():
    global _GLOBAL_SAMPLER
    s = _GLOBAL_SAMPLER
    _GLOBAL_SAMPLER = None
    if s is not None:
        s.close()
