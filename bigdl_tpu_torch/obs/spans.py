"""Nested wall-clock spans around the training loop's phases (counterpart
of bigdl_tpu/obs/spans.py).

The reference's Metrics.scala names flat counters ("computing time
average", "get weights average"); spans keep that — every span IS a
``optim.Metrics`` entry named ``span: <path>`` — and add three things:

- nesting: ``span("dispatch")`` inside ``span("epoch")`` records the
  path ``epoch/dispatch``, so the report reads as a tree;
- device-trace visibility: each span body runs under
  ``utils/profiler.annotation`` (``torch.profiler.record_function``, and
  an NVTX range on the card), so the same phase names line up in every
  trace the profiler takes;
- a cross-process breakdown with the deadlock-safe pattern Metrics
  already has: the TOP-LEVEL phase names are declared as distributed
  entries on EVERY rank at construction (``Metrics.declare``), so the
  epoch-end ``collect_per_node`` gather walks the identical name list on
  every rank even when a phase only ran on rank 0 (checkpoint writes),
  and rank 0 can render the per-rank table afterwards from the cache
  alone.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

#: top-level phases every optimizer declares — the fixed, every-process
#: name set that keeps the per-node allgather deadlock-free.  ``h2d``
#: is the host→device batch transfer (inline, or credited from the
#: prefetch transfer thread via :meth:`SpanTracker.record`); ``host-wait``
#: is the cadence-boundary device→host sync the loops pay instead of a
#: per-step ``float(loss)``.
PHASES = ("data-load", "h2d", "dispatch", "host-wait", "aggregate",
          "validate", "checkpoint")

_PREFIX = "span: "


class SpanTracker:
    def __init__(self, metrics, phases=PHASES):
        self.metrics = metrics
        self.phases = tuple(phases)
        self._stack: list = []
        self._paths: list = []   # insertion-ordered distinct span paths
        for name in self.phases:
            metrics.declare(_PREFIX + name, distributed=True)

    @contextmanager
    def span(self, name: str):
        """Time a phase; nested calls build slash paths.  Top-level
        phases from ``PHASES`` feed the distributed per-host breakdown;
        ad-hoc/nested names stay process-local."""
        from bigdl_tpu_torch.utils.profiler import annotation
        path = "/".join([s for s in self._stack] + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            with annotation(name):
                yield
        finally:
            self._stack.pop()
            dt = time.perf_counter() - t0
            if path not in self._paths:
                self._paths.append(path)
            self.metrics.add(_PREFIX + path, dt,
                             distributed=(path in self.phases))

    def record(self, name: str, seconds: float, count: int = 1):
        """Credit an externally-timed interval to a span — work measured
        on a background thread (the prefetch pipeline's H2D transfers)
        whose timing the main thread drains and books here.  ``count=0``
        adds seconds to an interval already counted once (accumulating a
        phase across drains without inflating its sample count)."""
        if seconds <= 0 and count <= 0:
            return
        if name not in self._paths:
            self._paths.append(name)
        self.metrics.accumulate(_PREFIX + name, seconds, count=count,
                                distributed=(name in self.phases))

    # -- rendering ---------------------------------------------------------
    def rows(self):
        """(path, depth, mean_s, total_s, count) per span, tree order."""
        out = []
        for path in sorted(self._paths):
            total, count = self.metrics.get(_PREFIX + path)
            out.append((path, path.count("/"), self.metrics.mean(
                _PREFIX + path), total, count))
        return out

    def report(self, unit: str = "s") -> str:
        """Process-local span tree (mean/total/count per phase)."""
        lines = [f"{'span':<32} {'mean_' + unit:>10} {'total_' + unit:>10} "
                 f"{'count':>7}"]
        for path, depth, mean, total, count in self.rows():
            label = "  " * depth + path.rsplit("/", 1)[-1]
            lines.append(f"{label:<32} {mean:>10.4f} {total:>10.4f} "
                         f"{count:>7d}")
        return "\n".join(lines)

    def per_host_report(self) -> str:
        """Per-process mean seconds for each top-level phase.

        CONTRACT: multi-process callers must have run
        ``metrics.collect_per_node()`` (a collective every process joins,
        e.g. the end of ``DistriOptimizer.optimize``) first — this method
        then reads the cached snapshot and is safe from process 0 alone.
        """
        rows = [(name, self.metrics.per_node(_PREFIX + name))
                for name in self.phases]
        n_hosts = max(len(vals) for _, vals in rows)
        header = f"{'phase':<14}" + "".join(
            f"{'host' + str(i):>12}" for i in range(n_hosts))
        lines = [header]
        for name, vals in rows:
            lines.append(f"{name:<14}" + "".join(
                f"{v:>12.4f}" for v in vals))
        return "\n".join(lines)

    def emit_phase_events(self, events_log, step: int):
        """One ``phase`` event per span path (cumulative mean + count),
        emitted at epoch boundaries and run end."""
        if events_log is None:
            return
        for path, _, mean, total, count in self.rows():
            if count:
                events_log.emit("phase", name=path, seconds=mean,
                                total=total, count=count, step=int(step))
