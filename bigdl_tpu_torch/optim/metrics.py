"""Host phase timers (counterpart of bigdl_tpu/optim/metrics.py; ref
optim/Metrics.scala:25): named sums and counts of seconds, one process.
The per-node gathers of the JAX module come with the distributed slice.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Metrics:
    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)

    def add(self, name: str, value: float):
        self._sums[name] += value
        self._counts[name] += 1

    def get(self, name: str):
        return self._sums[name], self._counts[name]

    def mean(self, name: str) -> float:
        return self._sums[name] / max(self._counts[name], 1)

    @contextmanager
    def timer(self, name: str):
        # a body that raises still records its elapsed time
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def summary(self, unit_scale: float = 1.0) -> str:
        """(ref Metrics.summary) one line per metric, averaged."""
        lines = ["========== Metrics Summary =========="]
        for name in sorted(self._sums):
            lines.append(f"{name} : {self.mean(name) * unit_scale}")
        lines.append("=====================================")
        return "\n".join(lines)
