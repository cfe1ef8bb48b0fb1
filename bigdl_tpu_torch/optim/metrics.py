"""Phase metrics (counterpart of bigdl_tpu/optim/metrics.py :19-144; ref
optim/Metrics.scala:25).

Named sums and counts of host seconds for the phase breakdown of an
iteration ("data fetch time", "computing time average", "aggregate
gradient time": DistriOptimizer.scala:114-118).  The reference keeps
local, aggregate and distributed entries, the last one value a node
through Spark accumulators; here an entry marked ``distributed`` gathers
one mean a rank on demand, in one all-gather of every such entry over
the process group (``collect_per_node``).
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch.distributed as dist


def _world(group) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(getattr(group, "group", group))


class Metrics:
    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)
        self._distributed = set()
        self._per_node_cache = {}

    def set(self, name: str, value: float, distributed: bool = False):
        self._sums[name] = value
        self._counts[name] = 1
        if distributed:
            self._distributed.add(name)

    def add(self, name: str, value: float, distributed: bool = False):
        self._sums[name] += value
        self._counts[name] += 1
        if distributed:
            self._distributed.add(name)

    def accumulate(self, name: str, value: float, count: int = 1,
                   distributed: bool = False):
        """``add`` with an explicit sample count: intervals timed on a
        background thread and booked in lumps (``count=0`` adds seconds
        to samples already counted, so the mean stays right)."""
        self._sums[name] += value
        self._counts[name] += count
        if distributed:
            self._distributed.add(name)

    def get(self, name: str):
        return self._sums[name], self._counts[name]

    def mean(self, name: str) -> float:
        return self._sums[name] / max(self._counts[name], 1)

    def declare(self, name: str, distributed: bool = True):
        """An entry with no samples yet (sum 0, count 0), so that every
        rank gathers the same set of names even where only some ranks
        record one (rank 0 alone writes checkpoints)."""
        self._sums[name] += 0.0
        self._counts[name] += 0
        if distributed:
            self._distributed.add(name)
        return self

    def per_node(self, name: str, group=None) -> list:
        """One mean a rank (the reference's per-node accumulator).  With
        more than one rank and no snapshot from :meth:`collect_per_node`
        this is a collective: every rank must call it together."""
        if _world(group) == 1:
            return [self.mean(name)]
        if name in self._per_node_cache:
            return list(self._per_node_cache[name])
        return self._gather([name], group)[name]

    def collect_per_node(self, group=None):
        """Gather every distributed entry's mean from every rank in one
        all-gather (a collective: every rank calls it at the same point);
        later ``per_node`` and ``summary(per_node=True)`` read the
        snapshot."""
        if _world(group) > 1:
            self._per_node_cache = self._gather(sorted(self._distributed),
                                                group)
        return self

    def _gather(self, names, group) -> dict:
        g = getattr(group, "group", group)
        out = [None] * _world(group)
        dist.all_gather_object(out, {n: self.mean(n) for n in names},
                               group=g)
        return {n: [float(d.get(n, 0.0)) for d in out] for n in names}

    @contextmanager
    def timer(self, name: str, distributed: bool = False):
        # a body that raises still records its elapsed time
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, distributed=distributed)

    def summary(self, unit_scale: float = 1.0, per_node: bool = False,
                group=None) -> str:
        """(ref Metrics.summary) one line a metric, averaged;
        ``per_node=True`` adds each rank's mean of the distributed entries
        (a collective unless :meth:`collect_per_node` ran)."""
        lines = ["========== Metrics Summary =========="]
        for name in sorted(self._sums):
            lines.append(f"{name} : {self.mean(name) * unit_scale}")
            if per_node and name in self._distributed:
                nodes = self.per_node(name, group)
                if len(nodes) > 1:
                    per = ", ".join(f"{v * unit_scale:.6g}" for v in nodes)
                    lines.append(f"  per node : [{per}]")
        lines.append("=====================================")
        return "\n".join(lines)

    def reset(self):
        self._sums.clear()
        self._counts.clear()
        self._distributed.clear()
        self._per_node_cache.clear()
