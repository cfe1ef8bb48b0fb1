"""Straggler mitigation (counterpart of bigdl_tpu/optim/straggler.py
:52-202; ref optim/DistriOptimizer.scala:154-172 timeout drop, :245-278
threshold; knobs from Optimizer.setDropMoudleProperty, Optimizer.scala:
116-124).  The port keeps its own copy of the JAX package's host logic:
``StragglerPolicy`` works on numpy arrays only, and so does its
``kth_largest`` (ref utils/Util.kthLargest, Util.scala:21).

The reference cancels in-flight gradient tasks that exceed a timeout
(``invokeAndWait2``), zeroes their gradients, and divides the gradient
sum by the number of tasks that finished.  A collective in flight cannot
be cancelled, so the bulk-synchronous design masks instead of cancels:
each rank is one "task"; a rank whose measured time exceeded the
threshold on the PREVIOUS iteration is masked out of the CURRENT
iteration's aggregation — ``grads = sum(w_i * g_i) / sum(w)`` — which is
exactly the reference's ``gradientPartition.div(finishedModelNum)`` math
(DistriOptimizer.scala:231-234), one iteration later.  Everything else
mirrors the reference line for line:

- the threshold is recomputed every ``compute_threshold_batch_size``
  accepted iterations after ``warmup_iteration``, as the k-th largest of
  the window's per-task times with ``k = drop_percentage * window *
  n_tasks``, discounted by the tasks already dropped in the window
  (Util.kthLargest, DistriOptimizer.scala:250-262);
- when the window already dropped >= k, the threshold relaxes by 1%
  (``threshold * 1.01``, :259);
- masked tasks contribute a zero time slot to the window, like the
  reference's cancelled tasks whose ``moduleTimeList`` slot stays 0;
- an iteration whose surviving-task count would fall below
  ``n * (1 - max_drop_percentage)`` is REJECTED: no update, no ``neval``
  advance, the batch is consumed (DistriOptimizer.scala:224 guard).  On
  rejection the policy forgets its last measurements so the next
  iteration runs unmasked and re-measures every task.

Timing source: per-task (= per-rank) seconds, gathered from every rank
so that every rank holds the same policy state (``DistriOptimizer``);
tests inject synthetic schedules via ``time_source``.
"""
from __future__ import annotations

import logging
import math

import numpy as np

logger = logging.getLogger("bigdl_tpu_torch.optim")


def kth_largest(values, k: int) -> float:
    """The k-th largest element (1-based k) of ``values`` (ref
    utils/Util.kthLargest, Util.scala:21)."""
    arr = np.asarray(values).reshape(-1)
    return float(np.partition(arr, len(arr) - k)[len(arr) - k])


class StragglerPolicy:
    """Host-side mask/threshold state for straggler dropping.

    Parameters mirror ``Optimizer.setDropMoudleProperty`` (ref
    Optimizer.scala:116-124, defaults :48-51): ``drop_percentage`` <=
    ``max_drop_percentage``, window ``compute_threshold_batch_size``
    (ref computeThresholdbatchSize, default 100), ``warmup_iteration``
    (default 200).
    """

    def __init__(self, n_tasks: int, drop_percentage: float,
                 max_drop_percentage: float,
                 compute_threshold_batch_size: int = 100,
                 warmup_iteration: int = 200,
                 time_source=None):
        if not (0.0 <= drop_percentage <= max_drop_percentage <= 1.0):
            raise ValueError(
                "need 0 <= drop_percentage <= max_drop_percentage <= 1 "
                f"(ref Optimizer.scala:120), got {drop_percentage}, "
                f"{max_drop_percentage}")
        if n_tasks < 1 or compute_threshold_batch_size < 1:
            raise ValueError("n_tasks and compute_threshold_batch_size "
                             "must be >= 1")
        self.n_tasks = int(n_tasks)
        self.drop_percentage = float(drop_percentage)
        self.max_drop_percentage = float(max_drop_percentage)
        self.batch_size = int(compute_threshold_batch_size)
        self.warmup = int(warmup_iteration)
        self.time_source = time_source
        if self.drop_percentage > 0 and self._k_per_window() == 0:
            # k rounds to 0 every window -> the threshold stays inf and
            # dropping can never engage; tell the user at configuration
            # time instead of silently doing nothing
            logger.warning(
                "straggler dropping cannot arm: drop_percentage (%g) * "
                "compute_threshold_batch_size (%d) * n_tasks (%d) rounds "
                "to 0 slow slots per window; raise drop_percentage or "
                "the window size", self.drop_percentage, self.batch_size,
                self.n_tasks)
        # ref: threshold starts at Long.MaxValue (Util.kthLargest k=0)
        self.threshold = math.inf
        self.iteration = 0          # accepted iterations, ref `iteration`
        self._window: list[float] = []   # ref moduleTimeList (flattened)
        self._dropped_in_window = 0      # ref dropModelNumBatch
        self._last_times: np.ndarray | None = None

    def _k_per_window(self) -> int:
        """Slow slots per threshold window (ref DistriOptimizer.scala:
        250: ``dropPercentage * computeThresholdbatchSize * n``) — the
        ONE k formula shared by the threshold update and the cannot-arm
        configuration check."""
        return int(self.drop_percentage * self.batch_size * self.n_tasks)

    # ------------------------------------------------------------- mask
    @property
    def armed(self) -> bool:
        """Dropping engages only after warmup + one full threshold window
        (ref DistriOptimizer.scala:154: ``iteration > warmupIterationNum
        + computeThresholdbatchSize - 1``)."""
        return (self.drop_percentage > 0
                and self.iteration > self.warmup + self.batch_size - 1)

    def mask(self) -> np.ndarray:
        """(n_tasks,) float32 of 0/1 — 1 keeps the task's gradient.

        A task is dropped only when it is over the threshold AND slower
        than the fastest cohort: the threshold is a quantile over TIME,
        so a uniformly slow iteration (GC pause, relay hiccup — every
        task's wall identical) would otherwise mask ALL tasks and
        spuriously reject the iteration.  A straggler is slow RELATIVE
        to its peers (the reference's timeout fires while other tasks
        finish); uniform slowness has no straggler to drop."""
        if (not self.armed or self._last_times is None
                or not math.isfinite(self.threshold)):
            return np.ones(self.n_tasks, np.float32)
        t = self._last_times
        return ((t <= self.threshold) | (t <= t.min())).astype(np.float32)

    def accepts(self, mask: np.ndarray) -> bool:
        """Ref DistriOptimizer.scala:224: the update runs only when
        ``finishedModelNum >= n * (1 - maxDropPercentage)`` — plus a
        floor of one finished task, or the masked mean would divide by
        zero (the reference would divide lossSum by finishedModelNum=0
        here too; we reject instead of NaN-ing the params)."""
        s = float(mask.sum())
        return s >= max(self.n_tasks * (1.0 - self.max_drop_percentage),
                        1.0)

    # ------------------------------------------------------- accounting
    def reject(self, mask: np.ndarray):
        """Iteration rejected (too many stragglers): count the drops
        (ref :223 ``dropModelNumBatch +=``), forget the stale
        measurements so the next iteration runs unmasked, advance
        nothing."""
        self._dropped_in_window += int(self.n_tasks - mask.sum())
        self._last_times = None
        logger.warning(
            "straggler drop REJECTED iteration: %d/%d tasks under "
            "threshold %.4gs < required %.1f (maxDropPercentage=%s); "
            "batch consumed, no update (ref DistriOptimizer.scala:224)",
            int(mask.sum()), self.n_tasks, self.threshold,
            self.n_tasks * (1 - self.max_drop_percentage),
            self.max_drop_percentage)

    def record(self, times, mask: np.ndarray):
        """After an ACCEPTED iteration: store per-task seconds for the
        next mask, append the window slots (masked tasks contribute 0
        like the reference's cancelled tasks), and recompute the
        threshold at window boundaries (ref DistriOptimizer.scala:
        245-278)."""
        times = np.asarray(times, np.float64).reshape(-1)
        if times.shape != (self.n_tasks,):
            raise ValueError(
                f"need {self.n_tasks} per-task times, got {times.shape}")
        self._last_times = times
        self._window.extend(np.where(mask > 0, times, 0.0).tolist())
        # ref moduleTimeList is a FIXED array of batchSize*n slots written
        # circularly (index ``(iteration % computeThresholdbatchSize) *
        # _subModelNumber``) — before warmup ends it only ever holds the
        # most recent window, so trim to one window here too
        cap = self.batch_size * self.n_tasks
        if len(self._window) > cap:
            del self._window[:len(self._window) - cap]
        self._dropped_in_window += int(self.n_tasks - mask.sum())
        self.iteration += 1
        if (self.drop_percentage > 0 and self.iteration > self.warmup
                and self.iteration % self.batch_size == 0):
            k = self._k_per_window()
            if k > self._dropped_in_window:
                self.threshold = kth_largest(
                    np.asarray(self._window),
                    k - self._dropped_in_window)
            else:
                # window already dropped its share: relax 1% (ref :259)
                self.threshold = self.threshold * 1.01
            logger.info("straggler threshold: %.6gs", self.threshold)
            self._window.clear()
            self._dropped_in_window = 0

    # ---------------------------------------------------------- timing
    def task_times(self, local_wall: float) -> np.ndarray:
        """Per-task seconds for this iteration as this rank sees them.
        ``time_source`` (tests / custom instrumentation) wins; else every
        task reads ``local_wall`` (one rank alone sees no skew).  The
        ``DistriOptimizer`` merges the ranks' views."""
        if self.time_source is not None:
            return np.asarray(self.time_source(local_wall),
                              np.float64).reshape(-1)
        return np.full(self.n_tasks, float(local_wall), np.float64)
