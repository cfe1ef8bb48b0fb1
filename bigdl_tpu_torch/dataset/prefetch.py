"""Background input pipeline of the training loop (counterpart of
bigdl_tpu/dataset/prefetch.py).

- :class:`PipelineRunner` runs the dataset's transformer chain on ONE
  producer thread that feeds a bounded queue.  The producer owns the
  dataset's random stream (``RNG.own_stream``) while it runs, so the
  shuffles, crops and flips draw the values the serial loop would, in its
  order: the losses are bit-identical with prefetch on or off.  Pure
  per-record stages (``Transformer.pure_per_record``) may fan out, in
  order, to ``BIGDL_PREFETCH_WORKERS`` worker threads; stochastic stages
  stay on the producer.
- The epoch rollover moves with the draws: the producer mirrors the
  loop's arithmetic (count and reset at one iteration a dispatch, count
  and subtract at n) and calls ``dataset.shuffle()`` and rebuilds its
  iterator itself, at the point of the stream where the serial loop
  does.  The loop only advances its counters.
- On the card, a transfer thread copies each batch to the device on a
  side CUDA stream, from a ring of pinned host buffers allocated once
  (pinning a fresh buffer for every batch is slow), and records an event
  that the consuming step waits on; the batch's device tensors are
  ``record_stream``-ed onto the consuming stream, so that the caching
  allocator does not hand their memory back to the side stream before the
  step that reads them has run.
- Checkpoints: every item carries the stream's state taken right after
  its draws, and the dataset's shuffled order (``order``) as of then.
  :meth:`PipelineRunner.rng_snapshot` is that of the last CONSUMED item,
  beside the live generators of the dropout masks (drawn at consume
  time, on the loop's thread), so a resume replays the batches the run
  consumed, not the ones it had merely prefetched;
  :meth:`PipelineRunner.close` leaves the stream and the order in that
  state.

Switches: ``BIGDL_PREFETCH`` (default off: on the card the producer
thread slowed every measured cell, as it contends with the loop's own
dispatch for the interpreter lock; ``1`` turns it on, ``N >= 2`` sets
the queue depth) and ``BIGDL_PREFETCH_WORKERS`` (the pure stages'
workers, default 0).
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from bigdl_tpu_torch.utils.random import RNG

logger = logging.getLogger("bigdl_tpu_torch.dataset")

ENV_PREFETCH = "BIGDL_PREFETCH"
ENV_WORKERS = "BIGDL_PREFETCH_WORKERS"
DEFAULT_DEPTH = 2


def enabled() -> bool:
    """``BIGDL_PREFETCH`` (default off)."""
    return os.environ.get(ENV_PREFETCH, "0").strip() != "0"


def depth() -> int:
    """The queue depth of each stage: ``BIGDL_PREFETCH=N`` with N >= 2,
    else two."""
    try:
        n = int(os.environ.get(ENV_PREFETCH, "").strip())
    except ValueError:
        return DEFAULT_DEPTH
    return n if n >= 2 else DEFAULT_DEPTH


def workers() -> int:
    try:
        return max(0, int(os.environ.get(ENV_WORKERS, "0")))
    except ValueError:
        return 0


def stack_chunk(batches):
    """n MiniBatches of one shape stacked into (n, B, ...) host arrays,
    each batch converted once."""
    xs = [np.asarray(b.data) for b in batches]
    ys = [np.asarray(b.labels) for b in batches]
    shapes = {(a.shape, b.shape) for a, b in zip(xs, ys)}
    if len(shapes) != 1:
        raise ValueError(f"iterations_per_dispatch needs uniform batch "
                         f"shapes within a chunk, got {shapes}")
    return np.stack(xs), np.stack(ys)


def background(iterator, depth: int = DEFAULT_DEPTH):
    """Plain bounded prefetch of an iterator on a background thread (no
    stream ownership, no epochs): what validation batches ride."""
    from bigdl_tpu_torch.dataset.transformer import PreFetch
    return PreFetch(depth)(iterator)


def decompose(dataset):
    """(root dataset, [stages in order]) of a ``TransformedDataSet``
    chain."""
    from bigdl_tpu_torch.dataset.dataset import TransformedDataSet
    from bigdl_tpu_torch.dataset.transformer import stages

    out = []
    while isinstance(dataset, TransformedDataSet):
        out = stages(dataset.transformer) + out
        dataset = dataset.base
    return dataset, out


def has_stochastic_stage(dataset) -> bool:
    """Whether the dataset's chain draws random numbers; ``validate``
    keeps such a chain on the calling thread."""
    return any(getattr(s, "stochastic", False) for s in decompose(dataset)[1])


def host_snapshot(dataset, np_state=None, order=None) -> dict:
    """The checkpoint's random payload for a run on ``dataset``: the
    package's generators (``RNG.snapshot``), the dataset's stream
    (``np_state``) and its shuffled order (``data_order``), the live ones
    unless given."""
    root = decompose(dataset)[0]
    snap = RNG.snapshot()
    stream = getattr(dataset, "rng", None)
    if np_state is None and stream is not None:
        np_state = stream.get_state()
    if np_state is not None:
        snap["np_state"] = np_state
    if order is None and getattr(root, "order", None) is not None:
        order = root.order.copy()
    if order is not None:
        snap["data_order"] = order
    return snap


def host_restore(snap: dict, dataset):
    """Put a payload of :func:`host_snapshot` (or the JAX package's) back:
    the generators, and ``dataset``'s stream and order."""
    RNG.restore(snap, getattr(dataset, "rng", None))
    root = decompose(dataset)[0]
    if snap.get("data_order") is not None and \
            getattr(root, "order", None) is not None:
        root.order[:] = snap["data_order"]


def _is_pure_map(stage) -> bool:
    return bool(getattr(stage, "pure_per_record", False)) and \
        not bool(getattr(stage, "stochastic", False))


class Item:
    """One produced batch (or chunk): host arrays, device tensors and the
    event they are ready at once transferred, the stream's state and the
    records' order after its draws, its place in the stream (``seq``) and
    the output queue's depth when it was taken."""

    __slots__ = ("x", "y", "device", "event", "np_state", "order", "seq",
                 "queue_depth")

    def __init__(self, x, y, np_state=None, order=None, seq=0):
        self.x = x
        self.y = y
        self.device = None
        self.event = None
        self.np_state = np_state
        self.order = order
        self.seq = seq
        self.queue_depth = 0


class _End:
    pass


class _Error:
    # a private wrapper, so that a record which is an exception object is
    # never taken for a failure
    def __init__(self, exc):
        self.exc = exc


class PinnedRing:
    """``slots`` sets of pinned host buffers, allocated once for each
    array's shape and dtype and reused in turn; a slot is written again
    only after the copy that last read it has completed."""

    def __init__(self, slots: int):
        self._bufs = [[] for _ in range(slots)]
        self._events = [None] * slots
        self._k = 0

    def stage(self, arrays):
        """Copy ``arrays`` into the next slot: (its pinned tensors, the
        slot's index)."""
        k = self._k
        self._k = (k + 1) % len(self._bufs)
        if self._events[k] is not None:
            self._events[k].synchronize()
        bufs = self._bufs[k]
        for i, a in enumerate(arrays):
            a = np.ascontiguousarray(a)
            want = torch.from_numpy(a[:0]).dtype
            if (i == len(bufs) or tuple(bufs[i].shape) != a.shape
                    or bufs[i].dtype != want):
                buf = torch.empty(a.shape, dtype=want, pin_memory=True)
                bufs[i:i + 1] = [buf]
            bufs[i].numpy()[...] = a
        return bufs[:len(arrays)], k

    def mark(self, k, event):
        """The copies out of slot ``k`` complete at ``event``."""
        self._events[k] = event


class PipelineRunner:
    """The bounded background pipeline over one dataset.

    ``chunk > 1`` stacks (n, B, ...) chunks for n iterations a dispatch;
    ``epoch_size`` turns on the producer-side epoch rollover (training);
    ``device``, a CUDA device, turns on the transfer stage."""

    def __init__(self, dataset, *, train: bool = True, chunk: int = 1,
                 epoch_size: int | None = None, depth: int | None = None,
                 device=None, n_workers: int | None = None):
        self._dataset = dataset
        self._train = train
        self._chunk = max(1, int(chunk))
        self._epoch_size = int(epoch_size) if epoch_size else None
        self.depth = int(depth) if depth else globals()["depth"]()
        self._n_workers = workers() if n_workers is None else int(n_workers)
        self._device = None if device is None else torch.device(device)
        if self._device is not None and self._device.type != "cuda":
            self._device = None   # on the CPU the host arrays are the batch
        #: the dataset's random stream, owned by the producer while it
        #: runs, and the shuffled order of its records
        self._stream = getattr(dataset, "rng", None) if train else None
        self._order = (getattr(decompose(dataset)[0], "order", None)
                       if train else None)
        self._host_q = queue.Queue(maxsize=self.depth)
        self._out_q = (self._host_q if self._device is None
                       else queue.Queue(maxsize=self.depth))
        self._stop = threading.Event()
        self._pause = threading.Event()
        # held by the producer over one whole draw (chain and rollover);
        # pause() takes it to wait out a draw in flight
        self._work_lock = threading.Lock()
        self._closed = False
        self._count = 0
        # the threads' walls, drained by the consuming loop into its spans
        # (``take_fetch``: the producer's draws, ``take_h2d``: the copies)
        self._stats_lock = threading.Lock()
        self._fetch_seconds, self._fetch_count = 0.0, 0
        self._h2d_seconds, self._h2d_count = 0.0, 0
        self.stall_seconds = 0.0
        self.consumed = 0
        self._pool = None
        self._split = None
        if self._train and self._n_workers > 0:
            self._plan_fanout()
        self._start_np = (self._stream.get_state()
                          if self._stream is not None else None)
        self._last_np = None
        self._start_order = self._order_now = (
            self._order.copy() if self._order is not None else None)
        self._last_order = None
        self._producer = threading.Thread(target=self._produce, daemon=True,
                                          name="bigdl-prefetch-producer")
        self._transfer = None
        if self._device is not None:
            self._ring = PinnedRing(self.depth + 2)
            self._side = torch.cuda.Stream(self._device)
            self._transfer = threading.Thread(
                target=self._transfer_loop, daemon=True,
                name="bigdl-prefetch-h2d")
        self._producer.start()
        if self._transfer is not None:
            self._transfer.start()

    # -- producer ----------------------------------------------------------
    def _plan_fanout(self):
        from bigdl_tpu_torch.dataset.dataset import LocalArrayDataSet

        base, stages = decompose(self._dataset)
        i = 0
        while i < len(stages) and _is_pure_map(stages[i]):
            i += 1
        # the looped iterator draws a permutation as each pass over the
        # records starts; only a list-backed dataset has a known pass
        # length, which the fan-out window must not read across
        if i and isinstance(base, LocalArrayDataSet):
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self._n_workers,
                thread_name_prefix="bigdl-prefetch-worker")
            self._cycle = base.size()
            self._split = (base, stages[:i], stages[i:])
        elif i:
            logger.info("prefetch worker fan-out off: %s has no known pass "
                        "length", type(base).__name__)

    def _make_iter(self):
        if self._split is None:
            return self._dataset.data(train=self._train)
        base, prefix, rest = self._split
        it = self._parallel_map(base.data(train=self._train), prefix)
        for stage in rest:
            it = stage(it)
        return it

    def _parallel_map(self, records, prefix):
        """The pure prefix on the workers, a bounded window of records in
        flight, in order; the window drains before the first record of a
        new pass is pulled, so that pass's permutation is drawn where the
        serial chain draws it."""
        pool, window, cycle = self._pool, self._n_workers * 2, self._cycle

        def apply(rec):
            for stage in prefix:
                out = list(stage(iter([rec])))
                if len(out) != 1:
                    raise ValueError(
                        f"{type(stage).__name__} is pure_per_record but "
                        f"made {len(out)} records of one")
                rec = out[0]
            return rec

        def gen():
            futs, pulled, it = deque(), 0, iter(records)
            while True:
                if pulled and pulled % cycle == 0:
                    while futs:
                        yield futs.popleft().result()
                try:
                    rec = next(it)
                except StopIteration:
                    break
                futs.append(pool.submit(apply, rec))
                pulled += 1
                if len(futs) >= window:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()

        return gen()

    def _advance_epoch(self, records: int):
        """The loop's rollover arithmetic, at produce time."""
        if not self._epoch_size or not self._train:
            return
        self._count += records
        if self._chunk <= 1:
            if self._count >= self._epoch_size:
                self._count = 0
                self._rollover()
        else:
            while self._count >= self._epoch_size:
                self._count -= self._epoch_size
                self._rollover()

    def _rollover(self):
        self._dataset.shuffle()
        if self._order is not None:
            self._order_now = self._order.copy()
        self._it = self._make_iter()

    def _produce(self):
        try:
            if self._stream is not None:
                RNG.own_stream(self._stream)
            self._it = self._make_iter()
            seq = 0
            while not self._stop.is_set():
                if self._pause.is_set():
                    time.sleep(0.002)
                    continue
                with self._work_lock:
                    if self._pause.is_set():
                        continue
                    t0 = time.perf_counter()
                    if self._chunk <= 1:
                        try:
                            b = next(self._it)
                        except StopIteration:
                            self._put(self._host_q, _End())
                            return
                        x, y = np.asarray(b.data), np.asarray(b.labels)
                        records = int(x.shape[0])
                    else:
                        x, y = stack_chunk(
                            [next(self._it) for _ in range(self._chunk)])
                        records = int(x.shape[0] * x.shape[1])
                    self._advance_epoch(records)
                    snap = (self._stream.get_state()
                            if self._stream is not None else None)
                    wall = time.perf_counter() - t0
                with self._stats_lock:
                    self._fetch_seconds += wall
                    self._fetch_count += 1
                if not self._put(self._host_q,
                                 Item(x, y, snap, self._order_now, seq)):
                    return
                seq += 1
        except BaseException as e:
            self._put(self._host_q, _Error(e))

    def _put(self, q, item) -> bool:
        """A bounded put that gives up once the runner is closed."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- transfer ------------------------------------------------------------
    def _transfer_loop(self):
        with torch.cuda.device(self._device), torch.cuda.stream(self._side):
            while not self._stop.is_set():
                try:
                    item = self._host_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if isinstance(item, (_End, _Error)):
                    self._put(self._out_q, item)
                    return
                try:
                    t0 = time.perf_counter()
                    pinned, k = self._ring.stage((item.x, item.y))
                    item.device = tuple(p.to(self._device, non_blocking=True)
                                        for p in pinned)
                    item.event = torch.cuda.Event()
                    item.event.record(self._side)
                    self._ring.mark(k, item.event)
                    wall = time.perf_counter() - t0
                    with self._stats_lock:
                        self._h2d_seconds += wall
                        self._h2d_count += 1
                except BaseException as e:
                    self._put(self._out_q, _Error(e))
                    return
                if not self._put(self._out_q, item):
                    return

    # -- consumer ------------------------------------------------------------
    def get(self):
        """The next item, blocking: ``(item, seconds waited)``.  Raises
        StopIteration at the end of a one-pass stream, and any error of
        the producer or the transfer.  On the card the item's device
        tensors are ready for the current stream's next work."""
        t0 = time.perf_counter()
        item = self._out_q.get()
        waited = time.perf_counter() - t0
        if isinstance(item, _End):
            raise StopIteration
        if isinstance(item, _Error):
            raise item.exc
        self.stall_seconds += waited
        self.consumed += 1
        item.queue_depth = self._out_q.qsize()
        if item.event is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(item.event)
            for t in item.device:
                t.record_stream(cur)
        if item.np_state is not None:
            self._last_np = item.np_state
        if item.order is not None:
            self._last_order = item.order
        return item, waited

    def take_h2d(self):
        """Drain the transfer thread's (seconds, batches) since the last
        call: the consuming loop books them to its ``h2d`` span."""
        with self._stats_lock:
            out = (self._h2d_seconds, self._h2d_count)
            self._h2d_seconds, self._h2d_count = 0.0, 0
        return out

    def take_fetch(self):
        """Drain the producer's (seconds, batches) of draws since the
        last call: the ``data-load/fetch`` span."""
        with self._stats_lock:
            out = (self._fetch_seconds, self._fetch_count)
            self._fetch_seconds, self._fetch_count = 0.0, 0
        return out

    def rng_snapshot(self) -> dict:
        """The checkpoint's random payload: the stream and the order as of
        the last consumed batch, the generators as they are now."""
        return host_snapshot(self._dataset, self._last_np or self._start_np,
                             self._consumed_order())

    def _consumed_order(self):
        return (self._last_order if self._last_order is not None
                else self._start_order)

    def pause(self):
        """Hold the producer before its next draw (validation may read
        the records an epoch shuffle reorders); waits out a draw in
        flight."""
        self._pause.set()
        with self._work_lock:
            pass
        return self

    def resume(self):
        self._pause.clear()
        return self

    def close(self, restore_rng: bool = True):
        """Stop the threads and give the stream back to the calling
        thread, the stream and the order in their state as of the last
        consumed batch (the draws and shuffles of batches prefetched but
        never consumed undone)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for q in {id(self._host_q): self._host_q,
                  id(self._out_q): self._out_q}.values():
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        self._producer.join(timeout=5.0)
        if self._transfer is not None:
            self._transfer.join(timeout=5.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._producer.is_alive():  # pragma: no cover - defensive
            logger.warning("prefetch producer did not stop within 5 s")
        if self._stream is not None:
            RNG.release_stream(self._stream)
            np_state = self._last_np or self._start_np
            if restore_rng and np_state is not None:
                self._stream.set_state(np_state)
        if restore_rng and self._order is not None:
            self._order[:] = self._consumed_order()
