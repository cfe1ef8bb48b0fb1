"""Transformer pipeline (counterpart of bigdl_tpu/dataset/transformer.py;
ref dataset/Transformer.scala:40-241).

A ``Transformer`` maps an iterator of records to an iterator of records,
composed with ``>>`` (the reference's ``->``).  ``SampleToBatch`` stacks
Samples into MiniBatches, padding variable-length records when asked;
``PreFetch`` runs the stages before it on a background thread.  Each
stage says whether the prefetch pipeline may fan it out to workers
(``pure_per_record``) or must keep it on the one producer thread that
owns the random stream (``stochastic``; ``dataset/prefetch.py``).
``SampleToBatch`` also takes the JAX module's buffer ring
(``reuse_buffers``) and global batch (``global_batch_size``).
"""
from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.sample import MiniBatch


class Transformer:
    """Iterator-to-iterator stage; subclasses override ``__call__``."""

    #: one output record per input record, no random draws, no state
    #: across records: the prefetch pipeline may run it on workers, in
    #: order
    pure_per_record = False
    #: draws from a random stream: it runs on the prefetch producer, the
    #: stream's owner, so the draws keep the serial order
    stochastic = False

    def __call__(self, iterator):
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        """``a >> b`` == the reference's ``a -> b``."""
        return ChainedTransformer(self, other)

    def chain(self, other):
        return self.__rshift__(other)


class ChainedTransformer(Transformer):
    def __init__(self, first, last):
        self.first = first
        self.last = last

    def __call__(self, iterator):
        return self.last(self.first(iterator))


def stages(transformer: Transformer) -> list:
    """The stages of a (possibly chained) transformer, in order."""
    if isinstance(transformer, ChainedTransformer):
        return stages(transformer.first) + stages(transformer.last)
    return [transformer]


class Identity(Transformer):
    def __call__(self, iterator):
        return iterator


class FuncTransformer(Transformer):
    """A per-record function as a stage: ``fn`` applied to each record
    (ref dataset/Transformer.scala; the JAX package's ``FuncTransformer``).

    It is not a pure per-record stage to the background prefetch
    (``dataset/prefetch.py``), which cannot see whether ``fn`` draws
    random numbers or keeps state across records: it runs on the one
    producer thread, in order, after the stages before it, exactly as
    the serial chain runs it, and no stage before it fans out to the
    workers past it."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, iterator):
        return (self.fn(x) for x in iterator)


class SampleToBatch(Transformer):
    """Sample -> MiniBatch (ref Transformer.scala:99-241; bigdl_tpu/
    dataset/transformer.py:68-219).

    ``feature_padding``/``label_padding``: pad value for variable-length
    features/labels (dim 0); ``fixed_length``: pad every batch to this
    length; ``drop_last``: drop a partial tail batch.

    ``reuse_buffers=N`` (N >= 2) assembles batches into a ring of N
    preallocated arrays instead of a new stack a batch: a batch is valid
    until N - 1 more have been drawn (the training loops copy each batch
    at once; a prefetch of depth d needs N >= d + 2).  A batch that does
    not fit the ring (a partial tail, a shape that drifts, a padded side
    without ``fixed_length``) is stacked anew.

    ``global_batch_size`` (instead of ``batch_size``): the batch over
    every process, divided over the live process group when each pass
    starts (ref Utils.getBatchSize, Utils.scala:26-48), so each rank's
    batch follows the world it runs in."""

    def __init__(self, batch_size: int = None, feature_padding=None,
                 label_padding=None, fixed_length: int = None,
                 drop_last: bool = False, reuse_buffers: int = 0,
                 global_batch_size: int = None):
        if reuse_buffers and reuse_buffers < 2:
            raise ValueError(
                f"reuse_buffers needs a ring of >= 2 slots, got "
                f"{reuse_buffers} (the consumer still holds the previous "
                "batch while the next is assembled)")
        if (batch_size is None) == (global_batch_size is None):
            raise ValueError("pass exactly one of batch_size (per-process)"
                             " or global_batch_size (divided over the live"
                             " process world)")
        self.global_batch_size = (int(global_batch_size)
                                  if global_batch_size is not None else None)
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.fixed_length = fixed_length
        self.drop_last = drop_last
        self.reuse_buffers = int(reuse_buffers)
        self._ring = None
        self._ring_i = 0

    def _stack(self, arrays, pad_value):
        if pad_value is None:
            return np.stack(arrays)
        return _pad_stack(arrays, pad_value, self.fixed_length)

    def _local_batch(self) -> int:
        if self.global_batch_size is None:
            return self.batch_size
        from bigdl_tpu_torch.dataset.dataset import (_world_position,
                                                     get_batch_size)
        return get_batch_size(self.global_batch_size, _world_position()[1])

    def __call__(self, iterator):
        batch = self._local_batch()
        if self._ring is not None and self._ring[0][0].shape[0] != batch:
            self._ring = None   # the world changed: new slots
        buf = []
        for s in iterator:
            buf.append(s)
            if len(buf) == batch:
                yield self._assemble(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._assemble(buf)

    def _ring_slot(self, feats, labels, rows):
        """The next (feature, label) buffer pair of the ring, or None
        where the batch does not fit it."""
        if not self.reuse_buffers:
            return None
        if self._ring is None:
            shapes = []
            for first, pad in ((np.asarray(feats[0]), self.feature_padding),
                               (np.asarray(labels[0]), self.label_padding)):
                if pad is not None:
                    if self.fixed_length is None:
                        return None
                    shapes.append(((rows, self.fixed_length)
                                   + first.shape[1:], first.dtype))
                else:
                    shapes.append(((rows,) + first.shape, first.dtype))
            self._ring = [tuple(np.empty(s, d) for s, d in shapes)
                          for _ in range(self.reuse_buffers)]
        fbuf, lbuf = self._ring[self._ring_i]
        if len(feats) != fbuf.shape[0] \
                or not _rows_fit(fbuf, feats, self.feature_padding) \
                or not _rows_fit(lbuf, labels, self.label_padding):
            return None
        self._ring_i = (self._ring_i + 1) % len(self._ring)
        return fbuf, lbuf

    def _assemble(self, samples):
        feats = [s.feature for s in samples]
        labels = [s.label for s in samples]
        slot = self._ring_slot(feats, labels, len(samples))
        if slot is not None:
            return MiniBatch(_fill(slot[0], feats, self.feature_padding),
                             _fill(slot[1], labels, self.label_padding))
        return MiniBatch(self._stack(feats, self.feature_padding),
                         self._stack(labels, self.label_padding))


def _rows_fit(buf, rows, pad_value) -> bool:
    """Every row has the buffer's row shape (a padded side: its trailing
    dims; dim 0 is clipped or padded)."""
    if pad_value is None:
        return all(np.shape(r) == buf.shape[1:] for r in rows)
    return all(np.shape(r)[1:] == buf.shape[2:] for r in rows)


def _fill(buf, arrays, pad_value):
    """The rows copied into a ring buffer (a padded side first filled
    with the pad value, then each row's prefix written)."""
    if pad_value is None:
        for i, a in enumerate(arrays):
            buf[i] = a
        return buf
    buf.fill(pad_value)
    for i, a in enumerate(arrays):
        n = min(np.shape(a)[0], buf.shape[1])
        buf[i, :n] = a[:n]
    return buf


def _pad_stack(arrays, pad_value, fixed_length=None):
    """Stack 1..nD arrays, padding dim 0 to the max (or fixed) length."""
    max_len = (fixed_length if fixed_length is not None
               else max(a.shape[0] for a in arrays))
    out = np.full((len(arrays), max_len) + arrays[0].shape[1:], pad_value,
                  dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        n = min(a.shape[0], max_len)
        out[i, :n] = a[:n]
    return out


class PreFetch(Transformer):
    """The stages before it run on a background thread, ``depth`` records
    ahead (the reference's MTLabeledBGRImgToBatch + PreFetch,
    MTLabeledBGRImgToBatch.scala:47,106); an error there is raised here,
    at the record it stopped at."""

    def __init__(self, depth: int = 2):
        self.depth = depth

    def __call__(self, iterator):
        import queue
        import threading

        q = queue.Queue(maxsize=self.depth)
        end = object()
        stop = threading.Event()

        class _Error:
            # a private wrapper, so that a record which is an exception
            # object is never taken for a failure
            def __init__(self, exc):
                self.exc = exc

        def put(item):
            # gives up once the consumer has gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in iterator:
                    if not put(item):
                        return
                put(end)
            except BaseException as e:
                put(_Error(e))

        threading.Thread(target=worker, daemon=True,
                         name="bigdl-prefetch").start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, _Error):
                    raise item.exc
                yield item
        finally:
            stop.set()
