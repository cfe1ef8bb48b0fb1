"""Transformer pipeline (counterpart of bigdl_tpu/dataset/transformer.py;
ref dataset/Transformer.scala:40-241).

A ``Transformer`` maps an iterator of records to an iterator of records,
composed with ``>>`` (the reference's ``->``).  ``SampleToBatch`` stacks
Samples into MiniBatches, padding variable-length records when asked;
``PreFetch`` runs the stages before it on a background thread.  Each
stage says whether the prefetch pipeline may fan it out to workers
(``pure_per_record``) or must keep it on the one producer thread that
owns the random stream (``stochastic``; ``dataset/prefetch.py``).  The
JAX module's buffer ring and global-batch mode are not ported.
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
    """Sample -> MiniBatch (ref Transformer.scala:99-241).

    ``feature_padding``/``label_padding``: pad value for variable-length
    features/labels (dim 0); ``fixed_length``: pad every batch to this
    length; ``drop_last``: drop a partial tail batch."""

    def __init__(self, batch_size: int, feature_padding=None,
                 label_padding=None, fixed_length: int = None,
                 drop_last: bool = False):
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.fixed_length = fixed_length
        self.drop_last = drop_last

    def _stack(self, arrays, pad_value):
        if pad_value is None:
            return np.stack(arrays)
        return _pad_stack(arrays, pad_value, self.fixed_length)

    def __call__(self, iterator):
        buf = []
        for s in iterator:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._assemble(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._assemble(buf)

    def _assemble(self, samples):
        return MiniBatch(
            self._stack([s.feature for s in samples], self.feature_padding),
            self._stack([s.label for s in samples], self.label_padding))


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
