"""Transformer pipeline (counterpart of bigdl_tpu/dataset/transformer.py;
ref dataset/Transformer.scala:40-241).

A ``Transformer`` maps an iterator of records to an iterator of records,
composed with ``>>`` (the reference's ``->``).  ``SampleToBatch`` stacks
Samples into MiniBatches, padding variable-length records when asked.
The JAX module's buffer ring, global-batch mode and background prefetch
are not ported.
"""
from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.sample import MiniBatch


class Transformer:
    """Iterator-to-iterator stage; subclasses override ``__call__``."""

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
