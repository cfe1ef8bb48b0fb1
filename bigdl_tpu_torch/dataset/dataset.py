"""Local datasets (counterpart of bigdl_tpu/dataset/dataset.py; ref
dataset/DataSet.scala:47-294).

``DataSet.array(records, seed)`` holds the records in memory and loops
over them shuffled; ``ds >> transformer`` composes as DataSet.scala:74-88.
The shuffles draw from the dataset's own ``np.random.RandomState(seed)``:
the same draws, in the same order, as the JAX package's main-thread
``RNG.np_rng()`` after ``set_seed(seed)`` (an in-place ``shuffle`` of
the records at each epoch rollover, then one ``permutation`` as each
training pass starts), so the two packages see the same epoch order.
``ds >> transformer`` hands that stream to every random (``stochastic``)
stage of the transformer that has none of its own, so the crops and
flips draw from it too, lazily, record by record, as the JAX pipeline
draws from ``RNG.np_rng()``.
The sharded (distributed) dataset comes with the distributed slice.
"""
from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer, stages


class AbstractDataSet:
    """(ref DataSet.scala:47)"""

    def data(self, train: bool):
        """An iterator over records: ``train=True`` loops forever,
        shuffled; ``train=False`` makes one pass in order."""
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer):
        """``ds >> transformer`` == the reference's ``ds -> transformer``."""
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """Iterator-based local dataset (ref DataSet.scala:111)."""


class LocalArrayDataSet(LocalDataSet):
    """In-memory records with looped, shuffled iteration
    (ref DataSet.scala:128)."""

    def __init__(self, data, seed: int = 1):
        self._data = list(data)
        self.rng = np.random.RandomState(seed)

    def size(self):
        return len(self._data)

    def shuffle(self):
        self.rng.shuffle(self._data)
        return self

    def data(self, train: bool):
        if train:
            def looped():
                while True:
                    for i in self.rng.permutation(len(self._data)):
                        yield self._data[i]
            return looped()
        return (self._data[i] for i in range(len(self._data)))


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer
        #: the random stream of the dataset at the chain's root, if any
        self.rng = getattr(base, "rng", None)
        for stage in stages(transformer):
            if getattr(stage, "stochastic", False) and stage.rng is None:
                stage.rng = self.rng

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()
        return self

    def data(self, train: bool):
        return self.transformer(self.base.data(train))


class DataSet:
    """Factory namespace (ref object DataSet, DataSet.scala:271)."""

    @staticmethod
    def array(data, seed: int = 1):
        """(ref DataSet.array :271-294); ``seed`` seeds the shuffles (the
        JAX package's process-wide default seed is 1)."""
        return LocalArrayDataSet(data, seed)
