"""Record types (counterpart of bigdl_tpu/dataset/sample.py; ref
dataset/Sample.scala:33, Types.scala:74).

``Sample`` is a (feature, label) numpy pair on the host; ``MiniBatch`` a
batched pair; ``LabeledSentence`` a token-id sequence and its labels.
Host data stays numpy until a whole batch crosses to the device.
"""
from __future__ import annotations

import numpy as np


class Sample:
    __slots__ = ("feature", "label")

    def __init__(self, feature, label):
        self.feature = np.asarray(feature)
        self.label = np.asarray(label)

    def feature_size(self):
        return self.feature.shape

    def label_size(self):
        return self.label.shape

    def clone(self):
        return Sample(self.feature.copy(), self.label.copy())

    def __eq__(self, other):
        return (isinstance(other, Sample)
                and np.array_equal(self.feature, other.feature)
                and np.array_equal(self.label, other.label))

    def __repr__(self):
        return f"Sample(feature{self.feature.shape}, label{self.label.shape})"


class MiniBatch:
    """(ref Types.scala:74) — ``data`` (B, ...) and ``labels`` (B, ...)."""

    __slots__ = ("data", "labels")

    def __init__(self, data, labels):
        self.data = data
        self.labels = labels

    def size(self):
        return int(self.data.shape[0])

    def __iter__(self):  # tuple-unpack convenience
        yield self.data
        yield self.labels

    def __repr__(self):
        return (f"MiniBatch(data{tuple(self.data.shape)}, "
                f"labels{tuple(self.labels.shape)})")


class LabeledSentence:
    """Token-id sequence + per-position labels (ref text/Types.scala:33)."""

    __slots__ = ("data", "label")

    def __init__(self, data, label):
        self.data = np.asarray(data)
        self.label = np.asarray(label)

    def data_length(self):
        return len(self.data)

    def label_length(self):
        return len(self.label)
