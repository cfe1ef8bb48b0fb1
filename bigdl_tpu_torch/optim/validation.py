"""Validation methods and their mergeable results (counterpart of
bigdl_tpu/optim/validation.py; ref optim/ValidationMethod.scala:26-230).

The compare runs on the host in numpy, as in the JAX package: reading a
batch's output there is the validation loop's one sync per batch.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class ValidationResult:
    def result(self):
        """(value, count)"""
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: int, count: int):
        self.correct = int(correct)
        self.count = int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __eq__(self, other):
        return (isinstance(other, AccuracyResult)
                and self.correct == other.correct
                and self.count == other.count)

    def __repr__(self):
        acc, n = self.result()
        return f"Accuracy(correct: {self.correct}, count: {n}, accuracy: {acc})"


class LossResult(ValidationResult):
    def __init__(self, loss: float, count: int):
        self.loss = float(loss)
        self.count = int(count)

    def result(self):
        return (self.loss / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        l, n = self.result()
        return f"Loss(sum: {self.loss}, count: {n}, mean: {l})"


class ValidationMethod:
    def __call__(self, output, target) -> ValidationResult:
        raise NotImplementedError


def _topk_correct(output, target, k):
    """Samples whose 1-based target is within the top k of their output
    row (ref EvaluateMethods.scala:23)."""
    output = _host(output)
    if output.ndim == 1:
        output = output[None]
    target = np.reshape(_host(target), (output.shape[0],))
    topk = np.argsort(-output, axis=1)[:, :k]
    correct = (topk == target.astype(np.int64)[:, None] - 1).any(axis=1)
    return int(correct.sum()), int(output.shape[0])


class Top1Accuracy(ValidationMethod):
    def __call__(self, output, target):
        return AccuracyResult(*_topk_correct(output, target, 1))

    def __repr__(self):
        return "Top1Accuracy"


class Top5Accuracy(ValidationMethod):
    def __call__(self, output, target):
        return AccuracyResult(*_topk_correct(output, target, 5))

    def __repr__(self):
        return "Top5Accuracy"


class Loss(ValidationMethod):
    """Mean criterion loss over the validation set (ref
    ValidationMethod.Loss)."""

    def __init__(self, criterion):
        self.criterion = criterion

    def __call__(self, output, target):
        target = torch.as_tensor(_host(target))
        l = float(self.criterion.apply_loss(output, target.to(output.device)))
        n = output.shape[0] if output.dim() > 1 else 1
        return LossResult(l * n, n)

    def __repr__(self):
        return "Loss"
