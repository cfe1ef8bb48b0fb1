"""Criterions (counterpart of bigdl_tpu/nn/criterion.py): the full
inventory of the JAX package.

Conventions match the reference and Torch: class targets are **1-based**
(floats are truncated, as ``jnp.asarray(target, jnp.int32)`` does);
``size_average=True`` divides by the batch size (or, where the JAX
criterion takes a mean over elements, by their count).  A criterion
over two inputs takes a 1-based ``Table`` (a list counts as the Table of
its elements).  ``apply_loss`` is the scalar function; autograd supplies
the backward.  Each is written with operations that ``torch.func.vmap``
batches, so ``TimeDistributedCriterion`` maps any tensor criterion over
time in one call, as the JAX one vmaps it.

Where the JAX criterion's derivative is set at a tie or a kink, the
port's is the same: ``jnp.maximum(0, v)`` gives 1/2 at v = 0 (so does
``torch.maximum``; ``clamp`` would give 1), ``jnp.abs`` gives 1 at 0
(``ops._activation._abs``; ``torch.abs`` gives 0), and
``jax.nn.softplus`` is ``logaddexp(v, 0)`` with no linear cut-off
(``F.softplus`` has one).
"""
from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import device_constant
from bigdl_tpu_torch.ops._activation import _abs
from bigdl_tpu_torch.utils.table import Table, as_table


class Criterion:
    """Loss base (ref abstractnn/AbstractCriterion.scala; the JAX
    package's ``nn.module.Criterion``)."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average
        self.output = None
        self.grad_input = None

    def apply_loss(self, input, target):
        raise NotImplementedError(type(self).__name__)

    def forward(self, input, target):
        self.output = self.apply_loss(input, target)
        return self.output

    def __call__(self, input, target):
        return self.forward(input, target)

    def backward(self, input, target):
        """The loss's gradient with respect to ``input``: a tensor, or for
        a Table input the Table of each element's gradient."""
        table = isinstance(input, (Table, list, tuple))
        xs = ([v.detach().requires_grad_() for v in as_table(input)]
              if table else [input.detach().requires_grad_()])
        with torch.enable_grad():
            loss = self.apply_loss(Table(*xs) if table else xs[0], target)
            grads = torch.autograd.grad(loss, xs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads)]
        self.grad_input = Table(*grads) if table else grads[0]
        return self.grad_input

    def __repr__(self):
        return f"{type(self).__name__}()"


def _reduce(per_sample, size_average):
    return per_sample.mean() if size_average else per_sample.sum()


def _tensor(v, like):
    """A target (tensor, numpy array or number) as a tensor on ``like``'s
    device; a tensor is taken as it is (vmap hands batched ones in)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v), device=like.device)


def _index(target, like):
    """1-based class targets as 0-based int64 indices."""
    return _tensor(target, like).long() - 1


def _hinge(v):
    """max(0, v) with ``jnp.maximum``'s 1/2 derivative at the tie."""
    return torch.maximum(v, torch.zeros((), dtype=v.dtype, device=v.device))


def _softplus(v):
    """``jax.nn.softplus``: log(1 + exp(v)) as logaddexp(v, 0)."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _weights(weights):
    return (None if weights is None
            else torch.as_tensor(np.asarray(weights), dtype=torch.float32))


class ClassNLLCriterion(Criterion):
    """NLL over log-probabilities: LogSoftMax input, 1-based class
    targets of shape (B,) or (B, 1), optional per-class ``weights``
    (ref ClassNLLCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__(size_average)
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=torch.float32))

    def apply_loss(self, input, target):
        if input.dim() == 1:
            input = input[None]
        idx = torch.as_tensor(target, device=input.device).reshape(
            input.shape[0]).long() - 1
        picked = input.gather(1, idx[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(input.device)[idx]
            loss = -(w * picked)
            return loss.sum() / w.sum() if self.size_average else loss.sum()
        return -picked.mean() if self.size_average else -picked.sum()


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL fused (ref CrossEntropyCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__(size_average)
        self.nll = ClassNLLCriterion(weights, size_average)

    def apply_loss(self, input, target):
        return self.nll.apply_loss(torch.log_softmax(input, dim=-1), target)


class MSECriterion(Criterion):
    """Mean squared error; ``size_average`` divides by the number of
    elements (ref MSECriterion.scala)."""

    def apply_loss(self, input, target):
        d = (input - _tensor(target, input)) ** 2
        return d.mean() if self.size_average else d.sum()


class AbsCriterion(Criterion):
    """Mean (or sum) of |input - target| (ref AbsCriterion.scala)."""

    def apply_loss(self, input, target):
        d = _abs(input - _tensor(target, input))
        return d.mean() if self.size_average else d.sum()


class BCECriterion(Criterion):
    """Binary cross-entropy on probabilities, each log taken of its
    argument plus 1e-12, optionally weighted element-wise (ref
    BCECriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__(size_average)
        self.weights = _weights(weights)

    def apply_loss(self, input, target):
        eps = 1e-12
        t = _tensor(target, input)
        loss = -(t * torch.log(input + eps)
                 + (1 - t) * torch.log(1 - input + eps))
        if self.weights is not None:
            loss = loss * device_constant(self, "weights", self.weights,
                                          input.device)
        return loss.mean() if self.size_average else loss.sum()


class DistKLDivCriterion(Criterion):
    """KL(target || input) with log-probability input; ``size_average``
    divides by the batch size (ref DistKLDivCriterion.scala)."""

    def apply_loss(self, input, target):
        t = _tensor(target, input)
        loss = torch.where(t > 0, t * (torch.log(t.clamp_min(1e-30))
                                       - input), 0.0)
        n = input.shape[0] if input.dim() > 1 else 1
        return loss.sum() / n if self.size_average else loss.sum()


def _simplex(n: int) -> np.ndarray:
    """The vertices of a regular (n-1)-simplex, one row a class (the JAX
    criterion's construction, criterion.py ``_build_simplex``)."""
    m = np.zeros((n, n), np.float32)
    np.fill_diagonal(m, 1.0)
    a = np.zeros((n, n), np.float32)
    for k in range(n - 1):
        a[k, k] = np.sqrt(1.0 - (a[k, :k] ** 2).sum())
        for r in range(k + 1, n):
            dot = (a[k, :k] * a[r, :k]).sum()
            a[r, k] = ((-1.0 / (n - 1)) - dot) / a[k, k]
    return a


class ClassSimplexCriterion(Criterion):
    """MSE against the simplex vertex of each 1-based class target (ref
    ClassSimplexCriterion.scala)."""

    def __init__(self, n_classes: int):
        super().__init__(True)
        self.n_classes = n_classes
        self.simplex = torch.from_numpy(_simplex(n_classes))
        self.mse = MSECriterion()

    def apply_loss(self, input, target):
        simplex = device_constant(self, "simplex", self.simplex,
                                  input.device)
        return self.mse.apply_loss(input, simplex[_index(target, input)])


class CosineEmbeddingCriterion(Criterion):
    """Table(x1, x2) and y in {1, -1}: 1 - cos where y = 1, max(0, cos -
    margin) where not (ref CosineEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def apply_loss(self, input, target):
        input = as_table(input)
        x1, x2 = input[1], input[2]
        dim = -1 if x1.dim() > 1 else 0
        norms = (torch.linalg.vector_norm(x1, dim=dim)
                 * torch.linalg.vector_norm(x2, dim=dim))
        cos = (x1 * x2).sum(dim) / torch.clamp_min(norms, 1e-12)
        y = _tensor(target, x1).reshape(cos.shape)
        loss = torch.where(y > 0, 1.0 - cos, _hinge(cos - self.margin))
        return _reduce(loss, self.size_average)


class HingeEmbeddingCriterion(Criterion):
    """x where y = 1, max(0, margin - x) where y = -1 (ref
    HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def apply_loss(self, input, target):
        loss = torch.where(_tensor(target, input) > 0, input,
                           _hinge(self.margin - input))
        return _reduce(loss, self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """Table(x1, x2) and y: the L1 distance where y = 1, max(0, margin -
    distance) where not (ref L1HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0):
        super().__init__(True)
        self.margin = margin

    def apply_loss(self, input, target):
        input = as_table(input)
        x1 = input[1]
        d = _abs(x1 - input[2]).sum(-1 if x1.dim() > 1 else 0)
        loss = torch.where(_tensor(target, x1).reshape(d.shape) > 0, d,
                           _hinge(self.margin - d))
        return _reduce(loss, self.size_average)


class MarginCriterion(Criterion):
    """Hinge loss max(0, margin - y x) (ref MarginCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def apply_loss(self, input, target):
        loss = _hinge(self.margin - input * _tensor(target, input))
        return loss.mean() if self.size_average else loss.sum()


class MarginRankingCriterion(Criterion):
    """Table(x1, x2) and y (a tensor, or a Table holding it): max(0,
    -y (x1 - x2) + margin) (ref MarginRankingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def apply_loss(self, input, target):
        input = as_table(input)
        y = target[1] if isinstance(target, Table) else target
        y = _tensor(y, input[1])
        loss = _hinge(-y * (input[1] - input[2]) + self.margin)
        return _reduce(loss, self.size_average)


class MultiCriterion(Criterion):
    """Weighted sum of criterions on the same (input, target) (ref
    MultiCriterion.scala)."""

    def __init__(self):
        super().__init__(True)
        self.criterions = []
        self.weights = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def apply_loss(self, input, target):
        return sum(w * c.apply_loss(input, target)
                   for c, w in zip(self.criterions, self.weights))


class ParallelCriterion(Criterion):
    """The i-th criterion on (input[i], target[i]), weighted and summed
    (ref ParallelCriterion.scala); ``repeat_target`` gives every one the
    whole target."""

    def __init__(self, repeat_target: bool = False):
        super().__init__(True)
        self.repeat_target = repeat_target
        self.criterions = []
        self.weights = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def apply_loss(self, input, target):
        input = as_table(input)
        if not self.repeat_target:
            target = as_table(target)
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.weights)):
            t = target if self.repeat_target else target[i + 1]
            total = total + w * c.apply_loss(input[i + 1], t)
        return total


class MultiLabelMarginCriterion(Criterion):
    """Multi-label hinge (ref MultiLabelMarginCriterion.scala): each row of
    the (n, d) target lists 1-based labels, padded with 0; every positive
    entry is a label, as in the JAX criterion.  For each label t and each
    class j that is no label: max(0, 1 - (x[t] - x[j])), summed over a
    row and divided by d."""

    def __init__(self, size_average: bool = True):
        super().__init__(size_average)

    def apply_loss(self, input, target):
        tgt = _tensor(target, input).long()
        if input.dim() == 1:
            input, tgt = input[None], tgt.reshape(1, -1)
        d = input.shape[1]
        valid = tgt > 0
        idx = torch.clamp_min(tgt - 1, 0)
        tgt_scores = input.gather(1, idx)
        classes = torch.arange(d, device=input.device)
        is_target = ((idx[..., None] == classes) & valid[..., None]).any(1)
        margins = _hinge(1.0 - (tgt_scores[:, :, None] - input[:, None, :]))
        mask = valid[:, :, None] & ~is_target[:, None, :]
        loss = (margins * mask).sum((1, 2)) / d
        return _reduce(loss, self.size_average)


class MultiLabelSoftMarginCriterion(Criterion):
    """Sigmoid and binary cross-entropy for each label, the mean over
    labels, optionally weighted (ref MultiLabelSoftMarginCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__(size_average)
        self.weights = _weights(weights)

    def apply_loss(self, input, target):
        t = _tensor(target, input)
        loss = _softplus(-input) * t + _softplus(input) * (1 - t)
        if self.weights is not None:
            loss = loss * device_constant(self, "weights", self.weights,
                                          input.device)
        if loss.dim() > 1:
            return _reduce(loss.mean(-1), self.size_average)
        return loss.mean()


class MultiMarginCriterion(Criterion):
    """Multi-class hinge: the sum over j != y of max(0, margin - x[y] +
    x[j]) ** p, weighted by the class of y, over the number of classes
    (ref MultiMarginCriterion.scala)."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__(size_average)
        self.p = p
        self.margin = margin
        self.weights = _weights(weights)

    def apply_loss(self, input, target):
        if input.dim() == 1:
            input = input[None]
        n, d = input.shape
        idx = _index(target, input).reshape(n)
        x_y = input.gather(1, idx[:, None])
        m = _hinge(self.margin - x_y + input) ** self.p
        if self.weights is not None:
            w = device_constant(self, "weights", self.weights, input.device)
            m = m * w[idx][:, None]
        classes = torch.arange(d, device=input.device)
        m = m * (idx[:, None] != classes)
        return _reduce(m.sum(1) / d, self.size_average)


class SmoothL1Criterion(Criterion):
    """Huber loss with delta 1 (ref SmoothL1Criterion.scala)."""

    def apply_loss(self, input, target):
        d = _abs(input - _tensor(target, input))
        loss = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
        return loss.mean() if self.size_average else loss.sum()


class SmoothL1CriterionWithWeights(Criterion):
    """Fast R-CNN's box loss with inside and outside weights and sigma
    (ref SmoothL1CriterionWithWeights.scala): the target is a Table
    (target, inside weights, outside weights) or a tensor (both weights
    1); the sum is divided by ``num`` if set, else by the batch size."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__(False)
        self.sigma2 = sigma * sigma
        self.num = num

    def apply_loss(self, input, target):
        if isinstance(target, Table):
            t, in_w, out_w = (_tensor(target[i], input) for i in (1, 2, 3))
        else:
            t, in_w, out_w = _tensor(target, input), 1.0, 1.0
        d = (input - t) * in_w
        ad = _abs(d)
        loss = torch.where(ad < 1.0 / self.sigma2, 0.5 * d * d * self.sigma2,
                           ad - 0.5 / self.sigma2) * out_w
        s = loss.sum()
        return s / self.num if self.num > 0 else s / input.shape[0]


class SoftMarginCriterion(Criterion):
    """log(1 + exp(-y x)) (ref SoftMarginCriterion.scala)."""

    def apply_loss(self, input, target):
        loss = _softplus(-input * _tensor(target, input))
        return loss.mean() if self.size_average else loss.sum()


class SoftmaxWithCriterion(Criterion):
    """Caffe's SoftmaxWithLoss over (N, C, ...) logits and (N, ...)
    1-based targets (ref SoftmaxWithCriterion.scala): ``ignore_label``
    drops the positions holding it; ``normalize_mode`` "valid" divides by
    the positions kept (at least 1), "batch_size" by N, "full" by every
    position, anything else not at all.

    A position holding the ignore label (which may lie outside 1..C, as
    Caffe's 255 does) gathers a clamped class index and is masked out."""

    def __init__(self, ignore_label: int = None,
                 normalize_mode: str = "valid"):
        super().__init__(True)
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def apply_loss(self, input, target):
        logp = torch.log_softmax(input, dim=1)
        tgt = _tensor(target, input).long()
        idx = (tgt - 1).clamp(0, input.shape[1] - 1)
        picked = logp.gather(1, idx[:, None])[:, 0]
        if self.ignore_label is not None:
            mask = tgt != self.ignore_label
            picked = picked * mask
            count = mask.sum()
        else:
            count = picked.numel()
        loss = -picked.sum()
        if self.normalize_mode == "valid":
            return loss / (torch.clamp_min(count, 1)
                           if isinstance(count, torch.Tensor)
                           else max(count, 1))
        if self.normalize_mode == "batch_size":
            return loss / input.shape[0]
        if self.normalize_mode == "full":
            return loss / picked.numel()
        return loss


class L1Cost(Criterion):
    """The sum of |x|; the target is not read (ref L1Cost.scala)."""

    def apply_loss(self, input, target):
        return _abs(input).sum()


class TimeDistributedCriterion(Criterion):
    """``critrn`` at every timestep of (N, T, ...) input, against a
    per-step target (N, T, ...) when the target has more than one dim,
    else the same target at every step; the steps' losses summed, then
    divided by T when ``size_average`` (ref
    TimeDistributedCriterion.scala).  The T steps are one batched call of
    ``critrn`` (``torch.func.vmap`` over the time axis, as the JAX
    criterion vmaps), not T calls: one launch an operation, whatever T."""

    def __init__(self, critrn: Criterion, size_average: bool = False):
        super().__init__(size_average)
        self.critrn = critrn

    def apply_loss(self, input, target):
        t_len = input.shape[1]
        target = torch.as_tensor(target, device=input.device)
        per_step = target.dim() > 1
        losses = torch.func.vmap(self.critrn.apply_loss,
                                 in_dims=(1, 1 if per_step else None))(
            input, target)
        total = losses.sum()
        return total / t_len if self.size_average else total
