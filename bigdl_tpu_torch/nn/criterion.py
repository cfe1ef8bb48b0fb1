"""Criterions (counterpart of bigdl_tpu/nn/criterion.py).

Conventions match the reference and Torch: class targets are **1-based**
(floats are truncated, as ``jnp.asarray(target, jnp.int32)`` does);
``size_average=True`` divides by the batch size.  ``apply_loss`` is the
scalar function; autograd supplies the backward.
"""
from __future__ import annotations

import torch


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
        x = input.detach().requires_grad_()
        with torch.enable_grad():
            (self.grad_input,) = torch.autograd.grad(
                self.apply_loss(x, target), x)
        return self.grad_input

    def __repr__(self):
        return f"{type(self).__name__}()"


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
