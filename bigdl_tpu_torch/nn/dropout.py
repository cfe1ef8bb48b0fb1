"""Regularisation layers (counterpart of bigdl_tpu/nn/dropout.py):
Dropout and L1Penalty."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.utils.random import RNG


class Dropout(TensorModule):
    """Inverted dropout with keep-scale 1/(1-p) in training; the identity
    in ``evaluate()`` mode.  The mask is drawn from the package stream
    (``utils.random.RNG`` on the input's device), never from PyTorch's
    global generator: one ``RNG.set_seed`` gives one run.  ``scale=False``
    leaves the kept units unscaled; ``inplace`` is accepted for the
    reference's signature and, as in the JAX module, changes nothing."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.p = init_p
        self.scale = scale

    def set_p(self, p: float) -> "Dropout":
        self.p = p
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(
            keep, generator=RNG.generator(x.device))
        return x * (mask.div_(keep) if self.scale and keep > 0 else mask)


class _L1Penalty(torch.autograd.Function):
    """The identity forward; the backward adds m * sign(x)."""

    @staticmethod
    def forward(ctx, x, m):
        ctx.save_for_backward(x)
        ctx.m = m
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.m * torch.sign(x), None


class L1Penalty(TensorModule):
    """The identity, whose backward adds the L1 subgradient m * sign(x),
    m = ``l1weight``, over ``x.numel()`` with ``size_average`` (ref
    L1Penalty.scala; the JAX module's custom VJP)."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True):
        super().__init__()
        self.l1weight = l1weight
        self.size_average = size_average

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.l1weight / x.numel() if self.size_average else self.l1weight
        return _L1Penalty.apply(x, m)
