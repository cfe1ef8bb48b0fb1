"""Dropout (counterpart of bigdl_tpu/nn/dropout.py ``Dropout``)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.utils.random import RNG


class Dropout(TensorModule):
    """Inverted dropout with keep-scale 1/(1-p) in training; the identity
    in ``evaluate()`` mode.  The mask is drawn from the package stream
    (``utils.random.RNG`` on the input's device), never from PyTorch's
    global generator: one ``RNG.set_seed`` gives one run."""

    def __init__(self, init_p: float = 0.5):
        super().__init__()
        self.p = init_p

    def set_p(self, p: float) -> "Dropout":
        self.p = p
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(
            keep, generator=RNG.generator(x.device))
        return x * (mask.div_(keep) if keep > 0 else mask)
