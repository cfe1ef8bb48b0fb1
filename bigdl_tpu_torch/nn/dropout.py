"""Dropout (counterpart of bigdl_tpu/nn/dropout.py ``Dropout``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import TensorModule


class Dropout(TensorModule):
    """Inverted dropout with keep-scale 1/(1-p) in training; the identity
    in ``evaluate()`` mode."""

    def __init__(self, init_p: float = 0.5):
        super().__init__()
        self.p = init_p

    def set_p(self, p: float) -> "Dropout":
        self.p = p
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        return F.dropout(x, self.p, training=True)
