"""Activations of the slice (counterpart of bigdl_tpu/nn/activations.py)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import TensorModule


class ReLU(TensorModule):
    """max(x, 0).  ``ip`` (in place) is taken for the reference's
    signature; the result is computed out of place, as in the JAX
    package."""

    def __init__(self, ip: bool = False):
        super().__init__()
        self.inplace = ip

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x)


class LogSoftMax(TensorModule):
    """Over the last dim, always in fp32 (log-probabilities need the
    fp32 mantissa)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return torch.log_softmax(x, dim=-1)


class Tanh(TensorModule):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x)
