"""TimeDistributed (counterpart of bigdl_tpu/nn/recurrent.py:462)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Container, Module


class TimeDistributed(Container):
    """Apply a module at every timestep of (N, T, ...) by folding T into
    the batch: one (N*T, ...) call instead of T small ones."""

    def __init__(self, module: Module):
        super().__init__(module)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t = x.shape[0], x.shape[1]
        y = self.get(1)(x.reshape((n * t,) + tuple(x.shape[2:])))
        return y.reshape((n, t) + tuple(y.shape[1:]))
