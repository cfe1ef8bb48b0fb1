"""Reductions (counterpart of bigdl_tpu/nn/reductions.py; ref Mean.scala).
Dimensions are 1-based, as in the reference.  Only ``Mean`` is ported:
the text classifier pools over time with it."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import TensorModule


class Mean(TensorModule):
    """Mean over 1-based ``dimension``; ``n_input_dims`` shifts it by one
    for batched input (more dims than that); ``squeeze`` drops the reduced
    dim."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def _axis(self, x: torch.Tensor) -> int:
        d = self.dimension - 1
        if self.n_input_dims > 0 and x.dim() > self.n_input_dims:
            d += 1
        return d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=self._axis(x), keepdim=not self.squeeze)
