"""Shape ops (counterpart of bigdl_tpu/nn/shape_ops.py)."""
from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.nn.module import Module, TensorModule


class Identity(Module):
    def forward(self, x):
        return x


class Reshape(TensorModule):
    """(ref Reshape.scala) — reshapes the non-batch dims; ``batch_mode``
    forces treating dim 0 as the batch (None: decide as the reference
    does)."""

    def __init__(self, size, batch_mode: bool = None):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_el = math.prod(self.size)
        batched = self.batch_mode
        if batched is None:
            # batched when the per-sample elements match; a singleton
            # leading dim with more input dims than target dims counts as
            # a batch of one (shape_ops.py:30-35)
            batched = (x.numel() == x.shape[0] * n_el and
                       (x.numel() != n_el or
                        (x.shape[0] == 1 and x.dim() > len(self.size))))
        if batched:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)

    def extra_repr(self) -> str:
        return "x".join(map(str, self.size))
