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


class View(TensorModule):
    """(ref View.scala) — reshape keeping the element count.  With
    ``num_input_dims`` set, an input of more dims than that is a batch
    over dim 0; otherwise the JAX module's rule: the whole input is one
    view unless its leading dim is a batch (``shape_ops.py:81-85``)."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.num_input_dims:
            batched = x.dim() > self.num_input_dims
        else:
            batched = not (x.numel() == math.prod(self.sizes) and not (
                x.shape[0] == 1 and x.dim() > len(self.sizes)))
        if batched:
            return x.reshape((x.shape[0],) + self.sizes)
        return x.reshape(self.sizes)

    def extra_repr(self) -> str:
        return "x".join(map(str, self.sizes))
