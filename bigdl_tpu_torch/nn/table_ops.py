"""Table ops of the slice (counterpart of bigdl_tpu/nn/table_ops.py)."""
from __future__ import annotations

import functools

import torch

from bigdl_tpu_torch.nn.module import Module


class CAddTable(Module):
    """Element-wise sum of a list of tensors."""

    def forward(self, xs):
        return functools.reduce(torch.add, xs)
