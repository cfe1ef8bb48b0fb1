"""Linear layer (counterpart of bigdl_tpu/nn/linear.py ``Linear``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import TensorModule


class Linear(TensorModule):
    """y = x W^T + b with ``weight`` (out, in), ``bias`` (out,)."""

    def __init__(self, input_size: int, output_size: int, device=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self._add_param("weight", init_.default_linear(
            (output_size, input_size), input_size, generator), device)
        self._add_param("bias", init_.default_linear(
            (output_size,), input_size, generator), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return f"{self.input_size} -> {self.output_size}"
