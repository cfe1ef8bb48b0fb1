"""LayerNorm (counterpart of bigdl_tpu/nn/normalization.py ``LayerNorm``)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import TensorModule


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * weight + bias over the last dim,
    with the population variance — the decode step's formula
    (bigdl_tpu/models/transformer.py ``_lm_forward_window``)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


class LayerNorm(TensorModule):
    """Layer normalisation over the trailing feature dim, stats in fp32."""

    def __init__(self, d_model: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.d_model = d_model
        self.eps = eps
        self._add_param("weight", torch.ones(d_model), device)
        self._add_param("bias", torch.zeros(d_model), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = layer_norm(x.float(), self.weight, self.bias, self.eps)
        return y.to(x.dtype)
