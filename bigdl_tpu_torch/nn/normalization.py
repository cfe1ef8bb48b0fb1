"""LayerNorm and cross-channel LRN (counterpart of
bigdl_tpu/nn/normalization.py ``LayerNorm`` and ``SpatialCrossMapLRN``)."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.ops import lrn_channel


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


class SpatialCrossMapLRN(TensorModule):
    """Local response normalisation across channels (ref
    SpatialCrossMapLRN.scala:221):
    y = x / (k + alpha/size * sum_{window} x^2) ** beta, the window of
    ``size`` channels padded ((size-1)//2, size-1-lo).  Every NCHW input
    (or one CHW sample) goes through ``ops.lrn_channel``: the hand-written
    kernel pair on the card, the plain version on the CPU.  The JAX
    module's route flags and its compute-dtype cast are not ported."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        was3d = x.dim() == 3
        y = lrn_channel((x[None] if was3d else x).contiguous(), self.size,
                        self.alpha, self.beta, self.k)
        return y[0] if was3d else y

    def extra_repr(self) -> str:
        return f"{self.size}, {self.alpha}, {self.beta}, {self.k}"
