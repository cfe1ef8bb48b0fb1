"""Multi-head self-attention and the sinusoidal position table
(counterpart of bigdl_tpu/nn/attention.py)."""
from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.parallel.ring_attention import full_attention


class MultiHeadSelfAttention(TensorModule):
    """(B, T, D) -> (B, T, D).  ``wq/wk/wv/wo`` are (D, D) applied as
    ``x @ W`` (the transpose of Linear's layout), with biases."""

    def __init__(self, d_model: int, n_heads: int, causal: bool = False,
                 device=None, generator=None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model ({d_model}) must divide by "
                             f"n_heads ({n_heads})")
        self.d_model = d_model
        self.n_heads = n_heads
        self.causal = causal
        for name in ("wq", "wk", "wv", "wo"):
            self._add_param(name, init_.default_linear(
                (d_model, d_model), d_model, generator), device)
            self._add_param(name.replace("w", "b"), torch.zeros(d_model),
                            device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_heads

        def proj(w, bias):
            return (x @ w + bias).reshape(b, t, h, d // h)

        o = full_attention(proj(self.wq, self.bq), proj(self.wk, self.bk),
                           proj(self.wv, self.bv), causal=self.causal)
        return o.reshape(b, t, d) @ self.wo + self.bo

    def extra_repr(self) -> str:
        return (f"{self.d_model}, heads={self.n_heads}"
                f"{', causal' if self.causal else ''}")


class SinusoidalPositionalEncoding(TensorModule):
    """x + PE[:T] with the standard sin/cos table (parameter-free)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def table(self, t: int) -> torch.Tensor:
        """The (t, d_model) fp32 table on the CPU, computed in float64
        numpy exactly as the JAX package does, so both packages add
        bit-identical positions."""
        d = self.d_model
        ang = np.arange(t)[:, None] * np.exp(
            np.arange(0, d, 2) * (-np.log(10000.0) / d))
        pe = np.zeros((t, d), np.float32)
        pe[:, 0::2] = np.sin(ang)
        pe[:, 1::2] = np.cos(ang[:, :d // 2])
        return torch.from_numpy(pe)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, d = x.shape[1], x.shape[2]
        if d != self.d_model:
            raise ValueError(f"input dim {d} != d_model {self.d_model}")
        return x + self.table(t).to(device=x.device, dtype=x.dtype)
