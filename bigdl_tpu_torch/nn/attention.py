"""Multi-head self-attention and the sinusoidal position table
(counterpart of bigdl_tpu/nn/attention.py).

Both layers have a sequence-parallel form.  The JAX layer learns of the
trainer's mesh through ``Context.seq_mesh``; here
``DistriOptimizer(sequence_parallel=True)`` sets each layer's
``seq_axis`` (the mesh's ``seq`` ``Axis``) for the run and clears it
after.  With it set, each rank holds block ``index`` of the time
dimension: the attention runs the ring (``parallel/ring_attention.py``)
and the position table adds the block's global rows.  On an axis of one
rank both take their plain path.

The attention also has a tensor-parallel form: with ``model_axis`` set
(by ``DistriOptimizer(tensor_parallel=True)``) this rank holds its rows
of ``wq/wk/wv/wo``, stored (in, out), so its part of each product's
input: each projection is this rank's columns of the input times its
rows, summed over the axis (row-parallel), the bias added after.

Under a reduced dtype policy (bigdl_tpu/nn/attention.py:60-91) the
projections take their operands in the compute dtype and stay in it,
their biases too, through the attention core, whose scores and softmax
statistics are f32 (``full_attention``, the ring); the output projection
comes back in the output dtype before its bias.
"""
from __future__ import annotations

import numpy as np
import torch

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.parallel import collectives as coll
from bigdl_tpu_torch.parallel.ring_attention import (full_attention,
                                                     ring_attention)
from bigdl_tpu_torch.tensor import policy


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
        for k, v in self._draw(generator).items():
            self._add_param(k, v, device)
        self.seq_axis = None
        self.model_axis = None

    def _draw(self, generator=None) -> dict:
        """The initial values (``Module.reset`` draws them again)."""
        d, out = self.d_model, {}
        for name in ("wq", "wk", "wv", "wo"):
            out[name] = init_.default_linear((d, d), d, generator)
            out[name.replace("w", "b")] = torch.zeros(d)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_heads
        axis = self.model_axis
        if axis is not None and axis.size == 1:
            axis = None
        p = policy()

        def product(a, w):
            if p.reduced:
                a, w = p.cast_compute(a), p.cast_compute(w)
            if axis is None:
                return a @ w
            return coll.sum_forward(coll.split_dim(a, axis, -1) @ w, axis)

        def proj(w, bias):
            y = product(x, w)
            return (y + bias.to(y.dtype)).reshape(b, t, h, d // h)

        q, k, v = (proj(self.wq, self.bq), proj(self.wk, self.bk),
                   proj(self.wv, self.bv))
        ring = self.seq_axis
        if ring is not None and ring.size > 1:
            o = ring_attention(q, k, v, ring, causal=self.causal)
        else:
            o = full_attention(q, k, v, causal=self.causal)
        y = product(o.reshape(b, t, d), self.wo)
        return (y.to(p.output_dtype) if p.reduced else y) + self.bo

    def extra_repr(self) -> str:
        return (f"{self.d_model}, heads={self.n_heads}"
                f"{', causal' if self.causal else ''}")


class SinusoidalPositionalEncoding(TensorModule):
    """x + PE[:T] with the standard sin/cos table (parameter-free), its
    wavelengths a geometric series up to ``base``."""

    def __init__(self, d_model: int, base: float = 10000.0):
        super().__init__()
        self.d_model = d_model
        self.base = base
        self.seq_axis = None

    def table(self, t: int) -> torch.Tensor:
        """The (t, d_model) fp32 table on the CPU, computed in float64
        numpy exactly as the JAX package does, so both packages add
        bit-identical positions."""
        d = self.d_model
        ang = np.arange(t)[:, None] * np.exp(
            np.arange(0, d, 2) * (-np.log(self.base) / d))
        pe = np.zeros((t, d), np.float32)
        pe[:, 0::2] = np.sin(ang)
        pe[:, 1::2] = np.cos(ang[:, :d // 2])
        return torch.from_numpy(pe)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, d = x.shape[1], x.shape[2]
        if d != self.d_model:
            raise ValueError(f"input dim {d} != d_model {self.d_model}")
        ring = self.seq_axis
        if ring is None or ring.size == 1:
            pe = self.table(t)
        else:
            # this rank's block of the time dimension: its global rows
            pe = self.table(t * ring.size)[ring.index * t:(ring.index + 1) * t]
        return x + pe.to(device=x.device, dtype=x.dtype)
