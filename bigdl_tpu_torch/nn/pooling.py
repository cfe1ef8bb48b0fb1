"""Max pooling (counterpart of bigdl_tpu/nn/pooling.py
``SpatialMaxPooling``; ref SpatialMaxPooling.scala:279).

Every pool goes through ``ops.maxpool2d``: on the card that is the
hand-written CUDA pair (argmax-storing forward, gather backward), with
the first-max tie rule of the JAX package's Mosaic route.  None of the
JAX module's TPU route flags is ported.  Ceil-mode output sizing follows
Torch: the last window may start in the padding but must begin inside
the input plus its left pad.
"""
from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.ops import maxpool2d


def _pool_out_size(in_size, k, stride, pad, ceil_mode):
    rnd = math.ceil if ceil_mode else math.floor
    out = int(rnd((in_size - k + 2 * pad) / stride)) + 1
    if pad > 0 and (out - 1) * stride >= in_size + pad:
        out -= 1  # last window must start inside input+left-pad (Torch)
    return out


def _pad_amounts(in_size, k, stride, pad, out):
    """(lo, hi) padding so the pool emits exactly ``out`` windows."""
    needed = (out - 1) * stride + k
    return pad, max(needed - in_size - pad, 0)


class SpatialMaxPooling(TensorModule):
    def __init__(self, kw: int, kh: int, dw: int = None, dh: int = None,
                 pad_w: int = 0, pad_h: int = 0):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        was3d = x.dim() == 3
        if was3d:
            x = x[None]
        h, w = x.shape[2:]
        oh = _pool_out_size(h, self.kh, self.dh, self.pad_h, self.ceil_mode)
        ow = _pool_out_size(w, self.kw, self.dw, self.pad_w, self.ceil_mode)
        pads = (_pad_amounts(h, self.kh, self.dh, self.pad_h, oh),
                _pad_amounts(w, self.kw, self.dw, self.pad_w, ow))
        y = maxpool2d(x.contiguous(), (self.kh, self.kw), (self.dh, self.dw),
                      pads)
        return y[0] if was3d else y

    def extra_repr(self) -> str:
        return f"{self.kw}x{self.kh}, {self.dw},{self.dh}"
