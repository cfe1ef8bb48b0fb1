"""Max and average pooling (counterpart of bigdl_tpu/nn/pooling.py
``SpatialMaxPooling`` and ``SpatialAveragePooling``; ref
SpatialMaxPooling.scala:279, SpatialAveragePooling.scala:458).

Every max pool goes through a kernel: a stride-1 pool through
``ops.maxpool2d_s1`` (the backward recomputes the first max from x, which
the next layer keeps anyway: no argmax is stored), every other through
``ops.maxpool2d`` (argmax-storing forward, gather backward).  Both take
the first-max tie rule of the JAX package's Mosaic route and its NaN rule
(a NaN counts only at a window's first tap), so the module's answer does
not depend on which kernel runs.  None of the JAX module's TPU route
flags is ported.  Ceil-mode output sizing follows Torch: the last window
may start in the padding but must begin inside the input plus its left
pad.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.ops import maxpool2d, maxpool2d_s1


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
        pads = _pads(self, x.shape[2:])
        x = x.contiguous()
        if (self.dh, self.dw) == (1, 1):
            y = maxpool2d_s1(x, (self.kh, self.kw), pads)
        else:
            y = maxpool2d(x, (self.kh, self.kw), (self.dh, self.dw), pads)
        return y[0] if was3d else y

    def extra_repr(self) -> str:
        return f"{self.kw}x{self.kh}, {self.dw},{self.dh}"


def _pads(pool, hw):
    """((lo_h, hi_h), (lo_w, hi_w)) of ``pool`` over an (H, W) plane."""
    h, w = hw
    oh = _pool_out_size(h, pool.kh, pool.dh, pool.pad_h, pool.ceil_mode)
    ow = _pool_out_size(w, pool.kw, pool.dw, pool.pad_w, pool.ceil_mode)
    return (_pad_amounts(h, pool.kh, pool.dh, pool.pad_h, oh),
            _pad_amounts(w, pool.kw, pool.dw, pool.pad_w, ow))


class SpatialAveragePooling(TensorModule):
    """Window average over NCHW (or one CHW sample), the JAX module's
    arithmetic: explicit (lo, hi) zero pads sized by the Torch rule, a
    window sum, then division by kh*kw (``count_include_pad``, the
    padding and a ceil-mode overhang counted) or by each window's count
    of real elements; ``divide=False`` keeps the sum.
    ``F.avg_pool2d(ceil_mode=True)`` would leave the overhang out of the
    divisor."""

    def __init__(self, kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0, ceil_mode: bool = False,
                 count_include_pad: bool = True, divide: bool = True):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide

    def ceil(self):
        self.ceil_mode = True
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        was3d = x.dim() == 3
        if was3d:
            x = x[None]
        (plh, phh), (plw, phw) = _pads(self, x.shape[2:])

        def wsum(v):
            return F.avg_pool2d(F.pad(v, (plw, phw, plh, phh)),
                                (self.kh, self.kw), (self.dh, self.dw),
                                divisor_override=1)

        y = wsum(x)
        if self.divide:
            if self.count_include_pad:
                y = y / float(self.kh * self.kw)
            else:
                y = y / wsum(torch.ones((1, 1) + x.shape[2:], dtype=x.dtype,
                                        device=x.device))
        return y[0] if was3d else y

    def extra_repr(self) -> str:
        return f"{self.kw}x{self.kh}, {self.dw},{self.dh}"
