"""Max, average and region-of-interest pooling (counterpart of
bigdl_tpu/nn/pooling.py ``SpatialMaxPooling``, ``SpatialAveragePooling``
and ``RoiPooling``; ref SpatialMaxPooling.scala:279,
SpatialAveragePooling.scala:458, RoiPooling.scala:363).

Every max pool goes through a kernel: a stride-1 pool through
``ops.maxpool2d_s1`` (the backward recomputes the first max from x, which
the next layer keeps anyway: no argmax is stored), every other through
``ops.maxpool2d`` (argmax-storing forward, gather backward).  Both take
the first-max tie rule of the JAX package's Mosaic route and its NaN rule
(a NaN counts only at a window's first tap), so the module's answer does
not depend on which kernel runs.  None of the JAX module's TPU route
flags is ported.  Under a reduced dtype policy an f32 input is pooled in
the compute dtype (the kernels' bf16 forms) and the result cast back, as
the JAX ``_max_pool2d`` does: the max of bf16 values is the bf16 of the
f32 max, so only the argmax of a rounding tie can differ; a bf16 input
is pooled as it is, and an input of any other dtype is never cast.

Ceil-mode output sizing follows Torch: the last window may start in the
padding but must begin inside the input plus its left pad.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module, TensorModule
from bigdl_tpu_torch.ops import maxpool2d, maxpool2d_s1
from bigdl_tpu_torch.tensor import policy
from bigdl_tpu_torch.utils.table import as_table


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
        p = policy()
        cast = x.dtype == torch.float32 and p.compute_dtype != torch.float32
        xin = (x.to(p.compute_dtype) if cast else x).contiguous()
        if (self.dh, self.dw) == (1, 1):
            y = maxpool2d_s1(xin, (self.kh, self.kw), pads)
        else:
            y = maxpool2d(xin, (self.kh, self.kw), (self.dh, self.dw), pads)
        y = y.to(x.dtype) if cast else y
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


class RoiPooling(Module):
    """Region-of-interest max pooling (ref RoiPooling.scala:363).

    Input: Table(features (N, C, H, W), rois (R, 5)), each roi row
    [batch index (0-based, as the reference's), x1, y1, x2, y2] in image
    coordinates, scaled by ``spatial_scale`` and rounded half up
    (``floor(v + 0.5)``, the reference's ``Math.round``).  Output: (R, C,
    pooled_h, pooled_w), a bin that holds no pixel 0.  The bins' bounds
    are the JAX module's, in float32.

    The JAX module takes each bin's maximum over the whole feature map
    under a (R, PH, PW, C, H, W) mask, which at Fast R-CNN's size (128
    rois, 7x7 bins, 512 x 38 x 50) would be about 24 GB.  A rectangle's
    maximum is the maximum over its rows of each row's maximum over its
    columns, so the port takes the two in turn: for each column bin the
    maximum of every row over its columns (R, C, H) under a (R, 1, 1, W)
    mask, then for each row bin the maximum of those over its rows.  The
    forward is the same function; the gradient of a tie is split evenly
    at each stage (``amax``), so where the tied entries of a bin lie in
    rows holding different numbers of them, the split differs from the
    JAX module's one even split over the bin."""

    def __init__(self, pooled_w: int, pooled_h: int, spatial_scale: float):
        super().__init__()
        self.pooled_w = pooled_w
        self.pooled_h = pooled_h
        self.spatial_scale = spatial_scale

    def _bins(self, rois, h, w):
        """The bins' [start, end) rows (R, PH) and columns (R, PW)."""
        f32 = torch.float32
        r = rois.to(f32)
        x1, y1, x2, y2 = (torch.floor(r[:, i] * self.spatial_scale + 0.5)
                          for i in (1, 2, 3, 4))
        # divided by a tensor: on the card a division by a host scalar is
        # a product with its reciprocal, which can put a bin's bound one
        # pixel off the correctly rounded quotient
        def divisor(v):
            return torch.full((), float(v), dtype=f32, device=rois.device)

        bin_w = torch.clamp_min(x2 - x1 + 1.0, 1.0) / divisor(self.pooled_w)
        bin_h = torch.clamp_min(y2 - y1 + 1.0, 1.0) / divisor(self.pooled_h)
        ph = torch.arange(self.pooled_h, dtype=f32, device=rois.device)
        pw = torch.arange(self.pooled_w, dtype=f32, device=rois.device)

        def bounds(p, size, start):
            lo = torch.floor(p[None] * size[:, None] + start[:, None])
            hi = torch.ceil((p[None] + 1) * size[:, None] + start[:, None])
            return lo, hi

        hs, he = bounds(ph, bin_h, y1)
        ws, we = bounds(pw, bin_w, x1)
        return (hs.clamp(0, h), he.clamp(0, h), ws.clamp(0, w),
                we.clamp(0, w))

    def forward(self, x):
        x = as_table(x)
        data, rois = x[1], torch.as_tensor(x[2], device=x[1].device)
        h, w = data.shape[2], data.shape[3]
        hs, he, ws, we = self._bins(rois, h, w)
        feats = data[rois[:, 0].long()]                    # (R, C, H, W)
        ys = torch.arange(h, dtype=torch.float32, device=data.device)
        xs = torch.arange(w, dtype=torch.float32, device=data.device)
        neg = torch.tensor(float("-inf"), dtype=data.dtype,
                           device=data.device)
        cols = []
        for j in range(self.pooled_w):
            inside = (xs >= ws[:, j, None]) & (xs < we[:, j, None])  # (R, W)
            cols.append(torch.amax(torch.where(
                inside[:, None, None, :], feats, neg), dim=3))
        cols = torch.stack(cols, dim=3)                    # (R, C, H, PW)
        rows = []
        for i in range(self.pooled_h):
            inside = (ys >= hs[:, i, None]) & (ys < he[:, i, None])  # (R, H)
            rows.append(torch.amax(torch.where(
                inside[:, None, :, None], cols, neg), dim=2))
        out = torch.stack(rows, dim=2)                     # (R, C, PH, PW)
        return torch.where(torch.isfinite(out), out, 0.0)

    def extra_repr(self) -> str:
        return (f"{self.pooled_w}x{self.pooled_h}, "
                f"scale {self.spatial_scale}")
