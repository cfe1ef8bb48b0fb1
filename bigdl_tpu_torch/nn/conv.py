"""Spatial convolution family (counterpart of bigdl_tpu/nn/conv.py):
SpatialConvolution, SpatialShareConvolution, SpatialDilatedConvolution,
SpatialFullConvolution and SpatialConvolutionMap (ref
SpatialConvolution.scala:31 and its siblings).

The JAX package convolves outside any Pallas kernel (XLA), so the port
calls ``F.conv2d`` and ``F.conv_transpose2d``, under the dtype policy
(``_conv``); TF32 stays off on the card (``utils.device.pin_fp32``).  The TPU-only forms of the JAX module
(the 1x1-as-dot and space-to-depth stem rewrites) are not ported: they
are the same math.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import TensorModule, device_constant
from bigdl_tpu_torch.parallel import collectives as coll
from bigdl_tpu_torch.tensor import policy
from bigdl_tpu_torch.utils.device import resolve_device


def _conv(fn, x, weight, bias=None, **kw):
    """``fn`` (``F.conv2d`` or ``F.conv_transpose2d``) under the dtype
    policy (bigdl_tpu/nn/conv.py ``_conv``): under a reduced policy both
    operands in the compute dtype, the result in the output dtype, then
    the bias added (an f32 bias promotes a bf16 result to f32, as in the
    JAX package).  No f32 accumulation type is asked for, as there:
    cuDNN accumulates a bf16 convolution in f32 and returns bf16, the
    same function.  Under FP32 the plain call."""
    p = policy()
    if not p.reduced:
        return fn(x, weight, bias, **kw)
    y = fn(p.cast_compute(x), p.cast_compute(weight), **kw).to(
        p.output_dtype)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


class SpatialConvolution(TensorModule):
    """2D convolution over NCHW (or one CHW sample) with ``weight``
    (O, I/groups, kh, kw) and ``bias`` (O,).  ``init_method`` Default
    draws both Torch-style from U(-1/sqrt(kw*kh*I), 1/sqrt(kw*kh*I));
    Xavier draws the weight with fan-in (I/groups)*kh*kw and fan-out
    (O/groups)*kh*kw and zeroes the bias; MSRA draws it from N(0,
    sqrt(2/(kw*kh*O))) and zeroes the bias.  Arguments follow the
    reference constructor, in the JAX module's order; ``propagate_back``
    is accepted for its signature and, as there, changes nothing.

    Under tensor parallelism ``model_axis`` (set by the
    ``DistriOptimizer`` for the run, on an ungrouped convolution) says
    that this rank holds its output planes of the weight: the layer
    computes those planes and gathers them, as ``Linear`` does."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 init_method: str = init_.Default, with_bias: bool = True,
                 device=None, generator=None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"SpatialConvolution: {n_input_plane} -> "
                             f"{n_output_plane} planes do not split into "
                             f"{n_group} groups")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.init_method = init_method
        self.with_bias = with_bias
        draws = self._draw(generator)
        self._add_param("weight", draws["weight"], device)
        if with_bias:
            self._add_param("bias", draws["bias"], device)
        else:
            self.bias = None
        self.model_axis = None

    def _draw(self, generator=None) -> dict:
        """The initial values (``Module.reset`` draws them again)."""
        n_in, n_out, g = self.n_input_plane, self.n_output_plane, self.n_group
        kw, kh = self.kernel_w, self.kernel_h
        shape = (n_out, n_in // g, kh, kw)
        if self.init_method == init_.Xavier:
            return {"weight": init_.xavier(shape, n_in // g * kh * kw,
                                           n_out // g * kh * kw, generator),
                    "bias": torch.zeros(n_out)}
        if self.init_method == init_.MSRA:
            return {"weight": init_.msra(shape, kw * kh * n_out, generator),
                    "bias": torch.zeros(n_out)}
        if self.init_method != init_.Default:
            raise ValueError(f"SpatialConvolution: no init method "
                             f"{self.init_method!r} in this port")
        stdv = 1.0 / math.sqrt(kw * kh * n_in)
        out = {"weight": init_.uniform(shape, -stdv, stdv, generator)}
        if self.with_bias:
            out["bias"] = init_.uniform((n_out,), -stdv, stdv, generator)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        was3d = x.dim() == 3
        x = x[None] if was3d else x
        axis = self.model_axis
        if axis is None or axis.size == 1:
            y = _conv(F.conv2d, x, self.weight, self.bias,
                      stride=(self.stride_h, self.stride_w),
                      padding=(self.pad_h, self.pad_w), groups=self.n_group)
        else:
            y = coll.gather_dim(_conv(
                F.conv2d, coll.sum_grad(x, axis), self.weight,
                stride=(self.stride_h, self.stride_w),
                padding=(self.pad_h, self.pad_w)), axis, 1)
            if self.bias is not None:
                y = y + self.bias.view(1, -1, 1, 1)
        return y[0] if was3d else y

    def extra_repr(self) -> str:
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, {self.stride_w},"
                f"{self.stride_h}, {self.pad_w},{self.pad_h}")


def _batched(x):
    """(4-D input, whether it was one 3-D sample)."""
    return (x[None], True) if x.dim() == 3 else (x, False)


class SpatialShareConvolution(SpatialConvolution):
    """The reference's convolution that shares its im2col buffers across
    layers to save JVM memory (SpatialShareConvolution.scala): here, as in
    the JAX package, the same layer as ``SpatialConvolution``."""


class SpatialDilatedConvolution(TensorModule):
    """Atrous convolution (ref SpatialDilatedConvolution.scala): ``weight``
    (O, I, kh, kw) and ``bias`` (O,), drawn U(-1/sqrt(I*kh*kw), ...) by
    default, or Xavier with a zero bias."""

    def __init__(self, n_input_plane: int, n_output_plane: int, kw: int,
                 kh: int, dw: int = 1, dh: int = 1, pad_w: int = 0,
                 pad_h: int = 0, dilation_w: int = 1, dilation_h: int = 1,
                 init_method: str = init_.Default, device="cuda",
                 generator=None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        self.init_method = init_method
        dev = resolve_device(device)
        for k, v in self._draw(generator).items():
            self._add_param(k, v, dev)

    def _draw(self, generator=None) -> dict:
        n_in, n_out, kh, kw = (self.n_input_plane, self.n_output_plane,
                               self.kh, self.kw)
        shape = (n_out, n_in, kh, kw)
        fan_in = n_in * kh * kw
        if self.init_method == init_.Xavier:
            return {"weight": init_.xavier(shape, fan_in, n_out * kh * kw,
                                           generator),
                    "bias": torch.zeros(n_out)}
        stdv = 1.0 / math.sqrt(fan_in)
        w = init_.uniform(shape, -stdv, stdv, generator)
        return {"weight": w,
                "bias": init_.uniform((n_out,), -stdv, stdv, generator)}

    def forward(self, x):
        x, was3d = _batched(x)
        y = _conv(F.conv2d, x, self.weight, self.bias,
                  stride=(self.dh, self.dw), padding=(self.pad_h, self.pad_w),
                  dilation=(self.dilation_h, self.dilation_w))
        return y[0] if was3d else y


class SpatialFullConvolution(TensorModule):
    """Transposed convolution (ref SpatialFullConvolution.scala): out =
    (in - 1) * stride - 2 * pad + kernel + adj, in ``n_group`` groups.

    The weight is stored Torch-style, (nInputPlane, nOutputPlane /
    nGroup, kH, kW), as the JAX module stores it; that is the layout
    ``F.conv_transpose2d`` takes, so it goes in as it is (the JAX module
    flips it and swaps its channels for an input-dilated convolution: the
    same function).  ``init_method`` BilinearFiller gives every plane the
    bilinear upsampling kernel and a zero bias; the default draws both
    U(-1/sqrt(I/g*kh*kw), ...)."""

    def __init__(self, n_input_plane: int, n_output_plane: int, kw: int,
                 kh: int, dw: int = 1, dh: int = 1, pad_w: int = 0,
                 pad_h: int = 0, adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 init_method: str = init_.Default, device="cuda",
                 generator=None):
        super().__init__()
        if adj_w >= dw or adj_h >= dh:
            raise ValueError("SpatialFullConvolution: adjW/adjH must be "
                             "smaller than the strides")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.no_bias = no_bias
        self.init_method = init_method
        draws = self._draw(generator)
        dev = resolve_device(device)
        self._add_param("weight", draws["weight"], dev)
        if no_bias:
            self.bias = None
        else:
            self._add_param("bias", draws["bias"], dev)

    def _draw(self, generator=None) -> dict:
        n_in, n_out, g = self.n_input_plane, self.n_output_plane, self.n_group
        shape = (n_in, n_out // g, self.kh, self.kw)
        if self.init_method == init_.BilinearFiller:
            return {"weight": init_.bilinear_filler(shape),
                    "bias": torch.zeros(n_out)}
        stdv = 1.0 / math.sqrt((n_in // g) * self.kh * self.kw)
        w = init_.uniform(shape, -stdv, stdv, generator)
        return {"weight": w,
                "bias": init_.uniform((n_out,), -stdv, stdv, generator)}

    def forward(self, x):
        x, was3d = _batched(x)
        y = _conv(F.conv_transpose2d, x, self.weight, self.bias,
                  stride=(self.dh, self.dw), padding=(self.pad_h, self.pad_w),
                  output_padding=(self.adj_h, self.adj_w),
                  groups=self.n_group)
        return y[0] if was3d else y


class SpatialConvolutionMap(TensorModule):
    """Convolution over an explicit connection table (ref
    SpatialConvolutionMap.scala): ``conn_table`` holds 1-based (from
    plane, to plane) pairs; ``weight`` is dense (O, I, kh, kw) and the
    forward multiplies it by the table's 0/1 mask, as the JAX module does,
    so a weight outside the table has gradient 0.  Each output plane's
    weights and bias are drawn U(-1, 1) / sqrt(its fan-in), the fan-in
    its connections times kw*kh, the weight masked."""

    def __init__(self, conn_table, kw: int, kh: int, dw: int = 1,
                 dh: int = 1, pad_w: int = 0, pad_h: int = 0, device="cuda",
                 generator=None):
        super().__init__()
        conn = np.asarray(conn_table, np.int64).reshape(-1, 2)
        self.conn_table = conn
        self.n_input_plane = int(conn[:, 0].max())
        self.n_output_plane = int(conn[:, 1].max())
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        mask = torch.zeros(self.n_output_plane, self.n_input_plane, 1, 1)
        for f, t in conn:
            mask[t - 1, f - 1] = 1.0
        self.mask = mask
        dev = resolve_device(device)
        for k, v in self._draw(generator).items():
            self._add_param(k, v, dev)

    def _draw(self, generator=None) -> dict:
        mask = self.mask
        fan_in = mask.sum((1, 2, 3)).clamp_min(1.0) * (self.kw * self.kh)
        stdv = 1.0 / fan_in.sqrt()
        weight = init_.uniform((self.n_output_plane, self.n_input_plane,
                                self.kh, self.kw), -1.0, 1.0, generator)
        bias = init_.uniform((self.n_output_plane,), -1.0, 1.0, generator)
        return {"weight": weight * stdv[:, None, None, None] * mask,
                "bias": bias * stdv}

    @staticmethod
    def full(n_in: int, n_out: int) -> np.ndarray:
        """Every input plane to every output plane."""
        return np.array([(i + 1, o + 1) for o in range(n_out)
                         for i in range(n_in)])

    @staticmethod
    def one_to_one(n: int) -> np.ndarray:
        return np.array([(i + 1, i + 1) for i in range(n)])

    @staticmethod
    def random(n_in: int, n_out: int, n_to: int, rng) -> np.ndarray:
        """``n_to`` distinct input planes, drawn from ``rng`` (a
        ``np.random.RandomState``), into each output plane."""
        pairs = []
        for o in range(n_out):
            ins = rng.choice(n_in, size=n_to, replace=False)
            pairs += [(int(i) + 1, o + 1) for i in ins]
        return np.array(pairs)

    def forward(self, x):
        x, was3d = _batched(x)
        w = self.weight * device_constant(self, "mask", self.mask,
                                          self.weight.device)
        y = _conv(F.conv2d, x, w, self.bias, stride=(self.dh, self.dw),
                  padding=(self.pad_h, self.pad_w))
        return y[0] if was3d else y
