"""Spatial convolution (counterpart of bigdl_tpu/nn/conv.py
``SpatialConvolution``; ref SpatialConvolution.scala:31).

The JAX package convolves outside any Pallas kernel (XLA), so the port
calls ``F.conv2d``; TF32 stays off on the card (``utils.device.pin_fp32``).
The TPU-only forms of the JAX module (the 1x1-as-dot and space-to-depth
stem rewrites) are not ported: they are the same math.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import TensorModule


class SpatialConvolution(TensorModule):
    """2D convolution over NCHW (or one CHW sample) with ``weight``
    (O, I/groups, kh, kw) and ``bias`` (O,).  ``init_method`` Default
    draws both Torch-style from U(-1/sqrt(kw*kh*I), 1/sqrt(kw*kh*I));
    Xavier draws the weight with fan-in (I/groups)*kh*kw and fan-out
    (O/groups)*kh*kw and zeroes the bias; MSRA draws it from N(0,
    sqrt(2/(kw*kh*O))) and zeroes the bias.  Arguments follow the
    reference constructor."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, with_bias: bool = True,
                 init_method: str = init_.Default, device=None,
                 generator=None):
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
        self.init_method = init_method
        shape = (n_output_plane, n_input_plane // n_group, kernel_h,
                 kernel_w)
        if init_method == init_.Xavier:
            area = kernel_h * kernel_w
            weight = init_.xavier(shape, n_input_plane // n_group * area,
                                  n_output_plane // n_group * area,
                                  generator)
            bias = torch.zeros(n_output_plane)
        elif init_method == init_.MSRA:
            weight = init_.msra(shape, kernel_w * kernel_h * n_output_plane,
                                generator)
            bias = torch.zeros(n_output_plane)
        elif init_method == init_.Default:
            stdv = 1.0 / math.sqrt(kernel_w * kernel_h * n_input_plane)
            weight = init_.uniform(shape, -stdv, stdv, generator)
            bias = (init_.uniform((n_output_plane,), -stdv, stdv, generator)
                    if with_bias else None)
        else:
            raise ValueError(f"SpatialConvolution: no init method "
                             f"{init_method!r} in this port")
        self._add_param("weight", weight, device)
        if with_bias:
            self._add_param("bias", bias, device)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        was3d = x.dim() == 3
        y = F.conv2d(x[None] if was3d else x, self.weight, self.bias,
                     stride=(self.stride_h, self.stride_w),
                     padding=(self.pad_h, self.pad_w), groups=self.n_group)
        return y[0] if was3d else y

    def extra_repr(self) -> str:
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, {self.stride_w},"
                f"{self.stride_h}, {self.pad_w},{self.pad_h}")
