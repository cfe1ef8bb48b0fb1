"""Weight initialisers (counterpart of bigdl_tpu/nn/init.py).

Each random one draws on the CPU in float32 from an explicit
``torch.Generator`` (``None``: PyTorch's default generator); the module
moves the result to its device.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class InitializationMethod:
    """The initialisation methods a layer takes (ref
    InitializationMethod.scala:23; bigdl_tpu/nn/init.py:14-23)."""
    DEFAULT = "default"
    XAVIER = "xavier"
    BILINEAR_FILLER = "bilinearfiller"
    MSRA = "msra"   # He init, the reference's ResNet (ResNet.scala:102)


Default = InitializationMethod.DEFAULT
Xavier = InitializationMethod.XAVIER
BilinearFiller = InitializationMethod.BILINEAR_FILLER
MSRA = InitializationMethod.MSRA


def uniform(shape, a: float, b: float, generator=None) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(
        a, b, generator=generator)


def normal(shape, mean: float, stdv: float, generator=None) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).normal_(
        mean, stdv, generator=generator)


def default_linear(shape, fan_in: int, generator=None) -> torch.Tensor:
    """Torch nn.Linear default: U(-1/sqrt(fanIn), 1/sqrt(fanIn))."""
    stdv = 1.0 / math.sqrt(fan_in)
    return uniform(shape, -stdv, stdv, generator)


def xavier(shape, fan_in: int, fan_out: int, generator=None) -> torch.Tensor:
    """Xavier/Glorot: U(-sqrt(6/(fanIn+fanOut)), sqrt(6/(fanIn+fanOut)))."""
    stdv = math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(shape, -stdv, stdv, generator)


def msra(shape, fan_out_spatial: int, generator=None) -> torch.Tensor:
    """He/MSRA: N(0, sqrt(2/n)), n = kw*kh*nOutputPlane (ref
    ResNet.modelInit ResNet.scala:102-132)."""
    return normal(shape, 0.0, math.sqrt(2.0 / fan_out_spatial), generator)


def bilinear_filler(shape) -> torch.Tensor:
    """The bilinear upsampling kernel of a deconvolution (ref
    InitializationMethod BilinearFiller), the same in every (out, in)
    plane of the 4-D ``shape``; no draw."""
    if len(shape) != 4:
        raise ValueError(f"bilinear filler expects (out, in, kh, kw), got "
                         f"{tuple(shape)}")
    kh, kw = shape[2], shape[3]
    f_h, f_w = np.ceil(kh / 2.0), np.ceil(kw / 2.0)
    c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
    c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
    ys = np.arange(kh)[:, None]
    xs = np.arange(kw)[None, :]
    k = (1 - np.abs(ys / f_h - c_h)) * (1 - np.abs(xs / f_w - c_w))
    return torch.from_numpy(
        np.broadcast_to(k, tuple(shape)).astype(np.float32).copy())
