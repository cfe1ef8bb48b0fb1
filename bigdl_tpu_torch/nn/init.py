"""Weight initialisers (counterpart of bigdl_tpu/nn/init.py).

Each draws on the CPU in float32 from an explicit ``torch.Generator``
(``None``: PyTorch's default generator); the module moves the result to
its device.
"""
from __future__ import annotations

import math

import torch

#: initialisation methods a layer takes (bigdl_tpu/nn/init.py:20-23)
Default = "default"
Xavier = "xavier"
MSRA = "msra"   # He init, the reference's ResNet (ResNet.scala:102)


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
