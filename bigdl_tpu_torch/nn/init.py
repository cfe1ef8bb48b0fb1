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


def uniform(shape, a: float, b: float, generator=None) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(
        a, b, generator=generator)


def default_linear(shape, fan_in: int, generator=None) -> torch.Tensor:
    """Torch nn.Linear default: U(-1/sqrt(fanIn), 1/sqrt(fanIn))."""
    stdv = 1.0 / math.sqrt(fan_in)
    return uniform(shape, -stdv, stdv, generator)


def xavier(shape, fan_in: int, fan_out: int, generator=None) -> torch.Tensor:
    """Xavier/Glorot: U(-sqrt(6/(fanIn+fanOut)), sqrt(6/(fanIn+fanOut)))."""
    stdv = math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(shape, -stdv, stdv, generator)
