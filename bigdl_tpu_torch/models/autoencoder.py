"""Autoencoder on MNIST (counterpart of bigdl_tpu/models/autoencoder.py;
ref models/autoencoder/Autoencoder.scala:28): 784 -> class_num -> 784
with a sigmoid reconstruction, trained with MSE against the input."""
from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.utils.device import resolve_device

ROW_N = 28
COL_N = 28
FEATURE_SIZE = ROW_N * COL_N


def Autoencoder(class_num: int = 32, device="cuda", generator=None):
    """(ref Autoencoder.scala:28-36)"""
    dev = dict(device=resolve_device(device), generator=generator)
    return nn.Sequential(
        nn.Reshape([FEATURE_SIZE]),
        nn.Linear(FEATURE_SIZE, class_num, **dev),
        nn.ReLU(True),
        nn.Linear(class_num, FEATURE_SIZE, **dev),
        nn.Sigmoid(),
    )
