"""LeNet-5 (counterpart of bigdl_tpu/models/lenet.py; ref
models/lenet/LeNet5.scala:24), the canonical training slice.

Layer for layer the JAX model, so the children are named '0'..'11' and
the parameter tree matches (``nn.module.load_jax_params`` takes the JAX
``LeNet5().params()`` tree).  22,278 parameters at ``class_num=10``.
"""
from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.utils.device import resolve_device


def LeNet5(class_num: int = 10, device="cuda", generator=None):
    """(B, 1, 28, 28) or (B, 28, 28) images -> (B, class_num) log-probs.
    Weights are drawn on the CPU from ``generator`` and placed on
    ``device`` (the card unless the caller asks for the CPU)."""
    kw = dict(device=resolve_device(device), generator=generator)
    return nn.Sequential(
        nn.Reshape([1, 28, 28]),
        nn.SpatialConvolution(1, 6, 5, 5, **kw).set_name("conv1_5x5"),
        nn.Tanh(),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.Tanh(),
        nn.SpatialConvolution(6, 12, 5, 5, **kw).set_name("conv2_5x5"),
        nn.SpatialMaxPooling(2, 2, 2, 2),
        nn.Reshape([12 * 4 * 4]),
        nn.Linear(12 * 4 * 4, 100, **kw).set_name("fc_1"),
        nn.Tanh(),
        nn.Linear(100, class_num, **kw).set_name("fc_2"),
        nn.LogSoftMax(),
    )
