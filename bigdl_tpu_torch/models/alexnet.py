"""AlexNet (counterpart of bigdl_tpu/models/alexnet.py; ref
example/loadmodel/AlexNet.scala: AlexNet and AlexNet_OWT).

Layer for layer the JAX models (the same parameter trees), over (B, 3,
227, 227) images.  ``AlexNet``'s two LRNs run the ``lrn`` kernels and
its three 3x3 s2 pools the ``maxpool2d`` kernels; its grouped
convolutions are ``F.conv2d`` with ``groups=2``.
"""
from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.utils.device import resolve_device


def AlexNet(class_num: int = 1000, device="cuda", generator=None):
    """Caffe-style AlexNet with grouped convolutions (ref AlexNet.scala)."""
    dev = dict(device=resolve_device(device), generator=generator)
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(3, 96, 11, 11, 4, 4, **dev).set_name("conv1"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    m.add(nn.SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, n_group=2,
                                **dev).set_name("conv2"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    m.add(nn.SpatialConvolution(256, 384, 3, 3, 1, 1, 1, 1,
                                **dev).set_name("conv3"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialConvolution(384, 384, 3, 3, 1, 1, 1, 1, n_group=2,
                                **dev).set_name("conv4"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, n_group=2,
                                **dev).set_name("conv5"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    _head(m, class_num, True, dev, names=("fc6", "fc7", "fc8"))
    return m


def AlexNet_OWT(class_num: int = 1000, has_dropout: bool = True,
                device="cuda", generator=None):
    """The one-weird-trick variant, without groups and LRN (ref
    AlexNet.scala)."""
    dev = dict(device=resolve_device(device), generator=generator)
    m = nn.Sequential()
    for n_in, n_out, k, s, p, pool in ((3, 64, 11, 4, 2, True),
                                       (64, 192, 5, 1, 2, True),
                                       (192, 384, 3, 1, 1, False),
                                       (384, 256, 3, 1, 1, False),
                                       (256, 256, 3, 1, 1, True)):
        m.add(nn.SpatialConvolution(n_in, n_out, k, k, s, s, p, p, **dev))
        m.add(nn.ReLU(True))
        if pool:
            m.add(nn.SpatialMaxPooling(3, 3, 2, 2))
    _head(m, class_num, has_dropout, dev)
    return m


def _head(m, class_num, dropout, dev, names=(None, None, None)):
    m.add(nn.View(256 * 6 * 6))
    for n_in, n_out, name in ((256 * 6 * 6, 4096, names[0]),
                              (4096, 4096, names[1])):
        lin = nn.Linear(n_in, n_out, **dev)
        m.add(lin.set_name(name) if name else lin)
        m.add(nn.ReLU(True))
        if dropout:
            m.add(nn.Dropout(0.5))
    lin = nn.Linear(4096, class_num, **dev)
    m.add(lin.set_name(names[2]) if names[2] else lin)
    m.add(nn.LogSoftMax())
    return m
