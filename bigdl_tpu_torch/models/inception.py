"""Inception-v1 / GoogLeNet (counterpart of bigdl_tpu/models/inception.py;
ref models/inception/Inception_v1.scala:96), the conv-net training slice.

Layer for layer the JAX model, so every container names its children
'0', '1', ... and the parameter tree matches (``nn.module.load_jax_params``
takes the JAX ``Inception_v1().params()`` tree): 116 leaves, 6,998,552
parameters at ``class_num=1000``.  Its two ``SpatialCrossMapLRN`` layers
run the ``lrn`` kernels, the nine stride-1 pools of the inception modules
the ``maxpool2d_s1`` kernels, the four 3x3/s2 ceil pools the
``maxpool2d`` kernels.  ``Inception_v2`` needs BatchNorm and is not
ported yet.
"""
from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.utils.device import resolve_device


def _conv(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0, **dev):
    return nn.SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph,
                                 init_method=nn.Xavier, **dev)


def inception_module(input_size, c1, c3r, c3, c5r, c5, pool_proj, device="cuda",
                     generator=None):
    """4-branch inception block (ref Inception_v1.scala inception()):
    Concat over the channel dim of 1x1 / 1x1-3x3 / 1x1-5x5 / pool-1x1."""
    dev = dict(device=resolve_device(device), generator=generator)
    return nn.Concat(
        2,
        nn.Sequential(_conv(input_size, c1, 1, 1, **dev), nn.ReLU(True)),
        nn.Sequential(_conv(input_size, c3r, 1, 1, **dev), nn.ReLU(True),
                      _conv(c3r, c3, 3, 3, 1, 1, 1, 1, **dev), nn.ReLU(True)),
        nn.Sequential(_conv(input_size, c5r, 1, 1, **dev), nn.ReLU(True),
                      _conv(c5r, c5, 5, 5, 1, 1, 2, 2, **dev), nn.ReLU(True)),
        nn.Sequential(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(),
                      _conv(input_size, pool_proj, 1, 1, **dev),
                      nn.ReLU(True)),
    )


def Inception_v1_NoAuxClassifier(class_num: int = 1000, device="cuda",
                                 generator=None):
    """GoogLeNet without aux heads (ref Inception_v1.scala:96 main path):
    (B, 3, 224, 224) images -> (B, class_num) log-probs.  Weights are
    drawn on the CPU from ``generator`` and placed on ``device`` (the
    card unless the caller asks for the CPU)."""
    dev = dict(device=resolve_device(device), generator=generator)

    def block(*sizes):
        return inception_module(*sizes, **dev)

    m = nn.Sequential()
    m.add(_conv(3, 64, 7, 7, 2, 2, 3, 3, **dev).set_name("conv1/7x7_s2"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(_conv(64, 64, 1, 1, **dev).set_name("conv2/3x3_reduce"))
    m.add(nn.ReLU(True))
    m.add(_conv(64, 192, 3, 3, 1, 1, 1, 1, **dev).set_name("conv2/3x3"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(block(192, 64, 96, 128, 16, 32, 32))      # 3a -> 256
    m.add(block(256, 128, 128, 192, 32, 96, 64))    # 3b -> 480
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(block(480, 192, 96, 208, 16, 48, 64))     # 4a -> 512
    m.add(block(512, 160, 112, 224, 24, 64, 64))    # 4b -> 512
    m.add(block(512, 128, 128, 256, 24, 64, 64))    # 4c -> 512
    m.add(block(512, 112, 144, 288, 32, 64, 64))    # 4d -> 528
    m.add(block(528, 256, 160, 320, 32, 128, 128))  # 4e -> 832
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(block(832, 256, 160, 320, 32, 128, 128))  # 5a -> 832
    m.add(block(832, 384, 192, 384, 48, 128, 128))  # 5b -> 1024
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    m.add(nn.Dropout(0.4))
    m.add(nn.View(1024))
    m.add(nn.Linear(1024, class_num, **dev).set_name("loss3/classifier"))
    m.add(nn.LogSoftMax())
    return m


def Inception_v1(class_num: int = 1000, device="cuda", generator=None):
    """The reference's default training graph: the model without aux
    heads."""
    return Inception_v1_NoAuxClassifier(class_num, device, generator)
