"""Inception-v1 / GoogLeNet (counterpart of bigdl_tpu/models/inception.py;
ref models/inception/Inception_v1.scala:96), the conv-net training slice.

Layer for layer the JAX model, so every container names its children
'0', '1', ... and the parameter tree matches (``nn.module.load_jax_params``
takes the JAX ``Inception_v1().params()`` tree): 116 leaves, 6,998,552
parameters at ``class_num=1000``.  Its two ``SpatialCrossMapLRN`` layers
run the ``lrn`` kernels, the nine stride-1 pools of the inception modules
the ``maxpool2d_s1`` kernels, the four 3x3/s2 ceil pools the
``maxpool2d`` kernels.

``Inception_v2`` (BN-Inception) matches the JAX model's parameter and
state trees too: 11,204,936 parameters and 19,904 running-statistic
values at ``class_num=1000``.  Its stem pools and the 3x3 s2 ceil max
pools of 3c and 4e run the ``maxpool2d`` kernels, 5b's 3x3 s1 p1 ceil
max pool the ``maxpool2d_s1`` kernels.
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


def _conv_bn(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0, **dev):
    return nn.Sequential(_conv(n_in, n_out, kw, kh, sw, sh, pw, ph, **dev),
                         nn.SpatialBatchNormalization(n_out, 1e-3, **dev),
                         nn.ReLU(True))


def inception_v2_module(input_size, c1, c3r, c3, d3r, d3, pool_proj,
                        pool_type="avg", stride=1, device="cuda",
                        generator=None):
    """BN-Inception block (ref Inception_v2.scala): the 5x5 branch
    factorised into two 3x3s; the stride-2 blocks drop the 1x1 branch
    (c1 == 0) and pass the pool through (pool_proj == 0)."""
    dev = dict(device=resolve_device(device), generator=generator)
    branches = []
    if c1 > 0:
        branches.append(_conv_bn(input_size, c1, 1, 1, **dev))
    branches.append(nn.Sequential(
        _conv_bn(input_size, c3r, 1, 1, **dev),
        _conv_bn(c3r, c3, 3, 3, stride, stride, 1, 1, **dev)))
    branches.append(nn.Sequential(
        _conv_bn(input_size, d3r, 1, 1, **dev),
        _conv_bn(d3r, d3, 3, 3, 1, 1, 1, 1, **dev),
        _conv_bn(d3, d3, 3, 3, stride, stride, 1, 1, **dev)))
    pad = 1 if stride == 1 else 0
    pool = (nn.SpatialAveragePooling(3, 3, 1, 1, 1, 1, ceil_mode=True)
            if pool_type == "avg"
            else nn.SpatialMaxPooling(3, 3, stride, stride, pad, pad).ceil())
    if pool_proj > 0:
        branches.append(nn.Sequential(
            pool, _conv_bn(input_size, pool_proj, 1, 1, **dev)))
    else:
        branches.append(nn.Sequential(pool))
    return nn.Concat(2, *branches)


def Inception_v2(class_num: int = 1000, device="cuda", generator=None):
    """BN-Inception (ref Inception_v2.scala): (B, 3, 224, 224) images ->
    (B, class_num) log-probs."""
    dev = dict(device=resolve_device(device), generator=generator)

    def block(*sizes):
        return inception_v2_module(*sizes, **dev)

    m = nn.Sequential()
    m.add(_conv_bn(3, 64, 7, 7, 2, 2, 3, 3, **dev))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(_conv_bn(64, 64, 1, 1, **dev))
    m.add(_conv_bn(64, 192, 3, 3, 1, 1, 1, 1, **dev))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(block(192, 64, 64, 64, 64, 96, 32, "avg"))        # 3a -> 256
    m.add(block(256, 64, 64, 96, 64, 96, 64, "avg"))        # 3b -> 320
    m.add(block(320, 0, 128, 160, 64, 96, 0, "max", 2))     # 3c -> 576
    m.add(block(576, 224, 64, 96, 96, 128, 128, "avg"))     # 4a -> 576
    m.add(block(576, 192, 96, 128, 96, 128, 128, "avg"))    # 4b -> 576
    m.add(block(576, 160, 128, 160, 128, 160, 96, "avg"))   # 4c -> 576
    m.add(block(576, 96, 128, 192, 160, 192, 96, "avg"))    # 4d -> 576
    m.add(block(576, 0, 128, 192, 192, 256, 0, "max", 2))   # 4e -> 1024
    m.add(block(1024, 352, 192, 320, 160, 224, 128, "avg"))  # 5a -> 1024
    m.add(block(1024, 352, 192, 320, 192, 224, 128, "max"))  # 5b -> 1024
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    m.add(nn.View(1024))
    m.add(nn.Linear(1024, class_num, **dev))
    m.add(nn.LogSoftMax())
    return m
