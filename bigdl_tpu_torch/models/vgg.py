"""VGG models (counterpart of bigdl_tpu/models/vgg.py; ref
models/vgg/VggForCifar10.scala:25, Vgg_16 / Vgg_19 :74+).

Layer for layer the JAX models, so the parameter and state trees match
(``nn.module.load_jax_params`` / ``load_jax_state``):
``VggForCifar10(10)`` has 14,991,946 parameters in 58 leaves and 9,472
running-statistic values (13 ``SpatialBatchNormalization`` and one
``BatchNormalization``); its five 2x2 s2 ceil pools run the
``maxpool2d`` kernels.  ``Vgg_16`` / ``Vgg_19`` are the 224x224 ImageNet
models without batch normalisation.
"""
from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.utils.device import resolve_device


def _conv_bn_relu(model, n_in, n_out, **dev):
    """convBNReLU (ref VggForCifar10.scala)."""
    model.add(nn.SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1, **dev))
    model.add(nn.SpatialBatchNormalization(n_out, 1e-3, **dev))
    model.add(nn.ReLU(True))
    return model


def VggForCifar10(class_num: int = 10, device="cuda", generator=None):
    """(B, 3, 32, 32) images -> (B, class_num) log-probs (ref
    VggForCifar10.scala:25-72).  Weights are drawn on the CPU from
    ``generator`` and placed on ``device`` (the card unless the caller
    asks for the CPU)."""
    dev = dict(device=resolve_device(device), generator=generator)
    m = nn.Sequential()
    # (n_in, n_out, dropout after the block's ReLU or None); None: a pool
    for spec in ((3, 64, 0.3), (64, 64, None), None,
                 (64, 128, 0.4), (128, 128, None), None,
                 (128, 256, 0.4), (256, 256, 0.4), (256, 256, None), None,
                 (256, 512, 0.4), (512, 512, 0.4), (512, 512, None), None,
                 (512, 512, 0.4), (512, 512, 0.4), (512, 512, None), None):
        if spec is None:
            m.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
            continue
        n_in, n_out, drop = spec
        _conv_bn_relu(m, n_in, n_out, **dev)
        if drop is not None:
            m.add(nn.Dropout(drop))
    m.add(nn.View(512))
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(512, 512, **dev))
    m.add(nn.BatchNormalization(512, **dev))
    m.add(nn.ReLU(True))
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(512, class_num, **dev))
    m.add(nn.LogSoftMax())
    return m


def _vgg_block(model, n_in, n_out, n_convs, **dev):
    for i in range(n_convs):
        model.add(nn.SpatialConvolution(n_in if i == 0 else n_out, n_out,
                                        3, 3, 1, 1, 1, 1, **dev))
        model.add(nn.ReLU(True))
    model.add(nn.SpatialMaxPooling(2, 2, 2, 2))
    return model


def _vgg(blocks, class_num, device, generator):
    dev = dict(device=resolve_device(device), generator=generator)
    m = nn.Sequential()
    for n_in, n_out, n_convs in zip((3, 64, 128, 256, 512),
                                    (64, 128, 256, 512, 512), blocks):
        _vgg_block(m, n_in, n_out, n_convs, **dev)
    m.add(nn.View(512 * 7 * 7))
    m.add(nn.Linear(512 * 7 * 7, 4096, **dev))
    m.add(nn.Threshold(0, 1e-6))
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096, **dev))
    m.add(nn.Threshold(0, 1e-6))
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num, **dev))
    m.add(nn.LogSoftMax())
    return m


def Vgg_16(class_num: int = 1000, device="cuda", generator=None):
    """224x224 ImageNet VGG-16 (ref Vgg_16): 138,357,544 parameters at
    ``class_num=1000``."""
    return _vgg((2, 2, 3, 3, 3), class_num, device, generator)


def Vgg_19(class_num: int = 1000, device="cuda", generator=None):
    """224x224 ImageNet VGG-19 (ref Vgg_19)."""
    return _vgg((2, 2, 4, 4, 4), class_num, device, generator)
