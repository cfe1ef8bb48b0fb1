"""ResNet (counterpart of bigdl_tpu/models/resnet.py; ref
models/resnet/ResNet.scala:59).

Layer for layer the JAX models, so the parameter and state trees match
(``nn.module.load_jax_params`` / ``load_jax_state``): ``ResNet(50)`` has
25,557,032 parameters in 161 leaves and 53 ``SpatialBatchNormalization``
layers; its 3x3 s2 p1 stem pool runs the ``maxpool2d`` kernels.  The
convolutions take the MSRA init, the BN weights U(0, 1).

The final-BN zero init differs from the JAX package's on purpose.  The
JAX ``_zero_init_final_bn`` zeroes the last BN of every ``Sequential``,
so with type-B shortcuts it also zeroes the projection shortcut's BN
(``Sequential(conv, BN)``): 20 of ResNet-50's 53 weights, and each
stage's first block then starts at ReLU(0 + 0).  The port zeroes the
residual branch's last BN only, ResNet.scala's intent (16 of 53).
"""
from __future__ import annotations

import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.utils.device import resolve_device


def _conv(n_in, n_out, k, stride=1, pad=0, **dev):
    return nn.SpatialConvolution(n_in, n_out, k, k, stride, stride, pad, pad,
                                 init_method=nn.MSRA, with_bias=False, **dev)


def _shortcut(n_in, n_out, stride, shortcut_type="B", **dev):
    """(ref ResNet.scala shortcut) B: a 1x1 projection and BN where the
    shape changes, C: always; A: a strided subsample and zero channels
    appended."""
    use_conv = shortcut_type == "C" or (shortcut_type == "B"
                                        and n_in != n_out)
    if use_conv:
        return nn.Sequential(_conv(n_in, n_out, 1, stride, **dev),
                             nn.SpatialBatchNormalization(n_out, **dev))
    if n_in != n_out:
        return nn.Sequential(
            nn.SpatialAveragePooling(1, 1, stride, stride),
            nn.Concat(2, nn.Identity(), nn.MulConstant(0.0)))
    return nn.Identity()


def _residual(branch, shortcut):
    return nn.Sequential(nn.ConcatTable(branch, shortcut),
                         nn.CAddTable(True), nn.ReLU(True))


def basic_block(n_in, n_out, stride=1, shortcut_type="B", **dev):
    """(ref ResNet.scala basicBlock :162)"""
    s = nn.Sequential(
        _conv(n_in, n_out, 3, stride, 1, **dev),
        nn.SpatialBatchNormalization(n_out, **dev),
        nn.ReLU(True),
        _conv(n_out, n_out, 3, 1, 1, **dev),
        nn.SpatialBatchNormalization(n_out, **dev))
    return _residual(s, _shortcut(n_in, n_out, stride, shortcut_type, **dev))


def bottleneck(n_in, n_mid, stride=1, shortcut_type="B", **dev):
    """(ref ResNet.scala bottleneck :182): expansion 4."""
    n_out = n_mid * 4
    s = nn.Sequential(
        _conv(n_in, n_mid, 1, **dev),
        nn.SpatialBatchNormalization(n_mid, **dev), nn.ReLU(True),
        _conv(n_mid, n_mid, 3, stride, 1, **dev),
        nn.SpatialBatchNormalization(n_mid, **dev), nn.ReLU(True),
        _conv(n_mid, n_out, 1, **dev),
        nn.SpatialBatchNormalization(n_out, **dev))
    return _residual(s, _shortcut(n_in, n_out, stride, shortcut_type, **dev))


def _layer(block, n_in, n_mid, count, stride, shortcut_type="B",
           expansion=1, **dev):
    m = nn.Sequential()
    for i in range(count):
        m.add(block(n_in if i == 0 else n_mid * expansion, n_mid,
                    stride if i == 0 else 1, shortcut_type, **dev))
    return m


def ResNetCifar(depth: int = 20, class_num: int = 10,
                shortcut_type: str = "A", device="cuda", generator=None):
    """CIFAR-10 ResNet of depth 6n+2 (ref ResNet.scala cifar path):
    (B, 3, 32, 32) -> (B, class_num) log-probs."""
    if (depth - 2) % 6:
        raise ValueError(f"ResNetCifar: depth {depth} is not 6n+2")
    n = (depth - 2) // 6
    dev = dict(device=resolve_device(device), generator=generator)
    m = nn.Sequential()
    m.add(_conv(3, 16, 3, 1, 1, **dev))
    m.add(nn.SpatialBatchNormalization(16, **dev))
    m.add(nn.ReLU(True))
    m.add(_layer(basic_block, 16, 16, n, 1, shortcut_type, **dev))
    m.add(_layer(basic_block, 16, 32, n, 2, shortcut_type, **dev))
    m.add(_layer(basic_block, 32, 64, n, 2, shortcut_type, **dev))
    m.add(nn.SpatialAveragePooling(8, 8, 1, 1))
    m.add(nn.View(64))
    m.add(nn.Linear(64, class_num, **dev))
    m.add(nn.LogSoftMax())
    _zero_init_final_bn(m)
    return m


#: depth -> (block, blocks a stage, expansion, features at the head)
_IMAGENET = {18: (basic_block, (2, 2, 2, 2), 1, 512),
             34: (basic_block, (3, 4, 6, 3), 1, 512),
             50: (bottleneck, (3, 4, 6, 3), 4, 2048),
             101: (bottleneck, (3, 4, 23, 3), 4, 2048),
             152: (bottleneck, (3, 8, 36, 3), 4, 2048)}


def ResNet(depth: int = 50, class_num: int = 1000,
           shortcut_type: str = "B", device="cuda", generator=None):
    """ImageNet ResNet (ref ResNet.scala imagenet path): (B, 3, 224, 224)
    -> (B, class_num) log-probs."""
    block, counts, expansion, n_features = _IMAGENET[depth]
    dev = dict(device=resolve_device(device), generator=generator)
    m = nn.Sequential()
    m.add(_conv(3, 64, 7, 2, 3, **dev))
    m.add(nn.SpatialBatchNormalization(64, **dev))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
    n_in = 64
    for i, (count, n_mid) in enumerate(zip(counts, (64, 128, 256, 512))):
        m.add(_layer(block, n_in, n_mid, count, 1 if i == 0 else 2,
                     shortcut_type, expansion, **dev))
        n_in = n_mid * expansion
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    m.add(nn.View(n_features))
    m.add(nn.Linear(n_features, class_num, **dev))
    m.add(nn.LogSoftMax())
    _zero_init_final_bn(m)
    return m


def _zero_init_final_bn(model) -> int:
    """Zero the weight of each residual branch's last BN (ref
    ResNet.modelInit ResNet.scala:102-132): the branch is the first
    child of every block's ``ConcatTable``, so a projection shortcut's
    BN keeps its draw.  Returns how many were zeroed."""
    zeroed = 0
    for mod in model.modules():
        if isinstance(mod, nn.ConcatTable):
            last = list(mod.get(1).children())[-1]
            if isinstance(last, nn.SpatialBatchNormalization) and last.affine:
                with torch.no_grad():
                    last.weight.zero_()
                zeroed += 1
    return zeroed
