#!/usr/bin/env python3
"""Counts of the batch-normalised models' work, from their shapes, on the
CPU (no card, no timing):

    python3 model_flops.py

For ``VggForCifar10(10)`` (3x32x32), ``ResNet(50)`` (3x224x224) and
``ResNetCifar(20)`` (3x32x32), one image's forward operations in its
convolutions and linear layers (a multiply and an add each) and the bytes
of its batch-normalisation outputs (fp32), each also at the smoke's batch
(128, 256, 128), and the least time those BN bytes take on an H100 (the
input read and the output written forward; the input and the output's
gradient read and the input's gradient written backward; 3.35 TB/s).
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet


def counts(model, shape):
    """(forward operations, BN output bytes) of one image of ``shape``."""
    from bigdl_tpu_torch.nn import (BatchNormalization, Linear,
                                    SpatialConvolution)

    ops, bn_bytes = [0], [0]

    def hook(m, _, out):
        if isinstance(m, SpatialConvolution):
            ops[0] += 2 * out.numel() * m.weight[0].numel()
        elif isinstance(m, Linear):
            ops[0] += 2 * out.numel() * m.weight.shape[1]
        elif isinstance(m, BatchNormalization):
            bn_bytes[0] += 4 * out.numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()]
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1,) + shape))
    for h in handles:
        h.remove()
    return ops[0], bn_bytes[0]


def main():
    from bigdl_tpu_torch.models import ResNet, ResNetCifar, VggForCifar10

    for name, build, shape, batch in (
            ("VggForCifar10", lambda: VggForCifar10(10, device="cpu"),
             (3, 32, 32), 128),
            ("ResNet(50)", lambda: ResNet(50, device="cpu"),
             (3, 224, 224), 256),
            ("ResNetCifar(20)", lambda: ResNetCifar(20, device="cpu"),
             (3, 32, 32), 128)):
        ops, bn = counts(build(), shape)
        bn_ms = 5 * bn * batch / HBM_BYTES_PER_S * 1e3
        print(f"{name}: {ops / 1e9:.4f} GFLOP an image forward, "
              f"{3 * ops * batch / 1e12:.4f} TFLOP a training step of "
              f"{batch} (forward and backward, 3x); BN outputs "
              f"{bn / 1e6:.4f} MB an image, {bn * batch / 1e9:.4f} GB a "
              f"step, their bytes' least time {bn_ms:.4f} ms a step")


if __name__ == "__main__":
    main()
