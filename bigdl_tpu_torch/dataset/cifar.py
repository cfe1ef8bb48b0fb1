"""CIFAR-10 binary reader and synthetic stand-in (counterpart of
bigdl_tpu/dataset/cifar.py; ref models/vgg/Utils.scala's loader).

A ``.bin`` file holds records of 1 label byte and 3,072 pixel bytes (the
R, G and B planes of a 32x32 image); ``load_bin`` decodes them with the
port's C loop (``native.cifar_decode``).  ``synthetic`` makes the same
images and labels as the JAX package's for the same ``(n, seed)``.
Labels of the records are 1-based floats.
"""
from __future__ import annotations

import os

import numpy as np

from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset.image import LabeledImage

# per-channel means and standard deviations of the training set, the
# reference vgg pipeline's
TRAIN_MEAN = (0.4913996898739353 * 255, 0.4821584196221302 * 255,
              0.44653092422369434 * 255)
TRAIN_STD = (0.24703223517429462 * 255, 0.2434851308749409 * 255,
             0.26158784442034005 * 255)


def load_bin(path, native_decode: bool = True):
    """(images (n, 32, 32, 3) float32 HWC, labels (n,) 0-based float32)
    of one ``.bin`` file."""
    raw = np.fromfile(path, np.uint8)
    labels1, imgs = native.cifar_decode(raw, native=native_decode)
    return imgs, labels1 - np.float32(1.0)


def load(folder, training: bool = True):
    """A list of LabeledImage from ``data_batch_{1..5}.bin`` (training)
    or ``test_batch.bin`` under ``folder``."""
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if training
             else ["test_batch.bin"])
    records = []
    for fn in files:
        p = os.path.join(folder, fn)
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        imgs, labels = load_bin(p)
        records += [LabeledImage(i, l + 1) for i, l in zip(imgs, labels)]
    return records


def synthetic(n: int = 1024, seed: int = 0):
    """Deterministic CIFAR-shaped data: uniform [0, 255) HWC images,
    labels 1..10."""
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(0, 255, (n, 32, 32, 3)).astype(np.float32)
    labels = rng.randint(0, 10, n).astype(np.float32)
    return [LabeledImage(i, l + 1) for i, l in zip(imgs, labels)]
