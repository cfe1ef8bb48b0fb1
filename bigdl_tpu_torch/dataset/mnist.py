"""MNIST idx-ubyte reader and synthetic stand-in (counterpart of
bigdl_tpu/dataset/mnist.py; ref models/lenet/Utils.scala).

``load`` reads the standard idx files; ``synthetic`` makes deterministic
MNIST-shaped data from a seed, the same images and labels as the JAX
package's for the same ``(n, seed)``.  Labels are 1-based floats.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from bigdl_tpu_torch.dataset.image import LabeledImage

TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def load_images(path):
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx image magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
        return data.reshape(n, rows, cols).astype(np.float32)


def load_labels(path):
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad idx label magic {magic}")
        return np.frombuffer(f.read(n), np.uint8).astype(np.float32)


def load(folder, training: bool = True):
    """A list of LabeledImage (grey HxW), labels 1-based."""
    prefix = "train" if training else "t10k"
    for suffix in ("", ".gz"):
        ip = os.path.join(folder, f"{prefix}-images-idx3-ubyte{suffix}")
        lp = os.path.join(folder, f"{prefix}-labels-idx1-ubyte{suffix}")
        if os.path.exists(ip) and os.path.exists(lp):
            imgs, labels = load_images(ip), load_labels(lp)
            return [LabeledImage(img, lbl + 1)
                    for img, lbl in zip(imgs, labels)]
    raise FileNotFoundError(f"no MNIST idx files under {folder}")


def synthetic(n: int = 1024, seed: int = 0):
    """Deterministic synthetic MNIST-shaped data."""
    rng = np.random.RandomState(seed)
    imgs = rng.uniform(0, 255, (n, 28, 28)).astype(np.float32)
    labels = rng.randint(0, 10, n).astype(np.float32)
    return [LabeledImage(img, lbl + 1) for img, lbl in zip(imgs, labels)]
