"""Image records and their transformers (counterpart of the parts of
bigdl_tpu/dataset/image.py that the LeNet and Inception paths use:
``LabeledImage``, ``ImgNormalizer``, ``ImgRdmCropper``, ``HFlip``,
``ImgToBatch``).  numpy only; the JAX package's native host ops are not
ported yet.

Every transformer yields new images and leaves the dataset's records as
they were (the JAX ones rebind ``img.data`` on the records themselves, so
an in-memory dataset's later passes normalise, crop and flip images that
were already).  The random ones draw from an explicit
``np.random.RandomState``: their own ``rng``, or, when they have none,
the stream of the ``DataSet.array`` they are chained onto, so the
shuffles, crops and flips interleave on one stream as the JAX package's
do on ``RNG.np_rng()``.
"""
from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.dataset.transformer import Transformer


class LabeledImage:
    """HWC (or HW grey) float image + label (ref LabeledBGRImage
    image/Types.scala:246); ``order`` names the channel layout."""

    __slots__ = ("data", "label", "order")

    def __init__(self, data, label, order: str = "rgb"):
        self.data = np.asarray(data, np.float32)
        self.label = float(label)
        self.order = order

    @property
    def height(self):
        return self.data.shape[0]

    @property
    def width(self):
        return self.data.shape[1]


class ImgNormalizer(Transformer):
    """Subtract mean, divide std, per channel (ref BGRImgNormalizer /
    GreyImgNormalizer); scalars or per-channel tuples.

    Yields new images and leaves the dataset's records as they were: the
    JAX module rebinds ``img.data`` on the record itself, so every later
    pass over an in-memory dataset normalises its images once more."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, iterator):
        for img in iterator:
            yield LabeledImage((img.data - self.mean) / self.std, img.label,
                               img.order)


class ImgRdmCropper(Transformer):
    """Crop ``crop_height`` x ``crop_width`` at a random position, after
    zero ``padding`` on each side (ref BGRImgRdmCropper / GreyImgCropper):
    draws the row, then the column offset."""

    stochastic = True

    def __init__(self, crop_width: int, crop_height: int, padding: int = 0,
                 rng: np.random.RandomState = None):
        self.cw, self.ch = crop_width, crop_height
        self.padding = padding
        self.rng = rng

    def __call__(self, iterator):
        rng = _stream(self)
        for img in iterator:
            d = img.data
            if self.padding > 0:
                p = self.padding
                d = np.pad(d, ((p, p), (p, p)) + ((0, 0),) * (d.ndim - 2))
            h, w = d.shape[:2]
            y0 = rng.randint(0, h - self.ch + 1)
            x0 = rng.randint(0, w - self.cw + 1)
            yield LabeledImage(d[y0:y0 + self.ch, x0:x0 + self.cw],
                               img.label, img.order)


class HFlip(Transformer):
    """Mirror the columns of an image with probability ``threshold`` (ref
    HFlip.scala): one uniform draw an image."""

    stochastic = True

    def __init__(self, threshold: float = 0.5,
                 rng: np.random.RandomState = None):
        self.threshold = threshold
        self.rng = rng

    def __call__(self, iterator):
        rng = _stream(self)
        for img in iterator:
            if rng.uniform() < self.threshold:
                img = LabeledImage(img.data[:, ::-1], img.label, img.order)
            yield img


def _stream(stage) -> np.random.RandomState:
    if stage.rng is None:
        raise ValueError(f"{type(stage).__name__} has no random stream: "
                         f"pass rng=, or chain it onto a DataSet.array")
    return stage.rng


def _img_to_chw(data, to_chw):
    if data.ndim == 2:
        return data[None]  # grey -> (1, H, W)
    return np.ascontiguousarray(data.transpose(2, 0, 1)) if to_chw else data


class ImgToBatch(Transformer):
    """LabeledImage -> MiniBatch in NCHW with float labels (ref
    BGRImgToBatch / GreyImgToBatch); a partial tail batch is kept."""

    def __init__(self, batch_size: int, to_chw: bool = True):
        self.batch_size = batch_size
        self.to_chw = to_chw

    def _stack(self, imgs):
        return MiniBatch(np.stack([_img_to_chw(i.data, self.to_chw)
                                   for i in imgs]),
                         np.asarray([i.label for i in imgs], np.float32))

    def __call__(self, iterator):
        buf = []
        for img in iterator:
            buf.append(img)
            if len(buf) == self.batch_size:
                yield self._stack(buf)
                buf = []
        if buf:
            yield self._stack(buf)
