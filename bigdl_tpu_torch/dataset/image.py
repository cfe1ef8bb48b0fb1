"""Image records and their transformers (counterpart of the parts of
bigdl_tpu/dataset/image.py that the LeNet path uses: ``LabeledImage``,
``ImgNormalizer``, ``ImgToBatch``).  numpy only; the JAX package's
native host ops are not ported yet.
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
