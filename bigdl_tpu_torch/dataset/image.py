"""Image records and their transformers (counterpart of the parts of
bigdl_tpu/dataset/image.py that the LeNet and Inception paths use:
``LabeledImage``, ``ImgNormalizer``, ``ImgRdmCropper``, ``HFlip``,
``ImgToBatch``).  The crops, flips, normalisation and batch copies run
through the native host ops (``bigdl_tpu_torch.native``, C++ with
OpenMP on large images); each is an element-wise fp32 copy or ``(x - mean) / std``, so the batches
have the bits of the numpy expressions they replace.  The
random offsets and coins are drawn in Python, record by record, in the
serial order.

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

from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.random import check_stream


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

    pure_per_record = True

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, iterator):
        for img in iterator:
            yield LabeledImage(native.normalize(img.data, self.mean,
                                                self.std),
                               img.label, img.order)


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
            yield LabeledImage(native.crop(d, y0, x0, self.ch, self.cw),
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
                img = LabeledImage(native.hflip(img.data), img.label,
                                   img.order)
            yield img


def _stream(stage) -> np.random.RandomState:
    if stage.rng is None:
        raise ValueError(f"{type(stage).__name__} has no random stream: "
                         f"pass rng=, or chain it onto a DataSet.array")
    check_stream(stage.rng)
    return stage.rng


class ImgToBatch(Transformer):
    """LabeledImage -> MiniBatch in NCHW with float labels (ref
    BGRImgToBatch / GreyImgToBatch); a partial tail batch is kept.  Each
    image is written straight into its row of the batch buffer, in CHW
    order (a grey image as one channel; ``to_chw=False`` keeps HWC)."""

    def __init__(self, batch_size: int, to_chw: bool = True):
        self.batch_size = batch_size
        self.to_chw = to_chw

    def _stack(self, imgs):
        first = imgs[0].data
        chw = first.ndim == 2 or self.to_chw
        channels = 1 if first.ndim == 2 else first.shape[2]
        shape = (channels,) + first.shape[:2] if chw else first.shape
        data = np.empty((len(imgs),) + shape, np.float32)
        for row, img in zip(data, imgs):
            if img.data.shape != first.shape:
                raise ValueError(f"ImgToBatch: image shapes "
                                 f"{first.shape} and {img.data.shape}")
            if chw:
                native.hwc_to_chw(img.data, out=row)
            else:
                row[...] = img.data
        return MiniBatch(data,
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
