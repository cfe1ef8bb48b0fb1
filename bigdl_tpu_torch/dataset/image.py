"""Image records and their transformers (counterpart of
bigdl_tpu/dataset/image.py; ref dataset/image/, SURVEY.md §2.4):
``LabeledImage``; the decoders ``BytesToImg`` (RGB or BGR),
``BytesToBGRImg`` and ``BytesToGreyImg``; the resize; the normalisers
``ImgNormalizer`` and ``ImgPixelNormalizer``; the croppers
``ImgCropper`` / ``BGRImgCropper`` (centre or random) and
``ImgRdmCropper``; the augmentations ``HFlip``, ``ColorJitter`` and
``Lighting``; the batchers ``ImgToBatch`` and ``MTLabeledImgToBatch``;
and ``ImgToSample`` / ``ImgToImageVector``.  The crops, flips,
normalisation and batch copies run through the native host ops
(``bigdl_tpu_torch.native``, C++ with OpenMP on large images); each is an
element-wise fp32 copy or ``(x - mean) / std``, so the batches have the
bits of the numpy expressions they replace.  The random offsets, coins
and jitters are drawn in Python, record by record, in the serial order,
with the JAX module's expressions, so they have its bits too.

A PNG decodes through the port's own decoder (``dataset/_png.py``)
everywhere, Pillow or not; any other format needs Pillow, and raises
without it.

Every transformer yields new images and leaves the dataset's records as
they were (the JAX ones rebind ``img.data`` on the records themselves, so
an in-memory dataset's later passes normalise, crop and flip images that
were already).  The random ones draw from an explicit
``np.random.RandomState``: their own ``rng``, or, when they have none,
the stream of the dataset they are chained onto, so the shuffles, crops,
flips and jitters interleave on one stream as the JAX package's do on
``RNG.np_rng()``.  ``MTLabeledImgToBatch`` runs each record's random
stages on a stream of its own, seeded from the chain's stream in the
serial order, so its batches are the same at any thread count.
"""
from __future__ import annotations

import numpy as np

from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset import _png
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import Transformer, stages
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


# -- decode -----------------------------------------------------------------

_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"), (b"GIF8", "GIF"),
            (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "WEBP"))


def _decode_bytes(raw: bytes) -> np.ndarray:
    """Encoded image bytes -> float32 HWC in RGB order: a PNG through the
    port's decoder, any other format through Pillow's
    ``convert("RGB")``."""
    if _png.is_png(raw):
        return _png.decode(raw)
    try:
        from PIL import Image as PILImage
    except ImportError:
        fmt = next((name for magic, name in _FORMATS
                    if raw.startswith(magic)), "an unknown format")
        raise RuntimeError(
            f"cannot decode {fmt} without Pillow: only PNG decodes without "
            f"it (the port's own decoder, dataset/_png.py)") from None
    import io

    return np.asarray(PILImage.open(io.BytesIO(raw)).convert("RGB"),
                      np.float32)


def _resize(arr, h, w):
    """Bilinear resize, pure numpy on float32 (no uint8 round-trip, so
    normalized/negative pixel values survive), the JAX module's
    expressions.  Works on HW and HWC."""
    arr = np.asarray(arr, np.float32)
    H, W = arr.shape[:2]
    if (H, W) == (h, w):
        return arr
    ys = np.linspace(0, H - 1, h, dtype=np.float32)
    xs = np.linspace(0, W - 1, w, dtype=np.float32)
    y0 = np.floor(ys).astype(np.intp)
    x0 = np.floor(xs).astype(np.intp)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    if arr.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    top = arr[y0][:, x0] * (1 - wx) + arr[y0][:, x1] * wx
    bot = arr[y1][:, x0] * (1 - wx) + arr[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


class BytesToImg(Transformer):
    """Decode ``ByteRecord`` bytes to a LabeledImage in RGB channel order,
    resized to (scale_to, scale_to) when given (ref BytesToBGRImg;
    BGRImage.resize image/Types.scala:278).  ``to_bgr=True`` flips the
    channels to the reference's BGR, so that reference-ordered
    per-channel constants apply unchanged."""

    pure_per_record = True

    def __init__(self, scale_to: int = None, to_bgr: bool = False):
        self.scale_to = scale_to
        self.to_bgr = to_bgr

    def __call__(self, iterator):
        for rec in iterator:
            arr = _decode_bytes(rec.data)
            if self.scale_to is not None:
                arr = _resize(arr, self.scale_to, self.scale_to)
            if self.to_bgr:
                arr = arr[..., ::-1].copy()
            yield LabeledImage(arr, rec.label,
                               order="bgr" if self.to_bgr else "rgb")


class BytesToBGRImg(BytesToImg):
    """Decode to BGR channel order, as the reference's BytesToBGRImg
    (image/Types.scala:278 stores pixels BGR)."""

    def __init__(self, scale_to: int = None):
        super().__init__(scale_to=scale_to, to_bgr=True)


class BytesToGreyImg(Transformer):
    """``row x col`` raw u8 bytes -> a grey LabeledImage (ref
    BytesToGreyImg.scala)."""

    pure_per_record = True

    def __init__(self, row: int, col: int):
        self.row = row
        self.col = col

    def __call__(self, iterator):
        for rec in iterator:
            arr = np.frombuffer(rec.data, np.uint8).astype(np.float32)
            yield LabeledImage(arr.reshape(self.row, self.col), rec.label)


# -- per-pixel maps and crops ------------------------------------------------

class ImgPixelNormalizer(Transformer):
    """Subtract a whole per-pixel mean image (ref BGRImgPixelNormalizer)."""

    pure_per_record = True

    def __init__(self, mean_image):
        self.mean_image = np.asarray(mean_image, np.float32)

    def __call__(self, iterator):
        for img in iterator:
            yield LabeledImage(img.data - self.mean_image, img.label,
                               img.order)


class ImgCropper(Transformer):
    """Positioned crop (ref BGRImgCropper.scala): ``cropper_method``
    ``"center"`` (this spelling's default, the validation chain's) or
    ``"random"`` (the row, then the column offset drawn from the
    stream)."""

    def __init__(self, crop_width: int, crop_height: int,
                 cropper_method: str = "center",
                 rng: np.random.RandomState = None):
        if cropper_method not in ("center", "random"):
            raise ValueError(
                f"cropper_method must be center|random, got {cropper_method}")
        self.cw, self.ch = crop_width, crop_height
        self.cropper_method = cropper_method
        self.stochastic = cropper_method == "random"
        self.pure_per_record = not self.stochastic
        self.rng = rng

    def __call__(self, iterator):
        rng = _stream(self) if self.stochastic else None
        for img in iterator:
            h, w = img.data.shape[:2]
            if rng is not None:
                y0 = rng.randint(0, h - self.ch + 1)
                x0 = rng.randint(0, w - self.cw + 1)
            else:
                y0 = (h - self.ch) // 2
                x0 = (w - self.cw) // 2
            yield LabeledImage(native.crop(img.data, y0, x0, self.ch,
                                           self.cw), img.label, img.order)


class BGRImgCropper(ImgCropper):
    """The reference's name: random position by default, as
    BGRImgCropper.scala (CropRandom)."""

    def __init__(self, crop_width: int, crop_height: int,
                 cropper_method: str = "random",
                 rng: np.random.RandomState = None):
        super().__init__(crop_width, crop_height, cropper_method, rng)


# -- colour augmentation -----------------------------------------------------

def _order_of(stage, img) -> str:
    return stage.channel_order or getattr(img, "order", "rgb")


def _check_order(channel_order):
    if channel_order not in (None, "bgr", "rgb"):
        raise ValueError(f"channel_order must be bgr|rgb, got "
                         f"{channel_order}")


class ColorJitter(Transformer):
    """Random brightness, contrast and saturation in a random order (ref
    ColoJitter.scala): a shuffle of the three operations, then one uniform
    draw each, in that order.  The channel layout is each image's
    ``order`` unless ``channel_order`` overrides it."""

    stochastic = True

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, channel_order: str = None,
                 rng: np.random.RandomState = None):
        _check_order(channel_order)
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.channel_order = channel_order
        self.rng = rng

    @staticmethod
    def _grayscale(d, order):
        # ITU-R 601 luma; weight per channel position depends on layout
        r, g_, b = ((2, 1, 0) if order == "bgr" else (0, 1, 2))
        g = 0.299 * d[..., r] + 0.587 * d[..., g_] + 0.114 * d[..., b]
        return g[..., None]

    def __call__(self, iterator):
        rng = _stream(self)
        for img in iterator:
            order = _order_of(self, img)
            ops = [self._do_brightness, self._do_contrast,
                   self._do_saturation]
            rng.shuffle(ops)
            d = img.data
            for op in ops:
                d = op(d, rng, order)
            yield LabeledImage(d, img.label, img.order)

    def _do_brightness(self, d, rng, order):
        alpha = 1.0 + rng.uniform(-self.brightness, self.brightness)
        return d * alpha

    def _do_contrast(self, d, rng, order):
        alpha = 1.0 + rng.uniform(-self.contrast, self.contrast)
        mean = self._grayscale(d, order).mean()
        return d * alpha + mean * (1 - alpha)

    def _do_saturation(self, d, rng, order):
        alpha = 1.0 + rng.uniform(-self.saturation, self.saturation)
        return d * alpha + self._grayscale(d, order) * (1 - alpha)


class Lighting(Transformer):
    """PCA lighting noise with the ImageNet eigen-decomposition (ref
    Lighting.scala; fb.resnet.torch's RGB rows): three normal draws an
    image.  As the JAX one: alpha ~ normal(0, alphastd) (Lighting.scala:41
    draws uniform), and the shift row flipped for a BGR image."""

    stochastic = True

    alphastd = 0.1
    eig_val = np.asarray([0.2175, 0.0188, 0.0045], np.float32)
    eig_vec = np.asarray([  # rows: R, G, B
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, channel_order: str = None,
                 rng: np.random.RandomState = None):
        _check_order(channel_order)
        self.channel_order = channel_order
        self.rng = rng

    def __call__(self, iterator):
        rng = _stream(self)
        for img in iterator:
            order = _order_of(self, img)
            alpha = rng.normal(0, self.alphastd, 3).astype(np.float32)
            shift = (self.eig_vec * alpha * self.eig_val).sum(axis=1)
            if order == "bgr":
                shift = shift[::-1]
            yield LabeledImage(img.data + shift, img.label, img.order)


# -- batches and samples -----------------------------------------------------

class MTLabeledImgToBatch(Transformer):
    """Multi-threaded record -> image -> MiniBatch assembly (ref
    MTLabeledBGRImgToBatch.scala:47: cloned sub-pipelines on
    ``num_threads`` host threads, finished batches one deep ahead).
    ``transformer`` maps one upstream record to one LabeledImage; an image
    of another size than ``height x width`` is resized before stacking.

    Each thread runs its own deep copy of ``transformer``.  Where it has
    random stages, this batcher draws one seed a record from the chain's
    stream (its ``rng``), in the serial order as it reads the records,
    and that record's random stages draw from ``RandomState(seed)``: the
    batches are the same at any ``num_threads``.  (The JAX batcher's
    threads draw from their own thread streams in the order they run.)
    A chain without random stages draws nothing, and gives the JAX
    batches."""

    def __init__(self, width: int, height: int, batch_size: int,
                 transformer: Transformer, num_threads: int = None,
                 to_chw: bool = True, rng: np.random.RandomState = None):
        import os
        import threading

        self.width = width
        self.height = height
        self.batch_size = batch_size
        self.transformer = transformer
        self.num_threads = num_threads or min(8, os.cpu_count() or 1)
        self._stack = ImgToBatch(batch_size, to_chw)._stack
        self.stochastic = any(getattr(s, "stochastic", False)
                              for s in stages(transformer))
        self.rng = rng
        self._tls = threading.local()

    def _thread_transformer(self):
        import copy

        tls = self._tls
        if getattr(tls, "transformer", None) is None:
            tls.transformer = copy.deepcopy(self.transformer)
            tls.random = [s for s in stages(tls.transformer)
                          if getattr(s, "stochastic", False)]
        return tls.transformer

    def _apply_one(self, item):
        rec, seed = item
        t = self._thread_transformer()
        if seed is not None:
            rs = np.random.RandomState(seed)
            for s in self._tls.random:
                s.rng = rs
        out = list(t(iter([rec])))
        if len(out) != 1:
            raise ValueError(
                "MTLabeledImgToBatch transformer must be 1-to-1 per record")
        img = out[0]
        if img.data.shape[:2] != (self.height, self.width):
            img = LabeledImage(_resize(img.data, self.height, self.width),
                               img.label, img.order)
        return img

    def __call__(self, iterator):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        rng = _stream(self) if self.stochastic else None

        def batches():
            buf = []
            for rec in iterator:
                buf.append((rec, None if rng is None
                            else int(rng.randint(2**31 - 1))))
                if len(buf) == self.batch_size:
                    yield buf
                    buf = []
            if buf:
                yield buf

        def build(pool, raw):
            return self._stack(list(pool.map(self._apply_one, raw)))

        # +2 threads run whole-batch assembly (at most 2 in flight) so all
        # num_threads decode workers stay available
        with ThreadPoolExecutor(max_workers=self.num_threads + 2) as pool:
            futures = deque()
            for raw in batches():
                futures.append(pool.submit(build, pool, raw))
                if len(futures) >= 2:
                    yield futures.popleft().result()
            while futures:
                yield futures.popleft().result()


class ImgToSample(Transformer):
    """LabeledImage -> Sample, CHW (a grey image as one channel) unless
    ``to_chw=False``, the label as a 1-vector."""

    pure_per_record = True

    def __init__(self, to_chw: bool = True):
        self.to_chw = to_chw

    def __call__(self, iterator):
        for img in iterator:
            d = img.data
            if d.ndim == 2:
                d = d[None]
            elif self.to_chw:
                d = native.hwc_to_chw(d)
            yield Sample(np.array(d, np.float32),
                         np.asarray([img.label], np.float32))


class ImgToImageVector(Transformer):
    """LabeledImage -> a flat float vector Sample (ref
    BGRImgToImageVector.scala, the MLlib DenseVector bridge): a 3-channel
    HWC BGR image becomes planar CHW in RGB plane order (the reference's
    ``copyTo(..., toRGB=true)``, image/Types.scala:154-164); a grey image
    flattens as it is."""

    pure_per_record = True

    def __call__(self, iterator):
        for img in iterator:
            d = np.asarray(img.data, np.float32)
            if d.ndim == 3 and d.shape[2] == 3:
                d = np.transpose(d, (2, 0, 1))[::-1]
            vec = np.ascontiguousarray(d, np.float32).reshape(-1)
            yield Sample(vec, np.asarray([img.label], np.float32))
