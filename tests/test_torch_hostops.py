"""The port's native host ops (``bigdl_tpu_torch.native``, its own copy of
the C++) against their numpy versions, bit for bit, and the image chain
that runs through them against the numpy chain the port had before
(crop and flip as views, ``(x - mean) / std``, a transpose and
``np.stack``), batch for batch, from one seed: every op is an element-wise
fp32 copy or ``(x - mean) / std``, so no tolerance applies."""
import numpy as np
import pytest

from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset import (DataSet, HFlip, ImgNormalizer,
                                     ImgRdmCropper, ImgToBatch, LabeledImage)
from bigdl_tpu_torch.dataset import mnist


def _img(shape, seed=0):
    return np.random.RandomState(seed).uniform(0, 255, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(9, 7, 3), (6, 5), (4, 8, 1), (3, 3, 4),
                                   (160, 160, 3), (300, 300)])
def test_native_ops_equal_numpy(shape):
    img = _img(shape)
    c = 1 if len(shape) == 2 else shape[2]
    mean = np.linspace(10, 60, c).astype(np.float32)
    std = np.linspace(1.5, 3.0, c).astype(np.float32)
    if len(shape) == 2:
        mean, std = mean[0], std[0]
    for name, call in (
            ("normalize", lambda nat: native.normalize(img, mean, std,
                                                       native=nat)),
            ("crop", lambda nat: native.crop(img, 1, 1, 2, 2, native=nat)),
            ("hflip", lambda nat: native.hflip(img, native=nat)),
            ("hwc_to_chw", lambda nat: native.hwc_to_chw(img, native=nat))):
        got, want = call(True), call(False)
        assert got.dtype == want.dtype == np.float32, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_u8_to_f32_equals_numpy():
    raw = np.random.RandomState(1).randint(0, 256, (5, 13)).astype(np.uint8)
    for scale, shift in ((1.0, 0.0), (1 / 255, -0.5), (0.3, 7.1)):
        np.testing.assert_array_equal(
            native.u8_to_f32(raw, scale, shift, native=True),
            native.u8_to_f32(raw, scale, shift, native=False))
    np.testing.assert_array_equal(native.u8_to_f32(raw, native=True),
                                  raw.astype(np.float32))


@pytest.mark.parametrize("nat", [True, False])
def test_out_is_written_in_place_and_checked(nat):
    img = _img((4, 6, 3))
    batch = np.zeros((2, 3, 4, 6), np.float32)
    native.hwc_to_chw(img, native=nat, out=batch[1])
    np.testing.assert_array_equal(batch[1], img.transpose(2, 0, 1))
    assert not batch[0].any()
    with pytest.raises(ValueError, match="out must be"):
        native.hwc_to_chw(img, native=nat,
                          out=np.zeros((3, 6, 4), np.float32))
    with pytest.raises(ValueError, match="outside"):
        native.crop(img, 2, 0, 3, 6, native=nat)


@pytest.mark.parametrize("shape", [(28, 28), (128, 128, 3)])
def test_the_default_takes_the_c_loop(monkeypatch, shape):
    """A digit or a colour image, the default is the C loop, with the
    bits of the numpy version."""
    calls = []
    so = native.lib()
    monkeypatch.setattr(native, "lib", lambda: calls.append(1) or so)
    img = _img(shape)
    mean, std = ((1.0, 2.0, 3.0), (2.0, 3.0, 4.0)) if img.ndim == 3 \
        else (1.0, 2.0)
    got = native.normalize(img, mean, std)
    assert calls == [1]
    np.testing.assert_array_equal(got, native.normalize(img, mean, std,
                                                        native=False))
    assert calls == [1]


def _pr11_chain(images, seed, crop, mean, std, batch, n_batches):
    """The numpy chain of the port before the host ops, as it drew."""
    rng = np.random.RandomState(seed)
    order = [images[i] for i in rng.permutation(len(images))]
    out, buf = [], []
    for img in order:
        d = img.data
        h, w = d.shape[:2]
        y0 = rng.randint(0, h - crop + 1)
        x0 = rng.randint(0, w - crop + 1)
        d = d[y0:y0 + crop, x0:x0 + crop]
        if rng.uniform() < 0.5:
            d = d[:, ::-1]
        d = (d - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
        buf.append(np.ascontiguousarray(d.transpose(2, 0, 1)))
        if len(buf) == batch:
            out.append(np.stack(buf))
            buf = []
        if len(out) == n_batches:
            return out
    return out


def test_inception_chain_batches_equal_the_numpy_chain():
    """examples/train_inception.py's chain at a small size: random crops
    and flips of RGB images, the mean subtraction, CHW batches."""
    rs = np.random.RandomState(3)
    images = [LabeledImage(rs.uniform(0, 255, (20, 18, 3)), k % 5 + 1)
              for k in range(12)]
    mean, std = (123.0, 117.0, 104.0), (1.0, 1.0, 1.0)
    ds = (DataSet.array(images, seed=7) >> ImgRdmCropper(11, 11) >> HFlip()
          >> ImgNormalizer(mean, std) >> ImgToBatch(4))
    got = [b.data for _, b in zip(range(3), ds.data(train=True))]
    want = _pr11_chain(images, 7, 11, mean, std, 4, 3)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == (4, 3, 11, 11)
        np.testing.assert_array_equal(a, b)


def test_grey_chain_batches_equal_numpy():
    """LeNet's chain: grey images normalised, batched as (B, 1, H, W)."""
    images = mnist.synthetic(10, 0)
    ds = DataSet.array(images) >> ImgNormalizer(
        mnist.TRAIN_MEAN, mnist.TRAIN_STD) >> ImgToBatch(4)
    got = list(ds.data(train=False))
    assert [b.data.shape for b in got] == [(4, 1, 28, 28)] * 2 + [
        (2, 1, 28, 28)]
    want = np.stack([(i.data - np.float32(mnist.TRAIN_MEAN))
                     / np.float32(mnist.TRAIN_STD) for i in images])[:, None]
    np.testing.assert_array_equal(np.concatenate([b.data for b in got]),
                                  want)


def test_the_library_is_built_from_the_ports_own_copy():
    path = native.target()
    assert path.parent.name == "build"
    assert path.parent.parent.name == "bigdl_tpu_torch"
    native.lib()
    assert path.exists()
    assert native._SRC.parent.parent.name == "bigdl_tpu_torch"
