"""The port's image decode and transformers against the JAX package and
Pillow: the PNG decoder (``dataset/_png.py``) equals Pillow's
``convert("RGB")`` bit for bit on the modes Pillow writes (L, LA, RGB,
RGBA, P), on rows that use each of the five scanline filters, on odd
widths and a 1x1 image, and raises on what it does not decode; the native
unfilter equals its plain version; ``BytesToImg`` (PNG through the port's
decoder, JPEG through Pillow) equals the JAX decoder; ``_resize``, the
croppers, ``ImgPixelNormalizer``, ``ColorJitter``, ``Lighting``,
``ImgToSample`` and ``ImgToImageVector`` equal the JAX outputs exactly
(``assert_array_equal``) on streams aligned as tests/test_torch_dataset.py
aligns them; ``MTLabeledImgToBatch`` gives the JAX batches on a chain
without random stages, and the same batches at 1 and 8 threads on one
with them."""
import io
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

import bigdl_tpu.dataset.image as jimage
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset.sample import ByteRecord as JaxByteRecord
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset import (BGRImgCropper, ByteRecord,
                                     BytesToGreyImg, BytesToImg,
                                     ColorJitter, ColoJitter, DataSet, HFlip,
                                     ImgCropper, ImgNormalizer,
                                     ImgRdmCropper, ImgToBatch,
                                     ImgToImageVector, ImgToSample,
                                     LabeledImage, Lighting,
                                     MTLabeledImgToBatch, _png)
from bigdl_tpu_torch.dataset import image as pimage

COLOUR_TYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filtered(px, bpp, kinds):
    """Rows of ``px`` (h, stride) uint8 under the filter types ``kinds``
    (cycled by row), as a PNG encoder writes them."""
    h, stride = px.shape
    p = px.astype(np.int32)
    out = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur, up = p[y], p[y - 1] if y else np.zeros(stride, np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            pa = np.abs(up - ul)
            pb = np.abs(left - ul)
            pc = np.abs(left + up - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    return b"".join(out)


def png_bytes(px, ctype, kinds=(0, 1, 2, 3, 4), palette=None, depth=8,
              interlace=0, extra=()):
    """A PNG of ``px`` ((h, w, c) uint8) in colour type ``ctype``, its rows
    under the filter types ``kinds``; ``extra`` chunks go before IDAT."""
    h, w = px.shape[:2]
    c = COLOUR_TYPES[ctype]
    raw = _filtered(px.reshape(h, w * c), c, kinds)
    body = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                        0, interlace))]
    if palette is not None:
        body.append(_chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    body += [_chunk(k, b) for k, b in extra]
    body.append(_chunk(b"IDAT", zlib.compress(raw)))
    body.append(_chunk(b"IEND", b""))
    return b"\x89PNG\r\n\x1a\n" + b"".join(body)


def _pil_rgb(raw):
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"),
                      np.float32)


def _pil_png(mode, h, w, seed=0, transparency=False):
    rs = np.random.RandomState(seed)
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    a = rs.randint(0, 256, (h, w, c)).astype(np.uint8)
    if mode in ("L", "P"):
        im = Image.fromarray(a[..., 0], "L" if mode == "L" else "P")
    else:
        im = Image.fromarray(a, mode)
    kw = {}
    if mode == "P":
        im.putpalette(list(rs.randint(0, 256, 768)))
        if transparency:
            kw["transparency"] = 3
    elif transparency and mode == "RGB":
        kw["transparency"] = (1, 2, 3)
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("hw", [(1, 1), (7, 5), (16, 33)])
def test_pillow_pngs_decode_to_pillow_rgb(mode, hw):
    raw = _pil_png(mode, *hw, seed=hw[1])
    want = _pil_rgb(raw)
    for nat in (True, False):
        got = _png.decode(raw, native_unfilter=nat)
        assert got.dtype == np.float32 and got.shape == hw + (3,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "P"])
def test_trns_is_ignored_as_pillow_convert_does(mode):
    raw = _pil_png(mode, 6, 9, seed=2, transparency=True)
    assert b"tRNS" in raw
    np.testing.assert_array_equal(_png.decode(raw), _pil_rgb(raw))


@pytest.mark.parametrize("ctype", sorted(COLOUR_TYPES))
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,),
                                   (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "cycled"])
def test_each_filter_decodes_as_pillow(ctype, kinds):
    rs = np.random.RandomState(ctype * 7 + len(kinds))
    h, w = 9, 13                       # odd width: rows of odd strides
    px = rs.randint(0, 256, (h, w, COLOUR_TYPES[ctype])).astype(np.uint8)
    palette = rs.randint(0, 256, (256, 3)) if ctype == 3 else None
    raw = png_bytes(px, ctype, kinds, palette)
    want = _pil_rgb(raw)
    got = _png.decode(raw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_png.decode(raw, native_unfilter=False),
                                  want)


def test_a_short_palette_reads_black_past_its_end():
    px = np.array([[[0], [1], [2]]], np.uint8)
    raw = png_bytes(px, 3, palette=np.array([[9, 8, 7], [6, 5, 4]]))
    got = _png.decode(raw)
    np.testing.assert_array_equal(got, _pil_rgb(raw))
    np.testing.assert_array_equal(got[0], [[9, 8, 7], [6, 5, 4], [0, 0, 0]])


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_equals_plain(bpp):
    rs = np.random.RandomState(bpp)
    h, stride = 23, bpp * 31
    rows = rs.randint(0, 256, (h, stride + 1)).astype(np.uint8)
    rows[:, 0] = rs.randint(0, 5, h)
    raw = rows.tobytes()
    got = native.png_unfilter(raw, h, stride, bpp)
    want = native.png_unfilter(raw, h, stride, bpp, native=False)
    assert got.dtype == np.uint8 and got.shape == (h, stride)
    np.testing.assert_array_equal(got, want)
    rows[5, 0] = 7
    for nat in (True, False):
        with pytest.raises(ValueError, match="row 5: unknown filter type 7"):
            native.png_unfilter(rows.tobytes(), h, stride, bpp, native=nat)


def _rgb8(h=4, w=5):
    return np.random.RandomState(0).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _ihdr_depth16():
    raw = png_bytes(_rgb8(), 2)
    body = struct.pack(">IIBBBBB", 5, 4, 16, 2, 0, 0, 0)
    return raw.replace(raw[8:33], _chunk(b"IHDR", body))


def _bad_crc():
    raw = bytearray(png_bytes(_rgb8(), 2))
    raw[-20] ^= 1          # inside the IDAT body
    return bytes(raw)


@pytest.mark.parametrize("raw,match", [
    (lambda: b"GIF89a" + bytes(20), "bad signature"),
    (_ihdr_depth16, "bit depth 16"),
    (lambda: png_bytes(_rgb8(), 2, interlace=1), "interlaced"),
    (lambda: png_bytes(_rgb8(), 2, depth=4), "bit depth 4"),
    (_bad_crc, "bad CRC"),
    (lambda: png_bytes(_rgb8(), 2, extra=[(b"ABCD", b"xy")]),
     "unknown critical chunk"),
    (lambda: png_bytes(_rgb8(), 2)[:-30], "truncated"),
    (lambda: png_bytes(_rgb8()[..., :1], 3), "without a PLTE"),
    (lambda: b"\x89PNG\r\n\x1a\n" + _chunk(b"IEND", b""), "no IHDR"),
], ids=["signature", "16-bit", "interlaced", "sub-byte", "crc",
        "critical-chunk", "truncated", "no-palette", "no-ihdr"])
def test_unsupported_pngs_raise_naming_the_reason(raw, match):
    with pytest.raises(ValueError, match=match):
        _png.decode(raw())


def test_an_ancillary_chunk_is_skipped():
    px = _rgb8()
    raw = png_bytes(px, 2, extra=[(b"tEXt", b"k\x00v"), (b"gAMA", b"1234")])
    np.testing.assert_array_equal(_png.decode(raw), px.astype(np.float32))


def _records(raws, pkg_record):
    return [pkg_record(r, float(i % 3 + 1)) for i, r in enumerate(raws)]


def _jpeg(seed):
    buf = io.BytesIO()
    Image.fromarray(_rgb8(13, 17) + np.uint8(seed)).save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("scale_to", [None, 11, 24])
@pytest.mark.parametrize("kind", ["BytesToImg", "BytesToImg-bgr",
                                  "BytesToBGRImg"])
def test_bytes_to_img_equals_jax(scale_to, kind):
    raws = [_pil_png(m, 9, 14, seed=i) for i, m in
            enumerate(["RGB", "L", "RGBA", "P"])] + [_jpeg(1)]

    def make(mod):
        if kind == "BytesToBGRImg":
            return mod.BytesToBGRImg(scale_to)
        return mod.BytesToImg(scale_to, to_bgr=kind.endswith("bgr"))

    want = list(make(jimage)(iter(_records(raws, JaxByteRecord))))
    got = list(make(pimage)(iter(_records(raws, ByteRecord))))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.order == w.order and g.label == w.label
        np.testing.assert_array_equal(g.data, w.data)


def test_without_pillow_only_png_decodes(monkeypatch):
    png, jpeg = _pil_png("RGB", 4, 4), _jpeg(0)
    monkeypatch.setitem(sys.modules, "PIL", None)
    (img,) = BytesToImg()(iter([ByteRecord(png, 1.0)]))
    assert img.data.shape == (4, 4, 3)
    with pytest.raises(RuntimeError, match="cannot decode JPEG without "
                       "Pillow: only PNG decodes"):
        list(BytesToImg()(iter([ByteRecord(jpeg, 1.0)])))


def test_bytes_to_grey_img_equals_jax():
    rs = np.random.RandomState(0)
    raws = [rs.bytes(12) for _ in range(3)]
    want = list(jimage.BytesToGreyImg(3, 4)(iter(_records(raws,
                                                          JaxByteRecord))))
    got = list(BytesToGreyImg(3, 4)(iter(_records(raws, ByteRecord))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
        assert g.data.shape == (3, 4) and g.label == w.label


@pytest.mark.parametrize("src,dst", [((9, 14, 3), (11, 11)),
                                     ((9, 14), (5, 20)),
                                     ((7, 7, 3), (7, 7)),
                                     ((1, 1, 3), (3, 2))])
def test_resize_equals_jax(src, dst):
    a = np.random.RandomState(1).uniform(-3, 300, src).astype(np.float32)
    got = pimage._resize(a, *dst)
    want = jimage._resize(a, *dst)
    assert got.dtype == np.float32 and got.shape == dst + src[2:]
    np.testing.assert_array_equal(got, want)


def _imgs(pkg, n=5, h=12, w=10, order="rgb", seed=0):
    rs = np.random.RandomState(seed)
    return [pkg.LabeledImage(rs.uniform(0, 255, (h, w, 3)).astype(
        np.float32), float(i + 1), order) for i in range(n)]


def _jax_run(stage, imgs, seed):
    """The JAX stage over ``imgs`` after ``set_seed(seed)``."""
    set_seed(seed)
    return list(stage(iter(imgs)))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.label == w.label and g.order == w.order
        np.testing.assert_array_equal(g.data, w.data)


@pytest.mark.parametrize("order", ["rgb", "bgr"])
@pytest.mark.parametrize("name", ["crop-center", "crop-random",
                                  "bgr-crop", "jitter", "jitter-override",
                                  "jitter-alias", "lighting",
                                  "lighting-override", "pixel-norm"])
def test_stages_equal_jax_on_aligned_streams(name, order):
    mean_img = np.random.RandomState(5).uniform(0, 9, (12, 10, 3))
    stages = {
        "crop-center": lambda m, r: m.ImgCropper(7, 5, **r),
        "crop-random": lambda m, r: m.ImgCropper(7, 5, "random", **r),
        "bgr-crop": lambda m, r: m.BGRImgCropper(6, 9, **r),
        "jitter": lambda m, r: m.ColorJitter(**r),
        "jitter-override": lambda m, r: m.ColorJitter(
            0.2, 0.7, 0.1, channel_order="rgb", **r),
        "jitter-alias": lambda m, r: (ColoJitter if m is pimage
                                      else m.ColorJitter)(**r),
        "lighting": lambda m, r: m.Lighting(**r),
        "lighting-override": lambda m, r: m.Lighting("bgr", **r),
        "pixel-norm": lambda m, r: m.ImgPixelNormalizer(mean_img),
    }
    make = stages[name]
    jstage = make(jimage, {})
    want = _jax_run(jstage, _imgs(jimage, order=order), 3)
    takes_rng = getattr(jstage, "stochastic", False)
    pstage = make(pimage, {"rng": np.random.RandomState(3)}
                  if takes_rng else {})
    src = _imgs(pimage, order=order)
    before = [i.data.copy() for i in src]
    got = list(pstage(iter(src)))
    _equal(got, want)
    for i, b in zip(src, before):       # the records stay as they were
        np.testing.assert_array_equal(i.data, b)


def test_bad_arguments_raise():
    for cls in (ColorJitter, Lighting):
        with pytest.raises(ValueError, match="channel_order"):
            cls(channel_order="hsv")
    with pytest.raises(ValueError, match="cropper_method"):
        ImgCropper(3, 3, "corner")
    with pytest.raises(ValueError, match="no random stream"):
        list(ColorJitter()(iter(_imgs(pimage, 1))))
    assert ImgCropper(3, 3).pure_per_record and \
        not ImgCropper(3, 3).stochastic
    assert BGRImgCropper(3, 3).stochastic


def test_example_chain_equals_jax_first_pass():
    """examples/train_resnet50_imagenet.py's augmentation at small size,
    decode included: ``DataSet.array(records, seed) >> BytesToImg >>
    ImgRdmCropper >> HFlip >> ColorJitter >> Lighting >> ImgNormalizer >>
    ImgToBatch`` gives the JAX batches after ``set_seed(seed)``: the
    permutation, the crops, the coins, the jitters' shuffles and draws and
    the lighting's draws interleave on one stream.  Held at rtol 1e-6 /
    atol 1e-6, not bit for bit: the contrast step's mean sums in its
    input's memory order, and the JAX resize leaves an image transposed
    in memory, which a JAX crop keeps (a view) and a flip undoes (a C
    copy), while every port image is C-ordered; the two means part by an
    ulp on the unflipped images.  The same stage on the same C-ordered
    image is bit for bit (``test_stages_equal_jax_on_aligned_streams``),
    and so is the chain up to the jitter."""
    raws = [_pil_png("RGB", 20 + i % 3, 18, seed=i) for i in range(10)]
    mean, std = (123.0, 117.0, 104.0), (58.4, 57.1, 57.4)
    set_seed(12)
    jds = (JaxDataSet.array(_records(raws, JaxByteRecord))
           >> jimage.BytesToImg(16) >> jimage.ImgRdmCropper(12, 12)
           >> jimage.HFlip() >> jimage.ColorJitter(channel_order="rgb")
           >> jimage.Lighting() >> jimage.ImgNormalizer(mean, std)
           >> jimage.ImgToBatch(4))
    it = jds.data(train=True)
    want = [next(it) for _ in range(4)]
    pds = (DataSet.array(_records(raws, ByteRecord), seed=12)
           >> BytesToImg(16) >> ImgRdmCropper(12, 12) >> HFlip()
           >> ColorJitter(channel_order="rgb") >> Lighting()
           >> ImgNormalizer(mean, std) >> ImgToBatch(4))
    it = pds.data(train=True)
    got = [next(it) for _ in range(4)]
    for g, w in zip(got, want):
        assert g.data.shape == (4, 3, 12, 12)
        np.testing.assert_allclose(g.data, w.data, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g.labels, w.labels)
    set_seed(12)
    jds = (JaxDataSet.array(_records(raws, JaxByteRecord))
           >> jimage.BytesToImg(16) >> jimage.ImgRdmCropper(12, 12)
           >> jimage.HFlip() >> jimage.ImgToBatch(4))
    pds = (DataSet.array(_records(raws, ByteRecord), seed=12)
           >> BytesToImg(16) >> ImgRdmCropper(12, 12) >> HFlip()
           >> ImgToBatch(4))
    jit, pit = jds.data(train=True), pds.data(train=True)
    for _ in range(4):
        np.testing.assert_array_equal(next(pit).data, next(jit).data)


@pytest.mark.parametrize("to_chw", [True, False])
def test_samples_and_image_vectors_equal_jax(to_chw):
    jimgs, pimgs = _imgs(jimage, 3, order="bgr"), _imgs(pimage, 3,
                                                        order="bgr")
    grey = np.random.RandomState(2).uniform(0, 9, (4, 6)).astype(np.float32)
    jimgs.append(jimage.LabeledImage(grey, 4.0))
    pimgs.append(LabeledImage(grey, 4.0))
    for jst, pst in ((jimage.ImgToSample(to_chw), ImgToSample(to_chw)),
                     (jimage.ImgToImageVector(), ImgToImageVector())):
        want = list(jst(iter(jimgs)))
        got = list(pst(iter(pimgs)))
        for g, w in zip(got, want):
            assert g.feature.shape == w.feature.shape
            np.testing.assert_array_equal(g.feature, w.feature)
            np.testing.assert_array_equal(g.label, w.label)
    vec = list(ImgToImageVector()(iter(pimgs[:1])))[0].feature
    # planar CHW in RGB plane order: plane 0 is the image's last channel
    np.testing.assert_array_equal(vec[:120], pimgs[0].data[..., 2].ravel())


def _mt_records(n=11):
    raws = [_pil_png("RGB", 14 + i % 4, 12 + i % 3, seed=i)
            for i in range(n)]
    return raws


def test_mt_batches_of_a_pure_chain_equal_jax_at_four_threads():
    raws = _mt_records()
    jchain = (jimage.BytesToImg(16) >> jimage.ImgCropper(12, 10)
              >> jimage.ImgNormalizer((120.0, 110.0, 100.0), (50.0, 2.0,
                                                              9.0)))
    pchain = (BytesToImg(16) >> ImgCropper(12, 10)
              >> ImgNormalizer((120.0, 110.0, 100.0), (50.0, 2.0, 9.0)))
    jds = JaxDataSet.array(_records(raws, JaxByteRecord)) >> \
        jimage.MTLabeledImgToBatch(8, 9, 4, jchain, num_threads=4)
    pds = DataSet.array(_records(raws, ByteRecord)) >> \
        MTLabeledImgToBatch(8, 9, 4, pchain, num_threads=4)
    want = list(jds.data(train=False))
    got = list(pds.data(train=False))
    assert [b.data.shape for b in got] == [(4, 3, 9, 8)] * 2 + [(3, 3, 9, 8)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
        np.testing.assert_array_equal(g.labels, w.labels)


def test_mt_batches_of_a_random_chain_do_not_depend_on_threads():
    """The documented difference: a seed a record from the chain's stream,
    drawn in the serial order, so 1 and 8 threads give the same batches,
    each record's own crop (not one crop repeated)."""
    raws = _mt_records(16)

    def run(threads):
        chain = (BytesToImg(16) >> ImgRdmCropper(10, 10) >> HFlip()
                 >> ColorJitter() >> Lighting())
        mt = MTLabeledImgToBatch(10, 10, 5, chain, num_threads=threads)
        assert mt.stochastic and mt.rng is None
        ds = DataSet.array(_records(raws, ByteRecord), seed=3) >> mt
        assert mt.rng is ds.rng
        it = ds.data(train=True)
        return [next(it) for _ in range(5)]

    one, eight = run(1), run(8)
    for a, b in zip(one, eight):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.labels, b.labels)
    # two records decoded alike still get crops of their own
    assert not np.array_equal(one[0].data[0], one[0].data[1])
    with pytest.raises(ValueError, match="no random stream"):
        list(MTLabeledImgToBatch(10, 10, 2, ImgRdmCropper(10, 10))(
            iter([])))


def test_mt_resizes_and_refuses_a_many_to_one_stage():
    imgs = _imgs(pimage, 3, h=7, w=9)
    from bigdl_tpu_torch.dataset import Identity
    out = list(MTLabeledImgToBatch(4, 5, 3, Identity(),
                                   num_threads=2)(iter(imgs)))
    want = np.stack([pimage._resize(i.data, 5, 4).transpose(2, 0, 1)
                     for i in imgs])
    np.testing.assert_array_equal(out[0].data, want)
    from bigdl_tpu_torch.dataset import FuncTransformer

    class Drop(FuncTransformer):
        def __call__(self, iterator):
            return iter([])

    with pytest.raises(ValueError, match="1-to-1"):
        list(MTLabeledImgToBatch(4, 5, 3, Drop(None))(iter(imgs)))
