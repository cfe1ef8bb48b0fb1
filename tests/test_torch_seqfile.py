"""The port's Hadoop SequenceFile reader and writer
(``dataset/seqfile.py``) against the JAX package: tests/test_seqfile.py's
cases on the port, the port's files equal the JAX bytes at the same path
(the sync marker is a digest of the path), each package reads the
other's, corrupt, cut and compressed files raise as in JAX, and the
streaming dataset's training passes shuffle its files as the JAX one does
after ``set_seed``.  All host code, compared exactly."""
import io
import os
import struct

import numpy as np
import pytest

from bigdl_tpu.dataset import seqfile as jax_seqfile
from bigdl_tpu.dataset.image import LabeledImage as JaxImage
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch.dataset import DataSet, seqfile
from bigdl_tpu_torch.dataset.image import LabeledImage
from bigdl_tpu_torch.dataset.seqfile import (BGRImgToLocalSeqFile,
                                             LocalSeqFileToBytes,
                                             SeqBytesToBGRImg, SeqFileDataSet,
                                             SequenceFileWriter,
                                             read_sequence_file, read_vint,
                                             write_vint)

VINTS = [0, 1, -1, 127, -112, 128, -113, 255, 256, 65535, 2 ** 20,
         2 ** 31 - 1, -(2 ** 31), 2 ** 40, -(2 ** 40), 2 ** 62]


@pytest.mark.parametrize("v", VINTS)
def test_vint_round_trip_and_jax_bytes(v):
    assert write_vint(v) == jax_seqfile.write_vint(v)
    assert read_vint(io.BytesIO(write_vint(v))) == v
    assert jax_seqfile.read_vint(io.BytesIO(write_vint(v))) == v


def test_single_byte_range_is_one_byte():
    for v in (-112, 0, 127):
        assert len(write_vint(v)) == 1


def _write(mod, path, records):
    with mod.SequenceFileWriter(path) as w:
        for k, v in records:
            w.append(k, v)
    with open(path, "rb") as f:
        return f.read()


def test_many_records_with_sync_escapes_equal_jax(tmp_path):
    path = str(tmp_path / "t_0.seq")
    rs = np.random.RandomState(0)
    records = [(f"k{i}".encode(), rs.bytes(137) * (i % 3 + 1))
               for i in range(200)]  # >> SYNC_INTERVAL bytes total
    want = _write(jax_seqfile, path, records)
    got = _write(seqfile, path, records)
    assert got == want
    assert len(got) > seqfile.SYNC_INTERVAL * 2
    assert list(read_sequence_file(path)) == records
    assert list(jax_seqfile.read_sequence_file(path)) == records


def test_reads_hand_built_file(tmp_path):
    """A byte-literal SequenceFile assembled from the Hadoop spec."""
    text_cls = b"\x19org.apache.hadoop.io.Text"  # vint(25) + name
    sync = bytes(range(16))
    key, value = b"\x013", b"\x05hello"  # Text("3"), Text("hello")
    blob = (b"SEQ\x06" + text_cls + text_cls + b"\x00\x00"
            + struct.pack(">i", 0) + sync
            + struct.pack(">ii", len(key) + len(value), len(key))
            + key + value
            + struct.pack(">i", -1) + sync  # sync escape mid-stream
            + struct.pack(">ii", len(key) + len(value), len(key))
            + key + value)
    path = str(tmp_path / "hand_0.seq")
    with open(path, "wb") as f:
        f.write(blob)
    assert list(read_sequence_file(path)) == [(b"3", b"hello")] * 2


def _raises_alike(path, exc, match):
    for mod in (seqfile, jax_seqfile):
        with pytest.raises(exc, match=match):
            list(mod.read_sequence_file(path))


def test_bad_files_raise_as_in_jax(tmp_path):
    bad = str(tmp_path / "x_0.seq")
    with open(bad, "wb") as f:
        f.write(b"NOPE")
    _raises_alike(bad, ValueError, "not a Hadoop SequenceFile")
    comp = str(tmp_path / "c_0.seq")
    with open(comp, "wb") as f:
        f.write(b"SEQ\x06" + b"\x19org.apache.hadoop.io.Text" * 2
                + b"\x01\x00" + struct.pack(">i", 0) + bytes(16))
    _raises_alike(comp, NotImplementedError, "compressed")
    old = str(tmp_path / "o_0.seq")
    with open(old, "wb") as f:
        f.write(b"SEQ\x05")
    _raises_alike(old, NotImplementedError, "version 5")

    path = str(tmp_path / "g_0.seq")
    raw = _write(seqfile, path, [(b"1", b"abcdef" * 500)] * 3)
    for cut, match in ((len(raw) - 7, "truncated record value"),
                       (len(raw) - 3005, "truncated record")):
        with open(path, "wb") as f:
            f.write(raw[:cut])
        _raises_alike(path, ValueError, match)
    # a corrupt sync marker (the second record follows an escape)
    with SequenceFileWriter(path) as w:
        for _ in range(3):
            w.append(b"1", b"x" * 3000)
    raw = bytearray(open(path, "rb").read())
    at = raw.index(struct.pack(">i", -1), 100)
    raw[at + 4] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    _raises_alike(path, ValueError, "corrupt sync marker")
    # a record header whose key is longer than the record
    with open(path, "wb") as f:
        f.write(_write(seqfile, str(tmp_path / "h.seq"), [])
                + struct.pack(">ii", 2, 5))
    _raises_alike(path, ValueError, "corrupt record header")


def _images(n, h=8, w=6, seed=0, pkg=LabeledImage):
    rng = np.random.RandomState(seed)
    return [pkg(rng.rand(h, w, 3).astype(np.float32), float(i % 4 + 1),
                order="bgr") for i in range(n)]


def test_block_splitting_equals_jax_and_reads_back(tmp_path):
    imgs = _images(7)
    base = str(tmp_path / "imagenet-seq-0")
    want = list(jax_seqfile.BGRImgToLocalSeqFile(3, base)(
        iter(_images(7, pkg=JaxImage))))
    want_bytes = [open(f, "rb").read() for f in want]
    files = list(BGRImgToLocalSeqFile(3, base)(iter(imgs)))
    assert files == want == [f"{base}_{i}.seq" for i in range(3)]
    assert [open(f, "rb").read() for f in files] == want_bytes
    recs = list(LocalSeqFileToBytes()(iter(files)))
    jrecs = list(jax_seqfile.LocalSeqFileToBytes()(iter(files)))
    assert [(r.label, r.data) for r in recs] == \
        [(r.label, r.data) for r in jrecs]
    assert [r.label for r in recs] == [img.label for img in imgs]
    out = list(SeqBytesToBGRImg()(iter(recs)))
    jout = list(jax_seqfile.SeqBytesToBGRImg()(iter(jrecs)))
    for got, ref, want_img in zip(out, jout, imgs):
        np.testing.assert_array_equal(got.data, ref.data)
        assert got.data.shape == want_img.data.shape and got.order == "bgr"
        # on-disk bytes quantize pixels to 1/255 steps
        assert np.abs(got.data - want_img.data).max() <= 1.0 / 255.0 + 1e-6


def test_rgb_images_are_flipped_to_disk_bgr(tmp_path):
    img = _images(1)[0]
    rgb = LabeledImage(img.data[..., ::-1], img.label, order="rgb")
    (f1,) = BGRImgToLocalSeqFile(8, str(tmp_path / "s"))(iter([img]))
    (f2,) = BGRImgToLocalSeqFile(8, str(tmp_path / "r"))(iter([rgb]))
    (_, v1), (_, v2) = next(read_sequence_file(f1)), next(
        read_sequence_file(f2))
    assert v1 == v2


@pytest.mark.parametrize("normalize", [255.0, 1.0])
def test_image_values_equal_jax(normalize):
    rs = np.random.RandomState(3)
    d = rs.rand(5, 4, 3).astype(np.float32) * (255.0 / normalize)
    v = seqfile.encode_image_value(d, 4, 5, normalize)
    assert v == jax_seqfile.encode_image_value(d, 4, 5, normalize)
    got, w, h = seqfile.decode_image_value(v, normalize)
    want, _, _ = jax_seqfile.decode_image_value(v, normalize)
    np.testing.assert_array_equal(got, want)
    assert (w, h) == (4, 5) and got.dtype == want.dtype


def test_has_name_keys(tmp_path):
    imgs = _images(2)
    named = [(img, f"n0/{i}.JPEG") for i, img in enumerate(imgs)]
    (f,) = BGRImgToLocalSeqFile(8, str(tmp_path / "named"),
                                has_name=True)(iter(named))
    keys = [k for k, _ in read_sequence_file(f)]
    assert keys[0].decode() == "n0/0.JPEG\n1"
    assert seqfile.read_label(keys[0]) == "1"
    assert seqfile.read_name(keys[0]) == "n0/0.JPEG"
    with pytest.raises(ValueError):
        seqfile.read_name(b"1")  # label-only key has no name


def test_folder_dataset_and_class_filter(tmp_path):
    imgs = _images(10)  # labels cycle 1..4
    list(BGRImgToLocalSeqFile(4, str(tmp_path / "a"))(iter(imgs)))
    ds = SeqFileDataSet(str(tmp_path))
    assert ds.size() == 10
    ds2 = SeqFileDataSet(str(tmp_path), class_num=2)
    labels = [r.label for r in ds2.data(train=False)]
    assert labels and all(l <= 2.0 for l in labels)
    assert labels == [r.label for r in jax_seqfile.SeqFileDataSet(
        str(tmp_path), class_num=2).data(train=False)]
    with pytest.raises(ValueError):
        SeqFileDataSet(str(tmp_path / "missing-dir-ok"))


def test_dispatch_and_pipeline_chaining(tmp_path):
    imgs = _images(5)
    list(BGRImgToLocalSeqFile(5, str(tmp_path / "b"))(iter(imgs)))
    ds = DataSet.seq_file_folder(str(tmp_path))
    assert isinstance(ds, SeqFileDataSet)
    decoded = list((ds >> SeqBytesToBGRImg()).data(train=False))
    assert len(decoded) == 5
    assert decoded[0].data.shape == imgs[0].data.shape


def test_size_uses_keys_only_scan_and_caches(tmp_path):
    imgs = _images(9)
    list(BGRImgToLocalSeqFile(4, str(tmp_path / "c"))(iter(imgs)))
    keys = [k for f in seqfile.find_seq_files(str(tmp_path))
            for k in seqfile.iter_record_keys(f)]
    assert keys == [k for f in jax_seqfile.find_seq_files(str(tmp_path))
                    for k in jax_seqfile.iter_record_keys(f)]
    assert [seqfile.read_label(k) for k in keys] \
        == [str(int(i.label)) for i in imgs]
    ds = SeqFileDataSet(str(tmp_path), class_num=3)
    want = sum(1 for i in imgs if i.label <= 3)
    assert ds.size() == want
    assert ds._size == want  # cached after first call
    f = seqfile.find_seq_files(str(tmp_path))[0]
    raw = open(f, "rb").read()
    with open(f, "wb") as out:
        out.write(raw[:-5])
    for mod in (seqfile, jax_seqfile):
        with pytest.raises(ValueError, match="truncated record value"):
            list(mod.iter_record_keys(f))


def test_distributed_shards_whole_files_per_process(tmp_path, monkeypatch):
    imgs = _images(8)
    list(BGRImgToLocalSeqFile(2, str(tmp_path / "d"))(iter(imgs)))  # 4 files
    monkeypatch.setattr(seqfile, "_world_position", lambda: (1, 2))
    ds = SeqFileDataSet(str(tmp_path), distributed=True)
    assert ds.local_files == ds.files[1::2]
    assert len(list(ds.data(train=False))) == 4  # this process's half
    assert ds.size() == 8  # size() stays global
    monkeypatch.setattr(seqfile, "_world_position", lambda: (5, 9))
    with pytest.raises(ValueError, match="got no sequence files"):
        SeqFileDataSet(str(tmp_path), distributed=True)


def test_training_passes_shuffle_files_as_jax(tmp_path):
    list(BGRImgToLocalSeqFile(2, str(tmp_path / "e"))(iter(_images(9))))
    pds = SeqFileDataSet(str(tmp_path), seed=4)
    jds = jax_seqfile.SeqFileDataSet(str(tmp_path))
    set_seed(4)
    jit, pit = jds.data(train=True), pds.data(train=True)
    want = [next(jit) for _ in range(27)]
    got = [next(pit) for _ in range(27)]
    assert [(r.label, r.data) for r in got] == \
        [(r.label, r.data) for r in want]


def test_matches_shardfile_path_on_same_records(tmp_path):
    """The same images through the reference wire format and through the
    packed-shard format decode identically."""
    from bigdl_tpu_torch.dataset.shardfile import write_shards
    imgs = _images(6, seed=3)
    list(BGRImgToLocalSeqFile(6, str(tmp_path / "seq" / "p"))(iter(imgs)))
    seq_imgs = list((DataSet.seq_file_folder(str(tmp_path / "seq"))
                     >> SeqBytesToBGRImg()).data(train=False))
    recs = [(str(int(img.label)),
             seqfile.encode_image_value(img.data, img.width, img.height))
            for img in imgs]
    write_shards(iter(recs), str(tmp_path / "shards"), n_shards=2,
                 prefix="p")
    shard_ds = DataSet.seq_file_folder(str(tmp_path / "shards"))
    assert not isinstance(shard_ds, SeqFileDataSet)
    shard_imgs = list((shard_ds >> SeqBytesToBGRImg()).data(train=False))
    assert sorted((i.label, i.data.tobytes()) for i in seq_imgs) \
        == sorted((i.label, i.data.tobytes()) for i in shard_imgs)
    assert os.path.exists(str(tmp_path / "shards" / "p-00001.bdts"))
