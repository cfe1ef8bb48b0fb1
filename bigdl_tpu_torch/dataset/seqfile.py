"""Hadoop SequenceFile ingestion (counterpart of
bigdl_tpu/dataset/seqfile.py) — the reference's ImageNet wire format.

The reference packs ImageNet into Hadoop SequenceFiles of Text->Text
records (models/utils/ImageNetSeqFileGenerator.scala via
dataset/image/BGRImgToLocalSeqFile.scala:57-76) and trains from them
(dataset/DataSet.SeqFileFolder DataSet.scala:384-455,
dataset/image/LocalSeqFileToBytes.scala).  This module implements the
actual SequenceFile version-6 wire format in pure Python so data
produced by the reference toolchain can be ingested directly (and data
written here is readable by Hadoop):

  header:  b"SEQ" 0x06 | vint-str keyClass | vint-str valueClass |
           bool compress | bool blockCompress | u32-BE metadata count
           (+ Text pairs) | 16-byte sync marker
  record:  i32-BE recordLen | i32-BE keyLen | key | value
           (key/value each serialized as Hadoop Text: vint len + bytes)
  sync escape: i32-BE -1 | 16-byte sync marker, inserted by writers at
           least every SYNC_INTERVAL (2000) bytes so readers can seek.

Per-record payload layout (BGRImgToLocalSeqFile.scala:62-71):
  key   = Text("<label>") or Text("<name>\n<label>") when hasName
  value = i32-BE width | i32-BE height | H*W*3 bytes, interleaved BGR,
          each byte = (float_pixel * 255).toByte

Only uncompressed record-oriented files are supported (the layout the
reference writes: SequenceFile.createWriter with a default Configuration
— compression NONE); compressed files raise.  A writer's sync marker is
``md5(b"bigdl_tpu.seqfile:" + path)``, the JAX package's, so the two
packages write the same bytes to the same path.  Local paths only, as
``utils.fs``.
"""
from __future__ import annotations

import hashlib
import io
import os
import struct

import numpy as np

from bigdl_tpu_torch.dataset.dataset import LocalDataSet, _world_position
from bigdl_tpu_torch.dataset.sample import ByteRecord
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils import fs
from bigdl_tpu_torch.utils.random import check_stream

TEXT_CLASS = "org.apache.hadoop.io.Text"
SYNC_SIZE = 16
SYNC_INTERVAL = 100 * (SYNC_SIZE + 4)  # Hadoop SequenceFile.SYNC_INTERVAL


# ---------------------------------------------------------------------------
# Hadoop WritableUtils variable-length ints (writeVInt/readVInt)
# ---------------------------------------------------------------------------

def write_vint(value: int) -> bytes:
    """Hadoop WritableUtils.writeVLong encoding."""
    if -112 <= value <= 127:
        return struct.pack("b", value)
    length = -112
    v = value
    if v < 0:
        v = ~v
        length = -120
    tmp = v
    while tmp != 0:
        tmp >>= 8
        length -= 1
    out = [struct.pack("b", length)]
    n_bytes = -(length + 112) if length >= -120 else -(length + 120)
    for shift in range(8 * (n_bytes - 1), -1, -8):
        out.append(struct.pack("B", (v >> shift) & 0xFF))
    return b"".join(out)


def read_vint(f) -> int:
    first = struct.unpack("b", f.read(1))[0]
    if first >= -112:
        return first
    negative = first < -120
    n_bytes = -(first + 120) if negative else -(first + 112)
    v = 0
    for _ in range(n_bytes):
        v = (v << 8) | f.read(1)[0]
    return ~v if negative else v


def _text(data: bytes) -> bytes:
    """Hadoop Text serialization: vint byte-length + raw bytes."""
    return write_vint(len(data)) + data


def _read_text(f) -> bytes:
    return f.read(read_vint(f))


def _read_exact(f, n: int, path: str, offset: int, what: str) -> bytes:
    """``f.read(n)`` that REFUSES short reads: a truncated or corrupt
    .seq file must raise, naming file and offset, instead of yielding
    silently wrong records."""
    data = f.read(n)
    if len(data) != n:
        raise ValueError(
            f"{path}: truncated {what} at offset {offset}: wanted {n} "
            f"bytes, got {len(data)} — file is corrupt or was cut short")
    return data


# ---------------------------------------------------------------------------
# File-level reader / writer
# ---------------------------------------------------------------------------

class SequenceFileWriter:
    """Uncompressed Text->Text SequenceFile writer (version 6 layout,
    what ``SequenceFile.createWriter(new Configuration, ...)`` emits)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "wb")
        # Deterministic per-path marker: any 16 bytes work — readers
        # learn it from the header (Hadoop uses an MD5 of class+time).
        self.sync = hashlib.md5(b"bigdl_tpu.seqfile:" + path.encode()).digest()
        hdr = io.BytesIO()
        hdr.write(b"SEQ\x06")
        hdr.write(_text(TEXT_CLASS.encode()))
        hdr.write(_text(TEXT_CLASS.encode()))
        hdr.write(b"\x00\x00")  # compress, blockCompress: false
        hdr.write(struct.pack(">i", 0))  # metadata: 0 entries
        hdr.write(self.sync)
        self._f.write(hdr.getvalue())
        self._last_sync = self._f.tell()
        self.n = 0

    def append(self, key: bytes, value: bytes):
        if self._f.tell() >= self._last_sync + SYNC_INTERVAL:
            self._f.write(struct.pack(">i", -1))
            self._f.write(self.sync)
            self._last_sync = self._f.tell()
        k, v = _text(key), _text(value)
        self._f.write(struct.pack(">ii", len(k) + len(v), len(k)))
        self._f.write(k)
        self._f.write(v)
        self.n += 1

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_sequence_file(path: str):
    """Yield (key_bytes, value_bytes) from one SequenceFile.

    Accepts any uncompressed record-layout file (the key/value classes
    are not restricted to Text — bytes come back as serialized by the
    writer minus the Text length prefix when the class IS Text)."""
    with fs.open_file(path, "rb") as f:
        magic = f.read(3)
        if magic != b"SEQ":
            raise ValueError(f"{path}: not a Hadoop SequenceFile")
        version = f.read(1)[0]
        if version < 6:
            raise NotImplementedError(
                f"{path}: SequenceFile version {version} (< 6) unsupported")
        key_cls = _read_text(f).decode()
        val_cls = _read_text(f).decode()
        compress, block_compress = f.read(1)[0], f.read(1)[0]
        if compress or block_compress:
            raise NotImplementedError(
                f"{path}: compressed SequenceFiles unsupported "
                "(the reference generator writes uncompressed)")
        (n_meta,) = struct.unpack(">i", f.read(4))
        for _ in range(n_meta):
            _read_text(f), _read_text(f)
        sync = f.read(SYNC_SIZE)
        is_text = (key_cls == TEXT_CLASS, val_cls == TEXT_CLASS)
        while True:
            off = f.tell()
            raw = f.read(4)
            if not raw:
                return
            if len(raw) < 4:
                raise ValueError(
                    f"{path}: truncated record length at offset {off}: "
                    f"got {len(raw)}/4 bytes — file was cut short")
            (rec_len,) = struct.unpack(">i", raw)
            if rec_len == -1:  # sync escape
                marker = _read_exact(f, SYNC_SIZE, path, off + 4,
                                     "sync marker")
                if marker != sync:
                    raise ValueError(f"{path}: corrupt sync marker")
                continue
            (key_len,) = struct.unpack(
                ">i", _read_exact(f, 4, path, off + 4, "key length"))
            if key_len < 0 or rec_len < key_len:
                raise ValueError(
                    f"{path}: corrupt record header at offset {off}: "
                    f"rec_len {rec_len}, key_len {key_len} (need "
                    "rec_len >= key_len >= 0)")
            key = _read_exact(f, key_len, path, off + 8, "record key")
            vlen = rec_len - key_len
            value = f.read(vlen)
            if len(value) != vlen:
                raise ValueError(
                    f"{path}: truncated record value at offset "
                    f"{off + 8 + key_len}: wanted {vlen} bytes, got "
                    f"{len(value)} — file is corrupt or was cut short")
            if is_text[0]:
                key = _read_text(io.BytesIO(key))
            if is_text[1]:
                value = _read_text(io.BytesIO(value))
            yield key, value


# ---------------------------------------------------------------------------
# The reference's image record layer
# ---------------------------------------------------------------------------

def read_label(key_bytes: bytes) -> str:
    """(ref DataSet.SeqFileFolder.readLabel DataSet.scala:409-416)"""
    parts = key_bytes.decode().split("\n")
    return parts[0] if len(parts) == 1 else parts[1]


def read_name(key_bytes: bytes) -> str:
    """(ref DataSet.SeqFileFolder.readName DataSet.scala:424-428)"""
    parts = key_bytes.decode().split("\n")
    if len(parts) < 2:
        raise ValueError("key in seq file only contains label, no name")
    return parts[0]


def encode_image_value(data, width: int, height: int,
                       normalize: float = 255.0) -> bytes:
    """float HWC image -> the value payload BGRImgToLocalSeqFile writes:
    i32-BE width | i32-BE height | (pixel * normalize).toByte stream."""
    arr = np.asarray(data, np.float32).reshape(-1)
    raw = (arr * normalize).astype(np.int32).astype(np.uint8).tobytes()
    return struct.pack(">ii", width, height) + raw


def decode_image_value(value: bytes, normalize: float = 255.0):
    """Value payload -> (HWC float array scaled by 1/normalize, w, h)."""
    w, h = struct.unpack(">ii", value[:8])
    arr = np.frombuffer(value, np.uint8, offset=8).astype(np.float32)
    return arr.reshape(h, w, 3) / normalize, w, h


class BGRImgToLocalSeqFile(Transformer):
    """LabeledImage stream -> numbered ``.seq`` files of blockSize records
    (ref BGRImgToLocalSeqFile.scala:41-81).  Input items are LabeledImage
    or (LabeledImage, name) pairs; yields each generated file name.

    ``normalize`` mirrors convertToByte's multiplier: 255.0 for images
    scaled to [0,1] (the reference's layout), 1.0 for [0,255] pipelines.
    RGB-ordered images are flipped to the on-disk BGR interleave."""

    def __init__(self, block_size: int, base_file_name: str,
                 has_name: bool = False, normalize: float = 255.0):
        self.block_size = block_size
        self.base = str(base_file_name)
        self.has_name = has_name
        self.normalize = normalize

    def __call__(self, iterator):
        it = iter(iterator)
        index = 0
        done = False
        while not done:
            done = True
            writer = None
            for item in it:
                img, name = item if isinstance(item, tuple) else (item, "")
                if writer is None:  # open lazily: no empty trailing file
                    writer = SequenceFileWriter(f"{self.base}_{index}.seq")
                d = img.data
                if getattr(img, "order", "bgr") == "rgb":
                    d = d[..., ::-1]
                h, w = d.shape[:2]
                key = (f"{name}\n{int(img.label)}" if self.has_name
                       else f"{int(img.label)}")
                writer.append(key.encode(),
                              encode_image_value(d, w, h, self.normalize))
                if writer.n >= self.block_size:
                    done = False
                    break
            if writer is not None:
                writer.close()
                index += 1
                yield f"{self.base}_{index - 1}.seq"


class LocalSeqFileToBytes(Transformer):
    """``.seq`` path stream -> ByteRecord stream (ref
    LocalSeqFileToBytes.scala:34-80): the record's value bytes (width/
    height prefix included) labeled by readLabel(key)."""

    def __call__(self, iterator):
        for path in iterator:
            for key, value in read_sequence_file(str(path)):
                yield ByteRecord(value, float(read_label(key)))


class SeqBytesToBGRImg(Transformer):
    """ByteRecord (prefixed raw BGR bytes from a seq file) -> LabeledImage
    in BGR channel order, pixels scaled by 1/normalize (the role of the
    reference's BytesToBGRImg over SeqFileFolder records)."""

    def __init__(self, normalize: float = 255.0):
        self.normalize = normalize

    def __call__(self, iterator):
        from bigdl_tpu_torch.dataset.image import LabeledImage
        for rec in iterator:
            arr, _, _ = decode_image_value(rec.data, self.normalize)
            yield LabeledImage(arr, rec.label, order="bgr")


def folder_listing(path: str):
    """Entry names of a local folder; [] when the path is not a listable
    directory (a URL raises, as ``utils.fs``).  Shared by the wire-format
    dispatch (``DataSet.seq_file_folder``) and ``find_seq_files`` so one
    listing answers both questions."""
    if not os.path.isdir(fs._local(path)):
        return []
    try:
        return fs.listdir(path)
    except (FileNotFoundError, OSError):
        return []


def find_seq_files(path: str, names=None):
    """Sorted ``*.seq`` under a local folder (ref DataSet.scala:449-455).
    ``names`` short-circuits the listing when the caller already holds
    one (``folder_listing``)."""
    if names is None:
        names = folder_listing(path)
    return sorted(fs.join(path, f) for f in names if f.endswith(".seq"))


def iter_record_keys(path: str):
    """Yield only the Text keys of a SequenceFile, seeking past the value
    payloads — an O(metadata) pass for counting/label scans that never
    reads the (multi-KB) image bytes."""
    with fs.open_file(path, "rb") as f:
        if f.read(4) != b"SEQ\x06":
            raise ValueError(f"{path}: not a version-6 SequenceFile")
        key_cls = _read_text(f).decode()
        _read_text(f)
        if f.read(1)[0] or f.read(1)[0]:
            raise NotImplementedError(f"{path}: compressed file unsupported")
        (n_meta,) = struct.unpack(">i", f.read(4))
        for _ in range(n_meta):
            _read_text(f), _read_text(f)
        f.read(SYNC_SIZE)
        # seeking skips the value payloads, so a file cut short mid-value
        # is only detectable against the real size — grab it up front
        here = f.tell()
        f.seek(0, 2)
        file_size = f.tell()
        f.seek(here)
        while True:
            off = f.tell()
            raw = f.read(4)
            if not raw:
                return
            if len(raw) < 4:
                raise ValueError(
                    f"{path}: truncated record length at offset {off}: "
                    f"got {len(raw)}/4 bytes — file was cut short")
            (rec_len,) = struct.unpack(">i", raw)
            if rec_len == -1:
                _read_exact(f, SYNC_SIZE, path, off + 4, "sync marker")
                continue
            (key_len,) = struct.unpack(
                ">i", _read_exact(f, 4, path, off + 4, "key length"))
            if key_len < 0 or rec_len < key_len:
                raise ValueError(
                    f"{path}: corrupt record header at offset {off}: "
                    f"rec_len {rec_len}, key_len {key_len} (need "
                    "rec_len >= key_len >= 0)")
            if off + 8 + rec_len > file_size:
                raise ValueError(
                    f"{path}: truncated record value at offset "
                    f"{off + 8 + key_len}: record ends at "
                    f"{off + 8 + rec_len} but the file holds only "
                    f"{file_size} bytes")
            key = _read_exact(f, key_len, path, off + 8, "record key")
            f.seek(rec_len - key_len, 1)
            yield (_read_text(io.BytesIO(key))
                   if key_cls == TEXT_CLASS else key)


class SeqFileDataSet(LocalDataSet):
    """Folder of Hadoop SequenceFiles as a ByteRecord dataset (ref
    DataSet.SeqFileFolder.files DataSet.scala:436-446).  ``class_num``
    drops records whose label exceeds it, like the reference's filter.
    Files are streamed (never fully in memory); ``train=True`` loops with
    the file order shuffled each pass from ``rng``
    (``np.random.RandomState(seed)``, the chain's stream), as the JAX one
    shuffles it from ``RNG.np_rng()`` after ``set_seed(seed)``.
    ``distributed=True`` gives this rank whole files,
    ``files[rank::world]``, and routes ``Optimizer(...)`` to the
    ``DistriOptimizer``."""

    def __init__(self, path: str, class_num: int = None,
                 distributed: bool = False, files=None, seed: int = 1):
        self.files = find_seq_files(path) if files is None else list(files)
        if not self.files:
            raise ValueError(f"Can't find any sequence files under {path}")
        self.class_num = class_num
        self.distributed = distributed
        if distributed:
            # whole files per process, like ShardFolder / the reference's
            # partition-per-node sequence-file splits
            idx, nproc = _world_position()
            self.local_files = self.files[idx::nproc]
            if not self.local_files:
                raise ValueError(
                    f"process {idx}/{nproc} got no sequence files: "
                    f"{len(self.files)} .seq files under {path} < process "
                    f"count; regenerate with more output files")
        else:
            self.local_files = list(self.files)
        self._size = None
        self.rng = np.random.RandomState(seed)

    def _records(self, files):
        for rec in LocalSeqFileToBytes()(iter(files)):
            if self.class_num is None or rec.label <= self.class_num:
                yield rec

    def size(self):
        """GLOBAL record count (all files, post class filter) — a
        keys-only scan that seeks past image payloads; cached."""
        if self._size is None:
            self._size = sum(
                1 for f in self.files for key in iter_record_keys(f)
                if self.class_num is None
                or float(read_label(key)) <= self.class_num)
        return self._size

    def shuffle(self):
        # Streaming dataset: shuffling happens at file granularity per
        # epoch inside data(train=True) (the reference likewise shuffles
        # sequence-file splits, not records — DataSet.scala:436-446).
        return self

    def data(self, train: bool = False):
        if not train:
            return self._records(self.local_files)

        def looped():
            while True:
                files = list(self.local_files)
                check_stream(self.rng)
                self.rng.shuffle(files)
                yield from self._records(files)
        return looped()
