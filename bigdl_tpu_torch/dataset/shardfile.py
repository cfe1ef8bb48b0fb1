"""Packed record shards (counterpart of bigdl_tpu/dataset/shardfile.py;
the Hadoop SequenceFile role of ref DataSet.SeqFileFolder :384-455 and
models/utils/ImageNetSeqFileGenerator.scala): many small image files
packed into large sequential shards, so that training reads streams, not
inodes.

Format (little-endian), the JAX package's byte for byte:
  header: magic b"BDTS" | u32 version | u64 record count
  record: u32 label_len | label bytes (utf-8, e.g. "1012") |
          u32 data_len  | data bytes (encoded image or raw array)

``write_shards`` packs (key, bytes) pairs into N shards round-robin;
``ShardFolder`` reads a directory of shards as a ``ByteRecord`` dataset.
Local paths only, as ``utils.fs``: a URL raises.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from bigdl_tpu_torch.dataset.dataset import LocalDataSet, _world_position
from bigdl_tpu_torch.dataset.sample import ByteRecord
from bigdl_tpu_torch.utils import fs
from bigdl_tpu_torch.utils.random import check_stream

MAGIC = b"BDTS"
VERSION = 1


class _ShardWriter:
    """Incremental single-shard writer: the records stream to a ``.tmp``
    file beside the shard (a GB-scale shard never lives in memory), which
    an atomic rename finishes."""

    def __init__(self, path):
        path = fs._local(path)
        self.path = path
        self.n = 0
        self.closed = False
        fs.makedirs(os.path.dirname(os.path.abspath(path)))
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "w+b")
        self._f.write(MAGIC + struct.pack("<IQ", VERSION, 0))

    def append(self, label, data):
        key = str(label).encode()
        self._f.write(struct.pack("<I", len(key)) + key)
        self._f.write(struct.pack("<I", len(data)) + data)
        self.n += 1

    def close(self):
        self._f.seek(len(MAGIC) + 4)
        self._f.write(struct.pack("<Q", self.n))
        self._f.close()
        os.replace(self._tmp, self.path)
        self.closed = True
        return self.n

    def abort(self):
        """Drop the partial shard (no stale .tmp survives a failed run)."""
        self._f.close()
        try:
            os.unlink(self._tmp)
        except OSError:
            pass


def write_shard(records, path):
    """records: iterable of (label: float|str, data: bytes); returns the
    record count."""
    w = _ShardWriter(path)
    try:
        for label, data in records:
            w.append(label, data)
    except BaseException:
        w.abort()
        raise
    return w.close()


def write_shards(records, out_dir, n_shards: int = 8, prefix: str = "shard"):
    """Round-robin pack records into ``n_shards`` files (the
    ImageNetSeqFileGenerator role), each record straight to its shard's
    writer; returns the shard paths."""
    fs.makedirs(out_dir)
    writers = []
    try:
        for i in range(n_shards):
            writers.append(
                _ShardWriter(fs.join(out_dir, f"{prefix}-{i:05d}.bdts")))
        for i, (label, data) in enumerate(records):
            writers[i % n_shards].append(label, data)
        for w in writers:
            w.close()
    except BaseException:
        for w in writers:
            if not w.closed:
                w.abort()
        raise
    return [w.path for w in writers]


def _read_head(f, path):
    head = f.read(len(MAGIC) + 12)
    if len(head) != len(MAGIC) + 12 or head[:4] != MAGIC:
        raise ValueError(f"bad shard magic in {path}")
    version, count = struct.unpack("<IQ", head[4:])
    if version != VERSION:
        raise ValueError(f"{path}: shard version {version}, expected "
                         f"{VERSION}")
    return count


def _exact(f, n, path, i) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise ValueError(f"{path}: truncated at record {i}: wanted {n} "
                         f"bytes, got {len(data)}")
    return data


def read_shard(path):
    """Yield a ``ByteRecord`` a record of one shard file; a label that is
    not a number (a ``--hasName`` key, ``"<label>:<file>"``) stays text."""
    with fs.open_file(path, "rb") as f:
        count = _read_head(f, path)
        for i in range(count):
            (klen,) = struct.unpack("<I", _exact(f, 4, path, i))
            key = _exact(f, klen, path, i).decode()
            (dlen,) = struct.unpack("<I", _exact(f, 4, path, i))
            data = _exact(f, dlen, path, i)
            try:
                label = float(key)
            except ValueError:
                label = key
            yield ByteRecord(data, label)


class ShardFolder(LocalDataSet):
    """Dataset over a directory of .bdts shards.  ``distributed=True``
    gives this rank whole shards, ``paths[rank::world]`` (the
    partition-per-node layout of CachedDistriDataSet), and routes
    ``Optimizer(...)`` to the ``DistriOptimizer``.

    A training pass shuffles the order of the rank's shards, in place,
    from ``rng`` (``np.random.RandomState(seed)``, the stream the chain's
    random stages draw from too), as the JAX one does from
    ``RNG.np_rng()`` after ``set_seed(seed)``; the records of a shard keep
    their order."""

    def __init__(self, folder, distributed: bool = False, seed: int = 1):
        self.distributed = distributed
        self.paths = sorted(
            fs.join(folder, f) for f in fs.listdir(folder)
            if f.endswith(".bdts"))
        if not self.paths:
            raise FileNotFoundError(f"no .bdts shards under {folder}")
        self._counts = []
        for p in self.paths:
            with fs.open_file(p, "rb") as f:
                self._counts.append(_read_head(f, p))
        if distributed:
            idx, nproc = _world_position()
            self.local_paths = self.paths[idx::nproc]
            if not self.local_paths:
                # an empty local slice would make the train iterator spin
                # forever yielding nothing while peers wait at the collective
                raise ValueError(
                    f"process {idx}/{nproc} got no shards: {len(self.paths)} "
                    f"shard files under {folder} < process count; repack with "
                    f"write_shards(n_shards >= {nproc})")
        else:
            self.local_paths = list(self.paths)
        self._order = list(range(len(self.local_paths)))
        self.rng = np.random.RandomState(seed)

    def size(self):
        return sum(self._counts)

    def shuffle(self):
        check_stream(self.rng)
        self.rng.shuffle(self._order)
        return self

    def data(self, train: bool):
        if train:
            def looped():
                while True:
                    self.shuffle()
                    for i in self._order:
                        yield from read_shard(self.local_paths[i])
            return looped()

        def once():
            for p in self.local_paths:
                yield from read_shard(p)
        return once()
